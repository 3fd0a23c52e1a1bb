// Image decoders on the host: the compiled forms of utils/jpeg.py (a
// baseline JPEG decoder) and of utils/png.py's row unfilter.  Plain C++ with
// no library, built by the kernels' single nvcc call (ops/_build.py) and
// called through ctypes.  Each computes what its plain form computes, byte
// for byte:
//
// - JPEG: SOF0/SOF1 8-bit Huffman frames of 1 or 3 components, restart
//   intervals, Annex K tables where a frame defines none; libjpeg-turbo's
//   jpeg_idct_islow, its default ("fancy") h2v1 / h2v2 / h1v2 upsampling
//   with the edge replicated (replication for other factors) and its
//   fixed-point YCbCr -> BGR tables; gray repeated into three channels.
//   The Python form parses the headers first and refuses what neither form
//   reads, so this one returns 1 for any stream it cannot decode (truncated
//   or damaged data), 2 when the frame's size is not the caller's and 3
//   when it runs out of memory.
// - PNG: undo the five row filters (None, Sub, Up, Average, Paeth).
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

const uint8_t kStdDcBits[2][16] = {
    {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
    {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0}};
const uint8_t kStdAcBits[2][16] = {
    {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d},
    {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77}};
const uint8_t kStdAcVals[2][162] = {
    {0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
     0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
     0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
     0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
     0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
     0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
     0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
     0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
     0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
     0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
     0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
     0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
     0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
     0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa},
    {0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
     0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
     0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
     0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
     0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
     0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
     0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
     0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
     0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
     0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
     0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
     0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
     0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
     0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa}};

struct Damaged {};  // thrown for truncated or damaged input

// A Huffman table as lookups over every 16-bit window of the bit stream.
struct Huffman {
  bool defined = false;
  std::vector<uint8_t> length, symbol;  // 65536 each; length 0: no code

  void build(const uint8_t* counts, const uint8_t* symbols, int total) {
    length.assign(1 << 16, 0);
    symbol.assign(1 << 16, 0);
    int code = 0, k = 0;
    for (int n = 1; n <= 16; ++n) {
      for (int i = 0; i < counts[n - 1]; ++i) {
        if (code >= (1 << n) || k >= total) throw Damaged();
        const int lo = code << (16 - n), hi = (code + 1) << (16 - n);
        std::fill(length.begin() + lo, length.begin() + hi, uint8_t(n));
        std::fill(symbol.begin() + lo, symbol.begin() + hi, symbols[k]);
        ++code;
        ++k;
      }
      code <<= 1;
    }
    defined = true;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int nbx = 0, nby = 0;       // blocks allocated (MCU-padded)
  std::vector<int32_t> coef;  // nby * nbx * 64, natural order
  int64_t q[64] = {};
  bool latched = false;
};

struct Reader {
  const uint8_t* d;
  int64_t n, pos;
  int u8() {
    if (pos >= n) throw Damaged();
    return d[pos++];
  }
  int u16() {
    const int hi = u8();
    return (hi << 8) | u8();
  }
};

int ceil_div(int64_t a, int64_t b) { return int((a + b - 1) / b); }

// The end of a scan's entropy-coded bytes: the first 0xFF that is neither
// a stuffed 0xFF00 nor a restart marker.
int64_t scan_end(const uint8_t* d, int64_t n, int64_t pos) {
  for (int64_t i = pos; i + 1 < n; ++i) {
    if (d[i] == 0xFF) {
      const uint8_t m = d[i + 1];
      if (m != 0x00 && !(m >= 0xD0 && m <= 0xD7)) return i;
    }
  }
  throw Damaged();
}

// One restart interval's unstuffed bytes, read 32 bits at a time.
class Bits {
 public:
  explicit Bits(std::vector<uint8_t>* bytes) : b_(bytes) {
    nbits_ = int64_t(b_->size()) * 8;
    b_->resize(b_->size() + 12, 0);
  }
  // Keep 32 or more bits in the window.  A run of damaged data that reads
  // past the padding is damaged.
  void fill() {
    if (nb_ < 32) {
      if ((wi_ + 1) * 4 > int64_t(b_->size())) throw Damaged();
      uint64_t w = 0;
      for (int i = 0; i < 4; ++i) w = (w << 8) | (*b_)[wi_ * 4 + i];
      acc_ = ((acc_ & ((uint64_t(1) << nb_) - 1)) << 32) | w;
      ++wi_;
      nb_ += 32;
    }
  }
  int peek16() const { return int((acc_ >> (nb_ - 16)) & 0xFFFF); }
  void skip(int n) { nb_ -= n; }
  int get(int s) {
    nb_ -= s;
    return int((acc_ >> nb_) & ((uint64_t(1) << s) - 1));
  }
  bool overran() const { return 32 * wi_ - nb_ > nbits_; }

 private:
  std::vector<uint8_t>* b_;
  int64_t nbits_, wi_ = 0;
  int nb_ = 0;
  uint64_t acc_ = 0;
};

int extend(int d, int s) { return d < (1 << (s - 1)) ? d - (1 << s) + 1 : d; }

void decode_scan(const uint8_t* d, int64_t start, int64_t end,
                 std::vector<Component>& comps, const std::vector<int>& members,
                 const std::vector<const Huffman*>& dc,
                 const std::vector<const Huffman*>& ac, int restart, int W,
                 int H, int hmax, int vmax, int mcux, int mcuy) {
  // the MCU layout: (member slot, block row, block col) per block
  struct Slot { int m, y, x; };
  std::vector<Slot> layout;
  int n_mcu, bw = 0;
  if (members.size() == 1) {
    const Component& c = comps[members[0]];
    bw = ceil_div(int64_t(W) * c.h, int64_t(hmax) * 8);
    const int bh = ceil_div(int64_t(H) * c.v, int64_t(vmax) * 8);
    n_mcu = bw * bh;
    layout.push_back({0, 0, 0});
  } else {
    for (size_t j = 0; j < members.size(); ++j) {
      const Component& c = comps[members[j]];
      for (int y = 0; y < c.v; ++y)
        for (int x = 0; x < c.h; ++x) layout.push_back({int(j), y, x});
    }
    n_mcu = mcux * mcuy;
  }
  const int per = restart ? restart : n_mcu;
  int64_t pos = start;
  int mcu = 0;
  for (int interval = 0; mcu < n_mcu; ++interval) {
    if (interval > 0) {  // the restart marker RST(interval - 1 mod 8)
      if (pos + 1 >= end || d[pos] != 0xFF ||
          d[pos + 1] != 0xD0 + ((interval - 1) & 7))
        throw Damaged();
      pos += 2;
    }
    std::vector<uint8_t> bytes;
    int64_t i = pos;
    while (i < end) {
      if (d[i] == 0xFF && i + 1 < end && d[i + 1] >= 0xD0 && d[i + 1] <= 0xD7)
        break;
      bytes.push_back(d[i]);
      i += (d[i] == 0xFF && i + 1 < end && d[i + 1] == 0x00) ? 2 : 1;
    }
    pos = i;
    Bits bits(&bytes);
    int pred[4] = {0, 0, 0, 0};
    const int stop = std::min(mcu + per, n_mcu);
    for (; mcu < stop; ++mcu) {
      const int my = bw ? mcu / bw : mcu / mcux;
      const int mx = bw ? mcu % bw : mcu % mcux;
      for (const Slot& s : layout) {
        Component& c = comps[members[s.m]];
        const int by = bw ? my : my * c.v + s.y;
        const int bx = bw ? mx : mx * c.h + s.x;
        int32_t* blk = c.coef.data() + (int64_t(by) * c.nbx + bx) * 64;
        bits.fill();
        int w = bits.peek16();
        int ln = dc[s.m]->length[w];
        if (!ln) throw Damaged();
        int sym = dc[s.m]->symbol[w];
        bits.skip(ln);
        if (sym > 15) throw Damaged();
        if (sym) pred[s.m] += extend(bits.get(sym), sym);
        blk[0] = pred[s.m];
        for (int k = 1; k < 64;) {
          bits.fill();
          w = bits.peek16();
          ln = ac[s.m]->length[w];
          if (!ln) throw Damaged();
          const int rs = ac[s.m]->symbol[w];
          bits.skip(ln);
          const int sz = rs & 15;
          if (sz) {
            k += rs >> 4;
            if (k > 63) throw Damaged();
            blk[kZigzag[k]] = extend(bits.get(sz), sz);
            ++k;
          } else if (rs == 0xF0) {
            k += 16;
          } else {
            break;  // end of block
          }
        }
      }
    }
    if (bits.overran()) throw Damaged();
  }
  if (pos != end) throw Damaged();  // more restart intervals than MCUs
}

// jpeg_idct_islow: one pass over 8 values x[0..7] (stride `is`), rounded by
// `shift` bits into out (stride `os`).
inline void idct_1d(const int64_t* x, int is, int64_t* out, int os, int shift) {
  int64_t z2 = x[2 * is], z3 = x[6 * is];
  int64_t z1 = (z2 + z3) * 4433;
  const int64_t tmp2 = z1 + z3 * -15137;
  const int64_t tmp3 = z1 + z2 * 6270;
  const int64_t tmp0 = (x[0] + x[4 * is]) * 8192;
  const int64_t tmp1 = (x[0] - x[4 * is]) * 8192;
  const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  int64_t t0 = x[7 * is], t1 = x[5 * is], t2 = x[3 * is], t3 = x[1 * is];
  z1 = t0 + t3;
  z2 = t1 + t2;
  z3 = t0 + t2;
  int64_t z4 = t1 + t3;
  const int64_t z5 = (z3 + z4) * 9633;
  t0 *= 2446;
  t1 *= 16819;
  t2 *= 25172;
  t3 *= 12299;
  z1 *= -7373;
  z2 *= -20995;
  z3 = z3 * -16069 + z5;
  z4 = z4 * -3196 + z5;
  t0 += z1 + z3;
  t1 += z2 + z4;
  t2 += z2 + z3;
  t3 += z1 + z4;
  const int64_t r = int64_t(1) << (shift - 1);
  out[0 * os] = (tmp10 + t3 + r) >> shift;
  out[7 * os] = (tmp10 - t3 + r) >> shift;
  out[1 * os] = (tmp11 + t2 + r) >> shift;
  out[6 * os] = (tmp11 - t2 + r) >> shift;
  out[2 * os] = (tmp12 + t1 + r) >> shift;
  out[5 * os] = (tmp12 - t1 + r) >> shift;
  out[3 * os] = (tmp13 + t0 + r) >> shift;
  out[4 * os] = (tmp13 - t0 + r) >> shift;
}

// The samples of a component [nby * 8, nbx * 8].
std::vector<uint8_t> idct_plane(const Component& c) {
  const int pw = c.nbx * 8;
  std::vector<uint8_t> plane(size_t(c.nby) * 8 * pw);
  int64_t x[64], ws[64], out[64];
  for (int by = 0; by < c.nby; ++by) {
    for (int bx = 0; bx < c.nbx; ++bx) {
      const int32_t* blk = c.coef.data() + (int64_t(by) * c.nbx + bx) * 64;
      for (int i = 0; i < 64; ++i) x[i] = int64_t(blk[i]) * c.q[i];
      // libjpeg's shortcuts for a column (row) whose AC terms are zero:
      // the full pass gives the same values
      for (int col = 0; col < 8; ++col) {
        bool ac = false;
        for (int k = 1; k < 8; ++k) ac |= x[k * 8 + col] != 0;
        if (ac) {
          idct_1d(x + col, 8, ws + col, 8, 11);
        } else {
          for (int k = 0; k < 8; ++k) ws[k * 8 + col] = x[col] * 4;
        }
      }
      for (int row = 0; row < 8; ++row) {
        bool ac = false;
        for (int k = 1; k < 8; ++k) ac |= ws[row * 8 + k] != 0;
        if (ac) {
          idct_1d(ws + row * 8, 1, out + row * 8, 1, 18);
        } else {
          for (int k = 0; k < 8; ++k) out[row * 8 + k] = (ws[row * 8] + 16) >> 5;
        }
      }
      for (int row = 0; row < 8; ++row) {
        uint8_t* dst = plane.data() + (size_t(by) * 8 + row) * pw + bx * 8;
        for (int col = 0; col < 8; ++col) {
          const int64_t s = ((out[row * 8 + col] + 512) & 1023) - 512;
          dst[col] = uint8_t(std::min<int64_t>(255, std::max<int64_t>(0, s + 128)));
        }
      }
    }
  }
  return plane;
}

// jdsample.c's upsampling of a component's dw x dh real samples (the rows
// of `plane` are `pw` apart) by (fh, fv), cropped to W x H.  Each filter
// is a convex sum rounded down, so the samples stay in 0..255.
std::vector<uint8_t> upsample(const std::vector<uint8_t>& plane, int pw,
                              int dw, int dh, int fh, int fv, int W, int H) {
  std::vector<uint8_t> out(size_t(W) * H);
  std::vector<int> cs(dw);
  std::vector<uint8_t> wide(size_t(dw) * fh);
  auto row = [&](int y) { return plane.data() + size_t(std::min(std::max(y, 0), dh - 1)) * pw; };
  for (int oy = 0; oy < H; ++oy) {
    uint8_t* dst = out.data() + size_t(oy) * W;
    const int i = oy / fv;
    const uint8_t* near = row(i);
    if (fh == 1 && fv == 1) {
      std::memcpy(dst, near, W);
    } else if (fh == 2 && fv == 1 && dw > 2) {  // h2v1
      for (int j = 0; j < dw; ++j) {
        const int x = 3 * near[j];
        wide[2 * j] = uint8_t((x + near[std::max(j - 1, 0)] + 1) >> 2);
        wide[2 * j + 1] = uint8_t((x + near[std::min(j + 1, dw - 1)] + 2) >> 2);
      }
      std::memcpy(dst, wide.data(), W);
    } else if (fh == 1 && fv == 2) {  // h1v2: the row above, bias 1, or below, 2
      const bool below = oy & 1;
      const uint8_t* far = row(below ? i + 1 : i - 1);
      for (int x = 0; x < W; ++x)
        dst[x] = uint8_t((3 * near[x] + far[x] + (below ? 2 : 1)) >> 2);
    } else if (fh == 2 && fv == 2 && dw > 2) {  // h2v2
      const uint8_t* far = row((oy & 1) ? i + 1 : i - 1);
      for (int j = 0; j < dw; ++j) cs[j] = 3 * near[j] + far[j];
      for (int j = 0; j < dw; ++j) {
        wide[2 * j] = uint8_t((3 * cs[j] + cs[std::max(j - 1, 0)] + 8) >> 4);
        wide[2 * j + 1] = uint8_t((3 * cs[j] + cs[std::min(j + 1, dw - 1)] + 7) >> 4);
      }
      std::memcpy(dst, wide.data(), W);
    } else {  // replication
      for (int x = 0; x < W; ++x) dst[x] = near[x / fh];
    }
  }
  return out;
}

uint8_t clamp255(int v) { return uint8_t(std::min(255, std::max(0, v))); }

int jpeg_decode(const uint8_t* d, int64_t n, uint8_t* out, int outH, int outW) {
  Reader r{d, n, 0};
  if (r.u8() != 0xFF || r.u8() != 0xD8) throw Damaged();
  Huffman tables[2][4];
  int64_t qt[4][64];
  bool qdef[4] = {false, false, false, false};
  std::vector<Component> comps;
  int H = 0, W = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0, restart = 0;
  bool jfif = false, scanned = false;
  int adobe = -1;
  for (;;) {
    if (r.u8() != 0xFF) throw Damaged();
    int m;
    while ((m = r.u8()) == 0xFF) {
    }
    if (m == 0xD9) break;
    if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
    const int L = r.u16();
    if (L < 2 || r.pos + L - 2 > n) throw Damaged();
    const int64_t body = r.pos, body_end = r.pos + L - 2;
    if (m == 0xE0 && L - 2 >= 5 && !std::memcmp(d + body, "JFIF\0", 5)) {
      jfif = true;
    } else if (m == 0xEE && L - 2 >= 12 && !std::memcmp(d + body, "Adobe", 5)) {
      adobe = d[body + 11];
    } else if (m == 0xDB) {
      while (r.pos < body_end) {
        const int pt = r.u8(), pq = pt >> 4, tq = pt & 15;
        if (tq > 3 || pq > 1 || r.pos + (pq ? 128 : 64) > body_end) throw Damaged();
        for (int k = 0; k < 64; ++k) qt[tq][kZigzag[k]] = pq ? r.u16() : r.u8();
        qdef[tq] = true;
      }
    } else if (m == 0xC4) {
      while (r.pos < body_end) {
        if (r.pos + 17 > body_end) throw Damaged();
        const int t = r.u8(), tc = t >> 4, th = t & 15;
        uint8_t counts[16];
        int total = 0;
        for (int k = 0; k < 16; ++k) total += counts[k] = uint8_t(r.u8());
        if (tc > 1 || th > 3 || total > 256 || r.pos + total > body_end)
          throw Damaged();
        tables[tc][th].build(counts, d + r.pos, total);
        r.pos += total;
      }
    } else if (m == 0xC0 || m == 0xC1) {
      if (!comps.empty() || L - 2 < 6 || r.u8() != 8) throw Damaged();
      H = r.u16();
      W = r.u16();
      const int nc = r.u8();
      if ((nc != 1 && nc != 3) || L - 2 != 6 + 3 * nc || !H || !W) throw Damaged();
      for (int c = 0; c < nc; ++c) {
        Component comp;
        comp.id = r.u8();
        const int hv = r.u8();
        comp.h = hv >> 4;
        comp.v = hv & 15;
        comp.tq = r.u8();
        if (comp.h < 1 || comp.h > 4 || comp.v < 1 || comp.v > 4 || comp.tq > 3)
          throw Damaged();
        hmax = std::max(hmax, comp.h);
        vmax = std::max(vmax, comp.v);
        comps.push_back(comp);
      }
      mcux = ceil_div(W, 8 * hmax);
      mcuy = ceil_div(H, 8 * vmax);
      for (Component& c : comps) {
        if (hmax % c.h || vmax % c.v) throw Damaged();
        c.nbx = mcux * c.h;
        c.nby = mcuy * c.v;
        c.coef.assign(size_t(c.nbx) * c.nby * 64, 0);
      }
    } else if (m == 0xDD) {
      if (L != 4) throw Damaged();
      restart = r.u16();
    } else if (m == 0xDA) {
      if (comps.empty()) throw Damaged();
      const int ns = r.u8();
      if (ns < 1 || ns > int(comps.size()) || L - 2 != 4 + 2 * ns) throw Damaged();
      std::vector<int> members;
      std::vector<const Huffman*> dc, ac;
      for (int j = 0; j < ns; ++j) {
        const int cid = r.u8(), t = r.u8();
        int ci = -1;
        for (size_t c = 0; c < comps.size(); ++c)
          if (comps[c].id == cid) ci = int(c);
        if (ci < 0 || (t >> 4) > 3 || (t & 15) > 3) throw Damaged();
        for (int cls = 0; cls < 2; ++cls) {
          const int th = cls ? (t & 15) : (t >> 4);
          Huffman& h = tables[cls][th];
          if (!h.defined) {  // Annex K's tables for an undefined slot
            if (th > 1) throw Damaged();
            if (cls == 0) {
              const uint8_t vals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
              h.build(kStdDcBits[th], vals, 12);
            } else {
              h.build(kStdAcBits[th], kStdAcVals[th], 162);
            }
          }
          (cls ? ac : dc).push_back(&h);
        }
        members.push_back(ci);
        Component& c = comps[ci];
        if (!c.latched) {
          if (!qdef[c.tq]) throw Damaged();
          std::memcpy(c.q, qt[c.tq], sizeof(c.q));
          c.latched = true;
        }
      }
      const int ss = r.u8(), se = r.u8(), ahal = r.u8();
      if (ss != 0 || se != 63 || ahal != 0) throw Damaged();
      if (ns > 1) {
        int blocks = 0;
        for (int ci : members) blocks += comps[ci].h * comps[ci].v;
        if (blocks > 10) throw Damaged();
      }
      const int64_t end = scan_end(d, n, r.pos);
      decode_scan(d, r.pos, end, comps, members, dc, ac, restart, W, H, hmax,
                  vmax, mcux, mcuy);
      r.pos = end;
      scanned = true;
      continue;
    } else if ((m >= 0xC2 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) ||
               m == 0xDC) {
      throw Damaged();  // the Python form refuses these first
    }
    r.pos = body_end;
  }
  if (!scanned) throw Damaged();
  for (const Component& c : comps)
    if (!c.latched) throw Damaged();
  if (H != outH || W != outW) return 2;
  std::vector<std::vector<uint8_t>> planes;
  for (const Component& c : comps) {
    const std::vector<uint8_t> plane = idct_plane(c);
    planes.push_back(upsample(plane, c.nbx * 8, ceil_div(int64_t(W) * c.h, hmax),
                              ceil_div(int64_t(H) * c.v, vmax), hmax / c.h,
                              vmax / c.v, W, H));
  }
  const size_t npx = size_t(W) * H;
  if (comps.size() == 1) {
    for (size_t i = 0; i < npx; ++i)
      out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = planes[0][i];
    return 0;
  }
  bool rgb;
  if (adobe >= 0 && !jfif)
    rgb = adobe == 0;
  else
    rgb = !jfif && comps[0].id == 82 && comps[1].id == 71 && comps[2].id == 66;
  if (rgb) {
    for (size_t i = 0; i < npx; ++i) {
      out[3 * i] = planes[2][i];
      out[3 * i + 1] = planes[1][i];
      out[3 * i + 2] = planes[0][i];
    }
    return 0;
  }
  // jdcolor.c's tables at SCALEBITS 16 (the G tables carry the rounding)
  int cr_r[256], cb_b[256], cr_g[256], cb_g[256];
  for (int k = 0; k < 256; ++k) {
    const int x = k - 128;
    cr_r[k] = (91881 * x + 32768) >> 16;
    cb_b[k] = (116130 * x + 32768) >> 16;
    cr_g[k] = -46802 * x;
    cb_g[k] = -22554 * x + 32768;
  }
  const uint8_t *Y = planes[0].data(), *Cb = planes[1].data(), *Cr = planes[2].data();
  for (size_t i = 0; i < npx; ++i) {
    const int y = Y[i], cb = Cb[i], cr = Cr[i];
    out[3 * i] = clamp255(y + cb_b[cb]);
    out[3 * i + 1] = clamp255(y + ((cb_g[cb] + cr_g[cr]) >> 16));
    out[3 * i + 2] = clamp255(y + cr_r[cr]);
  }
  return 0;
}

int paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

}  // namespace

extern "C" {

// Decode the JPEG in data[0:n] into out [H, W, 3] BGR.  0: decoded; 1: the
// data are truncated or damaged (or of a kind the Python form refuses);
// 2: the frame is not H x W.
int ofc_jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out, int H, int W) {
  try {
    return jpeg_decode(data, n, out, H, W);
  } catch (const Damaged&) {
    return 1;
  } catch (...) {  // out of memory
    return 3;
  }
}

// Undo the PNG row filters of raw (H rows of a filter byte and W * bpp
// bytes) into out [H, W * bpp].  0: done; 1: an unknown filter type.
int ofc_png_unfilter(const uint8_t* raw, uint8_t* out, int H, int W, int bpp) {
  const int64_t stride = int64_t(W) * bpp;
  for (int y = 0; y < H; ++y) {
    const uint8_t* src = raw + y * (stride + 1);
    const int ft = src[0];
    ++src;
    uint8_t* row = out + y * stride;
    const uint8_t* up = y ? row - stride : nullptr;
    for (int64_t i = 0; i < stride; ++i) {
      const int a = i >= bpp ? row[i - bpp] : 0;
      const int b = up ? up[i] : 0;
      const int c = (up && i >= bpp) ? up[i - bpp] : 0;
      int pred;
      switch (ft) {
        case 0: pred = 0; break;
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: pred = paeth(a, b, c); break;
        default: return 1;
      }
      row[i] = uint8_t(src[i] + pred);
    }
  }
  return 0;
}

}  // extern "C"
