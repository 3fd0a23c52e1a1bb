// K6: RAFT's windowed multi-scale correlation lookup, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference leaves the stage to XLA
// (ops/allpairs.py `corr_lookup` over its packed pyramid).  It computes the
// plain version, ops/allpairs.py `_lookup_packed(packed, flow, radius)`:
// for each source pixel p = (x, y) of image b, each level l of the packed
// pyramid (its first column col_l in p's row of `flat`, height h_l, width
// w_l) and each offset (dy, dx) in [-R, R]^2, row-major,
//   cx = x + u,  sx = cx * 2^-l + dx  (and sy likewise from y + v),
//   out[b, l (2R+1)^2 + (dy+R)(2R+1) + (dx+R), y, x] =
//     bilinear(level l of p's row, sx, sy),
// each of the four taps read as zero outside the level (so a level one
// pixel wide, or empty, reads as the plain version reads it).  flat
// [B, H*W, K] fp32 -> out [B, L (2R+1)^2, H, W] fp32: the update's layout,
// with no permute or copy after.  The coordinates, the floors, the weights
// and the four-tap sum are formed with __fmul_rn / __fadd_rn / __fsub_rn
// in the plain version's order (no FMA contraction), so the kernel gives
// the plain version's values bit for bit.
//
// Bound: bytes.  Each source pixel owns its own row of `flat` (42,900
// floats, 171.6 KB, at 1080p), so nothing is shared across pixels; inside a
// pixel's window a level's (2R+1)^2 samples read only (2R+2)^2 distinct
// taps.  Least traffic: those taps (at most 400 floats a pixel for R = 4 and
// four levels) read once, the flow read once and the L (2R+1)^2 samples
// written once: ~104 MB in and 84 MB out at 1080p, B = 2, R = 4.  A few
// flops a sample leave the fp32 pipe idle.  The plain version builds
// [B, H, W, L, (2R+1)^2, 4] int64 index, mask and weight temporaries in
// ~59 launches.
//
// Design: a block of 256 threads owns a strip of 32 consecutive source
// pixels of one image (flattened over H*W, so a strip may cross a row).
//   0. the first 32 threads load their pixel's flow and compute, per level,
//      the floor of the window's centre, clamped far outside any level;
//   1. every level's window of every pixel of the strip is staged in
//      shared memory with 4-byte cp.async copies, which zero-fill the taps
//      outside a level (src-size 0) and keep all of a thread's copies in
//      flight at once: (2R+3)^2 floats a level, one row and one column
//      more than 2R+2, because the rounding of sx = cx 2^-l + dx can move
//      a sample's floor one above floor(cx 2^-l) + dx.  Consecutive lanes
//      copy consecutive columns of one window row (2R+3 floats at a stride
//      of w_l), so a warp's copies fall on a few sectors.  TMA does not
//      fit: the coarsest level's row stride at 1080p is 30 floats, 120 B,
//      and TMA wants strides in multiples of 16 B;
//   2. lane i computes pixel i's samples, warp w the channels w, w + 8, ...,
//      from shared memory (each pixel's windows at an odd stride, so the
//      32 lanes' reads fall in distinct banks), and each channel's store is
//      one contiguous run out[b, c, p0 : p0 + 32], coalesced.
// Shared memory is 32 ((L (2R+3)^2) | 1) floats plus the strip's centres
// and floors: 64.5 KB for R = 4 and four levels, three blocks an SM.  The
// launcher opts in above 48 KB, once for each size it has not yet granted.
// R is a template parameter (0 .. kMaxRadius); the level count and sizes
// are run-time arguments, at most kMaxLevels.  Offsets into `flat` are
// 64-bit (B H W K is 2.8e9 at 1080p, B = 2).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPixels = 32;       // a block's strip: one pixel a lane
constexpr int kMaxLevels = 8;
constexpr int kMaxRadius = 4;
constexpr int kMaxDevices = 64;   // devices whose shared-memory grant is kept
constexpr float kFar = 65536.0f;  // beyond any level's side (the wrapper checks)

struct Levels {
  int count;
  int col[kMaxLevels];  // first column of the level in a row of `flat`
  int h[kMaxLevels];
  int w[kMaxLevels];
};

__device__ __forceinline__ void copy4_zfill(float* dst, const float* src,
                                            bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(in ? 4 : 0));
}

// floor(c), clamped to [-kFar, kFar] (NaN to -kFar): outside that range
// every tap of the window is off the level
__device__ __forceinline__ int window_floor(float c) {
  return static_cast<int>(fminf(fmaxf(floorf(c), -kFar), kFar));
}

__device__ __forceinline__ float level_scale(int l) {  // 2^-l, exact
  return __int_as_float((127 - l) << 23);
}

template <int R>
__global__ void __launch_bounds__(kThreads)
allpairs_lookup_kernel(const float* __restrict__ flat,
                       const float* __restrict__ flow, float* __restrict__ out,
                       int HW, int W, int K, Levels lv) {
  constexpr int N = 2 * R + 1;  // samples along a window's side
  constexpr int T = N * N;      // samples a level
  constexpr int S = N + 2;      // staged side
  constexpr int kWin = S * S;
  const int L = lv.count;
  const int stride = (L * kWin) | 1;  // floats a pixel, odd
  extern __shared__ float smem[];
  float* win = smem;                            // [kPixels][stride]
  float* cxs = win + kPixels * stride;          // [kPixels]
  float* cys = cxs + kPixels;                   // [kPixels]
  int* base = reinterpret_cast<int*>(cys + kPixels);  // [kMaxLevels][2][kPixels]
  int* lvs = base + kMaxLevels * 2 * kPixels;   // col, h, w [kMaxLevels] each

  const int b = blockIdx.y;
  const int p0 = blockIdx.x * kPixels;
  const int tid = threadIdx.x;
  if (tid == 0) {  // constant indices: the parameter stays in its bank
#pragma unroll
    for (int l = 0; l < kMaxLevels; ++l) {
      lvs[l] = lv.col[l];
      lvs[kMaxLevels + l] = lv.h[l];
      lvs[2 * kMaxLevels + l] = lv.w[l];
    }
  }
  if (tid < kPixels) {
    const int p = p0 + tid;
    float cx = 0.0f, cy = 0.0f;
    if (p < HW) {
      const int y = p / W;
      const float* f = flow + static_cast<int64_t>(b) * 2 * HW + p;
      cx = __fadd_rn(static_cast<float>(p - y * W), f[0]);
      cy = __fadd_rn(static_cast<float>(y), f[HW]);
    }
    cxs[tid] = cx;
    cys[tid] = cy;
    for (int l = 0; l < L; ++l) {
      const float s = level_scale(l);
      // a pixel past the image reads nothing: its window is far off
      base[(2 * l) * kPixels + tid] =
          p < HW ? window_floor(__fmul_rn(cy, s)) - R : -(1 << 20);
      base[(2 * l + 1) * kPixels + tid] =
          p < HW ? window_floor(__fmul_rn(cx, s)) - R : -(1 << 20);
    }
  }
  __syncthreads();

  // 1. stage the windows: element e = ((l * kPixels + i) * S + row) * S + col
  const int64_t row0 = static_cast<int64_t>(b) * HW + p0;
  const int total = L * kPixels * kWin;
  for (int e = tid; e < total; e += kThreads) {
    const int q = e / kWin;
    const int rem = e - q * kWin;
    const int row = rem / S;
    const int col = rem - row * S;
    const int l = q / kPixels;
    const int i = q - l * kPixels;
    const int gy = base[(2 * l) * kPixels + i] + row;
    const int gx = base[(2 * l + 1) * kPixels + i] + col;
    const int w = lvs[2 * kMaxLevels + l];
    const bool in = gy >= 0 && gy < lvs[kMaxLevels + l] && gx >= 0 && gx < w;
    const float* src =
        in ? flat + (row0 + i) * K + lvs[l] + gy * w + gx : flat;
    copy4_zfill(win + i * stride + l * kWin + rem, src, in);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // 2. the samples: lane i is pixel p0 + i, warp w the channels w, w + 8, ...
  const int i = tid % kPixels;
  const int p = p0 + i;
  if (p >= HW) return;
  const float cx = cxs[i];
  const float cy = cys[i];
  const float* mine = win + i * stride;
  float* dst = out + static_cast<int64_t>(b) * L * T * HW + p;
  for (int c = tid / kPixels; c < L * T; c += kThreads / kPixels) {
    const int l = c / T;
    const int s = c - l * T;
    const int dy = s / N;
    const int dx = s - dy * N;
    const float scale = level_scale(l);
    const float sx = __fadd_rn(__fmul_rn(cx, scale), static_cast<float>(dx - R));
    const float sy = __fadd_rn(__fmul_rn(cy, scale), static_cast<float>(dy - R));
    const float x0 = floorf(sx);
    const float y0 = floorf(sy);
    const float wx = __fsub_rn(sx, x0);
    const float wy = __fsub_rn(sy, y0);
    const float ox = __fsub_rn(1.0f, wx);
    const float oy = __fsub_rn(1.0f, wy);
    // the sample's floor within the staged window: 0 .. 2R+1 (clamped only
    // where the window lies far off the level and holds zeros)
    const int jx = static_cast<int>(fminf(fmaxf(
        x0 - static_cast<float>(base[(2 * l + 1) * kPixels + i]), 0.0f),
        static_cast<float>(S - 2)));
    const int jy = static_cast<int>(fminf(fmaxf(
        y0 - static_cast<float>(base[(2 * l) * kPixels + i]), 0.0f),
        static_cast<float>(S - 2)));
    const float* v = mine + l * kWin + jy * S + jx;
    float acc = __fmul_rn(__fmul_rn(v[0], ox), oy);
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v[1], wx), oy));
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v[S], ox), wy));
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v[S + 1], wx), wy));
    dst[static_cast<int64_t>(c) * HW] = acc;
  }
}

template <int R>
cudaError_t launch(const float* flat, const float* flow, float* out, int B,
                   int HW, int W, int K, const Levels& lv,
                   cudaStream_t stream) {
  constexpr int kWin = (2 * R + 3) * (2 * R + 3);
  const int smem_bytes =
      4 * (kPixels * ((lv.count * kWin) | 1) + 2 * kPixels +
           2 * kMaxLevels * kPixels + 3 * kMaxLevels);
  static int granted[kMaxDevices] = {};
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (smem_bytes > 48 * 1024 &&
      (device >= kMaxDevices || smem_bytes > granted[device])) {
    e = cudaFuncSetAttribute(allpairs_lookup_kernel<R>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
    if (e != cudaSuccess) return e;
    if (device < kMaxDevices) granted[device] = smem_bytes;
  }
  const dim3 grid((HW + kPixels - 1) / kPixels, B);
  allpairs_lookup_kernel<R>
      <<<grid, kThreads, smem_bytes, stream>>>(flat, flow, out, HW, W, K, lv);
  return cudaGetLastError();
}

}  // namespace

// flat: [B, H*W, K] fp32 contiguous, the packed pyramid; flow: [B, 2, H, W]
// fp32 contiguous (u, v); out: [B, levels (2 radius + 1)^2, H, W] fp32
// contiguous; all on the current device (the caller selects it).  sizes:
// on the host, levels triples (first column, h_l, w_l) with each level's
// columns inside K and each side below 65536.  radius 0 .. kMaxRadius,
// levels 1 .. kMaxLevels, 1 <= B <= 65535, H W >= 1.  Launches once on
// `stream` and returns cudaGetLastError().
extern "C" int ofc_allpairs_lookup(const void* flat, const void* flow,
                                   void* out, int B, int H, int W, int K,
                                   int radius, int levels, const int* sizes,
                                   void* stream) {
  if (levels < 1 || levels > kMaxLevels || radius < 0 ||
      radius > kMaxRadius || B < 1 || B > 65535 || H < 1 || W < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Levels lv = {};
  lv.count = levels;
  for (int l = 0; l < levels; ++l) {
    const int col = sizes[3 * l], h = sizes[3 * l + 1], w = sizes[3 * l + 2];
    if (col < 0 || h < 0 || w < 0 || h >= 65536 || w >= 65536 ||
        static_cast<int64_t>(col) + static_cast<int64_t>(h) * w > K) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    lv.col[l] = col;
    lv.h[l] = h;
    lv.w[l] = w;
  }
  const float* fp = static_cast<const float*>(flat);
  const float* up = static_cast<const float*>(flow);
  float* op = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int HW = H * W;
  switch (radius) {
    case 0:
      return static_cast<int>(launch<0>(fp, up, op, B, HW, W, K, lv, s));
    case 1:
      return static_cast<int>(launch<1>(fp, up, op, B, HW, W, K, lv, s));
    case 2:
      return static_cast<int>(launch<2>(fp, up, op, B, HW, W, K, lv, s));
    case 3:
      return static_cast<int>(launch<3>(fp, up, op, B, HW, W, K, lv, s));
    default:
      return static_cast<int>(launch<4>(fp, up, op, B, HW, W, K, lv, s));
  }
}
