// K5: Farneback's prep stage of one pyramid level, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference leaves the stage to XLA
// (classical/farneback.py: the level's Gaussian at full resolution, the
// bilinear resize, `_poly_planes`).  It is the plain version's
// (ops/farneback_prep.py `farneback_prep_plain`) mathematics, cv2's, in one
// pass: [N, H, W] fp32 frames -> level k's [N, 5, lh, lw] fp32 expansion
// planes (bx, by, axx, ayy, qxy), plane-major as K1 reads them.
//   1. the reflect101 Gaussian of 2p+1 taps at full resolution, vertical
//      pass then horizontal, evaluated only at the source rows and columns
//      the bilinear resize reads (two of each a level pixel; one where an
//      axis keeps its size), through the wrapper's pad index tables
//      (numpy's pad, any frame size);
//   2. the bilinear resize with the wrapper's (lo, hi, w) tables, rows
//      before columns, a * (1 - w) + b * w;
//   3. the polynomial expansion over the level tile and its `N`-pixel halo
//      (replicate border: a clamp at the level's edges): three vertical
//      passes (g, xg, xxg), six horizontal ones, and the five weighted
//      planes.
// Only the order of the fp32 sums differs from the plain version (each
// sum runs over its taps in the same order, with FMA contraction).
//
// Bound: bytes.  Each frame is read once a level and the five planes are
// written once: (H W + 5 lh lw) fp32 values a frame and level, 18.4 MB a
// 720p frame over the four levels of cv2's defaults; the halo and the
// blur's row re-reads come from L1/L2.  The plain version makes ~30 fp32
// passes a plane in ~240 launches a level.
//
// Design: one block of 256 threads per TILE x TILE level tile per frame,
// the frames in the grid's y (all T x S frames of a clip call in one
// launch).  TILE is 32, or 16 where the blur is wide or a level's grid of
// 32-tiles would leave the SMs short of blocks (the wrapper's choice,
// fitted to both tiles' times on the H100).  A block first puts in
// shared memory the source row (column) of each padded row (column) its
// blur reads and each slot's offset among them, so the passes read no
// index table from global memory.  Everything between the frame and the
// planes stays in shared memory:
//   vert     [strip_rows][span_w]   the vertical blur at the slots' source
//                                   rows, over the padded columns the
//                                   horizontal pass reads, strip by strip
//                                   (the wrapper caps a strip at 32 KB);
//   level    [TILE + 2N]^2          the tile and its halo, blurred
//                                   horizontally at the column slots and
//                                   resized straight from `vert`;
//   ex       [3][TILE][TILE + 2N + 1] the expansion's vertical passes, in
//                                   the strip's space.
// The vertical blur reads a pair of row slots from K + 1 rows with every
// load unconditional; the expansion keeps the values neighbouring outputs
// share in registers (two rows a thread down, four columns across) and
// writes each plane's row with 16-byte stores.  The wrapper sizes the
// dynamic shared memory; above 48 KB the launcher opts in, once for each
// size it has not yet granted.  The template on N (cv2's poly_n 5 and 7)
// unrolls the expansion's taps, which are a kernel parameter (constant
// bank).  N = 0 is the variant for every other poly_n up to kMaxPolyN,
// read at run time: the same stages and the same sums in the same order,
// the expansion's passes reading each value from shared memory (no
// register blocking).  Offsets into the batch are 64-bit.
//
// Measured on the H100 (graph replay, PERF.md): the 720p clip's 7 frames,
// all four levels, 0.332 ms against a 0.082 ms bound (the finest level 42%
// of its bound, the coarse ones 11-22%: their blur's re-reads and halo);
// the shifted-slice sums took 17.9 ms.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
// poly_n the kernel takes: the parameter block holds 2 kMaxPolyN + 1 taps
// of each 1-D kernel (372 bytes), and a 32-tile block's shared memory stays
// under 100 KB at every level of frames up to 4K (the wrapper's check)
constexpr int kMaxPolyN = 15;
constexpr int kMaxPolyTaps = 2 * kMaxPolyN + 1;
constexpr int kMaxDevices = 64;   // devices whose shared-memory grant is kept

struct PolyTaps {
  float g[kMaxPolyTaps], xg[kMaxPolyTaps], xxg[kMaxPolyTaps];
  float ig11, ig03, ig33, ig55;  // the inverse moment matrix's elements
  int n;                         // poly_n, 1 .. kMaxPolyN
};

struct Level {
  const float* img;  // [frames, H, W]
  float* out;        // [frames, 5, lh, lw]
  const int64_t* row_pad;  // [H + 2p] source row of each padded row
  const int64_t* col_pad;  // [W + 2p]
  const int64_t* row_lo;   // [lh] resize taps; null where lh == H
  const int64_t* row_hi;
  const float* row_w;
  const int64_t* col_lo;   // [lw]; null where lw == W
  const int64_t* col_hi;
  const float* col_w;
  const float* blur;  // [2p + 1]
  int H, W, lh, lw, p;
  int tiles_x;
  int span_h, span_w;  // padded rows (columns) one tile's blur reads, at most
  int strip_rows;      // row slots a pass of the vertical blur covers
};

// Shared memory of one block, in 4-byte words, in this order (the wrapper
// computes the same sum): the blur's taps and the four index tables, the
// vertical blur's strip (whose space the expansion's vertical passes reuse),
// the blur at the slots, and the resized tile.  N: poly_n unrolled (5 or
// 7), or 0 for P.n at run time.
template <int TILE, int N>
__global__ void __launch_bounds__(kThreads)
farneback_prep_kernel(const Level L, const PolyTaps P) {
  const int n = N > 0 ? N : P.n;
  const int E = TILE + 2 * n;  // level rows (columns) the tile reads
  extern __shared__ float smem[];
  const int ry = L.row_lo ? 2 : 1;  // source rows (columns) a level row reads
  const int rx = L.col_lo ? 2 : 1;
  const int RH = E * ry;
  const int RW = E * rx;
  const int K = 2 * L.p + 1;
  const int strip_w = L.span_w;
  float* taps = smem;                                    // [K]
  int* row_src = reinterpret_cast<int*>(taps + K);       // [span_h]
  int* col_src = row_src + L.span_h;                     // [span_w]
  int* row_slot = col_src + L.span_w;                    // [RH]
  int* col_slot = row_slot + RH;                         // [RW]
  float* vert = reinterpret_cast<float*>(col_slot + RW);  // [strip_rows][strip_w]
  float* ex = vert;                                  // [3][TILE][E + 1], later
  float* level = vert + max(L.strip_rows * strip_w, 3 * TILE * (E + 1));  // [E][E]

  const int tid = threadIdx.x;
  const int ty0 = (blockIdx.x / L.tiles_x) * TILE;
  const int tx0 = (blockIdx.x % L.tiles_x) * TILE;
  const int64_t frame = blockIdx.y;
  const float* img = L.img + frame * L.H * L.W;

  // level row (column) of extended index e, replicate border
  auto level_row = [&](int e) { return min(max(ty0 - n + e, 0), L.lh - 1); };
  auto level_col = [&](int e) { return min(max(tx0 - n + e, 0), L.lw - 1); };
  // first padded row (column) of the blur at row (column) slot s
  auto slot_row = [&](int s) -> int {
    if (ry == 1) return level_row(s);
    const int a = level_row(s >> 1);
    return static_cast<int>((s & 1) ? L.row_hi[a] : L.row_lo[a]);
  };
  auto slot_col = [&](int s) -> int {
    if (rx == 1) return level_col(s);
    const int a = level_col(s >> 1);
    return static_cast<int>((s & 1) ? L.col_hi[a] : L.col_lo[a]);
  };

  // the tables: each slot's first padded row (column) relative to the
  // tile's first, and the source row (column) of each padded one
  const int pr0 = slot_row(0);
  const int pc0 = slot_col(0);
  const int sh = slot_row(RH - 1) - pr0 + 2 * L.p + 1;  // <= span_h
  const int sw = slot_col(RW - 1) - pc0 + 2 * L.p + 1;  // <= span_w
  for (int i = tid; i < K; i += kThreads) taps[i] = L.blur[i];
  for (int i = tid; i < sh; i += kThreads) row_src[i] = static_cast<int>(L.row_pad[pr0 + i]);
  for (int i = tid; i < sw; i += kThreads) col_src[i] = static_cast<int>(L.col_pad[pc0 + i]);
  for (int i = tid; i < RH; i += kThreads) row_slot[i] = slot_row(i) - pr0;
  for (int i = tid; i < RW; i += kThreads) col_slot[i] = slot_col(i) - pc0;
  __syncthreads();

  // 1. the blur at the slots and the resize, a strip of row slots at a
  //    time.  Row slots come in pairs (2m, 2m + 1) whose first padded rows
  //    are equal or one apart (the resize's lo and hi taps of one level
  //    row, or two neighbouring rows of a kept axis), so a thread blurs
  //    both vertically from K + 1 values into `vert`; then a thread blurs
  //    a pair's two rows horizontally at one level column's slots and
  //    resizes them into `level`.  Each sum runs over its taps in order;
  //    the resize takes rows, then columns.
  for (int s0 = 0; s0 < RH; s0 += L.strip_rows) {
    const int pairs = min(L.strip_rows, RH - s0) / 2;
    for (int i = tid; i < pairs * sw; i += kThreads) {
      const int m = i / sw;
      const int c = i - m * sw;
      const float* src = img + col_src[c];
      const int* rs = row_src + row_slot[s0 + 2 * m];
      const int d = row_slot[s0 + 2 * m + 1] - row_slot[s0 + 2 * m];
      // tap t reads row t (lo) and row t + d (hi): one new row a tap, every
      // load unconditional, so the unrolled loads are all in flight at once
      float prev = src[static_cast<int64_t>(rs[0]) * L.W];
      float row = src[static_cast<int64_t>(rs[d]) * L.W];
      float lo = taps[0] * prev;
      float hi = taps[0] * row;
#pragma unroll 8
      for (int t = 1; t < K; ++t) {
        prev = row;
        row = src[static_cast<int64_t>(rs[t + d]) * L.W];
        lo = fmaf(taps[t], d ? prev : row, lo);
        hi = fmaf(taps[t], row, hi);
      }
      vert[2 * m * strip_w + c] = lo;
      vert[(2 * m + 1) * strip_w + c] = hi;
    }
    __syncthreads();
    for (int i = tid; i < pairs * E; i += kThreads) {
      const int m = i / E;
      const int q = i - m * E;
      const int cs = col_slot[q * rx];
      const int dc = rx == 2 ? col_slot[2 * q + 1] - cs : 0;
      const float* v0 = vert + 2 * m * strip_w + cs;  // row slot 2m
      const float* v1 = v0 + strip_w;                  // row slot 2m + 1
      // b<row><column>: the blur at the pair's rows x the column's slots
      float b00 = taps[0] * v0[0], b10 = taps[0] * v1[0];
      float b01 = taps[0] * v0[dc], b11 = taps[0] * v1[dc];
      if (rx == 2) {
#pragma unroll 4
        for (int t = 1; t < K; ++t) {
          b00 = fmaf(taps[t], v0[t], b00);
          b10 = fmaf(taps[t], v1[t], b10);
          b01 = fmaf(taps[t], v0[t + dc], b01);
          b11 = fmaf(taps[t], v1[t + dc], b11);
        }
      } else {
#pragma unroll 4
        for (int t = 1; t < K; ++t) {
          b00 = fmaf(taps[t], v0[t], b00);
          b10 = fmaf(taps[t], v1[t], b10);
        }
      }
      const float wx = rx == 2 ? L.col_w[level_col(q)] : 0.0f;
      if (ry == 2) {  // the pair is one level row's lo and hi
        const int e = s0 / 2 + m;
        const float wy = L.row_w[level_row(e)];
        float v = b00 * (1.0f - wy) + b10 * wy;
        if (rx == 2) v = v * (1.0f - wx) + (b01 * (1.0f - wy) + b11 * wy) * wx;
        level[e * E + q] = v;
      } else {  // two level rows
        const int e = s0 + 2 * m;
        level[e * E + q] = rx == 2 ? b00 * (1.0f - wx) + b01 * wx : b00;
        level[(e + 1) * E + q] = rx == 2 ? b10 * (1.0f - wx) + b11 * wx : b10;
      }
    }
    __syncthreads();
  }

  // 3. the expansion: vertical passes over the tile's rows and the halo's
  //    columns, then horizontal passes into the five planes.  `ex` rows
  //    have an odd stride (ES).
  const int ES = E + 1;
  float* tg = ex;
  float* txg = ex + TILE * ES;
  float* txxg = ex + 2 * TILE * ES;
  const int64_t plane = static_cast<int64_t>(L.lh) * L.lw;
  float* frame_out = L.out + frame * 5 * plane;
  if constexpr (N > 0) {
    // two rows a thread down, CB outputs along x a thread across: a thread
    // keeps the values its outputs share in registers
    constexpr int NT = 2 * N + 1;
    constexpr int RB = 2;
    constexpr int CB = TILE * TILE / kThreads;
    for (int i = tid; i < (TILE / RB) * E; i += kThreads) {
      const int g = i / E;
      const int q = i - g * E;
      const float* col = level + g * RB * E + q;
      float x[RB + NT - 1];
#pragma unroll
      for (int j = 0; j < RB + NT - 1; ++j) x[j] = col[j * E];
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        float a = P.g[0] * x[r];
        float b = P.xg[0] * x[r];
        float c = P.xxg[0] * x[r];
#pragma unroll
        for (int t = 1; t < NT; ++t) {
          a = fmaf(P.g[t], x[r + t], a);
          b = fmaf(P.xg[t], x[r + t], b);
          c = fmaf(P.xxg[t], x[r + t], c);
        }
        const int o = (g * RB + r) * ES + q;
        tg[o] = a;
        txg[o] = b;
        txxg[o] = c;
      }
    }
    __syncthreads();

    const int r = tid / (TILE / CB);
    const int q0 = (tid - r * (TILE / CB)) * CB;
    const int y = ty0 + r;
    if (y >= L.lh) return;
    float a[CB + NT - 1], b[CB + NT - 1], c[CB + NT - 1];
#pragma unroll
    for (int j = 0; j < CB + NT - 1; ++j) {
      a[j] = tg[r * ES + q0 + j];
      b[j] = txg[r * ES + q0 + j];
      c[j] = txxg[r * ES + q0 + j];
    }
    float v[5][CB];
#pragma unroll
    for (int j = 0; j < CB; ++j) {
      float s0 = P.g[0] * a[j], sx = P.xg[0] * a[j], sxx = P.xxg[0] * a[j];
      float sy = P.g[0] * b[j], sxy = P.xg[0] * b[j], syy = P.g[0] * c[j];
#pragma unroll
      for (int t = 1; t < NT; ++t) {
        s0 = fmaf(P.g[t], a[j + t], s0);
        sx = fmaf(P.xg[t], a[j + t], sx);
        sxx = fmaf(P.xxg[t], a[j + t], sxx);
        sy = fmaf(P.g[t], b[j + t], sy);
        sxy = fmaf(P.xg[t], b[j + t], sxy);
        syy = fmaf(P.g[t], c[j + t], syy);
      }
      v[0][j] = P.ig11 * sx;
      v[1][j] = P.ig11 * sy;
      v[2][j] = P.ig03 * s0 + P.ig33 * sxx;
      v[3][j] = P.ig03 * s0 + P.ig33 * syy;
      v[4][j] = P.ig55 * sxy;
    }
    const int x0 = tx0 + q0;
    float* out = frame_out + static_cast<int64_t>(y) * L.lw + x0;
    if (CB == 4 && L.lw % 4 == 0 && x0 + 3 < L.lw &&
        (reinterpret_cast<uintptr_t>(L.out) & 15) == 0) {
      // 16-byte stores: a warp writes four whole 128-byte rows of a plane
#pragma unroll
      for (int pl = 0; pl < 5; ++pl) {
        *reinterpret_cast<float4*>(out + pl * plane) =
            make_float4(v[pl][0], v[pl][1 % CB], v[pl][2 % CB], v[pl][3 % CB]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < CB; ++j) {
        if (x0 + j >= L.lw) break;
#pragma unroll
        for (int pl = 0; pl < 5; ++pl) out[pl * plane + j] = v[pl][j];
      }
    }
  } else {
    // one output a thread at a time; the tap loops run to kMaxPolyTaps so
    // that P's taps are read at constant offsets, and stop at T
    const int T = 2 * n + 1;
    for (int i = tid; i < TILE * E; i += kThreads) {
      const int r = i / E;
      const int q = i - r * E;
      const float* col = level + r * E + q;
      float a = P.g[0] * col[0];
      float b = P.xg[0] * col[0];
      float c = P.xxg[0] * col[0];
#pragma unroll
      for (int t = 1; t < kMaxPolyTaps; ++t) {
        if (t >= T) break;
        const float x = col[t * E];
        a = fmaf(P.g[t], x, a);
        b = fmaf(P.xg[t], x, b);
        c = fmaf(P.xxg[t], x, c);
      }
      tg[r * ES + q] = a;
      txg[r * ES + q] = b;
      txxg[r * ES + q] = c;
    }
    __syncthreads();

    for (int i = tid; i < TILE * TILE; i += kThreads) {
      const int r = i / TILE;
      const int q = i - r * TILE;
      const int y = ty0 + r;
      const int x = tx0 + q;
      if (y >= L.lh || x >= L.lw) continue;
      const float* a = tg + r * ES + q;
      const float* b = txg + r * ES + q;
      const float* c = txxg + r * ES + q;
      float s0 = P.g[0] * a[0], sx = P.xg[0] * a[0], sxx = P.xxg[0] * a[0];
      float sy = P.g[0] * b[0], sxy = P.xg[0] * b[0], syy = P.g[0] * c[0];
#pragma unroll
      for (int t = 1; t < kMaxPolyTaps; ++t) {
        if (t >= T) break;
        s0 = fmaf(P.g[t], a[t], s0);
        sx = fmaf(P.xg[t], a[t], sx);
        sxx = fmaf(P.xxg[t], a[t], sxx);
        sy = fmaf(P.g[t], b[t], sy);
        sxy = fmaf(P.xg[t], b[t], sxy);
        syy = fmaf(P.g[t], c[t], syy);
      }
      float* out = frame_out + static_cast<int64_t>(y) * L.lw + x;
      out[0] = P.ig11 * sx;
      out[plane] = P.ig11 * sy;
      out[2 * plane] = P.ig03 * s0 + P.ig33 * sxx;
      out[3 * plane] = P.ig03 * s0 + P.ig33 * syy;
      out[4 * plane] = P.ig55 * sxy;
    }
  }
}

template <int TILE, int N>
cudaError_t launch(const Level& level, const PolyTaps& poly, int frames,
                   int smem_bytes, cudaStream_t stream) {
  // the dynamic shared memory granted so far on each device; raised, never
  // lowered (the attribute is the current device's)
  static int granted[kMaxDevices] = {};
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (smem_bytes > 48 * 1024 &&
      (device >= kMaxDevices || smem_bytes > granted[device])) {
    e = cudaFuncSetAttribute(farneback_prep_kernel<TILE, N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
    if (e != cudaSuccess) return e;
    if (device < kMaxDevices) granted[device] = smem_bytes;
  }
  const int tiles = level.tiles_x * ((level.lh + TILE - 1) / TILE);
  const int64_t in_frame = static_cast<int64_t>(level.H) * level.W;
  const int64_t out_frame = 5 * static_cast<int64_t>(level.lh) * level.lw;
  for (int f0 = 0; f0 < frames; f0 += 65535) {
    Level chunk = level;
    chunk.img += f0 * in_frame;
    chunk.out += f0 * out_frame;
    const dim3 grid(tiles, std::min(frames - f0, 65535));
    farneback_prep_kernel<TILE, N>
        <<<grid, kThreads, smem_bytes, stream>>>(chunk, poly);
  }
  return cudaGetLastError();
}

}  // namespace

// img: [frames, H, W] fp32 contiguous; out: [frames, 5, lh, lw] fp32
// contiguous; row_pad / col_pad: int64 [H + 2p] / [W + 2p]; row_lo, row_hi
// (int64), row_w (fp32) [lh], null where lh == H, and the same for the
// columns; blur: fp32 [2p + 1]; all on the current device (the caller
// selects it).  poly_host: 3 (2 poly_n + 1) fp32 taps (g, then xg, then
// xxg) and ig11, ig03, ig33, ig55, on the host.  The tile (16 or 32), the
// spans, the strip and the shared memory come from the wrapper.  Launches
// on `stream` and returns cudaGetLastError(); cudaErrorInvalidValue for a
// poly_n outside 1 .. kMaxPolyN or another tile.
extern "C" int ofc_farneback_prep(
    const void* img, void* out, int frames, int H, int W, int lh, int lw,
    const void* row_pad, const void* col_pad, const void* row_lo,
    const void* row_hi, const void* row_w, const void* col_lo,
    const void* col_hi, const void* col_w, const void* blur, int p,
    int poly_n, const float* poly_host, int tile, int span_h, int span_w,
    int strip_rows, int smem_bytes, void* stream) {
  if (poly_n < 1 || poly_n > kMaxPolyN || (tile != 16 && tile != 32) ||
      frames < 1 || strip_rows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Level level{static_cast<const float*>(img), static_cast<float*>(out),
              static_cast<const int64_t*>(row_pad),
              static_cast<const int64_t*>(col_pad),
              static_cast<const int64_t*>(row_lo),
              static_cast<const int64_t*>(row_hi),
              static_cast<const float*>(row_w),
              static_cast<const int64_t*>(col_lo),
              static_cast<const int64_t*>(col_hi),
              static_cast<const float*>(col_w),
              static_cast<const float*>(blur),
              H, W, lh, lw, p, (lw + tile - 1) / tile, span_h, span_w,
              strip_rows};
  PolyTaps poly{};
  const int taps = 2 * poly_n + 1;
  for (int t = 0; t < taps; ++t) {
    poly.g[t] = poly_host[t];
    poly.xg[t] = poly_host[taps + t];
    poly.xxg[t] = poly_host[2 * taps + t];
  }
  poly.ig11 = poly_host[3 * taps];
  poly.ig03 = poly_host[3 * taps + 1];
  poly.ig33 = poly_host[3 * taps + 2];
  poly.ig55 = poly_host[3 * taps + 3];
  poly.n = poly_n;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (tile == 32) {
    e = poly_n == 5   ? launch<32, 5>(level, poly, frames, smem_bytes, s)
        : poly_n == 7 ? launch<32, 7>(level, poly, frames, smem_bytes, s)
                      : launch<32, 0>(level, poly, frames, smem_bytes, s);
  } else {
    e = poly_n == 5   ? launch<16, 5>(level, poly, frames, smem_bytes, s)
        : poly_n == 7 ? launch<16, 7>(level, poly, frames, smem_bytes, s)
                      : launch<16, 0>(level, poly, frames, smem_bytes, s);
  }
  return static_cast<int>(e);
}
