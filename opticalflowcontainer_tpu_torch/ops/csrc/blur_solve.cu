// K2: Farneback winsize blur + per-pixel 2x2 solve, for Hopper (sm_90a).
//
// Replaces the TPU kernel opticalflowcontainer_tpu/ops/solve2x2.py
// `blur_solve_2x2` (pallas_call at :156, body `_kernel`).  Semantics are
// those of the reference's classical/farneback.py `_solve_flow_planes` /
// `_solve_flow`: blur the 5 normal-equation planes (G00, G01, G11, h1, h2)
// with a separable `winsize` filter (box, or Gaussian under the flag; the
// taps come from the wrapper) and a replicate border, vertical pass first,
// then solve per pixel
//   det = G00 G11 - G01^2 + 1e-3,  u = (G11 h1 - G01 h2)/det,
//   v = (G00 h2 - G01 h1)/det.
//
// Bound: bytes.  Per pixel 5 fp32 reads and 2 fp32 writes (155 MB for the
// 720p clip's finest level at B=6, 46 us at 3.35 TB/s); the halo re-reads
// come from L1/L2.  The blur's 2 x winsize FMAs per plane and pixel (0.83 G
// at winsize 15 there, ~30 us of the fp32 pipe) come next.
//
// Two kernels; the wrapper picks by radius r = winsize // 2.
//
// `blur_solve_reg_kernel<R, RC>`, for the radii the callers use
// (r = 7: winsize 15, cv2's default and the clip's and stream's; r = 6:
// winsize 13, the runtime's default).  A block of 256 threads owns a
// 32 x 8*RC output tile and keeps its 5 planes' blurred values in
// registers; the taps are a kernel parameter (constant bank), so each tap
// is an FMA operand.  Per plane:
//   vertical: each thread owns one column of the tile + halo and a run of
//     RV = 32 / RUNS rows (RUNS: the most runs, a power of two, that give
//     every item a thread); it reads RV + 2R clamped values straight from
//     global memory (coalesced along x; the halo rows come from L1/L2) into
//     registers and slides the window over them: (RV + 2R) / RV loads per
//     output instead of 2R + 1.  It loads the next plane's column while
//     this plane is blurred.  The results go to a shared `vert` buffer
//     whose row stride is odd;
//   horizontal: lane l of warp w reads row l of `vert` from column w*RC,
//     RC + 2R values, and slides the window along the row.  The 32 lanes
//     read 32 rows at one column, and the odd stride puts them in 32
//     distinct banks.
// `vert` is double-buffered across planes, so a plane costs one barrier.
// Each output sums its taps in the order t = 0 .. 2R with FMAs, as the
// generic kernel does (no running sums: they would move the rounding).  At
// the end u and v pass through shared memory so that their stores
// coalesce.  The wrapper picks the tile width (112, 32 or 16 columns: RC =
// 14, 4 or 2, RUNS = 2, 4 or 8 at both radii) by the values the busiest SM
// has to read.  Measured on the H100 at 720p, B=6, winsize 15, the 112-wide
// tile beat 96- and 64-wide ones, and loading the next plane's column
// during the blur took 5% off.
// TMA does not fit the loads: its out-of-bounds fill is zeros, and the
// border here is replicate.
//
// `blur_solve_kernel`, every other radius (the first version of K2): for
// each plane in turn, the tile plus a halo of r is loaded into dynamic
// shared memory with clamped indices, blurred vertically into a second
// shared buffer, then horizontally into registers.  The wrapper sizes its
// tile from r (shared memory is (2 TH + 2r)(TW + 2r) + 2r+1 floats) and opts
// in above 48 KB, so any winsize whose smallest tile fits the card runs; the
// TPU kernel's fixed (8, 64) halo limit does not apply.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPerThread = 8;  // tile_h * tile_w <= kThreads * kMaxPerThread

__global__ void __launch_bounds__(kThreads)
blur_solve_kernel(const float* __restrict__ M, const float* __restrict__ taps,
                  float* __restrict__ U, float* __restrict__ V, int H, int W,
                  int r, int TH, int TW) {
  extern __shared__ float smem[];
  const int K = 2 * r + 1;
  const int SW = TW + 2 * r;
  const int SH = TH + 2 * r;
  float* tile = smem;            // [SH][SW] one plane, tile + halo
  float* vert = tile + SH * SW;  // [TH][SW] after the vertical pass
  float* w = vert + TH * SW;     // [K] blur taps

  const int tid = threadIdx.x;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const size_t plane = static_cast<size_t>(H) * W;
  const size_t b = blockIdx.z;
  for (int i = tid; i < K; i += kThreads) w[i] = taps[i];

  float acc[5][kMaxPerThread];
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    const float* src = M + (b * 5 + c) * plane;
    __syncthreads();  // taps loaded; previous plane's readers done
    for (int i = tid; i < SH * SW; i += kThreads) {
      const int ty = i / SW;
      const int tx = i - ty * SW;
      const int gy = min(max(y0 + ty - r, 0), H - 1);
      const int gx = min(max(x0 + tx - r, 0), W - 1);
      tile[i] = src[static_cast<size_t>(gy) * W + gx];
    }
    __syncthreads();
    for (int i = tid; i < TH * SW; i += kThreads) {
      const int ty = i / SW;
      const int tx = i - ty * SW;
      float s = 0.0f;
      for (int t = 0; t < K; ++t) s += w[t] * tile[(ty + t) * SW + tx];
      vert[i] = s;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kMaxPerThread; ++j) {
      const int p = tid + j * kThreads;
      float s = 0.0f;
      if (p < TH * TW) {
        const int ty = p / TW;
        const int tx = p - ty * TW;
        const float* row = vert + ty * SW + tx;
        for (int t = 0; t < K; ++t) s += w[t] * row[t];
      }
      acc[c][j] = s;
    }
  }

#pragma unroll
  for (int j = 0; j < kMaxPerThread; ++j) {
    const int p = tid + j * kThreads;
    if (p >= TH * TW) break;
    const int gy = y0 + p / TW;
    const int gx = x0 + p % TW;
    if (gy >= H || gx >= W) continue;
    const float g00 = acc[0][j], g01 = acc[1][j], g11 = acc[2][j];
    const float h1 = acc[3][j], h2 = acc[4][j];
    const float idet = 1.0f / (g00 * g11 - g01 * g01 + 1e-3f);
    const size_t o = b * plane + static_cast<size_t>(gy) * W + gx;
    U[o] = (g11 * h1 - g01 * h2) * idet;
    V[o] = (g00 * h2 - g01 * h1) * idet;
  }
}

constexpr int kRegRows = 32;  // tile rows: one per lane of a warp
constexpr int kRegWarps = kThreads / 32;

template <int K>
struct Taps {
  float w[K];
};

// The most runs of rows, a power of two up to kRegRows, whose
// (column, run) items the block's threads cover one each.
constexpr int vertical_runs(int columns) {
  int runs = 1;
  while (2 * runs <= kRegRows && 2 * runs * columns <= kThreads) runs *= 2;
  return runs;
}

// Tile geometry of blur_solve_reg_kernel<R, RC>.
template <int R, int RC>
struct RegTile {
  static constexpr int kTW = kRegWarps * RC;     // output columns
  static constexpr int kNC = kTW + 2 * R;        // columns with the halo
  static constexpr int kSW = kNC | 1;            // odd stride: no conflicts
  static constexpr int kRuns = vertical_runs(kNC);
  static constexpr int kRV = kRegRows / kRuns;   // rows per item
  static constexpr int kItems = kNC * kRuns;
  static_assert(kItems <= kThreads, "one vertical item per thread");
};

template <int R, int RC>
__global__ void __launch_bounds__(kThreads, 2)
blur_solve_reg_kernel(const float* __restrict__ M, const Taps<2 * R + 1> taps,
                      float* __restrict__ U, float* __restrict__ V, int H,
                      int W) {
  using T = RegTile<R, RC>;
  constexpr int K = 2 * R + 1;
  __shared__ float vert[2][kRegRows * T::kSW];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int y0 = blockIdx.y * kRegRows;
  const int x0 = blockIdx.x * T::kTW;
  const size_t plane = static_cast<size_t>(H) * W;
  const size_t b = blockIdx.z;
  // this thread's vertical item: a column of the tile + halo, a run of rows
  const int col = tid % T::kNC;
  const int run = tid / T::kNC * T::kRV;
  const int gx = min(max(x0 + col - R, 0), W - 1);

  const bool vertical = tid < T::kItems;
  const float* col_base = M + b * 5 * plane + gx;
  // plane c + 1's column is loaded while plane c is blurred
  float next[T::kRV + 2 * R];
  if (vertical) {
#pragma unroll
    for (int j = 0; j < T::kRV + 2 * R; ++j) {
      const int gy = min(max(y0 + run + j - R, 0), H - 1);
      next[j] = __ldg(col_base + static_cast<size_t>(gy) * W);
    }
  }

  float acc[5][RC];
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    float* buf = vert[c & 1];
    if (vertical) {
      // the column's RV + 2R values of plane c (clamped rows)
      float win[T::kRV + 2 * R];
#pragma unroll
      for (int j = 0; j < T::kRV + 2 * R; ++j) {
        const int gy = min(max(y0 + run + j - R, 0), H - 1);
        win[j] = next[j];
        if (c < 4) {
          next[j] = __ldg(col_base + (c + 1) * plane +
                          static_cast<size_t>(gy) * W);
        }
      }
#pragma unroll
      for (int j = 0; j < T::kRV; ++j) {
        float s = 0.0f;
#pragma unroll
        for (int t = 0; t < K; ++t) s = fmaf(taps.w[t], win[j + t], s);
        buf[(run + j) * T::kSW + col] = s;
      }
    }
    // vert[c & 1] written; its previous readers (plane c - 2) passed the
    // barrier of plane c - 1
    __syncthreads();
    const float* row = buf + lane * T::kSW + warp * RC;
    float win[RC + 2 * R];
#pragma unroll
    for (int j = 0; j < RC + 2 * R; ++j) win[j] = row[j];
#pragma unroll
    for (int j = 0; j < RC; ++j) {
      float s = 0.0f;
#pragma unroll
      for (int t = 0; t < K; ++t) s = fmaf(taps.w[t], win[j + t], s);
      acc[c][j] = s;
    }
  }

  __syncthreads();  // every warp is done with vert[0] (plane 4)
  float* ub = vert[1];
  float* vb = vert[0];
#pragma unroll
  for (int j = 0; j < RC; ++j) {
    const float g00 = acc[0][j], g01 = acc[1][j], g11 = acc[2][j];
    const float h1 = acc[3][j], h2 = acc[4][j];
    const float idet = 1.0f / (g00 * g11 - g01 * g01 + 1e-3f);
    ub[lane * T::kSW + warp * RC + j] = (g11 * h1 - g01 * h2) * idet;
    vb[lane * T::kSW + warp * RC + j] = (g00 * h2 - g01 * h1) * idet;
  }
  __syncthreads();
  for (int i = tid; i < kRegRows * T::kTW; i += kThreads) {
    const int ty = i / T::kTW;
    const int tx = i - ty * T::kTW;
    const int gy = y0 + ty;
    const int ox = x0 + tx;
    if (gy < H && ox < W) {
      const size_t o = b * plane + static_cast<size_t>(gy) * W + ox;
      U[o] = ub[ty * T::kSW + tx];
      V[o] = vb[ty * T::kSW + tx];
    }
  }
}

template <int R, int RC>
cudaError_t launch_reg(const float* m, const float* taps_host, float* u,
                       float* v, int B, int H, int W, cudaStream_t stream) {
  using T = RegTile<R, RC>;
  Taps<2 * R + 1> taps;
  for (int t = 0; t < 2 * R + 1; ++t) taps.w[t] = taps_host[t];
  const dim3 grid((W + T::kTW - 1) / T::kTW,
                  (H + kRegRows - 1) / kRegRows, B);
  blur_solve_reg_kernel<R, RC><<<grid, kThreads, 0, stream>>>(m, taps, u, v,
                                                               H, W);
  return cudaGetLastError();
}

// The wrapper's tiles: 32 rows by 112, 32 or 16 columns.
template <int R>
cudaError_t launch_reg_tile(int tile_w, const float* m, const float* taps,
                            float* u, float* v, int B, int H, int W,
                            cudaStream_t stream) {
  switch (tile_w) {
    case 112:
      return launch_reg<R, 14>(m, taps, u, v, B, H, W, stream);
    case 32:
      return launch_reg<R, 4>(m, taps, u, v, B, H, W, stream);
    case 16:
      return launch_reg<R, 2>(m, taps, u, v, B, H, W, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// The radius-specialized kernel.  M: [B, 5, H, W] fp32 contiguous; taps_host:
// the 2r+1 taps in host memory (passed by value); u, v: [B, H, W] fp32
// contiguous, all on the current device.  r in {6, 7}; tile_w in {112, 32,
// 16} (tile_h is 32).  Launches on `stream` and returns cudaGetLastError().
extern "C" int ofc_blur_solve_reg(const void* m, const float* taps_host,
                                  void* u, void* v, int B, int H, int W, int r,
                                  int tile_w, void* stream) {
  const float* mp = static_cast<const float*>(m);
  float* up = static_cast<float*>(u);
  float* vp = static_cast<float*>(v);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (r) {
    case 6:
      return static_cast<int>(
          launch_reg_tile<6>(tile_w, mp, taps_host, up, vp, B, H, W, s));
    case 7:
      return static_cast<int>(
          launch_reg_tile<7>(tile_w, mp, taps_host, up, vp, B, H, W, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The generic kernel.  M: [B, 5, H, W] fp32 contiguous; taps: [2r+1] fp32
// in device memory; u, v: [B, H, W] fp32 contiguous, all on the current
// device (the caller selects it).  The tile and its shared-memory size come
// from the wrapper.  Launches on `stream` and returns cudaGetLastError().
extern "C" int ofc_blur_solve(const void* m, const void* taps, void* u,
                              void* v, int B, int H, int W, int r, int tile_h,
                              int tile_w, int smem_bytes, void* stream) {
  if (tile_h < 1 || tile_w < 1 || tile_h * tile_w > kThreads * kMaxPerThread) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        blur_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((W + tile_w - 1) / tile_w, (H + tile_h - 1) / tile_h, B);
  blur_solve_kernel<<<grid, kThreads, smem_bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(m), static_cast<const float*>(taps),
      static_cast<float*>(u), static_cast<float*>(v), H, W, r, tile_h, tile_w);
  return static_cast<int>(cudaGetLastError());
}
