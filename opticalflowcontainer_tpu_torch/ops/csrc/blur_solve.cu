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
// Design: one block of 256 threads per TH x TW output tile.  For each plane
// in turn, the tile plus a halo of r = winsize/2 is loaded into dynamic
// shared memory with clamped indices (the replicate border), blurred
// vertically into a second shared buffer, then horizontally into registers;
// after the 5th plane each thread solves its pixels and writes u, v.  The
// wrapper sizes the tile from r (shared memory is (2 TH + 2r)(TW + 2r) + 2r+1
// floats) and opts in above 48 KB, so any winsize whose smallest tile fits
// the card runs; the TPU kernel's fixed (8, 64) halo limit does not apply.
//
// Bound: bytes.  Per pixel 5 fp32 reads and 2 fp32 writes (~26 MB per 720p
// field-level-iteration, ~8 us at 3.35 TB/s); the halo re-reads come from
// L2.  The blur's 2 x winsize multiply-adds per plane are below the fp32 rate
// at winsize 15.
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

}  // namespace

// M: [B, 5, H, W] fp32 contiguous; taps: [2r+1] fp32; u, v: [B, H, W] fp32
// contiguous, all on the current device (the caller selects it).  The tile
// and its shared-memory size come from the wrapper.  Launches on `stream` and
// returns cudaGetLastError().
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
