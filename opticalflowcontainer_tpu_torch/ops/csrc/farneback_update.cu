// K1: Farneback per-iteration update, for Hopper (sm_90a).
//
// Replaces the TPU kernel opticalflowcontainer_tpu/ops/blockwarp.py
// `block_warp_farneback_update` (pallas_call at :732; bodies
// `_kernel_farneback_update`, `_warp_block_core`, `_farneback_epilogue`).
// Semantics are those of the reference's exact CPU path,
// classical/farneback.py `_update_matrices`: for each pixel p of a pyramid
// level,
//   1. sample frame 1's expansion planes (bx, by, axx, ayy, qxy) bilinearly
//      at p + (u, v);
//   2. inb = all four taps strictly inside the level (R1 is read only then);
//   3. A = (A0 + A1)/2 (qxy /4), or A0 alone (qxy /2) when !inb;
//      db = (b0 - b1)/2 (0 when !inb) + A d;
//   4. multiply by the separable 5-px border ramp;
//   5. write M = (G00, G01, G11, h1, h2) = (A^T A, A^T db).
//
// Design: one thread per output pixel, exact bilinear taps from unpadded
// fp32 planes.  The TPU kernel's patch DMA, phase copies, lane rolls, 3-way
// bf16 split and block-mean slack window exist for Mosaic's (8, 128) tiling
// and are not carried over; here every pixel samples exactly.  Storage is
// fp32 (bf16 planes are a later change).
//
// Bound: bytes.  Each pixel reads R0 (5), u, v (2), R1's taps (5 planes,
// only when inb) and writes M (5): about 17 fp32 values, ~63 MB per 720p
// field-level-iteration, ~19 us at 3.35 TB/s.  About 80 flops per pixel is
// far below the fp32 rate.  Reads along x are coalesced (adjacent threads,
// adjacent pixels; smooth flow keeps the taps adjacent too); no shared memory.
#include <cuda_runtime.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

// 5-px edge ramp that down-weights the expansion near the level's borders
__constant__ float kRamp[5] = {0.14f, 0.14f, 0.4472f, 0.4472f, 0.4472f};

// One axis factor of the border weight (reference `_border_weight_vecs`): the
// ramp from the low edge times the ramp from the high edge, 1 inside.
__device__ __forceinline__ float ramp_factor(int i, int n) {
  float w = 1.0f;
  if (i < 5) w *= kRamp[i];
  if (n - 1 - i < 5) w *= kRamp[n - 1 - i];
  return w;
}

__global__ void __launch_bounds__(kBlockX * kBlockY)
farneback_update_kernel(const float* __restrict__ R0,
                        const float* __restrict__ R1,
                        const float* __restrict__ U,
                        const float* __restrict__ V,
                        float* __restrict__ M, int H, int W) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= W || y >= H) return;
  const size_t plane = static_cast<size_t>(H) * W;
  const size_t pix = static_cast<size_t>(y) * W + x;
  const size_t b = blockIdx.z;

  const float dx = U[b * plane + pix];
  const float dy = V[b * plane + pix];
  const float fx = static_cast<float>(x) + dx;
  const float fy = static_cast<float>(y) + dy;
  const float x0 = floorf(fx);
  const float y0 = floorf(fy);
  const bool inb = x0 >= 0.0f && x0 < static_cast<float>(W - 1) &&
                   y0 >= 0.0f && y0 < static_cast<float>(H - 1);

  const float* r0 = R0 + b * 5 * plane + pix;
  const float r0bx = r0[0], r0by = r0[plane], r0xx = r0[2 * plane],
              r0yy = r0[3 * plane], r0xy = r0[4 * plane];

  float axx, ayy, axy, dbx, dby;
  if (inb) {
    const float wx = fx - x0;
    const float wy = fy - y0;
    const float w00 = (1.0f - wx) * (1.0f - wy), w01 = wx * (1.0f - wy);
    const float w10 = (1.0f - wx) * wy, w11 = wx * wy;
    const size_t t = static_cast<size_t>(y0) * W + static_cast<size_t>(x0);
    const float* r1 = R1 + b * 5 * plane + t;
    float s[5];
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      const float* p = r1 + c * plane;
      s[c] = p[0] * w00 + p[1] * w01 + p[W] * w10 + p[W + 1] * w11;
    }
    axx = (r0xx + s[2]) * 0.5f;
    ayy = (r0yy + s[3]) * 0.5f;
    axy = (r0xy + s[4]) * 0.25f;
    dbx = (r0bx - s[0]) * 0.5f;
    dby = (r0by - s[1]) * 0.5f;
  } else {
    // out of bounds: frame 0's A alone and no data term
    axx = r0xx;
    ayy = r0yy;
    axy = r0xy * 0.5f;
    dbx = 0.0f;
    dby = 0.0f;
  }
  dbx = dbx + axx * dx + axy * dy;
  dby = dby + axy * dx + ayy * dy;

  const float bw = ramp_factor(y, H) * ramp_factor(x, W);
  axx *= bw;
  ayy *= bw;
  axy *= bw;
  dbx *= bw;
  dby *= bw;

  float* m = M + b * 5 * plane + pix;
  m[0] = axx * axx + axy * axy;
  m[plane] = (axx + ayy) * axy;
  m[2 * plane] = ayy * ayy + axy * axy;
  m[3 * plane] = axx * dbx + axy * dby;
  m[4 * plane] = axy * dbx + ayy * dby;
}

}  // namespace

// R0, R1, M: [B, 5, H, W] fp32 contiguous; u, v: [B, H, W] fp32 contiguous,
// all on the current device (the caller selects it).  Launches on `stream`
// and returns cudaGetLastError().
extern "C" int ofc_farneback_update(const void* r0, const void* r1,
                                    const void* u, const void* v, void* m,
                                    int B, int H, int W, void* stream) {
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((W + kBlockX - 1) / kBlockX, (H + kBlockY - 1) / kBlockY, B);
  farneback_update_kernel<<<grid, block, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r0), static_cast<const float*>(r1),
      static_cast<const float*>(u), static_cast<const float*>(v),
      static_cast<float*>(m), H, W);
  return static_cast<int>(cudaGetLastError());
}
