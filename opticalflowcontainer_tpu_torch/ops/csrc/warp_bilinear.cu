// K3: exact bilinear backward warp, for Hopper (sm_90a).
//
// Replaces the TPU kernel opticalflowcontainer_tpu/ops/blockwarp.py
// `block_warp_bilinear` (pallas_call at :598; body `_kernel` over
// `_warp_block_core`).  For each pixel p = (x, y) of each image b:
//   out[b, c, y, x] = bilinear(src[b, c], x + u[b, y, x], y + v[b, y, x])
// with the reference's two borders (core/warp.py):
//   padding 0, zeros: taps outside the image contribute zero
//     (`sample_bilinear_zeros`, torch grid_sample padding_mode="zeros");
//   padding 1, edge: the coordinate is clamped into the image first
//     (`sample_bilinear_edge`).
// With the mask on, the kernel also sums the weights of the in-image taps
// (what warping a channel of ones gives) and multiplies the output by
// (sum > threshold): PWC-Net's masked backwarp (`warp_with_mask`) without
// concatenating a ones channel.
//
// Design: one thread per output pixel computes the four taps' offsets,
// weights and validity once, then loops over the C channels.  The weights and
// the mask sum are formed with __fmul_rn/__fadd_rn (no FMA contraction) in
// the plain version's order, so the hard threshold flips at exactly the
// pixels where the plain version's does.  The TPU kernel's block-mean patch
// DMA, `slack` window and finite `pad` exist for Mosaic's (8, 128) tiling;
// here every pixel samples exactly, at any displacement.
//
// Bound: bytes.  Each output value reads about one source value (smooth flow
// keeps neighbouring threads' taps adjacent, so the four taps come mostly
// from L1/L2) and writes one: ~2 C + 2 fp32 values per pixel, 43 MB for a
// PWC-Net level-2 warp at B=8 (13 us at 3.35 TB/s).  Eight flops per value
// is far below the fp32 rate.
#include <cuda_runtime.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

__global__ void __launch_bounds__(kBlockX * kBlockY)
warp_bilinear_kernel(const float* __restrict__ src,
                     const float* __restrict__ U,
                     const float* __restrict__ V, float* __restrict__ out,
                     int C, int H, int W, int edge, int use_mask,
                     float threshold) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= W || y >= H) return;
  const size_t plane = static_cast<size_t>(H) * W;
  const size_t pix = static_cast<size_t>(y) * W + x;
  const size_t b = blockIdx.z;

  float fx = __fadd_rn(static_cast<float>(x), U[b * plane + pix]);
  float fy = __fadd_rn(static_cast<float>(y), V[b * plane + pix]);
  if (edge) {
    fx = fminf(fmaxf(fx, 0.0f), static_cast<float>(W - 1));
    fy = fminf(fmaxf(fy, 0.0f), static_cast<float>(H - 1));
  }
  const float x0 = floorf(fx);
  const float y0 = floorf(fy);
  const float wx = __fsub_rn(fx, x0);
  const float wy = __fsub_rn(fy, y0);
  const float ox = __fsub_rn(1.0f, wx);
  const float oy = __fsub_rn(1.0f, wy);
  const float w[4] = {__fmul_rn(ox, oy), __fmul_rn(wx, oy),
                      __fmul_rn(ox, wy), __fmul_rn(wx, wy)};

  // tap t = (dy, dx) in (0,0), (0,1), (1,0), (1,1): validity and offset.
  // Comparisons stay in float so that a huge or NaN displacement is never
  // converted to an out-of-range int (NaN compares false: no tap).
  bool ok[4];
  size_t off[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const float tx = x0 + static_cast<float>(t & 1);
    const float ty = y0 + static_cast<float>(t >> 1);
    if (edge) {  // the coordinate is in the image; the +1 tap clamps
      ok[t] = true;
      const int ix = min(static_cast<int>(tx), W - 1);
      const int iy = min(static_cast<int>(ty), H - 1);
      off[t] = static_cast<size_t>(iy) * W + ix;
    } else {
      ok[t] = tx >= 0.0f && tx <= static_cast<float>(W - 1) && ty >= 0.0f &&
              ty <= static_cast<float>(H - 1);
      off[t] = ok[t] ? static_cast<size_t>(ty) * W + static_cast<size_t>(tx)
                     : 0;
    }
  }

  float gate = 1.0f;
  if (use_mask) {
    float m = ok[0] ? w[0] : 0.0f;
#pragma unroll
    for (int t = 1; t < 4; ++t) m = __fadd_rn(m, ok[t] ? w[t] : 0.0f);
    gate = m > threshold ? 1.0f : 0.0f;
  }

  const float* s = src + b * C * plane;
  float* o = out + b * C * plane + pix;
  for (int c = 0; c < C; ++c, s += plane) {
    float acc = ok[0] ? s[off[0]] * w[0] : 0.0f;
#pragma unroll
    for (int t = 1; t < 4; ++t) acc += ok[t] ? s[off[t]] * w[t] : 0.0f;
    o[c * plane] = acc * gate;
  }
}

}  // namespace

// src, out: [B, C, H, W] fp32 contiguous; u, v: [B, H, W] fp32 contiguous,
// all on the current device (the caller selects it).  edge: 0 zeros, 1 edge.
// use_mask: gate the output by (in-image tap weight > threshold).  Launches
// on `stream` and returns cudaGetLastError().
extern "C" int ofc_warp_bilinear(const void* src, const void* u,
                                 const void* v, void* out, int B, int C, int H,
                                 int W, int edge, int use_mask,
                                 float threshold, void* stream) {
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((W + kBlockX - 1) / kBlockX, (H + kBlockY - 1) / kBlockY, B);
  warp_bilinear_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<const float*>(u),
      static_cast<const float*>(v), static_cast<float*>(out), C, H, W, edge,
      use_mask, threshold);
  return static_cast<int>(cudaGetLastError());
}
