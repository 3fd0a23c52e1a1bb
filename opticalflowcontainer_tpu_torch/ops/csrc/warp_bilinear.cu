// K3: exact bilinear backward warp, for Hopper (sm_90a).
//
// Replaces the TPU kernel opticalflowcontainer_tpu/ops/blockwarp.py
// `block_warp_bilinear` (pallas_call at :598; body `_kernel` over
// `_warp_block_core`).  For each pixel p = (x, y) of each image b:
//   out[b, c, y, x] = bilinear(src[b, c], x + u[b, y, x], y + v[b, y, x])
// with the reference's two borders (core/warp.py):
//   zeros: taps outside the image contribute zero
//     (`sample_bilinear_zeros`, torch grid_sample padding_mode="zeros");
//   edge: the coordinate is clamped into the image first
//     (`sample_bilinear_edge`).
// With the mask on, the kernel also sums the weights of the in-image taps
// (what warping a channel of ones gives) and multiplies the output by
// (sum > threshold): PWC-Net's masked backwarp (`warp_with_mask`) without
// concatenating a ones channel.  The TPU kernel's block-mean patch DMA,
// `slack` window and finite `pad` exist for Mosaic's (8, 128) tiling; here
// every pixel samples exactly, at any displacement.
//
// Bound: bytes.  Each output value reads about one source value (smooth flow
// keeps neighbouring threads' taps adjacent, so the four taps come mostly
// from L1/L2) and writes one: ~2 C + 2 fp32 values per pixel, 43 MB for a
// PWC-Net level-2 warp at B=8 (13 us at 3.35 TB/s).  Eight flops per value
// is far below the fp32 rate.
//
// Design.  The grid is (pixel blocks, channel groups, batch): each thread
// owns one pixel of one flattened H*W plane (a warp covers 32 consecutive
// pixels, so loads of neighbouring taps and the stores coalesce) and the
// channels [g*cpg, (g+1)*cpg) of its group.  Each group recomputes the taps
// and weights, which costs two flow loads and a few flops.  The wrapper
// splits C into groups of about four channels, and into more where B*H*W
// alone would leave SMs idle (PWC-Net at B=1: 320 pixels by 128 channels
// at level 5 run as 128 groups of one).  The border and the mask are
// template parameters (MODE), and the offsets are 32-bit unless the tensor
// has 2^31 values or more.  Measured on the H100, unrolling the channel
// loop and giving a thread two pixels cost more registers, and so
// occupancy, than they gain in loads in flight (many resident threads, each
// with its four taps in flight, hide the latency better), and 256-thread
// blocks gained nothing.
//
// The weights, the mask sum and the tap sum are formed with
// __fmul_rn/__fadd_rn (no FMA contraction) in the plain version's order, so
// the hard threshold flips at exactly the pixels where the plain version's
// does, and every launch configuration gives the plain version's values bit
// for bit.  A tap is summed as `ok ? s * w : 0`: a zeroed weight times a NaN
// would let the NaN through.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;

// MODE: 0 zeros, 1 zeros + mask, 2 edge, 3 edge + mask.
template <int MODE, typename Index>
__global__ void __launch_bounds__(kThreads)
warp_bilinear_kernel(const float* __restrict__ src,
                     const float* __restrict__ U,
                     const float* __restrict__ V, float* __restrict__ out,
                     int C, int H, int W, int cpg, float threshold) {
  constexpr bool kEdge = MODE >= 2;
  constexpr bool kMask = (MODE & 1) != 0;
  const Index plane = static_cast<Index>(H) * W;
  const Index p = static_cast<Index>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= plane) return;
  const Index b = blockIdx.z;
  const int c0 = blockIdx.y * cpg;
  const int c1 = min(C, c0 + cpg);
  const int y = static_cast<int>(p / W);
  const int x = static_cast<int>(p - static_cast<Index>(y) * W);
  float fx = __fadd_rn(static_cast<float>(x), U[b * plane + p]);
  float fy = __fadd_rn(static_cast<float>(y), V[b * plane + p]);
  if (kEdge) {
    fx = fminf(fmaxf(fx, 0.0f), static_cast<float>(W - 1));
    fy = fminf(fmaxf(fy, 0.0f), static_cast<float>(H - 1));
  }
  const float x0 = floorf(fx);
  const float y0 = floorf(fy);
  const float wx = __fsub_rn(fx, x0);
  const float wy = __fsub_rn(fy, y0);
  const float ox = __fsub_rn(1.0f, wx);
  const float oy = __fsub_rn(1.0f, wy);
  const float w[4] = {__fmul_rn(ox, oy), __fmul_rn(wx, oy), __fmul_rn(ox, wy),
                      __fmul_rn(wx, wy)};
  // tap t = (dy, dx) in (0,0), (0,1), (1,0), (1,1): validity and offset.
  // Comparisons stay in float so that a huge or NaN displacement is never
  // converted to an out-of-range int (NaN compares false: no tap).
  bool ok[4];
  Index off[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const float tx = x0 + static_cast<float>(t & 1);
    const float ty = y0 + static_cast<float>(t >> 1);
    if (kEdge) {  // the coordinate is in the image; the +1 tap clamps
      ok[t] = true;
      const int ix = min(static_cast<int>(tx), W - 1);
      const int iy = min(static_cast<int>(ty), H - 1);
      off[t] = static_cast<Index>(iy) * W + ix;
    } else {
      ok[t] = tx >= 0.0f && tx <= static_cast<float>(W - 1) && ty >= 0.0f &&
              ty <= static_cast<float>(H - 1);
      off[t] = ok[t] ? static_cast<Index>(ty) * W + static_cast<Index>(tx)
                     : 0;
    }
  }
  float gate = 1.0f;
  if (kMask) {
    float m = ok[0] ? w[0] : 0.0f;
#pragma unroll
    for (int t = 1; t < 4; ++t) m = __fadd_rn(m, ok[t] ? w[t] : 0.0f);
    gate = m > threshold ? 1.0f : 0.0f;
  }

  const float* s = src + (b * C + c0) * plane;
  float* o = out + (b * C + c0) * plane + p;
#pragma unroll 1
  for (int c = c0; c < c1; ++c, s += plane, o += plane) {
    float val[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) val[t] = ok[t] ? __ldg(s + off[t]) : 0.0f;
    float acc = ok[0] ? __fmul_rn(val[0], w[0]) : 0.0f;
#pragma unroll
    for (int t = 1; t < 4; ++t) {
      acc = __fadd_rn(acc, ok[t] ? __fmul_rn(val[t], w[t]) : 0.0f);
    }
    *o = acc * gate;
  }
}

template <int MODE>
cudaError_t launch(const dim3& grid, int wide, cudaStream_t stream,
                   const float* src, const float* u, const float* v,
                   float* out, int C, int H, int W, int cpg,
                   float threshold) {
  if (wide) {
    warp_bilinear_kernel<MODE, int64_t><<<grid, kThreads, 0, stream>>>(
        src, u, v, out, C, H, W, cpg, threshold);
  } else {
    warp_bilinear_kernel<MODE, int32_t><<<grid, kThreads, 0, stream>>>(
        src, u, v, out, C, H, W, cpg, threshold);
  }
  return cudaGetLastError();
}

}  // namespace

// src, out: [B, C, H, W] fp32 contiguous; u, v: [B, H, W] fp32 contiguous,
// all on the current device (the caller selects it).  edge: 0 zeros, 1 edge.
// use_mask: gate the output by (in-image tap weight > threshold).  The
// wrapper picks `groups` channel groups (1..C) and `wide` (64-bit offsets,
// required when B*C*H*W >= 2^31).  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int ofc_warp_bilinear(const void* src, const void* u,
                                 const void* v, void* out, int B, int C, int H,
                                 int W, int edge, int use_mask,
                                 float threshold, int groups, int wide,
                                 void* stream) {
  const long long plane = static_cast<long long>(H) * W;
  if (groups < 1 || groups > C ||
      (!wide && static_cast<long long>(B) * C * plane >= (1LL << 31))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int cpg = (C + groups - 1) / groups;
  const dim3 grid(static_cast<unsigned>((plane + kThreads - 1) / kThreads),
                  (C + cpg - 1) / cpg, B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(src);
  const float* up = static_cast<const float*>(u);
  const float* vp = static_cast<const float*>(v);
  float* op = static_cast<float*>(out);
  switch ((edge ? 2 : 0) + (use_mask ? 1 : 0)) {
    case 0:
      return static_cast<int>(launch<0>(grid, wide, s, sp, up, vp, op, C, H,
                                        W, cpg, threshold));
    case 1:
      return static_cast<int>(launch<1>(grid, wide, s, sp, up, vp, op, C, H,
                                        W, cpg, threshold));
    case 2:
      return static_cast<int>(launch<2>(grid, wide, s, sp, up, vp, op, C, H,
                                        W, cpg, threshold));
    default:
      return static_cast<int>(launch<3>(grid, wide, s, sp, up, vp, op, C, H,
                                        W, cpg, threshold));
  }
}
