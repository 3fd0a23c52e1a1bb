// K4: local correlation cost volume, for Hopper (sm_90a).
//
// Replaces the TPU kernel opticalflowcontainer_tpu/ops/correlation_pallas.py
// `correlation_pallas` (pallas_call at :101, body `_corr_kernel`), forward
// only.  For K = 2D + 1, D = max_disp / disp_stride and output pixel (y, x):
//   out[b, iy K + ix, y, x] = (1/C) sum_c f1[b, c, y os, x os]
//                                       * f2[b, c, y os + dy, x os + dx]
// with (dy, dx) = ((iy - D), (ix - D)) disp_stride, zeros outside the image,
// channels row-major over (dy, dx) (the reference's `correlation_lax`).  It
// covers every configuration of the model zoo, out_stride 2 included (the
// Pallas kernel takes out_stride 1 only).
//
// Design: a block of 32 x 8 threads owns a 32 x 8 tile of output pixels, one
// pixel per thread, each holding its K*K sums in registers (K is a template
// parameter: 7 or 9).  The block walks the channels kChunk at a time: it
// stages the f2 window those outputs reach, (7 os + 1 + 2 max_disp) rows by
// (31 os + 1 + 2 max_disp) columns per channel with zeros outside the image,
// in shared memory, then every thread reads its K*K taps from there.  Each
// staged value serves up to K*K threads, so f2 is read from device memory
// about once.  CUDA rather than Triton: the K*K shifted, dilated reads of one
// staged window are indexed shared-memory loads, which Triton's block model
// cannot express (each shift would be a separate load from L1/L2), and the
// port builds all its kernels with one nvcc call.
//
// Bound: bytes.  f1 and f2 are read once and K*K outputs written per pixel:
// at PWC-Net level 2 (B=8, C=32, 128 x 160, K*K=81) ~95 MB, 28 us at
// 3.35 TB/s, against 2 C K*K flops per pixel (13 us at the fp32 rate).  The
// K*K shared-memory reads per channel and pixel are the likely limit of
// this simple form.
#include <cuda_runtime.h>

namespace {

constexpr int kTileX = 32;
constexpr int kTileY = 8;
constexpr int kChunk = 4;  // channels staged per pass

template <int K>
__global__ void __launch_bounds__(kTileX * kTileY)
correlation_kernel(const float* __restrict__ f1, const float* __restrict__ f2,
                   float* __restrict__ out, int C, int H, int W, int Ho,
                   int Wo, int os, int ds, int max_disp, int win_h,
                   int win_w) {
  extern __shared__ float win[];  // [kChunk][win_h][win_w]
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kTileX + tx;
  const int ox = blockIdx.x * kTileX + tx;
  const int oy = blockIdx.y * kTileY + ty;
  const bool live = ox < Wo && oy < Ho;
  // the window's origin in f2: the tile's first input pixel minus max_disp
  const int gx0 = blockIdx.x * kTileX * os - max_disp;
  const int gy0 = blockIdx.y * kTileY * os - max_disp;
  const size_t plane = static_cast<size_t>(H) * W;
  const size_t b = blockIdx.z;
  const float* a_ptr = f1 + b * C * plane +
                       (live ? static_cast<size_t>(oy * os) * W + ox * os : 0);
  const float* f2b = f2 + b * C * plane;
  const int win_n = win_h * win_w;

  float acc[K * K];
#pragma unroll
  for (int k = 0; k < K * K; ++k) acc[k] = 0.0f;

  for (int c0 = 0; c0 < C; c0 += kChunk) {
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < kChunk * win_n; i += kTileX * kTileY) {
      const int cc = i / win_n;
      const int r = i - cc * win_n;
      const int wy = r / win_w;
      const int gy = gy0 + wy;
      const int gx = gx0 + (r - wy * win_w);
      float val = 0.0f;
      if (c0 + cc < C && gy >= 0 && gy < H && gx >= 0 && gx < W) {
        val = f2b[(c0 + cc) * plane + static_cast<size_t>(gy) * W + gx];
      }
      win[i] = val;
    }
    __syncthreads();
    const int nc = min(kChunk, C - c0);
    for (int cc = 0; cc < nc; ++cc) {
      const float a = live ? a_ptr[(c0 + cc) * plane] : 0.0f;
      // this thread's tap (iy, ix) sits at window row ty os + iy ds and
      // column tx os + ix ds
      const float* w0 = win + cc * win_n + (ty * os) * win_w + tx * os;
#pragma unroll
      for (int iy = 0; iy < K; ++iy) {
        const float* row = w0 + iy * ds * win_w;
#pragma unroll
        for (int ix = 0; ix < K; ++ix) acc[iy * K + ix] += a * row[ix * ds];
      }
    }
  }
  if (!live) return;
  const float fc = static_cast<float>(C);
  const size_t oplane = static_cast<size_t>(Ho) * Wo;
  float* o = out + b * (K * K) * oplane + static_cast<size_t>(oy) * Wo + ox;
#pragma unroll
  for (int k = 0; k < K * K; ++k) o[k * oplane] = acc[k] / fc;
}

template <int K>
cudaError_t launch(const float* f1, const float* f2, float* out, int B, int C,
                   int H, int W, int Ho, int Wo, int os, int ds, int max_disp,
                   int win_h, int win_w, int smem_bytes, cudaStream_t stream) {
  const dim3 block(kTileX, kTileY);
  const dim3 grid((Wo + kTileX - 1) / kTileX, (Ho + kTileY - 1) / kTileY, B);
  correlation_kernel<K><<<grid, block, smem_bytes, stream>>>(
      f1, f2, out, C, H, W, Ho, Wo, os, ds, max_disp, win_h, win_w);
  return cudaGetLastError();
}

}  // namespace

// Shared memory one launch needs, in bytes (the wrapper checks it against
// the 48 KB a block gets without opting in).
extern "C" int ofc_correlation_smem(int os, int max_disp) {
  const int win_h = (kTileY - 1) * os + 1 + 2 * max_disp;
  const int win_w = (kTileX - 1) * os + 1 + 2 * max_disp;
  return kChunk * win_h * win_w * static_cast<int>(sizeof(float));
}

// f1, f2: [B, C, H, W] fp32 contiguous; out: [B, K*K, Ho, Wo] fp32
// contiguous with Ho = ceil(H / os), Wo = ceil(W / os), K = 2 max_disp / ds
// + 1, all on the current device (the caller selects it).  K must be 7 or 9.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int ofc_correlation(const void* f1, const void* f2, void* out,
                               int B, int C, int H, int W, int max_disp,
                               int ds, int os, void* stream) {
  if (ds < 1 || os < 1 || max_disp % ds != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int K = 2 * (max_disp / ds) + 1;
  const int Ho = (H + os - 1) / os;
  const int Wo = (W + os - 1) / os;
  const int win_h = (kTileY - 1) * os + 1 + 2 * max_disp;
  const int win_w = (kTileX - 1) * os + 1 + 2 * max_disp;
  const int smem = ofc_correlation_smem(os, max_disp);
  const auto* a = static_cast<const float*>(f1);
  const auto* b = static_cast<const float*>(f2);
  auto* o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 7:
      return static_cast<int>(launch<7>(a, b, o, B, C, H, W, Ho, Wo, os, ds,
                                        max_disp, win_h, win_w, smem, s));
    case 9:
      return static_cast<int>(launch<9>(a, b, o, B, C, H, W, Ho, Wo, os, ds,
                                        max_disp, win_h, win_w, smem, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
