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
// Pallas kernel takes out_stride 1 only): the launcher takes disp_stride a
// multiple of out_stride, which all six are.
//
// Bound: bytes.  f1 and f2 are read once and K*K outputs written per pixel:
// at PWC-Net level 2 (B=8, C=32, 128 x 160, K*K=81) ~95 MB, 28 us at
// 3.35 TB/s, against 2 C K*K flops per pixel, 849 MFLOP, 13 us at the fp32
// rate of the CUDA cores.  The FMA time is below the byte time, so the sums
// stay fp32 FMAs on CUDA cores: tensor cores would not lower the bound, and
// a K*K-wide dot product per pixel does not map onto their tiles without
// materialising the shifted windows.
//
// Design.
// - Staging.  With s = out_stride, every tap lies on the s-strided grid
//   (disp_stride is a multiple of s), so a block stages only those rows and
//   columns of f2, and f1 at its output pixels: in staged units the problem
//   is out_stride 1 with displacement step DS = disp_stride / s (1 or 2).
//   A chunk of channels of the f2 window and the f1 tile goes to shared
//   memory by `cp.async`, whose zero-fill form (src-size 0) gives the zero
//   padding exactly: 16-byte copies where s = 1 and W % 4 == 0 (the window
//   starts on a 16-byte boundary, D*DS rounded up to 4 columns left of the
//   tile), 4-byte ones elsewhere.  With two such buffers chunk k + 1 is in
//   flight while chunk k is summed; a split short enough to stage at once
//   takes one.  Each thread's share
//   of a window is a fixed column and a row step computed once per block:
//   no division per staged value.
// - Not TMA: a tensor map needs the row stride W * 4 bytes to be a
//   multiple of 16, and PWC-Net's level 6 has W = 10 (so do odd sizes);
//   the s = 2 staging is not a box either.  One path serves every shape.
// - Register blocking.  A thread owns a strip of 4 neighbouring outputs on
//   one tap row iy: per channel it reads the strip's f1 values (one 16-byte
//   shared load) and the 4 + (K-1) DS window values of its row (3-5 16-byte
//   loads) and does 4 K FMAs from registers: 4-6 shared loads per 28-36
//   FMAs instead of one per FMA.  Neighbouring lanes read neighbouring
//   16-byte words; for tiles narrower than 32 the window's row stride is
//   congruent to the tile width mod 32, so a quarter warp whose strips span
//   rows hits distinct banks too.  out_stride 2 reads the same way, since
//   its strided columns are staged side by side.
// - Filling the card.  The grid's axes are pixel tiles (sized to the level),
//   groups of tap rows, channel splits and the batch; the wrapper's
//   `launch_config` picks them.  With one split a block writes sum / C.
//   With S splits each block writes its partial sums to a workspace
//   [S, B, K*K, Ho, Wo] and `correlation_reduce_kernel` adds them in split
//   order, then divides by C.
// - Reduction order.  Every output's channels are summed in ascending order
//   within a split, the splits in ascending order: no atomics, so a launch
//   repeats bit for bit, and every tile, tap grouping, chunk, buffer count
//   and copy width gives the same bits for the same number of splits.
// CUDA rather than Triton: the K shifted, strided reads of one staged row are
// register-level reuse that Triton's block model does not express, and the
// port builds all its kernels with one nvcc call.
#include <cuda_runtime.h>

namespace {

constexpr int kStrip = 4;         // output pixels per thread, along x
constexpr int kMaxThreads = 256;  // the launcher refuses larger blocks

// 4 or 16 bytes from global to shared memory; `bytes` < size zero-fills the
// rest (0: all zeros, src unread)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Columns of the staged f2 window left of the tile's first output: D DS
// rounded up to 4, so the window starts on a 16-byte boundary.
__host__ __device__ constexpr int pad_left(int K, int DS) {
  return (K / 2 * DS + 3) / 4 * 4;
}

struct Geometry {
  int C, H, W, Ho, Wo, os;
  int tw, th, taps;        // tile width (multiple of 4) and height, tap rows
  int tiles_x, groups, splits, chunk;
  int wr, wc, ws;          // window rows, columns, row stride (floats)
  int vec;                 // 16-byte copies: os 1, W % 4 == 0, aligned
  int stages;              // staged buffers: 1, or 2 to overlap
};

// A thread's share of a 2-D walk over rows x cols: columns c0, c0 + cstep,
// ..., and in each rows r0, r0 + rstep, ...  Computed once per block.
struct Walk {
  int c0, r0, cstep, rstep;
};

__device__ __forceinline__ Walk make_walk(int cols) {
  const int nt = blockDim.x, tid = threadIdx.x;
  if (nt < cols) return {tid, 0, nt, 1};
  const int rstep = nt / cols;
  const int r0 = tid / cols;
  if (r0 >= rstep) return {cols, 0, cols, 1};  // idle: no column
  return {tid - r0 * cols, r0, cols, rstep};
}

// Stage `n` channels from c into one buffer: f2's window [chunk][wr][ws]
// (staged units: every os-th row and column from (sy0, sx0)) and f1's tile
// [chunk][th][tw], zeros outside the image.
__device__ __forceinline__ void stage(const Geometry& g, const float* f1b,
                                      const float* f2b, float* buf, int c,
                                      int n, int sy0, int sx0, int oy0,
                                      int ox0, const Walk& w2,
                                      const Walk& w1) {
  const size_t plane = static_cast<size_t>(g.H) * g.W;
  float* win = buf;
  float* a = buf + g.chunk * g.wr * g.ws;
  if (g.vec) {
    for (int q = w2.c0; 4 * q < g.wc; q += w2.cstep) {
      const int gx = sx0 + 4 * q;  // a multiple of 4: all in or all out
      const bool okx = gx >= 0 && gx < g.W;
      for (int cc = 0; cc < n; ++cc) {
        const float* p = f2b + (c + cc) * plane + (okx ? gx : 0);
        float* w = win + cc * g.wr * g.ws + 4 * q;
        for (int r = w2.r0; r < g.wr; r += w2.rstep) {
          const int gy = sy0 + r;
          const bool ok = okx && gy >= 0 && gy < g.H;
          cp_async16(w + r * g.ws, ok ? p + static_cast<size_t>(gy) * g.W : f2b,
                     ok ? 16 : 0);
        }
      }
    }
    for (int q = w1.c0; 4 * q < g.tw; q += w1.cstep) {
      const int x = ox0 + 4 * q;
      const bool okx = x < g.Wo;
      for (int cc = 0; cc < n; ++cc) {
        const float* p = f1b + (c + cc) * plane + (okx ? x : 0);
        float* t = a + cc * g.th * g.tw + 4 * q;
        for (int r = w1.r0; r < g.th; r += w1.rstep) {
          const int y = oy0 + r;
          const bool ok = okx && y < g.Ho;
          cp_async16(t + r * g.tw, ok ? p + static_cast<size_t>(y) * g.W : f1b,
                     ok ? 16 : 0);
        }
      }
    }
    return;
  }
  for (int col = w2.c0; col < g.wc; col += w2.cstep) {
    const int gx = (sx0 + col) * g.os;
    const bool okx = gx >= 0 && gx < g.W;
    for (int cc = 0; cc < n; ++cc) {
      const float* p = f2b + (c + cc) * plane + (okx ? gx : 0);
      float* w = win + cc * g.wr * g.ws + col;
      for (int r = w2.r0; r < g.wr; r += w2.rstep) {
        const int gy = (sy0 + r) * g.os;
        const bool ok = okx && gy >= 0 && gy < g.H;
        cp_async4(w + r * g.ws, ok ? p + static_cast<size_t>(gy) * g.W : f2b,
                  ok ? 4 : 0);
      }
    }
  }
  for (int col = w1.c0; col < g.tw; col += w1.cstep) {
    const int x = ox0 + col;
    const bool okx = x < g.Wo;
    for (int cc = 0; cc < n; ++cc) {
      const float* p = f1b + (c + cc) * plane + (okx ? x * g.os : 0);
      float* t = a + cc * g.th * g.tw + col;
      for (int r = w1.r0; r < g.th; r += w1.rstep) {
        const int y = oy0 + r;
        const bool ok = okx && y < g.Ho;
        cp_async4(t + r * g.tw,
                  ok ? p + static_cast<size_t>(y * g.os) * g.W : f1b,
                  ok ? 4 : 0);
      }
    }
  }
}

// Blocks of kMaxThreads an SM should hold, which caps the registers: K = 9
// at 85 and K = 7 with DS = 1 at 64, for more resident warps (both ran
// faster so than uncapped); K = 7 with DS = 2 at 128, which its 20 window
// values need.  chip_smoke.py's build phase prints ptxas's counts.
template <int K, int DS>
constexpr int kMinBlocks = K == 9 ? 3 : (DS == 1 ? 4 : 2);

// One block: a th x tw tile of outputs, `taps` tap rows from group
// blockIdx.y % groups, the channels of split blockIdx.y / groups, batch
// blockIdx.z.  Thread (tz, ty, tx), tx fastest: tap row g0 + tz, output row
// ty, pixels 4 tx .. 4 tx + 3 of the tile.
template <int K, int DS>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks<K, DS>)
correlation_kernel(const float* __restrict__ f1, const float* __restrict__ f2,
                   float* __restrict__ out, Geometry g) {
  constexpr int D = K / 2;
  constexpr int kPad = pad_left(K, DS);
  constexpr int kOff = kPad - D * DS;  // window column of tap (., 0), pixel 0
  constexpr int kSpan = kOff + kStrip + (K - 1) * DS;  // values a strip reads
  constexpr int kVec = (kSpan + 3) / 4;                // as 16-byte loads
  extern __shared__ __align__(16) float smem[];
  const int strips = g.tw / kStrip;
  const int tx = threadIdx.x % strips;
  const int ty = (threadIdx.x / strips) % g.th;
  const int tz = threadIdx.x / (strips * g.th);
  const int tile_y = blockIdx.x / g.tiles_x;
  const int tile_x = blockIdx.x - tile_y * g.tiles_x;
  const int group = blockIdx.y % g.groups;
  const int split = blockIdx.y / g.groups;
  const int b = blockIdx.z;
  const int oy0 = tile_y * g.th, ox0 = tile_x * g.tw;
  const int g0 = group * g.taps;
  const int iy = g0 + tz;
  // the staged window's origin (staged units): row of tap row g0 for the
  // tile's first output row, kPad columns left of its first column
  const int sy0 = oy0 + (g0 - D) * DS;
  const int sx0 = ox0 - kPad;
  const int cb = static_cast<int>(static_cast<long long>(split) * g.C / g.splits);
  const int ce = static_cast<int>(static_cast<long long>(split + 1) * g.C / g.splits);
  const size_t plane = static_cast<size_t>(g.H) * g.W;
  const float* f1b = f1 + static_cast<size_t>(b) * g.C * plane;
  const float* f2b = f2 + static_cast<size_t>(b) * g.C * plane;
  const int stage_floats = g.chunk * (g.wr * g.ws + g.th * g.tw);
  const bool live = iy < K;
  const Walk w2 = make_walk(g.vec ? g.wc / 4 : g.wc);
  const Walk w1 = make_walk(g.vec ? g.tw / 4 : g.tw);

  float acc[K * kStrip];
#pragma unroll
  for (int k = 0; k < K * kStrip; ++k) acc[k] = 0.0f;

  // g.stages buffers in a ring: with two, chunk k + 1 is in flight while
  // chunk k is summed
  const int nchunks = (ce - cb + g.chunk - 1) / g.chunk;
  for (int k = 0; k < g.stages - 1; ++k) {
    const int c = cb + k * g.chunk;
    if (k < nchunks) {
      stage(g, f1b, f2b, smem + k * stage_floats, c, min(g.chunk, ce - c),
            sy0, sx0, oy0, ox0, w2, w1);
    }
    cp_async_commit();  // stages - 1 groups, empty or not, before the loop
  }
  for (int k = 0; k < nchunks; ++k) {
    const int c = cb + k * g.chunk;
    const int n = min(g.chunk, ce - c);
    const int kn = k + g.stages - 1;
    if (kn < nchunks) {
      const int cn = cb + kn * g.chunk;
      stage(g, f1b, f2b, smem + (kn % g.stages) * stage_floats, cn,
            min(g.chunk, ce - cn), sy0, sx0, oy0, ox0, w2, w1);
    }
    cp_async_commit();  // possibly empty: keeps one group per chunk
    if (g.stages == 2) {
      cp_async_wait<1>();  // chunk k has landed, chunk k + 1 may be in flight
    } else {
      cp_async_wait<0>();
    }
    const float* buf = smem + (k % g.stages) * stage_floats;
    __syncthreads();  // chunk k is in shared memory for every thread
    if (live) {
      const float* win = buf + (ty + tz * DS) * g.ws + kStrip * tx;
      const float* a = buf + g.chunk * g.wr * g.ws + ty * g.tw + kStrip * tx;
      for (int cc = 0; cc < n; ++cc) {
        float av[kStrip];
#pragma unroll
        for (int v = 0; v < kStrip / 4; ++v) {
          const float4 q = *reinterpret_cast<const float4*>(
              a + cc * g.th * g.tw + 4 * v);
          av[4 * v] = q.x;
          av[4 * v + 1] = q.y;
          av[4 * v + 2] = q.z;
          av[4 * v + 3] = q.w;
        }
        float w[4 * kVec];
        const float* row = win + cc * g.wr * g.ws;
#pragma unroll
        for (int v = 0; v < kVec; ++v) {
          const float4 q = *reinterpret_cast<const float4*>(row + 4 * v);
          w[4 * v] = q.x;
          w[4 * v + 1] = q.y;
          w[4 * v + 2] = q.z;
          w[4 * v + 3] = q.w;
        }
#pragma unroll
        for (int ix = 0; ix < K; ++ix) {
#pragma unroll
          for (int j = 0; j < kStrip; ++j) {
            acc[ix * kStrip + j] =
                fmaf(av[j], w[kOff + j + ix * DS], acc[ix * kStrip + j]);
          }
        }
      }
    }
    __syncthreads();  // every reader of this buffer is done
  }
  const int y = oy0 + ty;
  const int x0 = ox0 + kStrip * tx;
  if (!live || y >= g.Ho || x0 >= g.Wo) return;
  const size_t oplane = static_cast<size_t>(g.Ho) * g.Wo;
  // one split: the mean; several: raw partial sums into the workspace
  const float fc = static_cast<float>(g.C);
  float* o = out +
             (static_cast<size_t>(split) * gridDim.z + b) * (K * K) * oplane +
             static_cast<size_t>(iy * K) * oplane +
             static_cast<size_t>(y) * g.Wo + x0;
  const bool vec = (g.Wo % 4 == 0) && x0 + kStrip <= g.Wo;
#pragma unroll
  for (int ix = 0; ix < K; ++ix) {
    float v[kStrip];
#pragma unroll
    for (int j = 0; j < kStrip; ++j) {
      v[j] = g.splits == 1 ? acc[ix * kStrip + j] / fc : acc[ix * kStrip + j];
    }
    float* p = o + ix * oplane;
    if (vec) {
#pragma unroll
      for (int j = 0; j < kStrip; j += 4) {
        *reinterpret_cast<float4*>(p + j) =
            make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kStrip; ++j) {
        if (x0 + j < g.Wo) p[j] = v[j];
      }
    }
  }
}

// out[i] = (sum over s in order of part[s, i]) / C, i < n.
__global__ void __launch_bounds__(256)
correlation_reduce_kernel(const float* __restrict__ part,
                          float* __restrict__ out, size_t n, int splits,
                          int C) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = part[i];
  for (int k = 1; k < splits; ++k) s += part[static_cast<size_t>(k) * n + i];
  out[i] = s / static_cast<float>(C);
}

template <int K, int DS>
cudaError_t launch(const float* f1, const float* f2, float* dst, int B,
                   const Geometry& g, int threads, int smem,
                   cudaStream_t stream) {
  const int tiles_y = (g.Ho + g.th - 1) / g.th;
  const dim3 grid(g.tiles_x * tiles_y, g.groups * g.splits, B);
  correlation_kernel<K, DS><<<grid, threads, smem, stream>>>(f1, f2, dst, g);
  return cudaGetLastError();
}

}  // namespace

// f1, f2: [B, C, H, W] fp32 contiguous; out: [B, K*K, Ho, Wo] fp32
// contiguous with Ho = ceil(H / os), Wo = ceil(W / os), K = 2 max_disp / ds
// + 1 (7 or 9), ds a multiple of os; all on the current device (the caller
// selects it).  The launch configuration (`launch_config` in
// ops/correlation.py): tile tw x th (tw a multiple of 4), `taps` tap rows
// per block, `splits` channel splits, `chunk` channels per staged buffer,
// `ws` the window's row stride (floats), `vec` 1 for 16-byte copies (os 1,
// W % 4 == 0, 16-byte aligned f1 and f2) or 0 for 4-byte ones, `stages`
// staged buffers (1, or 2: cp.async of chunk k + 1 under the sums of chunk
// k), `smem` = stages * chunk * (wr ws + th tw) * 4 bytes
// with wr = th + (taps - 1) ds / os.  With splits > 1, `work` is a [splits,
// B, K*K, Ho, Wo] fp32 workspace and a second kernel reduces it into out.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int ofc_correlation(const void* f1, const void* f2, void* out,
                               void* work, int B, int C, int H, int W,
                               int max_disp, int ds, int os, int tw, int th,
                               int taps, int splits, int chunk, int ws,
                               int vec, int stages, int smem,
                               void* stream) {
  if (ds < 1 || os < 1 || max_disp % ds != 0 || ds % os != 0 || tw < 4 ||
      tw % kStrip != 0 || th < 1 || taps < 1 || splits < 1 || splits > C ||
      chunk < 1 || stages < 1 || stages > 2 ||
      (splits > 1 && work == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int K = 2 * (max_disp / ds) + 1;
  const int DS = ds / os;
  Geometry g;
  g.C = C;
  g.H = H;
  g.W = W;
  g.os = os;
  g.Ho = (H + os - 1) / os;
  g.Wo = (W + os - 1) / os;
  g.tw = tw;
  g.th = th;
  g.taps = taps;
  g.tiles_x = (g.Wo + tw - 1) / tw;
  g.groups = (K + taps - 1) / taps;
  g.splits = splits;
  g.chunk = chunk;
  g.wr = th + (taps - 1) * DS;
  const int pad = pad_left(K, DS);
  g.wc = (tw + pad + K / 2 * DS + 3) / 4 * 4;
  g.ws = ws;
  // 16-byte copies need 16-byte rows and bases: every staged column is then
  // a multiple of 4 from a 16-byte boundary
  const auto aligned = [](const void* p) {
    return reinterpret_cast<unsigned long long>(p) % 16 == 0;
  };
  g.vec = vec;
  g.stages = stages;
  const int span = pad - K / 2 * DS + kStrip + (K - 1) * DS;
  const int threads = (tw / kStrip) * th * taps;
  if (threads > kMaxThreads || ws % 4 != 0 || ws < g.wc ||
      ws < tw - kStrip + 4 * ((span + 3) / 4) ||
      (vec && (os != 1 || W % 4 != 0 || !aligned(f1) || !aligned(f2))) ||
      smem != stages * chunk * (g.wr * ws + th * tw) * 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* a = static_cast<const float*>(f1);
  const auto* b = static_cast<const float*>(f2);
  auto* dst = static_cast<float*>(splits > 1 ? work : out);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (K == 9 && DS == 1) {
    e = launch<9, 1>(a, b, dst, B, g, threads, smem, s);
  } else if (K == 9 && DS == 2) {
    e = launch<9, 2>(a, b, dst, B, g, threads, smem, s);
  } else if (K == 7 && DS == 1) {
    e = launch<7, 1>(a, b, dst, B, g, threads, smem, s);
  } else if (K == 7 && DS == 2) {
    e = launch<7, 2>(a, b, dst, B, g, threads, smem, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  const size_t n = static_cast<size_t>(B) * K * K * g.Ho * g.Wo;
  const unsigned blocks = static_cast<unsigned>((n + 255) / 256);
  correlation_reduce_kernel<<<blocks, 256, 0, s>>>(
      static_cast<const float*>(work), static_cast<float*>(out), n, splits, C);
  return static_cast<int>(cudaGetLastError());
}
