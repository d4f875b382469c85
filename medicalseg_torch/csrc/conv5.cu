// 5^3 SAME convolution, stride 1, for Hopper (sm_90a), with an optional
// fused BatchNorm + PReLU epilogue.
//
// Replaces medicalseg_tpu/ops/pallas_conv5.py:_conv5_kernel (:186), the
// one Pallas kernel behind all three forms the V-Net eval path runs:
//   * the head form (_conv5_head_kl, :382): general Ci, every NConv stack
//     conv and the OutputTransition 32 -> num_classes conv; Ci, Co up to
//     256 in one launch (the TPU needed conv5_wide's co chunks, :1550);
//   * the stem form (_conv5_stem_kl, :423): Ci = 1, here the CUDA-core
//     kernel instantiated with one input channel per shared-memory pass;
//   * the fused epilogue (conv5_kl_fused, :1288; _pack_ep, :360):
//     y = PReLU_alpha((conv + b) * inv + shift), applied in f32 before the
//     single store.
// The same kernels compute the input gradient (the conv of the cotangent
// with the flipped, io-transposed weight, :1380).
//
// Layout: x and y are [N, D, C, H, W] views given by element strides for
// N, C, D and H; W must be the contiguous axis. Bias comes as f32 [Co] (the
// warpgroup kernel also takes a null pointer: no bias), the epilogue as f32
// [inv(Co), shift(Co), alpha(Co)]; the wrapper packs the weights for each kernel (see below),
// rounded to the activation dtype as the JAX layer casts its kernel.
//
// Bound on an H100 SXM (989 TF/s bf16 tensor cores, 3.35 TB/s HBM): a 5^3
// conv does 2 * 125 * Ci * Co FLOP per output voxel and must move
// (Ci + Co) activations per voxel, so for Ci, Co >= 16 the FLOP bound
// exceeds the byte bound 20-300x: the kernel is operation-bound, and at
// the deep levels (256 channels at 8^3 and 16^3) the 16 MB of weights
// outweigh the activations.
//
// Design against that bound, two kernels, one source each:
//   * conv5_wg_kernel (csrc/conv5_wg.cu; bf16 head form: the serving path,
//     the training forward and the input gradient): an implicit GEMM on
//     wgmma with warp-specialised asynchronous staging and a deterministic
//     split of K where the grid is short of blocks.
//   * conv5_kernel (this file; f32, where sums must stay exact f32, and the
//     Ci = 1 stem): a direct convolution on the CUDA cores. A block owns one
//     output depth slice, a th x tw tile of (h, w) and COT output
//     channels; each thread keeps 2 voxels x COT accumulators in
//     registers. For each depth tap and each group of CIC input channels
//     the block stages the input halo tile [CIC][th+4][tw+4] and the 25
//     in-plane taps' weights [25][CIC][COT] (f32, packed
//     [co_tile][kd][kh][kw][Ci][COT]) in shared memory, so every input
//     value is read from device memory about 5 times (once per depth tap)
//     instead of 125, and every weight read from shared memory (a
//     warp-wide broadcast) feeds 2 FMAs per output channel. Its ceiling
//     is the 67 TF/s f32 FMA rate; its staging is synchronous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KS = 5;           // kernel edge
constexpr int HALO = KS / 2;    // SAME padding on each side
constexpr int TAPS2 = KS * KS;  // (kh, kw) taps of one depth slice
constexpr int MAX_THREADS = 128;

struct Geom {
  int n, d, ci, h, w, co;
  int th, tw;  // output tile of a block: th rows x tw columns
  long long xs_n, xs_c, xs_d, xs_h;  // element strides of x (w stride 1)
  long long ys_n, ys_c, ys_d, ys_h;  // element strides of y (w stride 1)
};

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int COT, int CIC>
__global__ void __launch_bounds__(MAX_THREADS)
conv5_kernel(const T* __restrict__ x, const float* __restrict__ wpk,
             const float* __restrict__ bias, const float* __restrict__ ep,
             T* __restrict__ y, Geom g) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int sh = g.th + 2 * HALO;
  const int sw = g.tw + 2 * HALO;
  const int xtile = CIC * sh * sw;
  float* sx = smem;                         // [CIC][sh][sw]
  float* swt = smem + ((xtile + 3) & ~3);   // [25][CIC][COT], 16B aligned

  const int tiles_w = (g.w + g.tw - 1) / g.tw;
  const int h0 = (blockIdx.x / tiles_w) * g.th;
  const int w0 = (blockIdx.x % tiles_w) * g.tw;
  const int od = blockIdx.y;
  const int co_tiles = (g.co + COT - 1) / COT;
  const int n = blockIdx.z / co_tiles;
  const int ct = blockIdx.z % co_tiles;

  const int t = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lw = t % g.tw;
  const int lh = (t / g.tw) * 2;

  float acc0[COT], acc1[COT];
#pragma unroll
  for (int o = 0; o < COT; ++o) {
    acc0[o] = 0.f;
    acc1[o] = 0.f;
  }

  const T* xn = x + n * g.xs_n;
  const float* wt = wpk + (size_t)ct * KS * TAPS2 * g.ci * COT;

  for (int kd = 0; kd < KS; ++kd) {
    const int id = od + kd - HALO;
    if (id < 0 || id >= g.d) continue;  // uniform across the block
    for (int c0 = 0; c0 < g.ci; c0 += CIC) {
      const int cn = min(CIC, g.ci - c0);
      __syncthreads();  // the previous pass is done reading shared memory
      for (int i = t; i < xtile; i += nthreads) {
        const int c = i / (sh * sw);
        const int r = i - c * (sh * sw);
        const int ih = h0 + r / sw - HALO;
        const int iw = w0 + r % sw - HALO;
        float v = 0.f;
        if (c < cn && ih >= 0 && ih < g.h && iw >= 0 && iw < g.w)
          v = load_f(xn + (c0 + c) * g.xs_c + id * g.xs_d + ih * g.xs_h + iw);
        sx[i] = v;
      }
      const float* wk = wt + ((size_t)kd * TAPS2 * g.ci + c0) * COT;
      for (int i = t; i < TAPS2 * CIC * COT; i += nthreads) {
        const int tap = i / (CIC * COT);
        const int r = i - tap * (CIC * COT);  // c * COT + o
        swt[i] = r < cn * COT ? wk[(size_t)tap * g.ci * COT + r] : 0.f;
      }
      __syncthreads();
      for (int c = 0; c < cn; ++c) {
        const float* xr = sx + (c * sh + lh) * sw + lw;
        const float* wc = swt + c * COT;
#pragma unroll
        for (int kh = 0; kh < KS; ++kh) {
#pragma unroll
          for (int kw = 0; kw < KS; ++kw) {
            const float xa = xr[kh * sw + kw];
            const float xb = xr[(kh + 1) * sw + kw];
            const float4* wv =
                reinterpret_cast<const float4*>(wc + (kh * KS + kw) * CIC * COT);
#pragma unroll
            for (int q = 0; q < COT / 4; ++q) {
              const float4 wq = wv[q];
              acc0[4 * q + 0] = fmaf(xa, wq.x, acc0[4 * q + 0]);
              acc0[4 * q + 1] = fmaf(xa, wq.y, acc0[4 * q + 1]);
              acc0[4 * q + 2] = fmaf(xa, wq.z, acc0[4 * q + 2]);
              acc0[4 * q + 3] = fmaf(xa, wq.w, acc0[4 * q + 3]);
              acc1[4 * q + 0] = fmaf(xb, wq.x, acc1[4 * q + 0]);
              acc1[4 * q + 1] = fmaf(xb, wq.y, acc1[4 * q + 1]);
              acc1[4 * q + 2] = fmaf(xb, wq.z, acc1[4 * q + 2]);
              acc1[4 * q + 3] = fmaf(xb, wq.w, acc1[4 * q + 3]);
            }
          }
        }
      }
    }
  }

  const int oh = h0 + lh;
  const int ow = w0 + lw;
  if (ow >= g.w || oh >= g.h) return;
  T* yb = y + n * g.ys_n + od * g.ys_d + oh * g.ys_h + ow;
  const bool second = oh + 1 < g.h;
#pragma unroll
  for (int o = 0; o < COT; ++o) {
    const int co = ct * COT + o;
    if (co < g.co) {
      float v0 = acc0[o] + bias[co];
      float v1 = acc1[o] + bias[co];
      if (ep != nullptr) {
        const float inv = ep[co], shift = ep[g.co + co], alpha = ep[2 * g.co + co];
        v0 = v0 * inv + shift;
        v1 = v1 * inv + shift;
        v0 = v0 >= 0.f ? v0 : v0 * alpha;
        v1 = v1 >= 0.f ? v1 : v1 * alpha;
      }
      T* yc = yb + co * g.ys_c;
      store_f(yc, v0);
      if (second) store_f(yc + g.ys_h, v1);
    }
  }
}

template <typename T, int COT, int CIC>
cudaError_t launch(const void* x, const float* w, const float* b,
                   const float* ep, void* y, const Geom& g, cudaStream_t s) {
  const int tiles = ((g.h + g.th - 1) / g.th) * ((g.w + g.tw - 1) / g.tw);
  const dim3 grid(tiles, g.d, g.n * ((g.co + COT - 1) / COT));
  const int threads = g.th * g.tw / 2;
  const int xtile = CIC * (g.th + 2 * HALO) * (g.tw + 2 * HALO);
  const size_t smem = sizeof(float) * (((xtile + 3) & ~3) + TAPS2 * CIC * COT);
  auto kern = conv5_kernel<T, COT, CIC>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, threads, smem, s>>>(static_cast<const T*>(x), w, b, ep,
                                   static_cast<T*>(y), g);
  return cudaGetLastError();
}

template <typename T, int CIC>
cudaError_t dispatch(int cot, const void* x, const float* w, const float* b,
                     const float* ep, void* y, const Geom& g, cudaStream_t s) {
  switch (cot) {
    case 4: return launch<T, 4, CIC>(x, w, b, ep, y, g, s);
    case 8: return launch<T, 8, CIC>(x, w, b, ep, y, g, s);
    case 16: return launch<T, 16, CIC>(x, w, b, ep, y, g, s);
    case 32: return launch<T, 32, CIC>(x, w, b, ep, y, g, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches one 5^3 SAME conv on `stream`. bf16 != 0: x and y are bf16,
// else f32. stem != 0 selects the Ci = 1 instantiation. cot is the
// output-channel tile (4, 8, 16 or 32) the weights were packed with;
// th (even) x tw is the output tile, th * tw / 2 <= 128 threads.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int conv5_launch(const void* x, const void* wpk, const void* bias,
                            const void* ep, void* y, int bf16, int stem,
                            int cot, int th, int tw, int n, int d, int ci,
                            int h, int w, int co, long long xs_n,
                            long long xs_c, long long xs_d, long long xs_h,
                            long long ys_n, long long ys_c, long long ys_d,
                            long long ys_h, void* stream) {
  if (th < 2 || th % 2 || tw < 1 || th * tw / 2 > MAX_THREADS)
    return cudaErrorInvalidValue;
  if (stem && ci != 1) return cudaErrorInvalidValue;
  const Geom g{n, d, ci, h, w, co, th, tw,
               xs_n, xs_c, xs_d, xs_h, ys_n, ys_c, ys_d, ys_h};
  const float* wf = static_cast<const float*>(wpk);
  const float* bf = static_cast<const float*>(bias);
  const float* ef = static_cast<const float*>(ep);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return stem ? dispatch<__nv_bfloat16, 1>(cot, x, wf, bf, ef, y, g, s)
                : dispatch<__nv_bfloat16, 8>(cot, x, wf, bf, ef, y, g, s);
  }
  return stem ? dispatch<float, 1>(cot, x, wf, bf, ef, y, g, s)
              : dispatch<float, 8>(cot, x, wf, bf, ef, y, g, s);
}
