// HU window + order-1 resize along the leading (depth) axis, in one pass.
//
// Replaces medicalseg_tpu/ops/pallas_kernels.py:_hu_resize_kernel (:60,
// launched by the pallas_call at :86): out[t, :] = W[t, :] @ win(x), with
//   win(v) = clip(((isnan(v) ? hu_nan : v) - hu_min) / (hu_max - hu_min),
//                 0, 1) * 255
// and W the (out_d, D) endpoint-aligned interpolation matrix. The windowed
// volume is never written to memory. The TPU kernel hard-codes the default
// window although its wrapper takes hu_min / hu_max / hu_nan; here they are
// arguments.
//
// Bound on an H100 SXM: bytes. x [D, H*W] f32 is read once and out
// [out_d, H*W] f32 written once, 4 * (D + out_d) * H * W bytes over
// 3.35 TB/s; the arithmetic (a subtract, a divide, two min/max and a
// multiply per input, two multiply-adds per output) is two orders below
// the f32 rate.
//
// Design against that bound. A row of W has two non-zeros, lo[t] and
// hi[t] = min(lo[t] + 1, D - 1), so this is no matrix product: a thread
// owns V neighbouring columns (V = 4 as one 16-byte word where H*W and the
// pointers allow, else V = 1: any H*W, no padded copy), walks a chunk of
// output slices in order, windows each input slice in registers as it
// loads it and writes w0[t] * win(x[lo[t]]) + w1[t] * win(x[hi[t]]).
// Neighbouring threads read and write neighbouring addresses. The two
// windowed slices of the last output stay in registers, so where
// consecutive outputs share a tap (every upsample, most downsamples) the
// slice is loaded once. blockIdx.y splits the output slices into chunks of
// t_per_block so that enough loads are in flight to fill the card; a chunk
// re-reads at most one slice of its neighbour's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Window {
  float hu_min, range, hu_nan;
  // NaN is replaced first: fminf / fmaxf return their non-NaN operand, so
  // the clip alone would turn NaN into 0 whatever hu_nan is.
  __device__ __forceinline__ float operator()(float v) const {
    v = (v != v) ? hu_nan : v;
    const float y = (v - hu_min) / range;  // +-inf stay +-inf
    return fminf(fmaxf(y, 0.0f), 1.0f) * 255.0f;
  }
};

template <int V>
struct Vec;
template <>
struct Vec<1> {
  float v[1];
  __device__ __forceinline__ void load(const float* p) { v[0] = __ldg(p); }
  __device__ __forceinline__ void store(float* p) const { p[0] = v[0]; }
};
template <>
struct Vec<4> {
  float v[4];
  __device__ __forceinline__ void load(const float* p) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  __device__ __forceinline__ void store(float* p) const {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <int V>
__device__ __forceinline__ Vec<V> load_windowed(const float* x, int slice,
                                                long long hw, long long col,
                                                const Window& win) {
  Vec<V> r;
  r.load(x + (long long)slice * hw + col);
#pragma unroll
  for (int k = 0; k < V; ++k) r.v[k] = win(r.v[k]);
  return r;
}

// idx: int32 [2, out_d] = lo, hi. wt: f32 [2, out_d] = w0, w1.
template <int V>
__global__ void __launch_bounds__(256)
hu_resize_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                 const float* __restrict__ wt, float* __restrict__ out,
                 int out_d, long long hw, int t_per_block, Window win) {
  const long long col =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (col >= hw) return;
  const int t0 = blockIdx.y * t_per_block;
  const int t1 = min(out_d, t0 + t_per_block);
  int ca = -1, cb = -1;  // slices whose windowed values va, vb hold
  Vec<V> va, vb;
  for (int t = t0; t < t1; ++t) {
    const int lo = __ldg(idx + t), hi = __ldg(idx + out_d + t);
    const float w0 = __ldg(wt + t), w1 = __ldg(wt + out_d + t);
    Vec<V> a, b;
    if (lo == ca) a = va;
    else if (lo == cb) a = vb;
    else a = load_windowed<V>(x, lo, hw, col, win);
    if (hi == lo) b = a;
    else if (hi == cb) b = vb;
    else if (hi == ca) b = va;
    else b = load_windowed<V>(x, hi, hw, col, win);
    Vec<V> o;
#pragma unroll
    for (int k = 0; k < V; ++k) o.v[k] = w0 * a.v[k] + w1 * b.v[k];
    o.store(out + (long long)t * hw + col);
    ca = lo; va = a; cb = hi; vb = b;
  }
}

}  // namespace

// x: f32 [d, hw] contiguous; idx: int32 [2, out_d] (lo, hi), every entry
// in [0, d); wt: f32 [2, out_d] (w0, w1); out: f32 [out_d, hw]. range =
// hu_max - hu_min. Launches on `stream`; returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int hu_resize_launch(const float* x, const int* idx,
                                const float* wt, float* out, int d, int out_d,
                                long long hw, int t_per_block, float hu_min,
                                float range, float hu_nan, void* stream) {
  if (d <= 0 || out_d <= 0 || hw <= 0 || t_per_block <= 0)
    return cudaErrorInvalidValue;
  const bool vec4 =
      hw % 4 == 0 && (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
      (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const long long cols = vec4 ? hw / 4 : hw;
  const long long bx = (cols + 255) / 256;
  const int by = (out_d + t_per_block - 1) / t_per_block;
  if (bx > 0x7fffffffLL || by > 65535) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)bx, (unsigned)by);
  const Window win{hu_min, range, hu_nan};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4)
    hu_resize_kernel<4><<<grid, 256, 0, s>>>(x, idx, wt, out, out_d, hw,
                                             t_per_block, win);
  else
    hu_resize_kernel<1><<<grid, 256, 0, s>>>(x, idx, wt, out, out_d, hw,
                                             t_per_block, win);
  return cudaGetLastError();
}
