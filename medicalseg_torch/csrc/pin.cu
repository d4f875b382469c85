// Layout pin: copy a strided 5-D tensor into contiguous row-major order.
//
// Replaces medicalseg_tpu/ops/pallas_conv5.py:_pin_kernel (:1412, launched
// by _pin_call at :1424): an identity copy that forces a kernel-layout
// [N, D, C, H, W] tensor into row-major layout. On the card it runs where a
// layout view (a transposed conv output seen as [N, D, C, H, W]) has to
// become the contiguous tensor the conv5 kernel and the elementwise ops
// read.
//
// Bound on an H100 SXM: no arithmetic, so bytes: (read + write) of the
// tensor over 3.35 TB/s.
//
// Design against that bound. Where the innermost axes of the view are
// jointly contiguous, the copy is a permutation of contiguous runs (the
// (H, W) plane of every view the model pins: 32 KB at 128^3, 128 bytes at
// 8^3). pin_vec_kernel moves such a view as 16-byte words over a flat
// grid sized by the tensor's bytes: a thread owns one word of the output
// at a time, neighbouring threads neighbouring words, four words in
// flight per thread, and the run an output word belongs to costs one
// division chain per word (8 or 4 elements), not one per element. A
// 128-byte run is 8 threads' work, so small planes fill the card as well
// as large ones. The wrapper takes this path when runs, outer strides and
// both base addresses are multiples of 16 bytes. Everything else (a
// strided last axis, a misaligned base, odd runs) goes through
// pin_kernel: one block per (i0, i1, i2) plane walking its (i3, i4)
// elements in output order as 2- or 4-byte words.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int VEC_THREADS = 256;
constexpr int VEC_UNROLL = 4;

// The view as runs of `vpr` 16-byte words; run r sits at the source offset
// (in words) given by its index (i0, i1, i2, i3) over the outer sizes
// o0..o3 and strides u0..u3. Unused outer axes have size 1.
struct Runs {
  long long vecs;  // 16-byte words of the tensor
  long long vpr;   // words per run
  int o1, o2, o3;
  long long u0, u1, u2, u3;
};

// I is the index type of the division chain: 32 bits wherever the tensor
// has fewer than 2^32 words (64-bit division costs several times more).
template <typename I>
__device__ __forceinline__ long long src_word(const Runs& r, long long v) {
  const I run = (I)v / (I)r.vpr;
  const I off = (I)v - run * (I)r.vpr;
  const I a = run / (I)r.o3;
  const I i3 = run - a * (I)r.o3;
  const I b = a / (I)r.o2;
  const I i2 = a - b * (I)r.o2;
  const I i0 = b / (I)r.o1;
  const I i1 = b - i0 * (I)r.o1;
  return (long long)i0 * r.u0 + (long long)i1 * r.u1 + (long long)i2 * r.u2 +
         (long long)i3 * r.u3 + (long long)off;
}

template <typename I>
__global__ void __launch_bounds__(VEC_THREADS)
pin_vec_kernel(const uint4* __restrict__ x, uint4* __restrict__ y, Runs r) {
  const long long stride = (long long)gridDim.x * VEC_THREADS;
  long long v = (long long)blockIdx.x * VEC_THREADS + threadIdx.x;
  for (; v + (VEC_UNROLL - 1) * stride < r.vecs; v += VEC_UNROLL * stride) {
    uint4 t[VEC_UNROLL];
#pragma unroll
    for (int k = 0; k < VEC_UNROLL; ++k)
      t[k] = x[src_word<I>(r, v + k * stride)];
#pragma unroll
    for (int k = 0; k < VEC_UNROLL; ++k) y[v + k * stride] = t[k];
  }
  for (; v < r.vecs; v += stride) y[v] = x[src_word<I>(r, v)];
}

template <typename T>
__global__ void pin_kernel(const T* __restrict__ x, T* __restrict__ y, int s1,
                           int s2, int s3, int s4, long long t0, long long t1,
                           long long t2, long long t3, long long t4) {
  const long long plane = blockIdx.x;
  const int i2 = (int)(plane % s2);
  const long long r = plane / s2;
  const int i1 = (int)(r % s1);
  const long long i0 = r / s1;
  const T* xp = x + i0 * t0 + i1 * t1 + i2 * t2;
  const int m = s3 * s4;
  T* yp = y + plane * m;
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    const int a = j / s4;
    const int b = j - a * s4;
    yp[j] = xp[a * t3 + b * t4];
  }
}

template <typename T>
cudaError_t launch(const void* x, void* y, long long planes, int s1, int s2,
                   int s3, int s4, long long t0, long long t1, long long t2,
                   long long t3, long long t4, cudaStream_t s) {
  pin_kernel<T><<<(unsigned)planes, 256, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(y), s1, s2, s3, s4, t0, t1,
      t2, t3, t4);
  return cudaGetLastError();
}

}  // namespace

// Copies the 5-D view x (sizes s0..s4, element strides t0..t4) into the
// contiguous tensor y on `stream`, element by element. elem_bytes is 2 or
// 4. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int pin_launch(const void* x, void* y, int elem_bytes, int s0,
                          int s1, int s2, int s3, int s4, long long t0,
                          long long t1, long long t2, long long t3,
                          long long t4, void* stream) {
  const long long planes = (long long)s0 * s1 * s2;
  if (planes <= 0 || planes > 0x7fffffffLL || (long long)s3 * s4 > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 2: return launch<uint16_t>(x, y, planes, s1, s2, s3, s4, t0, t1, t2, t3, t4, s);
    case 4: return launch<uint32_t>(x, y, planes, s1, s2, s3, s4, t0, t1, t2, t3, t4, s);
    default: return cudaErrorInvalidValue;
  }
}

// Copies a view made of contiguous runs as 16-byte words: `vecs` words in
// all, `vpr` words a run, the runs indexed by outer sizes o0..o3 (o0 is
// implied) with source strides u0..u3 in words. x and y must be 16-byte
// aligned. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int pin_vec_launch(const void* x, void* y, long long vecs,
                              long long vpr, int o1, int o2, int o3,
                              long long u0, long long u1, long long u2,
                              long long u3, void* stream) {
  if (vecs <= 0 || vpr <= 0 || o1 < 1 || o2 < 1 || o3 < 1 ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(y) % 16)
    return cudaErrorInvalidValue;
  const Runs r{vecs, vpr, o1, o2, o3, u0, u1, u2, u3};
  const long long want = (vecs + VEC_THREADS * VEC_UNROLL - 1) /
                         (VEC_THREADS * VEC_UNROLL);
  const unsigned blocks = (unsigned)(want < 132 * 16 ? want : 132 * 16);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint4* xv = static_cast<const uint4*>(x);
  uint4* yv = static_cast<uint4*>(y);
  if (vecs < 0xffffffffLL)
    pin_vec_kernel<uint32_t><<<blocks, VEC_THREADS, 0, s>>>(xv, yv, r);
  else
    pin_vec_kernel<unsigned long long><<<blocks, VEC_THREADS, 0, s>>>(xv, yv, r);
  return cudaGetLastError();
}
