// Weight gradient of the 5^3 SAME convolution (stride 1), for Hopper
// (sm_90a):
//
//   dW[kd, kh, kw, ci, co] =
//       sum over (n, d, h, w) of x[n, d+kd-2, ci, h+kh-2, w+kw-2] * g[n, d, co, h, w]
//
// with x zero outside the volume, operands in x's dtype (bf16 or f32),
// products and sums in f32, dW written in f32 as [5, 5, 5, Ci, Co].
//
// Replaces both wgrad families of medicalseg_tpu/ops/pallas_conv5.py at
// once: _wgrad_kernel_ck / _wgrad_kernel (:539, :465; the stem and the
// narrow head, pallas_calls :912 and :977) and _wgrad_mid_kernel_ck /
// _wgrad_mid_kernel (:697, :646; square stacks up to 64 channels,
// pallas_call :832), and also covers the wide stacks (128 and 256
// channels) that the JAX package leaves to XLA's VJP. The TPU kernels are
// not carried over: their 25x / 5x shifted copies of g exist because TPU
// lane slices must be aligned, their std / mid split because the f32
// accumulator must fit VMEM, and their one output block accumulated by a
// sequential grid has no counterpart on 132 SMs.
//
// Layout: x [N, D, Ci, H, W] and g [N, D, Co, H, W] are views given by
// element strides for N, C, D and H; W must be the contiguous axis.
//
// Bound on an H100 SXM: 2 * 125 * Ci * Co FLOP per voxel against
// (Ci + Co) activations read per voxel, so every form but the stem is
// operation-bound (989 TF/s bf16 on the tensor cores, 67 TF/s f32 on the
// CUDA cores); the stem (Ci = 1) is bytes-bound on the tensor cores' scale
// and FMA-bound where it runs, on the CUDA cores.
//
// Two kernels behind one entry each, with one scheme for the reduction:
// the contraction runs over voxels, so the voxel axis is split across
// blocks (grid.x) and each block keeps its part of dW in registers for its
// whole voxel range; a block writes one partial dW (one per in-block voxel
// group), and wgrad_reduce_kernel sums the partials in a fixed order (no
// atomics: dW is the same from run to run). Deep levels (few voxels, dW up
// to 125 x 256 x 256) get few splits and many (ci tile, co tile, kd) blocks
// (grid.y), shallow levels the opposite.
//   * wgrad_mma_kernel: bf16, every form but the stem, on the tensor cores
//     (mma.sync m16n8k16); see its own note below. On the main path the
//     square and wide convs (<4>) and the narrow head (<1>) run the
//     tensor-copy kernels of csrc/conv5_wgrad_tma.cu instead; this one
//     keeps the views a tensor copy cannot describe.
//   * wgrad_kernel: f32 (exact f32 products and sums) and the Ci = 1 stem,
//     on the CUDA cores. grid.y picks a (ci tile, co tile) of dW and, when
//     kdn == 1, the depth tap kd; with kdn == 5 (the stem, where g is the
//     wider operand) the block covers all five depth taps from five staged
//     x slices, so g is staged once, not five times. A thread owns one
//     in-plane tap row kh, CI_T input channels and 4 output channels: 5
//     (kw) x CI_T x 4 accumulators. It walks the rows of the voxel tile
//     that belong to its voxel group, sliding a window of x along w, so
//     each voxel costs one vector load of x and one of g from shared memory
//     for 20 * CI_T FMAs. x (with a 2-voxel halo) and g (without) are
//     staged in shared memory as f32, channels innermost, so a thread's
//     channels are one 16-byte load and every tap reads the same tile at a
//     shifted offset.
// Staging is synchronous in both (no cp.async / TMA) and the tensor-core
// kernel uses mma.sync, not wgmma: the next steps toward the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KS = 5;         // kernel edge
constexpr int HALO = KS / 2;  // SAME padding on each side
constexpr int CO_T = 4;       // output channels per thread
constexpr int WCH = 4;        // voxels along w per inner step
constexpr int MAX_THREADS = 384;  // leaves each thread up to 168 registers

struct WGeom {
  int n, d, ci, h, w, co;
  int th, tw;    // voxel tile of one staging step: th rows x tw columns
  int cig, cog;  // thread groups over ci (CI_T each) and co (CO_T each)
  int kdn;       // depth taps per block: 5, or 1 with kd taken from grid.y
  int vs;        // in-block voxel groups (rows r with r % vs == group)
  int cis, cos;  // shared-memory channel strides (floats) of x and g
  long long tiles_per_split;
  long long xs_n, xs_c, xs_d, xs_h;  // element strides of x (w stride 1)
  long long gs_n, gs_c, gs_d, gs_h;  // element strides of g (w stride 1)
};

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <int N>
struct Vec;
template <>
struct Vec<1> {
  float v[1];
  __device__ __forceinline__ void load(const float* p) { v[0] = *p; }
  __device__ __forceinline__ void store(float* p) const { *p = v[0]; }
};
template <>
struct Vec<4> {
  float v[4];
  __device__ __forceinline__ void load(const float* p) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  __device__ __forceinline__ void store(float* p) const {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <typename T, int CI_T>
__global__ void __launch_bounds__(MAX_THREADS)
wgrad_kernel(const T* __restrict__ x, const T* __restrict__ g,
             float* __restrict__ part, WGeom q) {
  extern __shared__ float4 smem4[];
  float* sx = reinterpret_cast<float*>(smem4);  // [kdn][sh][sw][cis]
  const int sh = q.th + 2 * HALO;
  const int sw = q.tw + 2 * HALO;
  const int cib = CI_T * q.cig;
  const int cob = CO_T * q.cog;
  const int xplane = sh * sw;
  const int xslice = xplane * q.cis;
  float* sg = sx + ((q.kdn * xslice + 3) & ~3);  // [th][tw][cos]

  // the block's tile of dW
  const int ci_tiles = (q.ci + cib - 1) / cib;
  const int co_tiles = (q.co + cob - 1) / cob;
  int by = blockIdx.y;
  const int o0 = (by % co_tiles) * cob;
  by /= co_tiles;
  const int c0 = (by % ci_tiles) * cib;
  const int kd0 = by / ci_tiles;  // 0 when kdn == 5

  // the thread's taps, channels and voxel group
  int t = threadIdx.x;
  const int cog = t % q.cog;
  t /= q.cog;
  const int cig = t % q.cig;
  t /= q.cig;
  const int kh = t % KS;
  t /= KS;
  const int kdi = t % q.kdn;
  const int vg = t / q.kdn;

  float acc[KS][CI_T][CO_T];
#pragma unroll
  for (int k = 0; k < KS; ++k)
#pragma unroll
    for (int a = 0; a < CI_T; ++a)
#pragma unroll
      for (int b = 0; b < CO_T; ++b) acc[k][a][b] = 0.f;

  const int tiles_w = (q.w + q.tw - 1) / q.tw;
  const int tiles_h = (q.h + q.th - 1) / q.th;
  const long long tiles = (long long)q.n * q.d * tiles_h * tiles_w;
  const long long first = (long long)blockIdx.x * q.tiles_per_split;
  const long long last = min(tiles, first + q.tiles_per_split);
  const int nthreads = blockDim.x;

  for (long long tile = first; tile < last; ++tile) {
    long long r = tile;
    const int w0 = (int)(r % tiles_w) * q.tw;
    r /= tiles_w;
    const int h0 = (int)(r % tiles_h) * q.th;
    r /= tiles_h;
    const int od = (int)(r % q.d);
    const int nb = (int)(r / q.d);
    if (q.kdn == 1 && (od + kd0 - HALO < 0 || od + kd0 - HALO >= q.d))
      continue;  // this depth tap reads only padding; uniform in the block
    __syncthreads();  // the previous tile is done reading shared memory
    // x: one (voxel, CI_T channels) unit per thread and step, lanes along w
    const T* xn = x + nb * q.xs_n;
    for (int s = 0; s < q.kdn; ++s) {
      const int id = od + kd0 + s - HALO;
      const bool dok = id >= 0 && id < q.d;
      for (int i = threadIdx.x; i < xplane * q.cig; i += nthreads) {
        const int v = i % xplane;
        const int cg = i / xplane;
        const int ih = h0 + v / sw - HALO;
        const int iw = w0 + v % sw - HALO;
        const bool inside = dok && ih >= 0 && ih < q.h && iw >= 0 && iw < q.w;
        const T* src = xn + id * q.xs_d + ih * q.xs_h + iw;
        Vec<CI_T> val;
#pragma unroll
        for (int a = 0; a < CI_T; ++a) {
          const int c = c0 + cg * CI_T + a;
          val.v[a] = inside && c < q.ci ? load_f(src + c * q.xs_c) : 0.f;
        }
        val.store(sx + s * xslice + v * q.cis + cg * CI_T);
      }
    }
    // g: one (voxel, 4 channels) unit per thread and step
    const T* gn = g + nb * q.gs_n + od * q.gs_d;
    for (int i = threadIdx.x; i < q.th * q.tw * q.cog; i += nthreads) {
      const int v = i % (q.th * q.tw);
      const int og = i / (q.th * q.tw);
      const int oh = h0 + v / q.tw;
      const int ow = w0 + v % q.tw;
      const bool inside = oh < q.h && ow < q.w;
      const T* src = gn + oh * q.gs_h + ow;
      Vec<CO_T> val;
#pragma unroll
      for (int b = 0; b < CO_T; ++b) {
        const int c = o0 + og * CO_T + b;
        val.v[b] = inside && c < q.co ? load_f(src + c * q.gs_c) : 0.f;
      }
      val.store(sg + v * q.cos + og * CO_T);
    }
    __syncthreads();

    const float* xb = sx + kdi * xslice + kh * sw * q.cis + cig * CI_T;
    const float* gb = sg + cog * CO_T;
    for (int row = vg; row < q.th; row += q.vs) {
      const float* xr = xb + row * sw * q.cis;
      const float* gr = gb + row * q.tw * q.cos;
      Vec<CI_T> xv[2 * WCH];
#pragma unroll
      for (int j = 0; j < WCH; ++j) xv[j].load(xr + j * q.cis);
      for (int cc = 0; cc < q.tw; cc += WCH) {
        Vec<CO_T> gv[WCH];
#pragma unroll
        for (int j = 0; j < WCH; ++j) {
          xv[WCH + j].load(xr + (cc + WCH + j) * q.cis);
          gv[j].load(gr + (cc + j) * q.cos);
        }
#pragma unroll
        for (int j = 0; j < WCH; ++j)
#pragma unroll
          for (int k = 0; k < KS; ++k)
#pragma unroll
            for (int a = 0; a < CI_T; ++a)
#pragma unroll
              for (int b = 0; b < CO_T; ++b)
                acc[k][a][b] = fmaf(xv[j + k].v[a], gv[j].v[b], acc[k][a][b]);
#pragma unroll
        for (int j = 0; j < WCH; ++j) xv[j] = xv[WCH + j];
      }
    }
  }

  // partial dW of (split, voxel group): [5, 5, 5, Ci, Co]
  const size_t size = (size_t)KS * KS * KS * q.ci * q.co;
  float* out = part + ((size_t)blockIdx.x * q.vs + vg) * size;
  const int kd = kd0 + kdi;
#pragma unroll
  for (int k = 0; k < KS; ++k)
#pragma unroll
    for (int a = 0; a < CI_T; ++a) {
      const int ci = c0 + cig * CI_T + a;
      if (ci >= q.ci) continue;
#pragma unroll
      for (int b = 0; b < CO_T; ++b) {
        const int co = o0 + cog * CO_T + b;
        if (co < q.co)
          out[(((size_t)(kd * KS + kh) * KS + k) * q.ci + ci) * q.co + co] =
              acc[k][a][b];
      }
    }
}

// out[i] = sum over the partials of part[p][i], in the order p = 0, 1, ...
__global__ void wgrad_reduce_kernel(const float* __restrict__ part,
                                    float* __restrict__ out, int parts,
                                    long long size) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size) return;
  float s = 0.f;
  for (int p = 0; p < parts; ++p) s += part[(size_t)p * size + i];
  out[i] = s;
}

template <typename T, int CI_T>
cudaError_t launch(const void* x, const void* g, float* part, float* out,
                   int splits, const WGeom& q, cudaStream_t s) {
  const int cib = CI_T * q.cig, cob = CO_T * q.cog;
  const int chan_blocks = ((q.ci + cib - 1) / cib) * ((q.co + cob - 1) / cob) *
                          (q.kdn == 1 ? KS : 1);
  const int threads = q.vs * q.kdn * KS * q.cig * q.cog;
  const size_t xfloats =
      (size_t)q.kdn * (q.th + 2 * HALO) * (q.tw + 2 * HALO) * q.cis;
  const size_t smem =
      sizeof(float) * (((xfloats + 3) & ~(size_t)3) + (size_t)q.th * q.tw * q.cos);
  if (threads > MAX_THREADS || chan_blocks > 65535 || smem > 227 * 1024)
    return cudaErrorInvalidValue;
  auto kern = wgrad_kernel<T, CI_T>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int parts = splits * q.vs;
  float* dst = parts == 1 ? out : part;
  kern<<<dim3(splits, chan_blocks), threads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), dst, q);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || parts == 1) return e;
  const long long size = (long long)KS * KS * KS * q.ci * q.co;
  wgrad_reduce_kernel<<<(unsigned)((size + 255) / 256), 256, 0, s>>>(
      part, out, parts, size);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bf16 on the tensor cores: for every tap the same GEMM, dW_tap[ci, co] =
// sum over voxels of X_tap[ci, v] * G[co, v], as mma.sync m16n8k16 (bf16 in,
// f32 accumulate) with M = input channels, N = output channels and K =
// voxels. Both operands keep the voxel axis contiguous in memory, which is
// what the row-major A and the column-major B fragments want, so nothing is
// transposed. A fragment register holds two K-neighbours; they are the same
// (h, w) voxel of two adjacent depth slices, packed into one 32-bit word when
// the tile is staged, so a tap's shift along w never splits a register and
// every fragment register is one aligned 32-bit shared-memory load: the K
// step of one mma is 8 voxels along w times 2 depths.
// A block owns 32 input channels x 8 * NF output channels of the 25 in-plane
// taps of one depth tap (grid.y) and a range of voxel tiles (grid.x); its 10
// warps are (kh, 16-channel half), each with 5 (kw) x NF accumulator tiles.
// Per K step a warp loads 18 words of x (9 columns cover all five kw shifts)
// and 2 * NF of g for 5 * NF mma. Channel strides in shared memory are 4 mod
// 8 words, so the 8 channel rows x 4 columns of a fragment load hit 32
// different banks.
// ---------------------------------------------------------------------------
constexpr int MMA_WARPS = 2 * KS;       // (kh, 16-channel half of the ci tile)
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr int MMA_CIB = 32;             // input channels per block

struct MGeom {
  int n, d, ci, h, w, co;
  int th;        // rows of a voxel tile (its width is the template's TW)
  int xcs, gcs;  // shared-memory channel strides of x and g in words
  long long tiles_per_split;
  long long xs_n, xs_c, xs_d, xs_h;
  long long gs_n, gs_c, gs_d, gs_h;
};

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(const __nv_bfloat16* p, bool ok0,
                                          long long off1, bool ok1) {
  const uint32_t lo = ok0 ? __bfloat16_as_ushort(p[0]) : 0;
  const uint32_t hi = ok1 ? __bfloat16_as_ushort(p[off1]) : 0;
  return lo | (hi << 16);
}

template <int NF, int TW>
__global__ void __launch_bounds__(MMA_THREADS)
wgrad_mma_kernel(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ g, float* __restrict__ part,
                 MGeom q) {
  constexpr int SW = TW + 2 * HALO;
  constexpr int COB = 8 * NF;
  extern __shared__ uint32_t smw[];
  uint32_t* sx = smw;                     // [MMA_CIB][xcs]: (sh, SW) planes
  uint32_t* sg = smw + MMA_CIB * q.xcs;   // [COB][gcs]: (th, TW) planes
  const int sh = q.th + 2 * HALO;
  const int xplane = sh * SW;
  const int gplane = q.th * TW;

  const int ci_tiles = (q.ci + MMA_CIB - 1) / MMA_CIB;
  const int co_tiles = (q.co + COB - 1) / COB;
  int by = blockIdx.y;
  const int o0 = (by % co_tiles) * COB;
  by /= co_tiles;
  const int c0 = (by % ci_tiles) * MMA_CIB;
  const int kd = by / ci_tiles;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int kh = warp % KS;
  const int mf = warp / KS;
  const int r = lane >> 2;
  const int p = lane & 3;

  float acc[KS][NF][4];
#pragma unroll
  for (int k = 0; k < KS; ++k)
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[k][f][e] = 0.f;

  const int tiles_w = (q.w + TW - 1) / TW;
  const int tiles_h = (q.h + q.th - 1) / q.th;
  const int dpairs = (q.d + 1) / 2;
  const long long tiles = (long long)q.n * dpairs * tiles_h * tiles_w;
  const long long first = (long long)blockIdx.x * q.tiles_per_split;
  const long long last = min(tiles, first + q.tiles_per_split);

  for (long long tile = first; tile < last; ++tile) {
    long long rest = tile;
    const int w0 = (int)(rest % tiles_w) * TW;
    rest /= tiles_w;
    const int h0 = (int)(rest % tiles_h) * q.th;
    rest /= tiles_h;
    const int od = 2 * (int)(rest % dpairs);
    const int nb = (int)(rest / dpairs);
    const int id0 = od + kd - HALO;  // x depths of this tap: id0, id0 + 1
    const bool x0 = id0 >= 0 && id0 < q.d;
    const bool x1 = id0 + 1 >= 0 && id0 + 1 < q.d;
    if (!x0 && !x1) continue;  // only padding; uniform in the block
    __syncthreads();           // the previous tile is done reading
    const __nv_bfloat16* xn = x + nb * q.xs_n + id0 * q.xs_d;
    for (int c = warp; c < MMA_CIB; c += MMA_WARPS) {
      const bool cok = c0 + c < q.ci;
      const __nv_bfloat16* xc = xn + (c0 + c) * q.xs_c;
      uint32_t* dst = sx + c * q.xcs;
      for (int v = lane; v < xplane; v += 32) {
        const int ih = h0 + v / SW - HALO;
        const int iw = w0 + v % SW - HALO;
        const bool in = cok && ih >= 0 && ih < q.h && iw >= 0 && iw < q.w;
        dst[v] = pack2(xc + ih * q.xs_h + iw, in && x0, q.xs_d, in && x1);
      }
    }
    const bool g1 = od + 1 < q.d;
    const __nv_bfloat16* gn = g + nb * q.gs_n + od * q.gs_d;
    for (int c = warp; c < COB; c += MMA_WARPS) {
      const bool cok = o0 + c < q.co;
      const __nv_bfloat16* gc = gn + (o0 + c) * q.gs_c;
      uint32_t* dst = sg + c * q.gcs;
      for (int v = lane; v < gplane; v += 32) {
        const int oh = h0 + v / TW;
        const int ow = w0 + v % TW;
        const bool in = cok && oh < q.h && ow < q.w;
        dst[v] = pack2(gc + oh * q.gs_h + ow, in, q.gs_d, in && g1);
      }
    }
    __syncthreads();

    const uint32_t* xa = sx + (mf * 16 + r) * q.xcs + kh * SW + p;
    const uint32_t* gb = sg + r * q.gcs + p;
    for (int row = 0; row < q.th; ++row) {
#pragma unroll
      for (int ws = 0; ws < TW; ws += 8) {
        const uint32_t* xr = xa + row * SW + ws;
        uint32_t xlo[KS + 4], xhi[KS + 4];
#pragma unroll
        for (int j = 0; j < KS + 4; ++j) {
          xlo[j] = xr[j];
          xhi[j] = xr[8 * q.xcs + j];
        }
        uint32_t b[NF][2];
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          b[f][0] = gb[f * 8 * q.gcs + row * TW + ws];
          b[f][1] = gb[f * 8 * q.gcs + row * TW + ws + 4];
        }
#pragma unroll
        for (int k = 0; k < KS; ++k)
#pragma unroll
          for (int f = 0; f < NF; ++f)
            mma_bf16(acc[k][f], xlo[k], xhi[k], xlo[k + 4], xhi[k + 4], b[f][0],
                     b[f][1]);
      }
    }
  }

  // accumulator fragment: rows lane / 4 and + 8 (ci), columns 2 * (lane % 4)
  // + {0, 1} (co)
  const size_t size = (size_t)KS * KS * KS * q.ci * q.co;
  float* out = part + (size_t)blockIdx.x * size;
#pragma unroll
  for (int k = 0; k < KS; ++k)
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ci = c0 + mf * 16 + r + (e >> 1) * 8;
        const int co = o0 + f * 8 + 2 * p + (e & 1);
        if (ci < q.ci && co < q.co)
          out[(((size_t)(kd * KS + kh) * KS + k) * q.ci + ci) * q.co + co] =
              acc[k][f][e];
      }
}

template <int NF, int TW>
cudaError_t launch_mma(const void* x, const void* g, float* part, float* out,
                       int splits, const MGeom& q, cudaStream_t s) {
  const int chan_blocks = ((q.ci + MMA_CIB - 1) / MMA_CIB) *
                          ((q.co + 8 * NF - 1) / (8 * NF)) * KS;
  const size_t smem =
      sizeof(uint32_t) * ((size_t)MMA_CIB * q.xcs + (size_t)8 * NF * q.gcs);
  if (q.xcs < (q.th + 2 * HALO) * (TW + 2 * HALO) || q.gcs < q.th * TW ||
      chan_blocks > 65535 || smem > 227 * 1024)
    return cudaErrorInvalidValue;
  auto kern = wgrad_mma_kernel<NF, TW>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  float* dst = splits == 1 ? out : part;
  kern<<<dim3(splits, chan_blocks), MMA_THREADS, smem, s>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(g), dst, q);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const long long size = (long long)KS * KS * KS * q.ci * q.co;
  wgrad_reduce_kernel<<<(unsigned)((size + 255) / 256), 256, 0, s>>>(
      part, out, splits, size);
  return cudaGetLastError();
}

template <int NF>
cudaError_t dispatch_mma(int tw, const void* x, const void* g, float* part,
                         float* out, int splits, const MGeom& q,
                         cudaStream_t s) {
  switch (tw) {
    case 8: return launch_mma<NF, 8>(x, g, part, out, splits, q, s);
    case 16: return launch_mma<NF, 16>(x, g, part, out, splits, q, s);
    case 32: return launch_mma<NF, 32>(x, g, part, out, splits, q, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches the CUDA-core weight gradient on `stream`: f32 in either form,
// bf16 (bf16 != 0) only with ci_t == 1, the stem. ci_t (1 or 4) input channels per thread; cig, cog thread
// groups over ci and co; kdn (1 or 5) depth taps per block; vs in-block
// voxel groups; th x tw the voxel tile (tw a multiple of 4); the voxel
// tiles are dealt to `splits` blocks. `part` is f32 scratch of
// splits * vs * 125 * ci * co elements (unused when splits * vs == 1),
// `out` the f32 [5, 5, 5, ci, co] result. cis / cos are the shared-memory
// channel strides in floats (multiples of 4 where the vector is 4 wide,
// at least ci_t * cig and 4 * cog). Returns cudaGetLastError() after the
// launches (0 on success).
extern "C" int conv5_wgrad_launch(
    const void* x, const void* g, void* part, void* out, int bf16, int ci_t,
    int cig, int cog, int kdn, int vs, int th, int tw, int cis, int cos,
    int splits, int n, int d, int ci, int h, int w, int co, long long xs_n,
    long long xs_c, long long xs_d, long long xs_h, long long gs_n,
    long long gs_c, long long gs_d, long long gs_h, void* stream) {
  if ((ci_t != 1 && ci_t != 4) || (kdn != 1 && kdn != KS) || cig < 1 ||
      cog < 1 || vs < 1 || th < 1 || tw < WCH || tw % WCH || splits < 1 ||
      cis < ci_t * cig || cos < CO_T * cog || cos % 4 ||
      (ci_t == 4 && cis % 4))
    return cudaErrorInvalidValue;
  const long long tiles = (long long)n * d * ((h + th - 1) / th) *
                          ((w + tw - 1) / tw);
  const long long per = (tiles + splits - 1) / splits;
  const WGeom q{n, d, ci, h, w, co, th, tw, cig, cog, kdn, vs, cis, cos, per,
                xs_n, xs_c, xs_d, xs_h, gs_n, gs_c, gs_d, gs_h};
  float* pf = static_cast<float*>(part);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {  // bf16 with ci_t == 4 is conv5_wgrad_mma_launch's
    return ci_t == 1 ? launch<__nv_bfloat16, 1>(x, g, pf, of, splits, q, s)
                     : cudaErrorInvalidValue;
  }
  return ci_t == 1 ? launch<float, 1>(x, g, pf, of, splits, q, s)
                   : launch<float, 4>(x, g, pf, of, splits, q, s);
}

// Launches the bf16 weight gradient on the tensor cores on `stream`: nf
// (1, 2 or 4) n8 fragments per warp (8 * nf output channels per block), a
// th x tw voxel tile (tw 8, 16 or 32) of two depth slices at a time, the
// (n, depth pair, tile) list dealt to `splits` blocks. xcs / gcs are the
// shared-memory channel strides in 32-bit words, at least (th + 4) * (tw + 4)
// and th * tw. `part` is f32 scratch of splits * 125 * ci * co elements
// (unused when splits == 1), `out` the f32 [5, 5, 5, ci, co] result.
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int conv5_wgrad_mma_launch(
    const void* x, const void* g, void* part, void* out, int nf, int th,
    int tw, int xcs, int gcs, int splits, int n, int d, int ci, int h, int w,
    int co, long long xs_n, long long xs_c, long long xs_d, long long xs_h,
    long long gs_n, long long gs_c, long long gs_d, long long gs_h,
    void* stream) {
  if (th < 1 || splits < 1) return cudaErrorInvalidValue;
  const long long tiles = (long long)n * ((d + 1) / 2) * ((h + th - 1) / th) *
                          ((w + tw - 1) / tw);
  const long long per = (tiles + splits - 1) / splits;
  const MGeom q{n, d, ci, h, w, co, th, xcs, gcs, per,
                xs_n, xs_c, xs_d, xs_h, gs_n, gs_c, gs_d, gs_h};
  float* pf = static_cast<float*>(part);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nf) {
    case 1: return dispatch_mma<1>(tw, x, g, pf, of, splits, q, s);
    case 2: return dispatch_mma<2>(tw, x, g, pf, of, splits, q, s);
    case 4: return dispatch_mma<4>(tw, x, g, pf, of, splits, q, s);
    default: return cudaErrorInvalidValue;
  }
}
