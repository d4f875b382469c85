// Weight gradient of the 5^3 SAME convolution (stride 1) in float32 on
// Hopper's tensor cores, at f32 accuracy ("split TF32"):
//
//   dW[kd, kh, kw, ci, co] =
//       sum over (n, d, h, w) of x[n, d+kd-2, ci, h+kh-2, w+kw-2] * g[n, d, co, h, w]
//
// with x zero outside the volume, written in f32 as [5, 5, 5, Ci, Co].
//
// Replaces, for float32 activations, the weight-gradient kernels of
// medicalseg_tpu/ops/pallas_conv5.py: _wgrad_mid_kernel_ck /
// _wgrad_mid_kernel (pallas_call :832; square stacks) and _wgrad_kernel_ck
// / _wgrad_kernel (pallas_calls :912 / :977) in their narrow-head form, and
// the wide 128 / 256 stacks the JAX package leaves to XLA's VJP. The f32
// stem (Ci = 1) stays on the CUDA cores (wgrad_kernel,
// csrc/conv5_wgrad.cu).
//
// Numerics as in csrc/conv5_tf32.cu: both operands are activations, so
// each is split into hi = rna_tf32(a) and lo = rna_tf32(a - hi), and each
// product is hi*hi + hi*lo + lo*hi (three mma.sync.m16n8k8 TF32 products):
// about 2^-22 of the product is lost, f32 accuracy. The tensor cores'
// accumulation truncates, so each K step's three products sum from zero
// and are then added, rounded, to the running sums in registers.
//
// For every tap the same GEMM, dW_tap[ci, co] = sum over voxels of
// X_tap[ci, v] * G[co, v]: M = input channels, N = output channels, K =
// voxels. Both operands keep the voxel axis contiguous (W innermost), which
// is what the row-major A and column-major B fragments of mma.sync want, so
// nothing is transposed. A block owns 16 input channels (one m16 tile) x 8
// * NF output channels (NF = 1, 2 or 4: Co 3 pads to 8, 5 of 8 columns
// padding; Co 20 to 32, 12 of 32) of the 25 in-plane
// taps of one depth tap and a contiguous range of (n, d, h, w) voxel tiles
// of th rows x tw columns; its warps are (kh, half of the n8 tiles), each
// holding 5 (kw) x NF / 2 accumulator tiles, and two blocks share an SM.
// A tile's x box (its 2-voxel halo, from 4 columns left) and g box come
// raw by cp.async (16 bytes a copy where the views allow it, else 4; zero
// fill for the SAME padding and the ragged H and W edges) while the last
// tile computes; then one flat pass splits the tile into hi and lo halves
// in the same layout. Per K step (8 voxels along w) a warp loads each
// tap's A fragment as 4 + 4 scalars straight into the mma's operand
// registers (a kw shift is 4 bytes, which no ldmatrix row can take) and
// its B fragments once for the 5 taps. Channel planes are padded to 4 mod
// 8 floats: the 8 channels x 4 voxels of a fragment load hit 32 banks.
// Tiles whose depth tap reads only padding are skipped.
//
// The voxel reduction is deterministic: each block (split) writes one
// partial dW of its channels, and wgrad_tf32_reduce_kernel adds the
// partials in split order, as wgrad_tma_kernel does; a repeat is bit for
// bit.
//
// Bound on an H100 SXM: 2 * 125 * Ci * Co FLOP a voxel in three TF32
// passes at 495 TF/s against (Ci + Co) * 4 bytes a voxel: bound by
// operations (the 15 head convs of a 2 x 128^3 backward: 2.92 TFLOP,
// 17.7 ms).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KS = 5;
constexpr int CIB = 16;              // input channels a block (an m16 tile)

// warps a block: (kh, half of the n8 tiles) where a block has two or more
template <int NF>
struct Warps {
  static constexpr int halves = NF > 1 ? 2 : 1;
  static constexpr int count = KS * halves;
  static constexpr int threads = 32 * count;
  static constexpr int nf = NF / halves;  // n8 tiles a warp
};

struct WGeom {
  int n, d, ci, h, w, co;
  int th, tw;               // voxel tile: th rows x tw columns (tw 8/16/32)
  int xplane, gplane;       // split planes of x and g (floats, 4 mod 8)
  int vec;                  // 16-byte copies (bases and strides on 16 bytes)
  long long tiles_per_split;
  long long xs_n, xs_c, xs_d, xs_h;
  long long gs_n, gs_c, gs_d, gs_h;
};

__device__ __forceinline__ uint32_t rna_tf32(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float a, float& hi, float& lo) {
  hi = __uint_as_float(rna_tf32(a));
  lo = __uint_as_float(rna_tf32(a - hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// copy qi of a row from global column c0 (raw layout, zeros out of [0, w)
// and where !ok): 16 bytes at column c0 + 4 qi where vec (c0 and the row
// start on 16 bytes), else 4 bytes at column c0 + qi
__device__ __forceinline__ void copy_one(float* dst, const float* src,
                                         const float* dummy, bool ok, int c0,
                                         int qi, int w, int vec) {
  if (vec) {
    const int c = c0 + 4 * qi;
    const int bytes = ok && c >= 0 && c < w ? 4 * min(4, w - c) : 0;
    cp16(dst + 4 * qi, bytes ? src + c : dummy, bytes);
  } else {
    const int c = c0 + qi;
    const bool in = ok && c >= 0 && c < w;
    cp4(dst + qi, in ? src + c : dummy, in);
  }
}

template <int NF>
__global__ void __launch_bounds__(Warps<NF>::threads, 2)
wgrad_tf32_kernel(const float* __restrict__ x, const float* __restrict__ g,
                  float* __restrict__ part, WGeom q) {
  constexpr int COB = 8 * NF;
  constexpr int THREADS = Warps<NF>::threads;
  constexpr int NFW = Warps<NF>::nf;
  extern __shared__ float4 smem4[];
  const int xpitch = q.tw + 8;  // the x box: from 4 columns left of the tile
  const int xrows = q.th + 4;
  // the raw tile, then its hi and lo halves in the same layout: x
  // [CIB][xplane] ((th + 4) rows of xpitch), then g [COB][gplane] (th rows
  // of tw)
  const int tile_floats = CIB * q.xplane + COB * q.gplane;  // a multiple of 4
  float* rx = reinterpret_cast<float*>(smem4);
  float* rg = rx + CIB * q.xplane;
  const float* xh = rx + tile_floats;
  const float* xl = xh + tile_floats;
  const float* gh = xh + CIB * q.xplane;
  const float* gl = xl + CIB * q.xplane;

  // the block's channels and depth tap
  const int ci_tiles = (q.ci + CIB - 1) / CIB;
  const int co_tiles = (q.co + COB - 1) / COB;
  int by = blockIdx.x;
  const int o0 = (by % co_tiles) * COB;
  by /= co_tiles;
  const int c0 = (by % ci_tiles) * CIB;
  const int kd = by / ci_tiles;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int kh = warp % KS;
  const int f0 = (warp / KS) * NFW;  // the warp's first n8 tile
  const int gq = lane >> 2;
  const int tq = lane & 3;

  float acc[KS][NFW][4];
#pragma unroll
  for (int k = 0; k < KS; ++k)
#pragma unroll
    for (int f = 0; f < NFW; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[k][f][e] = 0.f;

  const int tiles_w = (q.w + q.tw - 1) / q.tw;
  const int tiles_h = (q.h + q.th - 1) / q.th;
  const long long tiles = (long long)q.n * q.d * tiles_h * tiles_w;
  const long long first = (long long)blockIdx.y * q.tiles_per_split;
  const long long last = min(tiles, first + q.tiles_per_split);

  auto depth = [&](long long t) { return (int)((t / (tiles_w * tiles_h)) % q.d); };
  auto next_valid = [&](long long t) {  // a tile whose tap reads inside D
    while (t < last) {
      const int id = depth(t) + kd - 2;
      if (id >= 0 && id < q.d) break;
      ++t;
    }
    return t;
  };
  auto load = [&](long long t) {  // tile t's x and g boxes, raw f32
    const int w0 = (int)(t % tiles_w) * q.tw;
    const int h0 = (int)((t / tiles_w) % tiles_h) * q.th;
    const int od = depth(t);
    const int nb = (int)(t / ((long long)tiles_w * tiles_h * q.d));
    const float* xn = x + nb * q.xs_n + (od + kd - 2) * q.xs_d;
    const int xq = q.vec ? xpitch / 4 : xpitch;  // copies a row
    for (int i = threadIdx.x; i < CIB * xrows * xq; i += THREADS) {
      const int qi = i % xq;
      const int ri = i / xq;
      const int row = ri % xrows;
      const int ch = ri / xrows;
      const int ih = h0 + row - 2;
      const bool ok = c0 + ch < q.ci && ih >= 0 && ih < q.h;
      copy_one(rx + ch * q.xplane + row * xpitch,
               xn + (c0 + ch) * q.xs_c + ih * q.xs_h, x, ok, w0 - 4, qi, q.w,
               q.vec);
    }
    const float* gn = g + nb * q.gs_n + od * q.gs_d;
    const int gqn = q.vec ? q.tw / 4 : q.tw;
    for (int i = threadIdx.x; i < COB * q.th * gqn; i += THREADS) {
      const int qi = i % gqn;
      const int ri = i / gqn;
      const int row = ri % q.th;
      const int ch = ri / q.th;
      const int oh = h0 + row;
      const bool ok = o0 + ch < q.co && oh < q.h;
      copy_one(rg + ch * q.gplane + row * q.tw,
               gn + (o0 + ch) * q.gs_c + oh * q.gs_h, g, ok, w0, qi, q.w,
               q.vec);
    }
  };

  long long t = next_valid(first);
  if (t < last) load(t);
  cp_commit();
  while (t < last) {
    const long long tn = next_valid(t + 1);
    cp_wait_all();
    __syncthreads();  // tile t landed; the last tile's planes are free
    // split the tile into its (hi, lo) halves, 4 floats at a time
    {
      const float4* r4 = reinterpret_cast<const float4*>(rx);
      float4* h4 = reinterpret_cast<float4*>(rx + tile_floats);
      float4* l4 = h4 + tile_floats / 4;
      for (int i = threadIdx.x; i < tile_floats / 4; i += THREADS) {
        const float4 v = r4[i];
        float4 h, l;
        split_tf32(v.x, h.x, l.x);
        split_tf32(v.y, h.y, l.y);
        split_tf32(v.z, h.z, l.z);
        split_tf32(v.w, h.w, l.w);
        h4[i] = h;
        l4[i] = l;
      }
    }
    __syncthreads();  // the planes are ready; the raw tile is free
    if (tn < last) load(tn);
    cp_commit();
    // box column 0 (input w0 - 2) is column 2 of the x halves
    const int xa = gq * q.xplane + kh * xpitch + tq + 2;
    const int gb = (8 * f0 + gq) * q.gplane + tq;
#pragma unroll 1
    for (int row = 0; row < q.th; ++row) {
#pragma unroll 1
      for (int ws = 0; ws < q.tw; ws += 8) {
        const int xo = xa + row * xpitch + ws;
        const int go = gb + row * q.tw + ws;
        uint32_t bh[NFW][2], bl[NFW][2];
#pragma unroll
        for (int f = 0; f < NFW; ++f) {
          bh[f][0] = __float_as_uint(gh[go + f * 8 * q.gplane]);
          bh[f][1] = __float_as_uint(gh[go + f * 8 * q.gplane + 4]);
          bl[f][0] = __float_as_uint(gl[go + f * 8 * q.gplane]);
          bl[f][1] = __float_as_uint(gl[go + f * 8 * q.gplane + 4]);
        }
#pragma unroll
        for (int k = 0; k < KS; ++k) {
          // A of tap kw = k: rows gq, gq + 8 (ci), columns tq, tq + 4
          uint32_t ah[4], al[4];
          ah[0] = __float_as_uint(xh[xo + k]);
          ah[1] = __float_as_uint(xh[xo + 8 * q.xplane + k]);
          ah[2] = __float_as_uint(xh[xo + k + 4]);
          ah[3] = __float_as_uint(xh[xo + 8 * q.xplane + k + 4]);
          al[0] = __float_as_uint(xl[xo + k]);
          al[1] = __float_as_uint(xl[xo + 8 * q.xplane + k]);
          al[2] = __float_as_uint(xl[xo + k + 4]);
          al[3] = __float_as_uint(xl[xo + 8 * q.xplane + k + 4]);
#pragma unroll
          for (int f = 0; f < NFW; ++f) {
            // this step's three products, then one rounded add: the tensor
            // cores' accumulation truncates
            float sum[4] = {0.f, 0.f, 0.f, 0.f};
            mma_tf32(sum, al, bh[f][0], bh[f][1]);
            mma_tf32(sum, ah, bl[f][0], bl[f][1]);
            mma_tf32(sum, ah, bh[f][0], bh[f][1]);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[k][f][e] += sum[e];
          }
        }
      }
    }
    t = tn;
  }

  // accumulator fragment: rows gq and gq + 8 (ci), columns 2 tq and 2 tq +
  // 1 (co); this split's partial dW [5, 5, 5, Ci, Co]
  const size_t size = (size_t)KS * KS * KS * q.ci * q.co;
  float* out = part + (size_t)blockIdx.y * size;
#pragma unroll
  for (int k = 0; k < KS; ++k)
#pragma unroll
    for (int f = 0; f < NFW; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ci = c0 + gq + (e >> 1) * 8;
        const int co = o0 + (f0 + f) * 8 + 2 * tq + (e & 1);
        if (ci < q.ci && co < q.co)
          out[(((size_t)(kd * KS + kh) * KS + k) * q.ci + ci) * q.co + co] =
              acc[k][f][e];
      }
}

// out[i] = sum over the partials of part[p][i], in the order p = 0, 1, ...
__global__ void wgrad_tf32_reduce_kernel(const float* __restrict__ part,
                                         float* __restrict__ out, int parts,
                                         long long size) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size) return;
  float s = 0.f;
  for (int p = 0; p < parts; ++p) s += part[(size_t)p * size + i];
  out[i] = s;
}

template <int NF>
cudaError_t launch(const float* x, const float* g, float* part, float* out,
                   int splits, const WGeom& q, cudaStream_t s) {
  const int chan_blocks = KS * ((q.ci + CIB - 1) / CIB) *
                          ((q.co + 8 * NF - 1) / (8 * NF));
  // the raw tile and its hi and lo halves
  const size_t smem =
      3 * sizeof(float) * ((size_t)CIB * q.xplane + (size_t)8 * NF * q.gplane);
  if (smem > 227 * 1024 || splits > 65535) return cudaErrorInvalidValue;
  auto kern = wgrad_tf32_kernel<NF>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(chan_blocks, splits), Warps<NF>::threads, smem, s>>>(
      x, g, splits == 1 ? out : part, q);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const long long size = (long long)KS * KS * KS * q.ci * q.co;
  wgrad_tf32_reduce_kernel<<<(unsigned)((size + 255) / 256), 256, 0, s>>>(
      part, out, splits, size);
  return cudaGetLastError();
}

}  // namespace

// Launches the split-TF32 weight gradient on `stream`: x [N, D, Ci, H, W]
// and g [N, D, Co, H, W] f32 views (element strides for N, C, D and H; W
// contiguous; any alignment; vec != 0 where both bases and all strides lie
// on 16 bytes, for 16-byte copies). nf (1, 2 or 4) n8 tiles a block (8 nf
// output channels); th x tw the voxel tile (tw 8, 16 or 32); xplane >= (th
// + 4) * (tw + 8) and gplane >= th * tw the x and g channel planes in
// floats (4 mod 8); the (n, d, h, w) tiles dealt to `splits` blocks. `part` is f32
// scratch of splits * 125 * ci * co (unused when splits == 1), `out` the
// f32 [5, 5, 5, ci, co] result. Returns cudaGetLastError() after the
// launches (0 on success).
extern "C" int conv5_wgrad_tf32_launch(
    const void* x, const void* g, void* part, void* out, int nf, int th,
    int tw, int xplane, int gplane, int vec, int splits, int n, int d,
    int ci, int h, int w, int co, long long xs_n, long long xs_c,
    long long xs_d, long long xs_h, long long gs_n, long long gs_c,
    long long gs_d, long long gs_h, void* stream) {
  if (th < 1 || (tw != 8 && tw != 16 && tw != 32) ||
      xplane < (th + 4) * (tw + 8) || gplane < th * tw || xplane % 8 != 4 ||
      gplane % 8 != 4 || splits < 1 || (splits > 1 && !part))
    return cudaErrorInvalidValue;
  const long long tiles = (long long)n * d * ((h + th - 1) / th) *
                          ((w + tw - 1) / tw);
  const long long per = (tiles + splits - 1) / splits;
  const WGeom q{n, d, ci, h, w, co, th, tw, xplane, gplane, vec, per,
                xs_n, xs_c, xs_d, xs_h, gs_n, gs_c, gs_d, gs_h};
  const float* xf = static_cast<const float*>(x);
  const float* gf = static_cast<const float*>(g);
  float* pf = static_cast<float*>(part);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nf) {
    case 1: return launch<1>(xf, gf, pf, of, splits, q, s);
    case 2: return launch<2>(xf, gf, pf, of, splits, q, s);
    case 4: return launch<4>(xf, gf, pf, of, splits, q, s);
    default: return cudaErrorInvalidValue;
  }
}
