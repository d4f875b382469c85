// 5^3 SAME convolution (stride 1) in float32 on Hopper's tensor cores, at
// f32 accuracy ("split TF32"), with an optional fused BatchNorm + PReLU
// epilogue; the same kernel computes the input gradient.
//
// Replaces, for float32 activations, medicalseg_tpu/ops/pallas_conv5.py
// _conv5_kernel (:186) in its head form (_conv5_head_kl, :382; the
// pallas_call at :309): every NConv stack conv and the OutputTransition
// conv; with the epilogue conv5_kl_fused (:1288); and the input gradient of
// _conv5_kl_bwd (:1380-1384), the same conv of the cotangent with the
// spatially flipped, io-transposed weight (the wrapper packs that weight;
// no bias). The f32 stem (Ci = 1) stays on the CUDA cores (conv5_kernel,
// csrc/conv5.cu).
//
// Numerics. TF32 keeps 10 mantissa bits, too few for f32 results at a
// 1e-4 tolerance. Each f32 operand a is split into hi = rna_tf32(a) and
// lo = rna_tf32(a - hi) (round to nearest, ties away from zero, as
// cvt.rna.tf32.f32 rounds; a - hi is exact), and each product is
// hi*hi + hi*lo + lo*hi, three mma.sync.m16n8k8 TF32 products summed in
// f32. The dropped lo*lo term and lo's own rounding leave about 2^-22 of
// the product: f32 accuracy for three TF32 passes. The tensor cores' own
// f32 accumulation truncates rather than rounds: chained over a whole K
// (1,500 to 12,000 mma steps a sum) it missed the f32 tolerance on an
// H100 (1.75e-4 at 32 -> 32 channels, 64^3). So each stage's 75 mma steps
// sum into a fresh accumulator, which is then added, rounded, to the
// running sum in registers (as Ootomo and Yokota, 2022, do for split-TF32
// GEMM). The
// rounding is the integer form of cvt.rna ((bits + 0x1000) & ~0x1fff),
// which needs no conversion unit and which the wrapper's weight packing
// and the CPU tests reproduce bit for bit.
//
// Implicit GEMM: M = output voxels, N = output channels, K = (tap, input
// channel). A block owns a 256-voxel output tile (td depths x th rows x tw
// columns, tw 8, 16 or 32 by W) of one volume and 8 * NF output channels
// (NF = 1..4: Co 3 pads to 8, 62.5% of the columns padding; Co 20 to 24,
// 16.7%; Co >= 32 tiles of 32, none). Its 8 warps own 32 voxels each (two
// m16 tiles) against all 8 * NF channels; two blocks share an SM where
// their shared memory fits (every level but 8^3), so that one block's
// copies, split pass and barriers overlap the other's mma. K runs over
// stages of (depth tap kd, 8 input channels):
//   * the stage's input halo box ([td][8] planes of th + 4 rows from 4
//     columns left of the tile) comes raw by cp.async, 16 bytes a copy
//     where the view's base and strides allow it, else 4, with zero fill
//     for the SAME padding and the ragged edges (any W-contiguous view);
//     its 25 in-plane taps' weights, pre-split and packed per lane as (b0
//     hi, b1 hi, b0 lo, b1 lo) fragments (ops/conv5.py
//     _pack_weights_tf32), by 16-byte cp.async;
//   * one pass splits the box into hi and lo planes, a voxel's 8 channels
//     together (48 bytes a voxel: the 8 rows of an ldmatrix land on
//     distinct banks);
//   * every (kh, kw) tap then takes its A fragments with one ldmatrix.x4
//     a plane and m16 tile (a fragment's 8 x 4 tf32 blocks are 8 x 8 b16
//     matrices: rows are voxels, shifted by whole voxels for each tap) and
//     its B fragments with one 16-byte load each: per tap and warp 4
//     ldmatrix and NF loads feed 2 x NF x 3 mma, nothing between them.
// The raw box for the next stage is copied while this stage computes (its
// weights once the mma are done). A stage whose input depths all lie in
// the padding is skipped. Where the grid alone would leave SMs idle (the
// deep 8^3 levels), the stages are split over gridDim.z and
// conv5_tf32_reduce_kernel adds the partial sums in split order
// (deterministic) and applies bias and epilogue.
//
// Bound on an H100 SXM: 2 * 125 * Ci * Co FLOP a voxel, three TF32 passes
// at 495 TF/s, against (Ci + Co) * 4 bytes a voxel at 3.35 TB/s: every head
// conv is bound by operations (the 15 head convs of a 2 x 128^3 forward:
// 2.92 TFLOP, 17.7 ms). mma.sync reaches only part of the tensor cores'
// wgmma rate; wgmma takes TF32 only K-major from shared memory, which
// would need the box transposed for every tap.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KS = 5;           // kernel edge
constexpr int TAPS2 = KS * KS;  // (kh, kw) taps of one depth tap
constexpr int THREADS = 256;    // 8 warps x 32 output voxels
constexpr int VOX = 256;        // output voxels of a block tile
constexpr int CK = 8;           // input channels a stage: one k8 step a tap
constexpr int VB = 48;          // bytes a voxel in the split planes (8 ch + pad)

struct Geom {
  int n, d, ci, h, w, co;
  int td, th, tw;     // the block's output tile: td x th x tw = VOX voxels
  int pitch, plane;   // the raw box: row pitch and channel plane (floats)
  int splits;         // blocks along the stages (gridDim.z)
  int vec;            // 16-byte copies (base and strides on 16 bytes)
  long long xs_n, xs_c, xs_d, xs_h;  // element strides of x (w stride 1)
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

// four 8 x 4 tf32 matrices, one row address a lane: an m16k8 A fragment
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 4 bytes global -> shared; zeros where !ok (the source is then not read)
__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

// 16 bytes global -> shared, the first `bytes` of them read, the rest zero
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

template <int NF>
__global__ void __launch_bounds__(THREADS, 2)
conv5_tf32_kernel(const float* __restrict__ x, const float4* __restrict__ wpk,
                  const float* __restrict__ bias, const float* __restrict__ ep,
                  float* __restrict__ y, float* __restrict__ part, Geom g) {
  constexpr int NT = 8 * NF;
  constexpr int WSTAGE = TAPS2 * NF * 32;  // float4 fragments of a stage
  extern __shared__ float4 smem4[];
  const int bw = g.tw + 4;                 // the box's columns
  const int bvox = g.td * (g.th + 4) * bw;  // the box's voxels
  float4* sw = smem4;                                  // the stage's weights
  float* rx = reinterpret_cast<float*>(sw + WSTAGE);   // the raw box
  char* hi = reinterpret_cast<char*>(rx + g.td * CK * g.plane);  // split
  char* lo = hi + bvox * VB;

  const int tiles_w = (g.w + g.tw - 1) / g.tw;
  const int tiles_h = (g.h + g.th - 1) / g.th;
  int tile = blockIdx.x;
  const int w0 = (tile % tiles_w) * g.tw;
  tile /= tiles_w;
  const int h0 = (tile % tiles_h) * g.th;
  const int od0 = (tile / tiles_h) * g.td;
  const int co_tiles = (g.co + NT - 1) / NT;
  const int nb = blockIdx.y / co_tiles;
  const int ct = blockIdx.y % co_tiles;
  const int chunks = (g.ci + CK - 1) / CK;
  const int stages = KS * chunks;
  const int s0 = (int)((long long)blockIdx.z * stages / g.splits);
  const int s1 = (int)((long long)(blockIdx.z + 1) * stages / g.splits);
  const int dlast = min(od0 + g.td, g.d) - 1;  // last output depth of the tile

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tq = lane & 3;

  // this lane's ldmatrix row: voxel 32 warp + 16 mf + (lane & 7) + 8 (bit 3
  // of the lane), channels 4 (bit 4 of the lane) .. + 3
  unsigned arow[2];
#pragma unroll
  for (int mf = 0; mf < 2; ++mf) {
    const int v = 32 * warp + 16 * mf + (lane & 7) + 8 * ((lane >> 3) & 1);
    const int c = v % g.tw;
    const int r = (v / g.tw) % g.th;
    const int sd = v / (g.tw * g.th);
    arow[mf] = smem_addr(hi) + ((sd * (g.th + 4) + r) * bw + c) * VB +
               16 * (lane >> 4);
  }
  const unsigned lo_off = bvox * VB;

  float acc[2][NF][4];
#pragma unroll
  for (int mf = 0; mf < 2; ++mf)
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mf][f][e] = 0.f;

  const float* xn = x + nb * g.xs_n;
  auto valid = [&](int s) {  // a stage reads some input depth inside D
    const int kd = s / chunks;
    return od0 + kd - 2 < g.d && dlast + kd - 2 >= 0;
  };
  auto next_valid = [&](int s) {
    while (s < s1 && !valid(s)) ++s;
    return s;
  };
  // the raw box of stage s: [td][8 ch] planes of (th + 4) rows from column
  // w0 - 4, pitch tw + 8
  auto load_x = [&](int s) {
    const int kd = s / chunks;
    const int c0 = (s % chunks) * CK;
    const int rows = g.td * CK * (g.th + 4);
    const int per_row = g.vec ? g.pitch / 4 : g.pitch;
    for (int i = threadIdx.x; i < rows * per_row; i += THREADS) {
      const int q = i % per_row;
      const int ri = i / per_row;
      const int row = ri % (g.th + 4);
      const int ch = (ri / (g.th + 4)) % CK;
      const int sd = ri / ((g.th + 4) * CK);
      const int id = od0 + sd + kd - 2;
      const int ih = h0 + row - 2;
      const bool rok = id >= 0 && id < g.d && ih >= 0 && ih < g.h &&
                       c0 + ch < g.ci;
      const float* src = xn + (c0 + ch) * g.xs_c + id * g.xs_d + ih * g.xs_h;
      float* dst = rx + (sd * CK + ch) * g.plane + row * g.pitch;
      if (g.vec) {
        const int iw = w0 - 4 + 4 * q;
        const int bytes = rok && iw >= 0 && iw < g.w ? 4 * min(4, g.w - iw)
                                                      : 0;
        cp16(dst + 4 * q, bytes ? src + iw : xn, bytes);
      } else {
        const int iw = w0 - 4 + q;
        const bool ok = rok && iw >= 0 && iw < g.w;
        cp4(dst + q, ok ? src + iw : xn, ok);
      }
    }
  };
  auto load_w = [&](int s) {
    const int kd = s / chunks;
    const float4* wsrc =
        wpk + ((size_t)(ct * KS + kd) * chunks + s % chunks) * WSTAGE;
    for (int i = threadIdx.x; i < WSTAGE; i += THREADS) cp16(sw + i, wsrc + i, 16);
  };

  int s = next_valid(s0);
  if (s < s1) {
    load_x(s);
    load_w(s);
  }
  cp_commit();
  while (s < s1) {
    const int sn = next_valid(s + 1);
    cp_wait_all();
    __syncthreads();  // stage s landed; the last stage's planes are free
    // split the box into (hi, lo) planes, a voxel's 8 channels together
    for (int i = threadIdx.x; i < 2 * bvox; i += THREADS) {
      const int half = i & 1;
      const int p = i >> 1;
      const int col = p % bw;
      const int rr = p / bw;
      const int row = rr % (g.th + 4);
      const int sd = rr / (g.th + 4);
      const float* src =
          rx + (sd * CK + 4 * half) * g.plane + row * g.pitch + col + 2;
      float4 h, l;
      split_tf32(src[0], h.x, l.x);
      split_tf32(src[g.plane], h.y, l.y);
      split_tf32(src[2 * g.plane], h.z, l.z);
      split_tf32(src[3 * g.plane], h.w, l.w);
      *reinterpret_cast<float4*>(hi + p * VB + 16 * half) = h;
      *reinterpret_cast<float4*>(lo + p * VB + 16 * half) = l;
    }
    __syncthreads();  // the planes are ready; the raw box is free
    if (sn < s1) load_x(sn);
    cp_commit();
    // the stage's sum on the tensor cores, whose accumulation truncates:
    // a chain of 75 mma, then one rounded f32 add into acc
    float sum[2][NF][4];
#pragma unroll
    for (int mf = 0; mf < 2; ++mf)
#pragma unroll
      for (int f = 0; f < NF; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[mf][f][e] = 0.f;
#pragma unroll 1
    for (int kh = 0; kh < KS; ++kh) {
      const unsigned row_off = kh * bw * VB;
#pragma unroll
      for (int kw = 0; kw < KS; ++kw) {
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int mf = 0; mf < 2; ++mf) {
          ldsm4(ah[mf], arow[mf] + row_off + kw * VB);
          ldsm4(al[mf], arow[mf] + row_off + kw * VB + lo_off);
        }
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          const float4 b = sw[((kh * KS + kw) * NF + f) * 32 + lane];
          const uint32_t bh0 = __float_as_uint(b.x), bh1 = __float_as_uint(b.y);
          const uint32_t bl0 = __float_as_uint(b.z), bl1 = __float_as_uint(b.w);
#pragma unroll
          for (int mf = 0; mf < 2; ++mf) {
            mma_tf32(sum[mf][f], al[mf], bh0, bh1);
            mma_tf32(sum[mf][f], ah[mf], bl0, bl1);
            mma_tf32(sum[mf][f], ah[mf], bh0, bh1);
          }
        }
      }
    }
#pragma unroll
    for (int mf = 0; mf < 2; ++mf)
#pragma unroll
      for (int f = 0; f < NF; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mf][f][e] += sum[mf][f][e];
    __syncthreads();  // the weights are free
    if (sn < s1) load_w(sn);
    cp_commit();
    s = sn;
  }

  // accumulator fragment: voxels (lane >> 2) and + 8 of each m16 tile,
  // channels 2 tq and 2 tq + 1 of each n8 tile; y (and the partials)
  // contiguous [N, D, Co, H, W]
  const int gq = lane >> 2;
  const long long hw = (long long)g.h * g.w;
  float* dst = g.splits == 1 ? y : part + (size_t)blockIdx.z * g.n * g.d * g.co * hw;
#pragma unroll
  for (int mf = 0; mf < 2; ++mf) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int v = 32 * warp + 16 * mf + gq + 8 * hh;
      const int ow = w0 + v % g.tw;
      const int oh = h0 + (v / g.tw) % g.th;
      const int od = od0 + v / (g.tw * g.th);
      if (ow >= g.w || oh >= g.h || od >= g.d) continue;
      float* yv = dst + ((long long)nb * g.d + od) * g.co * hw + oh * g.w + ow;
#pragma unroll
      for (int f = 0; f < NF; ++f) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int co = ct * NT + f * 8 + 2 * tq + j;
          if (co >= g.co) continue;
          float val = acc[mf][f][2 * hh + j];
          if (g.splits == 1) {
            if (bias != nullptr) val += bias[co];
            if (ep != nullptr) {
              val = val * ep[co] + ep[g.co + co];
              val = val >= 0.f ? val : val * ep[2 * g.co + co];
            }
          }
          yv[co * hw] = val;
        }
      }
    }
  }
}

// y[i] = epilogue(sum over the splits of part[z][i] in the order z = 0, 1,
// ..., + bias), y contiguous [N, D, Co, H, W]
__global__ void conv5_tf32_reduce_kernel(const float* __restrict__ part,
                                         const float* __restrict__ bias,
                                         const float* __restrict__ ep,
                                         float* __restrict__ y, int splits,
                                         long long size, int co, long long hw) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size) return;
  float v = 0.f;
  for (int z = 0; z < splits; ++z) v += part[(size_t)z * size + i];
  const int c = (int)((i / hw) % co);
  if (bias != nullptr) v += bias[c];
  if (ep != nullptr) {
    v = v * ep[c] + ep[co + c];
    v = v >= 0.f ? v : v * ep[2 * co + c];
  }
  y[i] = v;
}

template <int NF>
cudaError_t launch(const float* x, const float4* wpk, const float* bias,
                   const float* ep, float* y, float* part, const Geom& g,
                   cudaStream_t s) {
  const int tiles = ((g.d + g.td - 1) / g.td) * ((g.h + g.th - 1) / g.th) *
                    ((g.w + g.tw - 1) / g.tw);
  const int co_tiles = (g.co + 8 * NF - 1) / (8 * NF);
  const size_t bvox = (size_t)g.td * (g.th + 4) * (g.tw + 4);
  // the weights, the raw box and its two split planes
  const size_t smem = (size_t)TAPS2 * NF * 32 * sizeof(float4) +
                      (size_t)g.td * CK * g.plane * sizeof(float) +
                      2 * bvox * VB;
  if (smem > 227 * 1024 || (long long)g.n * co_tiles > 65535 ||
      g.splits > 65535)
    return cudaErrorInvalidValue;
  auto kern = conv5_tf32_kernel<NF>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(tiles, g.n * co_tiles, g.splits), THREADS, smem, s>>>(
      x, wpk, bias, ep, y, part, g);
  e = cudaGetLastError();
  if (e != cudaSuccess || g.splits == 1) return e;
  const long long hw = (long long)g.h * g.w;
  const long long size = (long long)g.n * g.d * g.co * hw;
  conv5_tf32_reduce_kernel<<<(unsigned)((size + 255) / 256), 256, 0, s>>>(
      part, bias, ep, y, g.splits, size, g.co, hw);
  return cudaGetLastError();
}

}  // namespace

// Launches the split-TF32 conv on `stream`: x a [N, D, Ci, H, W] f32 view
// (element strides for N, C, D and H; W contiguous; any alignment; vec != 0
// where the base and the strides lie on 16 bytes, for 16-byte copies), wpk
// the packed weights (ops/conv5.py _pack_weights_tf32: [Co / (8 nf)][5]
// [Ci / 8][25][nf][32] fragments of 4 f32 words), bias f32 [Co] or null, ep
// f32 [inv(Co), shift(Co), alpha(Co)] or null, y the contiguous f32 [N, D,
// Co, H, W] output. td x th x tw = 256 is the block's output tile; pitch
// = tw + 8 and plane >= (th + 4) * pitch (4 mod 8) the raw box's row pitch
// and channel plane in floats; splits blocks along the (depth tap,
// 8-channel chunk) stages, with `part` f32 scratch of splits * N * D * Co *
// H * W (unused when splits == 1). Returns cudaGetLastError() after the
// launches (0 on success).
extern "C" int conv5_tf32_launch(const void* x, const void* wpk,
                                 const void* bias, const void* ep, void* y,
                                 void* part, int nf, int td, int th, int tw,
                                 int pitch, int plane, int splits, int vec,
                                 int n, int d, int ci, int h, int w, int co,
                                 long long xs_n, long long xs_c,
                                 long long xs_d, long long xs_h,
                                 void* stream) {
  if (td * th * tw != VOX || tw < 8 || pitch != tw + 8 || plane % 8 != 4 ||
      plane < (th + 4) * pitch || splits < 1 || (splits > 1 && !part))
    return cudaErrorInvalidValue;
  const Geom g{n, d, ci, h, w, co, td, th, tw, pitch, plane, splits, vec,
               xs_n, xs_c, xs_d, xs_h};
  const float* xf = static_cast<const float*>(x);
  const float4* wf = static_cast<const float4*>(wpk);
  const float* bf = static_cast<const float*>(bias);
  const float* ef = static_cast<const float*>(ep);
  float* yf = static_cast<float*>(y);
  float* pf = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nf) {
    case 1: return launch<1>(xf, wf, bf, ef, yf, pf, g, s);
    case 2: return launch<2>(xf, wf, bf, ef, yf, pf, g, s);
    case 3: return launch<3>(xf, wf, bf, ef, yf, pf, g, s);
    case 4: return launch<4>(xf, wf, bf, ef, yf, pf, g, s);
    default: return cudaErrorInvalidValue;
  }
}
