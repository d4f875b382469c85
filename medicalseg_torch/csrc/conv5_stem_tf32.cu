// The float32 stem of V-Net on Hopper's tensor cores, at f32 accuracy
// ("split TF32"): a 5^3 SAME convolution (stride 1) of one input channel
// into Co <= 16 output channels, with bias and an optional fused BatchNorm +
// PReLU epilogue:
//
//   y[n, d, co, h, w] = ep(b[co] + sum over the 125 taps of
//                          w[kd, kh, kw, 0, co] * x[n, d+kd-2, 0, h+kh-2, w+kw-2])
//
// with x zero outside the volume and ep(v) = PReLU_alpha(v * inv + shift)
// (or the identity), all in f32.
//
// Replaces, for float32 activations, medicalseg_tpu/ops/pallas_conv5.py
// _conv5_stem_kl (:423), the stem form of _conv5_kernel (:186; pallas_call
// :309), and its fused epilogue (conv5_kl_fused, :1288) for the stem. The
// CUDA-core kernel before it (conv5_kernel, csrc/conv5.cu) stays for wider
// stems and forced comparisons.
//
// Numerics, as csrc/conv5_tf32.cu: each operand a is split into hi =
// rna_tf32(a) and lo = rna_tf32(a - hi) (the integer form of
// cvt.rna.tf32.f32, ops/conv5.py split_tf32 bit for bit), and each product
// is lo*hi + hi*lo + hi*hi, three mma.sync.m16n8k8 TF32 products summed in
// f32. Here K is only 16 k8 steps (48 mma on one accumulator), short enough
// that the tensor cores' truncating accumulation keeps f32 accuracy.
//
// Layout: x is a [N, D, 1, H, W] view given by element strides for N, D and
// H (W contiguous, any alignment); y is [N, D, Co, H, W] given by strides
// (W contiguous). The wrapper packs the weights pre-split per lane
// (ops/conv5.py _pack_weights_stem_tf32): per k step and n8 tile, lane (g,
// t) holds (hi(b0), hi(b1), lo(b0), lo(b1)) of b0 = W[column 8s + t][8f +
// g], b1 = W[column 8s + 4 + t][8f + g], one 16-byte load.
//
// Bound on an H100 SXM: 2 * 125 * Co FLOP a voxel, three TF32 passes at 495
// TF/s (2 x 128^3, Co 16: 0.102 ms), against 4 bytes read and 4 * Co written
// a voxel (0.045 ms at 3.35 TB/s): bound by operations. conv5_kernel ran on
// the CUDA cores, whose f32 FMA rate (67 TF/s) caps it at 0.25 ms, and
// staged each input slice once per depth tap, synchronously.
//
// Design: an implicit GEMM on mma.sync m16n8k8 TF32, M = output voxels, N =
// the 16 channels (two n8 tiles), K = the 125 taps padded to 128. A TF32 A
// register holds one element, so x[w + kw - 2] is one 32-bit shared-memory
// load at a per-lane offset. K is laid out so that a lane's offset is a
// fixed part plus t (its K column in a quad), t * rowp or a slot: the 32
// half k8 steps are 25 (kd, kh) rows of kw 0..3 (stride 1), five (kd) rows
// of kh 0..3 at kw 4 (stride rowp), kd 0..3 at (kh, kw) = (4, 4) (stride
// a slot) and the tap (4, 4, 4) alone (three zero weights). A block owns a
// th x twd tile of (h, w), its voxels packed row-major onto M (where W is
// narrow a tile is whole rows, so W = 12 wastes no column of an m16 tile),
// and walks a chunk of depths; warp i owns voxels 64i .. 64i + 63 (four m16
// tiles) against both n8 tiles. The five input slices of an output depth
// sit in a ring of five slots, each slice split once into hi and lo planes
// when it is staged: its raw box comes by cp.async (16-byte copies where
// the view's base and strides allow, else 4-byte, zero fill for the SAME
// padding and the ragged edges) while the tensor cores work on the previous
// depth. The weights' 16 KB of fragments are loaded once a block. The
// pitches (rowp, slot) are chosen by the wrapper so that the A loads of a
// warp hit distinct banks (tests/test_torch_conv5_stem_tf32.py counts the
// wavefronts). The results get bias and epilogue and are staged per warp
// as [16 co][64 voxels] in shared memory, then written as 16-byte stores of
// whole row segments.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KS = 5;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MT = 4;                    // m16 tiles of a warp
constexpr int WVOX = 16 * MT;            // voxels of a warp (64)
constexpr int TVOX = WARPS * WVOX;       // voxels of a block tile (512)
constexpr int KSTEPS = 16;               // k8 steps: 128 K columns
constexpr int COP = 16;                  // output channels: N of the GEMM
constexpr int YP = WVOX + 4;             // staged output row pitch (floats)
constexpr int WB_F4 = KSTEPS * 2 * 32;   // float4 weight fragments

struct FGeom {
  int n, d, h, w, co;
  int th, twd, tiles_w;   // the block's tile: th rows x twd columns
  int dc;                 // output depths a block walks
  int rowp, slot;         // ring: row pitch and slot pitch (floats)
  int rawp;               // raw box: row pitch (floats), from column w0 - 4
  long long xs_n, xs_d, xs_h;
  long long ys_n, ys_c, ys_d, ys_h;
};

__device__ __forceinline__ uint32_t rna_tf32(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float a, float& hi, float& lo) {
  hi = __uint_as_float(rna_tf32(a));
  lo = __uint_as_float(rna_tf32(a - hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         float b0, float b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(__float_as_uint(b0)),
        "r"(__float_as_uint(b1)));
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

// The word offset of half k8 step hg (a constant once the k loop is
// unrolled) for lane quad position t in the ring, from the slots' bases sb
// (input depths od - 2 .. od + 2): (kd, kh) rows of kw = t; (kd) rows of kh
// = t at kw 4; kd = t at (4, 4); the tap (4, 4, 4) (lanes t > 0 carry zero
// weights and read its word).
__device__ __forceinline__ int half_offset(int hg, const int (&sb)[KS],
                                           int sbt, int t, int rowp) {
  if (hg < 25) return sb[hg / 5] + (hg % 5) * rowp + t;
  if (hg < 30) return sb[hg - 25] + t * rowp + 4;
  if (hg == 30) return sbt + 4 * rowp + 4;
  return sb[4] + 4 * rowp + 4;
}

template <bool EP, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
stem_tf32_kernel(const float* __restrict__ x, const float4* __restrict__ wpk,
                 const float* __restrict__ bias, const float* __restrict__ ep,
                 float* __restrict__ y, FGeom q) {
  extern __shared__ float4 smem4[];
  float4* wb = smem4;                                     // weight fragments
  float* ys = reinterpret_cast<float*>(wb + WB_F4);      // [8][16][YP]
  float* raw = ys + WARPS * COP * YP;                    // [th + 4][rawp]
  float* chan = raw + (q.th + 4) * q.rawp;               // [4][16]
  float* rhi = chan + 4 * COP;                           // [5][slot]
  float* rlo = rhi + KS * q.slot;                        // [5][slot]

  const int h0 = (blockIdx.x / q.tiles_w) * q.th;
  const int w0 = (blockIdx.x % q.tiles_w) * q.twd;
  const int chunks = (q.d + q.dc - 1) / q.dc;
  const int nb = blockIdx.y / chunks;
  const int d0 = (blockIdx.y % chunks) * q.dc;
  const int d1 = min(q.d, d0 + q.dc);
  // the tile's voxels that lie in the volume's rows (packed row-major)
  const int tvox = min(q.th, q.h - h0) * q.twd;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  // the ring offsets of this lane's voxels g and g + 8 of each m16 tile
  // (voxels past the tile read word 0 and are not stored: every warp runs
  // all four tiles, without a branch between the loads and the mma)
  int vo[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int v = WVOX * warp + 16 * m + g + 8 * e;
      vo[m][e] = v < tvox ? (v / q.twd) * q.rowp + v % q.twd : 0;
    }

  for (int i = threadIdx.x; i < WB_F4; i += THREADS) cp16(wb + i, wpk + i, 16);
  if (threadIdx.x < COP) {
    const int c = threadIdx.x;
    const bool ok = c < q.co;
    chan[c] = ok ? bias[c] : 0.f;
    chan[COP + c] = EP && ok ? ep[c] : 1.f;
    chan[2 * COP + c] = EP && ok ? ep[q.co + c] : 0.f;
    chan[3 * COP + c] = EP && ok ? ep[2 * q.co + c] : 1.f;
  }

  const float* xn = x + nb * q.xs_n;
  // the raw box of input depth dd: rows h0 - 2 .. h0 + th + 1 from column
  // w0 - 4, zeros outside the volume
  auto load_raw = [&](int dd) {
    const bool dok = dd >= 0 && dd < q.d;
    const int per_row = VEC ? q.rawp / 4 : q.rawp;
    const int total = (q.th + 4) * per_row;
    for (int i = threadIdx.x; i < total; i += THREADS) {
      const int row = i / per_row;
      const int k = i % per_row;
      const int ih = h0 - 2 + row;
      const bool rok = dok && ih >= 0 && ih < q.h;
      float* dst = raw + row * q.rawp;
      if (VEC) {
        const int iw = w0 - 4 + 4 * k;
        const int bytes = rok && iw >= 0 && iw < q.w ? 4 * min(4, q.w - iw) : 0;
        cp16(dst + 4 * k, bytes ? xn + dd * q.xs_d + ih * q.xs_h + iw : x,
             bytes);
      } else {
        const int iw = w0 - 4 + k;
        const bool ok = rok && iw >= 0 && iw < q.w;
        cp4(dst + k, ok ? xn + dd * q.xs_d + ih * q.xs_h + iw : x, ok);
      }
    }
  };
  // ... split once into the hi and lo planes of its slot
  auto split = [&](int dd) {
    const int slot = (dd + KS) % KS;
    const int cols = q.twd + 4;
    const int total = (q.th + 4) * cols;
    float* hs = rhi + slot * q.slot;
    float* ls = rlo + slot * q.slot;
    for (int e = threadIdx.x; e < total; e += THREADS) {
      const int row = e / cols;
      const int c = e % cols;
      float hv, lv;
      split_tf32(raw[row * q.rawp + c + 2], hv, lv);
      hs[row * q.rowp + c] = hv;
      ls[row * q.rowp + c] = lv;
    }
  };

  for (int k = -2; k < 2; ++k) {
    load_raw(d0 + k);
    cp_commit();
    cp_wait_all();
    __syncthreads();
    split(d0 + k);
    __syncthreads();
  }
  load_raw(d0 + 2);
  cp_commit();

  float* ysw = ys + warp * COP * YP;
  // this lane's output words: voxels vs .. vs + 3 of the tile (row sr,
  // column sc) of channels lane / 16, + 2, ... (the same voxels for each)
  const int vs = WVOX * warp + 4 * (lane % (WVOX / 4));
  const int sr = vs / q.twd;
  const int sc = vs % q.twd;
  const bool svec = sc + 4 <= q.twd && vs + 4 <= tvox && w0 + sc + 4 <= q.w;
  for (int od = d0; od < d1; ++od) {
    cp_wait_all();
    __syncthreads();  // slice od + 2 landed; every warp is done with od - 1
    split(od + 2);
    __syncthreads();  // the ring holds od - 2 .. od + 2; the raw box is free
    if (od + 1 < d1) load_raw(od + 3);
    cp_commit();

    int sb[KS];
#pragma unroll
    for (int kd = 0; kd < KS; ++kd) sb[kd] = ((od + 3 + kd) % KS) * q.slot;
    const int sbt = ((od + 3 + t) % KS) * q.slot;

    float acc[MT][2][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][f][e] = 0.f;
#pragma unroll
    for (int s = 0; s < KSTEPS; ++s) {
      // B: lane (g, t) of n8 tile f, (hi(b0), hi(b1), lo(b0), lo(b1))
      const float4 bf[2] = {wb[(2 * s) * 32 + lane],
                            wb[(2 * s + 1) * 32 + lane]};
      const int o0 = half_offset(2 * s, sb, sbt, t, q.rowp);
      const int o1 = half_offset(2 * s + 1, sb, sbt, t, q.rowp);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        // a0: voxel g, column t; a1: voxel g + 8; a2, a3: column t + 4
        const uint32_t ah[4] = {__float_as_uint(rhi[o0 + vo[m][0]]),
                                __float_as_uint(rhi[o0 + vo[m][1]]),
                                __float_as_uint(rhi[o1 + vo[m][0]]),
                                __float_as_uint(rhi[o1 + vo[m][1]])};
        const uint32_t al[4] = {__float_as_uint(rlo[o0 + vo[m][0]]),
                                __float_as_uint(rlo[o0 + vo[m][1]]),
                                __float_as_uint(rlo[o1 + vo[m][0]]),
                                __float_as_uint(rlo[o1 + vo[m][1]])};
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          mma_tf32(acc[m][f], al, bf[f].x, bf[f].y);
          mma_tf32(acc[m][f], ah, bf[f].z, bf[f].w);
          mma_tf32(acc[m][f], ah, bf[f].x, bf[f].y);
        }
      }
    }

    // accumulator fragment: voxels g (+ 8) of each m16 tile, channels 8 f +
    // 2 t + {0, 1}; bias and epilogue, staged as [co][voxel of the warp]
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int co = 8 * f + 2 * t + (e & 1);
          float v = acc[m][f][e] + chan[co];
          if (EP) {
            v = v * chan[COP + co] + chan[2 * COP + co];
            v = v >= 0.f ? v : v * chan[3 * COP + co];
          }
          ysw[co * YP + 16 * m + g + 8 * (e >> 1)] = v;
        }
    __syncwarp();
    float* yd = y + nb * q.ys_n + od * q.ys_d;
    if (vs < tvox) {
      float* row = yd + (h0 + sr) * q.ys_h + w0 + sc;
      const float* src = ysw + (vs - WVOX * warp);
      for (int co = lane / (WVOX / 4); co < q.co; co += 32 / (WVOX / 4)) {
        float* dst = row + co * q.ys_c;
        if (svec && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
          *reinterpret_cast<float4*>(dst) =
              *reinterpret_cast<const float4*>(src + co * YP);
        } else {
          for (int k = 0; k < 4 && vs + k < tvox; ++k) {
            const int rr = (vs + k) / q.twd;
            const int cc = (vs + k) % q.twd;
            if (w0 + cc < q.w)
              yd[co * q.ys_c + (h0 + rr) * q.ys_h + w0 + cc] =
                  src[co * YP + k];
          }
        }
      }
    }
    __syncwarp();
  }
}

size_t smem_bytes(int th, int rawp, int slot) {
  return sizeof(float4) * WB_F4 + sizeof(float) * (WARPS * COP * YP +
                                                   (th + 4) * rawp + 4 * COP +
                                                   2 * KS * slot);
}

template <bool EP, bool VEC>
cudaError_t launch(const float* x, const float4* wpk, const float* bias,
                   const float* ep, float* y, const FGeom& q, dim3 grid,
                   size_t smem, cudaStream_t s) {
  auto kern = stem_tf32_kernel<EP, VEC>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<grid, THREADS, smem, s>>>(x, wpk, bias, ep, y, q);
  return cudaGetLastError();
}

}  // namespace

// Launches the split-TF32 stem conv on `stream`: x [N, D, 1, H, W] f32
// (strides xs_*, W contiguous; vec != 0 where the base and the strides lie
// on 16 bytes and every tile starts on a multiple of 4 columns), wpk the
// packed weights (16 k steps x 2 n8 tiles x 32 lanes of 4 f32 words), bias
// f32 [co], ep f32 [3 * co] or null (no epilogue), y [N, D, co, H, W] f32
// (strides ys_*, W contiguous). A block owns th rows x twd columns (tiles_w
// tiles along W) over dc output depths; rowp and slot are the ring's row
// and slot pitches, rawp the raw box's row pitch (floats, a multiple of 4,
// at least twd + 6). Returns cudaGetLastError() after the launch (0 on
// success), cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int conv5_stem_tf32_launch(
    const void* x, const void* wpk, const void* bias, const void* ep, void* y,
    int th, int twd, int tiles_w, int dc, int rowp, int slot, int rawp,
    int vec, int n, int d, int h, int w, int co, long long xs_n,
    long long xs_d, long long xs_h, long long ys_n, long long ys_c,
    long long ys_d, long long ys_h, void* stream) {
  if (co < 1 || co > COP || n < 1 || d < 1 || h < 1 || w < 1 || th < 1 ||
      twd < 1 || th * twd > TVOX || tiles_w < 1 || (long long)tiles_w * twd < w ||
      dc < 1 || rowp < twd + 4 || slot < (th + 4) * rowp || rawp < twd + 6 ||
      rawp % 4 != 0 || (vec && twd % 4 != 0 && tiles_w > 1) || bias == nullptr)
    return cudaErrorInvalidValue;
  const long long tiles = (long long)((h + th - 1) / th) * tiles_w;
  const long long rows = (long long)n * ((d + dc - 1) / dc);
  const size_t smem = smem_bytes(th, rawp, slot);
  if (tiles > 0x7fffffffLL || rows > 65535 || smem > 227 * 1024)
    return cudaErrorInvalidValue;
  const FGeom q{n,    d,    h,    w,    co,   th,   twd,  tiles_w, dc,  rowp,
                slot, rawp, xs_n, xs_d, xs_h, ys_n, ys_c, ys_d,    ys_h};
  const dim3 grid((unsigned)tiles, (unsigned)rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* wf = static_cast<const float4*>(wpk);
  const auto* bf = static_cast<const float*>(bias);
  const auto* ef = static_cast<const float*>(ep);
  auto* yf = static_cast<float*>(y);
  if (ep != nullptr)
    return vec ? launch<true, true>(xf, wf, bf, ef, yf, q, grid, smem, s)
               : launch<true, false>(xf, wf, bf, ef, yf, q, grid, smem, s);
  return vec ? launch<false, true>(xf, wf, bf, ef, yf, q, grid, smem, s)
             : launch<false, false>(xf, wf, bf, ef, yf, q, grid, smem, s);
}
