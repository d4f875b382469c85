// The bf16 stem of V-Net: a 5^3 SAME convolution (stride 1) of one input
// channel into Co <= 16 output channels, with bias and an optional fused
// BatchNorm + PReLU epilogue, on the tensor cores, for Hopper (sm_90a):
//
//   y[n, d, co, h, w] = ep(b[co] + sum over the 125 taps of
//                          w[kd, kh, kw, 0, co] * x[n, d+kd-2, 0, h+kh-2, w+kw-2])
//
// with x zero outside the volume, bf16 operands, f32 products and sums,
// ep(v) = PReLU_alpha(v * inv + shift) in f32 (or the identity), and one
// rounding to bf16.
//
// Replaces medicalseg_tpu/ops/pallas_conv5.py:_conv5_stem_kl (:423), the
// stem form of _conv5_kernel (:186; pallas_call :309), and its fused
// epilogue (conv5_kl_fused, :1288) for the stem. The TPU builds 25
// (kd, kw)-shifted copies of the volume in HBM so that the contraction is
// lane-aligned; here the shifts are formed in registers.
//
// Layout: x is a [N, D, 1, H, W] view given by element strides for N, D
// and H (W contiguous, any alignment); y is [N, D, Co, H, W] with W
// contiguous. The wrapper packs the weights as 80 K pairs x 16 output
// channels of bf16 pairs (see below), bias as f32 [Co] and the epilogue
// as f32 [inv(Co), shift(Co), alpha(Co)].
//
// Bound on an H100 SXM: 2 * 125 * Co FLOP per voxel against 2 bytes read
// and 2 * Co written, so the stem is bound by the bytes of its output
// (2 x 128^3 x 16 bf16: 134 MB, 0.04 ms at 3.35 TB/s). The CUDA-core
// kernel before it (conv5_kernel, csrc/conv5.cu) was capped by the 67
// TF/s f32 FMA rate (16.8 GFLOP: 0.25 ms at best) and staged each input
// slice once per depth tap, synchronously.
//
// Design: an implicit GEMM on mma.sync m16n8k16, M = 16 voxels along w,
// N = 16 output channels (two n8 tiles), K = the taps as pairs (kw, kw+1)
// of one (kd, kh) row: (0, 1), (2, 3), (4, 5) with a zero weight at kw =
// 5, so 75 pairs padded with zero weights to 80, 10 K steps. The B
// fragments (all 80 x 16 pairs, 40 registers a thread) are loaded once per
// block and held. A block owns an 8 x 32 (h, w) tile and walks a range of
// depths; warp i computes tile row i (two m16 tiles). The block keeps the
// input slices of the five depth taps in shared memory, each stored twice
// (slots s and s + 5 of ten), so that the five slices of an output depth
// are five consecutive slots from one base and a thread's 20 operand
// offsets are fixed: each input slice is read from memory once per block
// and prefetched into registers while the tensor cores work on the
// previous depth. An A register is x[w + kw - 2], x[w + kw - 1]: one
// aligned 32-bit word where w + kw is even, else __byte_perm(lo, hi,
// 0x5432) of two neighbouring words, so a thread uses one selector (its
// voxel's parity). The f32 results get bias and epilogue, are rounded
// once, staged per warp as [16 co][32 w] in shared memory and written as
// 16-byte stores of whole rows (64 contiguous bytes per channel).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KS = 5;
constexpr int HALO = KS / 2;
constexpr int TH = 8;                  // tile rows: one per warp
constexpr int TW = 32;                 // tile columns: two m16 tiles
constexpr int THREADS = 32 * TH;
constexpr int COP = 16;                // output channels of the GEMM
constexpr int PAIRS = 80;              // K pairs: 75 taps pairs + 5 zero
constexpr int KSTEPS = PAIRS / 8;
constexpr int XROWS = TH + 2 * HALO;   // rows of a staged input slice
constexpr int XW = TW + 8;             // its columns (tile - 2 .. tile + 37)
constexpr int ROWW = XW / 2;           // words between its rows
constexpr int SLOTW = XROWS * ROWW;    // words of a slot
constexpr int SLOTS = 2 * KS;          // each slice stored twice
constexpr int XELEMS = XROWS * XW;     // elements of a slice
constexpr int LOADS = (XELEMS + THREADS - 1) / THREADS;
constexpr int YW = TW + 8;             // staged output row pitch (elements)

struct SGeom {
  int n, d, h, w, co;
  int dc;                                  // output depths per block
  long long xs_n, xs_d, xs_h;              // element strides of x
  long long ys_n, ys_c, ys_d, ys_h;        // element strides of y
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

template <bool EP>
__global__ void __launch_bounds__(THREADS, 2)
stem_tc_kernel(const __nv_bfloat16* __restrict__ x,
               const uint32_t* __restrict__ wpk, const float* __restrict__ bias,
               const float* __restrict__ ep, __nv_bfloat16* __restrict__ y,
               SGeom q) {
  __shared__ __align__(16) uint32_t ring[SLOTS * SLOTW];
  __shared__ __align__(16) __nv_bfloat16 ystage[TH][COP * YW];
  // bias, inv, shift, alpha of each output channel: read per depth from
  // here rather than held in registers beside the weights
  __shared__ float chan[4][COP];

  const int tiles_w = (q.w + TW - 1) / TW;
  const int h0 = (blockIdx.x / tiles_w) * TH;
  const int w0 = (blockIdx.x % tiles_w) * TW;
  const int chunks = (q.d + q.dc - 1) / q.dc;
  const int nb = blockIdx.y / chunks;
  const int d0 = (blockIdx.y % chunks) * q.dc;
  const int d1 = min(q.d, d0 + q.dc);

  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int r = lane >> 2;
  const int p = lane & 3;

  // B fragments: pair 8s + p (+ 4) of output channel 8f + r
  uint32_t b[KSTEPS][2][2];
#pragma unroll
  for (int s = 0; s < KSTEPS; ++s)
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      b[s][f][0] = wpk[(8 * s + p) * COP + 8 * f + r];
      b[s][f][1] = wpk[(8 * s + 4 + p) * COP + 8 * f + r];
    }
  // the word offset of pair 8s + 4 half + p: depth tap kd (a slot), row kh,
  // column pair kp; the 5 pairs past the 75th have zero weights and read
  // the first pair's words
  int tab[KSTEPS][2];
#pragma unroll
  for (int s = 0; s < KSTEPS; ++s)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      int j = 8 * s + 4 * hf + p;
      j = j < KS * KS * 3 ? j : 0;
      const int row = j / 3;
      tab[s][hf] = (row / KS) * SLOTW + (row % KS) * ROWW + j % 3;
    }
  const uint32_t sel = (r & 1) ? 0x5432u : 0x3210u;
  if (t < COP) {
    const bool ok = t < q.co;
    chan[0][t] = ok ? bias[t] : 0.f;
    chan[1][t] = EP && ok ? ep[t] : 1.f;
    chan[2][t] = EP && ok ? ep[q.co + t] : 0.f;
    chan[3][t] = EP && ok ? ep[2 * q.co + t] : 1.f;
  }

  const __nv_bfloat16* xn = x + nb * q.xs_n;
  uint16_t pre[LOADS];
  // the halo slice of input depth dd into registers (zeros outside)
  auto load = [&](int dd) {
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int e = t + i * THREADS;
      const int ih = h0 - HALO + e / XW;
      const int iw = w0 - HALO + e % XW;
      pre[i] = (e < XELEMS && dd >= 0 && dd < q.d && ih >= 0 && ih < q.h &&
                iw >= 0 && iw < q.w)
                   ? __bfloat16_as_ushort(xn[dd * q.xs_d + ih * q.xs_h + iw])
                   : (uint16_t)0;
    }
  };
  // ... and from registers into both of its slots
  auto store = [&](int dd) {
    const int slot = (dd + 5 * KS) % KS;
    uint16_t* r0 = reinterpret_cast<uint16_t*>(ring + slot * SLOTW);
    uint16_t* r1 = reinterpret_cast<uint16_t*>(ring + (slot + KS) * SLOTW);
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int e = t + i * THREADS;
      if (e < XELEMS) {
        r0[e] = pre[i];
        r1[e] = pre[i];
      }
    }
  };

  for (int k = -HALO; k < HALO; ++k) {
    load(d0 + k);
    store(d0 + k);
  }
  load(d0 + HALO);

  __nv_bfloat16* ys = ystage[warp];
  const int oh = h0 + warp;
  for (int od = d0; od < d1; ++od) {
    store(od + HALO);
    __syncthreads();
    if (od + 1 < d1) load(od + HALO + 1);

    // the five slices of this depth: slots base .. base + 4
    const int base = (od - HALO + 5 * KS) % KS;
    const uint32_t* xs = ring + base * SLOTW + warp * ROWW + (r >> 1);
    float acc[2][2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][f][e] = 0.f;
#pragma unroll
    for (int s = 0; s < KSTEPS; ++s) {
      uint32_t a[2][2][2];  // [m16 tile][K half][voxel r, r + 8]
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const uint32_t* xq = xs + tab[s][hf];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          a[m][hf][0] = __byte_perm(xq[8 * m], xq[8 * m + 1], sel);
          a[m][hf][1] = __byte_perm(xq[8 * m + 4], xq[8 * m + 5], sel);
        }
      }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int f = 0; f < 2; ++f)
          mma_bf16(acc[m][f], a[m][0][0], a[m][0][1], a[m][1][0], a[m][1][1],
                   b[s][f][0], b[s][f][1]);
    }

    // accumulator fragment: voxels 16 m + lane / 4 (+ 8), channels 8 f +
    // 2 (lane % 4) + {0, 1}
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int co = 8 * f + 2 * p + e2;
        const float bc = chan[0][co];
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int e1 = 0; e1 < 2; ++e1) {
            float v = acc[m][f][2 * e1 + e2] + bc;
            if (EP) {
              v = v * chan[1][co] + chan[2][co];
              v = v >= 0.f ? v : v * chan[3][co];
            }
            ys[co * YW + 16 * m + r + 8 * e1] = __float2bfloat16(v);
          }
      }
    __syncwarp();
    if (oh < q.h) {
      __nv_bfloat16* yrow = y + nb * q.ys_n + od * q.ys_d + oh * q.ys_h;
#pragma unroll
      for (int i = lane; i < COP * TW / 8; i += 32) {
        const int co = i >> 2;
        const int wc = 8 * (i & 3);
        if (co >= q.co) continue;
        __nv_bfloat16* dst = yrow + co * q.ys_c + w0 + wc;
        const __nv_bfloat16* src = ys + co * YW + wc;
        if (w0 + wc + 8 <= q.w && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else {
          for (int k = 0; k < 8 && w0 + wc + k < q.w; ++k) dst[k] = src[k];
        }
      }
    }
    __syncthreads();  // every warp is done with this depth's slots
  }
}

}  // namespace

// Launches the bf16 stem conv on `stream`: x [N, D, 1, H, W] (strides
// xs_*, W contiguous), wpk the packed weights (80 K pairs x 16 output
// channels of 32-bit words, see the note above), bias f32 [co], ep f32
// [3 * co] or null (no epilogue), y [N, D, co, H, W] (strides ys_*, W
// contiguous); each block walks `dc` output depths of an 8 x 32 tile.
// Returns cudaGetLastError() after the launch (0 on success),
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int conv5_stem_tc_launch(const void* x, const void* wpk,
                                    const void* bias, const void* ep, void* y,
                                    int dc, int n, int d, int h, int w, int co,
                                    long long xs_n, long long xs_d,
                                    long long xs_h, long long ys_n,
                                    long long ys_c, long long ys_d,
                                    long long ys_h, void* stream) {
  if (co < 1 || co > COP || dc < 1 || n < 1 || d < 1 || h < 1 || w < 1 ||
      bias == nullptr)
    return cudaErrorInvalidValue;
  const long long tiles = (long long)((h + TH - 1) / TH) * ((w + TW - 1) / TW);
  const long long rows = (long long)n * ((d + dc - 1) / dc);
  if (tiles > 0x7fffffffLL || rows > 65535) return cudaErrorInvalidValue;
  const SGeom q{n, d, h, w, co, dc, xs_n, xs_d, xs_h, ys_n, ys_c, ys_d, ys_h};
  const dim3 grid((unsigned)tiles, (unsigned)rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const uint32_t*>(wpk);
  const auto* bb = static_cast<const float*>(bias);
  const auto* eb = static_cast<const float*>(ep);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  if (ep != nullptr)
    stem_tc_kernel<true><<<grid, THREADS, 0, s>>>(xb, wb, bb, eb, yb, q);
  else
    stem_tc_kernel<false><<<grid, THREADS, 0, s>>>(xb, wb, bb, eb, yb, q);
  return cudaGetLastError();
}
