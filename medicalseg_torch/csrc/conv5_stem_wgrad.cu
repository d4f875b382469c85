// Weight gradient of the bf16 stem of V-Net: the 5^3 SAME convolution
// (stride 1) of one input channel into Co <= 16 output channels, on the
// tensor cores, for Hopper (sm_90a):
//
//   dW[kd, kh, kw, 0, co] =
//       sum over (n, d, h, w) of x[n, d+kd-2, 0, h+kh-2, w+kw-2] * g[n, d, co, h, w]
//
// with x zero outside the volume, bf16 operands, f32 products and sums, dW
// written in f32 as [5, 5, 5, 1, Co].
//
// Replaces the stem branch of medicalseg_tpu/ops/pallas_conv5.py:
// _wgrad_kernel_ck / _wgrad_kernel (:539, :465; pallas_calls :912 and :977
// via _conv5_wgrad_kl, :863; stem branches :933, :950, :998). The TPU
// kernel contracts 25 (kd, kh)-shifted copies of g built in HBM; here the
// shift is a shared-memory offset. csrc/conv5_wgrad.cu keeps the f32 stem.
//
// Layout: x is a [N, D, 1, H, W] view given by element strides for N, D
// and H, g a [N, D, Co, H, W] view given by strides for N, C, D and H; W
// is contiguous in both, at any alignment. Where every run of 8 elements
// of g is an aligned 16-byte word (W and g's strides multiples of 8, base
// on 16 bytes: the main path) g is staged by the copy engine (cp.async),
// else through registers (16-byte loads where a row segment allows them,
// element loads elsewhere).
//
// Bound on an H100 SXM: 2 * 125 * Co FLOP per voxel against 2 bytes of x
// and 2 * Co of g read, so the stem's weight gradient is bound by the bytes
// of g (2 x 128^3 x 16 bf16: 134 MB, 0.04 ms at 3.35 TB/s); its 16.8 GFLOP
// take 0.02 ms at 60% of the tensor cores' peak. The kernel before it
// (wgrad_kernel<bf16, 1>) ran on the CUDA cores, where 16.8 GFLOP at the
// 67 TF/s f32 FMA rate alone take 0.25 ms.
//
// Design: an implicit GEMM on mma.sync m16n8k16 with M = the 16 output
// channels, N = the 125 taps padded to 128 columns (16 n8 tiles), K =
// voxels, 16 consecutive w of one row per step. A is g: rows are channels
// and K runs along w, so an A register is one aligned 32-bit word and one
// A fragment serves every tap. B is x shifted by the tap: the B register of
// tap (kd, kh, kw) at K pair (w, w + 1) is x[w + kw - 2], x[w + kw - 1].
// Each input row is staged twice in shared memory, as is (copy 0) and one
// element to the right (copy 1), so that the pair is one aligned word of
// copy 0 for even kw and of copy 1 for odd kw: every B register is one
// 32-bit load at a per-lane offset (16 of them, one per n8 tile, computed
// once). The taps sit on N kw-major, the (kd, kh) rows ascending for even
// kw and descending for odd kw, and the pitches (ROWW, SLOTW) spread the
// eight taps of an n8 tile over distinct banks: 20 wavefronts per 16 B
// loads instead of 16 (tests/test_torch_conv5_stem_wgrad.py counts them).
// A block owns an 8 x 32 (h, w) tile (warp i: row i, two K steps) and walks
// a list of work items, each a depth range of a tile of one volume. It
// keeps the five input slices of the current depth in a ring of ten slots
// (each slice stored twice, as in stem_tc_kernel of csrc/conv5_stem.cu, so
// the five slices of a depth are consecutive slots and the offsets stay
// fixed), prefetching the next input slice into registers while the
// tensor cores run, and the g slices in a ring of three stages that the
// copy engine fills two depths ahead (one stage, filled from registers one
// depth ahead, on the other path): every x and g byte of an item is read
// from memory once. The copy engine took the stem's device time from 0.148
// to 0.126 ms (2 x 128^3) and from 0.372 to 0.285 ms (3 x 12 x 512^2):
// PERF.md. Each warp holds all 128 taps x 16 channels, 64 f32 accumulators
// a thread. At the end the eight warps' sums are added in warp order
// through shared memory, each block writes one partial dW, and
// stem_wgrad_reduce_kernel sums the partials in block order: no atomics,
// two launches give identical bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KS = 5;
constexpr int HALO = KS / 2;
constexpr int TAPS = KS * KS * KS;
constexpr int TH = 8;                    // tile rows: one per warp
constexpr int TW = 32;                   // tile columns: two K steps
constexpr int THREADS = 32 * TH;
constexpr int COP = 16;                  // output channels: M of the GEMM
constexpr int NTILES = 16;               // n8 tiles: 128 tap columns
constexpr int XROWS = TH + 2 * HALO;     // rows of a staged input slice
constexpr int XWORDS = 20;               // words of one copy of a row:
                                         // x[w0 - 4 .. w0 + 35] (copy 0)
constexpr int COPY1 = XWORDS;            // copy 1: one element to the right
constexpr int ROWW = 44;                 // words between staged rows
constexpr int SLOTW = 540;               // words between slots
constexpr int SLOTS = 2 * KS;            // each slice stored twice
constexpr int XLOADS = XROWS * XWORDS;   // words per copy of a slice
constexpr int GCP = TH * TW / 2 + 4;     // words between staged g channels
constexpr int GVECS = COP * TH * TW / 8; // 16-byte words of a g slice
constexpr int GLOADS = GVECS / THREADS;
constexpr int RED = NTILES / 4 * 128;    // floats a warp adds per round
constexpr int GSTAGE = COP * GCP;        // words of a staged g slice
constexpr int GSTAGES = 3;               // g ring with the copy engine
static_assert(GVECS % THREADS == 0, "g slice split");
static_assert(XLOADS <= THREADS, "x slice: one word per thread");
static_assert(TH * RED <= SLOTS * SLOTW, "reduction fits the ring");

struct SWGeom {
  int n, d, h, w, co;
  int dc, chunks, tiles_w, tiles;          // depth chunks and tiles
  long long items, per;                    // work items, per block
  long long xs_n, xs_d, xs_h;              // element strides of x
  long long gs_n, gs_c, gs_d, gs_h;        // element strides of g
};

__device__ __forceinline__ void cp_async16(uint32_t* dst, const void* src,
                                           int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The tap of N column c (c < 125; the three padding columns read tap 0's
// words and are never written): kw-major, the 25 (kd, kh) rows ascending
// for even kw and descending for odd kw.
__device__ __forceinline__ int tap_row(int c) {
  c = c < TAPS ? c : 0;
  const int kw = c / 25, i = c % 25;
  return (kw & 1) ? 24 - i : i;
}
__device__ __forceinline__ int tap_kw(int c) { return (c < TAPS ? c : 0) / 25; }

// The word offset of column c's B register in the five slots of a depth:
// slot kd, row kh, copy kw & 1, word kw / 2 + 1 (with the lane's K pair
// and the warp's row added by the caller).
__device__ __forceinline__ int tap_offset(int c) {
  const int row = tap_row(c), kw = tap_kw(c);
  return (row / KS) * SLOTW + (row % KS) * ROWW + (kw & 1) * COPY1 + kw / 2 + 1;
}

template <bool ASYNC>
__global__ void __launch_bounds__(THREADS, 2)
stem_wgrad_tc_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ g,
                     float* __restrict__ dst, SWGeom q) {
  __shared__ __align__(16) uint32_t ring[SLOTS * SLOTW];
  __shared__ __align__(16) uint32_t gst[(ASYNC ? GSTAGES : 1) * GSTAGE];

  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int r = lane >> 2;
  const int p = lane & 3;

  int off[NTILES];
#pragma unroll
  for (int j = 0; j < NTILES; ++j) off[j] = tap_offset(8 * j + r);

  float acc[NTILES][4];
#pragma unroll
  for (int j = 0; j < NTILES; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  // the x word this thread stages: row xr, word xk of each copy
  const int xr = t / XWORDS;
  const int xk = t % XWORDS;
  uint32_t px0 = 0, px1 = 0;  // prefetched copy-0 and copy-1 words
  uint4 pg[GLOADS];           // prefetched g words (register path)

  const long long first = (long long)blockIdx.x * q.per;
  const long long last = min(q.items, first + q.per);
  for (long long it = first; it < last; ++it) {
    const int tile = (int)(it % q.tiles);
    const long long rest = it / q.tiles;
    const int chunk = (int)(rest % q.chunks);
    const int nb = (int)(rest / q.chunks);
    const int h0 = (tile / q.tiles_w) * TH;
    const int w0 = (tile % q.tiles_w) * TW;
    const int d0 = chunk * q.dc;
    const int d1 = min(q.d, d0 + q.dc);
    const __nv_bfloat16* xn = x + nb * q.xs_n;
    const __nv_bfloat16* gn = g + nb * q.gs_n;

    // input slice dd's words x[w0 - 4 + 2 xk ..] of row h0 - 2 + xr
    // (zeros outside the volume)
    auto load_x = [&](int dd) {
      const int ih = h0 - HALO + xr;
      uint32_t e[3] = {0, 0, 0};
      if (t < XLOADS && dd >= 0 && dd < q.d && ih >= 0 && ih < q.h) {
        const __nv_bfloat16* row = xn + dd * q.xs_d + ih * q.xs_h;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const int iw = w0 - 4 + 2 * xk + k;
          if (iw >= 0 && iw < q.w) e[k] = __bfloat16_as_ushort(row[iw]);
        }
      }
      px0 = e[0] | (e[1] << 16);
      px1 = e[1] | (e[2] << 16);
    };
    // ... and into both slots of the slice
    auto store_x = [&](int dd) {
      if (t < XLOADS) {
        const int slot = (dd + 5 * KS) % KS;
        uint32_t* s0 = ring + slot * SLOTW + xr * ROWW + xk;
        uint32_t* s1 = s0 + KS * SLOTW;
        s0[0] = px0;
        s0[COPY1] = px1;
        s1[0] = px0;
        s1[COPY1] = px1;
      }
    };
    // g slice od: [16 co][8 rows][32 w] as 16-byte words (zeros past Co,
    // H and W)
    auto load_g = [&](int od) {
#pragma unroll
      for (int i = 0; i < GLOADS; ++i) {
        const int v = t + i * THREADS;
        const int co = v / (TH * TW / 8);
        const int oh = h0 + (v / (TW / 8)) % TH;
        const int ow = w0 + 8 * (v % (TW / 8));
        uint4 val = make_uint4(0, 0, 0, 0);
        if (co < q.co && oh < q.h && ow < q.w) {
          const __nv_bfloat16* src =
              gn + co * q.gs_c + od * q.gs_d + oh * q.gs_h + ow;
          if (ow + 8 <= q.w && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
            val = __ldg(reinterpret_cast<const uint4*>(src));
          } else {
            uint32_t e[8];
#pragma unroll
            for (int k = 0; k < 8; ++k)
              e[k] = ow + k < q.w ? __bfloat16_as_ushort(src[k]) : 0u;
            val = make_uint4(e[0] | (e[1] << 16), e[2] | (e[3] << 16),
                             e[4] | (e[5] << 16), e[6] | (e[7] << 16));
          }
        }
        pg[i] = val;
      }
    };
    auto store_g = [&]() {
#pragma unroll
      for (int i = 0; i < GLOADS; ++i) {
        const int v = t + i * THREADS;
        const int co = v / (TH * TW / 8);
        const int word = 4 * (v % (TH * TW / 8));
        *reinterpret_cast<uint4*>(gst + co * GCP + word) = pg[i];
      }
    };
    // g slice od into ring stage od % 3 by the copy engine: every 16-byte
    // word lies wholly inside or outside the volume (W % 8 == 0)
    auto issue_g = [&](int od) {
      uint32_t* stage = gst + (od % GSTAGES) * GSTAGE;
#pragma unroll
      for (int i = 0; i < GLOADS; ++i) {
        const int v = t + i * THREADS;
        const int co = v / (TH * TW / 8);
        const int oh = h0 + (v / (TW / 8)) % TH;
        const int ow = w0 + 8 * (v % (TW / 8));
        const bool in = co < q.co && oh < q.h && ow < q.w;
        cp_async16(stage + co * GCP + 4 * (v % (TH * TW / 8)),
                   in ? gn + co * q.gs_c + od * q.gs_d + oh * q.gs_h + ow : g,
                   in ? 16 : 0);
      }
    };

    if (ASYNC) {
      issue_g(d0);
      cp_async_commit();
      if (d0 + 1 < d1) issue_g(d0 + 1);
      cp_async_commit();
    }
    for (int k = -HALO; k < HALO; ++k) {
      load_x(d0 + k);
      store_x(d0 + k);
    }
    load_x(d0 + HALO);
    if (!ASYNC) load_g(d0);

    for (int od = d0; od < d1; ++od) {
      store_x(od + HALO);
      if (ASYNC)
        cp_async_wait1();
      else
        store_g();
      __syncthreads();
      if (ASYNC) {
        if (od + 2 < d1) issue_g(od + 2);
        cp_async_commit();
      }
      if (od + 1 < d1) {
        load_x(od + HALO + 1);
        if (!ASYNC) load_g(od + 1);
      }

      // the five slices of this depth: slots base .. base + 4
      const int base = (od - HALO + 5 * KS) % KS;
      const uint32_t* xs = ring + base * SLOTW + warp * ROWW + p;
      const uint32_t* ga = gst + (ASYNC ? (od % GSTAGES) * GSTAGE : 0) +
                           r * GCP + warp * (TW / 2) + p;
#pragma unroll
      for (int s = 0; s < TW / 16; ++s) {
        const uint32_t a0 = ga[8 * s];
        const uint32_t a1 = ga[8 * GCP + 8 * s];
        const uint32_t a2 = ga[8 * s + 4];
        const uint32_t a3 = ga[8 * GCP + 8 * s + 4];
#pragma unroll
        for (int j = 0; j < NTILES; ++j) {
          const uint32_t* xq = xs + off[j] + 8 * s;
          mma_bf16(acc[j], a0, a1, a2, a3, xq[0], xq[4]);
        }
      }
      __syncthreads();  // every warp is done with this depth's slots
    }
  }

  // the warps' sums, added in warp order, four n8 tiles per round; the
  // accumulator fragment holds channels r, r + 8 of columns 8 j + 2 p +
  // {0, 1}
  float* red = reinterpret_cast<float*>(ring);
  float* out = dst + (size_t)blockIdx.x * TAPS * q.co;
#pragma unroll
  for (int round = 0; round < NTILES / 4; ++round) {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[warp * RED + (4 * jj + e) * 32 + lane] = acc[4 * round + jj][e];
    __syncthreads();
    for (int i = t; i < RED; i += THREADS) {
      float sum = 0.f;
#pragma unroll
      for (int wp = 0; wp < TH; ++wp) sum += red[wp * RED + i];
      const int jj = i >> 7, e = (i >> 5) & 3, ln = i & 31;
      const int col = 8 * (4 * round + jj) + 2 * (ln & 3) + (e & 1);
      const int co = (ln >> 2) + 8 * (e >> 1);
      if (col < TAPS && co < q.co) {
        const int row = tap_row(col);
        out[(row * KS + tap_kw(col)) * q.co + co] = sum;
      }
    }
    __syncthreads();
  }
}

// out[i] = sum over the blocks' partials of part[b][i], in the order b = 0, 1, ...
__global__ void stem_wgrad_reduce_kernel(const float* __restrict__ part,
                                         float* __restrict__ out, int parts,
                                         int size) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size) return;
  float s = 0.f;
  for (int b = 0; b < parts; ++b) s += part[(size_t)b * size + i];
  out[i] = s;
}

}  // namespace

// Launches the bf16 stem weight gradient on `stream`: x [N, D, 1, H, W]
// (strides xs_*), g [N, D, co, H, W] (strides gs_*), both W contiguous;
// out f32 [125, co]. `blocks` blocks each walk `per` work items (a tile of
// 8 x 32 voxels of one volume over a chunk of `dc` depths), each writing
// its partial sums to part [blocks, 125, co], which a second kernel adds
// in block order into out; with one block the kernel writes out itself.
// Returns cudaGetLastError() after the launches (0 on success),
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int conv5_stem_wgrad_tc_launch(
    const void* x, const void* g, void* part, void* out, int dc, int per,
    int blocks, int n, int d, int h, int w, int co, long long xs_n,
    long long xs_d, long long xs_h, long long gs_n, long long gs_c,
    long long gs_d, long long gs_h, void* stream) {
  if (co < 1 || co > COP || dc < 1 || per < 1 || blocks < 1 || n < 1 ||
      d < 1 || h < 1 || w < 1 || (blocks > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  const int tiles_w = (w + TW - 1) / TW;
  const long long tiles = (long long)((h + TH - 1) / TH) * tiles_w;
  const int chunks = (d + dc - 1) / dc;
  const long long items = (long long)n * chunks * tiles;
  if (tiles > 0x7fffffffLL || (long long)blocks * per < items ||
      (long long)(blocks - 1) * per >= items)
    return cudaErrorInvalidValue;
  const SWGeom q{n, d, h, w, co, dc, chunks, tiles_w, (int)tiles, items, per,
                 xs_n, xs_d, xs_h, gs_n, gs_c, gs_d, gs_h};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = static_cast<float*>(blocks > 1 ? part : out);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* gb = static_cast<const __nv_bfloat16*>(g);
  // the copy engine where every 8-element run of g is 16 bytes, aligned
  const bool async = w % 8 == 0 && (reinterpret_cast<uintptr_t>(g) & 15) == 0 &&
                     gs_n % 8 == 0 && gs_c % 8 == 0 && gs_d % 8 == 0 &&
                     gs_h % 8 == 0;
  if (async)
    stem_wgrad_tc_kernel<true><<<blocks, THREADS, 0, s>>>(xb, gb, dst, q);
  else
    stem_wgrad_tc_kernel<false><<<blocks, THREADS, 0, s>>>(xb, gb, dst, q);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || blocks == 1) return e;
  const int size = TAPS * co;
  stem_wgrad_reduce_kernel<<<(size + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(out), blocks, size);
  return cudaGetLastError();
}
