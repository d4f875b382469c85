// Weight gradient of the 5^3 SAME convolution (stride 1), bf16, for the
// square and wide convs (Co > 16) and, with the taps moved onto g, the
// narrow heads (Co <= 16), fed by an asynchronous TMA ring, for Hopper
// (sm_90a):
//
//   dW[kd, kh, kw, ci, co] =
//       sum over (n, d, h, w) of x[n, d+kd-2, ci, h+kh-2, w+kw-2] * g[n, d, co, h, w]
//
// with x zero outside the volume, bf16 operands, f32 products and sums, dW
// written in f32 as [5, 5, 5, Ci, Co].
//
// Replaces medicalseg_tpu/ops/pallas_conv5.py:_wgrad_mid_kernel_ck /
// _wgrad_mid_kernel (:697, :646; pallas_call :832), and the 128- and
// 256-channel stacks that the JAX package leaves to XLA's VJP
// (_conv5_kl_bwd, :1374-1402); wgrad_head_tma_kernel (below) replaces the
// narrow-head branch of _wgrad_kernel_ck / _wgrad_kernel (:539, :465;
// pallas_call :912 via _conv5_wgrad_kl, :863), which also puts the taps on
// g (:890, :896-900). csrc/conv5_wgrad.cu keeps the stem, f32, and the
// views a tensor copy cannot describe.
//
// Layout: x [N, D, Ci, H, W] and g [N, D, Co, H, W] are views given by
// element strides for N, C, D and H; W is the contiguous axis, and each
// view starts on 16 bytes with every other stride a multiple of 8 elements
// (the wrapper's gate, ops/conv5.py: conv5_wgrad_form).
//
// Bound on an H100 SXM: 2 * 125 * Ci * Co FLOP per voxel against (Ci + Co)
// activations read per voxel, so every shape it takes is operation-bound:
// 989 TF/s of bf16 on the tensor cores, of which mma.sync reaches about 60%.
// The kernel before it (wgrad_mma_kernel<4>) sat at 9.4x the bound because
// all its warps staged every tile with scalar 2-byte loads between two
// __syncthreads(), so no copy was in flight while the tensor cores ran.
//
// Design. For every tap the same GEMM, dW_tap[ci, co] = sum over voxels of
// X_tap[ci, v] * G[co, v], as mma.sync m16n8k16 (M = ci, N = co, K =
// voxels). A block owns 32 input x 32 output channels of the 25 in-plane
// taps of one depth tap (grid.x: kd fastest, so the five blocks that read
// the same g slices run side by side and share them in L2) and a range of
// th x tw voxel tiles (grid.y, the voxel split). Its accumulators are 25 x
// 32 x 32 f32 = 100 KB, 25,600 of the SM's 65,536 registers: 80 a thread
// over 10 warps, (kh, 16-channel half) each with 5 (kw) x 4 n8 tiles.
//   * Warp 10, the loader: one thread keeps a ring of 3-8 stages full, per
//     voxel tile one 5-D tensor copy (TMA) of the x box [32 ci][rows][cols]
//     and one of the g box [32 co][rows][cols], both completing on the
//     stage's full mbarrier. Out-of-range elements arrive as zeros: SAME
//     padding, ragged edges and channel padding cost nothing. The x box
//     starts 8 columns left of the tile (a box starts on 16 bytes).
//   * Warps 0-9, the consumers: wait on the stage's full barrier, run the
//     tile's K steps straight from the tile as it lies in memory (W
//     innermost), then release the stage on its empty barrier. No
//     __syncthreads() in the loop.
// A K pair of a fragment register is (w, w+1) of one row, so a g register,
// and an x register at an even kw shift, is one aligned 32-bit shared load;
// at an odd shift it is one __byte_perm of two neighbouring words: 3 words a
// (channel, K half) give all five kw taps. A K step is 16 consecutive w
// (tw >= 16) or 8 w x 2 rows (tw = 8, the 8^3 level), matching the two K
// halves of m16n8k16. Each box holds an odd number of 16-byte units per
// channel (the wrapper pads a box by 8 columns or one row), so the channel
// pitch is 4 mod 8 words and the 8 channels x 4 words of a fragment load
// hit 32 different banks.
// The voxel axis is split over blocks; each writes a partial dW and
// wgrad_tma_reduce_kernel sums the partials in split order: no atomics, two
// runs are bit-identical. An mbarrier wait that never completes traps (a
// protocol fault is an error, not a hang). Not done yet: wgmma. With A (x)
// from these registers ptxas serializes it for want of registers beside the
// 80 accumulators (times in PERF.md, next steps in ROADMAP.md).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int KS = 5;                    // kernel edge
constexpr int HALO = KS / 2;             // SAME padding on each side
constexpr int CIB = 32;                  // input channels per block
constexpr int NF = 4;                    // n8 tiles per warp: 32 output channels
constexpr int COB = 8 * NF;
constexpr int CONSUMER_WARPS = 2 * KS;   // (kh, 16-channel half of the ci tile)
constexpr int THREADS = 32 * (CONSUMER_WARPS + 1);
constexpr int MAX_STAGES = 8;
constexpr int BAR_BYTES = 128;           // 2 * MAX_STAGES mbarriers of 8 bytes
constexpr int X_LEFT = 8;                // the x box starts this many columns left
constexpr uint32_t SPIN_LIMIT = 1u << 22;

struct TGeom {
  int n, d, ci, h, w, co;
  int th;              // rows of a voxel tile (its width is the template's TW)
  int xrows, xw;       // x box: rows (th + 4 halo, padded) and columns
  int grows, gw;       // g box: rows (th, padded) and columns (tw, padded)
  int stages;          // stages of the ring
  uint32_t x_bytes;    // bytes of the x box (the g box follows it)
  uint32_t stage;      // bytes of one stage (x box + g box)
  long long tiles_per_split;
};

// ---- mbarrier and tensor-copy helpers, as csrc/conv5_wg.cu proves them ----
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Waits until the barrier's phase differs from `parity`; traps when it
// never does.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spin = 0; !done; ++spin) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (spin > SPIN_LIMIT) __trap();
  }
}

// One tensor copy of a box at coordinates (w, h, c, d, n), completing on
// `bar`; out-of-range elements arrive as zeros.
__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2,
                                            int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4)
      : "memory");
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

// One K step of 16 voxels for the warp's 5 kw taps x 4 n8 tiles. xr: the
// thread's first x word (channel lane / 4, its K pair, kw = 0), xc8: words
// to channel + 8, xh: words to the second K half; gr, gc: the same for g
// (gc words between channels).
__device__ __forceinline__ void k_step(float (&acc)[KS][NF][4], const uint32_t* xr,
                                       int xc8, int xh, const uint32_t* gr, int gc,
                                       int gh) {
  uint32_t xv[2][2][3];  // [channel, + 8][K half][word]
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int j = 0; j < 3; ++j) xv[c][k][j] = xr[c * xc8 + k * xh + j];
  uint32_t b[NF][2];
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    b[f][0] = gr[f * 8 * gc];
    b[f][1] = gr[f * 8 * gc + gh];
  }
#pragma unroll
  for (int kw = 0; kw < KS; ++kw) {
    uint32_t a[2][2];
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int k = 0; k < 2; ++k)
        a[c][k] = (kw & 1) ? __byte_perm(xv[c][k][kw >> 1], xv[c][k][(kw >> 1) + 1],
                                         0x5432)
                           : xv[c][k][kw >> 1];
#pragma unroll
    for (int f = 0; f < NF; ++f)
      mma_bf16(acc[kw][f], a[0][0], a[1][0], a[0][1], a[1][1], b[f][0], b[f][1]);
  }
}

template <int TW>
__global__ void __launch_bounds__(THREADS, 1)
wgrad_tma_kernel(float* __restrict__ part, const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap gmap, TGeom q) {
  extern __shared__ __align__(128) uint8_t smem_t[];
  const uint32_t bars = smem_u32(smem_t);
  const uint32_t full = bars, empty = bars + 8 * MAX_STAGES;
  const uint32_t ring = bars + BAR_BYTES;

  const int co_tiles = (q.co + COB - 1) / COB;
  int bx = blockIdx.x;
  const int kd = bx % KS;
  bx /= KS;
  const int o0 = (bx % co_tiles) * COB;
  const int c0 = (bx / co_tiles) * CIB;

  const int tiles_w = (q.w + TW - 1) / TW;
  const int tiles_h = (q.h + q.th - 1) / q.th;
  const long long tiles = (long long)q.n * q.d * tiles_h * tiles_w;
  const long long first = (long long)blockIdx.y * q.tiles_per_split;
  const long long last = min(tiles, first + q.tiles_per_split);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int i = 0; i < q.stages; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMER_WARPS) {
    // ===================== loader =====================
    if (lane == 0) {
      uint32_t it = 0;
      for (long long t = first; t < last; ++t) {
        long long rest = t;
        const int w0 = (int)(rest % tiles_w) * TW;
        rest /= tiles_w;
        const int h0 = (int)(rest % tiles_h) * q.th;
        rest /= tiles_h;
        const int od = (int)(rest % q.d);
        const int nb = (int)(rest / q.d);
        const int id = od + kd - HALO;
        if (id < 0 || id >= q.d) continue;  // only padding: the consumers skip it too
        const uint32_t slot = it % q.stages;
        mbar_wait(empty + 8 * slot, ((it / q.stages) & 1) ^ 1);
        const uint32_t bar = full + 8 * slot;
        const uint32_t dst = ring + slot * q.stage;
        mbar_expect_tx(bar, q.stage);
        tma_load_5d(dst, &xmap, bar, w0 - X_LEFT, h0 - HALO, c0, id, nb);
        tma_load_5d(dst + q.x_bytes, &gmap, bar, w0, h0, o0, od, nb);
        ++it;
      }
    }
    return;
  }

  // ===================== consumers =====================
  const int kh = warp % KS;
  const int mf = warp / KS;
  const int r = lane >> 2;
  const int p = lane & 3;
  const int xc = q.xrows * q.xw / 2;  // words between channels
  const int xrw = q.xw / 2;           // words between rows
  const int gc = q.grows * q.gw / 2;
  const int grw = q.gw / 2;
  // the thread's first word of a stage: output column 2p at kw = 0 reads box
  // column 2p + X_LEFT - HALO
  const int xoff = (mf * 16 + r) * xc + kh * xrw + p + (X_LEFT - HALO) / 2;
  const int goff = r * gc + p;

  float acc[KS][NF][4];
#pragma unroll
  for (int k = 0; k < KS; ++k)
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[k][f][e] = 0.f;

  uint32_t it = 0;
  for (long long t = first; t < last; ++t) {
    const int od = (int)((t / ((long long)tiles_w * tiles_h)) % q.d);
    const int id = od + kd - HALO;
    if (id < 0 || id >= q.d) continue;
    const uint32_t slot = it % q.stages;
    mbar_wait(full + 8 * slot, (it / q.stages) & 1);
    const uint32_t* xs =
        reinterpret_cast<const uint32_t*>(smem_t + BAR_BYTES + slot * q.stage) + xoff;
    const uint32_t* gs = reinterpret_cast<const uint32_t*>(
                             smem_t + BAR_BYTES + slot * q.stage + q.x_bytes) +
                         goff;
    if constexpr (TW >= 16) {
      // a K step: 16 consecutive w of one row, the halves 8 columns apart
#pragma unroll 1
      for (int row = 0; row < q.th; ++row) {
#pragma unroll
        for (int ws = 0; ws < TW; ws += 16)
          k_step(acc, xs + row * xrw + ws / 2, 8 * xc, 4, gs + row * grw + ws / 2,
                 gc, 4);
      }
    } else {
      // a K step: 8 w of two rows, the halves one row apart
#pragma unroll 1
      for (int row = 0; row < q.th; row += 2)
        k_step(acc, xs + row * xrw, 8 * xc, xrw, gs + row * grw, gc, grw);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * slot);
    ++it;
  }

  // accumulator fragment: rows lane / 4 and + 8 (ci), columns 2 * (lane % 4)
  // + {0, 1} (co)
  const size_t size = (size_t)KS * KS * KS * q.ci * q.co;
  float* out = part + (size_t)blockIdx.y * size;
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

// ---- the narrow head (Co <= 16): taps on g ----
//
// dW[kd, kh, kw, ci, co] = sum over u of x[ci, u] * g[co, u - tap + 2]
// (u = v + tap - 2), so for each (kd, kh) one GEMM with M = ci (32), N =
// (co, kw) (3 channels x 5 taps = 15, padded to 16: two n8 tiles) and K =
// voxels u, x unshifted and g shifted. A block owns 32 input channels x 3
// output channels x all 25 (kd, kh): 25 x 32 x 16 f32 accumulators, so
// each x box is staged once (the taps-on-x form stages it once per kd).
// Warp (kd, row parity) runs the K steps of every other tile row for the 5
// kh, both m16 and both n8 tiles (80 accumulators a thread); the two warps
// of a kd add their sums at the end, in a fixed order. A K step is 16
// consecutive w of one tile row. Per stage the loader brings the x box
// [32 ci][rows][cols] at the tile (no halo) and the g box [5 d][3 co][rows]
// [cols] that covers every shift: depths ud - 2 .. ud + 2, rows h0 - 2 ..,
// columns from 8 left of the tile (a box starts on 16 bytes). A thread's
// two B columns (one per n8 tile) are fixed, and chosen to share their
// words: rows 0-5 of the tiles hold (co, kw) and (co, kw + 1) for even kw,
// the aligned word at kw and __byte_perm(word left of it, it, 0x5432) at
// kw + 1; rows 6 and 7 hold kw = 4 of the three channels (aligned words)
// and the padding column, masked to zero. So a B fragment pair of the two
// tiles costs two shared loads, not four. Bound: at 32 -> 3 the operations
// (0.10 ms at 989 TF/s for 2 x 128^3) and the bytes of x (0.09 ms) are
// close; what limits the kernel is its shared-memory loads, 28 a warp per
// K step (8 of x, 20 of g) for 20 mma.sync.
constexpr int HEAD_COG = 3;             // output channels of a block
constexpr int HEAD_WARPS = 2 * KS;      // (kd, row parity)
constexpr int HEAD_THREADS = 32 * (HEAD_WARPS + 1);
constexpr int G_LEFT = 8;               // the g box starts this many columns left

struct HGeom {
  int n, d, ci, h, w, co;
  int th;              // rows of a voxel tile (its width is the template's TW)
  int xrows, xw;       // x box: rows (th, padded) and columns (tw, padded)
  int grows, gw;       // g box: rows (th + 4, padded) and columns
  int stages;
  uint32_t x_bytes;    // bytes of the x box (the g box follows it)
  uint32_t g_bytes;    // bytes of the g box
  uint32_t stage;      // bytes of one stage, a multiple of 128
  long long tiles_per_split;
};

template <int TW>
__global__ void __launch_bounds__(HEAD_THREADS, 1)
wgrad_head_tma_kernel(float* __restrict__ part,
                      const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap gmap, HGeom q) {
  extern __shared__ __align__(128) uint8_t smem_h[];
  const uint32_t bars = smem_u32(smem_h);
  const uint32_t full = bars, empty = bars + 8 * MAX_STAGES;
  const uint32_t ring = bars + BAR_BYTES;

  const int co_groups = (q.co + HEAD_COG - 1) / HEAD_COG;
  const int o0 = (blockIdx.x % co_groups) * HEAD_COG;
  const int c0 = (blockIdx.x / co_groups) * CIB;

  const int tiles_w = (q.w + TW - 1) / TW;
  const int tiles_h = (q.h + q.th - 1) / q.th;
  const long long tiles = (long long)q.n * q.d * tiles_h * tiles_w;
  const long long first = (long long)blockIdx.y * q.tiles_per_split;
  const long long last = min(tiles, first + q.tiles_per_split);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int i = 0; i < q.stages; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, HEAD_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == HEAD_WARPS) {
    // ===================== loader =====================
    if (lane == 0) {
      uint32_t it = 0;
      for (long long t = first; t < last; ++t, ++it) {
        long long rest = t;
        const int w0 = (int)(rest % tiles_w) * TW;
        rest /= tiles_w;
        const int h0 = (int)(rest % tiles_h) * q.th;
        rest /= tiles_h;
        const int ud = (int)(rest % q.d);
        const int nb = (int)(rest / q.d);
        const uint32_t slot = it % q.stages;
        mbar_wait(empty + 8 * slot, ((it / q.stages) & 1) ^ 1);
        const uint32_t bar = full + 8 * slot;
        const uint32_t dst = ring + slot * q.stage;
        mbar_expect_tx(bar, q.x_bytes + q.g_bytes);
        tma_load_5d(dst, &xmap, bar, w0, h0, c0, ud, nb);
        tma_load_5d(dst + q.x_bytes, &gmap, bar, w0 - G_LEFT, h0 - HALO, o0,
                    ud - HALO, nb);
      }
    }
    return;
  }

  // ===================== consumers =====================
  // warp (kd, row parity) runs the K steps of its tile rows for all 5 kh,
  // both m16 tiles and both n8 tiles; the two warps of a kd add up at the
  // end
  const int kd = warp >> 1;
  const int rp = warp & 1;
  const int r = lane >> 2;
  const int p = lane & 3;
  // the thread's two B columns (one per n8 tile) share their two g words:
  // rows 0-5 hold (co, kw even) and (co, kw + 1), read from the words
  // at kw and one left of it; row 6 holds kw = 4 of channels 0 and 1, row
  // 7 kw = 4 of channel 2 and the padding column
  const bool pair = r < 6;
  const int co_u = pair ? r >> 1 : (r == 6 ? 0 : 2);
  const int co_v = pair ? r >> 1 : (r == 6 ? 1 : 2);
  const int kwe = pair ? 2 * (r & 1) : KS - 1;
  const uint32_t sel0 = pair ? 0x7654u : 0x3210u;  // tile 0: v, or u
  const uint32_t sel1 = pair ? 0x5432u : 0x7654u;  // tile 1: u:v, or v
  const uint32_t mask1 = r == 7 ? 0u : 0xffffffffu;
  const int xc = q.xrows * q.xw / 2;  // words between x channels
  const int xrw = q.xw / 2;           // words between x rows
  const int gc = q.grows * q.gw / 2;  // words between g channels
  const int grw = q.gw / 2;
  const int gdw = HEAD_COG * gc;      // words between g depths
  const int xoff = r * xc + p;
  // voxel (row, w0 + 2p) at tap (kd, kh = 0, kwe) reads g box depth 4 - kd,
  // row row + 4, column 2p + G_LEFT + 2 - kwe: word p + (10 - kwe) / 2
  const int gbase = (2 * HALO - kd) * gdw + 2 * HALO * grw + p +
                    (G_LEFT + HALO - kwe) / 2;
  const int off_u = gbase + co_u * gc - (pair ? 1 : 0);
  const int off_v = gbase + co_v * gc;

  float acc[KS][2][2][4];
#pragma unroll
  for (int k = 0; k < KS; ++k)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[k][m][f][e] = 0.f;

  uint32_t it = 0;
  for (long long t = first; t < last; ++t, ++it) {
    const uint32_t slot = it % q.stages;
    mbar_wait(full + 8 * slot, (it / q.stages) & 1);
    const uint32_t* xs =
        reinterpret_cast<const uint32_t*>(smem_h + BAR_BYTES + slot * q.stage) +
        xoff;
    const uint32_t* gs = reinterpret_cast<const uint32_t*>(
        smem_h + BAR_BYTES + slot * q.stage + q.x_bytes);
#pragma unroll 1
    for (int row = rp; row < q.th; row += 2) {
#pragma unroll
      for (int ws = 0; ws < TW; ws += 16) {
        const uint32_t* xr = xs + row * xrw + ws / 2;
        uint32_t a[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          a[m][0] = xr[m * 16 * xc];
          a[m][1] = xr[m * 16 * xc + 8 * xc];
          a[m][2] = xr[m * 16 * xc + 4];
          a[m][3] = xr[m * 16 * xc + 8 * xc + 4];
        }
        const int grow = row * grw + ws / 2;
#pragma unroll
        for (int kh = 0; kh < KS; ++kh) {
          const uint32_t* gu = gs + off_u + grow - kh * grw;
          const uint32_t* gv = gs + off_v + grow - kh * grw;
          const uint32_t u0 = gu[0], v0 = gv[0], u1 = gu[4], v1 = gv[4];
          const uint32_t b00 = __byte_perm(u0, v0, sel0);
          const uint32_t b01 = __byte_perm(u1, v1, sel0);
          const uint32_t b10 = __byte_perm(u0, v0, sel1) & mask1;
          const uint32_t b11 = __byte_perm(u1, v1, sel1) & mask1;
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            mma_bf16(acc[kh][m][0], a[m][0], a[m][1], a[m][2], a[m][3], b00,
                     b01);
            mma_bf16(acc[kh][m][1], a[m][0], a[m][1], a[m][2], a[m][3], b10,
                     b11);
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * slot);
  }

  // the odd-row warps hand their sums to the even-row warps through the
  // ring (every copy has landed and been consumed), which add them in a
  // fixed order; then the accumulator fragment: rows lane / 4 and + 8
  // (ci), column 2 * (lane % 4) + {0, 1} of n8 tile f, the (co, kw) of
  // that column's thread row
  float* red = reinterpret_cast<float*>(smem_h + BAR_BYTES) +
               (size_t)kd * (KS * 2 * 2 * 4) * 32 + lane;
  constexpr int NACC = KS * 2 * 2 * 4;
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * HEAD_WARPS) : "memory");
  if (rp == 1) {
#pragma unroll
    for (int i = 0; i < NACC; ++i) red[i * 32] = (&acc[0][0][0][0])[i];
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * HEAD_WARPS) : "memory");
  if (rp == 1) return;
#pragma unroll
  for (int i = 0; i < NACC; ++i) (&acc[0][0][0][0])[i] += red[i * 32];

  const size_t size = (size_t)KS * KS * KS * q.ci * q.co;
  float* out = part + (size_t)blockIdx.y * size;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    // the column's thread row: lane 4 * rr + p holds column rr
    const int rr = 2 * p + (e & 1);
    const bool cpair = rr < 6;
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      const int co_l = cpair ? rr >> 1 : (rr == 6 ? f : 2);
      const int kw = cpair ? 2 * (rr & 1) + f : KS - 1;
      const int co = o0 + co_l;
      if ((rr == 7 && f == 1) || co >= q.co) continue;
#pragma unroll
      for (int kh = 0; kh < KS; ++kh)
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int ci = c0 + m * 16 + r + (e >> 1) * 8;
          if (ci < q.ci)
            out[(((size_t)(kd * KS + kh) * KS + kw) * q.ci + ci) * q.co + co] =
                acc[kh][m][f][e];
        }
    }
  }
}

// out[i] = sum over the partials of part[p][i], in the order p = 0, 1, ...
__global__ void wgrad_tma_reduce_kernel(const float* __restrict__ part,
                                        float* __restrict__ out, int parts,
                                        long long size) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size) return;
  float s = 0.f;
  for (int p = 0; p < parts; ++p) s += part[(size_t)p * size + i];
  out[i] = s;
}

// cuTensorMapEncodeTiled through the runtime (no link against libcuda).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &status) == cudaSuccess &&
        status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The tensor map of a bf16 [N, D, C, H, W] view as (w, h, c, d, n) with a
// [1][depths][chans][rows][cols] box. False when the view cannot be
// described (base or strides not multiples of 16 bytes).
bool make_tmap(CUtensorMap* map, const void* base, int n, int d, int c, int h,
               int w, long long s_n, long long s_c, long long s_d, long long s_h,
               int rows, int cols, int chans = CIB, int depths = 1) {
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr || reinterpret_cast<uintptr_t>(base) % 16) return false;
  const cuuint64_t dims[5] = {(cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)c,
                              (cuuint64_t)d, (cuuint64_t)n};
  const cuuint64_t strides[4] = {(cuuint64_t)s_h * 2, (cuuint64_t)s_c * 2,
                                 (cuuint64_t)s_d * 2, (cuuint64_t)s_n * 2};
  const cuuint32_t box[5] = {(cuuint32_t)cols, (cuuint32_t)rows,
                             (cuuint32_t)chans, (cuuint32_t)depths, 1};
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  for (int i = 0; i < 4; ++i)
    if (strides[i] == 0 || strides[i] % 16) return false;
  if (cols > 256 || rows > 256 || cols % 8) return false;
  memset(map, 0, sizeof(*map));
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(base),
             dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int TW>
cudaError_t launch_tma(const CUtensorMap& xmap, const CUtensorMap& gmap,
                       float* part, float* out, int splits, const TGeom& q,
                       cudaStream_t s) {
  const long long chan_blocks =
      (long long)KS * ((q.ci + CIB - 1) / CIB) * ((q.co + COB - 1) / COB);
  const size_t smem = BAR_BYTES + (size_t)q.stages * q.stage;
  if (chan_blocks > 0x7fffffffLL || splits > 65535 || smem > 227 * 1024)
    return cudaErrorInvalidValue;
  auto kern = wgrad_tma_kernel<TW>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  float* dst = splits == 1 ? out : part;
  kern<<<dim3((unsigned)chan_blocks, splits), THREADS, smem, s>>>(dst, xmap, gmap,
                                                                   q);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const long long size = (long long)KS * KS * KS * q.ci * q.co;
  wgrad_tma_reduce_kernel<<<(unsigned)((size + 255) / 256), 256, 0, s>>>(
      part, out, splits, size);
  return cudaGetLastError();
}


template <int TW>
cudaError_t launch_head_tma(const CUtensorMap& xmap, const CUtensorMap& gmap,
                            float* part, float* out, int splits,
                            const HGeom& q, cudaStream_t s) {
  const long long chan_blocks = (long long)((q.ci + CIB - 1) / CIB) *
                                ((q.co + HEAD_COG - 1) / HEAD_COG);
  const size_t smem = BAR_BYTES + (size_t)q.stages * q.stage;
  if (chan_blocks > 0x7fffffffLL || splits > 65535 || smem > 227 * 1024)
    return cudaErrorInvalidValue;
  auto kern = wgrad_head_tma_kernel<TW>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  float* dst = splits == 1 ? out : part;
  kern<<<dim3((unsigned)chan_blocks, splits), HEAD_THREADS, smem, s>>>(
      dst, xmap, gmap, q);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const long long size = (long long)KS * KS * KS * q.ci * q.co;
  wgrad_tma_reduce_kernel<<<(unsigned)((size + 255) / 256), 256, 0, s>>>(
      part, out, splits, size);
  return cudaGetLastError();
}

}  // namespace

// Launches the bf16 weight gradient fed by tensor copies on `stream`: a th x
// tw voxel tile (tw 8, 16 or 32; th even), an x box of xrows x xw and a g box
// of grows x gw (rows x columns, 32 channels; each an odd number of 16-byte
// units per channel, the x box covering columns tw0 - 8 .. and rows th0 - 2
// ..), a ring of `stages` (3 to 8) stages, the (n, d, tile) list dealt to
// `splits` blocks. `part` is f32 scratch of splits * 125 * ci * co elements
// (unused when splits == 1), `out` the f32 [5, 5, 5, ci, co] result. Returns
// cudaGetLastError() after the launches (0 on success), cudaErrorInvalidValue
// for a geometry or a view the kernel does not take.
extern "C" int conv5_wgrad_tma_launch(
    const void* x, const void* g, void* part, void* out, int th, int tw,
    int xrows, int xw, int grows, int gw, int stages, int splits, int n, int d,
    int ci, int h, int w, int co, long long xs_n, long long xs_c, long long xs_d,
    long long xs_h, long long gs_n, long long gs_c, long long gs_d,
    long long gs_h, void* stream) {
  if (th < 2 || th % 2 || splits < 1 || stages < 3 || stages > MAX_STAGES ||
      xrows < th + 2 * HALO || xw < tw + X_LEFT + HALO || grows < th ||
      gw < tw || ((xrows * xw / 8) & 1) == 0 || ((grows * gw / 8) & 1) == 0)
    return cudaErrorInvalidValue;
  CUtensorMap xmap, gmap;
  if (!make_tmap(&xmap, x, n, d, ci, h, w, xs_n, xs_c, xs_d, xs_h, xrows, xw) ||
      !make_tmap(&gmap, g, n, d, co, h, w, gs_n, gs_c, gs_d, gs_h, grows, gw))
    return cudaErrorInvalidValue;
  const long long tiles = (long long)n * d * ((h + th - 1) / th) *
                          ((w + tw - 1) / tw);
  const long long per = (tiles + splits - 1) / splits;
  const uint32_t x_bytes = (uint32_t)(CIB * xrows * xw * 2);
  const uint32_t g_bytes = (uint32_t)(COB * grows * gw * 2);
  const TGeom q{n, d, ci, h, w, co, th, xrows, xw, grows, gw, stages, x_bytes,
                x_bytes + g_bytes, per};
  float* pf = static_cast<float*>(part);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tw) {
    case 8: return launch_tma<8>(xmap, gmap, pf, of, splits, q, s);
    case 16: return launch_tma<16>(xmap, gmap, pf, of, splits, q, s);
    case 32: return launch_tma<32>(xmap, gmap, pf, of, splits, q, s);
    default: return cudaErrorInvalidValue;
  }
}

// Launches the bf16 weight gradient of a narrow head (Co <= 16) fed by
// tensor copies on `stream`: a th x tw voxel tile (tw 16 or 32), an x box
// of xrows x xw (32 channels, at the tile; an odd number of 16-byte units
// per channel) and a g box of grows x gw (3 channels x 5 depths, covering
// rows th0 - 2 .. and columns tw0 - 8 ..), a ring of `stages` (2 to 8), the
// (n, d, tile) list dealt to `splits` blocks. `part` is f32 scratch of
// splits * 125 * ci * co elements (unused when splits == 1), `out` the f32
// [5, 5, 5, ci, co] result. Returns cudaGetLastError() after the launches
// (0 on success), cudaErrorInvalidValue for a geometry or a view the kernel
// does not take.
extern "C" int conv5_wgrad_head_tma_launch(
    const void* x, const void* g, void* part, void* out, int th, int tw,
    int xrows, int xw, int grows, int gw, int stages, int splits, int n, int d,
    int ci, int h, int w, int co, long long xs_n, long long xs_c, long long xs_d,
    long long xs_h, long long gs_n, long long gs_c, long long gs_d,
    long long gs_h, void* stream) {
  if (th < 1 || splits < 1 || stages < 2 || stages > MAX_STAGES || co < 1 ||
      co > 16 || xrows < th || xw < tw || grows < th + 2 * HALO ||
      gw < tw + G_LEFT + HALO || ((xrows * xw / 8) & 1) == 0)
    return cudaErrorInvalidValue;
  CUtensorMap xmap, gmap;
  if (!make_tmap(&xmap, x, n, d, ci, h, w, xs_n, xs_c, xs_d, xs_h, xrows, xw) ||
      !make_tmap(&gmap, g, n, d, co, h, w, gs_n, gs_c, gs_d, gs_h, grows, gw,
                 HEAD_COG, KS))
    return cudaErrorInvalidValue;
  const long long tiles = (long long)n * d * ((h + th - 1) / th) *
                          ((w + tw - 1) / tw);
  const long long per = (tiles + splits - 1) / splits;
  const uint32_t x_bytes = (uint32_t)(CIB * xrows * xw * 2);
  const uint32_t g_bytes = (uint32_t)(KS * HEAD_COG * grows * gw * 2);
  const uint32_t stage = (x_bytes + g_bytes + 127) / 128 * 128;
  const HGeom q{n, d, ci, h, w, co, th, xrows, xw, grows, gw, stages, x_bytes,
                g_bytes, stage, per};
  float* pf = static_cast<float*>(part);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tw) {
    case 16: return launch_head_tma<16>(xmap, gmap, pf, of, splits, q, s);
    case 32: return launch_head_tma<32>(xmap, gmap, pf, of, splits, q, s);
    default: return cudaErrorInvalidValue;
  }
}
