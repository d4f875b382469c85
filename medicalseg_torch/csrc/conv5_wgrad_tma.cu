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
// element strides for N, C, D and H; W is the contiguous axis. The tensor
// copy takes views that start on 16 bytes with every other stride a
// multiple of 8 elements (the wrapper's gate, ops/conv5.py:
// conv5_wgrad_form: 'tma', 'head_tma'); the software producer below takes
// any other W-contiguous bf16 view ('ragged', 'head_ragged').
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
// Views a tensor copy cannot describe (rows of 18, 24, 8 or 4 bytes: W = 9,
// 12, 4, 2; a base off 16 bytes; a channel slice) take the same kernels
// with another producer (template argument PW > 0): PW warps fill the same
// boxes, byte for byte, from any W-contiguous view, and zero whatever lies
// outside the volume or the channel range, as the tensor copy does. The
// ring is zeroed once at the start and a producer writes only the box
// columns that some tile of the launch can hold in-range data in (all of
// them where W spans several tiles), so the zeros of the always-padding
// columns and channels cost nothing per stage. A unit is 4 columns of one
// box row of one channel plane. Each thread owns a fixed (row, unit)
// position, neighbouring threads neighbouring rows of a plane (a warp's
// copies of a plane are one run of memory), and a range of planes, which
// it walks with constant strides after finding the row's validity once a
// stage: where the view's rows start on 8 (or 4) bytes, one 8-byte (two
// 4-byte) cp.async a unit with a source size that zero-fills the rest;
// elsewhere (odd W, a base off 4 bytes) the aligned 32-bit words that hold
// the unit, realigned with __byte_perm and stored with st.shared, eight
// planes' loads in flight before their stores. A producer thread commits
// its copies of a stage as a group and waits for the group before; then
// lane 0 arrives for its warp on that earlier stage's full barrier (count
// PW). The address arithmetic per unit, not the copies, bounded the first
// form of this producer (PERF.md). The consumers, the barrier protocol,
// the split and the reduce are the tensor-copy path's, so both give the
// same bits on a view both can take.
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
// threads of a block: the consumer warps and the producer's (PW software
// producer warps, or one loader warp for the tensor copy, PW = 0)
constexpr int threads_for(int pw) { return 32 * (2 * KS + (pw > 0 ? pw : 1)); }
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

// The software producer's source: two W-contiguous bf16 views by element
// strides (n, c, d, h), how each is copied (vec: 8 or 4 for cp.async of 8 or
// 4 bytes where every row starts on that many bytes, 0 for aligned 32-bit
// loads realigned with __byte_perm) and the box columns [c0, c1) written
// (multiples of 4).
struct Soft {
  const uint16_t* x;
  const uint16_t* g;
  long long xs[4], gs[4];
  int xvec, gvec;
  int xc0, xc1, gc0, gc1;
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

// ---- the software producer ----
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, int cp,
                                         int bytes) {
  if (cp == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
                 "l"(src), "r"(bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(src), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void st_shared2(uint32_t dst, uint32_t a, uint32_t b) {
  asm volatile("st.shared.v2.u32 [%0], {%1, %2};\n" ::"r"(dst), "r"(a), "r"(b)
               : "memory");
}

// the first n (<= 0, 1, >= 2) bf16 halves of a word, the rest zero
__device__ __forceinline__ uint32_t keep(uint32_t v, int n) {
  return n >= 2 ? v : (n == 1 ? v & 0xffffu : 0u);
}

// One box of a stage as the tensor copy lays it out: [ndep depths][nch
// channels][rows][cols] bf16, element (dep, ch, r, col) from (d0 + dep, c0 +
// ch, h0 + r, w0 + col), zero outside the view; the producer writes columns
// [cs, ce).
struct Box {
  int d0, c0, h0, rows, w0, cols, cs, ce;
};

constexpr int UNITS = 8;  // planes a thread has in flight with realigned loads

// Copies one unit (4 columns, n of them in range, n <= 0: none) from src to
// the shared address dst: cp.async of 8 or 4 bytes with a source size (the
// rest zero-filled), or (VEC 0) the aligned 32-bit words that hold it (two
// where its first element is even, three where it is odd; only words that
// hold an element in range are read), realigned with __byte_perm.
template <int VEC>
__device__ __forceinline__ void unit_copy(uint32_t dst, const uint16_t* src,
                                          const uint16_t* base, int n) {
  if constexpr (VEC == 8) {
    cp_async(dst, n > 0 ? src : base, 8, 2 * max(n, 0));
  } else {
    cp_async(dst, n > 0 ? src : base, 4, 2 * min(max(n, 0), 2));
    cp_async(dst + 4, n > 2 ? src + 2 : base, 4, 2 * max(n - 2, 0));
  }
}

// Fills the box columns [b.cs, b.ce) of every channel that exists (the
// others stay zero), rows in and out of range, at shared address dst, from
// `base` with strides s (n, c, d, h) and extents n_d, n_c, n_h, n_w;
// producer thread pt of PT. A unit is 4 columns of one row of one plane
// (depth, channel). A thread owns a fixed (row, unit) position and a range
// of planes: per stage it finds the row's validity and the unit's in-range
// count once, then walks the planes with constant strides.
template <int PT, int VEC, int NDEP, int NCH>
__device__ __forceinline__ void soft_box(uint32_t dst, const uint16_t* base,
                                         const long long (&s)[4], int nb, int n_d,
                                         int n_c, int n_h, int n_w, const Box& b,
                                         int pt) {
  constexpr int PLANES = NDEP * NCH;
  const int nu = (b.ce - b.cs) >> 2;
  const int positions = b.rows * nu;
  const int groups = max(1, min(PLANES, PT / positions));  // plane ranges
  const int nch = min(NCH, n_c - b.c0);                    // channels that exist
  const uint32_t plane_bytes = (uint32_t)(b.rows * b.cols * 2);
  const long long tile = nb * s[0] + (long long)b.c0 * s[1] +
                         (long long)b.d0 * s[2];
  for (int item = pt; item < positions * groups; item += PT) {
    // neighbouring threads take neighbouring positions of one plane range:
    // a warp's copies of a plane are one run of rows, few sectors
    const int grp = item / positions, pos = item - grp * positions;
    const int r = pos / nu, col = b.cs + 4 * (pos - r * nu);
    const int h = b.h0 + r, w = b.w0 + col;
    const int nrow = h >= 0 && h < n_h && w >= 0 ? max(0, min(4, n_w - w)) : 0;
    const int p0 = grp * PLANES / groups;
    const int p1 = NDEP == 1 ? min((grp + 1) * PLANES / groups, nch)
                             : (grp + 1) * PLANES / groups;
    // the plane p0: its depth and channel, its source and destination
    int dep = p0 / NCH, ch = p0 - dep * NCH;
    const uint16_t* src = base + (tile + (long long)h * s[3] + w +
                                  ch * s[1] + dep * s[2]);
    uint32_t pdst = dst + (uint32_t)((r * b.cols + col) * 2) + p0 * plane_bytes;
    const long long next_dep = s[2] - NCH * s[1];
    if constexpr (VEC != 0) {
      for (int p = p0; p < p1; ++p) {
        const int dd = b.d0 + dep;
        const int n = ch < nch && dd >= 0 && dd < n_d ? nrow : 0;
        if (ch < nch) unit_copy<VEC>(pdst, src, base, n);
        pdst += plane_bytes;
        src += s[1];
        if (NDEP > 1 && ++ch == NCH) {
          ch = 0;
          ++dep;
          src += next_dep;
        }
      }
    } else {
      for (int pb = p0; pb < p1; pb += UNITS) {
        uint32_t v[UNITS][3];
        int ns[UNITS];
        bool odd[UNITS];
#pragma unroll
        for (int k = 0; k < UNITS; ++k) {
          const int dd = b.d0 + dep;
          ns[k] = pb + k < p1 && ch < nch ? (dd >= 0 && dd < n_d ? nrow : 0) : -1;
          const int n = ns[k];
          const uintptr_t a = reinterpret_cast<uintptr_t>(src);
          odd[k] = (a & 2) != 0;
          const uint32_t* wp = reinterpret_cast<const uint32_t*>(a & ~uintptr_t(3));
          v[k][0] = n >= 1 ? __ldg(wp) : 0u;
          v[k][1] = (odd[k] ? n >= 2 : n >= 3) ? __ldg(wp + 1) : 0u;
          v[k][2] = odd[k] && n >= 4 ? __ldg(wp + 2) : 0u;
          src += s[1];
          if (NDEP > 1 && ++ch == NCH) {
            ch = 0;
            ++dep;
            src += next_dep;
          }
        }
#pragma unroll
        for (int k = 0; k < UNITS; ++k) {
          if (ns[k] >= 0) {
            const uint32_t lo =
                odd[k] ? __byte_perm(v[k][0], v[k][1], 0x5432) : v[k][0];
            const uint32_t hi =
                odd[k] ? __byte_perm(v[k][1], v[k][2], 0x5432) : v[k][1];
            st_shared2(pdst, keep(lo, ns[k]), keep(hi, ns[k] - 2));
          }
          pdst += plane_bytes;
        }
      }
    }
  }
}

template <int PT, int NDEP, int NCH>
__device__ __forceinline__ void soft_fill(uint32_t dst, const uint16_t* base,
                                          const long long (&s)[4], int vec, int nb,
                                          int n_d, int n_c, int n_h, int n_w,
                                          const Box& b, int pt) {
  if (vec == 8)
    soft_box<PT, 8, NDEP, NCH>(dst, base, s, nb, n_d, n_c, n_h, n_w, b, pt);
  else if (vec == 4)
    soft_box<PT, 4, NDEP, NCH>(dst, base, s, nb, n_d, n_c, n_h, n_w, b, pt);
  else
    soft_box<PT, 0, NDEP, NCH>(dst, base, s, nb, n_d, n_c, n_h, n_w, b, pt);
}

// A producer warp's waits and arrivals. Its lane 0 waits for a slot to be
// free (the warp follows); after filling a stage each thread commits its
// copies as a group, waits until all but this stage's group have landed,
// and lane 0 arrives once for the warp on the previous stage's full
// barrier (count: PW), which releases the warp's copies and stores;
// soft_last arrives for the last stage.
__device__ __forceinline__ void soft_wait(uint32_t bar, uint32_t parity) {
  if ((threadIdx.x & 31) == 0) mbar_wait(bar, parity);
  __syncwarp();
}

constexpr uint32_t NO_STAGE = 0xffffffffu;  // no shared address

__device__ __forceinline__ void soft_arrive(uint32_t bar, uint32_t& prev) {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  if (prev != NO_STAGE) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(prev);
  }
  prev = bar;
}

__device__ __forceinline__ void soft_last(uint32_t prev) {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();
  if (prev != NO_STAGE && (threadIdx.x & 31) == 0) mbar_arrive(prev);
}

// Zeroes the ring once (the columns and channels no producer writes stay
// zero), before the barriers are set up.
__device__ __forceinline__ void zero_ring(uint8_t* ring, uint32_t bytes) {
  uint4* r4 = reinterpret_cast<uint4*>(ring);
  for (uint32_t i = threadIdx.x; i < bytes / 16; i += blockDim.x)
    r4[i] = make_uint4(0u, 0u, 0u, 0u);
}

// The tile after (wi, hi, od, nb) in the (n, d, tile row, tile column)
// order of the voxel split: a producer walks its tiles without dividing.
__device__ __forceinline__ void next_tile(int& wi, int& hi, int& od, int& nb,
                                          int tiles_w, int tiles_h, int d) {
  if (++wi < tiles_w) return;
  wi = 0;
  if (++hi < tiles_h) return;
  hi = 0;
  if (++od < d) return;
  od = 0;
  ++nb;
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

template <int TW, int PW>
__global__ void __launch_bounds__(threads_for(PW), 1)
wgrad_tma_kernel(float* __restrict__ part, const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap gmap, const __grid_constant__ Soft src,
                 TGeom q) {
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
  if constexpr (PW > 0) zero_ring(smem_t + BAR_BYTES, q.stages * q.stage);
  if (threadIdx.x == 0) {
    for (int i = 0; i < q.stages; ++i) {
      mbar_init(full + 8 * i, PW > 0 ? PW : 1);
      mbar_init(empty + 8 * i, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {
    // ============== producer: tensor copies, or PW warps ==============
    const int pt = threadIdx.x - 32 * CONSUMER_WARPS;
    if (PW == 0 && pt != 0) return;
    uint32_t it = 0, prev = NO_STAGE;
    int wi = (int)(first % tiles_w), hi = (int)(first / tiles_w % tiles_h);
    int od = (int)(first / tiles_w / tiles_h % q.d);
    int nb = (int)(first / tiles_w / tiles_h / q.d);
    for (long long t = first; t < last;
         ++t, next_tile(wi, hi, od, nb, tiles_w, tiles_h, q.d)) {
      const int w0 = wi * TW, h0 = hi * q.th;
      const int id = od + kd - HALO;
      if (id < 0 || id >= q.d) continue;  // only padding: the consumers skip it too
      const uint32_t slot = it % q.stages;
      if constexpr (PW == 0)
        mbar_wait(empty + 8 * slot, ((it / q.stages) & 1) ^ 1);
      else
        soft_wait(empty + 8 * slot, ((it / q.stages) & 1) ^ 1);
      const uint32_t bar = full + 8 * slot;
      const uint32_t dst = ring + slot * q.stage;
      if constexpr (PW == 0) {
        mbar_expect_tx(bar, q.stage);
        tma_load_5d(dst, &xmap, bar, w0 - X_LEFT, h0 - HALO, c0, id, nb);
        tma_load_5d(dst + q.x_bytes, &gmap, bar, w0, h0, o0, od, nb);
      } else {
        const Box xb{id, c0, h0 - HALO, q.xrows, w0 - X_LEFT, q.xw, src.xc0,
                     src.xc1};
        const Box gb{od, o0, h0, q.grows, w0, q.gw, src.gc0, src.gc1};
        soft_fill<32 * PW, 1, CIB>(dst, src.x, src.xs, src.xvec, nb, q.d, q.ci,
                                   q.h, q.w, xb, pt);
        soft_fill<32 * PW, 1, COB>(dst + q.x_bytes, src.g, src.gs, src.gvec, nb,
                                   q.d, q.co, q.h, q.w, gb, pt);
        soft_arrive(bar, prev);
      }
      ++it;
    }
    if constexpr (PW > 0) soft_last(prev);
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
constexpr int HEAD_WARPS = 2 * KS;      // (kd, row parity): threads_for(PW) too
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

template <int TW, int PW>
__global__ void __launch_bounds__(threads_for(PW), 1)
wgrad_head_tma_kernel(float* __restrict__ part,
                      const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap gmap,
                      const __grid_constant__ Soft src, HGeom q) {
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
  if constexpr (PW > 0) zero_ring(smem_h + BAR_BYTES, q.stages * q.stage);
  if (threadIdx.x == 0) {
    for (int i = 0; i < q.stages; ++i) {
      mbar_init(full + 8 * i, PW > 0 ? PW : 1);
      mbar_init(empty + 8 * i, HEAD_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= HEAD_WARPS) {
    // ============== producer: tensor copies, or PW warps ==============
    const int pt = threadIdx.x - 32 * HEAD_WARPS;
    if (PW == 0 && pt != 0) return;
    uint32_t it = 0, prev = NO_STAGE;
    int wi = (int)(first % tiles_w), hi = (int)(first / tiles_w % tiles_h);
    int ud = (int)(first / tiles_w / tiles_h % q.d);
    int nb = (int)(first / tiles_w / tiles_h / q.d);
    for (long long t = first; t < last;
         ++t, ++it, next_tile(wi, hi, ud, nb, tiles_w, tiles_h, q.d)) {
      const int w0 = wi * TW, h0 = hi * q.th;
      const uint32_t slot = it % q.stages;
      if constexpr (PW == 0)
        mbar_wait(empty + 8 * slot, ((it / q.stages) & 1) ^ 1);
      else
        soft_wait(empty + 8 * slot, ((it / q.stages) & 1) ^ 1);
      const uint32_t bar = full + 8 * slot;
      const uint32_t dst = ring + slot * q.stage;
      if constexpr (PW == 0) {
        mbar_expect_tx(bar, q.x_bytes + q.g_bytes);
        tma_load_5d(dst, &xmap, bar, w0, h0, c0, ud, nb);
        tma_load_5d(dst + q.x_bytes, &gmap, bar, w0 - G_LEFT, h0 - HALO, o0,
                    ud - HALO, nb);
      } else {
        const Box xb{ud, c0, h0, q.xrows, w0, q.xw, src.xc0, src.xc1};
        const Box gb{ud - HALO, o0, h0 - HALO, q.grows, w0 - G_LEFT, q.gw, src.gc0,
                     src.gc1};
        soft_fill<32 * PW, 1, CIB>(dst, src.x, src.xs, src.xvec, nb, q.d, q.ci,
                                   q.h, q.w, xb, pt);
        soft_fill<32 * PW, KS, HEAD_COG>(dst + q.x_bytes, src.g, src.gs, src.gvec,
                                         nb, q.d, q.co, q.h, q.w, gb, pt);
        soft_arrive(bar, prev);
      }
    }
    if constexpr (PW > 0) soft_last(prev);
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

// One launch of kernel `kern` (threads a block `threads`) and, where the
// voxel axis is split, the fixed-order reduce of its partials.
template <typename Kern, typename Geom>
cudaError_t launch_with_reduce(Kern kern, int threads, long long chan_blocks,
                               const CUtensorMap& xmap, const CUtensorMap& gmap,
                               const Soft& src, float* part, float* out, int splits,
                               const Geom& q, cudaStream_t s) {
  const size_t smem = BAR_BYTES + (size_t)q.stages * q.stage;
  if (chan_blocks > 0x7fffffffLL || splits > 65535 || smem > 227 * 1024)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  float* dst = splits == 1 ? out : part;
  kern<<<dim3((unsigned)chan_blocks, splits), threads, smem, s>>>(dst, xmap, gmap,
                                                                 src, q);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const long long size = (long long)KS * KS * KS * q.ci * q.co;
  wgrad_tma_reduce_kernel<<<(unsigned)((size + 255) / 256), 256, 0, s>>>(
      part, out, splits, size);
  return cudaGetLastError();
}

template <int TW, int PW>
cudaError_t launch_tma(const CUtensorMap& xmap, const CUtensorMap& gmap,
                       const Soft& src, float* part, float* out, int splits,
                       const TGeom& q, cudaStream_t s) {
  const long long chan_blocks =
      (long long)KS * ((q.ci + CIB - 1) / CIB) * ((q.co + COB - 1) / COB);
  return launch_with_reduce(wgrad_tma_kernel<TW, PW>, threads_for(PW), chan_blocks,
                            xmap, gmap, src, part, out, splits, q, s);
}

template <int TW, int PW>
cudaError_t launch_head_tma(const CUtensorMap& xmap, const CUtensorMap& gmap,
                            const Soft& src, float* part, float* out, int splits,
                            const HGeom& q, cudaStream_t s) {
  const long long chan_blocks = (long long)((q.ci + CIB - 1) / CIB) *
                                ((q.co + HEAD_COG - 1) / HEAD_COG);
  return launch_with_reduce(wgrad_head_tma_kernel<TW, PW>, threads_for(PW),
                            chan_blocks, xmap, gmap, src, part, out, splits, q, s);
}

// The launch for producer warps `pw` (0: the tensor copy) and tile width tw.
template <int PW>
cudaError_t launch_tma_pw(int tw, const CUtensorMap& xmap, const CUtensorMap& gmap,
                          const Soft& src, float* part, float* out, int splits,
                          const TGeom& q, cudaStream_t s) {
  switch (tw) {
    case 8: return launch_tma<8, PW>(xmap, gmap, src, part, out, splits, q, s);
    case 16: return launch_tma<16, PW>(xmap, gmap, src, part, out, splits, q, s);
    case 32: return launch_tma<32, PW>(xmap, gmap, src, part, out, splits, q, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int PW>
cudaError_t launch_head_pw(int tw, const CUtensorMap& xmap, const CUtensorMap& gmap,
                           const Soft& src, float* part, float* out, int splits,
                           const HGeom& q, cudaStream_t s) {
  switch (tw) {
    case 16: return launch_head_tma<16, PW>(xmap, gmap, src, part, out, splits, q, s);
    case 32: return launch_head_tma<32, PW>(xmap, gmap, src, part, out, splits, q, s);
    default: return cudaErrorInvalidValue;
  }
}

// A view the software producer takes with copies of `vec` bytes: 8 or 4
// where the base and every stride (elements) keep each row on that many
// bytes, 0 (realigned 32-bit loads) for any other bf16 view.
bool vec_ok(const void* base, int vec, const long long (&s)[4]) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(base);
  if (a % 2 || (vec != 0 && vec != 4 && vec != 8)) return false;
  for (int i = 0; i < 4; ++i)
    if (s[i] < 0 || (vec && (s[i] * 2) % vec)) return false;
  return vec == 0 || a % vec == 0;
}

// The columns [c0, c1) a producer writes of a box `cols` wide that starts
// `left` columns left of its tile: multiples of 4, every column that holds
// the view's row in some tile (all of them where W spans several tiles).
bool span_ok(int c0, int c1, int cols, int left, int tw, int w) {
  if (c0 < 0 || c1 > cols || c0 >= c1 || c0 % 4 || c1 % 4) return false;
  if (w > tw) return c0 == 0 && c1 == cols;
  return c0 <= left && c1 >= (left + w < cols ? left + w : cols);
}

Soft make_soft(const void* x, const void* g, const long long (&xs)[4],
               const long long (&gs)[4], int xvec, int gvec, int xc0, int xc1,
               int gc0, int gc1) {
  Soft src{static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(g),
           {xs[0], xs[1], xs[2], xs[3]}, {gs[0], gs[1], gs[2], gs[3]},
           xvec, gvec, xc0, xc1, gc0, gc1};
  return src;
}

TGeom tma_geom(int th, int tw, int xrows, int xw, int grows, int gw, int stages,
               int splits, int n, int d, int ci, int h, int w, int co) {
  const long long tiles = (long long)n * d * ((h + th - 1) / th) *
                          ((w + tw - 1) / tw);
  const long long per = (tiles + splits - 1) / splits;
  const uint32_t x_bytes = (uint32_t)(CIB * xrows * xw * 2);
  const uint32_t g_bytes = (uint32_t)(COB * grows * gw * 2);
  return TGeom{n, d, ci, h, w, co, th, xrows, xw, grows, gw, stages, x_bytes,
               x_bytes + g_bytes, per};
}

bool tma_geom_ok(int th, int tw, int xrows, int xw, int grows, int gw, int stages,
                 int splits) {
  return !(th < 2 || th % 2 || splits < 1 || stages < 3 || stages > MAX_STAGES ||
           xrows < th + 2 * HALO || xw < tw + X_LEFT + HALO || grows < th ||
           gw < tw || ((xrows * xw / 8) & 1) == 0 || ((grows * gw / 8) & 1) == 0);
}

HGeom head_geom(int th, int tw, int xrows, int xw, int grows, int gw, int stages,
                int splits, int n, int d, int ci, int h, int w, int co) {
  const long long tiles = (long long)n * d * ((h + th - 1) / th) *
                          ((w + tw - 1) / tw);
  const long long per = (tiles + splits - 1) / splits;
  const uint32_t x_bytes = (uint32_t)(CIB * xrows * xw * 2);
  const uint32_t g_bytes = (uint32_t)(KS * HEAD_COG * grows * gw * 2);
  const uint32_t stage = (x_bytes + g_bytes + 127) / 128 * 128;
  return HGeom{n, d, ci, h, w, co, th, xrows, xw, grows, gw, stages, x_bytes,
               g_bytes, stage, per};
}

bool head_geom_ok(int th, int tw, int xrows, int xw, int grows, int gw, int stages,
                  int splits, int co) {
  return !(th < 1 || splits < 1 || stages < 2 || stages > MAX_STAGES || co < 1 ||
           co > 16 || xrows < th || xw < tw || grows < th + 2 * HALO ||
           gw < tw + G_LEFT + HALO || ((xrows * xw / 8) & 1) == 0);
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
  if (!tma_geom_ok(th, tw, xrows, xw, grows, gw, stages, splits))
    return cudaErrorInvalidValue;
  CUtensorMap xmap, gmap;
  if (!make_tmap(&xmap, x, n, d, ci, h, w, xs_n, xs_c, xs_d, xs_h, xrows, xw) ||
      !make_tmap(&gmap, g, n, d, co, h, w, gs_n, gs_c, gs_d, gs_h, grows, gw))
    return cudaErrorInvalidValue;
  const TGeom q = tma_geom(th, tw, xrows, xw, grows, gw, stages, splits, n, d, ci,
                           h, w, co);
  const Soft none{};
  return launch_tma_pw<0>(tw, xmap, gmap, none, static_cast<float*>(part),
                          static_cast<float*>(out), splits, q,
                          static_cast<cudaStream_t>(stream));
}

// The same kernel on any W-contiguous bf16 views (the ones a tensor copy
// cannot describe), its boxes filled by `pw` software producer warps (1, 2,
// 4 or 6): x and g copied by `xvec` / `gvec` bytes (8, 4, or 0 for realigned
// 32-bit loads; the view's base and strides must keep rows on that many
// bytes), box columns [xc0, xc1) and [gc0, gc1) written (multiples of 4,
// every column some tile holds in-range data in). Geometry, scratch and
// result as conv5_wgrad_tma_launch.
extern "C" int conv5_wgrad_ragged_launch(
    const void* x, const void* g, void* part, void* out, int th, int tw,
    int xrows, int xw, int grows, int gw, int stages, int splits, int pw,
    int xvec, int gvec, int xc0, int xc1, int gc0, int gc1, int n, int d,
    int ci, int h, int w, int co, long long xs_n, long long xs_c, long long xs_d,
    long long xs_h, long long gs_n, long long gs_c, long long gs_d,
    long long gs_h, void* stream) {
  const long long xs[4] = {xs_n, xs_c, xs_d, xs_h};
  const long long gs[4] = {gs_n, gs_c, gs_d, gs_h};
  if (!tma_geom_ok(th, tw, xrows, xw, grows, gw, stages, splits) ||
      !vec_ok(x, xvec, xs) || !vec_ok(g, gvec, gs) ||
      !span_ok(xc0, xc1, xw, X_LEFT, tw, w) || !span_ok(gc0, gc1, gw, 0, tw, w))
    return cudaErrorInvalidValue;
  CUtensorMap none;
  memset(&none, 0, sizeof(none));
  const Soft src = make_soft(x, g, xs, gs, xvec, gvec, xc0, xc1, gc0, gc1);
  const TGeom q = tma_geom(th, tw, xrows, xw, grows, gw, stages, splits, n, d, ci,
                           h, w, co);
  float* pf = static_cast<float*>(part);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pw) {
    case 1: return launch_tma_pw<1>(tw, none, none, src, pf, of, splits, q, s);
    case 2: return launch_tma_pw<2>(tw, none, none, src, pf, of, splits, q, s);
    case 4: return launch_tma_pw<4>(tw, none, none, src, pf, of, splits, q, s);
    case 6: return launch_tma_pw<6>(tw, none, none, src, pf, of, splits, q, s);
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
  if (!head_geom_ok(th, tw, xrows, xw, grows, gw, stages, splits, co))
    return cudaErrorInvalidValue;
  CUtensorMap xmap, gmap;
  if (!make_tmap(&xmap, x, n, d, ci, h, w, xs_n, xs_c, xs_d, xs_h, xrows, xw) ||
      !make_tmap(&gmap, g, n, d, co, h, w, gs_n, gs_c, gs_d, gs_h, grows, gw,
                 HEAD_COG, KS))
    return cudaErrorInvalidValue;
  const HGeom q = head_geom(th, tw, xrows, xw, grows, gw, stages, splits, n, d,
                            ci, h, w, co);
  const Soft none{};
  return launch_head_pw<0>(tw, xmap, gmap, none, static_cast<float*>(part),
                           static_cast<float*>(out), splits, q,
                           static_cast<cudaStream_t>(stream));
}

// The narrow head's kernel on any W-contiguous bf16 views, its boxes filled
// by `pw` software producer warps; the producer's arguments as
// conv5_wgrad_ragged_launch (the g box starts 8 columns left of its tile),
// the rest as conv5_wgrad_head_tma_launch.
extern "C" int conv5_wgrad_head_ragged_launch(
    const void* x, const void* g, void* part, void* out, int th, int tw,
    int xrows, int xw, int grows, int gw, int stages, int splits, int pw,
    int xvec, int gvec, int xc0, int xc1, int gc0, int gc1, int n, int d,
    int ci, int h, int w, int co, long long xs_n, long long xs_c, long long xs_d,
    long long xs_h, long long gs_n, long long gs_c, long long gs_d,
    long long gs_h, void* stream) {
  const long long xs[4] = {xs_n, xs_c, xs_d, xs_h};
  const long long gs[4] = {gs_n, gs_c, gs_d, gs_h};
  if (!head_geom_ok(th, tw, xrows, xw, grows, gw, stages, splits, co) ||
      !vec_ok(x, xvec, xs) || !vec_ok(g, gvec, gs) ||
      !span_ok(xc0, xc1, xw, 0, tw, w) || !span_ok(gc0, gc1, gw, G_LEFT, tw, w))
    return cudaErrorInvalidValue;
  CUtensorMap none;
  memset(&none, 0, sizeof(none));
  const Soft src = make_soft(x, g, xs, gs, xvec, gvec, xc0, xc1, gc0, gc1);
  const HGeom q = head_geom(th, tw, xrows, xw, grows, gw, stages, splits, n, d,
                            ci, h, w, co);
  float* pf = static_cast<float*>(part);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pw) {
    case 1: return launch_head_pw<1>(tw, none, none, src, pf, of, splits, q, s);
    case 2: return launch_head_pw<2>(tw, none, none, src, pf, of, splits, q, s);
    case 4: return launch_head_pw<4>(tw, none, none, src, pf, of, splits, q, s);
    case 6: return launch_head_pw<6>(tw, none, none, src, pf, of, splits, q, s);
    default: return cudaErrorInvalidValue;
  }
}
