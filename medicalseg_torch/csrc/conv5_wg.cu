// 5^3 SAME convolution, stride 1, bf16 head form, for Hopper (sm_90a): the
// warpgroup kernel, with an optional fused BatchNorm + PReLU epilogue.
//
// Replaces medicalseg_tpu/ops/pallas_conv5.py:_conv5_kernel (:186) in its
// head form (_conv5_head_kl, :382: general Ci, every NConv stack conv and
// the OutputTransition 32 -> num_classes conv; Ci, Co up to 256 in one
// launch, where the TPU needed conv5_wide's co chunks, :1550), with the
// fused epilogue (conv5_kl_fused, :1288; _pack_ep, :360: y =
// PReLU_alpha((conv + b) * inv + shift) in f32 before the single store),
// and as the input gradient (:1380: the conv of the cotangent with the
// flipped, io-transposed weight; the wrapper packs the io-transposed
// weight and the kernel walks the taps backwards). The f32 and Ci = 1 stem
// forms are csrc/conv5.cu's.
//
// Layout: x and y are [N, D, C, H, W] views given by element strides for
// N, C, D and H; W must be the contiguous axis. Bias comes as f32 [Co] or
// a null pointer (no bias), the epilogue as f32 [inv(Co), shift(Co),
// alpha(Co)] or null; the wrapper packs the weights (see conv5_wg_launch),
// rounded to bf16 as the JAX layer casts its kernel.
//
// Bound on an H100 SXM (989 TF/s bf16 tensor cores, 3.35 TB/s HBM): a 5^3
// conv does 2 * 125 * Ci * Co FLOP per output voxel and must move
// (Ci + Co) activations per voxel, so for Ci, Co >= 16 the FLOP bound
// exceeds the byte bound 20-300x: the kernel is operation-bound, and at
// the deep levels (256 channels at 8^3 and 16^3) the 16 MB of weights
// outweigh the activations. Below 64 output channels the shared-memory
// reads of the voxel operand (2 KB per wgmma whatever its width) bind
// before the tensor cores do.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int KS = 5;           // kernel edge
constexpr int HALO = KS / 2;    // SAME padding on each side
constexpr int TAPS2 = KS * KS;  // (kh, kw) taps of one depth slice

// ---------------------------------------------------------------------------
// bf16 head form on the tensor cores: implicit GEMM with M = output voxels,
// N = output channels, K = (tap, Ci), as wgmma m64nNk16 (bf16 in, f32
// accumulators in registers).
//
// A block is three warpgroups that never reconverge after the barriers are
// set up:
//   * warps 0-3 and 4-7, the consumers (setmaxnreg): each owns MT m64
//     tiles, every one an 8 x 8 patch of the block's td x th x tw output
//     tile, and all NT output channels of the block's channel tile. Both
//     operands are read from shared memory by the hardware through
//     no-swizzle K-major descriptors: B is the tap's [NT][16] weights, A
//     the patch shifted by the tap. The halo tile is stored as two planes
//     of 8 channels, [plane][row][voxel][8 channels], so that 8 neighbouring
//     w-voxels are one 128-byte core matrix, a tap's (kh, kw) shift moves
//     the start address by whole 16-byte voxels, and the stride between
//     the 8-row groups of an m64 tile is the halo row pitch. No operand
//     passes through registers, so a whole kh row of taps is in flight
//     before the warpgroup waits. When the block is done, the consumers
//     turn the rings' memory into a staging tile [channel][td][th][tw] of
//     bf16 results (bias and epilogue applied in f32) and store it as
//     16-byte words, a tile row being one contiguous run of y.
//   * warps 8-10, the X producers (setmaxnreg): per (depth tap,
//     16-channel chunk) they fill one stage of a ring of XS halo tiles. A
//     thread takes 8 channels x 8 neighbouring w (one 16-byte load a
//     channel), transposes the 8 x 8 block in registers and stores 8
//     voxels x 16 bytes. The halo row pitch is 6 mod 8 voxels and the
//     plane stride 16 mod 128 bytes, so the 4 rows x 2 planes of a
//     quarter-warp store into 8 distinct bank groups. Where every row of
//     x starts on a 16-byte boundary the loads come from a raw tile
//     [td][16][rows][w] that one tensor copy (TMA, out-of-range elements
//     arrive as zeros: SAME padding, ragged edges, channel padding)
//     brought into a ring of RS stages; other views are read straight
//     from device memory by a scalar, predicated path with explicit zeros.
//   * warp 11, the loader: one thread keeps the raw-tile ring one stage
//     ahead and a ring of WS weight stages full with cp.async.bulk (one
//     (depth tap, chunk, kh) row of 5 taps a stage, a contiguous block of
//     the packed weights), each copy completing on its stage's mbarrier.
// Full/empty mbarriers per stage carry the hand-over; a wait that never
// completes traps, so a protocol fault is an error and not a hang. Up to
// 32 output channels a block is small enough for two to share an SM (one
// block's prologue and stores overlap the other's wgmmas); wider tiles
// take the SM's registers and most of its shared memory for one block.
//
// The reduction over (depth tap, chunk) can be split over blockIdx.z: each
// split writes f32 partials and conv5_reduce_kernel sums them in split
// order, then applies bias, epilogue and the one cast. No atomics: two
// runs are bit-identical. Unsplit blocks apply bias and epilogue themselves.
//
// Why these choices (times on an H100 80GB HBM3 at 700 W are in PERF.md):
// A comes from shared memory because the register route (ldmatrix
// fragments) leaves ptxas short of registers beside 128 accumulators and
// it serialises the wgmmas; the producers divide by float reciprocals
// because an integer division per staged item cost three warps more than
// their loads and stores; and below 64 output channels the kernel is
// bound by the shared-memory reads of A (2 KB per wgmma whatever N is),
// which is why narrow tiles get two blocks per SM and not wider rings.
// ---------------------------------------------------------------------------
constexpr int KC = 16;    // input channels per K step (one wgmma depth)
constexpr int XS = 2;     // stages of the halo-tile ring
constexpr int RS = 2;     // stages of the raw input tile ring (tensor copies)
constexpr int WG_THREADS = 384;
constexpr int X_PRODUCERS = 96;
constexpr int CONSUMER_WARPS = 8;
constexpr int BAR_BYTES = 256;  // 2 * (XS + WS + RS) mbarriers of 8 bytes, padded
constexpr uint32_t SPIN_LIMIT = 1u << 22;

struct WGeom {
  int n, d, ci, h, w, co;
  int td, th, tw;  // output tile of a block: th, tw powers of two >= 8,
                   // td * th * tw <= 128 * MT
  int sw;          // halo row pitch in voxels: >= tw + 4 and 6 mod 8
  int splits;      // blocks along the (depth tap, chunk) reduction
  int flip;        // walk the taps backwards (the input gradient)
  int aligned;     // base and strides of x are multiples of 16 bytes
  int tma;         // the raw input tile comes by tensor copy (tmap is valid)
  int y_aligned;   // base and strides of y are multiples of 16 bytes
  long long xs_n, xs_c, xs_d, xs_h;  // element strides of x (w stride 1)
  long long ys_n, ys_c, ys_d, ys_h;  // element strides of y (w stride 1)
};

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

__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src,
                                         uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// One tensor copy of a [1][td][16][sh][groups * 8] box of x (coordinates
// w, h, c, d, n; out-of-range elements arrive as zeros) completing on `bar`.
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

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// setmaxnreg for the calling warpgroup: up from, or down from, the count
// the block was launched with.
template <int REGS, int LAUNCHED>
__device__ __forceinline__ void set_max_regs() {
  if constexpr (REGS > LAUNCHED)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
  else
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// No-swizzle K-major shared-memory descriptor: 8 x 8 core matrices of 128
// contiguous bytes (8 rows of 8 bf16), the two K halves `lbo` bytes apart,
// consecutive 8-row groups `sbo` bytes apart. desc_hi is the constant part,
// desc_lo the start address.
__device__ __forceinline__ uint64_t desc_hi(uint32_t lbo, uint32_t sbo) {
  return ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}
__device__ __forceinline__ uint64_t desc_lo(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4);
}

// D (64 x N f32, in registers) += A (64 x 16 bf16) * B (16 x N), both in
// shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[4], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "%4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// Per channel tile: m64 tiles per consumer warpgroup (128 accumulators a
// thread at most), stages of the weight ring, blocks per SM and the
// registers a consumer / producer thread keeps after setmaxnreg. Up to 32
// channels a block is small enough for two to share an SM, so that one
// block's prologue and stores overlap the other's wgmmas; the registers of
// a block, 384 * 80 there and 384 * 168 above, are split accordingly:
// with 32 accumulators or fewer it is the transposing producers that need
// the larger share, above it the consumers.
template <int NT>
struct WgTile {
  static constexpr int MT = NT == 64 ? 4 : 2;
  static constexpr int WS = NT == 128 ? 6 : 8;
  static constexpr int BLOCKS = NT <= 32 ? 2 : 1;
  static constexpr int CONSUMER_REGS = NT <= 32 ? 72 : 208;
  static constexpr int PRODUCER_REGS = NT <= 32 ? 96 : 88;
  // registers a thread is launched with: 65536 / (384 * BLOCKS), in eights
  static constexpr int LAUNCH_REGS = NT <= 32 ? 80 : 168;
};

// Bytes between the two 8-channel planes of a halo tile: the plane, padded
// to 16 mod 128 (see the producers' note above).
__host__ __device__ __forceinline__ uint32_t x_plane_bytes(int rows, int sw) {
  const uint32_t plane = (uint32_t)(rows * sw * 16);
  return plane + ((16u - plane % 128u) % 128u + 128u) % 128u;
}

template <int NT>
__global__ void __launch_bounds__(WG_THREADS, WgTile<NT>::BLOCKS)
conv5_wg_kernel(const __nv_bfloat16* __restrict__ x,
                const __nv_bfloat16* __restrict__ wpk,
                const float* __restrict__ bias, const float* __restrict__ ep,
                __nv_bfloat16* __restrict__ y, float* __restrict__ part,
                const __grid_constant__ CUtensorMap tmap, WGeom g) {
  constexpr int MT = WgTile<NT>::MT;
  constexpr int WS = WgTile<NT>::WS;
  constexpr int NJ = NT / 8;                     // n8 groups of the tile
  constexpr uint32_t W_TAP = NT * KC * 2;        // bytes of one tap
  constexpr uint32_t W_STAGE = KS * W_TAP;       // one kh row of 5 taps
  extern __shared__ __align__(128) uint8_t smem_wg[];
  const int sh = g.th + 2 * HALO;
  const int rows = g.td * sh;                    // halo rows of a stage
  // 8-voxel groups of a halo row: the raw tile starts 8 voxels left of the
  // output tile (a tensor copy must start on a 16-byte boundary)
  const int groups = (g.tw + 1) / 8 + 2;
  // halo tile: [2 planes][rows][sw] voxels of 8 channels (16 bytes)
  const uint32_t x_plane = x_plane_bytes(rows, g.sw);
  const uint32_t x_stage = (2 * x_plane + 127) & ~127u;
  const uint32_t r_stage = (uint32_t)(rows * KC * groups * 8 * 2);
  const uint32_t bars = smem_u32(smem_wg);
  const uint32_t w_ring = bars + BAR_BYTES;
  const uint32_t x_ring = w_ring + WS * W_STAGE;
  const uint32_t r_ring = x_ring + XS * x_stage;
  // barriers: x_full[XS], x_empty[XS], w_full[WS], w_empty[WS], r_full[RS],
  // r_empty[RS]
  const uint32_t x_full = bars, x_empty = bars + 8 * XS;
  const uint32_t w_full = bars + 16 * XS, w_empty = w_full + 8 * WS;
  const uint32_t r_full = w_empty + 8 * WS, r_empty = r_full + 8 * RS;

  const int tiles_w = (g.w + g.tw - 1) / g.tw;
  const int tiles_h = (g.h + g.th - 1) / g.th;
  const int w0 = (blockIdx.x % tiles_w) * g.tw;
  const int h0 = ((blockIdx.x / tiles_w) % tiles_h) * g.th;
  const int d0 = (blockIdx.x / (tiles_w * tiles_h)) * g.td;
  const int co_tiles = (g.co + NT - 1) / NT;
  const int n = blockIdx.y / co_tiles;
  const int ct = blockIdx.y % co_tiles;
  const int chunks = (g.ci + KC - 1) / KC;
  const int q_all = KS * chunks;                 // (depth tap, chunk) stages
  // this split's stages, less the depth taps none of whose input slices
  // lies in the volume (the whole block skips them)
  const int kd_lo = max(0, HALO - (d0 + g.td - 1));
  const int kd_hi = min(KS - 1, g.d - 1 + HALO - d0);
  const int qa = max((int)((long long)blockIdx.z * q_all / g.splits),
                     kd_lo * chunks);
  const int qb = min((int)((long long)(blockIdx.z + 1) * q_all / g.splits),
                     (kd_hi + 1) * chunks);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < XS; ++i) {
      mbar_init(x_full + 8 * i, X_PRODUCERS);
      mbar_init(x_empty + 8 * i, CONSUMER_WARPS);
    }
    for (int i = 0; i < WS; ++i) {
      mbar_init(w_full + 8 * i, 1);
      mbar_init(w_empty + 8 * i, CONSUMER_WARPS);
    }
    for (int i = 0; i < RS; ++i) {
      mbar_init(r_full + 8 * i, 1);
      mbar_init(r_empty + 8 * i, X_PRODUCERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {
    // ===================== producers =====================
    set_max_regs<WgTile<NT>::PRODUCER_REGS, WgTile<NT>::LAUNCH_REGS>();
    if (warp == CONSUMER_WARPS + 3) {
      // ---- loader: one thread; per stage one tensor copy of the raw input
      // tile (kept one stage ahead) and one bulk copy per kh row of weights
      if (lane == 0) {
        uint32_t wi = 0, ri = 0;
        int qr = qa;  // next stage whose raw tile has not been asked for
        for (int q = qa; q < qb; ++q) {
          for (; g.tma && qr < qb && qr <= q + 1; ++qr, ++ri) {
            const int kd = qr / chunks;
            const uint32_t slot = ri % RS;
            mbar_wait(r_empty + 8 * slot, ((ri / RS) & 1) ^ 1);
            mbar_expect_tx(r_full + 8 * slot, r_stage);
            tma_load_5d(r_ring + slot * r_stage, &tmap, r_full + 8 * slot,
                        w0 - 8, h0 - HALO, (qr - kd * chunks) * KC,
                        d0 + kd - HALO, n);
          }
          const int kd = q / chunks;
          const int ch = q - kd * chunks;
          const int kde = g.flip ? KS - 1 - kd : kd;
          for (int kh = 0; kh < KS; ++kh) {
            const int khe = g.flip ? KS - 1 - kh : kh;
            const uint32_t slot = wi % WS;
            mbar_wait(w_empty + 8 * slot, ((wi / WS) & 1) ^ 1);
            mbar_expect_tx(w_full + 8 * slot, W_STAGE);
            // packed weights: [co_tile][kd][chunk][kh][kw][NT/8][2][8][8]
            const __nv_bfloat16* src =
                wpk + ((((size_t)ct * KS + kde) * chunks + ch) * KS + khe) *
                          (size_t)(KS * NT * KC);
            bulk_g2s(w_ring + slot * W_STAGE, src, W_STAGE, w_full + 8 * slot);
            ++wi;
          }
        }
      }
    } else {
      // ---- X producers: transpose the halo tile into the ring, from the
      // raw tile the tensor copy brought, or straight from device memory
      const int p = threadIdx.x - CONSUMER_WARPS * 32;  // 0..95
      const int items = ((rows + 3) / 4) * groups * 8;  // [rows/4][group][4][2]
      // quotients by groups and sh through float reciprocals: an integer
      // division is a long dependent chain, and three warps have little else
      // to hide it behind (operands stay far below 2^20, so it is exact)
      const float inv_groups = 1.0f / (float)groups, inv_sh = 1.0f / (float)sh;
      const __nv_bfloat16* xn = x + n * g.xs_n;
      const unsigned short* xu = reinterpret_cast<const unsigned short*>(xn);
      uint32_t xi = 0;
      for (int q = qa; q < qb; ++q, ++xi) {
        const int kd = q / chunks;
        const int ch = q - kd * chunks;
        const uint32_t slot = xi % XS;
        const uint32_t rslot = xi % RS;
        if (g.tma) mbar_wait(r_full + 8 * rslot, (xi / RS) & 1);
        mbar_wait(x_empty + 8 * slot, ((xi / XS) & 1) ^ 1);
        uint8_t* xst = smem_wg + BAR_BYTES + WS * W_STAGE + slot * x_stage;
        const uint8_t* raw =
            smem_wg + BAR_BYTES + WS * W_STAGE + XS * x_stage + rslot * r_stage;
        for (int it = p; it < items; it += X_PRODUCERS) {
          const int cg = it & 1;
          const int t = it >> 3;
          const int rb = (int)(((float)t + 0.5f) * inv_groups);
          const int grp = t - rb * groups;
          const int row = rb * 4 + ((it >> 1) & 3);
          if (row >= rows) continue;
          const int idl = (int)(((float)row + 0.5f) * inv_sh);
          const int ihl = row - idl * sh;
          uint32_t v[8][4];  // [channel][voxel pair]
          if (g.tma) {
            // raw tile: [td][16][sh][groups * 8], zero outside the volume
            const uint8_t* src =
                raw + ((size_t)(((idl * KC + cg * 8) * sh + ihl) * groups + grp)) * 16;
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              const uint4 u = *reinterpret_cast<const uint4*>(
                  src + (size_t)c * sh * groups * 16);
              v[c][0] = u.x;
              v[c][1] = u.y;
              v[c][2] = u.z;
              v[c][3] = u.w;
            }
          } else {
            const int id = d0 + idl + kd - HALO;
            const int ih = h0 + ihl - HALO;
            const int iw0 = w0 - 8 + 8 * grp;
            const int cbase = ch * KC + cg * 8;
            const bool row_ok = id >= 0 && id < g.d && ih >= 0 && ih < g.h;
            const long long base = (long long)cbase * g.xs_c + id * g.xs_d +
                                   ih * g.xs_h + iw0;
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              const bool c_ok = row_ok && cbase + c < g.ci;
#pragma unroll
              for (int j2 = 0; j2 < 4; ++j2) {
                const int iwa = iw0 + 2 * j2;
                uint32_t lo = 0u, hi = 0u;
                if (c_ok && iwa >= 0 && iwa < g.w)
                  lo = xu[base + c * g.xs_c + 2 * j2];
                if (c_ok && iwa + 1 >= 0 && iwa + 1 < g.w)
                  hi = xu[base + c * g.xs_c + 2 * j2 + 1];
                v[c][j2] = lo | (hi << 16);
              }
            }
          }
          // voxel j of the group: its 8 channels as one 16-byte store
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = 8 * grp + j - (8 - HALO);
            if (col < 0 || col >= g.tw + 2 * HALO) continue;
            const uint32_t sel = (j & 1) ? 0x7632u : 0x5410u;
            uint4 o;
            o.x = __byte_perm(v[0][j >> 1], v[1][j >> 1], sel);
            o.y = __byte_perm(v[2][j >> 1], v[3][j >> 1], sel);
            o.z = __byte_perm(v[4][j >> 1], v[5][j >> 1], sel);
            o.w = __byte_perm(v[6][j >> 1], v[7][j >> 1], sel);
            *reinterpret_cast<uint4*>(
                xst + (size_t)cg * x_plane + (size_t)(row * g.sw + col) * 16) = o;
          }
        }
        // wgmma reads the tile through the async proxy: order these generic
        // stores before it, then hand the stage over
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(x_full + 8 * slot);
        if (g.tma) mbar_arrive(r_empty + 8 * rslot);
      }
    }
  } else {
    // ===================== consumers =====================
    set_max_regs<WgTile<NT>::CONSUMER_REGS, WgTile<NT>::LAUNCH_REGS>();
    const int wg = warp >> 2;
    const int wl = warp & 3;
    // the 8 x 8 patches of the block's tile, in (d, h, w) order; this
    // warpgroup owns patches wg * MT .. wg * MT + MT - 1. th and tw are
    // powers of two: patch and chunk indices by shifts
    const int pw_s = 28 - __clz(g.tw), ph_s = 28 - __clz(g.th);  // log2(t / 8)
    const int pw_n = 1 << pw_s, ph_n = 1 << ph_s;
    const int patches = g.td << (ph_s + pw_s);
    uint32_t a_base[MT];  // byte offset of each patch in a stage, tap (0, 0)
#pragma unroll
    for (int f = 0; f < MT; ++f) {
      int pt = wg * MT + f;
      if (pt >= patches) pt = 0;  // unused tiles read a valid patch; never stored
      const int pw = pt & (pw_n - 1);
      const int ph = (pt >> pw_s) & (ph_n - 1);
      const int pd = pt >> (pw_s + ph_s);
      a_base[f] = (uint32_t)(((pd * sh + ph * 8) * g.sw + pw * 8) * 16);
    }
    const uint64_t a_hi = desc_hi(x_plane, (uint32_t)(g.sw * 16));
    const uint64_t b_hi = desc_hi(128, 256);  // [NT / 8][2][8][8]
    float acc[MT][NT / 2];
#pragma unroll
    for (int f = 0; f < MT; ++f)
#pragma unroll
      for (int i = 0; i < NT / 2; ++i) acc[f][i] = 0.f;

    uint32_t xi = 0, wi = 0;
    // stages whose wgmmas may still be in flight: one kh row is one group
    int w_pending = -1, x_pending = -1;
    for (int q = qa; q < qb; ++q, ++xi) {
      const uint32_t xslot = xi % XS;
      mbar_wait(x_full + 8 * xslot, (xi / XS) & 1);
      const uint32_t xb = x_ring + xslot * x_stage;
#pragma unroll 1
      for (int kh = 0; kh < KS; ++kh, ++wi) {
        const uint32_t wslot = wi % WS;
        mbar_wait(w_full + 8 * wslot, (wi / WS) & 1);
        const uint32_t xrow = xb + (uint32_t)(kh * g.sw * 16);
        const uint32_t wb = w_ring + wslot * W_STAGE;
        wgmma_fence();
#pragma unroll
        for (int kw = 0; kw < KS; ++kw) {
          const uint64_t bd =
              b_hi | desc_lo(wb + (g.flip ? KS - 1 - kw : kw) * W_TAP);
#pragma unroll
          for (int f = 0; f < MT; ++f)
            wgmma_ss(acc[f], a_hi | desc_lo(xrow + a_base[f] + kw * 16), bd);
        }
        wgmma_commit();
        wgmma_wait<1>();  // every row but this one is done: free its stages
        if (lane == 0) {
          if (w_pending >= 0) mbar_arrive(w_empty + 8 * w_pending);
          if (x_pending >= 0) mbar_arrive(x_empty + 8 * x_pending);
        }
        w_pending = (int)wslot;
        x_pending = -1;
      }
      x_pending = (int)xslot;
    }
    wgmma_wait<0>();

    // accumulator fragment: rows lane/4 and lane/4 + 8 of the warp's 16 (two
    // rows of the 8 x 8 patch), columns 8 * j + 2 * (lane % 4) + {0, 1}
    const long long plane = (long long)g.h * g.w;
    const int tile_vox = g.td * g.th * g.tw;
    const int s_pitch = tile_vox + 8;
    __nv_bfloat16* s_out = reinterpret_cast<__nv_bfloat16*>(smem_wg + BAR_BYTES);
    // every copy has landed and both warpgroups are done reading the rings:
    // the rings' memory becomes the staging tile
    if (g.splits == 1) asm volatile("bar.sync 1, 256;\n" ::: "memory");
#pragma unroll
    for (int f = 0; f < MT; ++f) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int pt = wg * MT + f;
        const int pw = pt & (pw_n - 1);
        const int ph = (pt >> pw_s) & (ph_n - 1);
        const int pd = pt >> (pw_s + ph_s);
        const int ow = w0 + pw * 8 + (lane >> 2);
        const int oh = h0 + ph * 8 + wl * 2 + half;
        const int od = d0 + pd;
        if (pt >= patches || ow >= g.w || oh >= g.h || od >= g.d) continue;
        if (g.splits > 1) {
          float* pv = part + (((long long)blockIdx.z * g.n + n) * g.d + od) *
                                 g.co * plane + (long long)oh * g.w + ow;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int co = ct * NT + j * 8 + (lane & 3) * 2 + e;
              if (co < g.co) pv[co * plane] = acc[f][j * 4 + half * 2 + e];
            }
          }
          continue;
        }
        // bias and epilogue in f32, one cast, into the block's staging tile
        // [channel][td][th][tw] (channel pitch padded by 16 bytes)
        __nv_bfloat16* sv =
            s_out + (pd * g.th + ph * 8 + wl * 2 + half) * g.tw + pw * 8 +
            (lane >> 2);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int cl = j * 8 + (lane & 3) * 2 + e;
            const int co = ct * NT + cl;
            if (co >= g.co) continue;
            float v = acc[f][j * 4 + half * 2 + e];
            if (bias != nullptr) v += bias[co];
            if (ep != nullptr) {
              v = v * ep[co] + ep[g.co + co];
              v = v >= 0.f ? v : v * ep[2 * g.co + co];
            }
            sv[cl * s_pitch] = __float2bfloat16(v);
          }
        }
      }
    }
    if (g.splits == 1) {
      // the staged tile goes out as 16-byte words, 8 voxels along w each:
      // a row of the tile is one contiguous run of y
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
      const int th_s = ph_s + 3;
      const int n_ch = min(NT, g.co - ct * NT);
      const int total = n_ch * (tile_vox / 8);
      const bool vec = g.y_aligned != 0;
      const float inv_td = 1.0f / (float)g.td;
      for (int i = threadIdx.x; i < total; i += CONSUMER_WARPS * 32) {
        const int cw = i & (pw_n - 1);
        const int r = (i >> pw_s) & (g.th - 1);
        const int rest = i >> (pw_s + th_s);  // channel * td + slice
        const int cl = (int)(((float)rest + 0.5f) * inv_td);
        const int pd = rest - cl * g.td;
        const int ow = w0 + cw * 8, oh = h0 + r, od = d0 + pd;
        if (ow >= g.w || oh >= g.h || od >= g.d) continue;
        const __nv_bfloat16* src =
            s_out + cl * s_pitch + (pd * g.th + r) * g.tw + cw * 8;
        __nv_bfloat16* dst = y + n * g.ys_n + od * g.ys_d + oh * g.ys_h +
                             (ct * NT + cl) * g.ys_c + ow;
        if (vec && ow + 8 <= g.w) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else {
          for (int k = 0; k < 8 && ow + k < g.w; ++k) dst[k] = src[k];
        }
      }
    }
  }
}

// Second pass of a split conv: y = cast(epilogue(sum over splits, in split
// order, of the f32 partials + bias)). part is [splits][N][D][Co][H][W], y
// contiguous [N][D][Co][H][W].
__global__ void conv5_reduce_kernel(const float* __restrict__ part, int splits,
                                    long long total, long long plane, int co,
                                    const float* __restrict__ bias,
                                    const float* __restrict__ ep,
                                    __nv_bfloat16* __restrict__ y) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    float v = 0.f;
    for (int s = 0; s < splits; ++s) v += part[s * total + i];
    const int c = (int)((i / plane) % co);
    if (bias != nullptr) v += bias[c];
    if (ep != nullptr) {
      v = v * ep[c] + ep[co + c];
      v = v >= 0.f ? v : v * ep[2 * co + c];
    }
    y[i] = __float2bfloat16(v);
  }
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

// The tensor map of x as (w, h, c, d, n) with the raw-tile box. False when
// the view cannot be described (strides or base not 16-byte multiples).
bool make_tmap(CUtensorMap* map, const void* x, const WGeom& g) {
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr || !g.aligned) return false;
  const int groups = (g.tw + 1) / 8 + 2;
  const cuuint64_t dims[5] = {(cuuint64_t)g.w, (cuuint64_t)g.h, (cuuint64_t)g.ci,
                              (cuuint64_t)g.d, (cuuint64_t)g.n};
  const cuuint64_t strides[4] = {(cuuint64_t)g.xs_h * 2, (cuuint64_t)g.xs_c * 2,
                                 (cuuint64_t)g.xs_d * 2, (cuuint64_t)g.xs_n * 2};
  const cuuint32_t box[5] = {(cuuint32_t)(groups * 8),
                             (cuuint32_t)(g.th + 2 * HALO), KC,
                             (cuuint32_t)g.td, 1};
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  for (int i = 0; i < 4; ++i)
    if (strides[i] == 0 || strides[i] % 16) return false;
  if (box[1] > 256 || box[3] > 256) return false;
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(x),
             dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NT>
cudaError_t launch_wg(const void* x, const void* w, const float* b,
                      const float* ep, void* y, float* part, WGeom g,
                      cudaStream_t s) {
  constexpr int MT = WgTile<NT>::MT;
  constexpr int WS = WgTile<NT>::WS;
  if (g.td < 1 || g.th < 8 || g.tw < 8 || (g.th & (g.th - 1)) ||
      (g.tw & (g.tw - 1)) ||
      g.td * g.th * g.tw > 128 * MT ||
      g.sw < g.tw + 2 * HALO || g.splits < 1 || (g.splits > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  const long long tiles = (long long)((g.d + g.td - 1) / g.td) *
                          ((g.h + g.th - 1) / g.th) * ((g.w + g.tw - 1) / g.tw);
  const long long gy = (long long)g.n * ((g.co + NT - 1) / NT);
  if (tiles > 0x7fffffffLL || gy > 65535 || g.splits > 65535)
    return cudaErrorInvalidValue;
  const size_t rows = (size_t)g.td * (g.th + 2 * HALO);
  const size_t x_stage =
      (2 * (size_t)x_plane_bytes((int)rows, g.sw) + 127) & ~(size_t)127;
  const size_t r_stage = rows * KC * ((g.tw + 1) / 8 + 2) * 8 * 2;
  const size_t smem =
      BAR_BYTES + (size_t)WS * KS * NT * KC * 2 + XS * x_stage + RS * r_stage;
  if (smem > 227 * 1024 / WgTile<NT>::BLOCKS ||
      smem < BAR_BYTES + (size_t)NT * (g.td * g.th * g.tw + 8) * 2)
    return cudaErrorInvalidValue;
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  g.tma = make_tmap(&map, x, g) ? 1 : 0;
  auto kern = conv5_wg_kernel<NT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)tiles, (unsigned)gy, (unsigned)g.splits);
  kern<<<grid, WG_THREADS, smem, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      b, ep, static_cast<__nv_bfloat16*>(y), part, map, g);
  e = cudaGetLastError();
  if (e != cudaSuccess || g.splits == 1) return e;
  const long long plane = (long long)g.h * g.w;
  const long long total = (long long)g.n * g.d * g.co * plane;
  const unsigned blocks = (unsigned)min((total + 255) / 256, (long long)132 * 16);
  conv5_reduce_kernel<<<blocks, 256, 0, s>>>(
      part, g.splits, total, plane, g.co, b, ep, static_cast<__nv_bfloat16*>(y));
  return cudaGetLastError();
}

}  // namespace

// Launches the bf16 head form on the tensor cores (conv5_wg_kernel, and
// conv5_reduce_kernel when splits > 1). nt (8, 32, 64 or 128) is the
// output-channel tile the weights were packed with: wpk is bf16
// [co_tile][kd][Ci/16][kh][kw][nt/8][2][8][8]. td x th x tw is the output
// tile of a block (th and tw powers of two from 8; at most 512 voxels for
// nt = 64, 256 otherwise), sw the halo row pitch in voxels (6 mod 8). flip != 0 walks the taps backwards (the input gradient
// on the io-transposed weight). bias and ep may be null; part is f32
// scratch of splits * N * D * Co * H * W elements (null when splits == 1),
// and y must be contiguous when splits > 1.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int conv5_wg_launch(const void* x, const void* wpk, const void* bias,
                               const void* ep, void* y, void* part, int nt,
                               int td, int th, int tw, int sw, int splits,
                               int flip, int n, int d, int ci, int h, int w,
                               int co, long long xs_n, long long xs_c,
                               long long xs_d, long long xs_h, long long ys_n,
                               long long ys_c, long long ys_d, long long ys_h,
                               void* stream) {
  const int aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                      xs_n % 8 == 0 && xs_c % 8 == 0 && xs_d % 8 == 0 &&
                      xs_h % 8 == 0;
  const int y_aligned = reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                        ys_n % 8 == 0 && ys_c % 8 == 0 && ys_d % 8 == 0 &&
                        ys_h % 8 == 0;
  const WGeom g{n, d, ci, h, w, co, td, th, tw, sw, splits, flip, aligned, 0,
                y_aligned,
                xs_n, xs_c, xs_d, xs_h, ys_n, ys_c, ys_d, ys_h};
  const float* bf = static_cast<const float*>(bias);
  const float* ef = static_cast<const float*>(ep);
  float* pf = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nt) {
    case 8: return launch_wg<8>(x, wpk, bf, ef, y, pf, g, s);
    case 32: return launch_wg<32>(x, wpk, bf, ef, y, pf, g, s);
    case 64: return launch_wg<64>(x, wpk, bf, ef, y, pf, g, s);
    case 128: return launch_wg<128>(x, wpk, bf, ef, y, pf, g, s);
    default: return cudaErrorInvalidValue;
  }
}
