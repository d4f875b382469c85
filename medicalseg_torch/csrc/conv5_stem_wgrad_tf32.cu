// Weight gradient of the float32 stem of V-Net on Hopper's tensor cores, at
// f32 accuracy ("split TF32"): the 5^3 SAME convolution (stride 1) of one
// input channel into Co <= 16 output channels,
//
//   dW[kd, kh, kw, 0, co] =
//       sum over (n, d, h, w) of x[n, d+kd-2, 0, h+kh-2, w+kw-2] * g[n, d, co, h, w]
//
// with x zero outside the volume, written in f32 as [5, 5, 5, 1, Co].
//
// Replaces, for float32 activations, the stem branch of
// medicalseg_tpu/ops/pallas_conv5.py _wgrad_kernel_ck / _wgrad_kernel
// (:539, :465; pallas_calls :912 and :977 via _conv5_wgrad_kl, :863; stem
// branches :933, :998). The CUDA-core kernel before it (wgrad_kernel,
// csrc/conv5_wgrad.cu) stays for wider stems and forced comparisons.
//
// Numerics, as csrc/conv5_tf32.cu: operands split into TF32 hi and lo
// halves (ops/conv5.py split_tf32 bit for bit), three mma.sync.m16n8k8 TF32
// products a term (lo*hi, hi*lo, hi*hi). K runs over millions of voxels and
// the tensor cores' own accumulation truncates, so every stage (two k8
// steps, six mma) sums into a fresh accumulator, which is then added,
// rounded, to running f32 sums in registers. The eight warps' sums are
// added in warp order, each block writes one partial dW and a second
// kernel adds the partials in block order: no atomics, two launches give
// the same bits.
//
// Layout: x is a [N, D, 1, H, W] view given by element strides for N, D
// and H, g a [N, D, Co, H, W] view given by strides for N, C, D and H; W
// contiguous in both, any alignment. Where the bases and strides lie on 16
// bytes and W and the tile's width are multiples of 4 the copies are 16
// bytes each (a g copy takes 4 voxels of a row whole), else 4, with zero
// fill.
//
// Bound on an H100 SXM: 2 * 125 * Co FLOP a voxel, three TF32 passes at 495
// TF/s (2 x 128^3, Co 16: 0.102 ms), against 4 bytes of x and 4 * Co of g
// read a voxel (0.045 ms at 3.35 TB/s): bound by operations. wgrad_kernel
// ran on the CUDA cores (0.25 ms at best at the 67 TF/s f32 FMA rate) and
// reduced its partials in a second pass over them.
//
// Design, after the bf16 stem's stem_wgrad_tc_kernel (csrc/
// conv5_stem_wgrad.cu): an implicit GEMM with M = the 16 channels (g is A),
// N = the 125 taps padded to 128 (16 n8 tiles), K = voxels, 8 a k8 step. A
// block owns a th x twd (h, w) tile, its voxels packed row-major onto K
// (where W is narrow a tile is whole rows), and walks a list of work items,
// each a depth range of a tile of one volume; warp i takes voxels 32i ..
// 32i + 31 of every depth (four k8 steps). Each g element feeds one lane's
// A register once, so g is split into hi and lo as its fragment is loaded;
// x feeds every tap, so each input slice is split once as it is staged,
// into hi and lo planes of a ring of ten slots (each slice stored twice, so
// that the five slices of a depth are consecutive slots and a lane's tap
// offsets stay fixed). A B register is one x element at a tap offset: one
// 32-bit load, no shifted copy. The raw g slices and x slices come by
// cp.async into a ring of three stages, two depths ahead. The taps sit on N
// so that the eight taps of an n8 tile are eight consecutive rows r (r = 5
// kd + kh, or kd + 5 kh: `order`) of one kw, and the pitches (rowp = 4 mod
// 32 and slot = 20 mod 32, or the other way round) put the eight 4-word
// windows of a B load on distinct banks; the sixteenth tile holds row 0 of
// every kw, whose windows overlap in the same words (16 wavefronts for 16
// loads: tests/test_torch_conv5_stem_tf32.py counts them).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KS = 5;
constexpr int TAPS = KS * KS * KS;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int KW = 4;                    // k8 steps of a warp a depth
constexpr int TVOX = WARPS * KW * 8;     // voxels of a block tile (256)
constexpr int KST = 2;                   // k8 steps of a stage
constexpr int COP = 16;                  // output channels: M of the GEMM
constexpr int NTILES = 16;               // n8 tiles: 128 tap columns
constexpr int GP = TVOX + 4;             // staged g channel pitch (floats)
constexpr int STAGES = 3;                // copy ring
constexpr int RED = 4 * 4 * 32;          // floats a warp adds per round
static_assert(KW % KST == 0, "stages split a warp's k steps");

struct WGeom {
  int n, d, h, w, co;
  int th, twd, tiles_w, tiles;   // the tile: th rows x twd columns
  int dc, chunks;                // depth chunks
  long long items, per;          // work items, per block
  int rowp, slot, rawp, order;   // ring pitches, raw box pitch, tap order
  long long xs_n, xs_d, xs_h;    // element strides of x
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

__device__ __forceinline__ void cp_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The tap of N column c: n8 tiles 0..14 hold kw = j / 3 and rows r = 1 + 8
// (j % 3) .. + 7 (r = 5 kd + kh, or kd + 5 kh with `order`); tile 15 holds
// row 0 of kw 0..4 and three padding columns (pad: never written; they read
// the word of tap (0, 0, 0)).
__device__ __forceinline__ void col_tap(int c, int order, int& kd, int& kh,
                                        int& kw, bool& pad) {
  const int j = c >> 3, i = c & 7;
  if (j < 15) {
    const int r = 1 + 8 * (j % 3) + i;
    kw = j / 3;
    kd = order ? r % KS : r / KS;
    kh = order ? r / KS : r % KS;
    pad = false;
  } else {
    kd = kh = 0;
    kw = i < KS ? i : 0;
    pad = i >= KS;
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
stem_wgrad_tf32_kernel(const float* __restrict__ x, const float* __restrict__ g,
                       float* __restrict__ dst, WGeom q) {
  extern __shared__ float4 smem4[];
  float* gr_ = reinterpret_cast<float*>(smem4);           // [3][16][GP] raw g
  float* xr = gr_ + STAGES * COP * GP;                    // [3][th+4][rawp]
  const int xbox = (q.th + 4) * q.rawp;
  float* rhi = xr + STAGES * xbox;                        // [10][slot]
  float* rlo = rhi + 2 * KS * q.slot;                     // [10][slot]
  int* vbt = reinterpret_cast<int*>(rlo + 2 * KS * q.slot);  // [8][256]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;

  // this lane's B column of n8 tile j: its word offset from a depth's
  // first slot is offr[j % 3] + j / 3 (row block j % 3 of kw j / 3) for j
  // < 15, off15 for the last tile
  int offr[3];
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    int kd, kh, kw;
    bool pad;
    col_tap(8 * b + gq, q.order, kd, kh, kw, pad);
    offr[b] = kd * q.slot + kh * q.rowp;
  }
  const int off15 = gq < KS ? gq : 0;
  // the ring offsets of the voxels of this lane's B rows, voxel 32 warp +
  // 8 k + 4 half + tq (voxels past the tile read word 0; their g is zero),
  // kept in shared memory and read again at each depth
#pragma unroll
  for (int i = 0; i < 2 * KW; ++i) {
    const int v = 32 * warp + 4 * i + tq;
    vbt[i * THREADS + threadIdx.x] =
        v < q.th * q.twd ? (v / q.twd) * q.rowp + v % q.twd : 0;
  }

  // this thread's g copies: voxel gv of the tile (row gr, column gc) for
  // channels gco0, gco0 + GSTEP, ... (the same voxel for every channel)
  constexpr int GUNIT = VEC ? 4 : 1;
  constexpr int GSTEP = THREADS * GUNIT / TVOX;
  const int gv = GUNIT * (threadIdx.x % (TVOX / GUNIT));
  const int gco0 = threadIdx.x / (TVOX / GUNIT);
  const int gr = gv / q.twd;
  const int gc = gv % q.twd;

  float run[NTILES][4];
#pragma unroll
  for (int j = 0; j < NTILES; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) run[j][e] = 0.f;

  const long long first = (long long)blockIdx.x * q.per;
  const long long last = min(q.items, first + q.per);
  for (long long it = first; it < last; ++it) {
    const int tile = (int)(it % q.tiles);
    const long long rest = it / q.tiles;
    const int chunk = (int)(rest % q.chunks);
    const int nb = (int)(rest / q.chunks);
    const int h0 = (tile / q.tiles_w) * q.th;
    const int w0 = (tile % q.tiles_w) * q.twd;
    const int d0 = chunk * q.dc;
    const int d1 = min(q.d, d0 + q.dc);
    const int tvox = min(q.th, q.h - h0) * q.twd;
    const float* xn = x + nb * q.xs_n;
    const float* gn = g + nb * q.gs_n;

    // input slice dd's raw box (rows h0 - 2 .., from column w0 - 4) into
    // stage s, zeros outside the volume
    auto copy_x = [&](int dd, int s) {
      const bool dok = dd >= 0 && dd < q.d;
      const int per_row = VEC ? q.rawp / 4 : q.rawp;
      const int total = (q.th + 4) * per_row;
      float* box = xr + s * xbox;
      for (int i = threadIdx.x; i < total; i += THREADS) {
        const int row = i / per_row;
        const int k = i % per_row;
        const int ih = h0 - 2 + row;
        const bool rok = dok && ih >= 0 && ih < q.h;
        if (VEC) {
          const int iw = w0 - 4 + 4 * k;
          const int bytes = rok && iw >= 0 && iw < q.w ? 4 * min(4, q.w - iw)
                                                       : 0;
          cp16(box + row * q.rawp + 4 * k,
               bytes ? xn + dd * q.xs_d + ih * q.xs_h + iw : x, bytes);
        } else {
          const int iw = w0 - 4 + k;
          const bool ok = rok && iw >= 0 && iw < q.w;
          cp4(box + row * q.rawp + k,
              ok ? xn + dd * q.xs_d + ih * q.xs_h + iw : x, ok);
        }
      }
    };
    // g slice od, [16 co][256 voxels of the tile] into stage s (zeros past
    // Co and past the tile's voxels in the volume)
    const bool gin = gv < tvox && w0 + gc < q.w;
    auto copy_g = [&](int od, int s) {
      float* box = gr_ + s * COP * GP + gv;
      const float* src =
          gn + od * q.gs_d + (h0 + gr) * q.gs_h + w0 + gc;
#pragma unroll
      for (int co = gco0; co < COP; co += GSTEP) {
        const bool in = gin && co < q.co;
        if (VEC)
          cp16(box + co * GP, in ? src + co * q.gs_c : g, in ? 16 : 0);
        else
          cp4(box + co * GP, in ? src + co * q.gs_c : g, in);
      }
    };
    // ... and the raw x box of stage s split once into both slots of dd
    auto split_x = [&](int dd, int s) {
      const int cols = q.twd + 4;
      const int total = (q.th + 4) * cols;
      const float* box = xr + s * xbox;
      const int s0 = ((dd + KS) % KS) * q.slot;
      const int s1 = s0 + KS * q.slot;
      for (int e = threadIdx.x; e < total; e += THREADS) {
        const int row = e / cols;
        const int c = e % cols;
        float hv, lv;
        split_tf32(box[row * q.rawp + c + 2], hv, lv);
        const int o = row * q.rowp + c;
        rhi[s0 + o] = hv;
        rlo[s0 + o] = lv;
        rhi[s1 + o] = hv;
        rlo[s1 + o] = lv;
      }
    };

    __syncthreads();  // the last item's stages and slots are free
    for (int k = -2; k < 2; ++k) {
      copy_x(d0 + k, 0);
      cp_commit();
      cp_wait_all();
      __syncthreads();
      split_x(d0 + k, 0);
      __syncthreads();
    }
    // stage od % 3 holds g slice od and x slice od + 2
    copy_g(d0, 0);
    copy_x(d0 + 2, 0);
    cp_commit();
    if (d0 + 1 < d1) {
      copy_g(d0 + 1, 1);
      copy_x(d0 + 3, 1);
    }
    cp_commit();

    for (int od = d0; od < d1; ++od) {
      const int s = (od - d0) % STAGES;
      cp_wait1();
      __syncthreads();  // stage s landed; every warp is done with od - 1
      split_x(od + 2, s);
      __syncthreads();  // the ring holds od - 2 .. od + 2
      if (od + 2 < d1) {
        copy_g(od + 2, (s + 2) % STAGES);
        copy_x(od + 4, (s + 2) % STAGES);
      }
      cp_commit();

      // the five slices of this depth: slots base .. base + 4
      const int base = ((od + 3) % KS) * q.slot;
      const float* xh = rhi + base;
      const float* xl = rlo + base;
      const float* gs = gr_ + s * COP * GP + gq * GP + 32 * warp + tq;
      int vb[KW][2];
#pragma unroll
      for (int i = 0; i < 2 * KW; ++i)
        vb[i / 2][i % 2] = vbt[i * THREADS + threadIdx.x];
#pragma unroll
      for (int kb = 0; kb < KW; kb += KST) {
        if (32 * warp + 8 * kb >= tvox) break;
        // A: g[co gq (+ 8)][voxel 8 k + tq (+ 4)], split as it is loaded
        uint32_t ah[KST][4], al[KST][4];
#pragma unroll
        for (int k = 0; k < KST; ++k) {
          const float a[4] = {gs[8 * (kb + k)], gs[8 * GP + 8 * (kb + k)],
                              gs[8 * (kb + k) + 4],
                              gs[8 * GP + 8 * (kb + k) + 4]};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float hv, lv;
            split_tf32(a[e], hv, lv);
            ah[k][e] = __float_as_uint(hv);
            al[k][e] = __float_as_uint(lv);
          }
        }
#pragma unroll
        for (int j = 0; j < NTILES; ++j) {
          float sum[4] = {0.f, 0.f, 0.f, 0.f};
          const int off = j < 15 ? offr[j % 3] + j / 3 : off15;
#pragma unroll
          for (int k = 0; k < KST; ++k) {
            const int o0 = vb[kb + k][0] + off;
            const int o1 = vb[kb + k][1] + off;
            mma_tf32(sum, al[k], xh[o0], xh[o1]);
            mma_tf32(sum, ah[k], xl[o0], xl[o1]);
            mma_tf32(sum, ah[k], xh[o0], xh[o1]);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) run[j][e] += sum[e];
        }
      }
    }
  }

  // the warps' sums, added in warp order, four n8 tiles per round; the
  // accumulator fragment holds channels gq, gq + 8 of columns 8 j + 2 tq +
  // {0, 1}
  __syncthreads();
  float* red = gr_;
  float* out = dst + (size_t)blockIdx.x * TAPS * q.co;
#pragma unroll
  for (int round = 0; round < NTILES / 4; ++round) {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[warp * RED + (4 * jj + e) * 32 + lane] = run[4 * round + jj][e];
    __syncthreads();
    for (int i = threadIdx.x; i < RED; i += THREADS) {
      float sum = 0.f;
#pragma unroll
      for (int wp = 0; wp < WARPS; ++wp) sum += red[wp * RED + i];
      const int jj = i >> 7, e = (i >> 5) & 3, ln = i & 31;
      const int col = 8 * (4 * round + jj) + 2 * (ln & 3) + (e & 1);
      const int co = (ln >> 2) + 8 * (e >> 1);
      int kd, kh, kw;
      bool pad;
      col_tap(col, q.order, kd, kh, kw, pad);
      if (!pad && co < q.co) out[((kd * KS + kh) * KS + kw) * q.co + co] = sum;
    }
    __syncthreads();
  }
}

// out[i] = sum over the blocks' partials of part[b][i], in the order b = 0, 1, ...
__global__ void stem_wgrad_tf32_reduce_kernel(const float* __restrict__ part,
                                              float* __restrict__ out,
                                              int parts, int size) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size) return;
  float s = 0.f;
  for (int b = 0; b < parts; ++b) s += part[(size_t)b * size + i];
  out[i] = s;
}

size_t smem_bytes(int th, int rawp, int slot) {
  return sizeof(float) * ((size_t)STAGES * COP * GP +
                          (size_t)STAGES * (th + 4) * rawp + 4 * KS * slot +
                          2 * KW * THREADS);
}

}  // namespace

// Launches the split-TF32 stem weight gradient on `stream`: x [N, D, 1, H,
// W] f32 (strides xs_*), g [N, D, co, H, W] f32 (strides gs_*), both W
// contiguous (vec != 0 where both bases and all strides lie on 16 bytes and
// W and twd are multiples of 4); out f32 [125, co].
// `blocks` blocks each walk `per` work items (a th x twd tile, tiles_w of
// them along W, of one volume over a chunk of dc depths), each writing its
// partial sums to part [blocks, 125, co], which a second kernel adds in
// block order into out; with one block the kernel writes out itself. rowp,
// slot: the ring's pitches (floats; 4 and 20 mod 32 with order 0, 20 and 4
// with order 1), rawp the raw box's row pitch (a multiple of 4, at least
// twd + 6). Returns cudaGetLastError() after the launches (0 on success),
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int conv5_stem_wgrad_tf32_launch(
    const void* x, const void* g, void* part, void* out, int th, int twd,
    int tiles_w, int dc, int per, int blocks, int rowp, int slot, int rawp,
    int order, int vec, int n, int d, int h, int w, int co, long long xs_n,
    long long xs_d, long long xs_h, long long gs_n, long long gs_c,
    long long gs_d, long long gs_h, void* stream) {
  if (co < 1 || co > COP || n < 1 || d < 1 || h < 1 || w < 1 || th < 1 ||
      twd < 1 || th * twd > TVOX || tiles_w < 1 ||
      (long long)tiles_w * twd < w || dc < 1 || per < 1 || blocks < 1 ||
      rowp < twd + 4 || slot < (th + 4) * rowp || rawp < twd + 6 ||
      rawp % 4 != 0 || (vec && (twd % 4 != 0 || w % 4 != 0)) ||
      (blocks > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  const long long tiles = (long long)((h + th - 1) / th) * tiles_w;
  const int chunks = (d + dc - 1) / dc;
  const long long items = (long long)n * chunks * tiles;
  const size_t smem = smem_bytes(th, rawp, slot);
  if (tiles > 0x7fffffffLL || (long long)blocks * per < items ||
      (long long)(blocks - 1) * per >= items || smem > 227 * 1024)
    return cudaErrorInvalidValue;
  const WGeom q{n,     d,     h,    w,     co,    th,   twd,  tiles_w,
                (int)tiles, dc, chunks, items, per, rowp, slot, rawp,
                order, xs_n,  xs_d, xs_h,  gs_n,  gs_c, gs_d, gs_h};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dstp = static_cast<float*>(blocks > 1 ? part : out);
  const auto* xf = static_cast<const float*>(x);
  const auto* gf = static_cast<const float*>(g);
  auto kern = vec ? stem_wgrad_tf32_kernel<true> : stem_wgrad_tf32_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<blocks, THREADS, smem, s>>>(xf, gf, dstp, q);
  e = cudaGetLastError();
  if (e != cudaSuccess || blocks == 1) return e;
  const int size = TAPS * co;
  stem_wgrad_tf32_reduce_kernel<<<(size + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(out), blocks, size);
  return cudaGetLastError();
}
