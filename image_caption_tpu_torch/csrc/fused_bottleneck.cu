// Fused ResNet identity bottleneck for Hopper (sm_90a): one block, or a
// stack of blocks in one launch.
//
// Replaces image_caption_tpu/vision/pallas_bottleneck.py:_bottleneck_kernel
// (through fused_bottleneck) and :_stage_kernel (through fused_stage).  Per
// block, with BN folded into a scale and a bias per channel:
//
//   h1 = relu(x . w1 * s1 + b1)           1x1 conv, C -> Wd
//   h2 = relu(conv3x3(h1, w2) * s2 + b2)  3x3 conv, Wd -> Wd, zero padded
//   y  = relu(h2 . w3 * s3 + b3 + x)      1x1 conv, Wd -> C
//
// x and y are NHWC in memory (a PyTorch NCHW tensor in channels_last), f32
// or bf16.  Products accumulate in f32 and the scale, bias and residual
// epilogues run in f32; h1, h2 and y are rounded to x's type, so a stack
// carries x in that type from block to block, as the TPU kernel does.
//
// What bounds it: operations.  At the ResNet-101 crop shapes (224 px crops,
// stages at 56/28/14/7 px) a block does 218 M multiply-adds per crop
// against a few MB of activations, far above the card's ~295 bf16
// operations per byte, so the least time is the tensor cores' rate: bf16,
// or for f32 three TF32 passes (495 / 3 = 165 TFLOP/s).  The TPU kernel
// keeps a batch tile of whole crops and all the stage's weights in VMEM
// (48 MB for stage 3); an SM has 227 KB, so this design keeps h1, h2 and
// the running y in global memory (L2 where they fit, else HBM) and writes
// y in place: the expand phase reads its residual at exactly the element
// it writes.
//
// One body for both types (stack_kernel<T>): every phase of every block is
// one GEMM over all crops at once.
//   - Rows are every pixel of every crop, M = N*H*W; columns the phase's
//     output channels; K is C (reduce), 9*Wd in tap-major order (3x3) or Wd
//     (expand).  Output tiles of 128 rows x 128 columns (64 where the
//     width is not a multiple of 128) cross crop boundaries: the 3x3 phase
//     gathers row m's A row per tap from pixel (py + dy, px + dx) of crop
//     m / (H*W), zero outside that crop or past M (cp.async zero-fill).
//     The row -> (crop, py, px) divisions run once per tile per thread.
//   - A persistent cooperative grid, one CTA per SM (clamped to the tile
//     count; the launch guarantees every CTA is resident), walks each
//     phase's tiles in a fixed order, the column tiles of a row band one
//     after another so the band's A rows come from L2.  A grid barrier sits
//     between phases (the 3x3 phase reads h1 of other CTAs' tiles, the next
//     block all of y): 3 * nblk - 1 per launch.  No split-K and no atomics
//     on data, so every output element has one owner and one summation
//     order: results are bitwise the same run to run and for any grid
//     (chip_smoke.py checks both, in each type).
//   - K chunks of one 128-byte row (64 bf16 or 32 floats) stream through a
//     ring in dynamic shared memory (5 stages of A and B for bf16, 4 of A,
//     B's high and B's low parts for f32), two or three chunks in flight
//     ahead of the multiply and across tile boundaries (a phase of one or
//     four chunks a tile still keeps them in flight), in the
//     128-byte-swizzled K-major layout that wgmma reads (16-byte unit j of
//     row r at j ^ (r % 8)).  The weights (B) and the 1x1 convs' A rows come
//     by TMA (tensor maps built here, one mbarrier per stage counting the
//     bytes); the 3x3 conv's gathered A rows come by 16-byte cp.async.cg
//     with zero-fill.  A chunk's copies are posted as soon as the barrier
//     frees their stage, before the chunk in hand is multiplied.
//   - Two warpgroups of 64 rows each issue wgmma.mma_async m64nNk16 (bf16)
//     or m64nNk8 (TF32), N = 128 or 64, f32 accumulators in registers, one
//     commit group per chunk.
//
// bf16, the YOLOv5 path's type: A and B from shared-memory descriptors; the
// chunk's group runs on under the next chunk, so a stage is refilled two
// chunks after its multiply.  Each thread fences its gathered rows into
// the async proxy before the barrier that hands the stage to wgmma.  The
// epilogue goes through an f32 staging tile in shared memory (64 KB beside
// the 160 KB ring), so each thread applies scale and bias, adds the
// residual (loaded into registers before the K loop) in f32, applies relu,
// rounds once and stores 16 bytes, while the next tile's chunks load.
//   What holds it back, from per-phase timer stamps taken while the design
//   was brought up (PERF.md, NVIDIA H100, 192 stage-3 crops): a chunk
//   takes the same time per CTA on 66, 99 or 132 CTAs, so no resource
//   shared between SMs (L2, HBM) sets the pace; the 3x3 phase takes about
//   the sum, not the larger, of its copy-only and multiply-only times,
//   since every warp both copies and multiplies and one barrier a chunk
//   ties them; the expand phase is bound by its epilogue (77 MB of y read
//   and written per block); and a phase whose tile count is not a
//   multiple of the grid idles part of its last wave.
//
// f32, the Faster R-CNN path's type (the JAX package computes it in f32;
// TF32 alone, or bf16, would be another result): products in three TF32
// passes.  Each operand v splits into hi = tf32(v) and lo = tf32(v - hi),
// both rounded to nearest (cvt.rna), and the accumulators take a_lo.b_hi +
// a_hi.b_lo + a_hi.b_hi: every product of two TF32 values is exact in f32,
// and what is dropped (a_lo.b_lo and the bits below lo) is about 2^-22 of
// each product.  The wrapper splits the weights once a call ([2, ...]:
// high parts, then low), and TMA brings both into the stage; each warp
// reads its 16 A rows of a chunk from the swizzled stage by ldmatrix (an
// 8x8 b16 matrix is 8 rows x 4 floats, the layout of wgmma's register A)
// and splits them in registers, 16 values a thread a chunk.  A comes from
// registers, so the chunk's products are waited for before the next
// chunk's A is written: two register sets in flight made ptxas serialize
// every wgmma (C7512) and measured slower.  The epilogue stores straight
// from the accumulators (a lane quad holds 8 consecutive floats of a row:
// 32-byte sectors, whole), its residual loaded after the K loop.
//   Measured (PERF.md; NVIDIA H100, the Faster R-CNN batch's 1184 crops,
//   ResNet-101's four identity runs): this body 180 ms, where the one-block-per-crop FFMA body it
//   replaces took 565 ms and cuDNN f32 takes 485; mma.sync on the same
//   fragments 235; two register sets in flight 190.  One TF32 pass instead
//   of three takes 115 and no split 161, so the passes and then the split
//   set the pace at the 28-7 px stages.  At 56 px (stage 1) one pass takes
//   as long as three: data movement sets it, where the phase's x, h1, h2
//   or y (0.95-3.8 GB at 1184 crops) outgrows L2 and HBM carries 4 N*H*W
//   (3 C + 4 Wd) bytes a block, 9 of its 20 ms at the HBM rate.
//
// Shapes: C and Wd multiples of 64, any H, W and N >= 1.  Weights K-major:
// w1 [n, Wd, C], w2 [n, Wd, 3, 3, Wd] (out, tap row, tap col, in), w3
// [n, C, Wd], in x's type (f32: each [2, n, ...], the TF32 high parts,
// then the low parts); scale and bias rows sb1 [n, 2, Wd], sb2 [n, 2, Wd],
// sb3 [n, 2, C] in f32.  The caller supplies h1 and h2 scratch
// of N*H*W*Wd elements each and a zeroed 32-bit barrier word.

#include <cuda.h>      // CUtensorMap and its enums; the encoder is reached
                       // through cudaGetDriverEntryPoint: no libcuda link
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

namespace gemm {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;               // output rows (pixels) per tile
constexpr int ROW = 128;              // bytes of a K chunk's row: the swizzle
constexpr int THREADS = 256;          // two warpgroups of 64 rows each
constexpr int B_OFFSET = BM * ROW;    // a stage: A 128 rows, then B <= 128
                                      // (f32: B's TF32 high parts, then its
                                      // low parts)
constexpr int STG_STRIDE = 128;       // bf16's f32 staging row (8-float
                                      // groups XOR-swizzled by row % 8)

template <typename T>
constexpr bool IS_F32 = std::is_same<T, float>::value;
template <typename T>
constexpr int BK = ROW / sizeof(T);   // K chunk: 64 bf16 or 32 floats
template <typename T>
constexpr int VEC = 16 / sizeof(T);   // elements in 16 bytes
template <typename T>
constexpr int STAGES = IS_F32<T> ? 4 : 5;    // ring of K chunks
template <typename T>
constexpr int STAGE_BYTES = (IS_F32<T> ? 3 : 2) * B_OFFSET;
// chunks loading ahead of the multiply: bf16's wgmma may still read the
// chunk before the one in hand (f32, which waits for each chunk's
// products, could load one more)
template <typename T>
constexpr int AHEAD = STAGES<T> - 2;
template <typename T>
constexpr int STG_BYTES = IS_F32<T> ? 0 : BM * STG_STRIDE * 4;
template <typename T>
constexpr int SMEM_BYTES =            // + one mbarrier per stage
    1024 + STAGES<T> * STAGE_BYTES<T> + STG_BYTES<T> + 8 * STAGES<T>;

struct Geo {
  int M, P, H, W;                     // rows, pixels per crop, crop size
};

// One conv of a block as a GEMM: out[m, n] = epilogue(sum_k A[m, k] w[n, k]).
// A is `a` [M, lda] for a 1x1 conv; for the 3x3 conv k = tap * lda + c and
// A[m, k] = a[pixel m shifted by the tap within its crop, c].
// A 1x1 conv's A tiles come by TMA through `amap`; the 3x3 conv gathers
// its A rows from `a` by cp.async (amap is null).  B tiles always come by
// TMA: rows brow + n of `bmap`, the block's weights in the stacked array,
// and for f32 their low parts at rows blo + n.
template <typename T>
struct Phase {
  const T* a;
  int lda;
  const CUtensorMap* amap;
  const CUtensorMap* bmap;            // [nblk * n_out, K] (f32: twice)
  int brow, blo;
  const float* sb;                    // [2, n_out]: scale row, bias row
  const T* res;                       // residual [M, n_out] or nullptr
  T* out;                             // [M, n_out]
  int n_out;
  int K;
};

// Tensor maps of x, y, h2 [M, C or Wd] (boxes of 128 rows) and of the
// stacked weights (boxes of the phase's tile width; f32: the TF32 high
// parts of every block, then the low parts), 128 bytes a box row.
template <typename T>
struct Stack {
  CUtensorMap mx, my, mh2, mw1, mw2, mw3;
  const T* x;
  T* y;
  T* h1;
  T* h2;
  const float* sb1;
  const float* sb2;
  const float* sb3;
  unsigned* bar;
  int nblk, M, H, W, C, Wd;
};

// The four A rows a thread copies in a tile, r0 + 32 i with r0 =
// threadIdx.x / 8, and the pixel each stands for; a row past M gets
// py = -4, so that every tap falls outside.
struct Rows {
  int m[4], py[4], px[4];
};

__device__ __forceinline__ Rows rows_of(int m0, const Geo& g) {
  Rows r;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + (threadIdx.x >> 3) + 32 * i;
    r.m[i] = m;
    r.py[i] = -4;
    r.px[i] = 0;
    if (m < g.M) {
      const int p = m % g.P;
      r.py[i] = p / g.W;
      r.px[i] = p - r.py[i] * g.W;
    }
  }
  return r;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(fill ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// this thread's shared-memory accesses (generic proxy) before later ones
// by wgmma or TMA (async proxy)
__device__ __forceinline__ void fence_proxy_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// A wait of 10 s on the card is a fault: trap instead of hanging.
__device__ __forceinline__ void check_timeout(unsigned long long t0) {
  if (now_ns() - t0 > 10000000000ull) __trap();
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}
// the one arrival of the stage's phase, and the bytes its copies will bring
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ bool mbar_done(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_done(bar, parity)) return;
  const unsigned long long t0 = now_ns();
  while (!mbar_done(bar, parity)) check_timeout(t0);
}

// TMA: the box at (col, row) of `map` into shared memory at `dst`, in the
// map's 128-byte swizzle, completing on the mbarrier `bar`; rows past the
// matrix arrive as zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int col, int row, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(map), "r"(col), "r"(row), "r"(bar)
      : "memory");
}

// The copy side of a phase: the CTA's tiles and their K chunks in the
// order they are multiplied, run AHEAD chunks ahead of the multiply and
// across tile boundaries, so the next tile's first chunks load while this
// one finishes and stores.
struct Cursor {
  int tile, chunk, m0, n0;
  Rows rows;
};

template <bool GATHER>
__device__ __forceinline__ void seek(Cursor& cur, int tile, int ntn,
                                     int tiles, int bn, const Geo& g) {
  cur.tile = tile;
  cur.chunk = 0;
  if (tile < tiles) {
    cur.m0 = tile / ntn * BM;
    cur.n0 = tile % ntn * bn;
    if (GATHER) cur.rows = rows_of(cur.m0, g);
  }
}

// Copy the cursor's K chunk into the stage at shared address `stage`, in
// the 128-byte swizzle (16-byte unit j of row r at r * 128 + (j ^ (r % 8))
// * 16): thread 0 posts the TMA copies and their byte count on the stage's
// mbarrier `bar`; for the 3x3 conv (GATHER) every thread gathers its A
// rows.
template <typename T, int BN, bool GATHER>
__device__ __forceinline__ void load_chunk(const Phase<T>& ph, const Geo& g,
                                           const Cursor& cur, uint32_t stage,
                                           uint32_t bar) {
  const int k0 = cur.chunk * BK<T>;
  if (threadIdx.x == 0) {
    // f32: the stage's A rows were last read by ldmatrix (generic proxy)
    if (IS_F32<T>) fence_proxy_async_smem();
    mbar_expect(bar, (GATHER ? 0 : BM * ROW) + (IS_F32<T> ? 2 : 1) * BN * ROW);
    if (!GATHER) tma_load(stage, ph.amap, k0, cur.m0, bar);
    tma_load(stage + B_OFFSET, ph.bmap, k0, ph.brow + cur.n0, bar);
    if (IS_F32<T>)
      tma_load(stage + 2 * B_OFFSET, ph.bmap, k0, ph.blo + cur.n0, bar);
  }
  if (!GATHER) return;
  const int tap = k0 / ph.lda;        // a chunk never straddles two taps
  const int c0 = k0 - tap * ph.lda, dy = tap / 3 - 1, dx = tap % 3 - 1;
  const int shift = dy * g.W + dx;
  const int vec = threadIdx.x & 7, r0 = threadIdx.x >> 3;
  const uint32_t swz = (uint32_t)((vec ^ (r0 & 7)) << 4);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool inside = (unsigned)(cur.rows.py[i] + dy) < (unsigned)g.H &&
                        (unsigned)(cur.rows.px[i] + dx) < (unsigned)g.W;
    const T* src = inside ? ph.a + (long long)(cur.rows.m[i] + shift) * ph.lda +
                                c0 + vec * VEC<T>
                          : ph.a;
    cp_async16(stage + (r0 + 32 * i) * ROW + swz, src, inside);
  }
}

// Load the cursor's chunk into ring slot `slot` (nothing once past the
// CTA's last tile), close one cp.async group, and step the cursor.
template <typename T, int BN, bool GATHER>
__device__ __forceinline__ void load_next(Cursor& cur, const Phase<T>& ph,
                                          const Geo& g, int ntn, int tiles,
                                          int chunks, int slot, uint32_t ring,
                                          uint32_t bars) {
  if (cur.tile < tiles) {
    const int s = slot % STAGES<T>;
    load_chunk<T, BN, GATHER>(ph, g, cur, ring + s * STAGE_BYTES<T>,
                              bars + 8 * s);
    if (++cur.chunk == chunks)
      seek<GATHER>(cur, cur.tile + gridDim.x, ntn, tiles, BN, g);
  }
  if (GATHER) cp_async_commit();
}

// ---------------------------------------------------------------------------
// Products: wgmma, f32 accumulators in registers
// ---------------------------------------------------------------------------

// wgmma shared-memory descriptor of a K-major tile of 128-byte rows in the
// 128-byte swizzle: 8-row groups 1024 bytes apart (SBO = 64 x 16 B); the
// leading offset is unused by this layout (1).  A K step of 32 bytes (16
// bf16, 8 floats) adds 32 to the start address.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator accesses across the async MMA
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define D8(i)                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define D64                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, " \
  "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, " \
  "%57, %58, %59, %60, %61, %62, %63}"
#define D32                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31}"

// d[64x128] += A[64x16] . B[128x16]^T, bf16, both K-major in shared memory
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t a,
                                      uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "l"(a), "l"(b), "r"(1));
}

// d[64x64] += A[64x16] . B[64x16]^T
__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t a,
                                      uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : D8(0), D8(8), D8(16), D8(24)
      : "l"(a), "l"(b), "r"(1));
}

// d[64x128] += A[64x8] . B[128x8]^T in TF32: A from registers (each
// warp's 16 rows: a0..a3 at (r, k) = (g, t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4) with g = lane / 4, t = lane % 4), B K-major in shared
// memory
__device__ __forceinline__ void wgmma(float (&d)[64], const uint32_t (&a)[4],
                                      uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[64x64] += A[64x8] . B[64x8]^T in TF32
__device__ __forceinline__ void wgmma(float (&d)[32], const uint32_t (&a)[4],
                                      uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : D8(0), D8(8), D8(16), D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef D8
#undef D64
#undef D32

// Thread layout of d (wgmma's): warp w = threadIdx.x / 32 owns tile rows
// 16w..16w+15; d[4j + e] sits at row 16w + lane/4 + 8 (e / 2), column
// 8j + 2 (lane % 4) + e % 2.

// bf16: multiply one K chunk of the stage at `st` into the accumulators.
template <int BN>
__device__ __forceinline__ void multiply_bf16(float (&d)[BN / 2],
                                              uint32_t st) {
  const uint32_t a = st + (threadIdx.x >> 7) * 64 * ROW;  // warpgroup's rows
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < BK<bf16> / 16; ++s)   // 16 bf16 = 32 bytes of K a step
    wgmma(d, desc(a + 32 * s), desc(st + B_OFFSET + 32 * s));
  wgmma_commit();
}

// f32: this warp's 16 A rows of one K chunk (32 floats, four k8 steps) in
// the register layout of wgmma's A, each value split into TF32 high and
// low parts.
struct Frag {
  uint32_t hi[BK<float> / 8][4], lo[BK<float> / 8][4];
};

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t t;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(t) : "f"(v));
  return t;
}

// ldmatrix.x4 reads four 8x8 b16 matrices, each 8 rows x 4 floats: lanes
// 8i..8i+7 address matrix i's rows, and lane l receives row l / 4, float
// l % 4 of each.  Matrices (rows 0-7, k 0-3), (8-15, 0-3), (0-7, 4-7),
// (8-15, 4-7) of a k8 step are a0..a3; in the swizzle the eight rows of a
// matrix fall on distinct banks.  v = hi + lo + (at most 2^-22 |v|), hi and
// lo exact TF32 values.
__device__ __forceinline__ void load_frag(Frag& f, uint32_t st) {
  const int lane = threadIdx.x & 31, mat = lane >> 3, r8 = lane & 7;
  const uint32_t row =
      st + (16 * (threadIdx.x >> 5) + 8 * (mat & 1) + r8) * ROW;
#pragma unroll
  for (int s = 0; s < BK<float> / 8; ++s) {
    uint32_t v[4];
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
        : "r"(row + (uint32_t)(((2 * s + (mat >> 1)) ^ r8) << 4))
        : "memory");
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f.hi[s][i] = tf32_rna(__uint_as_float(v[i]));
      f.lo[s][i] =
          tf32_rna(__uint_as_float(v[i]) - __uint_as_float(f.hi[s][i]));
    }
  }
}

// f32: multiply one K chunk in three TF32 passes, a_lo.b_hi + a_hi.b_lo +
// a_hi.b_hi per k8 step, B's high and low parts K-major in the stage.
template <int BN>
__device__ __forceinline__ void multiply_f32(float (&d)[BN / 2],
                                             const Frag& f, uint32_t st) {
  wgmma_fence();                      // f's registers written before wgmma
#pragma unroll
  for (int s = 0; s < BK<float> / 8; ++s) {   // 8 floats = 32 bytes of K
    const uint64_t bhi = desc(st + B_OFFSET + 32 * s);
    const uint64_t blo = desc(st + 2 * B_OFFSET + 32 * s);
    wgmma(d, f.lo[s], bhi);
    wgmma(d, f.hi[s], blo);
    wgmma(d, f.hi[s], bhi);
  }
  wgmma_commit();
}

// ---------------------------------------------------------------------------
// Epilogues
// ---------------------------------------------------------------------------

// bf16: the f32 staging tile [BM][STG_STRIDE]: 8-float group j of row r
// sits at group j ^ (r % 8), so that the register-layout writes and the
// row reads below both fall on distinct banks.
__device__ __forceinline__ int staged(int r, int col) {
  return r * STG_STRIDE + ((((col >> 3) ^ r) & 7) | ((col >> 3) & ~7)) * 8 +
         (col & 7);
}

// Accumulators -> the staging tile.
template <int BN>
__device__ __forceinline__ void stage_acc(const float (&d)[BN / 2],
                                          float* stg) {
  const int lane = threadIdx.x & 31;
  const int row = 16 * (threadIdx.x >> 5) + (lane >> 2), col = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(stg + staged(row + 8 * h, 8 * j + col)) =
          make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
}

__device__ __forceinline__ float4 bf16x4(uint32_t lo, uint32_t hi) {
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&lo);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&hi);
  return make_float4(__low2float(a), __high2float(a), __low2float(b),
                     __high2float(b));
}
__device__ __forceinline__ uint32_t pack_relu(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(fmaxf(a, 0.f), fmaxf(b, 0.f));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// bf16: the epilogue of one tile from the staging tile: 8 consecutive
// channels of one row per thread and step, scale and bias, residual in f32,
// relu, rounded once, 16 bytes stored.
template <int BN>
struct Res {
  uint4 v[BM * BN / 8 / THREADS];
};

template <int BN>
__device__ __forceinline__ void load_res(const Phase<bf16>& ph, const Geo& g,
                                         int m0, int n0, Res<BN>& res) {
  constexpr int VPR = BN / 8;
#pragma unroll
  for (int i = 0; i < BM * VPR / THREADS; ++i) {
    const int v = threadIdx.x + i * THREADS;
    const int m = m0 + v / VPR;
    res.v[i] = make_uint4(0u, 0u, 0u, 0u);
    if (m < g.M)
      res.v[i] = __ldcg(reinterpret_cast<const uint4*>(
          ph.res + (long long)m * ph.n_out + n0 + 8 * (v % VPR)));
  }
}

template <int BN, bool RES>
__device__ __forceinline__ void store_tile(const Phase<bf16>& ph,
                                           const Geo& g, int m0, int n0,
                                           const float* stg,
                                           const Res<BN>& res) {
  constexpr int VPR = BN / 8;         // 16-byte output vectors per row
#pragma unroll
  for (int i = 0; i < BM * VPR / THREADS; ++i) {
    const int v = threadIdx.x + i * THREADS;
    const int r = v / VPR, cv = v % VPR;
    const int m = m0 + r;
    if (m >= g.M) continue;
    const int n = n0 + 8 * cv;
    // a thread whose group landed in the upper half of a 32-bank row reads
    // its two halves in the other order: each eight threads' 16-byte reads
    // then cover the 32 banks once
    const float* s = stg + staged(r, 8 * cv);
    const bool swap = (((cv ^ r) & 7) >> 2) & 1;
    const float4 p0 = *reinterpret_cast<const float4*>(s + (swap ? 4 : 0));
    const float4 p1 = *reinterpret_cast<const float4*>(s + (swap ? 0 : 4));
    const float4 lo = swap ? p1 : p0, hi = swap ? p0 : p1;
    const float4 s0 = __ldg(reinterpret_cast<const float4*>(ph.sb + n));
    const float4 s1 = __ldg(reinterpret_cast<const float4*>(ph.sb + n + 4));
    const float4 b0 =
        __ldg(reinterpret_cast<const float4*>(ph.sb + ph.n_out + n));
    const float4 b1 =
        __ldg(reinterpret_cast<const float4*>(ph.sb + ph.n_out + n + 4));
    float o[8] = {lo.x * s0.x + b0.x, lo.y * s0.y + b0.y, lo.z * s0.z + b0.z,
                  lo.w * s0.w + b0.w, hi.x * s1.x + b1.x, hi.y * s1.y + b1.y,
                  hi.z * s1.z + b1.z, hi.w * s1.w + b1.w};
    const long long at = (long long)m * ph.n_out + n;
    if (RES) {
      const uint4 rv = res.v[i];
      const float4 r0 = bf16x4(rv.x, rv.y), r1 = bf16x4(rv.z, rv.w);
      o[0] += r0.x; o[1] += r0.y; o[2] += r0.z; o[3] += r0.w;
      o[4] += r1.x; o[5] += r1.y; o[6] += r1.z; o[7] += r1.w;
    }
    __stcg(reinterpret_cast<uint4*>(ph.out + at),
           make_uint4(pack_relu(o[0], o[1]), pack_relu(o[2], o[3]),
                      pack_relu(o[4], o[5]), pack_relu(o[6], o[7])));
  }
}

// f32: the epilogue straight from the accumulators, no staging: a quad of
// lanes holds 8 consecutive floats of a row, so each 8-byte store fills its
// share of a whole 32-byte sector.  The residual (read where y is written,
// in place) is loaded whole before the first store.
template <int BN, bool RES>
__device__ __forceinline__ void store_acc(const Phase<float>& ph,
                                          const Geo& g, int m0, int n0,
                                          const float (&d)[BN / 2]) {
  const int lane = threadIdx.x & 31;
  const int r = m0 + 16 * (threadIdx.x >> 5) + (lane >> 2);
  const int c = n0 + 2 * (lane & 3);
  float2 res[BN / 8][2];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      res[j][h] = make_float2(0.f, 0.f);
      if (RES && r + 8 * h < g.M)
        res[j][h] = __ldcg(reinterpret_cast<const float2*>(
            ph.res + (long long)(r + 8 * h) * ph.n_out + c + 8 * j));
    }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const float2 sc = __ldg(reinterpret_cast<const float2*>(ph.sb + c + 8 * j));
    const float2 bi = __ldg(
        reinterpret_cast<const float2*>(ph.sb + ph.n_out + c + 8 * j));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (r + 8 * h >= g.M) continue;
      float o0 = d[4 * j + 2 * h] * sc.x + bi.x;
      float o1 = d[4 * j + 2 * h + 1] * sc.y + bi.y;
      if (RES) {
        o0 += res[j][h].x;
        o1 += res[j][h].y;
      }
      __stcg(reinterpret_cast<float2*>(
                 ph.out + (long long)(r + 8 * h) * ph.n_out + c + 8 * j),
             make_float2(fmaxf(o0, 0.f), fmaxf(o1, 0.f)));
    }
  }
}

// ---------------------------------------------------------------------------
// The tile walk
// ---------------------------------------------------------------------------

// Wait for chunk q (this thread's gathered rows and its TMA copies), hand
// its stage to the CTA, post the copies of chunk q + AHEAD into the stage
// of chunk q - 2 (its products are done) and return q's stage.
template <typename T, int BN, bool GATHER>
__device__ __forceinline__ uint32_t next_stage(Cursor& cur,
                                               const Phase<T>& ph,
                                               const Geo& g, int ntn,
                                               int tiles, int chunks, int q,
                                               uint32_t ring, uint32_t bars) {
  constexpr int ahead = AHEAD<T>;
  const int s = q % STAGES<T>;
  if (GATHER) {
    cp_async_wait<ahead - 1>();
    if (!IS_F32<T>) fence_proxy_async_smem();   // visible to wgmma
  }
  mbar_wait(bars + 8 * s, (q / STAGES<T>) & 1);
  __syncthreads();
  load_next<T, BN, GATHER>(cur, ph, g, ntn, tiles, chunks, q + ahead, ring,
                           bars);
  return ring + s * STAGE_BYTES<T>;
}

// Every tile of one phase that falls to this CTA: tiles blockIdx.x,
// blockIdx.x + gridDim.x, ...; tile t is row band t / (n_out / BN), column
// tile t % (n_out / BN).  The q-th chunk the CTA multiplies in the launch
// sits in ring stage q % STAGES, whose mbarrier completes its (q /
// STAGES)-th phase when the chunk's TMA copies have landed.  One commit
// group a chunk; bf16 lets it run on under the next chunk, f32 waits for
// it (so that no wgmma is in flight while A's registers are rewritten:
// two sets in flight cost ptxas's serialization of every wgmma, C7512).
// GATHER (the 3x3 conv) and RES (the expand's residual) are compile-time,
// so each phase keeps only its own state in registers beside the
// accumulators.
template <typename T, int BN, bool GATHER, bool RES>
__device__ void run_phase(const Phase<T>& ph, const Geo& g, uint32_t ring,
                          uint32_t bars, float* stg, int& q) {
  const int ntn = ph.n_out / BN;
  const int tiles = (g.M + BM - 1) / BM * ntn;
  const int chunks = ph.K / BK<T>;
  Cursor cur;
  seek<GATHER>(cur, blockIdx.x, ntn, tiles, BN, g);
#pragma unroll
  for (int i = 0; i < AHEAD<T>; ++i)
    load_next<T, BN, GATHER>(cur, ph, g, ntn, tiles, chunks, q + i, ring,
                             bars);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / ntn * BM, n0 = tile % ntn * BN;
    Res<BN> res;                      // bf16: loads under the K loop
    if constexpr (!IS_F32<T>)
      if (RES) load_res<BN>(ph, g, m0, n0, res);
    float d[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;
    for (int c = 0; c < chunks; ++c, ++q) {
      const uint32_t st = next_stage<T, BN, GATHER>(cur, ph, g, ntn, tiles,
                                                    chunks, q, ring, bars);
      if constexpr (IS_F32<T>) {
        Frag f;
        load_frag(f, st);
        fence_acc(d);
        multiply_f32<BN>(d, f, st);
        wgmma_wait<0>();
      } else {
        fence_acc(d);
        multiply_bf16<BN>(d, st);
        wgmma_wait<1>();              // chunk q - 1's products are done
      }
      fence_acc(d);
    }
    wgmma_wait<0>();
    fence_acc(d);
    if constexpr (IS_F32<T>) {
      store_acc<BN, RES>(ph, g, m0, n0, d);
    } else {
      stage_acc<BN>(d, stg);
      __syncthreads();                // the staging tile is written
      store_tile<BN, RES>(ph, g, m0, n0, stg, res);
    }
  }
}

template <typename T, bool GATHER, bool RES>
__device__ __forceinline__ void run(const Phase<T>& ph, const Geo& g,
                                    uint32_t ring, uint32_t bars, float* stg,
                                    int& q) {
  if (ph.n_out % 128 == 0)
    run_phase<T, 128, GATHER, RES>(ph, g, ring, bars, stg, q);
  else
    run_phase<T, 64, GATHER, RES>(ph, g, ring, bars, stg, q);
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}
// Grid-wide barrier (all CTAs are resident: cooperative launch).  CTA 0
// adds 2^31 - (gridDim.x - 1) to the counter and every other CTA 1, so the
// top bit flips when the last one arrives and the low bits return to where
// they were: the counter needs no reset between barriers or launches, only
// to start at 0.  Thread 0, which posts the TMA copies, then orders them
// (async proxy) after the other CTAs' stores (generic proxy).
__device__ void grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned add =
        blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    __threadfence();                  // this CTA's writes before arriving
    const unsigned old = atomicAdd(bar, add);
    const unsigned long long t0 = now_ns();
    while (((old ^ ld_acquire(bar)) & 0x80000000u) == 0) check_timeout(t0);
    __threadfence();
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
    // and the next phase's TMA copies after this phase's cp.async writes
    // to the same stages
    fence_proxy_async_smem();
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    stack_kernel(const __grid_constant__ Stack<T> p) {
  extern __shared__ uint8_t smem[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t ring = (raw + 1023u) & ~1023u;   // swizzle atoms: 1024 B
  float* stg = reinterpret_cast<float*>(smem + (ring - raw) +
                                        STAGES<T> * STAGE_BYTES<T>);
  const uint32_t bars = ring + STAGES<T> * STAGE_BYTES<T> + STG_BYTES<T>;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES<T>; ++s) mbar_init(bars + 8 * s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int q = 0;                          // chunks multiplied so far
  const Geo g{p.M, p.H * p.W, p.H, p.W};
  const int nwd = p.nblk * p.Wd, nc = p.nblk * p.C;  // f32: rows of the
                                                     // low parts' offset
  for (int b = 0; b < p.nblk; ++b) {
    const T* src = b == 0 ? p.x : p.y;
    const Phase<T> reduce{src, p.C, b == 0 ? &p.mx : &p.my, &p.mw1, b * p.Wd,
                          nwd + b * p.Wd, p.sb1 + 2 * b * p.Wd, nullptr,
                          p.h1, p.Wd, p.C};
    run<T, false, false>(reduce, g, ring, bars, stg, q);
    grid_sync(p.bar);                 // h1 complete before its 3x3 reads
    const Phase<T> spatial{p.h1, p.Wd, nullptr, &p.mw2, b * p.Wd,
                           nwd + b * p.Wd, p.sb2 + 2 * b * p.Wd, nullptr,
                           p.h2, p.Wd, 9 * p.Wd};
    run<T, true, false>(spatial, g, ring, bars, stg, q);
    grid_sync(p.bar);
    const Phase<T> expand{p.h2, p.Wd, &p.mh2, &p.mw3, b * p.C, nc + b * p.C,
                          p.sb3 + 2 * b * p.C, src, p.y, p.C, p.Wd};
    run<T, false, true>(expand, g, ring, bars, stg, q);
    if (b + 1 < p.nblk) grid_sync(p.bar);  // y complete before the next
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* entry = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &entry,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(entry);
  }
  return fn;
}

// The tensor map of a matrix [rows, cols] of T (cols contiguous) in boxes
// of one 128-byte row of columns (the 128-byte swizzle) by box_rows rows.
template <typename T>
bool tile_map(CUtensorMap* map, const void* base, long long rows, int cols,
              int box_rows) {
  const EncodeTiled encode = encoder();
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)BK<T>, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  return encode != nullptr &&
         encode(map,
                IS_F32<T> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                2, const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tile width `run` gives a phase of n_out output channels.
int tile_cols(int n_out) { return n_out % 128 == 0 ? 128 : 64; }

// One CTA per SM (times the occupancy), no more than the widest phase has
// tiles, nor than max_ctas where that is above 0.
template <typename T>
cudaError_t launch(Stack<T>& p, const void* w1, const void* w2,
                   const void* w3, int max_ctas, cudaStream_t s) {
  const long long M = p.M;
  const long long parts = IS_F32<T> ? 2 : 1;   // f32: high, low parts
  if (!(tile_map<T>(&p.mx, p.x, M, p.C, BM) &&
        tile_map<T>(&p.my, p.y, M, p.C, BM) &&
        tile_map<T>(&p.mh2, p.h2, M, p.Wd, BM) &&
        tile_map<T>(&p.mw1, w1, parts * p.nblk * p.Wd, p.C,
                    tile_cols(p.Wd)) &&
        tile_map<T>(&p.mw2, w2, parts * p.nblk * p.Wd, 9 * p.Wd,
                    tile_cols(p.Wd)) &&
        tile_map<T>(&p.mw3, w3, parts * p.nblk * p.C, p.Wd,
                    tile_cols(p.C))))
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(stack_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES<T>);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, stack_kernel<T>, THREADS, SMEM_BYTES<T>);
  if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
  const long long bands = (M + BM - 1) / BM;
  long long grid = (long long)per_sm * sms;
  grid = std::min(grid, bands * std::max(p.Wd / tile_cols(p.Wd),
                                         p.C / tile_cols(p.C)));
  if (max_ctas > 0) grid = std::min(grid, (long long)max_ctas);
  if (e == cudaSuccess && grid < 1) e = cudaErrorCooperativeLaunchTooLarge;
  if (e == cudaSuccess) {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeCooperative;   // every CTA resident
    attr[0].val.cooperative = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)grid);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = SMEM_BYTES<T>;
    cfg.stream = s;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, stack_kernel<T>, p);
  }
  const cudaError_t last = cudaGetLastError();     // clears a launch error
  return e != cudaSuccess ? e : last;
}

template <typename T>
int launch_as(const void* x, void* y, void* h1, void* h2, const void* w1,
              const void* sb1, const void* w2, const void* sb2,
              const void* w3, const void* sb3, void* bar, int N, int H,
              int W, int C, int Wd, int nblk, int max_ctas,
              cudaStream_t s) {
  Stack<T> p{};
  p.x = (const T*)x;
  p.y = (T*)y;
  p.h1 = (T*)h1;
  p.h2 = (T*)h2;
  p.sb1 = (const float*)sb1;
  p.sb2 = (const float*)sb2;
  p.sb3 = (const float*)sb3;
  p.bar = (unsigned*)bar;
  p.nblk = nblk;
  p.M = N * H * W;
  p.H = H;
  p.W = W;
  p.C = C;
  p.Wd = Wd;
  return (int)launch<T>(p, w1, w2, w3, max_ctas, s);
}

}  // namespace gemm

int dispatch(const void* x, void* y, void* h1, void* h2, const void* w1,
             const void* sb1, const void* w2, const void* sb2, const void* w3,
             const void* sb3, void* bar, int N, int H, int W, int C, int Wd,
             int nblk, int max_ctas, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (N < 1 || H < 1 || W < 1 || nblk < 1 || C < 64 || Wd < 64 ||
      C % 64 != 0 || Wd % 64 != 0 || bar == nullptr ||
      (long long)N * H * W > 0x7fffffffLL / (C > Wd ? C : Wd))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return gemm::launch_as<float>(x, y, h1, h2, w1, sb1, w2, sb2, w3, sb3,
                                  bar, N, H, W, C, Wd, nblk, max_ctas, s);
  if (dtype == 1)
    return gemm::launch_as<gemm::bf16>(x, y, h1, h2, w1, sb1, w2, sb2, w3,
                                       sb3, bar, N, H, W, C, Wd, nblk,
                                       max_ctas, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Either is a cooperative launch of one
// CTA per SM, or of at most max_ctas where that is above 0; bar: a zeroed
// uint32 in device memory.  Each returns the launch's CUDA error (0 =
// launched), on `stream`, without synchronising.

// Kernel #3: one identity bottleneck.
extern "C" int fused_bottleneck(const void* x, void* y, void* h1, void* h2,
                                const void* w1, const void* sb1,
                                const void* w2, const void* sb2,
                                const void* w3, const void* sb3, void* bar,
                                int N, int H, int W, int C, int Wd,
                                int max_ctas, int dtype, void* stream) {
  return dispatch(x, y, h1, h2, w1, sb1, w2, sb2, w3, sb3, bar, N, H, W, C,
                  Wd, 1, max_ctas, dtype, stream);
}

// Kernel #4: a stack of nblk identity bottlenecks in one launch.
extern "C" int fused_stage(const void* x, void* y, void* h1, void* h2,
                           const void* w1, const void* sb1, const void* w2,
                           const void* sb2, const void* w3, const void* sb3,
                           void* bar, int N, int H, int W, int C, int Wd,
                           int nblk, int max_ctas, int dtype, void* stream) {
  return dispatch(x, y, h1, h2, w1, sb1, w2, sb2, w3, sb3, bar, N, H, W, C,
                  Wd, nblk, max_ctas, dtype, stream);
}
