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
// operations per byte, so the least time is the tensor cores' (bf16) or the
// CUDA cores' (f32) rate.  The TPU kernel keeps a batch tile of whole crops
// and all the stage's weights in VMEM (48 MB for stage 3); an SM has 227 KB,
// so both designs below keep h1, h2 and the running y in global memory (L2
// for the most part) and write y in place: the expand phase reads its
// residual at exactly the element it writes.
//
// bf16, the main path (stack_kernel): every phase of every block is one
// GEMM over all crops at once.
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
//     (chip_smoke.py checks both).
//   - K chunks of 64 bf16 (128-byte rows) stream through a 5-stage ring in
//     dynamic shared memory, three chunks in flight ahead of the multiply
//     and across tile boundaries (a phase of one or four chunks a tile
//     still keeps three in flight), in the 128-byte-swizzled K-major layout
//     that wgmma reads (16-byte unit j of row r at j ^ (r % 8)).  The
//     weights (B) and the 1x1 convs' A rows come by TMA (tensor maps built
//     here, one mbarrier per stage counting the bytes); the 3x3 conv's
//     gathered A rows come by 16-byte cp.async.cg with zero-fill, and each
//     thread fences them into the async proxy (fence.proxy.async) before
//     the barrier that hands the stage to wgmma.  A chunk's copies are
//     posted as soon as the barrier frees their stage, before the chunk in
//     hand is multiplied.
//   - Two warpgroups of 64 rows each issue wgmma.mma_async m64n128k16
//     (m64n64k16) from shared-memory descriptors, f32 accumulators in
//     registers, one commit group per chunk with the next chunk's group
//     allowed in flight.
//   - Epilogue: the expand phase's residual tile is loaded into registers
//     before its K loop; the accumulators go through an f32 staging tile
//     in shared memory (64 KB beside the 160 KB ring), so each thread then
//     applies scale and bias, adds the residual in f32, applies relu,
//     rounds once and stores 16 bytes, while the next tile's chunks load.
//   What holds it back, from per-phase timer stamps taken while the design
//   was brought up (PERF.md, NVIDIA H100, 192 stage-3 crops): a chunk
//   takes the same time per CTA on 66, 99 or 132 CTAs, so no resource
//   shared between SMs (L2, HBM) sets the pace; the 3x3 phase takes about
//   the sum, not the larger, of its copy-only and multiply-only times,
//   since every warp both copies and multiplies and one barrier a chunk
//   ties them; the expand phase is bound by its epilogue (77 MB of y read
//   and written per block); and a phase whose tile count is not a
//   multiple of the grid idles part of its last wave.  Scratch traffic is
//   the design's own cost: y, h1 and h2 go through L2 and, where they
//   outgrow its 50 MB, through HBM, once per phase.
//
// f32, the check route (bottleneck_stack_kernel): one 128-thread block per
// crop walks every block of the stack and its three phases in order with
// __syncthreads() between them, each phase an implicit GEMM over 64x64
// output tiles and 32-deep K chunks with one register stage of prefetch,
// FMAs on the CUDA cores.  Bound by the CUDA cores' f32 rate and, at N
// crops below 2x the SM count, by the blocks' imbalance over the SMs.
//
// Shapes: C and Wd multiples of 64, any H, W and N >= 1.  Weights K-major:
// w1 [n, Wd, C], w2 [n, Wd, 3, 3, Wd] (out, tap row, tap col, in), w3
// [n, C, Wd], in x's type; scale and bias rows sb1 [n, 2, Wd], sb2
// [n, 2, Wd], sb3 [n, 2, C] in f32.  The caller supplies h1 and h2 scratch
// of N*H*W*Wd elements each and, for bf16, a zeroed 32-bit barrier word.

#include <cuda.h>      // CUtensorMap and its enums; the encoder is reached
                       // through cudaGetDriverEntryPoint: no libcuda link
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

// ===========================================================================
// bf16: all crops in one GEMM per phase, persistent cooperative grid, wgmma
// ===========================================================================

namespace gemm {

constexpr int BM = 128;               // output rows (pixels) per tile
constexpr int BK = 64;                // K chunk: one 128-byte bf16 row
constexpr int THREADS = 256;          // two warpgroups of 64 rows each
constexpr int STAGES = 5;             // ring of K chunks
constexpr int AHEAD = STAGES - 2;     // chunks loading ahead of the multiply
constexpr int B_OFFSET = BM * 128;    // a stage: A 128x64, then B <= 128x64
constexpr int STAGE_BYTES = 2 * B_OFFSET;
constexpr int STG_STRIDE = 128;       // f32 staging row (8-float groups
                                      // XOR-swizzled by row % 8)
constexpr int STG_BYTES = BM * STG_STRIDE * 4;
constexpr int SMEM_BYTES =            // + one mbarrier per stage
    1024 + STAGES * STAGE_BYTES + STG_BYTES + 8 * STAGES;

struct Geo {
  int M, P, H, W;                     // rows, pixels per crop, crop size
};

// One conv of a block as a GEMM: out[m, n] = epilogue(sum_k A[m, k] w[n, k]).
// A is `a` [M, lda] for a 1x1 conv; for the 3x3 conv k = tap * lda + c and
// A[m, k] = a[pixel m shifted by the tap within its crop, c].
// A 1x1 conv's A tiles come by TMA through `amap`; the 3x3 conv gathers
// its A rows from `a` by cp.async (amap is null).  B tiles always come by
// TMA: rows brow + n of `bmap`, the block's weights in the stacked array.
struct Phase {
  const __nv_bfloat16* a;
  int lda;
  const CUtensorMap* amap;
  const CUtensorMap* bmap;            // [nblk * n_out, K]
  int brow;
  const float* sb;                    // [2, n_out]: scale row, bias row
  const __nv_bfloat16* res;           // residual [M, n_out] or nullptr
  __nv_bfloat16* out;                 // [M, n_out]
  int n_out;
  int K;
};

// Tensor maps of x, y, h2 [M, C or Wd] (boxes of 128 rows) and of the
// stacked weights (boxes of the phase's tile width), 64 columns a box.
struct Stack {
  CUtensorMap mx, my, mh2, mw1, mw2, mw3;
  const __nv_bfloat16* x;
  __nv_bfloat16* y;
  __nv_bfloat16* h1;
  __nv_bfloat16* h2;
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
// this thread's shared-memory writes (generic proxy) before later reads by
// wgmma or TMA (async proxy)
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
template <int BN, bool GATHER>
__device__ __forceinline__ void load_chunk(const Phase& ph, const Geo& g,
                                           const Cursor& cur, uint32_t stage,
                                           uint32_t bar) {
  const int k0 = cur.chunk * BK;
  if (threadIdx.x == 0) {
    mbar_expect(bar, (GATHER ? 0 : BM * 128) + BN * 128);
    if (!GATHER) tma_load(stage, ph.amap, k0, cur.m0, bar);
    tma_load(stage + B_OFFSET, ph.bmap, k0, ph.brow + cur.n0, bar);
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
    const __nv_bfloat16* src =
        inside ? ph.a + (long long)(cur.rows.m[i] + shift) * ph.lda + c0 +
                     vec * 8
               : ph.a;
    cp_async16(stage + (r0 + 32 * i) * 128 + swz, src, inside);
  }
}

// Load the cursor's chunk into ring slot `slot` (nothing once past the
// CTA's last tile), close one cp.async group, and step the cursor.
template <int BN, bool GATHER>
__device__ __forceinline__ void load_next(Cursor& cur, const Phase& ph,
                                          const Geo& g, int ntn, int tiles,
                                          int chunks, int slot, uint32_t ring,
                                          uint32_t bars) {
  if (cur.tile < tiles) {
    const int s = slot % STAGES;
    load_chunk<BN, GATHER>(ph, g, cur, ring + s * STAGE_BYTES, bars + 8 * s);
    if (++cur.chunk == chunks)
      seek<GATHER>(cur, cur.tile + gridDim.x, ntn, tiles, BN, g);
  }
  if (GATHER) cp_async_commit();
}

// wgmma shared-memory descriptor of a K-major tile of 128-byte rows in the
// 128-byte swizzle: 8-row groups 1024 bytes apart (SBO = 64 x 16 B); the
// leading offset is unused by this layout (1).
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

// d[64x128] += A[64x16] . B[128x16]^T, both K-major in shared memory
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t a,
                                      uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "l"(a), "l"(b), "r"(1));
}

// d[64x64] += A[64x16] . B[64x16]^T
__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t a,
                                      uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : D8(0), D8(8), D8(16), D8(24)
      : "l"(a), "l"(b), "r"(1));
}

#undef D8

// Multiply one K chunk of the stage at `st` into the accumulators.  Thread
// layout of d (wgmma's): warp w = threadIdx.x / 32 owns tile rows
// 16w..16w+15; d[4j + e] sits at row 16w + lane/4 + 8 (e / 2), column
// 8j + 2 (lane % 4) + e % 2.
template <int BN>
__device__ __forceinline__ void multiply_chunk(float (&d)[BN / 2],
                                               uint32_t st) {
  const uint32_t a = st + (threadIdx.x >> 7) * 64 * 128;  // warpgroup's rows
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < BK / 16; ++s)   // 16 bf16 = 32 bytes of K per step
    wgmma(d, desc(a + 32 * s), desc(st + B_OFFSET + 32 * s));
  wgmma_commit();
}

// The f32 staging tile [BM][STG_STRIDE]: 8-float group j of row r sits at
// group j ^ (r % 8), so that the register-layout writes and the row reads
// below both fall on distinct banks.
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

// The epilogue of one tile from the staging tile: 8 consecutive channels
// of one row per thread and step, scale and bias, residual in f32, relu,
// rounded once, 16 bytes stored.
template <int BN>
struct Res {
  uint4 v[BM * BN / 8 / THREADS];
};

template <int BN>
__device__ __forceinline__ void load_res(const Phase& ph, const Geo& g,
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
__device__ __forceinline__ void store_tile(const Phase& ph, const Geo& g,
                                           int m0, int n0, const float* stg,
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

// Every tile of one phase that falls to this CTA: tiles blockIdx.x,
// blockIdx.x + gridDim.x, ...; tile t is row band t / (n_out / BN), column
// tile t % (n_out / BN).  The q-th chunk the CTA multiplies in the launch
// sits in ring stage q % STAGES, whose mbarrier completes its (q /
// STAGES)-th phase when the chunk's TMA copies have landed.  GATHER (the
// 3x3 conv) and RES (the expand's residual) are compile-time, so each
// phase keeps only its own state in registers beside the accumulators.
template <int BN, bool GATHER, bool RES>
__device__ void run_phase(const Phase& ph, const Geo& g, uint32_t ring,
                          uint32_t bars, float* stg, int& q) {
  const int ntn = ph.n_out / BN;
  const int tiles = (g.M + BM - 1) / BM * ntn;
  const int chunks = ph.K / BK;
  Cursor cur;
  seek<GATHER>(cur, blockIdx.x, ntn, tiles, BN, g);
#pragma unroll
  for (int i = 0; i < AHEAD; ++i)
    load_next<BN, GATHER>(cur, ph, g, ntn, tiles, chunks, q + i, ring, bars);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / ntn * BM, n0 = tile % ntn * BN;
    Res<BN> res;                      // loads under the K loop
    if (RES) load_res<BN>(ph, g, m0, n0, res);
    float d[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;
    for (int c = 0; c < chunks; ++c, ++q) {
      const int s = q % STAGES;
      if (GATHER) {                   // this thread's rows of q, visible
        cp_async_wait<AHEAD - 1>();   // to wgmma
        fence_proxy_async_smem();
      }
      mbar_wait(bars + 8 * s, (q / STAGES) & 1);   // chunk q's TMA copies
      __syncthreads();                // everyone's rows; q - 2 is consumed
      load_next<BN, GATHER>(cur, ph, g, ntn, tiles, chunks, q + AHEAD,
                            ring, bars);    // into q - 2's stage
      fence_acc(d);
      multiply_chunk<BN>(d, ring + s * STAGE_BYTES);
      wgmma_wait<1>();                // chunk q - 1's products are done
      fence_acc(d);
    }
    wgmma_wait<0>();
    fence_acc(d);
    stage_acc<BN>(d, stg);
    __syncthreads();                  // the staging tile is written
    store_tile<BN, RES>(ph, g, m0, n0, stg, res);
  }
}

template <bool GATHER, bool RES>
__device__ __forceinline__ void run(const Phase& ph, const Geo& g,
                                    uint32_t ring, uint32_t bars, float* stg,
                                    int& q) {
  if (ph.n_out % 128 == 0)
    run_phase<128, GATHER, RES>(ph, g, ring, bars, stg, q);
  else
    run_phase<64, GATHER, RES>(ph, g, ring, bars, stg, q);
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

__global__ void __launch_bounds__(THREADS, 1)
    stack_kernel(const __grid_constant__ Stack p) {
  extern __shared__ uint8_t smem[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t ring = (raw + 1023u) & ~1023u;   // swizzle atoms: 1024 B
  float* stg =
      reinterpret_cast<float*>(smem + (ring - raw) + STAGES * STAGE_BYTES);
  const uint32_t bars = ring + STAGES * STAGE_BYTES + STG_BYTES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(bars + 8 * s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int q = 0;                          // chunks multiplied so far
  const Geo g{p.M, p.H * p.W, p.H, p.W};
  for (int b = 0; b < p.nblk; ++b) {
    const __nv_bfloat16* src = b == 0 ? p.x : p.y;
    const Phase reduce{src, p.C, b == 0 ? &p.mx : &p.my, &p.mw1, b * p.Wd,
                       p.sb1 + 2 * b * p.Wd, nullptr, p.h1, p.Wd, p.C};
    run<false, false>(reduce, g, ring, bars, stg, q);
    grid_sync(p.bar);                 // h1 complete before its 3x3 reads
    const Phase spatial{p.h1, p.Wd, nullptr, &p.mw2, b * p.Wd,
                        p.sb2 + 2 * b * p.Wd, nullptr, p.h2, p.Wd, 9 * p.Wd};
    run<true, false>(spatial, g, ring, bars, stg, q);
    grid_sync(p.bar);
    const Phase expand{p.h2, p.Wd, &p.mh2, &p.mw3, b * p.C,
                       p.sb3 + 2 * b * p.C, src, p.y, p.C, p.Wd};
    run<false, true>(expand, g, ring, bars, stg, q);
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

// The tensor map of a bf16 matrix [rows, cols] (cols contiguous) in boxes
// of 64 columns (128 bytes, the 128-byte swizzle) by box_rows rows.
bool tile_map(CUtensorMap* map, const void* base, long long rows, int cols,
              int box_rows) {
  const EncodeTiled encode = encoder();
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  return encode != nullptr &&
         encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tile width `run` gives a phase of n_out output channels.
int tile_cols(int n_out) { return n_out % 128 == 0 ? 128 : 64; }

// One CTA per SM (times the occupancy), no more than the widest phase has
// tiles, nor than max_ctas where that is above 0.
cudaError_t launch(Stack& p, const void* w1, const void* w2, const void* w3,
                   int max_ctas, cudaStream_t s) {
  const long long M = p.M;
  if (!(tile_map(&p.mx, p.x, M, p.C, BM) && tile_map(&p.my, p.y, M, p.C, BM) &&
        tile_map(&p.mh2, p.h2, M, p.Wd, BM) &&
        tile_map(&p.mw1, w1, (long long)p.nblk * p.Wd, p.C, tile_cols(p.Wd)) &&
        tile_map(&p.mw2, w2, (long long)p.nblk * p.Wd, 9 * p.Wd,
                 tile_cols(p.Wd)) &&
        tile_map(&p.mw3, w3, (long long)p.nblk * p.C, p.Wd, tile_cols(p.C))))
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(stack_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stack_kernel,
                                                      THREADS, SMEM_BYTES);
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
    cfg.dynamicSmemBytes = SMEM_BYTES;
    cfg.stream = s;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, stack_kernel, p);
  }
  const cudaError_t last = cudaGetLastError();     // clears a launch error
  return e != cudaSuccess ? e : last;
}

}  // namespace gemm

// ===========================================================================
// f32: one thread block per crop, FMAs on the CUDA cores
// ===========================================================================

constexpr int BM = 64;        // output pixels per tile
constexpr int BN = 64;        // output channels per tile
constexpr int BK = 32;        // depth of one K chunk
constexpr int THREADS = 128;  // four warps, a 32x32 sub-tile each
constexpr int PAD = 4;        // row stride 36 floats: no bank conflicts

struct Smem {
  float a[BM][BK + PAD];      // A tile: pixel-major, K contiguous
  float b[BN][BK + PAD];      // B tile: channel-major, K contiguous
};

// 16-byte vectors each thread moves per tile of A (and of B)
constexpr int LOADS = BM * BK * 4 / 16 / THREADS;

// One convolution of a block as a GEMM: out[p, n] = epilogue(sum_k
// A[p, k] * w[n, k]).  A is `a` [P, lda] for a 1x1 conv; for the 3x3 conv
// k = tap * lda + c and A[p, k] = a[pixel p shifted by tap, c].
struct Phase {
  const float* a;
  int lda;
  const float* w;     // [n_out, K]
  const float* sb;    // [2, n_out]: the scale row, then the bias row
  const float* res;   // residual [P, n_out] or nullptr
  float* out;         // [P, n_out]
  int n_out;
  int K;
  bool conv3x3;
};

__device__ __forceinline__ void load_chunk(const Phase& ph, int P, int H,
                                           int W, int m0, int n0, int k0,
                                           uint4 (&ra)[LOADS],
                                           uint4 (&rb)[LOADS]) {
  constexpr int VEC = 4;
  constexpr int PER_ROW = BK / VEC;
  int c0 = k0, dy = 0, dx = 0;
  if (ph.conv3x3) {              // a chunk never straddles two taps
    const int tap = k0 / ph.lda;
    c0 = k0 - tap * ph.lda;
    dy = tap / 3 - 1;
    dx = tap % 3 - 1;
  }
#pragma unroll
  for (int i = 0; i < LOADS; ++i) {
    const int v = threadIdx.x + i * THREADS;
    const int row = v / PER_ROW;
    const int kk = (v % PER_ROW) * VEC;
    const int p = m0 + row;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (p < P) {
      int q = p;
      bool inside = true;
      if (ph.conv3x3) {
        const int py = p / W + dy, px = p % W + dx;
        inside = py >= 0 && py < H && px >= 0 && px < W;
        q = py * W + px;
      }
      if (inside)
        val = *reinterpret_cast<const uint4*>(ph.a + (long long)q * ph.lda +
                                              c0 + kk);
    }
    ra[i] = val;
    rb[i] = *reinterpret_cast<const uint4*>(
        ph.w + (long long)(n0 + row) * ph.K + k0 + kk);
  }
}

__device__ __forceinline__ void store_chunk(Smem& sm,
                                            const uint4 (&ra)[LOADS],
                                            const uint4 (&rb)[LOADS]) {
  constexpr int VEC = 4;
  constexpr int PER_ROW = BK / VEC;
#pragma unroll
  for (int i = 0; i < LOADS; ++i) {
    const int v = threadIdx.x + i * THREADS;
    const int row = v / PER_ROW;
    const int kk = (v % PER_ROW) * VEC;
    *reinterpret_cast<uint4*>(&sm.a[row][kk]) = ra[i];
    *reinterpret_cast<uint4*>(&sm.b[row][kk]) = rb[i];
  }
}

// acc[mi][ni][e]: element e of the warp's 32x32 sub-tile block (mi, ni)
// sits at row g + 8*(e/2), column 2t + e%2 (the mma m16n8 layout).
__device__ __forceinline__ void multiply_chunk(Smem& sm, float (&acc)[2][4][4],
                                               int wm, int wn, int g, int t) {
#pragma unroll 8
  for (int k = 0; k < BK; ++k) {
    float a[2][2], b[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      a[mi][0] = sm.a[wm + mi * 16 + g][k];
      a[mi][1] = sm.a[wm + mi * 16 + g + 8][k];
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      b[ni][0] = sm.b[wn + ni * 8 + 2 * t][k];
      b[ni][1] = sm.b[wn + ni * 8 + 2 * t + 1][k];
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        acc[mi][ni][0] = fmaf(a[mi][0], b[ni][0], acc[mi][ni][0]);
        acc[mi][ni][1] = fmaf(a[mi][0], b[ni][1], acc[mi][ni][1]);
        acc[mi][ni][2] = fmaf(a[mi][1], b[ni][0], acc[mi][ni][2]);
        acc[mi][ni][3] = fmaf(a[mi][1], b[ni][1], acc[mi][ni][3]);
      }
  }
}

__device__ void run_phase(const Phase& ph, int P, int H, int W, Smem& sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int ntiles = ph.n_out / BN;
  const int tiles = (P + BM - 1) / BM * ntiles;
  const int chunks = ph.K / BK;
  for (int tile = 0; tile < tiles; ++tile) {
    const int m0 = tile / ntiles * BM, n0 = tile % ntiles * BN;
    float acc[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

    uint4 ra[LOADS], rb[LOADS];
    load_chunk(ph, P, H, W, m0, n0, 0, ra, rb);
    for (int c = 0; c < chunks; ++c) {
      __syncthreads();                  // the last chunk's reads are done
      store_chunk(sm, ra, rb);
      __syncthreads();
      if (c + 1 < chunks)               // next chunk in flight meanwhile
        load_chunk(ph, P, H, W, m0, n0, (c + 1) * BK, ra, rb);
      multiply_chunk(sm, acc, wm, wn, g, t);
    }

    // epilogue in f32: scale, bias, residual, relu
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = m0 + wm + mi * 16 + g + half * 8;
        if (p >= P) continue;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int n = n0 + wn + ni * 8 + 2 * t;
          float v0 = acc[mi][ni][2 * half] * ph.sb[n] + ph.sb[ph.n_out + n];
          float v1 = acc[mi][ni][2 * half + 1] * ph.sb[n + 1] +
                     ph.sb[ph.n_out + n + 1];
          const long long at = (long long)p * ph.n_out + n;
          if (ph.res != nullptr) {
            const float2 r = *reinterpret_cast<const float2*>(ph.res + at);
            v0 += r.x;
            v1 += r.y;
          }
          *reinterpret_cast<float2*>(ph.out + at) =
              make_float2(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
        }
      }
  }
}

// One thread block per crop, walking the stack's blocks in order.
__global__ void __launch_bounds__(THREADS)
    bottleneck_stack_kernel(const float* __restrict__ x, float* y, float* h1,
                            float* h2, const float* __restrict__ w1,
                            const float* __restrict__ sb1,
                            const float* __restrict__ w2,
                            const float* __restrict__ sb2,
                            const float* __restrict__ w3,
                            const float* __restrict__ sb3, int nblk, int H,
                            int W, int C, int Wd) {
  __shared__ __align__(16) Smem sm;
  const int P = H * W;
  const long long crop = blockIdx.x;
  const float* xc = x + crop * P * C;
  float* yc = y + crop * P * C;
  float* h1c = h1 + crop * P * Wd;
  float* h2c = h2 + crop * P * Wd;
  for (int b = 0; b < nblk; ++b) {
    const float* src = b == 0 ? xc : yc;
    const Phase reduce{src, C, w1 + (long long)b * Wd * C, sb1 + 2 * b * Wd,
                       nullptr, h1c, Wd, C, false};
    run_phase(reduce, P, H, W, sm);
    __syncthreads();                    // h1 complete before its 3x3 reads
    const Phase spatial{h1c, Wd, w2 + (long long)b * 9 * Wd * Wd,
                        sb2 + 2 * b * Wd, nullptr, h2c, Wd, 9 * Wd, true};
    run_phase(spatial, P, H, W, sm);
    __syncthreads();
    const Phase expand{h2c, Wd, w3 + (long long)b * C * Wd, sb3 + 2 * b * C,
                       src, yc, C, Wd, false};
    run_phase(expand, P, H, W, sm);
    __syncthreads();                    // y complete before the next block
  }
}

int dispatch(const void* x, void* y, void* h1, void* h2, const void* w1,
             const void* sb1, const void* w2, const void* sb2, const void* w3,
             const void* sb3, void* bar, int N, int H, int W, int C, int Wd,
             int nblk, int max_ctas, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (N < 1 || H < 1 || W < 1 || nblk < 1 || C < 64 || Wd < 64 ||
      C % 64 != 0 || Wd % 64 != 0 ||
      (long long)N * H * W > 0x7fffffffLL / (C > Wd ? C : Wd))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    bottleneck_stack_kernel<<<N, THREADS, 0, s>>>(
        (const float*)x, (float*)y, (float*)h1, (float*)h2, (const float*)w1,
        (const float*)sb1, (const float*)w2, (const float*)sb2,
        (const float*)w3, (const float*)sb3, nblk, H, W, C, Wd);
    return (int)cudaGetLastError();
  }
  if (dtype == 1 && bar != nullptr) {
    gemm::Stack p{};
    p.x = (const __nv_bfloat16*)x;
    p.y = (__nv_bfloat16*)y;
    p.h1 = (__nv_bfloat16*)h1;
    p.h2 = (__nv_bfloat16*)h2;
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
    return (int)gemm::launch(p, w1, w2, w3, max_ctas, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32 (one block per crop; bar and max_ctas unused), 1 =
// bfloat16 (cooperative launch of one CTA per SM, or of at most max_ctas
// where that is above 0; bar: a zeroed uint32 in device memory).  Each returns the launch's CUDA error (0 = launched), on
// `stream`, without synchronising.

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
