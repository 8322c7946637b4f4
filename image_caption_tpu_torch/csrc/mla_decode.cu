// The absorbed latent attention of one decode step of the mla_moe
// captioner (models/lm.py: MLA.step), for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no mla_moe captioner.  It
// takes the place of two batched products through cuBLAS (scores over the
// latent cache, then the weights over its latent part) and the passes
// between them (the concatenation of q, the scale, the mask, the softmax
// and two casts).
//
// For each batch row b and head h, over the cache rows t = 0..pos:
//
//   s_t = scale * (q_lat[b,h] . c_t[:512] + q_pe[b,h] . c_t[512:])   (f32)
//   s_t = -inf where visible[b,t] is false
//   P   = bf16(softmax_t(s))                                          (f32)
//   out[h,b] = bf16(sum_t P_t c_t[:512])                              (f32 sum)
//
// q_lat [B,16,512] and q_pe [B,16,64] bf16 are read through their strides,
// the cache [B,T,576] bf16 is contiguous, visible [B,T] bool, pos an int64
// on the device (read here, so one captured graph serves every step).  Rows
// after pos are attended by no batch row and are not loaded; rows up to pos
// that a pad slot holds are loaded and masked (work beyond the bound).  The
// output is [16,B,512]:
// the absorbed value product (W_uv per head) takes it as a batch over heads
// without a copy.
//
// What bounds it: bytes.  A batch row's work is 2 x 16 x (pos+1) x 1,088
// multiply-adds over (pos+1) x 1,152 bytes of cache, about 30 operations a
// byte, a tenth of the card's balance point.  The least time of a launch is
// the visible cache rows, q and the output moved once at 3.35 TB/s (35 us at
// B 1024 and pos 86 with the captioning traffic's pad slots; 41 us with
// none).  The design:
//
// * One block a batch row, 4 warps.  The block issues cp.async copies of
//   all its rows 0..pos at once (one commit group per tile of 16 rows) into
//   shared memory, where each row is read once from device memory and then
//   serves both products; the 16-byte chunks of a row are swizzled so that
//   the tensor-core fragment loads (ldmatrix) hit distinct banks.  At T 87
//   a block holds 110 KB, so two blocks share an SM and one computes while
//   the other's copies are in flight.
// * The 16 heads are the M = 16 of mma.sync m16n8k16 (bf16 in, f32 sums).
//   Scores: each warp holds a quarter of q (9 of its 36 k-steps of 16) as
//   A fragments in registers and, tile by tile as the copies land, computes
//   its partial scores for the tile's 16 keys; the block adds the four
//   partials in a fixed order, scales and masks them into a [16, 96] f32
//   array in shared memory.  Neither the scores nor P reach device memory.
// * Softmax over all of a head's keys in f32 (8 threads a head, every head
//   at once), P rounded to bf16 as the plain version rounds it.  Then
//   P . V: each warp owns 128 of the 512 output columns and walks the
//   tiles again from shared memory (V fragments by ldmatrix.trans), f32
//   sums in registers; the block stores its [16, 512] output with 16-byte
//   stores.
// * Every sum runs in an order fixed by the shape: two launches give the
//   same bits.
//
// Measured on an H100 (PERF.md): 41-51% of the bound at pos 38-86 with the
// traffic's pad slots (56-62% of a bound over every row up to pos).  The
// copies alone run at 3.0 TB/s; what is left is the pad rows and each
// block's compute after its last tile lands, which two blocks an SM
// overlap only in part.  One bulk copy (TMA) a row in place of the
// cp.async copies read no faster, and q loaded after the copies slower.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kHeads = 16;                    // one m16 tile
constexpr int kLatent = 512;
constexpr int kRope = 64;
constexpr int kWidth = kLatent + kRope;       // a cache row: 576 bf16
constexpr int kRowBytes = kWidth * 2;         // 1,152
constexpr int kChunks = kRowBytes / 16;       // 16-byte chunks a row: 72
constexpr int kTile = 16;                     // keys a tile (one k-step of P.V)
constexpr int kMaxRows = 96;                  // the most cache rows: 6 tiles
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kKSteps = kWidth / 16;          // 36
constexpr int kKStepsPerWarp = kKSteps / kWarps;
constexpr int kColsPerWarp = kLatent / kWarps;  // 128
constexpr int kPStride = kMaxRows + 8;        // P rows, bf16: no conflicts
constexpr int kOutStride = kLatent + 8;       // staged output rows, bf16
// score rows, f32: 8 banks apart, so four heads' rows share no bank
constexpr int kScoreStride = kMaxRows + 8;
constexpr int kScoreBytes = kHeads * kScoreStride * 4;
constexpr int kPartBytes = kWarps * kHeads * kTile * 4;
static_assert(kKSteps % kWarps == 0, "q splits evenly over the warps");
static_assert(kHeads * kPStride * 2 <= kPartBytes, "P fits the partials");
static_assert(kThreads % kTile == 0, "a thread reduces one key of a tile");
static_assert(kThreads == kHeads * 8, "the softmax takes 8 threads a head");

// dynamic shared memory of a block over T cache rows: the rows (or the
// staged output, whichever is larger), the scores, the partial scores
__host__ __device__ inline size_t smem_bytes(int T) {
  const size_t rows = (size_t)T * kRowBytes;
  const size_t staged = (size_t)kHeads * kOutStride * 2;
  return (rows > staged ? rows : staged) + kScoreBytes + kPartBytes;
}

// chunk c of row r: the low three bits of the chunk index are XORed with
// the row's, so 8 consecutive rows put the same chunk in 8 distinct banks
__device__ __forceinline__ uint32_t row_chunk(uint32_t base, int r, int c) {
  return base + r * kRowBytes + (((c & ~7) | ((c ^ r) & 7)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `pending` commit groups are still in flight (a
// block commits at most 6)
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d += a (16x16, row) . b (16x8, col), bf16 in, f32 sums
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads, 2)
    mla_decode_kernel(const __nv_bfloat16* __restrict__ q_lat,
                      long long ql_b, long long ql_h,
                      const __nv_bfloat16* __restrict__ q_pe, long long qp_b,
                      long long qp_h, const __nv_bfloat16* __restrict__ cache,
                      const uint8_t* __restrict__ visible,
                      const int64_t* __restrict__ pos_ptr,
                      __nv_bfloat16* __restrict__ out, int B, int T,
                      float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;   // a fragment's row and pair
  const long long pos = *pos_ptr;
  const int n = (int)(pos < 0 ? 1 : pos >= T ? T : pos + 1);  // rows loaded
  const int tiles = (n + kTile - 1) / kTile;
  const size_t rows_bytes = smem_bytes(T) - kScoreBytes - kPartBytes;
  float* scores = reinterpret_cast<float*>(smem + rows_bytes);
  float* part = scores + kHeads * kScoreStride;
  __nv_bfloat16* p_s = reinterpret_cast<__nv_bfloat16*>(part);
  const uint32_t rows_s = (uint32_t)__cvta_generic_to_shared(smem);

  // this warp's quarter of q as A fragments: k-steps 9w .. 9w+8 of 36, the
  // first 32 from q_lat, the last 4 from q_pe (loads in flight with the
  // copies below)
  uint32_t qa[kKStepsPerWarp][4];
#pragma unroll
  for (int s = 0; s < kKStepsPerWarp; ++s) {
    const int ks = warp * kKStepsPerWarp + s;
    const bool lat = ks < kLatent / 16;
    const __nv_bfloat16* q = lat ? q_lat + b * ql_b : q_pe + b * qp_b;
    const long long hs = lat ? ql_h : qp_h;
    const int k = (lat ? ks * 16 : ks * 16 - kLatent) + 2 * t4;
    qa[s][0] = ld_pair(q + g * hs + k);
    qa[s][1] = ld_pair(q + (g + 8) * hs + k);
    qa[s][2] = ld_pair(q + g * hs + k + 8);
    qa[s][3] = ld_pair(q + (g + 8) * hs + k + 8);
  }

  // every row 0..pos, one commit group a tile
  const __nv_bfloat16* src = cache + (size_t)b * T * kWidth;
  for (int i = 0; i < tiles; ++i) {
    const int r0 = i * kTile;
    const int count = min(kTile, n - r0) * kChunks;
    for (int j = tid; j < count; j += kThreads) {
      const int r = r0 + j / kChunks, c = j % kChunks;
      cp_async16(row_chunk(rows_s, r, c), src + (size_t)r * kWidth + c * 8);
    }
    cp_async_commit();
  }

  // whether the key this thread reduces in each tile (key tid % 16) is
  // attended, read while the copies fly so that no tile waits on it
  const uint8_t* vis = visible + (size_t)b * T;
  uint32_t attended = 0;
#pragma unroll
  for (int i = 0; i < kMaxRows / kTile; ++i) {
    const int t = i * kTile + tid % kTile;
    if (t < n && t <= pos && vis[t]) attended |= 1u << i;
  }

  // scores, tile by tile as the copies land.  A row past n (in the last
  // tile) is read from row 0, which is loaded and finite, and masked.  Even
  // and odd k-steps sum into separate accumulators: four independent mma
  // chains a warp in place of two.
  for (int i = 0; i < tiles; ++i) {
    cp_async_wait(tiles - 1 - i);
    __syncthreads();
    const int r0 = i * kTile;
    float acc[2][2][4] = {};
    int r = r0 + (lane & 7) + ((lane >> 4) << 3);
    r = r < n ? r : 0;
#pragma unroll
    for (int s = 0; s < kKStepsPerWarp; ++s) {
      const int c = 2 * (warp * kKStepsPerWarp + s) + ((lane >> 3) & 1);
      uint32_t k4[4];
      ldmatrix_x4(k4, row_chunk(rows_s, r, c));
      mma16816(acc[s & 1][0], qa[s], k4[0], k4[1]);
      mma16816(acc[s & 1][1], qa[s], k4[2], k4[3]);
    }
    float* pw = part + warp * kHeads * kTile;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int key = j * 8 + 2 * t4;
      *reinterpret_cast<float2*>(pw + g * kTile + key) = make_float2(
          acc[0][j][0] + acc[1][j][0], acc[0][j][1] + acc[1][j][1]);
      *reinterpret_cast<float2*>(pw + (g + 8) * kTile + key) = make_float2(
          acc[0][j][2] + acc[1][j][2], acc[0][j][3] + acc[1][j][3]);
    }
    __syncthreads();
    const bool seen = (attended >> i) & 1u;
    for (int e = tid; e < kHeads * kTile; e += kThreads) {
      const float s = ((part[e] + part[e + kHeads * kTile]) +
                       part[e + 2 * kHeads * kTile]) +
                      part[e + 3 * kHeads * kTile];
      scores[(e / kTile) * kScoreStride + r0 + e % kTile] =
          seen ? s * scale : -INFINITY;
    }
  }
  __syncthreads();

  // softmax over each head's keys, P in bf16 (over the partials, now
  // free): 8 threads a head, all 16 heads at once, each thread over keys
  // j, j + 8, ... of its head
  const int kpad = tiles * kTile;
  {
    const int h = tid >> 3, j = tid & 7;
    const float* row = scores + h * kScoreStride;
    float v[kMaxRows / 8];
    float m = -INFINITY;
#pragma unroll
    for (int u = 0; u < kMaxRows / 8; ++u) {
      const int t = j + 8 * u;
      v[u] = t < kpad ? row[t] : -INFINITY;
      m = fmaxf(m, v[u]);
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.f;
#pragma unroll
    for (int u = 0; u < kMaxRows / 8; ++u) {
      v[u] = expf(v[u] - m);
      sum += v[u];
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
#pragma unroll
    for (int u = 0; u < kMaxRows / 8; ++u) {
      const int t = j + 8 * u;
      if (t < kpad) p_s[h * kPStride + t] = __float2bfloat16(v[u] / sum);
    }
  }
  __syncthreads();

  // P . V: this warp's 128 columns, 16 n-tiles of 8, one k-step a tile
  float o[kColsPerWarp / 8][4] = {};
  for (int i = 0; i < tiles; ++i) {
    const int k0 = i * kTile + 2 * t4;
    uint32_t a[4];
    a[0] = *reinterpret_cast<const uint32_t*>(p_s + g * kPStride + k0);
    a[1] = *reinterpret_cast<const uint32_t*>(p_s + (g + 8) * kPStride + k0);
    a[2] = *reinterpret_cast<const uint32_t*>(p_s + g * kPStride + k0 + 8);
    a[3] =
        *reinterpret_cast<const uint32_t*>(p_s + (g + 8) * kPStride + k0 + 8);
    int r = i * kTile + (lane & 7) + (((lane >> 3) & 1) << 3);
    r = r < n ? r : 0;
#pragma unroll
    for (int np = 0; np < kColsPerWarp / 16; ++np) {
      const int c = (warp * kColsPerWarp + np * 16) / 8 + (lane >> 4);
      uint32_t v4[4];
      ldmatrix_x4_trans(v4, row_chunk(rows_s, r, c));
      mma16816(o[2 * np], a, v4[0], v4[1]);
      mma16816(o[2 * np + 1], a, v4[2], v4[3]);
    }
  }
  __syncthreads();   // every warp is done with the rows: stage over them

  __nv_bfloat16* staged = reinterpret_cast<__nv_bfloat16*>(smem);
#pragma unroll
  for (int nt = 0; nt < kColsPerWarp / 8; ++nt) {
    const int col = warp * kColsPerWarp + nt * 8 + 2 * t4;
    *reinterpret_cast<__nv_bfloat162*>(staged + g * kOutStride + col) =
        __floats2bfloat162_rn(o[nt][0], o[nt][1]);
    *reinterpret_cast<__nv_bfloat162*>(staged + (g + 8) * kOutStride + col) =
        __floats2bfloat162_rn(o[nt][2], o[nt][3]);
  }
  __syncthreads();
  constexpr int kOutChunks = kLatent / 8;   // 16-byte chunks a head: 64
  for (int j = tid; j < kHeads * kOutChunks; j += kThreads) {
    const int h = j / kOutChunks, c = j % kOutChunks;
    *reinterpret_cast<uint4*>(out + ((size_t)h * B + b) * kLatent + c * 8) =
        *reinterpret_cast<const uint4*>(staged + h * kOutStride + c * 8);
  }
}

}  // namespace

// q_lat [B,16,512] and q_pe [B,16,64] bf16 with the given strides (in
// elements; the last dim contiguous), cache [B,T,576] bf16 contiguous,
// visible [B,T] bool, pos int64 [1], out [16,B,512] bf16; T <= 96.
// Returns cudaGetLastError() after the launch (0 = launched).  Launches on
// `stream` and does not synchronise.
extern "C" int mla_decode(const void* q_lat, long long ql_b, long long ql_h,
                          const void* q_pe, long long qp_b, long long qp_h,
                          const void* cache, const void* visible,
                          const void* pos, void* out, int B, int T,
                          float scale, void* stream) {
  if (B < 1 || T < 1 || T > kMaxRows) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(T);
  cudaError_t err = cudaFuncSetAttribute(
      mla_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  mla_decode_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q_lat, ql_b, ql_h, (const __nv_bfloat16*)q_pe,
      qp_b, qp_h, (const __nv_bfloat16*)cache, (const uint8_t*)visible,
      (const int64_t*)pos, (__nv_bfloat16*)out, B, T, scale);
  return (int)cudaGetLastError();
}
