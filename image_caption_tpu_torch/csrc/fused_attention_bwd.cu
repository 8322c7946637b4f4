// Fused masked attention backward for Hopper (sm_90a).
//
// Replaces image_caption_tpu/ops/attention.py:_attention_bwd_kernel (the
// Pallas TPU kernel behind the custom VJP of fused_attention).  Its tile is
// one batch item with all of its heads; for each (b, h) it recomputes P and
// forms the three gradients:
//
//   S  = (q * (1/t)) . k^T, masked -> -inf;   P = softmax(S) (guarded)
//   dV = P^T . dO;   dP = dO . V^T;   dS = P o (dP - rowsum(dP o P))
//   dQ = dS . K / t;   dK = dS^T . Q / t
//
// q, dO [B,H,Lq,Dh], k/v [B,H,Lk,Dh] (f32 or bf16, contiguous), mask int8
// [B,Lq,Lk] shared by all heads (nonzero = masked).  The softmax guard is
// the forward's: the row max is set to 0 when it is not finite and the
// denominator is floored at 1e-30, so a fully masked row has P = 0, dS = 0
// and exactly zero dQ.  Sums are taken in f32; outputs take the input
// dtype.
//
// What bounds it: bytes.  At the training shapes (Dh = 8, L <= 50) the
// function reads q, k, v, dO and the mask once and writes dq, dk, dv once;
// its f32 work (about 10 * Dh flops per unmasked (i, j) pair) is below the
// card's ~20 f32 flops per byte.  Head dim 8 is below the K = 16 of a bf16
// mma, and TF32 would round the f32 products, so the dots run on the CUDA
// cores.  At these sizes what costs time is latency: a block's critical
// path and the number of blocks in flight.  The design:
//
// * A block takes U consecutive (b, h) units: a group of heads of one item,
//   or, when a unit is tiny (the pair block's 2x2 tiles), many items.  The
//   launcher picks U from the shape and the SM count (cached) so that the
//   grid is a few blocks per SM.  The block stages its q, dO, k, v (f32,
//   rows padded to an even number of floats) in shared memory with 16-byte
//   loads, and, when it holds several units, the mask tiles of its items: a
//   mask tile serves all heads of its item.
// * Phase 1, one team of T lanes per query row, T the power of two that
//   leaves a lane at most 32 keys (1 at L <= 32, 2 at the training shapes'
//   L = 37 or 50): each lane takes the keys j = lane + T n, keeps S and dP
//   of them in the block's P and dS tiles, and the row max, exp-sum and
//   rowsum(dP o P) are combined across the team by shuffles in a fixed
//   butterfly.  The same team then forms dS and its row of dQ = dS . K / t,
//   reduce-scattered across the team so each lane holds its own columns:
//   dQ needs no second phase.
// * Phase 2, one team of Tc lanes per key row (Tc from Lq): each lane takes
//   the rows i = lane + Tc n of P and dS and accumulates dV and dK, which
//   are reduce-scattered the same way.
// * dK and dV, in place of the K and V rows phase 2 no longer reads, and
//   the dQ rows of a block of several units are gathered in shared memory
//   and stored to device memory at the end with 16-byte stores.  A block of
//   one unit (a small grid, or tiles too large to pack) writes dQ from its
//   lanes and reads the mask from device memory, so one (b, h) needs only
//   its q, dO, k, v, P and dS in shared memory.  Each element is written
//   once, there are no atomics, and every sum runs in an order fixed by the
//   shape, so two launches give the same bits.
//
// Measured on an H100 (PERF.md): staging and the launch alone take
// about 3 us of the 10-33 us at the training shapes; the rest is the rows'
// walks, where neither unrolling the key loops nor splitting the dot chains
// moved the time, and scores held in registers cost spills at 64 registers
// and more time at 128.
// The exponentials are expf: __expf took no time off here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

// the shared memory one block may use on sm_90 (227 KB)
constexpr size_t kMaxSmemBytes = 232448;
// the shared memory a block is grown to when several units are packed
constexpr size_t kPackSmemBytes = 64 * 1024;
// the grid the packing aims at, in blocks per SM
constexpr int kBlocksPerSm = 4;
constexpr int kMaxThreads = 256;
// blocks an SM must hold at Dh <= 16: caps the registers at 64 a thread
constexpr int kMinBlocks = 4;
// the most keys (or query rows) one lane of a team walks
constexpr int kKeysPerLane = 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes of T as floats
__device__ __forceinline__ void unpack16(const uint4& raw, float* out,
                                         const float*) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack16(const uint4& raw, float* out,
                                         const __nv_bfloat16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float2 f = __bfloat1622float2(h[c]);
    out[2 * c] = f.x;
    out[2 * c + 1] = f.y;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// true when both addresses lie on 16-byte boundaries
__device__ __forceinline__ bool aligned16(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) &
          15) == 0;
}

// Stage `rows` rows of Dh elements from src (contiguous) into dst as f32
// rows of Dp floats, the pad zeroed.  All threads of the block take part.
// f32 rows that need no pad go by cp.async, 16 bytes a copy, all in flight
// at once (the caller waits with cp_async_wait_all); bf16 rows are loaded
// 16 bytes at a time and widened in registers.
template <typename T>
__device__ void stage_rows(float* __restrict__ dst, const T* __restrict__ src,
                           int rows, int Dh, int Dp, int tid, int nt) {
  const int n = rows * Dh;
  constexpr int V = 16 / sizeof(T);
  if (Dh == Dp && aligned16(dst, src)) {
    const int nv = n / V;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    if constexpr (sizeof(T) == 4) {
      for (int w = tid; w < nv; w += nt) cp_async16(dst + w * V, s4 + w);
    } else {
      for (int w = tid; w < nv; w += nt) {
        float f[V];
        unpack16(s4[w], f, src);
#pragma unroll
        for (int c = 0; c < V; c += 4)
          *reinterpret_cast<float4*>(dst + w * V + c) =
              make_float4(f[c], f[c + 1], f[c + 2], f[c + 3]);
      }
    }
    for (int e = nv * V + tid; e < n; e += nt) dst[e] = to_f32(src[e]);
  } else {
    for (int e = tid; e < rows * Dp; e += nt) {
      const int r = e / Dp, d = e - r * Dp;
      dst[e] = d < Dh ? to_f32(src[r * Dh + d]) : 0.f;
    }
  }
}

// Store `rows` f32 rows of Dp floats from src (shared memory) into dst
// (contiguous rows of Dh elements of T): 16-byte stores where the rows have
// no pad and dst is aligned, so neighbouring threads write neighbouring
// words.  All threads of the block take part.
template <typename T>
__device__ void store_rows(T* __restrict__ dst, const float* __restrict__ src,
                           int rows, int Dh, int Dp, int tid, int nt) {
  const int n = rows * Dh;
  constexpr int V = 16 / sizeof(T);
  if (Dh == Dp && aligned16(dst, src)) {
    const int nv = n / V;
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (int w = tid; w < nv; w += nt) {
      const float* s = src + w * V;
      uint4 raw;
      if constexpr (sizeof(T) == 4) {
        const float4 x = *reinterpret_cast<const float4*>(s);
        raw = make_uint4(__float_as_uint(x.x), __float_as_uint(x.y),
                         __float_as_uint(x.z), __float_as_uint(x.w));
      } else {
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          h[c] = __floats2bfloat162_rn(s[2 * c], s[2 * c + 1]);
      }
      d4[w] = raw;
    }
    for (int e = nv * V + tid; e < n; e += nt) dst[e] = from_f32<T>(src[e]);
  } else {
    for (int e = tid; e < n; e += nt) {
      const int r = e / Dh, d = e - r * Dh;
      dst[e] = from_f32<T>(src[r * Dp + d]);
    }
  }
}

// Copy n bytes; dst must lie at (a 16-byte boundary) + (src mod 16), so
// that the body moves by cp.async in 16-byte words on both sides.
__device__ void copy_bytes(unsigned char* __restrict__ dst,
                           const unsigned char* __restrict__ src, int n,
                           int tid, int nt) {
  int head = (int)((16 - (reinterpret_cast<uintptr_t>(src) & 15)) & 15);
  head = head < n ? head : n;
  for (int e = tid; e < head; e += nt) dst[e] = src[e];
  const int words = (n - head) / 16;
  for (int w = tid; w < words; w += nt)
    cp_async16(dst + head + 16 * w, src + head + 16 * w);
  for (int e = head + words * 16 + tid; e < n; e += nt) dst[e] = src[e];
}

// VW floats of a shared-memory row at p (aligned to 4 VW bytes)
template <int VW>
__device__ __forceinline__ void load_vec(const float* __restrict__ p,
                                         float (&x)[VW]) {
  if constexpr (VW == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    x[0] = f.x;
    x[1] = f.y;
    x[2] = f.z;
    x[3] = f.w;
  } else {
    const float2 f = *reinterpret_cast<const float2*>(p);
    x[0] = f.x;
    x[1] = f.y;
  }
}

// a . b over Dp floats of a shared-memory row, read VW floats at a time
template <int MAXD, int VW>
__device__ __forceinline__ float dot_row(const float (&a)[MAXD],
                                         const float* __restrict__ b,
                                         int Dp) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < MAXD / VW; ++c) {
    if (VW * c < Dp) {
      float x[VW];
      load_vec<VW>(b + VW * c, x);
#pragma unroll
      for (int e = 0; e < VW; ++e) s = fmaf(a[VW * c + e], x[e], s);
    }
  }
  return s;
}

// acc += w * b over Dp floats of a shared-memory row
template <int MAXD, int VW>
__device__ __forceinline__ void axpy_row(float (&acc)[MAXD], float w,
                                         const float* __restrict__ b,
                                         int Dp) {
#pragma unroll
  for (int c = 0; c < MAXD / VW; ++c) {
    if (VW * c < Dp) {
      float x[VW];
      load_vec<VW>(b + VW * c, x);
#pragma unroll
      for (int e = 0; e < VW; ++e)
        acc[VW * c + e] = fmaf(w, x[e], acc[VW * c + e]);
    }
  }
}

// r = p * scale over Dp floats of a shared-memory row, zero beyond them
template <int MAXD, int VW>
__device__ __forceinline__ void load_row(float (&r)[MAXD],
                                         const float* __restrict__ p, int Dp,
                                         float scale) {
#pragma unroll
  for (int c = 0; c < MAXD / VW; ++c) {
    float x[VW];
#pragma unroll
    for (int e = 0; e < VW; ++e) x[e] = 0.f;
    if (VW * c < Dp) load_vec<VW>(p + VW * c, x);
#pragma unroll
    for (int e = 0; e < VW; ++e) r[VW * c + e] = x[e] * scale;
  }
}

// The lanes of one team: T consecutive lanes (T a power of two <= 32).
struct Team {
  int T, lane;
  unsigned mask;
  __device__ Team(int T_, int tid) : T(T_), lane(tid & (T_ - 1)) {
    mask = T_ == 32 ? 0xffffffffu
                    : ((1u << T_) - 1u) << ((tid & 31) & ~(T_ - 1));
  }
  __device__ __forceinline__ float max(float x) const {
    for (int off = T >> 1; off > 0; off >>= 1)
      x = fmaxf(x, __shfl_xor_sync(mask, x, off));
    return x;
  }
  __device__ __forceinline__ float sum(float x) const {
    for (int off = T >> 1; off > 0; off >>= 1)
      x += __shfl_xor_sync(mask, x, off);
    return x;
  }
};

__host__ __device__ constexpr int log2_of(int n) { return n <= 1 ? 0 : 1 + log2_of(n >> 1); }

// Sum a[MAXD] across the team, scattered: afterwards this lane holds the
// team's sums of the columns base .. base + R - 1 in a[0 .. R-1], with
// R = max(MAXD / T, 1); the butterfly halves the columns at each step, so a
// row costs MAXD - 1 shuffles at T = MAXD, not MAXD log2 T.
template <int MAXD>
__device__ __forceinline__ int reduce_scatter(float (&a)[MAXD],
                                              const Team& tm) {
  int base = 0;
  int off = tm.T >> 1;
#pragma unroll
  for (int lvl = 1; lvl <= log2_of(MAXD); ++lvl) {
    const int half = MAXD >> lvl;
    if (off > 0) {
      const bool up = (tm.lane & off) != 0;
#pragma unroll
      for (int c = 0; c < (MAXD >> lvl); ++c) {
        const float send = up ? a[c] : a[c + half];
        const float keep = up ? a[c + half] : a[c];
        a[c] = keep + __shfl_xor_sync(tm.mask, send, off);
      }
      if (up) base += half;
      off >>= 1;
    }
  }
  for (; off > 0; off >>= 1) a[0] += __shfl_xor_sync(tm.mask, a[0], off);
  return base;
}

// Write this lane's share of a reduce-scattered row: columns base.. of
// out_row, times scale; lanes that hold a duplicate stay silent.
template <typename T, int MAXD>
__device__ __forceinline__ void write_scattered(const float (&a)[MAXD],
                                                int base, const Team& tm,
                                                T* __restrict__ out_row,
                                                int Dh, float scale) {
  const int R = tm.T >= MAXD ? 1 : MAXD / tm.T;
  const int dup = tm.T > MAXD ? tm.T / MAXD : 1;
  if ((tm.lane & (dup - 1)) != 0) return;
#pragma unroll
  for (int c = 0; c < MAXD; ++c)
    if (c < R && base + c < Dh) out_row[base + c] = from_f32<T>(a[c] * scale);
}

struct Plan {
  int U, T, Tc, threads, items;
  size_t smem;
};

// a staged row's floats: Dh rounded up to even, so a row is read 2 floats
// at a time, or 4 where this is a multiple of 4
__host__ __device__ inline int pad2(int d) { return d + (d & 1); }

// floats of U units' q, dO, k, v, P and dS.  A block of several units also
// stages their dQ and the mask bytes of `items` items, with 32 bytes of
// alignment slack; a block of one unit writes dQ straight to device memory
// and reads the mask there, so the largest tiles fit.
inline size_t smem_bytes(int U, int items, int Lq, int Lk, int Dh) {
  const size_t dp = (size_t)pad2(Dh);
  const size_t core =
      4 * (size_t)U *
      (2 * (size_t)Lq * dp + 2 * (size_t)Lk * dp + 2 * (size_t)Lq * Lk);
  if (U == 1) return core;
  return core + 4 * (size_t)U * Lq * dp + (size_t)items * Lq * Lk + 32;
}

// the most items U consecutive (b, h) units can touch
inline int items_of(int U, int H) {
  const int n = (U - 1) / H + 2;
  return n < U ? n : U;
}

// a power of two team for a walk over n elements, at most kKeysPerLane a
// lane (more where n > 32 kKeysPerLane)
inline int team_for(int n) {
  int t = 1;
  while (t < 32 && t * kKeysPerLane < n) t *= 2;
  return t;
}

// threads for `work` lane tasks: rounds of at most kMaxThreads, the tasks
// spread evenly over the rounds, a whole number of warps
inline int threads_for(long long work) {
  const long long rounds = (work + kMaxThreads - 1) / kMaxThreads;
  const long long per = (work + rounds - 1) / rounds;
  return (int)((per + 31) / 32 * 32);
}

inline int sm_count() {
  static int counts[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (counts[dev] <= 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    counts[dev] = n > 0 ? n : 132;
  }
  return counts[dev];
}

// Units per block: doubled while the grid is over 4 blocks an SM and the
// block stays within kPackSmemBytes; a grid of a few blocks per SM keeps
// every SM busy with several blocks' critical paths at once.
Plan plan_for(long long units, int H, int Lq, int Lk, int Dh) {
  Plan p;
  p.T = team_for(Lk);
  p.Tc = team_for(Lq);
  const long long target = (long long)kBlocksPerSm * sm_count();
  p.U = 1;
  while (2LL * p.U <= units && (units + p.U - 1) / p.U > target &&
         smem_bytes(2 * p.U, items_of(2 * p.U, H), Lq, Lk, Dh) <=
             kPackSmemBytes)
    p.U *= 2;
  p.items = items_of(p.U, H);
  p.smem = smem_bytes(p.U, p.items, Lq, Lk, Dh);
  long long work = (long long)p.U * Lq * p.T;
  const long long work_c = (long long)p.U * Lk * p.Tc;
  if (work_c > work) work = work_c;
  p.threads = threads_for(work);
  return p;
}

template <typename T, int MAXD, int VW>
__global__ void __launch_bounds__(kMaxThreads, MAXD <= 16 ? kMinBlocks : 1)
    fused_attention_bwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int8_t* __restrict__ mask,
    const T* __restrict__ dout, T* __restrict__ dq, T* __restrict__ dk,
    T* __restrict__ dv, long long units, int H, int Lq, int Lk, int Dh,
    int U, int Tq, int Tc, float inv_t) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  static_assert(MAXD % VW == 0, "a row is a whole number of vectors");
  const int Dp = pad2(Dh);
  const bool staged = U > 1;  // dQ and the mask tiles in shared memory
  const long long u0 = (long long)blockIdx.x * U;
  const int nu = (int)(units - u0 < U ? units - u0 : U);
  float* sq = reinterpret_cast<float*>(smem_raw);  // [nu*Lq, Dp]
  float* sdo = sq + U * Lq * Dp;                   // [nu*Lq, Dp]
  float* sk = sdo + U * Lq * Dp;                   // [nu*Lk, Dp]
  float* sv = sk + U * Lk * Dp;                    // [nu*Lk, Dp]
  float* sdq = sv + U * Lk * Dp;                   // [nu*Lq, Dp]: dQ, staged
  float* sp = sdq + (staged ? U * Lq * Dp : 0);    // [nu, Lq, Lk]: S, P
  float* sds = sp + U * Lq * Lk;                   // [nu, Lq, Lk]: dP, dS
  const long long b0 = u0 / H, b1 = (u0 + nu - 1) / H;
  const int h0 = (int)(u0 - b0 * H);  // the head of unit u0
  const unsigned char* msrc =
      reinterpret_cast<const unsigned char*>(mask) + b0 * Lq * Lk;
  const uintptr_t mbase =
      (reinterpret_cast<uintptr_t>(sds + U * Lq * Lk) + 15) & ~uintptr_t(15);
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      mbase + (reinterpret_cast<uintptr_t>(msrc) & 15));  // [items, Lq, Lk]
  // the items' mask tiles, from shared memory where staged
  const unsigned char* mtile = staged ? sm : msrc;

  const int tid = threadIdx.x, nt = blockDim.x;
  stage_rows(sq, q + u0 * Lq * Dh, nu * Lq, Dh, Dp, tid, nt);
  stage_rows(sdo, dout + u0 * Lq * Dh, nu * Lq, Dh, Dp, tid, nt);
  stage_rows(sk, k + u0 * Lk * Dh, nu * Lk, Dh, Dp, tid, nt);
  stage_rows(sv, v + u0 * Lk * Dh, nu * Lk, Dh, Dp, tid, nt);
  if (staged) copy_bytes(sm, msrc, (int)((b1 - b0 + 1) * Lq * Lk), tid, nt);
  cp_async_wait_all();
  __syncthreads();

  // Phase 1: a team per query row r = (unit u, row i): S and dP of its
  // keys, the softmax, dS, and the row of dQ.
  {
    const Team tm(Tq, tid);
    const int teams = nt / Tq;
    for (int r = tid / Tq; r < nu * Lq; r += teams) {
      const int u = r / Lq, i = r - u * Lq;
      const unsigned char* mrow = mtile + ((h0 + u) / H * Lq + i) * Lk;
      const float* kb = sk + u * Lk * Dp;
      const float* vb = sv + u * Lk * Dp;
      float* prow = sp + r * Lk;
      float* drow = sds + r * Lk;
      float m = -INFINITY;
      {
        float qr[MAXD], dor[MAXD];
        load_row<MAXD, VW>(qr, sq + r * Dp, Dp, inv_t);
        load_row<MAXD, VW>(dor, sdo + r * Dp, Dp, 1.f);
        for (int j = tm.lane; j < Lk; j += Tq) {
          // a masked key gets P = 0, so dS = 0 whatever its dP
          const bool masked = mrow[j] != 0;
          const float s =
              masked ? -INFINITY : dot_row<MAXD, VW>(qr, kb + j * Dp, Dp);
          prow[j] = s;
          drow[j] = masked ? 0.f : dot_row<MAXD, VW>(dor, vb + j * Dp, Dp);
          m = fmaxf(m, s);
        }
      }
      m = tm.max(m);
      if (!isfinite(m)) m = 0.f;
      // exp-sum and sum(dP o exp) in one walk: rowsum(dP o P) is their
      // ratio
      float den = 0.f, rd = 0.f;
      for (int j = tm.lane; j < Lk; j += Tq) {
        const float ex = expf(prow[j] - m);
        prow[j] = ex;
        den += ex;
        rd = fmaf(drow[j], ex, rd);
      }
      const float inv_den = 1.f / fmaxf(tm.sum(den), 1e-30f);
      const float rowsum = tm.sum(rd) * inv_den;
      float acc[MAXD];
#pragma unroll
      for (int d = 0; d < MAXD; ++d) acc[d] = 0.f;
      for (int j = tm.lane; j < Lk; j += Tq) {
        const float p = prow[j] * inv_den;
        const float ds = p * (drow[j] - rowsum);
        prow[j] = p;
        drow[j] = ds;
        // P = 0 gives dS = 0: skipping the product changes no bit
        if (p != 0.f) axpy_row<MAXD, VW>(acc, ds, kb + j * Dp, Dp);
      }
      const int base = reduce_scatter(acc, tm);
      if (staged)
        write_scattered(acc, base, tm, sdq + r * Dp, Dh, inv_t);
      else
        write_scattered(acc, base, tm, dq + (u0 * Lq + r) * Dh, Dh, inv_t);
    }
  }
  __syncthreads();

  // Phase 2: a team per key row c = (unit u, key j): dV = P^T . dO and
  // dK = dS^T . Q / t over its rows.
  {
    const Team tm(Tc, tid);
    const int teams = nt / Tc;
    for (int c = tid / Tc; c < nu * Lk; c += teams) {
      const int u = c / Lk, j = c - u * Lk;
      const float* pcol = sp + u * Lq * Lk + j;
      const float* dcol = sds + u * Lq * Lk + j;
      const float* qb = sq + u * Lq * Dp;
      const float* ob = sdo + u * Lq * Dp;
      float ak[MAXD], av[MAXD];
#pragma unroll
      for (int d = 0; d < MAXD; ++d) ak[d] = av[d] = 0.f;
      for (int i = tm.lane; i < Lq; i += Tc) {
        const float p = pcol[i * Lk];
        if (p == 0.f) continue;  // then dS = 0 too
        axpy_row<MAXD, VW>(av, p, ob + i * Dp, Dp);
        axpy_row<MAXD, VW>(ak, dcol[i * Lk], qb + i * Dp, Dp);
      }
      const int base = reduce_scatter(ak, tm);
      reduce_scatter(av, tm);
      // K and V were last read in phase 1: their rows take dK and dV
      write_scattered(ak, base, tm, sk + c * Dp, Dh, inv_t);
      write_scattered(av, base, tm, sv + c * Dp, Dh, 1.f);
    }
  }
  __syncthreads();
  if (staged) store_rows(dq + u0 * Lq * Dh, sdq, nu * Lq, Dh, Dp, tid, nt);
  store_rows(dk + u0 * Lk * Dh, sk, nu * Lk, Dh, Dp, tid, nt);
  store_rows(dv + u0 * Lk * Dh, sv, nu * Lk, Dh, Dp, tid, nt);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* mask, const void* dout, void* dq, void* dk,
                   void* dv, int B, int H, int Lq, int Lk, int Dh,
                   float inv_t, cudaStream_t stream) {
  const long long units = (long long)B * H;
  if (B < 1 || H < 1 || Lq < 1 || Lk < 1 || Dh < 1 || Dh > 64 ||
      smem_bytes(1, 1, Lq, Lk, Dh) > kMaxSmemBytes)
    return cudaErrorInvalidValue;
  const Plan p = plan_for(units, H, Lq, Lk, Dh);
  const long long blocks = (units + p.U - 1) / p.U;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
#define ICT_LAUNCH(D, VW)                                                    \
  do {                                                                       \
    auto kern = fused_attention_bwd_kernel<T, D, VW>;                        \
    if (p.smem > 48 * 1024) {                                                \
      const cudaError_t err = cudaFuncSetAttribute(                          \
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);   \
      if (err != cudaSuccess) return err;                                    \
    }                                                                        \
    kern<<<(unsigned)blocks, p.threads, p.smem, stream>>>(                   \
        (const T*)q, (const T*)k, (const T*)v, (const int8_t*)mask,          \
        (const T*)dout, (T*)dq, (T*)dk, (T*)dv, units, H, Lq, Lk, Dh, p.U,   \
        p.T, p.Tc, inv_t);                                                   \
  } while (0)
#define ICT_LAUNCH_VW(D)        \
  do {                          \
    if (pad2(Dh) % 4 == 0)      \
      ICT_LAUNCH(D, 4);         \
    else                        \
      ICT_LAUNCH(D, 2);         \
  } while (0)
  if (Dh <= 8)
    ICT_LAUNCH_VW(8);
  else if (Dh <= 16)
    ICT_LAUNCH_VW(16);
  else if (Dh <= 32)
    ICT_LAUNCH_VW(32);
  else
    ICT_LAUNCH_VW(64);
#undef ICT_LAUNCH_VW
#undef ICT_LAUNCH
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 = launched; a unit whose tiles need more than 232,448 bytes of
// shared memory is refused).  Launches on `stream` and does not
// synchronise.
extern "C" int fused_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* mask,
                                   const void* dout, void* dq, void* dk,
                                   void* dv, int B, int H, int Lq, int Lk,
                                   int Dh, float inv_t, int dtype,
                                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch<float>(q, k, v, mask, dout, dq, dk, dv, B, H, Lq, Lk,
                              Dh, inv_t, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, mask, dout, dq, dk, dv, B, H,
                                      Lq, Lk, Dh, inv_t, s);
  return (int)cudaErrorInvalidValue;
}
