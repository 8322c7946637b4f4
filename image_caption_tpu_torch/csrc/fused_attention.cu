// Fused masked attention forward for Hopper (sm_90a).
//
// Replaces image_caption_tpu/ops/attention.py:_fused_attention_kernel (the
// Pallas TPU kernel behind fused_attention, whose tile is one batch item
// with all of its heads):
//
//   out = softmax((q * (1/t)) . k^T, masked -> -inf) . v
//
// q [B,H,Lq,Dh], k/v [B,H,Lk,Dh] (f32 or bf16, contiguous), mask int8
// [B,Lq,Lk] shared by all heads (nonzero = masked).  The row max is guarded
// so that a fully masked row comes out exactly 0, and the denominator is
// floored at 1e-30.  Sums are taken in f32; the output takes q's dtype.
//
// What bounds it: bytes.  At the caption shapes (Dh = 8, L <= 50) a query
// row does 4*Dh*Lk flops against 2*Dh*Lk*elem bytes of K/V, far below the
// card's ~20 flops per byte for f32 on the CUDA cores, so the least time is
// q, k, v and out read or written once.  Head dim 8 is below the K = 16 of
// a bf16 mma, and TF32 would round the f32 products, so the dots run on the
// CUDA cores; what costs time at these sizes is latency.  The design, the
// backward's block shape (csrc/fused_attention_bwd.cu):
//
// * A block takes U consecutive (b, h) units (a group of heads of one item,
//   or many items when a unit is tiny) and a tile of query rows, and stages
//   their q, K, V (f32, rows padded to a multiple of 4 floats) and the mask
//   tiles of their items in shared memory with 16-byte loads; a mask tile
//   serves all heads of its item.  The launcher picks the packing from the
//   shape and the SM count (cached) so that the grid is a few blocks per
//   SM.
// * One team of T lanes per query row, T the power of two that leaves a
//   lane at most 32 keys (1 at L <= 32, 2 at L = 37 or 50): each lane walks
//   the keys j = lane + T n once, with its own running max, exp-sum and
//   weighted sum of V (rescaled when its max grows), so no score is
//   computed twice or stored.  The team combines the lanes' partials by
//   shuffles in a fixed butterfly and reduce-scatters the output row, which
//   replaces the row's q in shared memory; the block stores its output at
//   the end with 16-byte stores.
// * Where one unit's q, K, V and mask do not fit a block's shared memory,
//   the block takes one unit and as many query rows as it has teams, and
//   walks the keys in tiles with the same running state.
// * Every sum runs in an order fixed by the shape: two launches give the
//   same bits.
//
// Measured on an H100 (PERF.md): staging and the launch alone take
// about 3 us of the 6-12 us at the caption and training shapes; the rest
// is the rows' walks.  The exponentials are __expf (ex2.approx, a few ulp
// where expf is within one): 2-8% less time at the training shapes, with
// the same worst f32 error against the plain version in the card's check.

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
  if (Dh == Dp && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int nv = n / V;  // Dh == Dp is a multiple of 4: no f32 tail
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
  if (Dh == Dp && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
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

// a . b over Dp floats of a shared-memory row
template <int MAXD>
__device__ __forceinline__ float dot_row(const float (&a)[MAXD],
                                         const float* __restrict__ b,
                                         int Dp) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < MAXD / 4; ++c) {
    if (4 * c < Dp) {
      const float4 x = reinterpret_cast<const float4*>(b)[c];
      s = fmaf(a[4 * c], x.x, s);
      s = fmaf(a[4 * c + 1], x.y, s);
      s = fmaf(a[4 * c + 2], x.z, s);
      s = fmaf(a[4 * c + 3], x.w, s);
    }
  }
  return s;
}

// acc += w * b over Dp floats of a shared-memory row
template <int MAXD>
__device__ __forceinline__ void axpy_row(float (&acc)[MAXD], float w,
                                         const float* __restrict__ b,
                                         int Dp) {
#pragma unroll
  for (int c = 0; c < MAXD / 4; ++c) {
    if (4 * c < Dp) {
      const float4 x = reinterpret_cast<const float4*>(b)[c];
      acc[4 * c] = fmaf(w, x.x, acc[4 * c]);
      acc[4 * c + 1] = fmaf(w, x.y, acc[4 * c + 1]);
      acc[4 * c + 2] = fmaf(w, x.z, acc[4 * c + 2]);
      acc[4 * c + 3] = fmaf(w, x.w, acc[4 * c + 3]);
    }
  }
}

template <int MAXD>
__device__ __forceinline__ void load_row(float (&r)[MAXD],
                                         const float* __restrict__ p, int Dp,
                                         float scale) {
#pragma unroll
  for (int c = 0; c < MAXD / 4; ++c) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (4 * c < Dp) x = reinterpret_cast<const float4*>(p)[c];
    r[4 * c] = x.x * scale;
    r[4 * c + 1] = x.y * scale;
    r[4 * c + 2] = x.z * scale;
    r[4 * c + 3] = x.w * scale;
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

__host__ __device__ inline int pad4(int d) { return (d + 3) & ~3; }

// q of U units over QT rows, K and V over KT keys, then the mask bytes of
// `items` items over QT rows and KT keys, and 32 bytes of alignment slack
inline size_t smem_bytes(int U, int items, int QT, int KT, int Dh) {
  return 4 * (size_t)U * pad4(Dh) * (QT + 2 * (size_t)KT) +
         (size_t)items * QT * KT + 32;
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

struct Plan {
  int U, QT, KT, T, threads, items;
  size_t smem;
};

// Whole tiles: units per block doubled while the grid is over 4 blocks an
// SM and the block stays within kPackSmemBytes.  Tiles too large for a
// block: one unit, one query row per team, the keys in tiles.
Plan plan_for(long long units, int H, int Lq, int Lk, int Dh) {
  Plan p;
  p.T = team_for(Lk);
  p.U = 1;
  if (smem_bytes(1, 1, Lq, Lk, Dh) <= kMaxSmemBytes) {
    p.QT = Lq;
    p.KT = Lk;
    const long long target = (long long)kBlocksPerSm * sm_count();
    while (2LL * p.U <= units && (units + p.U - 1) / p.U > target &&
           smem_bytes(2 * p.U, items_of(2 * p.U, H), Lq, Lk, Dh) <=
               kPackSmemBytes)
      p.U *= 2;
    p.threads = threads_for((long long)p.U * Lq * p.T);
  } else {
    p.threads = kMaxThreads;
    p.QT = Lq < kMaxThreads / p.T ? Lq : kMaxThreads / p.T;
    const size_t dp = (size_t)pad4(Dh);
    const size_t kt = (kMaxSmemBytes - 32 - 4 * dp * p.QT) / (8 * dp + p.QT);
    p.KT = kt < (size_t)Lk ? (int)kt : Lk;
  }
  p.items = items_of(p.U, H);
  p.smem = smem_bytes(p.U, p.items, p.QT, p.KT, Dh);
  return p;
}

// Block (unit group, query tile) of a grid flattened as group * nqt + tile.
template <typename T, int MAXD>
__global__ void __launch_bounds__(kMaxThreads, MAXD <= 16 ? kMinBlocks : 1)
    fused_attention_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int8_t* __restrict__ mask, T* __restrict__ out, long long units,
    int H, int Lq, int Lk, int Dh, int U, int QT, int KT, int nqt, int Tq,
    float inv_t) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Dp = pad4(Dh);
  const long long u0 = ((long long)blockIdx.x / nqt) * U;
  const int i0 = (int)((long long)blockIdx.x % nqt) * QT;
  const int nu = (int)(units - u0 < U ? units - u0 : U);
  const int nq = Lq - i0 < QT ? Lq - i0 : QT;
  float* sq = reinterpret_cast<float*>(smem_raw);  // [nu*nq, Dp]
  float* sk = sq + U * QT * Dp;                    // [nu*nk, Dp]
  float* sv = sk + U * KT * Dp;                    // [nu*nk, Dp]
  unsigned char* mbase = reinterpret_cast<unsigned char*>(sv + U * KT * Dp);
  const long long b0 = u0 / H, b1 = (u0 + nu - 1) / H;
  const int h0 = (int)(u0 - b0 * H);  // the head of unit u0
  const int items = (int)(b1 - b0 + 1);
  const int tid = threadIdx.x, nt = blockDim.x;
  const Team tm(Tq, tid);
  const int teams = nt / Tq;
  const int n_kt = (Lk + KT - 1) / KT;

  // one row's running state; with several key tiles each team holds at
  // most one row (the launcher's rule), so it carries across the tiles
  float qr[MAXD], acc[MAXD], m = -INFINITY, den = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int j0 = kt * KT;
    const int nk = Lk - j0 < KT ? Lk - j0 : KT;
    if (kt) __syncthreads();
    const unsigned char* sm;
    if (kt == 0) {
      if (nq == Lq) {
        stage_rows(sq, q + u0 * Lq * Dh, nu * Lq, Dh, Dp, tid, nt);
      } else {
        for (int u = 0; u < nu; ++u)
          stage_rows(sq + u * nq * Dp, q + ((u0 + u) * Lq + i0) * Dh, nq, Dh,
                     Dp, tid, nt);
      }
    }
    if (nk == Lk) {
      stage_rows(sk, k + u0 * Lk * Dh, nu * Lk, Dh, Dp, tid, nt);
      stage_rows(sv, v + u0 * Lk * Dh, nu * Lk, Dh, Dp, tid, nt);
    } else {
      for (int u = 0; u < nu; ++u) {
        const long long off = ((u0 + u) * Lk + j0) * Dh;
        stage_rows(sk + u * nk * Dp, k + off, nk, Dh, Dp, tid, nt);
        stage_rows(sv + u * nk * Dp, v + off, nk, Dh, Dp, tid, nt);
      }
    }
    if (nq == Lq && nk == Lk) {  // the items' tiles lie back to back
      const unsigned char* msrc =
          reinterpret_cast<const unsigned char*>(mask) + b0 * Lq * Lk;
      unsigned char* dst = mbase + (reinterpret_cast<uintptr_t>(msrc) & 15);
      copy_bytes(dst, msrc, items * Lq * Lk, tid, nt);
      sm = dst;
    } else {
      for (int e = tid; e < items * nq * nk; e += nt) {
        const int bi = e / (nq * nk), rest = e - bi * nq * nk;
        const int ii = rest / nk, jj = rest - ii * nk;
        mbase[e] = (unsigned char)mask[((b0 + bi) * Lq + i0 + ii) * Lk + j0 + jj];
      }
      sm = mbase;
    }
    cp_async_wait_all();
    __syncthreads();

    for (int r = tid / Tq; r < nu * nq; r += teams) {
      const int u = r / nq, ii = r - u * nq;
      if (kt == 0) {
        load_row(qr, sq + r * Dp, Dp, inv_t);
        m = -INFINITY;
        den = 0.f;
#pragma unroll
        for (int d = 0; d < MAXD; ++d) acc[d] = 0.f;
      }
      const unsigned char* mrow = sm + ((h0 + u) / H * nq + ii) * nk;
      const float* kb = sk + u * nk * Dp;
      const float* vb = sv + u * nk * Dp;
      for (int j = tm.lane; j < nk; j += Tq) {
        if (mrow[j]) continue;
        const float s = dot_row(qr, kb + j * Dp, Dp);
        if (s > m) {  // a new running max: rescale what was summed
          const float c = __expf(m - s);
          den *= c;
#pragma unroll
          for (int d = 0; d < MAXD; ++d) acc[d] *= c;
          m = s;
        }
        const float p = __expf(s - m);
        den += p;
        axpy_row(acc, p, vb + j * Dp, Dp);
      }
      if (kt == n_kt - 1) {
        // lanes to the team's max; a lane that saw no key has m = -inf
        // and nothing summed, and a fully masked row stays exactly 0
        const float mx = tm.max(m);
        const float f = m == -INFINITY ? 0.f : __expf(m - mx);
        const float total = fmaxf(tm.sum(den * f), 1e-30f);
#pragma unroll
        for (int d = 0; d < MAXD; ++d) acc[d] *= f;
        const int base = reduce_scatter(acc, tm);
        // the row's output replaces its q row, which only this team read
        write_scattered(acc, base, tm, sq + r * Dp, Dh, 1.f / total);
      }
    }
  }
  __syncthreads();
  if (nq == Lq) {
    store_rows(out + u0 * Lq * Dh, sq, nu * Lq, Dh, Dp, tid, nt);
  } else {
    for (int u = 0; u < nu; ++u)
      store_rows(out + ((u0 + u) * Lq + i0) * Dh, sq + u * nq * Dp, nq, Dh,
                 Dp, tid, nt);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* mask, void* out, int B, int H, int Lq, int Lk,
                   int Dh, float inv_t, cudaStream_t stream) {
  if (B < 1 || H < 1 || Lq < 1 || Lk < 1 || Dh < 1 || Dh > 64)
    return cudaErrorInvalidValue;
  const long long units = (long long)B * H;
  const Plan p = plan_for(units, H, Lq, Lk, Dh);
  const int nqt = (Lq + p.QT - 1) / p.QT;
  const long long blocks = (units + p.U - 1) / p.U * nqt;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
#define ICT_LAUNCH(D)                                                        \
  do {                                                                       \
    auto kern = fused_attention_fwd_kernel<T, D>;                            \
    if (p.smem > 48 * 1024) {                                                \
      const cudaError_t err = cudaFuncSetAttribute(                          \
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);   \
      if (err != cudaSuccess) return err;                                    \
    }                                                                        \
    kern<<<(unsigned)blocks, p.threads, p.smem, stream>>>(                   \
        (const T*)q, (const T*)k, (const T*)v, (const int8_t*)mask, (T*)out, \
        units, H, Lq, Lk, Dh, p.U, p.QT, p.KT, nqt, p.T, inv_t);             \
  } while (0)
  if (Dh <= 8)
    ICT_LAUNCH(8);
  else if (Dh <= 16)
    ICT_LAUNCH(16);
  else if (Dh <= 32)
    ICT_LAUNCH(32);
  else
    ICT_LAUNCH(64);
#undef ICT_LAUNCH
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 = launched).  Launches on `stream` and does not synchronise.
extern "C" int fused_attention_fwd(const void* q, const void* k,
                                   const void* v, const void* mask, void* out,
                                   int B, int H, int Lq, int Lk, int Dh,
                                   float inv_t, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch<float>(q, k, v, mask, out, B, H, Lq, Lk, Dh, inv_t, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, mask, out, B, H, Lq, Lk, Dh,
                                      inv_t, s);
  return (int)cudaErrorInvalidValue;
}
