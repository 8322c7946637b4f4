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
// CUDA cores' (f32) rate.
//
// The TPU kernel keeps a batch tile of whole crops and all the stage's
// weights in VMEM (48 MB for stage 3).  An SM has 227 KB, less than one
// stage-1 crop's h1, so this design keeps h1, h2 and the running y in
// global memory (L2 for the most part) and computes each of the three
// convolutions as an implicit GEMM over shared-memory tiles:
//   - one thread block owns one crop and walks every block of the stack and
//     its three phases in order, with __syncthreads() between phases (the
//     3x3 phase reads h1 of neighbouring pixels, the next block all of y).
//     No grid-wide barrier and no atomics: results are the same run to run;
//   - a phase is a GEMM [pixels x n_out] over K (C, 9*Wd or Wd), cut into
//     64x64 output tiles and 32-deep K chunks.  The 3x3 phase reads its A
//     tile from h1 shifted by the chunk's tap, zero outside the crop;
//   - four warps each own a 32x32 sub-tile.  bf16 runs mma.sync m16n8k16
//     with f32 accumulators; f32 runs FMAs on the CUDA cores, each thread
//     owning the same accumulator elements as in the mma layout, so both
//     share the loads and the epilogue;
//   - the next K chunk is loaded from global memory into registers while
//     the current one is multiplied (one stage of prefetch);
//   - y is written in place over the previous block's output: the third
//     phase reads its residual at exactly the element it writes.
// The weights of a block stream from L2 or HBM for every crop.  wgmma, TMA,
// deeper pipelines and several crops or several thread blocks per crop
// are left for later work.
//
// Shapes: C and Wd multiples of 64, any H, W and N >= 1.  Weights K-major:
// w1 [n, Wd, C], w2 [n, Wd, 3, 3, Wd] (out, tap row, tap col, in), w3
// [n, C, Wd], in x's type; scale and bias rows sb1 [n, 2, Wd], sb2
// [n, 2, Wd], sb3 [n, 2, C] in f32.  The caller supplies h1 and h2 scratch
// of N*H*W*Wd elements each.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // output pixels per tile
constexpr int BN = 64;        // output channels per tile
constexpr int BK = 32;        // depth of one K chunk
constexpr int THREADS = 128;  // four warps, a 32x32 sub-tile each

template <typename T>
struct Cfg;
template <>
struct Cfg<float> {
  static constexpr int PAD = 4;   // row stride 36 floats: no bank conflicts
};
template <>
struct Cfg<__nv_bfloat16> {
  static constexpr int PAD = 8;   // row stride 40 bf16 = 80 bytes
};

template <typename T>
struct Smem {
  T a[BM][BK + Cfg<T>::PAD];      // A tile: pixel-major, K contiguous
  T b[BN][BK + Cfg<T>::PAD];      // B tile: channel-major, K contiguous
};

// 16-byte vectors each thread moves per tile of A (and of B)
template <typename T>
struct Loads {
  static constexpr int N = BM * BK * (int)sizeof(T) / 16 / THREADS;
};

__device__ __forceinline__ void load_pair(const float* p, float& a,
                                          float& b) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  a = v.x;
  b = v.y;
}
__device__ __forceinline__ void load_pair(const __nv_bfloat16* p, float& a,
                                          float& b) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  a = __low2float(v);
  b = __high2float(v);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// One convolution of a block as a GEMM: out[p, n] = epilogue(sum_k
// A[p, k] * w[n, k]).  A is `a` [P, lda] for a 1x1 conv; for the 3x3 conv
// k = tap * lda + c and A[p, k] = a[pixel p shifted by tap, c].
template <typename T>
struct Phase {
  const T* a;
  int lda;
  const T* w;         // [n_out, K]
  const float* sb;    // [2, n_out]: the scale row, then the bias row
  const T* res;       // residual [P, n_out] or nullptr
  T* out;             // [P, n_out]
  int n_out;
  int K;
  bool conv3x3;
};

template <typename T>
__device__ __forceinline__ void load_chunk(const Phase<T>& ph, int P, int H,
                                           int W, int m0, int n0, int k0,
                                           uint4 (&ra)[Loads<T>::N],
                                           uint4 (&rb)[Loads<T>::N]) {
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int PER_ROW = BK / VEC;
  int c0 = k0, dy = 0, dx = 0;
  if (ph.conv3x3) {              // a chunk never straddles two taps
    const int tap = k0 / ph.lda;
    c0 = k0 - tap * ph.lda;
    dy = tap / 3 - 1;
    dx = tap % 3 - 1;
  }
#pragma unroll
  for (int i = 0; i < Loads<T>::N; ++i) {
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

template <typename T>
__device__ __forceinline__ void store_chunk(
    Smem<T>& sm, const uint4 (&ra)[Loads<T>::N],
    const uint4 (&rb)[Loads<T>::N]) {
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int PER_ROW = BK / VEC;
#pragma unroll
  for (int i = 0; i < Loads<T>::N; ++i) {
    const int v = threadIdx.x + i * THREADS;
    const int row = v / PER_ROW;
    const int kk = (v % PER_ROW) * VEC;
    *reinterpret_cast<uint4*>(&sm.a[row][kk]) = ra[i];
    *reinterpret_cast<uint4*>(&sm.b[row][kk]) = rb[i];
  }
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// acc[mi][ni][e]: the m16n8 accumulator fragment (mi, ni) of the warp's
// 32x32 sub-tile; element e sits at row g + 8*(e/2), column 2t + e%2.
__device__ __forceinline__ void multiply_chunk(Smem<__nv_bfloat16>& sm,
                                               float (&acc)[2][4][4], int wm,
                                               int wn, int g, int t) {
#pragma unroll
  for (int ks = 0; ks < BK; ks += 16) {
    uint32_t a[2][4], b[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int r = wm + mi * 16 + g;
      a[mi][0] = ld32(&sm.a[r][ks + 2 * t]);
      a[mi][1] = ld32(&sm.a[r + 8][ks + 2 * t]);
      a[mi][2] = ld32(&sm.a[r][ks + 2 * t + 8]);
      a[mi][3] = ld32(&sm.a[r + 8][ks + 2 * t + 8]);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int n = wn + ni * 8 + g;
      b[ni][0] = ld32(&sm.b[n][ks + 2 * t]);
      b[ni][1] = ld32(&sm.b[n][ks + 2 * t + 8]);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        float* d = acc[mi][ni];
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
            : "r"(a[mi][0]), "r"(a[mi][1]), "r"(a[mi][2]), "r"(a[mi][3]),
              "r"(b[ni][0]), "r"(b[ni][1]));
      }
  }
}

__device__ __forceinline__ void multiply_chunk(Smem<float>& sm,
                                               float (&acc)[2][4][4], int wm,
                                               int wn, int g, int t) {
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

template <typename T>
__device__ void run_phase(const Phase<T>& ph, int P, int H, int W,
                          Smem<T>& sm) {
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

    uint4 ra[Loads<T>::N], rb[Loads<T>::N];
    load_chunk(ph, P, H, W, m0, n0, 0, ra, rb);
    for (int c = 0; c < chunks; ++c) {
      __syncthreads();                  // the last chunk's reads are done
      store_chunk(sm, ra, rb);
      __syncthreads();
      if (c + 1 < chunks)               // next chunk in flight meanwhile
        load_chunk(ph, P, H, W, m0, n0, (c + 1) * BK, ra, rb);
      multiply_chunk(sm, acc, wm, wn, g, t);
    }

    // epilogue in f32: scale, bias, residual, relu; rounded to T once
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
            float r0, r1;
            load_pair(ph.res + at, r0, r1);
            v0 += r0;
            v1 += r1;
          }
          store_pair(ph.out + at, fmaxf(v0, 0.f), fmaxf(v1, 0.f));
        }
      }
  }
}

// One thread block per crop, walking the stack's blocks in order.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    bottleneck_stack_kernel(const T* __restrict__ x, T* y, T* h1, T* h2,
                            const T* __restrict__ w1,
                            const float* __restrict__ sb1,
                            const T* __restrict__ w2,
                            const float* __restrict__ sb2,
                            const T* __restrict__ w3,
                            const float* __restrict__ sb3, int nblk, int H,
                            int W, int C, int Wd) {
  __shared__ __align__(16) Smem<T> sm;
  const int P = H * W;
  const long long crop = blockIdx.x;
  const T* xc = x + crop * P * C;
  T* yc = y + crop * P * C;
  T* h1c = h1 + crop * P * Wd;
  T* h2c = h2 + crop * P * Wd;
  for (int b = 0; b < nblk; ++b) {
    const T* src = b == 0 ? xc : yc;
    const Phase<T> reduce{src, C, w1 + (long long)b * Wd * C, sb1 + 2 * b * Wd,
                          nullptr, h1c, Wd, C, false};
    run_phase(reduce, P, H, W, sm);
    __syncthreads();                    // h1 complete before its 3x3 reads
    const Phase<T> spatial{h1c, Wd, w2 + (long long)b * 9 * Wd * Wd,
                           sb2 + 2 * b * Wd, nullptr, h2c, Wd, 9 * Wd, true};
    run_phase(spatial, P, H, W, sm);
    __syncthreads();
    const Phase<T> expand{h2c, Wd, w3 + (long long)b * C * Wd,
                          sb3 + 2 * b * C, src, yc, C, Wd, false};
    run_phase(expand, P, H, W, sm);
    __syncthreads();                    // y complete before the next block
  }
}

template <typename T>
cudaError_t launch(const void* x, void* y, void* h1, void* h2,
                   const void* w1, const void* sb1, const void* w2,
                   const void* sb2, const void* w3, const void* sb3, int N,
                   int H, int W, int C, int Wd, int nblk, cudaStream_t s) {
  if (N < 1 || H < 1 || W < 1 || nblk < 1 || C < BN || Wd < BN ||
      C % BN != 0 || Wd % BN != 0 || (long long)H * W > 0x7fffffffLL / C)
    return cudaErrorInvalidValue;
  bottleneck_stack_kernel<T><<<N, THREADS, 0, s>>>(
      (const T*)x, (T*)y, (T*)h1, (T*)h2, (const T*)w1, (const float*)sb1,
      (const T*)w2, (const float*)sb2, (const T*)w3, (const float*)sb3, nblk,
      H, W, C, Wd);
  return cudaGetLastError();
}

int dispatch(const void* x, void* y, void* h1, void* h2, const void* w1,
             const void* sb1, const void* w2, const void* sb2, const void* w3,
             const void* sb3, int N, int H, int W, int C, int Wd, int nblk,
             int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch<float>(x, y, h1, h2, w1, sb1, w2, sb2, w3, sb3, N, H,
                              W, C, Wd, nblk, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, y, h1, h2, w1, sb1, w2, sb2, w3,
                                      sb3, N, H, W, C, Wd, nblk, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Each returns cudaGetLastError() after
// its launch (0 = launched), on `stream`, without synchronising.

// Kernel #3: one identity bottleneck.
extern "C" int fused_bottleneck(const void* x, void* y, void* h1, void* h2,
                                const void* w1, const void* sb1,
                                const void* w2, const void* sb2,
                                const void* w3, const void* sb3, int N, int H,
                                int W, int C, int Wd, int dtype,
                                void* stream) {
  return dispatch(x, y, h1, h2, w1, sb1, w2, sb2, w3, sb3, N, H, W, C, Wd, 1,
                  dtype, stream);
}

// Kernel #4: a stack of nblk identity bottlenecks in one launch.
extern "C" int fused_stage(const void* x, void* y, void* h1, void* h2,
                           const void* w1, const void* sb1, const void* w2,
                           const void* sb2, const void* w3, const void* sb3,
                           int N, int H, int W, int C, int Wd, int nblk,
                           int dtype, void* stream) {
  return dispatch(x, y, h1, h2, w1, sb1, w2, sb2, w3, sb3, N, H, W, C, Wd,
                  nblk, dtype, stream);
}
