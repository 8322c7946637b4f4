// Fused masked attention backward for Hopper (sm_90a).
//
// Replaces image_caption_tpu/ops/attention.py:_attention_bwd_kernel (the
// Pallas TPU kernel behind the custom VJP of fused_attention).  For one
// (b, h) it recomputes P and forms the three gradients:
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
// card's ~20 f32 flops per byte.  The design keeps every intermediate out of
// device memory: one thread block per (b, h) holds q, k, v, dO (rows padded
// to Dh + 1 floats against bank conflicts), P and dP/dS in shared memory,
// so each input is read from device memory once and each output written
// once.  Every sum (the softmax max and denominator, rowsum(dP o P), the
// dQ, dK and dV dots) runs in a fixed order inside one thread or one warp,
// with no atomics, so results repeat exactly from run to run.  Head dim 8
// is below the K = 16 of a bf16 mma/wgmma, so the dots run on the CUDA
// cores.  The block size follows the tile (32 threads for the pair block's
// 2x2 tiles, 256 for 37x37 or 50x50), but the pair block still spends one
// block on each of its 37,888 tiny tiles; packing several (b, h) per block
// is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

// the shared memory one block may use on sm_90 (227 KB)
constexpr size_t kMaxSmemBytes = 232448;

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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

size_t smem_bytes(int Lq, int Lk, int Dh) {
  const size_t dp = (size_t)Dh + 1;
  return sizeof(float) * (2 * (size_t)Lq * dp + 2 * (size_t)Lk * dp +
                          2 * (size_t)Lq * (size_t)Lk);
}

// One block per (b, h); blockDim.x is a multiple of 32.
template <typename T>
__global__ void fused_attention_bwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int8_t* __restrict__ mask,
    const T* __restrict__ dout, T* __restrict__ dq, T* __restrict__ dk,
    T* __restrict__ dv, int H, int Lq, int Lk, int Dh, float inv_t) {
  extern __shared__ float smem[];
  const int Dp = Dh + 1;
  float* sq = smem;              // [Lq, Dp]
  float* sdo = sq + Lq * Dp;     // [Lq, Dp]
  float* sk = sdo + Lq * Dp;     // [Lk, Dp]
  float* sv = sk + Lk * Dp;      // [Lk, Dp]
  float* sp = sv + Lk * Dp;      // [Lq, Lk]: scores, then P
  float* sds = sp + Lq * Lk;     // [Lq, Lk]: dP, then dS

  const long long bh = blockIdx.x;
  const long long b = bh / H;
  const long long qoff = bh * Lq * Dh;
  const long long koff = bh * Lk * Dh;
  const int8_t* mp = mask + b * Lq * Lk;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  for (int e = tid; e < Lq * Dh; e += nt) {
    const int i = e / Dh, d = e - (e / Dh) * Dh;
    sq[i * Dp + d] = to_f32(q[qoff + e]);
    sdo[i * Dp + d] = to_f32(dout[qoff + e]);
  }
  for (int e = tid; e < Lk * Dh; e += nt) {
    const int j = e / Dh, d = e - (e / Dh) * Dh;
    sk[j * Dp + d] = to_f32(k[koff + e]);
    sv[j * Dp + d] = to_f32(v[koff + e]);
  }
  __syncthreads();

  // scores S (masked -> -inf) and dP = dO . V^T
  for (int e = tid; e < Lq * Lk; e += nt) {
    const int i = e / Lk, j = e - (e / Lk) * Lk;
    const float* qi = sq + i * Dp;
    const float* oi = sdo + i * Dp;
    const float* kj = sk + j * Dp;
    const float* vj = sv + j * Dp;
    float s = 0.f, dp = 0.f;
    for (int d = 0; d < Dh; ++d) {
      s += (qi[d] * inv_t) * kj[d];
      dp += oi[d] * vj[d];
    }
    sp[e] = mp[e] ? -INFINITY : s;
    sds[e] = dp;
  }
  __syncthreads();

  // one warp per query row: P, then dS = P o (dP - rowsum(dP o P)).  Each
  // lane reads and writes only its own columns j = lane + 32 n.
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  for (int i = warp; i < Lq; i += nwarps) {
    float* prow = sp + i * Lk;
    float* drow = sds + i * Lk;
    float m = -INFINITY;
    for (int j = lane; j < Lk; j += 32) m = fmaxf(m, prow[j]);
    m = warp_max(m);
    if (!isfinite(m)) m = 0.f;
    float denom = 0.f;
    for (int j = lane; j < Lk; j += 32) {
      const float ex = expf(prow[j] - m);
      prow[j] = ex;
      denom += ex;
    }
    denom = fmaxf(warp_sum(denom), 1e-30f);
    float r = 0.f;
    for (int j = lane; j < Lk; j += 32) {
      const float p = prow[j] / denom;
      prow[j] = p;
      r += drow[j] * p;
    }
    r = warp_sum(r);
    for (int j = lane; j < Lk; j += 32) drow[j] = prow[j] * (drow[j] - r);
  }
  __syncthreads();

  // dV = P^T . dO and dK = dS^T . Q / t, one (j, d) per thread, i in order
  for (int e = tid; e < Lk * Dh; e += nt) {
    const int j = e / Dh, d = e - (e / Dh) * Dh;
    float acc_v = 0.f, acc_k = 0.f;
    for (int i = 0; i < Lq; ++i) {
      acc_v += sp[i * Lk + j] * sdo[i * Dp + d];
      acc_k += sds[i * Lk + j] * sq[i * Dp + d];
    }
    dv[koff + e] = from_f32<T>(acc_v);
    dk[koff + e] = from_f32<T>(acc_k * inv_t);
  }
  // dQ = dS . K / t, one (i, d) per thread, j in order
  for (int e = tid; e < Lq * Dh; e += nt) {
    const int i = e / Dh, d = e - (e / Dh) * Dh;
    const float* dsi = sds + i * Lk;
    float acc = 0.f;
    for (int j = 0; j < Lk; ++j) acc += dsi[j] * sk[j * Dp + d];
    dq[qoff + e] = from_f32<T>(acc * inv_t);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* mask, const void* dout, void* dq, void* dk,
                   void* dv, int B, int H, int Lq, int Lk, int Dh,
                   float inv_t, cudaStream_t stream) {
  const long long blocks = (long long)B * H;
  const size_t smem = smem_bytes(Lq, Lk, Dh);
  if (blocks <= 0 || blocks > 0x7fffffffLL || Lq < 1 || Lk < 1 || Dh < 1 ||
      Dh > 64 || smem > kMaxSmemBytes)
    return cudaErrorInvalidValue;
  // enough threads for the largest loop of the block, a multiple of 32
  const long long tile = (long long)Lq * Lk;
  const long long rows = (long long)(Lq > Lk ? Lq : Lk) * Dh;
  const long long work = tile > rows ? tile : rows;
  int threads = 32;
  while (threads < 256 && threads < work) threads *= 2;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_attention_bwd_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  fused_attention_bwd_kernel<T><<<(unsigned)blocks, threads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int8_t*)mask,
      (const T*)dout, (T*)dq, (T*)dk, (T*)dv, H, Lq, Lk, Dh, inv_t);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 = launched; a tile above 232,448 bytes of shared memory is
// refused).  Launches on `stream` and does not synchronise.
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
