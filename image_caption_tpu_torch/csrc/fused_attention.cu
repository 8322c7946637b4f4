// Fused masked attention forward for Hopper (sm_90a).
//
// Replaces image_caption_tpu/ops/attention.py:_fused_attention_kernel (the
// Pallas TPU kernel behind fused_attention):
//
//   out = softmax((q * (1/t)) . k^T, masked -> -inf) . v
//
// q [B,H,Lq,Dh], k/v [B,H,Lk,Dh] (f32 or bf16, contiguous), mask int8
// [B,Lq,Lk] shared by all heads (nonzero = masked).  The row max is guarded
// to 0 when it is not finite and the denominator is floored at 1e-30, so a
// fully masked row comes out exactly 0.  Sums are taken in f32; the output
// takes q's dtype.
//
// What bounds it: bytes.  At the caption shapes (Dh = 8, L = 37 or 2) a
// query row does 4*Dh*Lk flops against 2*Dh*Lk*elem bytes of K/V, far below
// the card's ~20 flops per byte for f32 on the CUDA cores, so the least
// time is q, k, v and out read or written once.  The design keeps the
// traffic to that: one thread per (b, h, query row), its q row and its
// output accumulator in registers, K and V of one (b, h) read from global
// memory, where the threads of a warp that share a (b, h) hit the same
// rows and L2 serves the rest.  Two passes over the keys (max, then
// exp-sum and the weighted sum of V) mirror the JAX formula; the scores are
// recomputed in the second pass instead of stored.  Head dim 8 is below
// the K = 16 of a bf16 mma/wgmma, so the dots run on the CUDA cores.
// Launch overhead dominates at these sizes; shared-memory tiles, tensor
// cores with Dh padded to 16 and one block per batch item over many heads
// are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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

// MAXD is the register tile of a row: the smallest of 8, 16, 32, 64 that
// holds Dh.  Lanes d >= Dh stay 0 and are never read from memory.
template <typename T, int MAXD>
__global__ void __launch_bounds__(128)
fused_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const int8_t* __restrict__ mask,
                           T* __restrict__ out, int B, int H, int Lq, int Lk,
                           int Dh, float inv_t) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= (long long)B * H * Lq) return;
  const int i = (int)(row % Lq);
  const long long bh = row / Lq;
  const long long b = bh / H;

  const T* qp = q + row * Dh;
  const T* kp = k + bh * Lk * Dh;
  const T* vp = v + bh * Lk * Dh;
  const int8_t* mp = mask + (b * Lq + i) * Lk;

  float qr[MAXD];
#pragma unroll
  for (int d = 0; d < MAXD; ++d) qr[d] = d < Dh ? to_f32(qp[d]) * inv_t : 0.f;

  // pass 1: row max over the unmasked keys
  float m = -INFINITY;
  for (int j = 0; j < Lk; ++j) {
    if (mp[j]) continue;
    const T* kj = kp + (long long)j * Dh;
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < MAXD; ++d)
      if (d < Dh) s += qr[d] * to_f32(kj[d]);
    m = fmaxf(m, s);
  }
  if (!isfinite(m)) m = 0.f;

  // pass 2: exp-sum and the unnormalised weighted sum of V
  float acc[MAXD];
#pragma unroll
  for (int d = 0; d < MAXD; ++d) acc[d] = 0.f;
  float denom = 0.f;
  for (int j = 0; j < Lk; ++j) {
    if (mp[j]) continue;
    const T* kj = kp + (long long)j * Dh;
    const T* vj = vp + (long long)j * Dh;
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < MAXD; ++d)
      if (d < Dh) s += qr[d] * to_f32(kj[d]);
    const float p = expf(s - m);
    denom += p;
#pragma unroll
    for (int d = 0; d < MAXD; ++d)
      if (d < Dh) acc[d] += p * to_f32(vj[d]);
  }
  denom = fmaxf(denom, 1e-30f);

  T* op = out + row * Dh;
#pragma unroll
  for (int d = 0; d < MAXD; ++d)
    if (d < Dh) op[d] = from_f32<T>(acc[d] / denom);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* mask, void* out, int B, int H, int Lq, int Lk,
                   int Dh, float inv_t, cudaStream_t stream) {
  const int threads = 128;
  const long long rows = (long long)B * H * Lq;
  const long long blocks = (rows + threads - 1) / threads;
  if (rows <= 0 || blocks > 0x7fffffffLL || Dh < 1 || Dh > 64)
    return cudaErrorInvalidValue;
#define ICT_LAUNCH(D)                                                      \
  fused_attention_fwd_kernel<T, D><<<(unsigned)blocks, threads, 0, stream>>>( \
      (const T*)q, (const T*)k, (const T*)v, (const int8_t*)mask, (T*)out, \
      B, H, Lq, Lk, Dh, inv_t)
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
