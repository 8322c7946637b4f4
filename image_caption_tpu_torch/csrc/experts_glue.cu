// The routed experts' elementwise glue around their two grouped products
// (ops/experts.py: grouped_experts), for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no mixture of experts.  It
// takes the place of six PyTorch passes around torch._grouped_mm:
//
//   silu_up   h [R, 2I] (each row's I gate columns, then its I up columns)
//             -> out [R, I] = T(T(silu(f32 gate)) * f32 up)
//
//             the roundings of `F.silu(gate) * up` on the two halves of h,
//             so the result is the same bits: SiLU as x / (1 + expf(-x)) in
//             f32 rounded to the dtype T, the product in f32 rounded again.
//             PyTorch ran the two as generic strided elementwise passes with
//             the [R, I] SiLU written out between them.
//
//   combine   y [N*k, D] in expert-sorted order, inv [N*k] int32 (the row
//             of y that holds flat row n*k + j, token n's j-th choice), w
//             [N, k] f32 -> out[n] = T(sum_j w[n,j] * f32 y[inv[n*k+j]]),
//             the sum in f32 over j = 0..k-1 in that order.  PyTorch put the
//             rows back in token order (index_copy_), copied them to f32,
//             summed them in an f32 batched product (a cuBLAS gemv) and cast
//             the result: four passes, one of them twice the size of y.
//
// Each T is bf16 or f32; rows are contiguous, D and I multiples of 8, so a
// row is a whole number of 16-byte vectors.
//
// What bounds it: bytes.  Both are a few operations an element.  At the
// kimi_vl_a3b decode step (N 1024, k 6, D 2,048, I 1,408, bf16) silu_up
// moves 34.6 MB in and 17.3 MB out, combine 25.2 MB in and 4.2 MB out:
// 15.5 and 8.8 us at 3.35 TB/s, against about 284 MB the six passes moved.
// The design:
//
// * One thread a 16-byte vector of the output (8 bf16 or 4 f32 lanes); its
//   loads and its store are 16 bytes wide and neighbouring threads touch
//   neighbouring addresses, so every access is a full coalesced sector.
// * silu_up: a flat grid over the R x I/L output vectors; a thread loads
//   its gate vector and its up vector (I columns apart in the same row).
// * combine: a block a token and a slab of D; each thread first starts the
//   k 16-byte loads of its columns of the token's k rows (all in flight at
//   once), then sums them in registers.  inv and w are read by every thread
//   of a block at the same address: one broadcast each.
// * Nothing is allocated here and nothing waits: both launch on the stream
//   they are given, so a CUDA graph captures them as they are.  The grids
//   depend on R and N alone, so the prefill (233k rows a layer) and a
//   decode step (6,144) take the same code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 8;                      // the most choices a token

// A 16-byte vector as four 32-bit words, read and written lane by lane in
// f32.  Lane i of a bf16 vector is the low (even i) or high half of word
// i / 2: the element at the lower address sits in the low half.
template <typename T> struct Lanes;

template <> struct Lanes<__nv_bfloat16> {
  static constexpr int kCount = 8;
  __device__ __forceinline__ static float get(const uint32_t (&w)[4], int i) {
    return __uint_as_float((i & 1) ? (w[i >> 1] & 0xffff0000u)
                                   : (w[i >> 1] << 16));
  }
  // to the nearest bf16 (ties to even), as PyTorch rounds f32 to bf16
  __device__ __forceinline__ static float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  // w must start zeroed
  __device__ __forceinline__ static void set(uint32_t (&w)[4], int i,
                                             float x) {
    uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(x));
    w[i >> 1] |= (i & 1) ? (b << 16) : b;
  }
};

template <> struct Lanes<float> {
  static constexpr int kCount = 4;
  __device__ __forceinline__ static float get(const uint32_t (&w)[4], int i) {
    return __uint_as_float(w[i]);
  }
  __device__ __forceinline__ static float round(float x) { return x; }
  __device__ __forceinline__ static void set(uint32_t (&w)[4], int i,
                                             float x) {
    w[i] = __float_as_uint(x);
  }
};

__device__ __forceinline__ void load16(const void* p, uint32_t (&w)[4]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}

__device__ __forceinline__ void store16(void* p, const uint32_t (&w)[4]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// out [R, I] from h [R, 2I]; `vectors` = R * I / L, `row_vectors` = I / L.
template <typename T>
__global__ void __launch_bounds__(kThreads)
silu_up_kernel(const T* __restrict__ h, T* __restrict__ out,
               long long vectors, int row_vectors, int width) {
  using L = Lanes<T>;
  const long long v = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (v >= vectors) return;
  const long long r = v / row_vectors;
  const int c = (int)(v - r * row_vectors) * L::kCount;
  const T* row = h + r * 2 * width;
  uint32_t gate[4], up[4], o[4] = {0u, 0u, 0u, 0u};
  load16(row + c, gate);
  load16(row + width + c, up);
#pragma unroll
  for (int i = 0; i < L::kCount; ++i) {
    const float x = L::get(gate, i);
    const float s = L::round(x / (1.0f + expf(-x)));
    L::set(o, i, s * L::get(up, i));
  }
  store16(out + r * width + c, o);
}

// out [N, D] from y [N*k, D]: grid (N, slabs of D), `row_vectors` = D / L.
template <typename T>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const T* __restrict__ y, const int* __restrict__ inv,
               const float* __restrict__ w, T* __restrict__ out, int k,
               int row_vectors, int width) {
  using L = Lanes<T>;
  const int v = blockIdx.y * blockDim.x + threadIdx.x;
  if (v >= row_vectors) return;
  const long long n = blockIdx.x;
  const int c = v * L::kCount;
  uint32_t rows[kMaxK][4];
#pragma unroll
  for (int j = 0; j < kMaxK; ++j)
    if (j < k) load16(y + (long long)inv[n * k + j] * width + c, rows[j]);
  float acc[L::kCount];
#pragma unroll
  for (int i = 0; i < L::kCount; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) {
    if (j < k) {
      const float wj = w[n * k + j];
#pragma unroll
      for (int i = 0; i < L::kCount; ++i)
        acc[i] = fmaf(wj, L::get(rows[j], i), acc[i]);
    }
  }
  uint32_t o[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < L::kCount; ++i) L::set(o, i, acc[i]);
  store16(out + n * width + c, o);
}

template <typename T>
int launch_silu_up(const void* h, void* out, long long rows, int width,
                   cudaStream_t stream) {
  const int row_vectors = width / Lanes<T>::kCount;
  const long long vectors = rows * row_vectors;
  const long long blocks = (vectors + kThreads - 1) / kThreads;
  silu_up_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(h), static_cast<T*>(out), vectors, row_vectors,
      width);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_combine(const void* y, const void* inv, const void* w, void* out,
                   long long tokens, int k, int width, cudaStream_t stream) {
  const int row_vectors = width / Lanes<T>::kCount;
  const int threads = row_vectors < kThreads ? (row_vectors + 31) / 32 * 32
                                             : kThreads;
  const dim3 grid((unsigned)tokens, (row_vectors + threads - 1) / threads);
  combine_kernel<T><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(y), static_cast<const int*>(inv),
      static_cast<const float*>(w), static_cast<T*>(out), k, row_vectors,
      width);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 bf16, 1 f32.  Each returns cudaGetLastError() after its launch
// (0 = launched; nothing to do is 0 with no launch), launches on `stream`
// and does not synchronise.  The wrapper has checked every shape.

extern "C" int silu_up(const void* h, void* out, long long rows, int width,
                       int dtype, void* stream) {
  if (rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0 ? launch_silu_up<__nv_bfloat16>(h, out, rows, width, s)
                    : launch_silu_up<float>(h, out, rows, width, s);
}

extern "C" int combine(const void* y, const void* inv, const void* w,
                       void* out, long long tokens, int k, int width,
                       int dtype, void* stream) {
  if (tokens == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0
             ? launch_combine<__nv_bfloat16>(y, inv, w, out, tokens, k, width,
                                             s)
             : launch_combine<float>(y, inv, w, out, tokens, k, width, s);
}
