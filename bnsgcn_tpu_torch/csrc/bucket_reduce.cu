// Width-axis reduction of a gathered ELL bucket:
//
//     out[r, :] = sum_{w < W} g[r, w, :]      accumulated in f32,
//                                             stored in g's dtype (f32, bf16)
//
// Replaces the TPU kernel tools/pallas_spmm.py `_reduce_kernel` /
// `pallas_bucket_reduce`: the reduce half of the ELL bucket sum, which the
// TPU path once ran after the XLA gather (retired there, bnsgcn_tpu/ops/
// ell.py:488, in favour of an unrolled accumulation; the port's own ELL path
// gathers and sums in one kernel, K1). Its TPU shapes were f32
// [3592, 32, 602] and [64, 16, 602].
//
// Bound on this card: bytes. Each input element is read once and added once
// (1 f32 add per 4 bytes read, or per 2 in bf16), each output written once:
// least time = (R*W*H + R*H) * sizeof(T) / 3.35 TB/s, far above the adds
// over 67 TFLOP/s.
//
// Design: one thread owns one output row segment of V contiguous elements
// and walks W with a stride of H, summing in f32 registers in w order (the
// plain version's order, so f32 results agree bitwise with it). Neighbouring
// threads own neighbouring segments of the same row, so each step over w is
// one coalesced read of the row. V is the widest vector that H and the
// pointers' alignment allow: 16 bytes (float4 / 8 bf16) where H is a
// multiple of the vector, then 8 and 4 bytes, else scalars -- H = 602 of the
// TPU shapes takes float2 / 2 bf16, never assumed to be a multiple of 4. The
// f32 sum is cast to the output type once (bf16: round to nearest even, as
// astype does).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bucket_reduce_kernel(const T* __restrict__ g, T* __restrict__ out, int64_t R,
                     int64_t W, int64_t H) {
  const int64_t hv = H / V;                         // vectors per row
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= R * hv) return;
  const int64_t r = t / hv;
  const int64_t c = t - r * hv;
  const Vec<T, V>* __restrict__ src =
      reinterpret_cast<const Vec<T, V>*>(g + r * W * H) + c;
  float acc[V];
#pragma unroll
  for (int q = 0; q < V; ++q) acc[q] = 0.f;
#pragma unroll 8
  for (int64_t w = 0; w < W; ++w) {
    const Vec<T, V> x = src[w * hv];
#pragma unroll
    for (int q = 0; q < V; ++q) acc[q] += to_f32(x.v[q]);
  }
  Vec<T, V> y;
#pragma unroll
  for (int q = 0; q < V; ++q) y.v[q] = from_f32<T>(acc[q]);
  reinterpret_cast<Vec<T, V>*>(out + r * H)[c] = y;
}

template <typename T, int V>
int launch(const void* g, void* out, int64_t R, int64_t W, int64_t H,
           cudaStream_t st) {
  const int64_t n = R * (H / V);
  const dim3 grid((unsigned)((n + kThreads - 1) / kThreads));
  bucket_reduce_kernel<T, V><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(g), static_cast<T*>(out), R, W, H);
  return (int)cudaGetLastError();
}

// the widest of 16/8/4-byte vectors (then scalars) that H and both pointers'
// alignment allow
template <typename T>
int dispatch(const void* g, void* out, int64_t R, int64_t W, int64_t H,
             cudaStream_t st) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(g) |
                      reinterpret_cast<uintptr_t>(out);
  constexpr int v16 = 16 / sizeof(T), v8 = 8 / sizeof(T), v4 = 4 / sizeof(T);
  if (H % v16 == 0 && a % 16 == 0) return launch<T, v16>(g, out, R, W, H, st);
  if (H % v8 == 0 && a % 8 == 0) return launch<T, v8>(g, out, R, W, H, st);
  if (v4 > 1 && H % v4 == 0 && a % 4 == 0)
    return launch<T, (v4 > 1 ? v4 : 1)>(g, out, R, W, H, st);
  return launch<T, 1>(g, out, R, W, H, st);
}

}  // namespace

extern "C" {

// g [R, W, H], out [R, H], contiguous on the device, both of `dtype`
// (0 = float32, 1 = bfloat16). Launches on `stream`; returns
// cudaGetLastError() after the launch (-1 for an unknown dtype).
int bnsgcn_bucket_reduce(const void* g, void* out, int64_t R, int64_t W,
                         int64_t H, int dtype, void* stream) {
  if (R <= 0 || H <= 0) return 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(g, out, R, W, H, st);
  if (dtype == 1) return dispatch<__nv_bfloat16>(g, out, R, W, H, st);
  return -1;
}

const char* bnsgcn_bucket_reduce_error(int code) {
  if (code == -1) return "unknown dtype code";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
