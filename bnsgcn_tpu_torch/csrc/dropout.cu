// D1: the dropout draw, out = keep-mask ? x / keep : 0, with the mask
// jax.random.bernoulli(key, keep, x.shape) -- threefry2x32 of the key over
// each element's flat row-major index -- recomputed from (key, index) in
// the kernel, so no mask is stored and the backward (the same kernel over
// the incoming gradient, with the same key) and a rematerialized forward
// draw the same mask.
//
// Replaces no Pallas kernel: the JAX package leaves its `_dropout`
// (bnsgcn_tpu/models/gnn.py:230-235, jnp.where(bernoulli(rng, keep,
// shape), h / keep, 0)) to XLA, which fuses the draw, the compare and the
// divide into one pass. Drawn in plain torch integer ops, threefry costs
// some 200 passes over the element (utils/prng.py); this kernel is that
// fused pass.
//
// Per element, as jax's partitionable threefry draws it (the layout
// utils/prng.py documents and tests/test_torch_prng.py pins):
//   (y0, y1) = threefry2x32(key, (index >> 32, index & 0xFFFFFFFF))
//   u        = bits((y0 ^ y1) >> 9 | 0x3F800000) as f32, minus 1
//   out      = u < keep ? x / div : 0
// where keep is f32(1 - rate) and div is keep rounded to x's type (jax
// divides a bf16 x by the weakly typed scalar in bf16). The division is
// IEEE (__fdiv_rn, and nvcc builds without --use_fast_math); bf16 values
// are converted to f32, divided and rounded to nearest-even once, as
// torch and XLA compute a bf16 division.
//
// Bound on this card: operations. Threefry is 73 int32 operations per
// element (two counter adds; 20 rounds of an add, a funnel-shift rotate and
// a xor; five key injections of two adds; the xor of the output words)
// against 8 (f32) or 4 (bf16) bytes moved, above the H100's ~5 int32
// operations per byte of memory rate (16.7 T/s over 3.35 TB/s). The design
// does nothing clever: one element per thread in a grid-stride loop, the
// rounds fully unrolled with the rotations as immediates, loads and stores
// coalesced across the warp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// threefry2x32 with 20 rounds (jax._src.prng.threefry2x32's schedule).
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  constexpr int kRot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, kRot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dropout_kernel(const T* __restrict__ x, T* __restrict__ out, int64_t n,
               uint32_t k0, uint32_t k1, float keep, float div) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    uint32_t c0 = static_cast<uint32_t>(static_cast<uint64_t>(i) >> 32);
    uint32_t c1 = static_cast<uint32_t>(i);
    threefry2x32(k0, k1, c0, c1);
    const float u = __uint_as_float(((c0 ^ c1) >> 9) | 0x3F800000u) - 1.0f;
    store(out + i, u < keep ? __fdiv_rn(load(x + i), div) : 0.0f);
  }
}

}  // namespace

extern "C" {

// out[i] = mask(i) ? x[i] / div : 0 over n contiguous elements of type
// `dtype` (0 float32, 1 bfloat16) on `stream`, the mask drawn from the
// threefry key (k0, k1) against `keep`. Returns cudaGetLastError() after
// the launch, -1 for bad arguments.
int bnsgcn_dropout(const void* x, void* out, int64_t n, uint32_t k0,
                   uint32_t k1, float keep, float div, int dtype,
                   void* stream) {
  if (n < 0 || (dtype != 0 && dtype != 1) || !(div > 0.0f)) return -1;
  if (n == 0) return 0;
  const int64_t want = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0)
    dropout_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), n, k0, k1,
        keep, div);
  else
    dropout_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<__nv_bfloat16*>(out), n, k0, k1, keep, div);
  return (int)cudaGetLastError();
}

const char* bnsgcn_dropout_error(int code) {
  if (code == -1) return "bad arguments (count, dtype, divisor)";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
