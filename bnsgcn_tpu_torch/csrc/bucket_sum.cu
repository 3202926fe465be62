// ELL bucket gather-sum for one bucket of the ELL SpMM:
//
//     out[r, :] = sum_{w < W} h[idx[r, w], :]      (idx[r, w] == n_src: skip)
//
// Replaces the TPU kernel tools/pallas_spmm.py `_bucket_kernel` /
// `pallas_bucket_sum` (the same function as bnsgcn_tpu/ops/ell.py
// `_bucket_sum`), which the hybrid SpMM's ELL residual runs forward and, on
// the transposed layout, backward; the use_pp precompute runs it at the raw
// feature width.
//
// Bound on this card: bytes. Each real index pulls one H-float row of h from
// device memory (4H bytes per 4-byte index) and adds it once, so the sum is
// 1 FLOP per 4 bytes moved -- far below the H100's ~20 FLOP/byte f32 ridge.
// Least time = (R*W*4 + nnz*4H + R*H*4) bytes / 3.35 TB/s.
//
// Design:
//   * one warp per output row, 8 rows per 256-thread block; the f32 sums
//     stay in registers and each output row is written once -- no [R, W, H]
//     gathered intermediate ever reaches device memory (the Pallas study
//     kernel's double-buffered per-row DMAs become plain coalesced loads that
//     the warp keeps several of in flight);
//   * the warp loads 32 indices at a time, one per lane, and broadcasts each
//     with a shuffle, so index traffic is one coalesced read per 32 entries;
//   * each lane owns up to 4 vectors of the row per column chunk, loaded as
//     float4 when H % 4 == 0, float2 when H % 2 == 0 (H = 602 in the
//     precompute), else scalars -- H is never assumed a multiple of the
//     vector width;
//   * the pad index n_src is skipped (a warp-uniform branch), so the caller
//     never builds the [N+1, H] zero-padded copy of h the TPU kernel reads.
// Speed (TMA row gathers, bf16/int8/fp8 rows) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kSlots = 4;   // vectors per lane per column chunk

template <int V> struct VecT;
template <> struct VecT<1> { using T = float; };
template <> struct VecT<2> { using T = float2; };
template <> struct VecT<4> { using T = float4; };

__device__ __forceinline__ void vzero(float& a) { a = 0.f; }
__device__ __forceinline__ void vzero(float2& a) { a = make_float2(0.f, 0.f); }
__device__ __forceinline__ void vzero(float4& a) {
  a = make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ void vadd(float& a, float b) { a += b; }
__device__ __forceinline__ void vadd(float2& a, float2 b) {
  a.x += b.x; a.y += b.y;
}
__device__ __forceinline__ void vadd(float4& a, float4 b) {
  a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
}

template <int V>
__global__ void __launch_bounds__(kWarps * 32)
bucket_sum_kernel(const float* __restrict__ h, const int32_t* __restrict__ idx,
                  float* __restrict__ out, int64_t n_src, int64_t H, int64_t R,
                  int64_t W) {
  using T = typename VecT<V>::T;
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= R) return;
  const int64_t hv = H / V;                      // vectors per row
  const T* __restrict__ hvec = reinterpret_cast<const T*>(h);
  T* __restrict__ orow = reinterpret_cast<T*>(out + r * H);
  const int32_t* __restrict__ ridx = idx + r * W;

  for (int64_t c0 = 0; c0 < hv; c0 += 32 * kSlots) {
    T acc[kSlots];
#pragma unroll
    for (int q = 0; q < kSlots; ++q) vzero(acc[q]);
    for (int64_t w0 = 0; w0 < W; w0 += 32) {
      const int32_t mine = (w0 + lane < W) ? ridx[w0 + lane] : (int32_t)n_src;
      const int nw = (int)((W - w0) < 32 ? (W - w0) : 32);
#pragma unroll 4
      for (int j = 0; j < nw; ++j) {
        const int32_t s = __shfl_sync(0xffffffffu, mine, j);
        if (s >= 0 && (int64_t)s < n_src) {      // warp-uniform: pads skip
          const T* __restrict__ src = hvec + (int64_t)s * hv;
#pragma unroll
          for (int q = 0; q < kSlots; ++q) {
            const int64_t c = c0 + lane + 32 * q;
            if (c < hv) vadd(acc[q], __ldg(src + c));
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
      const int64_t c = c0 + lane + 32 * q;
      if (c < hv) orow[c] = acc[q];
    }
  }
}

}  // namespace

extern "C" {

// h [n_src, H] f32, idx [R, W] int32, out [R, H] f32, all contiguous on the
// device. Launches on `stream`; returns cudaGetLastError() after the launch.
int bnsgcn_bucket_sum_f32(const void* h, const void* idx, void* out,
                          int64_t n_src, int64_t H, int64_t R, int64_t W,
                          void* stream) {
  if (R <= 0 || H <= 0) return 0;
  const dim3 block(kWarps * 32);
  const dim3 grid((unsigned)((R + kWarps - 1) / kWarps));
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const uintptr_t a = reinterpret_cast<uintptr_t>(h) |
                      reinterpret_cast<uintptr_t>(out);
  const float* hf = static_cast<const float*>(h);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  float* of = static_cast<float*>(out);
  if (H % 4 == 0 && a % 16 == 0) {
    bucket_sum_kernel<4><<<grid, block, 0, st>>>(hf, ix, of, n_src, H, R, W);
  } else if (H % 2 == 0 && a % 8 == 0) {
    bucket_sum_kernel<2><<<grid, block, 0, st>>>(hf, ix, of, n_src, H, R, W);
  } else {
    bucket_sum_kernel<1><<<grid, block, 0, st>>>(hf, ix, of, n_src, H, R, W);
  }
  return (int)cudaGetLastError();
}

const char* bnsgcn_bucket_sum_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
