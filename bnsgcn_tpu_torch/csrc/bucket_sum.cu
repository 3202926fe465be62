// The ELL SpMM of one direction of one part's layout, in one launch:
//
//     out[r, :] = base[base_row[r], :] + sum_{e in row r} h[src[e], :]
//
// (the base term is optional). Row r's terms are src[row_ptr[r] ..
// row_ptr[r + 1]), a CSR that ops/bucket_sum.py `pack_rows` packs once per
// layout from the bucketed ELL tables: split rows joined back into one row,
// pads dropped, degree-0 rows empty, multi-edges kept as repeated entries.
// `work` lists every row once: first the n_long rows longer than the
// long-row threshold, longest first, then the others in the layout's work
// order.
//
// Replaces the TPU kernel tools/pallas_spmm.py `_bucket_kernel` /
// `pallas_bucket_sum` together with what its wrapper `pallas_ell_apply` and
// bnsgcn_tpu/ops/ell.py `_ell_apply` do around it (the split-row combine and
// the permutation gather), and, in the hybrid SpMM, the permutation of the
// dense tiles' output and the add of the two parts
// (bnsgcn_tpu/ops/block_spmm.py `make_block_spmm`): `base` is the dense-tile
// kernel's output in cluster order and `base_row` the permutation back to
// row order. It runs forward, on the transposed layout backward, and at the
// raw feature width in the use_pp precompute.
//
// Bound on this card: bytes, and in practice the L2. Each term pulls 4 H
// bytes of h for H adds. A forward residual pass at full size gathers 41.8M
// rows of 1 KB from a 238 MB table, ~5x the 50 MB L2, so what separates the
// kernel from its L2-resident rate is the misses to device memory.
//
// Design:
//   * L2-sized column passes: the grid's slowest axis (y) is a chunk of C
//     columns (a template parameter, 32, 64 or 256), so the CTAs resident at
//     any time gather from the same n_src x C x 4-byte slice of h (30 MB at
//     C = 32 at full size, inside the L2). The indices are read again for
//     every chunk;
//   * a group of 8 lanes per row, each lane C / 8 columns as registers,
//     read as float4 (float2 at H = 602, scalars at an odd H or an
//     unaligned pointer): 4 rows per warp step, 32 rows per 256-thread CTA.
//     A group reads its row's indices 8 at a time, coalesced, one per lane,
//     and broadcasts each by shuffle; the next 8 are in flight meanwhile. A
//     warp step lasts as long as its longest row; lanes past a shorter
//     row's end load nothing;
//   * long rows (more than the wrapper's threshold of terms) get a CTA of
//     their own, dispatched first: its 8 warps sum fixed contiguous slices
//     of the row (each warp's 4 groups a quarter of its slice), reduce the
//     groups by shuffles in a fixed tree and the warps in shared memory in
//     warp order;
//   * each output element is written once, base included: no atomics, no
//     zero-fill, and two calls give the same bits.
// Speed beyond this (TMA row gathers, bf16/int8/fp8 rows) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kGroup = 8;                              // lanes per row
constexpr int kRowsPerStep = 32 / kGroup;              // 4
constexpr int kRowsPerCta = kWarps * kRowsPerStep;     // 32
constexpr unsigned kAll = 0xffffffffu;

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

// Adds h[src[b .. b + n), h0 + columns] into the group's accumulators; slot
// j of lane gl holds vector j * kGroup + gl of the chunk. Every lane of the
// warp calls it (the shuffles are warp-wide); a lane with n == 0 adds
// nothing.
template <int V, int C>
__device__ __forceinline__ void gather_sum(
    const float* __restrict__ h, const int32_t* __restrict__ src, int64_t b,
    int n, int h0, int H, int grp, int gl,
    typename VecT<V>::T (&acc)[C / (kGroup * V)]) {
  using T = typename VecT<V>::T;
  constexpr int kSlots = C / (kGroup * V);
  const int n_max = __reduce_max_sync(kAll, n);
  int cur = gl < n ? src[b + gl] : -1;
  for (int p = 0; p < n_max; p += kGroup) {
    const int q = p + kGroup + gl;
    const int nxt = q < n ? src[b + q] : -1;           // in flight
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const int s = __shfl_sync(kAll, cur, grp * kGroup + k);
      if (s >= 0) {
        const T* __restrict__ row =
            reinterpret_cast<const T*>(h + (int64_t)s * H + h0);
#pragma unroll
        for (int j = 0; j < kSlots; ++j) {
          const int v = j * kGroup + gl;
          if (h0 + v * V < H) vadd(acc[j], __ldg(row + v));
        }
      }
    }
    cur = nxt;
  }
}

template <int V, int C>
__global__ void __launch_bounds__(kThreads)
ell_rows_kernel(const float* __restrict__ h,
                const int32_t* __restrict__ row_ptr,
                const int32_t* __restrict__ src,
                const int32_t* __restrict__ work, int n_rows, int n_long,
                const float* __restrict__ base,
                const int32_t* __restrict__ base_row,
                float* __restrict__ out, int H) {
  using T = typename VecT<V>::T;
  constexpr int kSlots = C / (kGroup * V);
  __shared__ float part[kWarps][C];                    // a long row's warps
  const int h0 = blockIdx.y * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane / kGroup, gl = lane % kGroup;
  T acc[kSlots];
#pragma unroll
  for (int j = 0; j < kSlots; ++j) vzero(acc[j]);

  if ((int)blockIdx.x < n_long) {                      // one long row
    const int r = work[blockIdx.x];
    const int64_t b = row_ptr[r];
    const int n = row_ptr[r + 1] - row_ptr[r];
    const int per_w = (n + kWarps - 1) / kWarps;
    const int w_lo = min(n, warp * per_w), w_hi = min(n, w_lo + per_w);
    const int per_g = (w_hi - w_lo + kRowsPerStep - 1) / kRowsPerStep;
    const int g_lo = min(w_hi, w_lo + grp * per_g);
    const int g_hi = min(w_hi, g_lo + per_g);
    gather_sum<V, C>(h, src, b + g_lo, g_hi - g_lo, h0, H, grp, gl, acc);
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      float* f = reinterpret_cast<float*>(&acc[j]);
#pragma unroll
      for (int e = 0; e < V; ++e) {                    // (g0 + g1) + (g2 + g3)
        f[e] += __shfl_xor_sync(kAll, f[e], kGroup);
        f[e] += __shfl_xor_sync(kAll, f[e], 2 * kGroup);
      }
      if (grp == 0) {
#pragma unroll
        for (int e = 0; e < V; ++e) part[warp][(j * kGroup + gl) * V + e] = f[e];
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < C; c += kThreads) {
      if (h0 + c < H) {
        float s = part[0][c];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) s += part[w][c];
        if (base != nullptr) s = base[(int64_t)base_row[r] * H + h0 + c] + s;
        out[(int64_t)r * H + h0 + c] = s;
      }
    }
    return;
  }

  const int64_t i = (int64_t)n_long +
                    (int64_t)(blockIdx.x - n_long) * kRowsPerCta +
                    warp * kRowsPerStep + grp;
  const int r = i < n_rows ? work[i] : -1;
  int64_t b = 0;
  int n = 0;
  if (r >= 0) {
    b = row_ptr[r];
    n = row_ptr[r + 1] - row_ptr[r];
  }
  gather_sum<V, C>(h, src, b, n, h0, H, grp, gl, acc);
  if (r < 0) return;
  T* __restrict__ o = reinterpret_cast<T*>(out + (int64_t)r * H + h0);
  const T* __restrict__ bs =
      base != nullptr
          ? reinterpret_cast<const T*>(base + (int64_t)base_row[r] * H + h0)
          : nullptr;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int v = j * kGroup + gl;
    if (h0 + v * V < H) {
      T x = acc[j];
      if (bs != nullptr) {
        T y = __ldg(bs + v);
        vadd(y, x);
        x = y;
      }
      o[v] = x;
    }
  }
}

template <int V, int C>
int launch(const void* h, const void* row_ptr, const void* src,
           const void* work, int n_rows, int n_long, const void* base,
           const void* base_row, void* out, int H, cudaStream_t stream) {
  const long long n_short = (long long)n_rows - n_long;
  const long long nx = n_long + (n_short + kRowsPerCta - 1) / kRowsPerCta;
  const dim3 grid((unsigned)nx, (unsigned)((H + C - 1) / C));
  ell_rows_kernel<V, C><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(h), static_cast<const int32_t*>(row_ptr),
      static_cast<const int32_t*>(src), static_cast<const int32_t*>(work),
      n_rows, n_long, static_cast<const float*>(base),
      static_cast<const int32_t*>(base_row), static_cast<float*>(out), H);
  return (int)cudaGetLastError();
}

template <int V>
int launch_chunk(const void* h, const void* row_ptr, const void* src,
                 const void* work, int n_rows, int n_long, const void* base,
                 const void* base_row, void* out, int H, int C,
                 cudaStream_t stream) {
  switch (C) {
    case 32:
      return launch<V, 32>(h, row_ptr, src, work, n_rows, n_long, base,
                           base_row, out, H, stream);
    case 64:
      return launch<V, 64>(h, row_ptr, src, work, n_rows, n_long, base,
                           base_row, out, H, stream);
    case 256:
      return launch<V, 256>(h, row_ptr, src, work, n_rows, n_long, base,
                            base_row, out, H, stream);
    default:
      return -1;
  }
}

}  // namespace

extern "C" {

// h [n_src, H] f32; row_ptr [n_rows + 1], src [nnz], work [n_rows] int32;
// base [*, H] f32 and base_row [n_rows] int32, or both null; out [n_rows, H]
// f32; all contiguous on the device. C: 32, 64 or 256 columns per pass.
// Launches on `stream`; returns cudaGetLastError() after the launch, -1 for
// a column chunk the library was not built for.
int bnsgcn_ell_rows_f32(const void* h, const void* row_ptr, const void* src,
                        const void* work, int n_rows, int n_long,
                        const void* base, const void* base_row, void* out,
                        int H, int C, void* stream) {
  if (C != 32 && C != 64 && C != 256) return -1;
  if (n_rows <= 0 || H <= 0) return 0;
  const auto st = reinterpret_cast<cudaStream_t>(stream);
  const uintptr_t a = reinterpret_cast<uintptr_t>(h) |
                      reinterpret_cast<uintptr_t>(out) |
                      reinterpret_cast<uintptr_t>(base);
  if (H % 4 == 0 && a % 16 == 0)
    return launch_chunk<4>(h, row_ptr, src, work, n_rows, n_long, base,
                           base_row, out, H, C, st);
  if (H % 2 == 0 && a % 8 == 0)
    return launch_chunk<2>(h, row_ptr, src, work, n_rows, n_long, base,
                           base_row, out, H, C, st);
  return launch_chunk<1>(h, row_ptr, src, work, n_rows, n_long, base,
                         base_row, out, H, C, st);
}

const char* bnsgcn_ell_rows_error(int code) {
  if (code == -1) return "bad arguments (column chunk not 32, 64 or 256)";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
