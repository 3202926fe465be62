// The ELL SpMM of one direction of one part's layout, in one launch:
//
//     out[r, :] = base[base_row[r], :] + scale * sum_{e in row r} h[src[e], :]
//
// (the base and the scale are optional). Row r's terms are src[row_ptr[r] ..
// row_ptr[r + 1]), a CSR that ops/bucket_sum.py `pack_rows` packs once per
// layout from the bucketed ELL tables: split rows joined back into one row,
// pads dropped, degree-0 rows empty, multi-edges kept as repeated entries.
// `work` lists every row once: first the n_long rows longer than the
// long-row threshold, longest first, then the others, longest first.
//
// Row element types (the `kind` argument), each summed in its accumulator:
//   f32 rows  -> f32 sums, f32 out;
//   bf16 rows -> f32 sums, bf16 out (the sum rounded once);
//   int8 rows -> exact int32 sums; out int32 (the raw accumulators), or
//                f32 / bf16 as int32 -> f32 x scale, rounded to the out type;
//   e4m3 rows -> f32 sums; out f32 or bf16, x scale.
// The split-row combine happens in the accumulator (a split row's chunks are
// one CSR row), so it is exact for int8. `scale` (a device f32 scalar, the
// quantizer's one per-call scale) multiplies after the sum, as the JAX
// package's `_ell_apply` multiplies after its combine. The base (f32, the
// dense tiles' output in the hybrid) is added after the residual has been
// scaled and rounded to the out type, and a bf16 out rounds the base to bf16
// first: the JAX package computes `dense + ell(h)` in h's dtype.
//
// Replaces the TPU kernel tools/pallas_spmm.py `_bucket_kernel` /
// `pallas_bucket_sum` together with what its wrapper `pallas_ell_apply` and
// bnsgcn_tpu/ops/ell.py `_ell_apply` / `_bucket_sum` do around it (the
// split-row combine, the permutation gather, the int8/e4m3 dequant scale),
// and, in the hybrid SpMM, the permutation of the dense tiles' output and
// the add of the two parts (bnsgcn_tpu/ops/block_spmm.py `make_block_spmm`):
// `base` is the dense-tile kernel's output in cluster order and `base_row`
// the permutation back to row order. It runs forward, on the transposed
// layout backward, and at the raw feature width in the use_pp precompute.
//
// Bound on this card: bytes, and in practice the L2. Each term pulls a row
// slice of h for its adds. A forward residual pass at full size and f32
// gathers 41.8M rows of 1 KB from a 238 MB table, ~5x the 50 MB L2, so what
// separates the kernel from its L2-resident rate is the misses to device
// memory; int8 and e4m3 rows move a quarter of the bytes, bf16 rows half.
//
// Design:
//   * L2-sized column passes: the grid's slowest axis (y) is a chunk of
//     128 bytes of each row (32 f32, 64 bf16 or 128 int8/e4m3 columns), so
//     the CTAs resident at any time gather from the same n_src x 128-byte
//     slice of h (30 MB at full size, inside the L2). The indices are read
//     again for every chunk;
//   * a group of 8 lanes per row, each lane 16 bytes of the chunk as
//     accumulators, read as one 16-byte vector where the row width and the
//     pointer allow it (else 8 (f32), 4, 2 (bf16) or 1 byte per load) and
//     converted to the accumulator type in the load (int8 -> int32, e4m3 ->
//     f32 by the cvt instruction, bf16 -> f32 by a shift): 4 rows per warp
//     step, 32 rows per 256-thread CTA. A group reads its row's indices 8 at
//     a time, coalesced, one per lane, and broadcasts each by shuffle; the
//     next 8 are in flight meanwhile. A warp step lasts as long as its
//     longest row; lanes past a shorter row's end load nothing;
//   * long rows (more than the wrapper's threshold of terms) get a CTA of
//     their own, dispatched first: its 8 warps sum fixed contiguous slices
//     of the row (each warp's 4 groups a quarter of its slice), reduce the
//     groups by shuffles in a fixed tree and the warps in shared memory in
//     warp order;
//   * each output element is written once, base included: no atomics, no
//     zero-fill, and two calls give the same bits.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kGroup = 8;                              // lanes per row
constexpr int kRowsPerStep = 32 / kGroup;              // 4
constexpr int kRowsPerCta = kWarps * kRowsPerStep;     // 32
constexpr int kLaneBytes = 16;                         // of a row, per pass
constexpr int kChunkBytes = kGroup * kLaneBytes;       // 128
constexpr unsigned kAll = 0xffffffffu;

// row element kinds and output kinds (the C interface's codes)
enum { kF32 = 0, kBF16 = 1, kI8 = 2, kE4M3 = 3 };
enum { kOutF32 = 0, kOutBF16 = 1, kOutI32 = 2 };

// Storage types: float, uint16_t (bf16 bits), int8_t, uint8_t (e4m3 bits).
template <typename T> struct AccOf { using A = float; };
template <> struct AccOf<int8_t> { using A = int; };

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(uint16_t b) {
  return __uint_as_float(static_cast<uint32_t>(b) << 16);
}
__device__ __forceinline__ int widen(int8_t x) { return x; }
__device__ __forceinline__ float widen(uint8_t b) {
  __nv_fp8_e4m3 v;
  v.__x = b;
  return static_cast<float>(v);
}

template <int VB> struct Raw;
template <> struct Raw<16> { using T = uint4; };
template <> struct Raw<8> { using T = uint2; };
template <> struct Raw<4> { using T = unsigned int; };
template <> struct Raw<2> { using T = unsigned short; };
template <> struct Raw<1> { using T = unsigned char; };

// One VB-byte vector of a row: VB / sizeof(T) elements.
template <typename T, int VB>
union Vec {
  typename Raw<VB>::T raw;
  T e[VB / sizeof(T)];
};

template <typename T, int VB>
struct Shape {
  static constexpr int kVe = VB / (int)sizeof(T);      // elements per load
  static constexpr int kLaneCols = kLaneBytes / (int)sizeof(T);
  static constexpr int kSlots = kLaneCols / kVe;       // loads per term
  static constexpr int kChunk = kGroup * kLaneCols;    // columns per pass
};

// Adds h[src[b .. b + n), h0 + columns] into the group's accumulators; slot
// j of lane gl holds vector j * kGroup + gl of the chunk, element e of it in
// acc[j * kVe + e]. Every lane of the warp calls it (the shuffles are
// warp-wide); a lane with n == 0 adds nothing.
template <typename T, int VB>
__device__ __forceinline__ void gather_sum(
    const T* __restrict__ h, const int32_t* __restrict__ src, int64_t b,
    int n, int h0, int H, int grp, int gl,
    typename AccOf<T>::A (&acc)[Shape<T, VB>::kLaneCols]) {
  using S = Shape<T, VB>;
  using R = typename Raw<VB>::T;
  const int n_max = __reduce_max_sync(kAll, n);
  int cur = gl < n ? src[b + gl] : -1;
  for (int p = 0; p < n_max; p += kGroup) {
    const int q = p + kGroup + gl;
    const int nxt = q < n ? src[b + q] : -1;           // in flight
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const int s = __shfl_sync(kAll, cur, grp * kGroup + k);
      if (s >= 0) {
        const R* __restrict__ row =
            reinterpret_cast<const R*>(h + (int64_t)s * H + h0);
#pragma unroll
        for (int j = 0; j < S::kSlots; ++j) {
          const int v = j * kGroup + gl;
          if (h0 + v * S::kVe < H) {
            Vec<T, VB> x;
            x.raw = __ldg(row + v);
#pragma unroll
            for (int e = 0; e < S::kVe; ++e) acc[j * S::kVe + e] += widen(x.e[e]);
          }
        }
      }
    }
    cur = nxt;
  }
}

// Output element (r, c) from the row's accumulated value: scaled, rounded
// to the out type, plus the base (rounded to bf16 first for a bf16 out).
template <typename A>
__device__ __forceinline__ void emit(A a, int64_t at, const float* scale,
                                     const float* __restrict__ base,
                                     int64_t base_at, void* out,
                                     int out_kind) {
  if (out_kind == kOutI32) {
    static_cast<int32_t*>(out)[at] = static_cast<int32_t>(a);
    return;
  }
  float v = static_cast<float>(a);
  if (scale != nullptr) v = __fmul_rn(v, *scale);
  if (out_kind == kOutBF16) {
    __nv_bfloat16 r = __float2bfloat16_rn(v);
    if (base != nullptr)
      r = __float2bfloat16_rn(
          __fadd_rn(__bfloat162float(__float2bfloat16_rn(base[base_at])),
                    __bfloat162float(r)));
    static_cast<__nv_bfloat16*>(out)[at] = r;
  } else {
    if (base != nullptr) v = __fadd_rn(base[base_at], v);
    static_cast<float*>(out)[at] = v;
  }
}

template <typename T, int VB>
__global__ void __launch_bounds__(kThreads)
ell_rows_kernel(const T* __restrict__ h,
                const int32_t* __restrict__ row_ptr,
                const int32_t* __restrict__ src,
                const int32_t* __restrict__ work, int n_rows, int n_long,
                const float* scale, const float* __restrict__ base,
                const int32_t* __restrict__ base_row, void* out,
                int out_kind, int H) {
  using S = Shape<T, VB>;
  using A = typename AccOf<T>::A;
  constexpr int C = S::kChunk;
  __shared__ A part[kWarps][C];                        // a long row's warps
  const int h0 = blockIdx.y * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane / kGroup, gl = lane % kGroup;
  A acc[S::kLaneCols];
#pragma unroll
  for (int j = 0; j < S::kLaneCols; ++j) acc[j] = A(0);

  if ((int)blockIdx.x < n_long) {                      // one long row
    const int r = work[blockIdx.x];
    const int64_t b = row_ptr[r];
    const int n = row_ptr[r + 1] - row_ptr[r];
    const int per_w = (n + kWarps - 1) / kWarps;
    const int w_lo = min(n, warp * per_w), w_hi = min(n, w_lo + per_w);
    const int per_g = (w_hi - w_lo + kRowsPerStep - 1) / kRowsPerStep;
    const int g_lo = min(w_hi, w_lo + grp * per_g);
    const int g_hi = min(w_hi, g_lo + per_g);
    gather_sum<T, VB>(h, src, b + g_lo, g_hi - g_lo, h0, H, grp, gl, acc);
#pragma unroll
    for (int j = 0; j < S::kSlots; ++j) {
#pragma unroll
      for (int e = 0; e < S::kVe; ++e) {               // (g0 + g1) + (g2 + g3)
        A& f = acc[j * S::kVe + e];
        f += __shfl_xor_sync(kAll, f, kGroup);
        f += __shfl_xor_sync(kAll, f, 2 * kGroup);
        if (grp == 0) part[warp][(j * kGroup + gl) * S::kVe + e] = f;
      }
    }
    __syncthreads();
    const int64_t br = base != nullptr ? base_row[r] : 0;
    for (int c = threadIdx.x; c < C; c += kThreads) {
      if (h0 + c < H) {
        A s = part[0][c];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) s += part[w][c];
        emit(s, (int64_t)r * H + h0 + c, scale, base, br * H + h0 + c, out,
             out_kind);
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
  gather_sum<T, VB>(h, src, b, n, h0, H, grp, gl, acc);
  if (r < 0) return;
  const int64_t br = base != nullptr ? base_row[r] : 0;
#pragma unroll
  for (int j = 0; j < S::kSlots; ++j) {
    const int v = j * kGroup + gl;
    if (h0 + v * S::kVe < H) {
#pragma unroll
      for (int e = 0; e < S::kVe; ++e) {
        const int c = h0 + v * S::kVe + e;
        emit(acc[j * S::kVe + e], (int64_t)r * H + c, scale, base,
             br * H + c, out, out_kind);
      }
    }
  }
}

template <typename T, int VB>
int launch(const void* h, const void* row_ptr, const void* src,
           const void* work, int n_rows, int n_long, const void* scale,
           const void* base, const void* base_row, void* out, int out_kind,
           int H, cudaStream_t stream) {
  constexpr int C = Shape<T, VB>::kChunk;
  const long long n_short = (long long)n_rows - n_long;
  const long long nx = n_long + (n_short + kRowsPerCta - 1) / kRowsPerCta;
  const dim3 grid((unsigned)nx, (unsigned)((H + C - 1) / C));
  ell_rows_kernel<T, VB><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(h), static_cast<const int32_t*>(row_ptr),
      static_cast<const int32_t*>(src), static_cast<const int32_t*>(work),
      n_rows, n_long, static_cast<const float*>(scale),
      static_cast<const float*>(base), static_cast<const int32_t*>(base_row),
      out, out_kind, H);
  return (int)cudaGetLastError();
}

// The widest load of `widths` (bytes, descending) that the row width and
// h's alignment allow; the last one always does.
template <typename T, int V0, int V1, int V2>
int launch_width(const void* h, const void* row_ptr, const void* src,
                 const void* work, int n_rows, int n_long, const void* scale,
                 const void* base, const void* base_row, void* out,
                 int out_kind, int H, cudaStream_t st) {
  const long long row_bytes = (long long)H * sizeof(T);
  const uintptr_t a = reinterpret_cast<uintptr_t>(h);
  if (row_bytes % V0 == 0 && a % V0 == 0)
    return launch<T, V0>(h, row_ptr, src, work, n_rows, n_long, scale, base,
                         base_row, out, out_kind, H, st);
  if (row_bytes % V1 == 0 && a % V1 == 0)
    return launch<T, V1>(h, row_ptr, src, work, n_rows, n_long, scale, base,
                         base_row, out, out_kind, H, st);
  return launch<T, V2>(h, row_ptr, src, work, n_rows, n_long, scale, base,
                       base_row, out, out_kind, H, st);
}

}  // namespace

extern "C" {

// h [n_src, H] of the row kind (0 f32, 1 bf16, 2 int8, 3 e4m3); row_ptr
// [n_rows + 1], src [nnz], work [n_rows] int32; scale: a device f32 scalar
// or null (1); base [*, H] f32 and base_row [n_rows] int32, or both null;
// out [n_rows, H] of the out kind (0 f32, 1 bf16, 2 int32); all contiguous
// on the device. Kinds taken: f32 -> f32, bf16 -> bf16, int8 -> int32
// (no scale, no base), int8 or e4m3 -> f32 or bf16. Launches on `stream`;
// returns cudaGetLastError() after the launch, -1 for bad arguments.
int bnsgcn_ell_rows(const void* h, int kind, const void* row_ptr,
                    const void* src, const void* work, int n_rows, int n_long,
                    const void* scale, const void* base, const void* base_row,
                    void* out, int out_kind, int H, void* stream) {
  const bool ok =
      (kind == kF32 && out_kind == kOutF32) ||
      (kind == kBF16 && out_kind == kOutBF16) ||
      (kind == kI8 && out_kind == kOutI32 && scale == nullptr &&
       base == nullptr) ||
      ((kind == kI8 || kind == kE4M3) &&
       (out_kind == kOutF32 || out_kind == kOutBF16));
  if (!ok || (base == nullptr) != (base_row == nullptr)) return -1;
  if (n_rows <= 0 || H <= 0) return 0;
  const auto st = reinterpret_cast<cudaStream_t>(stream);
  switch (kind) {
    case kF32:
      return launch_width<float, 16, 8, 4>(h, row_ptr, src, work, n_rows,
                                           n_long, scale, base, base_row, out,
                                           out_kind, H, st);
    case kBF16:
      return launch_width<uint16_t, 16, 4, 2>(h, row_ptr, src, work, n_rows,
                                              n_long, scale, base, base_row,
                                              out, out_kind, H, st);
    case kI8:
      return launch_width<int8_t, 16, 4, 1>(h, row_ptr, src, work, n_rows,
                                            n_long, scale, base, base_row,
                                            out, out_kind, H, st);
    default:
      return launch_width<uint8_t, 16, 4, 1>(h, row_ptr, src, work, n_rows,
                                             n_long, scale, base, base_row,
                                             out, out_kind, H, st);
  }
}

const char* bnsgcn_ell_rows_error(int code) {
  if (code == -1) return "bad arguments (row kind, out kind, scale or base)";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
