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
//     kChunkBytes of each row (32 f32, 64 bf16 or 128 int8/e4m3 columns), so
//     the CTAs resident at any time gather from the same n_src x 128-byte
//     slice of h (30 MB at full size, inside the L2). The indices are read
//     again for every chunk;
//   * a group of 8 lanes per row, each lane 16 bytes of the chunk as
//     accumulators, read as one 16-byte vector where the row width and the
//     pointer allow it (else 8 (f32), 4, 2 (bf16) or 1 byte per load) and
//     converted to the accumulator type in the load (bf16 -> f32 by a
//     shift; int8 and e4m3 at narrower loads element by element): 4 rows
//     per warp step, 32 rows per 256-thread CTA. A group reads its row's
//     indices 8 at a time, coalesced, one per lane, and broadcasts each by
//     shuffle; the next 8 are in flight meanwhile. A warp step lasts as
//     long as its longest row; lanes past a shorter row's end load nothing;
//   * int8, e4m3 and bf16 rows at 16-byte loads have their own routine
//     (gather_batched): widening element by element cost ~49 (int8), ~89
//     (e4m3) and ~39 (bf16) instructions per 16-byte vector against f32's
//     ~20, and the instruction rate, not the gather, set their time. The
//     group loads 4 terms at a time, with no branch per term, before any
//     add; int8 turns the lane's 4 words of the 4 terms into 4 words of one
//     column each by a byte transpose (8 permutes) and adds each column's 4
//     terms with one dp4a (exact); e4m3 converts two bytes per instruction
//     (cvt.rn.f16x2.e4m3x2), bf16 widens a word's two values by one shift
//     and one mask, and both add in f32 in term order, the order of the
//     element-wise path, whose bits they give. A short row's lane (16
//     columns of 1-byte rows, 8 of bf16) leaves with the base read and the
//     output written 16 bytes at a time (emit_vec). bf16 rows of a width
//     that is not a multiple of 8 (the use_pp precompute at F=602: 1,204-
//     byte rows, 4-byte loads) keep the element-wise path (gather_sum, emit);
//   * long rows (more than the wrapper's threshold of terms) get a CTA of
//     their own, dispatched first: its 8 warps sum fixed contiguous slices
//     of the row (each warp's 4 groups a quarter of its slice), reduce the
//     groups by shuffles in a fixed tree and the warps in shared memory in
//     warp order;
//   * each output element is written once, base included: no atomics, no
//     zero-fill, and two calls give the same bits.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
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
  static constexpr int kChunk = kChunkBytes / (int)sizeof(T);  // per pass
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

// The byte mask of the first m of 4 terms: dp4a's second operand.
__device__ __forceinline__ int term_mask(int m) {
  return m >= 4 ? 0x01010101 : (int)(0x01010101u & ((1u << (8 * m)) - 1u));
}

__device__ __forceinline__ unsigned word(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// int8: adds the first m of the 4 terms x[0..3] (16 columns each) into the
// column accumulators. Word j of the 4 terms, [a b c d], is transposed into
// 4 words of one column each, [a_i b_i c_i d_i], and dp4a adds a word's 4
// bytes, each times its term's mask byte (0 past the row's end, where x
// holds stale bytes), to the column's int32 sum: exact.
__device__ __forceinline__ void add_terms(const uint4 (&x)[4], int m,
                                          int (&acc)[16]) {
  const int mask = term_mask(m);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned ab_lo = __byte_perm(word(x[0], j), word(x[1], j), 0x5140);
    const unsigned ab_hi = __byte_perm(word(x[0], j), word(x[1], j), 0x7362);
    const unsigned cd_lo = __byte_perm(word(x[2], j), word(x[3], j), 0x5140);
    const unsigned cd_hi = __byte_perm(word(x[2], j), word(x[3], j), 0x7362);
    int* a = &acc[4 * j];
    a[0] = __dp4a((int)__byte_perm(ab_lo, cd_lo, 0x5410), mask, a[0]);
    a[1] = __dp4a((int)__byte_perm(ab_lo, cd_lo, 0x7632), mask, a[1]);
    a[2] = __dp4a((int)__byte_perm(ab_hi, cd_hi, 0x5410), mask, a[2]);
    a[3] = __dp4a((int)__byte_perm(ab_hi, cd_hi, 0x7632), mask, a[3]);
  }
}

// e4m3: adds one term's 16 columns into the f32 accumulators, two bytes
// per conversion (e4m3x2 -> f16x2, exact), then f16 -> f32 and the add.
__device__ __forceinline__ void add_e4m3(const uint4& x, float (&acc)[16]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned w = word(x, j);
    const float2 lo = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(
        (__nv_fp8x2_storage_t)(w & 0xffffu), __NV_E4M3)));
    const float2 hi = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(
        (__nv_fp8x2_storage_t)(w >> 16), __NV_E4M3)));
    acc[4 * j] += lo.x;
    acc[4 * j + 1] += lo.y;
    acc[4 * j + 2] += hi.x;
    acc[4 * j + 3] += hi.y;
  }
}

// e4m3: adds the first m of the 4 terms, in term order.
__device__ __forceinline__ void add_terms(const uint4 (&x)[4], int m,
                                          float (&acc)[16]) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (k < m) add_e4m3(x[k], acc);
}

// bf16: adds the first m of the 4 terms x[0..3] (8 columns each) into the
// f32 accumulators, in term order (gather_sum's, so the sums are its bits).
// A word holds two columns; each widens to f32 by one bit operation.
__device__ __forceinline__ void add_terms(const uint4 (&x)[4], int m,
                                          float (&acc)[8]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (k < m) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned w = word(x[k], j);
        acc[2 * j] += __uint_as_float(w << 16);
        acc[2 * j + 1] += __uint_as_float(w & 0xffff0000u);
      }
    }
  }
}

// gather_sum for int8 (T = int8_t), e4m3 (uint8_t) and bf16 (uint16_t)
// rows at 16-byte loads: the lane's 16 bytes of 4 terms at a time, their
// loads in flight together before any add, each address one wide
// multiply-add from the lane's slice of h; add_terms sums them by type.
template <typename T>
__device__ __forceinline__ void gather_batched(
    const T* __restrict__ h, const int32_t* __restrict__ src, int64_t b,
    int n, int h0, int H, int grp, int gl,
    typename AccOf<T>::A (&acc)[kLaneBytes / sizeof(T)]) {
  constexpr int L = kLaneBytes / (int)sizeof(T);
  const int n_max = __reduce_max_sync(kAll, n);
  int cur = gl < n ? src[b + gl] : -1;
  const bool cols = h0 + gl * L < H;
  const unsigned row_bytes = (unsigned)H * (unsigned)sizeof(T);
  const unsigned char* __restrict__ hb =
      reinterpret_cast<const unsigned char*>(h + h0 + gl * L);
  uint4 x[4] = {};
  for (int p = 0; p < n_max; p += kGroup) {
    const int q = p + kGroup + gl;
    const int nxt = q < n ? src[b + q] : -1;           // in flight
#pragma unroll
    for (int k0 = 0; k0 < kGroup; k0 += 4) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int s = __shfl_sync(kAll, cur, grp * kGroup + k0 + k);
        if (s >= 0 && cols)
          x[k] = __ldg(reinterpret_cast<const uint4*>(
              hb + (size_t)(unsigned)s * row_bytes));
      }
      add_terms(x, min(max(n - p - k0, 0), 4), acc);
    }
    cur = nxt;
  }
}

template <typename T, int VB>
__device__ __forceinline__ void gather(
    const T* __restrict__ h, const int32_t* __restrict__ src, int64_t b,
    int n, int h0, int H, int grp, int gl,
    typename AccOf<T>::A (&acc)[Shape<T, VB>::kLaneCols]) {
  if constexpr (sizeof(T) <= 2 && VB == 16)
    gather_batched<T>(h, src, b, n, h0, H, grp, gl, acc);
  else
    gather_sum<T, VB>(h, src, b, n, h0, H, grp, gl, acc);
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

// emit for a lane's N consecutive columns from at (N = 16 for 1-byte
// rows, 8 for bf16; at a multiple of N in a row of a multiple of N
// columns, out and base 16-byte aligned): the same values, 8 columns at a
// time, with the base read as two float4 and the output written 16 bytes
// at a time.
template <int N, typename A>
__device__ __forceinline__ void emit_vec(const A (&acc)[N], int64_t at,
                                         const float* scale,
                                         const float* __restrict__ base,
                                         int64_t base_at, void* out,
                                         int out_kind) {
#pragma unroll
  for (int c0 = 0; c0 < N; c0 += 8) {
    if (out_kind == kOutI32) {
      int4* o = reinterpret_cast<int4*>(static_cast<int32_t*>(out) + at + c0);
      o[0] = make_int4((int)acc[c0], (int)acc[c0 + 1], (int)acc[c0 + 2],
                       (int)acc[c0 + 3]);
      o[1] = make_int4((int)acc[c0 + 4], (int)acc[c0 + 5], (int)acc[c0 + 6],
                       (int)acc[c0 + 7]);
      continue;
    }
    float v[8], bv[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      v[e] = static_cast<float>(acc[c0 + e]);
      if (scale != nullptr) v[e] = __fmul_rn(v[e], *scale);
    }
    if (base != nullptr) {
      const float4* bp = reinterpret_cast<const float4*>(base + base_at + c0);
      const float4 lo = __ldg(bp), hi = __ldg(bp + 1);
      bv[0] = lo.x; bv[1] = lo.y; bv[2] = lo.z; bv[3] = lo.w;
      bv[4] = hi.x; bv[5] = hi.y; bv[6] = hi.z; bv[7] = hi.w;
    }
    if (out_kind == kOutBF16) {
      unsigned pk[4];
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        unsigned short r[2];
#pragma unroll
        for (int d = 0; d < 2; ++d) {
          __nv_bfloat16 t = __float2bfloat16_rn(v[e + d]);
          if (base != nullptr)
            t = __float2bfloat16_rn(__fadd_rn(
                __bfloat162float(__float2bfloat16_rn(bv[e + d])),
                __bfloat162float(t)));
          r[d] = __bfloat16_as_ushort(t);
        }
        pk[e / 2] = (unsigned)r[0] | ((unsigned)r[1] << 16);
      }
      *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out) + at + c0) =
          make_uint4(pk[0], pk[1], pk[2], pk[3]);
    } else {
      if (base != nullptr) {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = __fadd_rn(bv[e], v[e]);
      }
      float4* o = reinterpret_cast<float4*>(static_cast<float*>(out) + at + c0);
      o[0] = make_float4(v[0], v[1], v[2], v[3]);
      o[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
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
    gather<T, VB>(h, src, b + g_lo, g_hi - g_lo, h0, H, grp, gl, acc);
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
  gather<T, VB>(h, src, b, n, h0, H, grp, gl, acc);
  if (r < 0) return;
  const int64_t br = base != nullptr ? base_row[r] : 0;
  if constexpr (sizeof(T) <= 2 && VB == 16) {
    const int c = h0 + gl * S::kLaneCols;
    if (c < H && ((reinterpret_cast<uintptr_t>(out) |
                   reinterpret_cast<uintptr_t>(base)) & 15) == 0) {
      emit_vec(acc, (int64_t)r * H + c, scale, base, br * H + c, out,
               out_kind);
      return;
    }
  }
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
