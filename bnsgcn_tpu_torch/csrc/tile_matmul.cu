// Grouped dense-tile SpMM for the hybrid SpMM's dense part, skipping zeros:
//
//     out[rb] = sum_{t : rowb[t] == rb} tiles[t] @ x_slabs[colb[t]]
//
// computed from the tiles' packed nonzero entries (ops/tile_matmul.py
// `pack_tiles`): ent holds one 32-bit word per nonzero tile entry, the column
// in the tile in its upper 24 bits and the int8 multiplicity in its low 8,
// sorted by (tile, row, column); ent_off [B, TR + 1] int32 gives row r of tile
// t the entries [ent_off[t, r], ent_off[t, r + 1]). x_slabs [n_cb, TC, H],
// out [n_row_blocks, TR, H]. row_ptr [n_row_blocks + 1] is the CSR offset
// array over the rowb-sorted tiles: row-block rb owns tiles
// [row_ptr[rb], row_ptr[rb + 1]); pad tiles lie past the end and are never
// visited.
//
// Slab types (the `kind` argument), as the TPU kernel's branches:
//   f32 slabs  -> f32 products and sums, f32 out;
//   bf16 slabs -> the products (exact in f32) summed in f32, f32 out;
//   int8 slabs -> int8 x int8 products summed in int32, exact; out the raw
//                 int32 accumulators (the caller owns the one per-call
//                 scale), or, given a per-slab scale array [n_cb] f32, each
//                 tile's int32 sum as f32 times its slab's scale, summed over
//                 the row-block's tiles in tile order in f32, f32 out (the
//                 JAX package's `_dense_apply` int8 formulation, the route of
//                 a layout whose int32 row sums could overflow).
//
// Replaces the TPU kernel bnsgcn_tpu/ops/pallas_block.py `_kernel` /
// `pallas_tile_matmul` (wrapper `dense_apply_pallas`), run by
// `--spmm hybrid --use-pallas` forward and, on the transposed tile stack,
// backward, and at the raw feature width in the use_pp precompute; with
// per-slab scales, bnsgcn_tpu/ops/block_spmm.py `_dense_apply`'s int8 path.
//
// Why entries and not the dense tiles. The tiles are a few percent nonzero
// (58.1M entries in 8,192 tiles of 512 x 512 on the Reddit-sized graph,
// 2.7%), so a dense product of the whole tiles runs ~37x the FMAs the
// output needs; the first version of this kernel did that on the CUDA cores
// and was bound by the wasted FMAs. Tensor cores do not pay at this
// density: at ~3 nonzeros per 16 x 8 fragment almost no fragment is empty,
// so skipping empty fragments skips nothing, and bf16 or int8 `mma` would
// still multiply the 97% zeros. The zeros are skipped entry by entry: the
// work is 2 * entries * H operations, and what it needs is each entry's
// H-wide row of x. Gathered from L2 or device memory that is the ELL
// kernel's random row gather; here each slab row serves ~14 output rows of
// the tile, so the slab is staged in shared memory once per tile and
// gathered there.
//
// Design:
//   * one CTA owns one (row-block, 512-row slice, 32-column chunk) of the
//     output and walks the row-block's tile range itself, keeping the
//     output in registers and writing it once: no atomics, a deterministic
//     sum (tiles in order, each row's entries in column order), and a
//     row-block no tile visits is written as zeros. The column chunk is the
//     fastest grid index, so the CTAs of one row-block run together and
//     share its entries and slab rows through L2;
//   * Hc = 32 columns per CTA: a staged slab chunk is TC x 32 elements,
//     64 KB at TC = 512 in f32 (32 KB bf16, 16 KB int8); three stages of
//     dynamic shared memory (of 227 KB, set with cudaFuncSetAttribute)
//     where they fit, else two (f32 only; the wrapper caps TC);
//   * the stages are filled with cp.async (16-, 8- or 4-byte copies as the
//     row's bytes and the slab's alignment allow: f32 H = 602 in the
//     precompute takes 8 bytes, bf16 H = 602 4; columns past H are
//     zero-filled): the slab chunks of the next one or two tiles land while
//     the current one is gathered. One barrier per tile: after it every
//     warp is past the previous tile, so the copy into that tile's stage is
//     issued right after it;
//   * 32 warps, 1024 threads; warp w owns the slice's rows w, w + 32, ...
//     (strided, so a run of dense rows spreads over the warps), 16 of them,
//     taken 4 at a time: each group of 8 lanes owns one row, each lane 4
//     columns of it as a register accumulator, read from shared memory as
//     one 16-, 8- or 4-byte vector (a group reads one contiguous run: no
//     bank conflicts) and widened in the load (bf16 -> f32 by a shift, int8
//     -> int32). A group loads 8 of its row's entries at once, one per lane,
//     and broadcasts each to the group with a shuffle;
//   * the next entries to add (this row's next 8, the next step's rows'
//     first 8, or the next tile's) are always in flight while the current
//     ones are added, and the next tile's row offsets are loaded before the
//     barrier that waits for its slab;
//   * a step lasts as long as its longest row: lanes past a shorter row's
//     end add 0 x a staged value;
//   * TR is any size (512-row slices), TC as the stages allow (the wrapper
//     checks); the per-slab mode keeps a tile's int32 sums beside the f32
//     totals, twice the accumulator registers.
// What bounds it: neither device memory nor the operations (~13x its
// operations bound at full size in f32, PERF.md); the shared-memory reads,
// the instructions around each entry, the barrier per tile and a step's
// wait on its longest row share the time, and no profiler on the card's
// machine splits them yet.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHc = 32;                          // output columns per CTA
constexpr int kWarps = 32;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 16;
constexpr int kSliceRows = kWarps * kRowsPerWarp;  // 512
constexpr int kMaxSmem = 232448;                 // per-block opt-in limit
constexpr int kGroup = 8;                        // lanes per row
constexpr int kRowsPerStep = 32 / kGroup;        // 4
constexpr int kCols = kHc / kGroup;              // 4 columns per lane
constexpr int kSteps = kRowsPerWarp / kRowsPerStep;

enum { kF32 = 0, kBF16 = 1, kI8 = 2 };

template <int CB>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         bool valid) {
  const int n = valid ? CB : 0;                  // 0: zero-fill
  if constexpr (CB == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                 :: "r"(dst), "l"(src), "r"(n) : "memory");
  } else if constexpr (CB == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;"
                 :: "r"(dst), "l"(src), "r"(n) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
                 :: "r"(dst), "l"(src), "r"(n) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// Slab element types: float, uint16_t (bf16 bits), int8_t. Four staged
// elements of a lane, widened: f32 for float slabs, int32 for int8.
template <typename T> struct Acc { using A = float; };
template <> struct Acc<int8_t> { using A = int; };

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
__device__ __forceinline__ void load4(const uint16_t* p, float (&v)[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(x.x << 16);
  v[1] = __uint_as_float(x.x & 0xffff0000u);
  v[2] = __uint_as_float(x.y << 16);
  v[3] = __uint_as_float(x.y & 0xffff0000u);
}
__device__ __forceinline__ void load4(const int8_t* p, int (&v)[4]) {
  const unsigned x = *reinterpret_cast<const unsigned*>(p);
  v[0] = static_cast<int8_t>(x & 0xffu);
  v[1] = static_cast<int8_t>((x >> 8) & 0xffu);
  v[2] = static_cast<int8_t>((x >> 16) & 0xffu);
  v[3] = static_cast<int8_t>(x >> 24);
}

__device__ __forceinline__ void madd(float& a, int m, float v) {
  a = fmaf(static_cast<float>(m), v, a);
}
__device__ __forceinline__ void madd(int& a, int m, int v) { a += m * v; }

// Copy x_slabs[cb, :, h0:h0 + 32] into the stage at shared address dst
// ([TC][32] elements of T), CB bytes per copy.
template <typename T, int CB>
__device__ __forceinline__ void stage_slab(uint32_t dst,
                                           const T* __restrict__ x, int cb,
                                           int TC, int H, int h0) {
  constexpr int kPer = CB / (int)sizeof(T);      // elements per copy
  constexpr int kCopies = kHc / kPer;            // copies per slab row
  const T* base = x + (int64_t)cb * TC * H;
  const int n = TC * kCopies;
  for (int v = threadIdx.x; v < n; v += kThreads) {
    const int r = v / kCopies, j = (v % kCopies) * kPer;
    const bool ok = h0 + j < H;                  // kPer | H: all or none
    const T* src = ok ? base + (int64_t)r * H + h0 + j : base;
    cp_async<CB>(dst + (uint32_t)((r * kHc + j) * sizeof(T)), src, ok);
  }
}

// Lane i < 16: the entry range [ob, oe) of the warp's i-th row in tile t
// (t < 0: none).
__device__ __forceinline__ void load_offsets(
    const int32_t* __restrict__ ent_off, int t, int TR, int r0, int warp,
    int lane, int& ob, int& oe) {
  ob = oe = 0;
  if (t >= 0 && lane < kRowsPerWarp) {
    const int row = r0 + warp + lane * kWarps;
    if (row < TR) {
      const int32_t* off = ent_off + (int64_t)t * (TR + 1) + row;
      ob = off[0];
      oe = off[1];
    }
  }
}

// Entry b + p + gl of a row [b, b + n), one per lane of the group (0 past
// the row's end: column 0, multiplicity 0).
__device__ __forceinline__ uint32_t load_entries(
    const uint32_t* __restrict__ ent, int b, int n, int p, int gl) {
  return p + gl < n ? ent[b + p + gl] : 0u;
}

// T: slab element; CB: copy bytes; S: slab stages (2 or 3); SLAB: per-slab
// scales (int8 only): a tile's int32 sums are scaled into f32 totals.
template <typename T, int CB, int S, bool SLAB>
__global__ void __launch_bounds__(kThreads, 1)
tile_spmm_kernel(const uint32_t* __restrict__ ent,
                 const int32_t* __restrict__ ent_off,
                 const int32_t* __restrict__ colb,
                 const int32_t* __restrict__ row_ptr,
                 const T* __restrict__ x,
                 const float* __restrict__ slab_scale, void* out, int TR,
                 int TC, int H, int n_chunks, int n_slices) {
  using A = typename Acc<T>::A;
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);            // [S][TC][kHc]
  const int chunk = blockIdx.x % n_chunks;
  const int slice = (blockIdx.x / n_chunks) % n_slices;
  const int rb = blockIdx.x / (n_chunks * n_slices);
  const int h0 = chunk * kHc;
  const int r0 = slice * kSliceRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane / kGroup, gl = lane % kGroup;
  const uint32_t xs_addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(xs));
  const int stage_elems = TC * kHc;

  A acc[kSteps][kCols];
  float tot[SLAB ? kSteps : 1][SLAB ? kCols : 1];
#pragma unroll
  for (int s = 0; s < kSteps; ++s)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[s][c] = A(0);
  if constexpr (SLAB) {
#pragma unroll
    for (int s = 0; s < kSteps; ++s)
#pragma unroll
      for (int c = 0; c < kCols; ++c) tot[s][c] = 0.f;
  }

  const int t_begin = row_ptr[rb], t_end = row_ptr[rb + 1];
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {              // the first S - 1 tiles
    if (t_begin + i < t_end)
      stage_slab<T, CB>(xs_addr + (uint32_t)(i * stage_elems * sizeof(T)),
                        x, colb[t_begin + i], TC, H, h0);
    cp_async_commit();
  }
  // (ob, oe): the current tile's row offsets, (ob2, oe2) the next tile's;
  // (bn, nn) the next row range to add, `cur` its first entries
  int ob = 0, oe = 0, ob2, oe2;
  load_offsets(ent_off, t_begin < t_end ? t_begin : -1, TR, r0, warp, lane,
               ob2, oe2);
  int bn = __shfl_sync(0xffffffffu, ob2, grp);
  int nn = __shfl_sync(0xffffffffu, oe2, grp) - bn;
  uint32_t cur = load_entries(ent, bn, nn, 0, gl);

  for (int t = t_begin; t < t_end; ++t) {
    const int it = t - t_begin;
    ob = ob2;
    oe = oe2;
    load_offsets(ent_off, t + 1 < t_end ? t + 1 : -1, TR, r0, warp, lane,
                 ob2, oe2);
    cp_async_wait<S - 2>();                      // this thread's copies of t
    __syncthreads();                             // ... and every thread's;
                                                 // all are past tile t - 1
    if (t + S - 1 < t_end)                       // into t - 1's stage
      stage_slab<T, CB>(
          xs_addr + (uint32_t)(((it + S - 1) % S) * stage_elems * sizeof(T)),
          x, colb[t + S - 1], TC, H, h0);
    cp_async_commit();
    const T* __restrict__ xst = xs + (it % S) * stage_elems;

#pragma unroll
    for (int s = 0; s < kSteps; ++s) {           // 4 rows of the warp
      const int b = bn, n = nn;
      if (s + 1 < kSteps) {
        bn = __shfl_sync(0xffffffffu, ob, (s + 1) * kRowsPerStep + grp);
        nn = __shfl_sync(0xffffffffu, oe, (s + 1) * kRowsPerStep + grp) - bn;
      } else {                                   // the next tile's first
        bn = __shfl_sync(0xffffffffu, ob2, grp);
        nn = __shfl_sync(0xffffffffu, oe2, grp) - bn;
      }
      const int n_max = __reduce_max_sync(0xffffffffu, n);
      if (n_max == 0) cur = load_entries(ent, bn, nn, 0, gl);
      for (int p = 0; p < n_max; p += kGroup) {
        const uint32_t nxt = p + kGroup < n_max
                                 ? load_entries(ent, b, n, p + kGroup, gl)
                                 : load_entries(ent, bn, nn, 0, gl);
        const int cnt = min(kGroup, n_max - p);
#pragma unroll 4
        for (int k = 0; k < cnt; ++k) {
          const uint32_t w = __shfl_sync(0xffffffffu, cur, grp * kGroup + k);
          const int m = static_cast<int8_t>(w & 0xffu);
          A v[kCols];
          load4(xst + (w >> 8) * kHc + gl * kCols, v);
#pragma unroll
          for (int c = 0; c < kCols; ++c) madd(acc[s][c], m, v[c]);
        }
        cur = nxt;
      }
    }
    if constexpr (SLAB) {                        // this tile's sums, scaled
      const float sc = slab_scale[colb[t]];
#pragma unroll
      for (int s = 0; s < kSteps; ++s)
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          tot[s][c] = __fadd_rn(
              tot[s][c], __fmul_rn(__int2float_rn(acc[s][c]), sc));
          acc[s][c] = 0;
        }
    }
  }

#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int row = r0 + warp + (s * kRowsPerStep + grp) * kWarps;
    if (row < TR) {
      const int64_t o = ((int64_t)rb * TR + row) * H;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = h0 + gl * kCols + c;
        if (col < H) {
          if constexpr (SLAB)
            static_cast<float*>(out)[o + col] = tot[s][c];
          else
            static_cast<A*>(out)[o + col] = acc[s][c];
        }
      }
    }
  }
}

template <typename T>
constexpr int stage_bytes(int TC) { return TC * kHc * (int)sizeof(T); }

template <typename T, int CB, int S, bool SLAB>
int launch(const void* ent, const void* ent_off, const void* colb,
           const void* row_ptr, const void* x, const void* slab_scale,
           void* out, int n_row_blocks, int TR, int TC, int H,
           cudaStream_t stream) {
  const int smem = S * stage_bytes<T>(TC);
  cudaError_t rc = cudaFuncSetAttribute(
      tile_spmm_kernel<T, CB, S, SLAB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return (int)rc;
  const int n_chunks = (H + kHc - 1) / kHc;
  const int n_slices = (TR + kSliceRows - 1) / kSliceRows;
  const long long n_blocks = (long long)n_row_blocks * n_slices * n_chunks;
  tile_spmm_kernel<T, CB, S, SLAB>
      <<<(unsigned)n_blocks, kThreads, smem, stream>>>(
          static_cast<const uint32_t*>(ent),
          static_cast<const int32_t*>(ent_off),
          static_cast<const int32_t*>(colb),
          static_cast<const int32_t*>(row_ptr), static_cast<const T*>(x),
          static_cast<const float*>(slab_scale), out, TR, TC, H, n_chunks,
          n_slices);
  return (int)cudaGetLastError();
}

// f32 slabs: three stages where they fit, else two. bf16 and int8 slabs:
// three (the wrapper caps TC so that they fit).
template <typename T, int CB, bool SLAB>
int launch_stages(const void* ent, const void* ent_off, const void* colb,
                  const void* row_ptr, const void* x, const void* slab_scale,
                  void* out, int n_row_blocks, int TR, int TC, int H,
                  cudaStream_t s) {
  if (sizeof(T) < 4 || 3 * stage_bytes<T>(TC) <= kMaxSmem)
    return launch<T, CB, 3, SLAB>(ent, ent_off, colb, row_ptr, x, slab_scale,
                                  out, n_row_blocks, TR, TC, H, s);
  return launch<T, CB, 2, SLAB>(ent, ent_off, colb, row_ptr, x, slab_scale,
                                out, n_row_blocks, TR, TC, H, s);
}

template <typename T, bool SLAB>
int launch_copy(const void* ent, const void* ent_off, const void* colb,
                const void* row_ptr, const void* x, const void* slab_scale,
                void* out, int n_row_blocks, int TR, int TC, int H,
                cudaStream_t s) {
  const long long row_bytes = (long long)H * sizeof(T);
  const uintptr_t a = reinterpret_cast<uintptr_t>(x);
  if (row_bytes % 16 == 0 && a % 16 == 0)
    return launch_stages<T, 16, SLAB>(ent, ent_off, colb, row_ptr, x,
                                      slab_scale, out, n_row_blocks, TR, TC,
                                      H, s);
  if (row_bytes % 8 == 0 && a % 8 == 0)
    return launch_stages<T, 8, SLAB>(ent, ent_off, colb, row_ptr, x,
                                     slab_scale, out, n_row_blocks, TR, TC,
                                     H, s);
  return launch_stages<T, 4, SLAB>(ent, ent_off, colb, row_ptr, x,
                                   slab_scale, out, n_row_blocks, TR, TC, H,
                                   s);
}

}  // namespace

extern "C" {

// Shapes as in the header. kind: 0 f32 slabs, 1 bf16, 2 int8 (out int32,
// or f32 with slab_scale [n_cb] f32; slab_scale must be null otherwise);
// out f32 except for int8 without slab_scale. The slab row's bytes must be
// a multiple of 4 and the stages must fit in shared memory (three for bf16
// and int8, at least two for f32; the wrapper checks). Launches on
// `stream`; returns cudaGetLastError() after the launch (or the error of
// setting the kernel's shared-memory size), -1 for bad arguments.
int bnsgcn_tile_spmm(const void* ent, const void* ent_off, const void* colb,
                     const void* row_ptr, const void* x, int kind,
                     const void* slab_scale, void* out, int n_row_blocks,
                     int TR, int TC, int H, void* stream) {
  if (n_row_blocks <= 0 || H <= 0) return 0;
  if (TR <= 0 || TC <= 0 || kind < kF32 || kind > kI8) return -1;
  if (slab_scale != nullptr && kind != kI8) return -1;
  const int esize = kind == kF32 ? 4 : kind == kBF16 ? 2 : 1;
  const int stages = kind == kF32 ? 2 : 3;
  if (((long long)H * esize) % 4 != 0 ||
      stages * TC * kHc * esize > kMaxSmem)
    return -1;
  const auto s = reinterpret_cast<cudaStream_t>(stream);
  if (kind == kF32)
    return launch_copy<float, false>(ent, ent_off, colb, row_ptr, x, nullptr,
                                     out, n_row_blocks, TR, TC, H, s);
  if (kind == kBF16)
    return launch_copy<uint16_t, false>(ent, ent_off, colb, row_ptr, x,
                                        nullptr, out, n_row_blocks, TR, TC,
                                        H, s);
  if (slab_scale != nullptr)
    return launch_copy<int8_t, true>(ent, ent_off, colb, row_ptr, x,
                                     slab_scale, out, n_row_blocks, TR, TC,
                                     H, s);
  return launch_copy<int8_t, false>(ent, ent_off, colb, row_ptr, x, nullptr,
                                    out, n_row_blocks, TR, TC, H, s);
}

const char* bnsgcn_tile_spmm_error(int code) {
  if (code == -1) return "bad arguments (slab kind, scale or tile geometry)";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
