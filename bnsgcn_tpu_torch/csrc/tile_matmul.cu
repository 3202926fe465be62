// Grouped dense-tile SpMM for the hybrid SpMM's dense part, skipping zeros:
//
//     out[rb] = sum_{t : rowb[t] == rb} tiles[t] @ x_slabs[colb[t]]
//
// computed from the tiles' packed nonzero entries (ops/tile_matmul.py
// `pack_tiles`): ent holds one 32-bit word per nonzero tile entry, the column
// in the tile in its upper 24 bits and the int8 multiplicity in its low 8,
// sorted by (tile, row, column); ent_off [B, TR + 1] int32 gives row r of tile
// t the entries [ent_off[t, r], ent_off[t, r + 1]). x_slabs [n_cb, TC, H] f32,
// out [n_row_blocks, TR, H] f32. row_ptr [n_row_blocks + 1] is the CSR offset
// array over the rowb-sorted tiles: row-block rb owns tiles
// [row_ptr[rb], row_ptr[rb + 1]); pad tiles lie past the end and are never
// visited.
//
// Replaces the TPU kernel bnsgcn_tpu/ops/pallas_block.py `_kernel` /
// `pallas_tile_matmul` (wrapper `dense_apply_pallas`) for f32 slabs, run by
// `--spmm hybrid --use-pallas` forward and, on the transposed tile stack,
// backward, and at the raw feature width in the use_pp precompute. int8
// and bf16 slabs run on the tensor cores: csrc/tile_mma.cu.
//
// Why entries and not the dense tiles. The tiles are a few percent nonzero
// (58.1M entries in 8,192 tiles of 512 x 512 on the Reddit-sized graph,
// 2.7%), so a dense product of the whole tiles runs ~37x the FMAs the
// output needs; the first version of this kernel did that on the CUDA cores
// and was bound by the wasted FMAs. For f32 slabs the tensor cores do not
// pay at this density: TF32 `wgmma` would round x (the check rejects that),
// 3xTF32 would still multiply the 97% zeros at a third of the rate, and at
// ~3 nonzeros per 16 x 8 fragment almost no fragment is empty, so skipping
// empty fragments skips nothing. (For int8 and bf16 slabs, which the tensor
// cores take exactly at 30x and 15x the CUDA cores' f32 rate, the dense
// product wins: csrc/tile_mma.cu.) The zeros are skipped entry by entry: the
// work is 2 * entries * H FLOPs, and what it needs is each entry's H-wide
// row of x. Gathered from L2 or device memory that is the ELL kernel's
// random row gather; here each slab row serves ~14 output rows of the tile,
// so the slab is staged in shared memory once per tile and gathered there.
//
// Design:
//   * one CTA owns one (row-block, 512-row slice, 32-column chunk) of the
//     output and walks the row-block's tile range itself, keeping the
//     output in registers and writing it once: no atomics, a deterministic
//     sum (tiles in order, each row's entries in column order), and a
//     row-block no tile visits is written as zeros. The column chunk is the
//     fastest grid index, so the CTAs of one row-block run together and
//     share its entries and slab rows through L2;
//   * Hc = 32 columns per CTA: a staged slab chunk is TC x 32 f32 = 64 KB at
//     TC = 512; three stages, 192 KB of dynamic shared memory (of 227 KB,
//     set with cudaFuncSetAttribute), where they fit (TC <= 605), else two.
//     Hc = 64 would need 256 KB for two stages;
//   * the stages are filled with cp.async (16-, 8- or 4-byte copies as H and
//     the slab's alignment allow: H = 602 in the precompute takes 8 bytes,
//     an odd H 4; columns past H are zero-filled): the slab chunks of the
//     next one or two tiles land while the current one is gathered. One
//     barrier per tile: after it every warp is past the previous tile, so
//     the copy into that tile's stage is issued right after it;
//   * 32 warps, 1024 threads; warp w owns the slice's rows w, w + 32, ...
//     (strided, so a run of dense rows spreads over the warps), 16 of them,
//     taken 4 at a time: each group of 8 lanes owns one row, each lane 4
//     columns of it as a register accumulator, read from shared memory as
//     one float4 (a group reads 128 contiguous bytes: no bank conflicts).
//     A group loads 8 of its row's entries at once, one per lane, and
//     broadcasts each to the group with a shuffle;
//   * the next entries to add (this row's next 8, the next step's rows'
//     first 8, or the next tile's) are always in flight while the current
//     ones are added, and the next tile's row offsets are loaded before the
//     barrier that waits for its slab: latency of the per-row loads from L2
//     is what held the first, warp-per-row version back;
//   * a step lasts as long as its longest row: lanes past a shorter row's
//     end add 0 x a staged value;
//   * TR is any size (512-row slices), TC at most 908 (two stages must fit
//     in shared memory; the wrapper checks).
// What bounds it now: neither device memory nor the FLOPs (~13x its
// operations bound at full size, PERF.md); the shared-memory reads (H x 4
// bytes per entry), the instructions around each entry, the barrier per
// tile and a step's wait on its longest row share the time, and no profiler
// on the card's machine splits them yet. Build (nvcc -Xptxas -v, sm_90a):
// 63-64 registers, no spills, in each of the six instances (three copy
// widths, two or three stages).

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

template <int V>
__device__ __forceinline__ void cp_async(uint32_t dst, const float* src,
                                         bool valid) {
  const int n = valid ? 4 * V : 0;               // 0: zero-fill
  if constexpr (V == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                 :: "r"(dst), "l"(src), "r"(n) : "memory");
  } else if constexpr (V == 2) {
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

// Copy x_slabs[cb, :, h0:h0 + 32] into the stage at shared address dst
// ([TC][32] f32), V floats per copy.
template <int V>
__device__ __forceinline__ void stage_slab(uint32_t dst,
                                           const float* __restrict__ x,
                                           int cb, int TC, int H, int h0) {
  constexpr int kVecs = kHc / V;                 // copies per slab row
  const float* base = x + (int64_t)cb * TC * H;
  const int n = TC * kVecs;
  for (int v = threadIdx.x; v < n; v += kThreads) {
    const int r = v / kVecs, j = (v % kVecs) * V;
    const bool ok = h0 + j < H;                  // V | H: all or none valid
    const float* src = ok ? base + (int64_t)r * H + h0 + j : base;
    cp_async<V>(dst + (uint32_t)(r * kHc + j) * 4u, src, ok);
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

template <int V, int S>                          // S: slab stages, 2 or 3
__global__ void __launch_bounds__(kThreads, 1)
tile_spmm_kernel(const uint32_t* __restrict__ ent,
                 const int32_t* __restrict__ ent_off,
                 const int32_t* __restrict__ colb,
                 const int32_t* __restrict__ row_ptr,
                 const float* __restrict__ x, float* __restrict__ out,
                 int TR, int TC, int H, int n_chunks, int n_slices) {
  extern __shared__ __align__(16) float xs[];    // [S][TC][kHc]
  const int chunk = blockIdx.x % n_chunks;
  const int slice = (blockIdx.x / n_chunks) % n_slices;
  const int rb = blockIdx.x / (n_chunks * n_slices);
  const int h0 = chunk * kHc;
  const int r0 = slice * kSliceRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane / kGroup, gl = lane % kGroup;
  const uint32_t xs_addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(xs));
  const int stage_floats = TC * kHc;

  float acc[kSteps][kCols];
#pragma unroll
  for (int s = 0; s < kSteps; ++s)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[s][c] = 0.f;

  const int t_begin = row_ptr[rb], t_end = row_ptr[rb + 1];
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {              // the first S - 1 tiles
    if (t_begin + i < t_end)
      stage_slab<V>(xs_addr + (uint32_t)(i * stage_floats * 4), x,
                    colb[t_begin + i], TC, H, h0);
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
      stage_slab<V>(xs_addr + (uint32_t)(((it + S - 1) % S) *
                                         stage_floats * 4),
                    x, colb[t + S - 1], TC, H, h0);
    cp_async_commit();
    const float* __restrict__ xst = xs + (it % S) * stage_floats;

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
          const float m = static_cast<float>(static_cast<int8_t>(w & 0xffu));
          const float4 v = *reinterpret_cast<const float4*>(
              xst + (w >> 8) * kHc + gl * kCols);
          acc[s][0] = fmaf(m, v.x, acc[s][0]);
          acc[s][1] = fmaf(m, v.y, acc[s][1]);
          acc[s][2] = fmaf(m, v.z, acc[s][2]);
          acc[s][3] = fmaf(m, v.w, acc[s][3]);
        }
        cur = nxt;
      }
    }
  }

#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int row = r0 + warp + (s * kRowsPerStep + grp) * kWarps;
    if (row < TR) {
      float* o = out + ((int64_t)rb * TR + row) * H;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = h0 + gl * kCols + c;
        if (col < H) o[col] = acc[s][c];
      }
    }
  }
}

constexpr int stage_bytes(int TC) { return TC * kHc * (int)sizeof(float); }

template <int V, int S>
int launch(const void* ent, const void* ent_off, const void* colb,
           const void* row_ptr, const void* x, void* out, int n_row_blocks,
           int TR, int TC, int H, cudaStream_t stream) {
  const int smem = S * stage_bytes(TC);
  cudaError_t rc = cudaFuncSetAttribute(
      tile_spmm_kernel<V, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (rc != cudaSuccess) return (int)rc;
  const int n_chunks = (H + kHc - 1) / kHc;
  const int n_slices = (TR + kSliceRows - 1) / kSliceRows;
  const long long n_blocks = (long long)n_row_blocks * n_slices * n_chunks;
  tile_spmm_kernel<V, S><<<(unsigned)n_blocks, kThreads, smem, stream>>>(
      static_cast<const uint32_t*>(ent), static_cast<const int32_t*>(ent_off),
      static_cast<const int32_t*>(colb), static_cast<const int32_t*>(row_ptr),
      static_cast<const float*>(x), static_cast<float*>(out), TR, TC, H,
      n_chunks, n_slices);
  return (int)cudaGetLastError();
}

template <int V>
int launch_stages(const void* ent, const void* ent_off, const void* colb,
                  const void* row_ptr, const void* x, void* out,
                  int n_row_blocks, int TR, int TC, int H,
                  cudaStream_t stream) {
  if (3 * stage_bytes(TC) <= kMaxSmem)
    return launch<V, 3>(ent, ent_off, colb, row_ptr, x, out, n_row_blocks,
                        TR, TC, H, stream);
  return launch<V, 2>(ent, ent_off, colb, row_ptr, x, out, n_row_blocks, TR,
                      TC, H, stream);
}

}  // namespace

extern "C" {

// Shapes as in the header; TC <= 908, so that two slab stages fit in
// shared memory (the wrapper checks). Launches on `stream`; returns
// cudaGetLastError() after the launch (or the error of setting the kernel's
// shared-memory size), -1 for bad arguments.
int bnsgcn_tile_spmm_f32(const void* ent, const void* ent_off,
                         const void* colb, const void* row_ptr, const void* x,
                         void* out, int n_row_blocks, int TR, int TC, int H,
                         void* stream) {
  if (n_row_blocks <= 0 || H <= 0) return 0;
  if (TR <= 0 || TC <= 0 || 2 * stage_bytes(TC) > kMaxSmem) return -1;
  const auto s = reinterpret_cast<cudaStream_t>(stream);
  const uintptr_t a = reinterpret_cast<uintptr_t>(x);
  if (H % 4 == 0 && a % 16 == 0)
    return launch_stages<4>(ent, ent_off, colb, row_ptr, x, out, n_row_blocks,
                            TR, TC, H, s);
  if (H % 2 == 0 && a % 8 == 0)
    return launch_stages<2>(ent, ent_off, colb, row_ptr, x, out, n_row_blocks,
                            TR, TC, H, s);
  return launch_stages<1>(ent, ent_off, colb, row_ptr, x, out, n_row_blocks,
                          TR, TC, H, s);
}

const char* bnsgcn_tile_spmm_error(int code) {
  if (code == -1) return "bad arguments (tile geometry)";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
