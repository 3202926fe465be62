// K2 on the tensor cores: the grouped dense-tile matmul of the hybrid SpMM
// for int8 and bf16 slabs,
//
//     out[rb] = sum_{t in [row_ptr[rb], row_ptr[rb + 1])}
//                   tiles[t] (TR x TC int8) @ x_slabs[colb[t]]^T
//
// a grouped GEMM: row-block rb's K dimension is TC times its tile count,
// gathered through colb. tiles [B, TR, TC] int8, sorted by row-block (pad
// tiles lie past row_ptr[n_row_blocks] and are never visited); x_slabs
// [n_cb, H, TC] int8 or bf16, each slab K-major (wgmma reads int8 only so;
// ops/tile_matmul.py `k_major`); out [n_row_blocks, TR, H]; order
// [n_row_blocks] the row-blocks in the order the CTAs take them (most
// tiles first: ops/tile_matmul.py `work_order`).
//
// Slab types (the `kind` argument), as the TPU kernel's branches:
//   int8 slabs -> wgmma s8 x s8 -> s32, exact; out the raw int32 sums (the
//                 caller owns the one per-call scale), or, given slab_scale
//                 [n_cb] f32, each tile's int32 sums as f32 times its slab's
//                 scale, added to f32 totals in tile order (__fmul_rn,
//                 __fadd_rn: bitwise the plain version), f32 out;
//   bf16 slabs -> wgmma bf16 x bf16 -> f32, the int8 tiles converted to
//                 bf16 in shared memory (exact), f32 out.
//
// Replaces the TPU kernel bnsgcn_tpu/ops/pallas_block.py `_kernel` /
// `pallas_tile_matmul` (wrapper `dense_apply_pallas`) for int8 and bf16
// slabs, run by `--spmm-dense int8` and `--dtype bfloat16` forward and, on
// the transposed tile stack, backward, and in the use_pp precompute; with
// per-slab scales, bnsgcn_tpu/ops/block_spmm.py `_dense_apply`'s int8 path.
// It is the TPU kernel's own formulation: a tile [TR, TC] times its slab on
// the matrix unit. f32 slabs stay on csrc/tile_matmul.cu, which skips the
// zeros on the CUDA cores (the tensor cores would take f32 as TF32).
//
// What bounds it. At the Reddit-sized layout (8,192 tiles of 512 x 512,
// H = 256) a dense product of the whole stack is 2 * 8192 * 512 * 512 * 256
// = 1.0995e12 operations: 0.56 ms at 1,979 TOPS int8, 1.11 ms at 989
// TFLOP/s bf16. The tile stack is 2.147 GB, read once per pass: with the
// slabs and the output 0.73 ms at 3.35 TB/s. So int8 is bound by the tile
// bytes, bf16 by the operations. The tiles are 2.7% nonzero, but at ~3
// nonzeros per 16 x 32 fragment almost no fragment is empty: the dense
// product on the tensor cores beats skipping zeros one by one on the CUDA
// cores (37x fewer operations at 1/30 the rate).
//
// Design:
//   * one CTA of two warpgroups owns (row-block, a 128-row slice of TR, a
//     BN-column chunk of H) and walks the row-block's tiles in order, the
//     sum in registers, written once: no atomics, a fixed order of
//     summation, and a row-block no tile visits is written as zeros.
//     BN = 256 where H pads no further to 256 than to 128 (the main path's
//     H = 256: each tile byte is read from device memory once), else 128,
//     and 128 in the per-slab mode, whose f32 totals take as many
//     registers again. The chunk and the slice are the fastest grid
//     indices, so the CTAs of one row-block run together and share its
//     slabs through L2;
//   * the K loop runs over (tile, piece of KB tile columns), KB = 128 for
//     int8 slabs and 64 for bf16 (128 bytes of a slab row either way): each
//     step stages A = tiles[t][rows, piece] (128 x KB bytes) and B =
//     x_slabs[colb[t]][chunk, piece] (BN rows of 128 bytes) by TMA, one
//     thread issuing both boxes onto the stage's mbarrier, into a ring of 4
//     stages (128-192 KB of dynamic shared memory), 2 steps ahead of the
//     one computed and one for the wgmmas still reading the step before;
//     one barrier per step. Rows past TR or H in a box are the next tile's
//     or slab's (or zeros past the end): they reach only outputs that are
//     not stored; columns past TC are zeros. Where TC or a base does not
//     allow TMA's 16-byte strides, cp.async stages the same layout (16-,
//     4- or 1-byte copies, zero-filled past TR, H and TC): no geometry is
//     refused;
//   * operands K-major in the 128-byte swizzle that wgmma reads (16-byte
//     chunk c of row r at c ^ (r & 7)). bf16: each warpgroup converts its
//     64 rows of the step's int8 A (staged in plain 64-byte rows) into a
//     bf16 buffer of that layout (double-buffered), 2 values per 4
//     instructions: a byte permute puts the low 7 bits under a biased
//     exponent (0x43mm = 128 + m), a second the sign bit (0x4300 or 0x4380
//     = 128 or 256), and one packed bf16 subtract of the two is the value,
//     exactly;
//   * warpgroup w multiplies rows 64w..64w+63: per step 4 wgmma m64nBNk32
//     (int8) or m64nBNk16 (bf16) from shared-memory descriptors, committed
//     as one group; the group of the step before is waited for only after
//     this one is issued, so the tensor cores always have a step queued.
//
// What holds it back (PERF.md): at H = 256 a build without the wgmmas took
// as long as the whole kernel, so the staging of tiles and slabs sets the
// time, not the tensor cores.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBM = 128;                 // output rows per CTA
constexpr int kRowBytes = 128;           // bytes of k per staged slab row
constexpr int kStages = 4;
constexpr int kAhead = kStages - 2;      // steps staged ahead of the one
                                         // computed
constexpr int kThreads = 256;            // two warpgroups

enum { kI8 = 0, kBF16 = 1 };

template <int CB>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int n) {
  if constexpr (CB == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
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

// Stage one 16-byte chunk: the first n (0..16) bytes at src, zeros after.
// mode 16: one 16-byte copy (n is 0 or 16); 4: four 4-byte copies (n a
// multiple of 4); 1: bytes, loaded and stored by this thread. `safe` is an
// address that may be named for a copy of 0 bytes.
__device__ __forceinline__ void stage_chunk(uint32_t dst, const char* src,
                                            int n, int mode,
                                            const char* safe) {
  if (mode == 16) {
    cp_async<16>(dst, n ? src : safe, n);
  } else if (mode == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool ok = 4 * i < n;
      cp_async<4>(dst + 4 * i, ok ? src + 4 * i : safe, ok ? 4 : 0);
    }
  } else {
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int b = 0; b < 16; ++b)
      if (b < n)
        w[b >> 2] |= static_cast<uint32_t>(
                         reinterpret_cast<const unsigned char*>(src)[b])
                     << ((b & 3) * 8);
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};"
                 :: "r"(dst), "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3])
                 : "memory");
  }
}

// Stage `rows` rows of W bytes (bytes b0..b0 + W - 1 of rows of
// `row_bytes` bytes at src; row r valid when r < valid_rows) at dst, the
// 16-byte chunks of a row XOR-swizzled by (r & 7) when SW.
template <int W, bool SW>
__device__ __forceinline__ void stage_rows(uint32_t dst, const char* src,
                                           int rows, int valid_rows,
                                           int64_t row_bytes, int b0,
                                           int mode, const char* safe) {
  constexpr int kChunks = W / 16;
  for (int v = threadIdx.x; v < rows * kChunks; v += kThreads) {
    const int r = v / kChunks, c = v % kChunks;
    const int64_t left = row_bytes - b0 - c * 16;
    const int n = r < valid_rows ? (int)(left < 0 ? 0 : left < 16 ? left : 16)
                                 : 0;
    stage_chunk(dst + r * W + ((SW ? c ^ (r & 7) : c) << 4),
                src + r * row_bytes + b0 + c * 16, n, mode, safe);
  }
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}
// A TMA load of the box at (c0, c1) of `map` to dst, completing on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(bar)
      : "memory");
}

// A wgmma shared-memory descriptor of a K-major operand in the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (the stride
// byte offset; the leading one is unused for this layout).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}
// Pin the accumulators' reads and writes to this point of the instruction
// stream (the compiler does not see the asynchronous wgmma write them).
template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d += A (64 x k, descriptor da) @ B (k x N, descriptor db), issued by the
// warpgroup (asynchronous: see wgmma_commit/wgmma_wait): int8 slabs (tag
// int8_t) k = 32, s8 x s8 -> s32; bf16 slabs (tag uint16_t) k = 16,
// bf16 x bf16 -> f32. N = 128 (64 accumulators a thread) or 256 (128).
__device__ __forceinline__ void wgmma(int8_t, int (&d)[64], uint64_t da,
                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma(int8_t, int (&d)[128], uint64_t da,
                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
        "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
        "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma(uint16_t, float (&d)[64], uint64_t da,
                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma(uint16_t, float (&d)[128], uint64_t da,
                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// Two int8 values of a (the bytes sel picks: 0x5140 bytes 0, 1; 0x5342
// bytes 2, 3) as a bf16 pair, exactly: (128 + low 7 bits) - (128 or 256).
__device__ __forceinline__ uint32_t bf16_pair(uint32_t mag, uint32_t sgn,
                                              uint32_t sel) {
  const uint32_t v = __byte_perm(mag, 0x43434343u, sel);
  const uint32_t b = __byte_perm(sgn, 0x43434343u, sel);
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
                             *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// Warpgroup wg's 64 rows of the staged int8 A (rows of 64 bytes, plain) as
// bf16 at dst (rows of 128 bytes, swizzled).
__device__ __forceinline__ void a_to_bf16(uint32_t dst, uint32_t src,
                                          int wg) {
  const int t = threadIdx.x & 127;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int q = t + 128 * j;                   // 16-byte chunk of 256
    const int r = wg * 64 + (q >> 2), c = q & 3;
    uint32_t a[4];
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
                 : "r"(src + r * 64 + c * 16));
    uint32_t o[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t mag = a[i] & 0x7f7f7f7fu, sgn = a[i] & 0x80808080u;
      o[2 * i] = bf16_pair(mag, sgn, 0x5140);
      o[2 * i + 1] = bf16_pair(mag, sgn, 0x5342);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)                  // k 16c.., 16c + 8..
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};"
                   :: "r"(dst + r * 128 + (((2 * c + h) ^ (r & 7)) << 4)),
                      "r"(o[4 * h]), "r"(o[4 * h + 1]), "r"(o[4 * h + 2]),
                      "r"(o[4 * h + 3])
                   : "memory");
  }
}

// Out row `o` (its first element), columns col, col + 1.
template <typename T>
__device__ __forceinline__ void store_pair(T* __restrict__ o, int col, int H,
                                           T v0, T v1) {
  if ((H & 1) == 0 && col + 1 < H) {
    T v[2] = {v0, v1};
    *reinterpret_cast<uint2*>(o + col) = *reinterpret_cast<const uint2*>(v);
  } else {
    if (col < H) o[col] = v0;
    if (col + 1 < H) o[col + 1] = v1;
  }
}

// KIND: slab type; SLAB: per-slab scales (int8); NH: the CTA's columns /
// 128; TMA: stage by TMA (tm_a, tm_b: the tiles and the slabs as 2-D maps
// over their rows), else by cp.async of mode_a, mode_b bytes.
template <int KIND, bool SLAB, int NH, bool TMA>
__global__ void __launch_bounds__(kThreads, 1)
tile_mma_kernel(const int8_t* __restrict__ tiles,
                const int32_t* __restrict__ colb,
                const int32_t* __restrict__ row_ptr,
                const int32_t* __restrict__ order, const void* x,
                const float* __restrict__ slab_scale, void* out, int TR,
                int TC, int H, int n_chunks, int n_slices, int mode_a,
                int mode_b, const __grid_constant__ CUtensorMap tm_a,
                const __grid_constant__ CUtensorMap tm_b) {
  using T = std::conditional_t<KIND == kBF16, uint16_t, int8_t>;
  using Acc = std::conditional_t<KIND == kBF16, float, int>;
  using Out = std::conditional_t<KIND == kI8 && !SLAB, int, float>;
  constexpr int kKB = kRowBytes / (int)sizeof(T);    // k per step
  constexpr int BN = 128 * NH;
  constexpr int kAStage = kBM * kKB;                 // int8 A
  constexpr int kStage = kAStage + BN * kRowBytes;
  constexpr int kN = 64 * NH;                        // accumulators

  extern __shared__ unsigned char smem_raw[];
  // the swizzle repeats every 1024 bytes: align the stages to it
  const uint32_t sraw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t sbase = (sraw + 1023) & ~1023u;
  // bf16: the converted A, two buffers of 128 rows of 128 bytes
  const uint32_t abf = sbase + kStages * kStage;
  const uint32_t bars = abf + (KIND == kBF16 ? 2 * kBM * kRowBytes : 0);
  const int chunk = blockIdx.x % n_chunks;
  const int slice = (blockIdx.x / n_chunks) % n_slices;
  const int rb = order[blockIdx.x / (n_chunks * n_slices)];
  const int r0 = slice * kBM, h0 = chunk * BN;
  const int wg = threadIdx.x >> 7;               // warpgroup: rows 64 wg..
  const int t_begin = row_ptr[rb], t_end = row_ptr[rb + 1];
  const int nk = (TC + kKB - 1) / kKB;           // pieces per tile
  const int steps = (t_end - t_begin) * nk;
  const char* tb = reinterpret_cast<const char*>(tiles);
  const char* xb = static_cast<const char*>(x);
  const int64_t x_row = (int64_t)TC * sizeof(T);  // a slab row's bytes

  Acc acc[kN];
  float tot[SLAB ? kN : 1];
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    acc[i] = Acc(0);
    if constexpr (SLAB) tot[i] = 0.f;
  }

  // TMA: one mbarrier per stage
  if constexpr (TMA) {
    if (threadIdx.x == 0) {
      for (int i = 0; i < kStages; ++i) mbar_init(bars + 8 * i, 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
  }
  int lt = t_begin, lk = 0;                      // the next step to stage
  auto load = [&](int stage) {
    const uint32_t sa = sbase + stage * kStage;
    if constexpr (TMA) {
      if (threadIdx.x == 0) {
        const uint32_t bar = bars + 8 * stage;
        mbar_expect_tx(bar, kStage);
        tma_load(sa, &tm_a, lk * kKB, lt * TR + r0, bar);
        tma_load(sa + kAStage, &tm_b, lk * kKB, colb[lt] * H + h0, bar);
      }
    } else {
      stage_rows<kKB, KIND == kI8>(sa, tb + ((int64_t)lt * TR + r0) * TC,
                                   kBM, TR - r0, TC, lk * kKB, mode_a, tb);
      stage_rows<kRowBytes, true>(
          sa + kAStage, xb + ((int64_t)colb[lt] * H + h0) * x_row, BN,
          H - h0, x_row, lk * kRowBytes, mode_b, xb);
    }
    if (++lk == nk) {
      lk = 0;
      ++lt;
    }
  };

#pragma unroll
  for (int i = 0; i < kAhead; ++i) {             // the first steps
    if (i < steps) load(i);
    if constexpr (!TMA) cp_async_commit();
  }
  int ct = t_begin, ck = 0;                      // the step computed
  float sc = 0.f;                                // its slab's scale
  for (int s = 0; s < steps; ++s) {
    if constexpr (SLAB)
      if (ck == 0) sc = slab_scale[colb[ct]];
    const uint32_t sa = sbase + (s % kStages) * kStage;
    if constexpr (TMA) {
      mbar_wait(bars + 8 * (s % kStages), (s / kStages) & 1);
    } else {
      cp_async_wait<kAhead - 1>();               // this thread's copies of s
      if constexpr (KIND == kBF16) __syncthreads();  // every thread's
    }
    uint32_t a_desc = sa + wg * 64 * kRowBytes;
    if constexpr (KIND == kBF16) {               // this warpgroup's rows;
      const uint32_t dst = abf + (s & 1) * kBM * kRowBytes;  // its wgmmas
      a_to_bf16(dst, sa, wg);                    // of step s - 2 are done
      a_desc = dst + wg * 64 * kRowBytes;
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();                             // every thread's copies (or
                                                 // conversions); both
                                                 // warpgroups are past the
                                                 // wgmmas of step s - 2
    if (s + kAhead < steps) load((s + kAhead) % kStages);
    if constexpr (!TMA) cp_async_commit();
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma(T{}, acc, sw128_desc(a_desc + kk * 32),
            sw128_desc(sa + kAStage + kk * 32));
    wgmma_commit();
    wgmma_wait<1>();                             // step s - 1's are done
    if (++ck == nk) {
      if constexpr (SLAB) {                      // the tile's sums, scaled
        wgmma_wait<0>();
        fence_acc(acc);
#pragma unroll
        for (int i = 0; i < kN; ++i) {
          tot[i] = __fadd_rn(tot[i], __fmul_rn(__int2float_rn(acc[i]), sc));
          acc[i] = 0;
        }
      }
      ck = 0;
      ++ct;
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // a thread's outputs (the wgmma accumulator layout): rows g and g + 8 of
  // its warp's 16, columns 8j + 2q, + 1 of each 8-column block j
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  Out* o = static_cast<Out*>(out);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = r0 + wg * 64 + warp * 16 + g + hf * 8;
    if (row >= TR) continue;
    Out* orow = o + ((int64_t)rb * TR + row) * H;
#pragma unroll
    for (int j = 0; j < 16 * NH; ++j) {
      const int col = h0 + j * 8 + 2 * q;
      if constexpr (SLAB)
        store_pair(orow, col, H, tot[4 * j + 2 * hf], tot[4 * j + 2 * hf + 1]);
      else
        store_pair(orow, col, H, acc[4 * j + 2 * hf], acc[4 * j + 2 * hf + 1]);
    }
  }
}

// The copy width rows of `row_bytes` at `base` allow: 16, 4 or 1 bytes.
int copy_mode(long long row_bytes, const void* base) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(base);
  if (row_bytes % 16 == 0 && p % 16 == 0) return 16;
  if (row_bytes % 4 == 0 && p % 4 == 0) return 4;
  return 1;
}

// cuTensorMapEncodeTiled from the driver, resolved once (no link to it).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A 2-D map over `rows` rows of `cols` elements (esize bytes) at base,
// boxes of box_rows x box_cols elements, in the 128-byte swizzle or plain;
// zeros past the ends.
bool tile_map(CUtensorMap* m, const void* base, long long rows, int cols,
              int esize, int box_rows, int box_cols, bool swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * esize};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  return encode(m, esize == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                              : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                2, const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle ? CU_TENSOR_MAP_SWIZZLE_128B
                        : CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int kMapError = -2;

template <int KIND, bool SLAB, int NH, bool TMA>
int launch(const void* tiles, const void* colb, const void* row_ptr,
           const void* order, const void* x, const void* slab_scale,
           void* out, int n_tiles, int n_cb, int n_row_blocks, int TR,
           int TC, int H, int mode_a, int mode_b, cudaStream_t stream) {
  constexpr int esize = KIND == kBF16 ? 2 : 1;
  constexpr int kKB = kRowBytes / esize;
  constexpr int smem = kStages * (kBM * kKB + 128 * NH * kRowBytes) +
                       (KIND == kBF16 ? 2 * kBM * kRowBytes : 0) + 1024 +
                       kStages * 8;
  auto kernel = tile_mma_kernel<KIND, SLAB, NH, TMA>;
  CUtensorMap tm_a{}, tm_b{};
  if (TMA && !(tile_map(&tm_a, tiles, (long long)n_tiles * TR, TC, 1, kBM,
                        kKB, KIND == kI8) &&
               tile_map(&tm_b, x, (long long)n_cb * H, TC, esize, 128 * NH,
                        kKB, true)))
    return kMapError;
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return (int)rc;
  const int n_chunks = (H + 128 * NH - 1) / (128 * NH);
  const int n_slices = (TR + kBM - 1) / kBM;
  const long long n_blocks = (long long)n_row_blocks * n_slices * n_chunks;
  kernel<<<(unsigned)n_blocks, kThreads, smem, stream>>>(
      static_cast<const int8_t*>(tiles), static_cast<const int32_t*>(colb),
      static_cast<const int32_t*>(row_ptr),
      static_cast<const int32_t*>(order), x,
      static_cast<const float*>(slab_scale), out, TR, TC, H, n_chunks,
      n_slices, mode_a, mode_b, tm_a, tm_b);
  return (int)cudaGetLastError();
}

// TMA where the rows' bytes and both bases allow 16-byte steps (and there
// are tiles to map), else cp.async.
template <int KIND, bool SLAB, int NH>
int launch_mode(const void* tiles, const void* colb, const void* row_ptr,
                const void* order, const void* x, const void* slab_scale,
                void* out, int n_tiles, int n_cb, int n_row_blocks, int TR,
                int TC, int H, cudaStream_t stream) {
  const int mode_a = copy_mode(TC, tiles);
  const int mode_b = copy_mode((long long)TC * (KIND == kBF16 ? 2 : 1), x);
  if (mode_a == 16 && mode_b == 16 && n_tiles > 0)
    return launch<KIND, SLAB, NH, true>(tiles, colb, row_ptr, order, x,
                                        slab_scale, out, n_tiles, n_cb,
                                        n_row_blocks, TR, TC, H, mode_a,
                                        mode_b, stream);
  return launch<KIND, SLAB, NH, false>(tiles, colb, row_ptr, order, x,
                                       slab_scale, out, n_tiles, n_cb,
                                       n_row_blocks, TR, TC, H, mode_a,
                                       mode_b, stream);
}

// 256 columns a CTA where H pads no further to 256 than to 128, else 128.
template <int KIND>
int launch_width(const void* tiles, const void* colb, const void* row_ptr,
                 const void* order, const void* x, void* out, int n_tiles,
                 int n_cb, int n_row_blocks, int TR, int TC, int H,
                 cudaStream_t s) {
  if ((H + 255) / 256 * 256 == (H + 127) / 128 * 128)
    return launch_mode<KIND, false, 2>(tiles, colb, row_ptr, order, x,
                                       nullptr, out, n_tiles, n_cb,
                                       n_row_blocks, TR, TC, H, s);
  return launch_mode<KIND, false, 1>(tiles, colb, row_ptr, order, x, nullptr,
                                     out, n_tiles, n_cb, n_row_blocks, TR, TC,
                                     H, s);
}

}  // namespace

extern "C" {

// Shapes as in the header (n_tiles = B). kind: 0 int8 slabs (out int32
// [n_row_blocks, TR, H], or f32 with slab_scale [n_cb] f32), 1 bf16 slabs
// (out f32; slab_scale must be null). Launches on `stream`; returns
// cudaGetLastError() after the launch (or the error of setting the
// kernel's shared-memory size), -1 for bad arguments, -2 when the driver
// refused a tensor map.
int bnsgcn_tile_mma(const void* tiles, const void* colb, const void* row_ptr,
                    const void* order, const void* x, int kind,
                    const void* slab_scale, void* out, int n_tiles, int n_cb,
                    int n_row_blocks, int TR, int TC, int H, void* stream) {
  if (n_row_blocks <= 0 || H <= 0) return 0;
  if (TR <= 0 || TC <= 0 || n_tiles < 0 || n_cb <= 0 ||
      (kind != kI8 && kind != kBF16) ||
      (slab_scale != nullptr && kind != kI8))
    return -1;
  const auto s = reinterpret_cast<cudaStream_t>(stream);
  if (slab_scale != nullptr)
    return launch_mode<kI8, true, 1>(tiles, colb, row_ptr, order, x,
                                     slab_scale, out, n_tiles, n_cb,
                                     n_row_blocks, TR, TC, H, s);
  if (kind == kBF16)
    return launch_width<kBF16>(tiles, colb, row_ptr, order, x, out, n_tiles,
                               n_cb, n_row_blocks, TR, TC, H, s);
  return launch_width<kI8>(tiles, colb, row_ptr, order, x, out, n_tiles, n_cb,
                           n_row_blocks, TR, TC, H, s);
}

const char* bnsgcn_tile_mma_error(int code) {
  if (code == -1) return "bad arguments (slab kind, scale or geometry)";
  if (code == kMapError) return "the driver refused a TMA tensor map";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
