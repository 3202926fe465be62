// Grouped dense-tile matmul for the hybrid SpMM's dense part:
//
//     out[rb] = sum_{t : rowb[t] == rb} tiles[t] @ x_slabs[colb[t]]
//
// tiles [B, TR, TC] int8 edge multiplicities (rowb-sorted; pad tiles carry
// rowb == n_row_blocks and are never visited), x_slabs [n_cb, TC, H] f32,
// out [n_row_blocks, TR, H] f32. row_ptr [n_row_blocks + 1] is the CSR
// offset array over the sorted rowb: row-block rb owns tiles
// [row_ptr[rb], row_ptr[rb + 1]).
//
// Replaces the TPU kernel bnsgcn_tpu/ops/pallas_block.py `_kernel` /
// `pallas_tile_matmul` (wrapper `dense_apply_pallas`), run by
// `--spmm hybrid --use-pallas` forward and, on the transposed tile stack,
// backward.
//
// The TPU kernel relies on its grid running IN ORDER: the output block stays
// resident in VMEM across consecutive tiles of one row-block and is zeroed on
// its first visit; a row-block no tile visits is left unwritten and masked by
// the caller. Hopper runs blocks in no order, so here one CTA owns one
// (row-block, 64-row slice, 64-column slice) of the output and walks that
// row-block's contiguous tile range itself: it accumulates in registers and
// writes once. No atomics (the result is deterministic), and a row-block
// with no tiles is written as zeros, so no caller mask is needed.
//
// Bound on this card: bytes. The output needs 2*nnz*H f32 FLOPs, nnz the
// edges the tiles carry (a zero entry adds nothing), against
// ~B*TR*TC + n_cb*TC*H*4 + n_rb*TR*H*4 bytes; the tiles are a few percent
// dense, so the bytes over 3.35 TB/s take longer than the needed FLOPs over
// 67 TFLOP/s. This kernel does not skip zeros: it runs all 2*B*TR*TC*H FLOPs
// on the CUDA cores (no TF32: the port computes in float32), which is what
// holds it far above that bound. The design is the classic shared-memory SGEMM:
// 64x64 output block, 32-deep K steps through shared memory (16 KB static,
// well under the 48 KB static limit, so both TC and H are tiled -- a whole
// [512, 602] f32 slab would be 1.2 MB), each thread an FMA micro-tile of 4x4.
// The int8 tile converts to f32 on its way into shared memory.
// Speed (wgmma tensor cores, TMA pipelines, fusing the slab gather) is later
// work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;       // output rows per CTA
constexpr int kBN = 64;       // output columns per CTA
constexpr int kBK = 32;       // K (tile column) step
constexpr int kThreads = 256; // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(kThreads)
tile_matmul_kernel(const int8_t* __restrict__ tiles,
                   const int32_t* __restrict__ colb,
                   const int32_t* __restrict__ row_ptr,
                   const float* __restrict__ x, float* __restrict__ out,
                   int TR, int TC, int H) {
  __shared__ __align__(16) float As[kBK][kBM];   // tile chunk, transposed
  __shared__ __align__(16) float Xs[kBK][kBN];   // slab chunk
  const int rb = blockIdx.x;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.z * kBN;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  // tile loader: 64 rows x 32 int8 = 256 threads x 8 bytes
  const int a_row = tid >> 2, a_k = (tid & 3) * 8;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int t_begin = row_ptr[rb], t_end = row_ptr[rb + 1];
  for (int t = t_begin; t < t_end; ++t) {
    const int8_t* __restrict__ a =
        tiles + (int64_t)t * TR * TC + (int64_t)(m0 + a_row) * TC + a_k;
    const float* __restrict__ xs = x + (int64_t)colb[t] * TC * H;
    for (int k0 = 0; k0 < TC; k0 += kBK) {
      const int2 v = *reinterpret_cast<const int2*>(a + k0);
      const int8_t* b8 = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
      for (int q = 0; q < 8; ++q) As[a_k + q][a_row] = (float)b8[q];
#pragma unroll
      for (int q = 0; q < (kBK * kBN) / kThreads; ++q) {
        const int e = tid + kThreads * q;
        const int kk = e / kBN, col = e % kBN;
        const int c = n0 + col;
        Xs[kk][col] = (c < H) ? xs[(int64_t)(k0 + kk) * H + c] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
        const float4 bv = *reinterpret_cast<const float4*>(&Xs[kk][tx * 4]);
        const float ar[4] = {av.x, av.y, av.z, av.w};
        const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* __restrict__ o = out + ((int64_t)rb * TR + m0 + ty * 4 + i) * H;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx * 4 + j;
      if (c < H) o[c] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// Shapes as in the header; TR % 64 == 0, TC % 32 == 0 and an 8-byte aligned
// tile stack (the wrapper checks). Launches on `stream`; returns
// cudaGetLastError() after the launch.
int bnsgcn_tile_matmul_f32(const void* tiles, const void* colb,
                           const void* row_ptr, const void* x, void* out,
                           int n_row_blocks, int TR, int TC, int H,
                           void* stream) {
  if (n_row_blocks <= 0 || H <= 0) return 0;
  const dim3 grid((unsigned)n_row_blocks, (unsigned)(TR / kBM),
                  (unsigned)((H + kBN - 1) / kBN));
  tile_matmul_kernel<<<grid, kThreads, 0,
                       reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(tiles), static_cast<const int32_t*>(colb),
      static_cast<const int32_t*>(row_ptr), static_cast<const float*>(x),
      static_cast<float*>(out), TR, TC, H);
  return (int)cudaGetLastError();
}

const char* bnsgcn_tile_matmul_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
