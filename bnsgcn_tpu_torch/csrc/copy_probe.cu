// Manual-copy probe: out[0] = x[0] through shared memory by the Tensor
// Memory Accelerator.
//
// Replaces the TPU kernel tools/hw_session.py `dma_kernel` (a probe script
// string): a minimal `pltpu.make_async_copy` of x[0] from HBM into VMEM
// scratch, a semaphore wait, then a vector store to the output -- a check
// that the toolchain reaches the chip's manual-DMA path at all. Its Hopper
// counterpart proves the same of this repo's nvcc build on sm_90a: one CTA
//
//   * initializes an mbarrier in shared memory (arrival count 1) and fences
//     the init so the asynchronous proxy sees it;
//   * one thread announces the transaction bytes (mbarrier.arrive.expect_tx)
//     and issues one bulk copy global -> shared
//     (cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes),
//     which completes its bytes on that barrier;
//   * every thread waits on phase 0 (mbarrier.try_wait.parity in a loop),
//     then the threads write shared memory to `out` with plain stores.
//
// That is the TMA bulk-copy + mbarrier path a pipelined K2 (the dense-tile
// kernel) needs. Bound on this card: launch latency -- the copy is 4 KiB at
// the probe's shape [4, 8, 128] f32; its bytes over 3.35 TB/s take ~2 ns.
// Bulk copies need 16-byte-aligned addresses and a size that is a multiple
// of 16 bytes, at most kMaxBytes here; the wrapper checks both.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr uint32_t kMaxBytes = 16384;

__global__ void __launch_bounds__(kThreads)
copy_probe_kernel(const float* __restrict__ x, float* __restrict__ out,
                  uint32_t nbytes) {
  __shared__ __align__(128) float buf[kMaxBytes / sizeof(float)];
  __shared__ __align__(8) uint64_t bar;
  const uint32_t bar_addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(&bar));
  const uint32_t buf_addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(buf));

  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(bar_addr), "r"(1) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x == 0) {
    asm volatile(
        "{\n\t.reg .b64 state;\n\t"
        "mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n\t}"
        :: "r"(bar_addr), "r"(nbytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];"
        :: "r"(buf_addr), "l"(x), "r"(nbytes), "r"(bar_addr) : "memory");
  }

  uint32_t ready = 0;
  while (!ready) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(ready) : "r"(bar_addr), "r"(0) : "memory");
  }

  const uint32_t n = nbytes / sizeof(float);
  for (uint32_t i = threadIdx.x; i < n; i += kThreads) out[i] = buf[i];
}

}  // namespace

extern "C" {

// Copies the first `nbytes` of x to out (both on the device, 16-byte
// aligned, nbytes a multiple of 16 and at most kMaxBytes) on `stream`;
// returns cudaGetLastError() after the launch, -1 for bad arguments.
int bnsgcn_copy_probe(const void* x, void* out, uint32_t nbytes,
                      void* stream) {
  if (nbytes == 0 || nbytes % 16 || nbytes > kMaxBytes ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return -1;
  copy_probe_kernel<<<1, kThreads, 0,
                      reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), nbytes);
  return (int)cudaGetLastError();
}

const char* bnsgcn_copy_probe_error(int code) {
  if (code == -1) return "bad arguments (alignment, size)";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
