// Shared-memory staging for the port's Hopper kernels: mbarriers and 1-D
// bulk copies (TMA) from device memory into shared memory.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace spmv {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}
// One arrival that also expects `bytes` of bulk copies to land.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
// A consumer hands a stage back to the bulk copies: its generic-proxy
// reads of the stage are ordered before the async-proxy writes of the
// next copy into it.  The empty barrier's arrive and wait order the
// generic proxy only; without this fence a read issued late (a staged x
// word at an address decoded from the meta) could see the next tile's
// bytes: a few wrong rows when two launches share the SMs (sell.cu's row
// mode on two CUDA streams; sell_probe.py streams builds the kernel
// without it).  Every consumer thread calls it before the warp's arrive.
__device__ __forceinline__ void fence_stage_reads() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}
// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}
// 1-D bulk copy (TMA) of `bytes` (a multiple of 16, both ends 16-B aligned)
// from device memory into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Columns of the window at `base` that are staged: all 1024 inside n, else
// those below n rounded down to whole 16-B words (the bulk copy's unit).
template <typename T>
__device__ __forceinline__ int staged_x(int64_t base, int64_t n) {
  const int64_t avail = n - base;
  constexpr int kWord = 16 / int(sizeof(T));
  return avail >= kTile ? kTile : avail <= 0 ? 0 : int(avail) & ~(kWord - 1);
}

}  // namespace spmv
