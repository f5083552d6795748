// A ring of shared-memory slots filled by 1-D bulk copies (sm_90):
// cp.async.bulk (the Tensor Memory Accelerator without a tensor map) moves
// a contiguous run of global memory into a slot and completes on the
// slot's "full" mbarrier; the slot's readers arrive on its "empty"
// mbarrier when done. Each barrier completes one phase per use of its
// slot, so a wait names the parity of the phase it waits for: use n of a
// slot waits for phase n, parity n & 1.

#ifndef MYT_BULK_RING_CUH
#define MYT_BULK_RING_CUH

#include <cstdint>

namespace myt_ring {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// a phase completes after `count` arrivals (and, once armed, its bytes)
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy; then a
// __syncthreads() before any thread uses them
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// one arrival, with release semantics: this thread's earlier accesses
// (and those ordered before them) happen before the phase completes
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  uint64_t state;
  asm volatile("mbarrier.arrive.release.cta.shared::cta.b64 %0, [%1];"
               : "=l"(state) : "r"(smem_addr(bar)) : "memory");
}

// one arrival that also arms the phase to wait for `bytes` of bulk copies
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  uint64_t state;
  asm volatile("mbarrier.arrive.expect_tx.release.cta.shared::cta.b64 %0, [%1], %2;"
               : "=l"(state) : "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// wait, with acquire semantics, for the phase of parity `parity` to
// complete. A wait that polls 2^24 times (seconds; a row lands in
// microseconds) traps, so a lost arrival ends the kernel with an error
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.acquire.cta.shared::cta.b64 p, [%1], %2;\n"
                 " selp.b32 %0, 1, 0, p;\n}"
                 : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (polls == (1u << 24)) __trap();
  }
}

// copy `bytes` (a multiple of 16; both addresses 16-byte aligned) from
// global to shared memory; completes `bytes` of the armed phase of `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

}  // namespace myt_ring

#endif  // MYT_BULK_RING_CUH
