// Asynchronous 4-, 8- and 16-byte copies from device memory to shared memory
// (cp.async, sm_80 and later), for kernels that stage tiles with a halo: a thread
// issues all of its copies without waiting on any, so their latencies
// overlap each other (and, with two buffers, the compute on the previous
// tile). A copy marked invalid writes a zero and reads nothing: the zero
// padding outside the image.
//
// Also the bulk copy engine (cp.async.bulk, sm_90): one thread moves a
// contiguous run of bytes (a multiple of 16, 16-byte aligned at both ends)
// between device memory and shared memory. A load completes on an mbarrier
// in shared memory, which counts its bytes; a store is tracked in the
// issuing thread's bulk groups. K9-bf16 loads its weights so, K3-bf16
// stores its output so.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace cpa {

// shared[dst] = valid ? *src : 0, 4 bytes (a float or two bf16 values):
// dst and src 4-byte aligned. src must be a valid address even when
// !valid (it is not read then).
__device__ __forceinline__ void copy4(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 4 : 0));
}

// The same for 8 bytes (four bf16 values): dst and src 8-byte aligned.
__device__ __forceinline__ void copy8(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 8 : 0));
}

// The same for 16 bytes: dst and src 16-byte aligned.
__device__ __forceinline__ void copy16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0));
}

// Closes the group of copies issued since the last commit.
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// an mbarrier expecting count arrivals, made visible to the bulk copies
// (one thread calls it; a barrier of the block follows before any use)
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// this thread's arrival on bar, which then also waits for bytes of copies
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// waits until the phase of bar with this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

// shared[dst] = global[src], bytes, completing on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// global[dst] = shared[src], bytes, in this thread's current bulk group
__device__ __forceinline__ void bulk_store(void* dst, const void* src, unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(dst), "r"(smem_u32(src)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// this thread's bulk stores have read their sources (read) or are done
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

}  // namespace cpa
