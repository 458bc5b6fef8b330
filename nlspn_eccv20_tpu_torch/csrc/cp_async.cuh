// Asynchronous 4-, 8- and 16-byte copies from device memory to shared memory
// (cp.async, sm_80 and later), for kernels that stage tiles with a halo: a thread
// issues all of its copies without waiting on any, so their latencies
// overlap each other (and, with two buffers, the compute on the previous
// tile). A copy marked invalid writes a zero and reads nothing: the zero
// padding outside the image.

#pragma once

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

}  // namespace cpa
