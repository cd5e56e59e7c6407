// Asynchronous copies from device memory into shared memory (cp.async,
// sm_80 and later): the copy runs while the thread goes on, and a wait on
// its commit group, then a block barrier, makes it visible to the block.

#pragma once

#include <cstddef>

namespace {

// 16 bytes (4 floats or 8 bfloat16); both addresses 16-byte aligned. .cg:
// cached in L2 only.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

// 4 bytes, for rows whose stride is not a multiple of 16 bytes.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's commit groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace
