// The cp.async copies from device memory into shared memory, and the waits
// on their commit groups, shared by the kernels that stage their inputs in
// shared memory (cdecode.cu, sscan.cu, stencil.cu, zfp.cu).

#pragma once

#include <cuda_runtime.h>

// An asynchronous copy of kBytes (4, 8 or 16, aligned to kBytes).
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(src), "n"(kBytes)
               : "memory");
}

// The same, reading nothing and writing kBytes zeros where valid is false
// (src-size 0; src must still be a device address).
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
               "l"(src), "n"(kBytes), "r"(valid ? kBytes : 0)
               : "memory");
}

// Close the group of the copies issued since the last commit.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
