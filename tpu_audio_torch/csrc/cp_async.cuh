// cp.async helpers shared by the port's Hopper kernels (sm_90a): 16-byte
// asynchronous copies from global to shared memory, with the zero-fill
// form for masked vectors, and the commit/wait of copy groups.

#pragma once

#include <cuda_runtime.h>

// 16-byte asynchronous copy, global -> shared (L2 only), zero-filled when
// !valid (src is then not read, but must still be a valid address)
__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are pending
template <int N>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}


