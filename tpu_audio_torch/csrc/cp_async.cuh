// cp.async helpers shared by the port's Hopper kernels (sm_90a): 16- and
// 8-byte asynchronous copies from global to shared memory, with the
// zero-fill form for masked vectors and an L2 prefetch form, and the
// commit/wait of copy groups.

#pragma once

#include <cuda_runtime.h>

// 16-byte asynchronous copy, global -> shared (L2 only), zero-filled when
// !valid (src is then not read, but must still be a valid address)
__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// 8-byte asynchronous copy (through L1: the .cg form takes 16 bytes only),
// zero-filled when !valid; dst and src 8-byte aligned
__device__ __forceinline__ void copy8(void* dst, const void* src,
                                      bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 8 : 0) : "memory");
}

// copy16 that also has L2 fetch the 256-byte block holding src: a line
// read in 128-byte runs per row then reaches device memory in 256-byte
// ones, the next chunk's run already in L2 when its copy comes
__device__ __forceinline__ void copy16_l2pf(void* dst, const void* src,
                                            bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// the copy of one vector of kBytes: 16 (copy16_l2pf) or 8 (copy8)
template <int kBytes>
__device__ __forceinline__ void copy_vec(void* dst, const void* src,
                                         bool valid) {
  static_assert(kBytes == 16 || kBytes == 8, "16- or 8-byte copies only");
  if constexpr (kBytes == 16) copy16_l2pf(dst, src, valid);
  else copy8(dst, src, valid);
}

// two bf16 values packed in a 32-bit word (the lower address in the low
// half) -> the float of each: exact, a bf16 is the top half of a float
__device__ __forceinline__ float bf16_lo(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are pending
template <int N>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}


