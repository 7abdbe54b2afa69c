// Tensor-core helpers shared by the port's bf16 kernels (sm_90a): ldmatrix
// loads of bf16 fragments from shared memory and the warp-wide
// m16n8k16 product, bf16 operands, f32 accumulators (mma.sync).
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16"): with g =
// lane / 4 and t = lane % 4, A (16 x 16, row-major) is four 32-bit words of
// two bf16 each, rows g and g + 8 by k 2t..2t+1 and 2t+8..2t+9; B (16 x 8,
// "col", i.e. k-major per column) two words, k 2t..2t+1 and 2t+8..2t+9 of
// column g; C / D four floats, rows g and g + 8 by columns 2t and 2t + 1.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// A fragment of rows [r0, r0 + 16) and k [k0, k0 + 16) of a row-major bf16
// tile: `row` points at element (r0 + lane % 16, k0 + 8 * (lane / 16))
// (16-byte aligned). Matrix j of the four is rows 8 (j % 2), k 8 (j / 2).
__device__ __forceinline__ void ldmatrix_a(unsigned (&a)[4], const void* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(s)
      : "memory");
}

// B fragments of two adjacent n8 tiles, columns [n0, n0 + 16) and k [k0,
// k0 + 16), from a k-major bf16 tile (each row k holds its columns
// contiguously): `row` points at element (k0 + lane % 16, n0 + 8 * (lane /
// 16)) (16-byte aligned). .trans hands each lane a column's k pairs: b[0],
// b[1] are tile n0's two words, b[2], b[3] tile n0 + 8's.
__device__ __forceinline__ void ldmatrix_b2(unsigned (&b)[4],
                                            const void* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(s)
      : "memory");
}

// d += a * b over one m16n8k16 tile: bf16 products (exact in f32) added
// into the f32 accumulators by the tensor core
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warp's product of a chunk: rows [16 * warp, + 16) of the A tile
// (row stride AS bf16) by all KT columns of the B tile (row stride BS
// bf16), k in [0, KQ). The chunk's sum starts from zero in `part` and is
// then added into `acc` on the CUDA cores (a round-to-nearest f32 add per
// chunk), so the tensor core's own additions span one chunk only.
template <int KQ, int KT, int AS, int BS>
__device__ __forceinline__ void mma_chunk(float (&acc)[KT / 8][4],
                                          const __nv_bfloat16* as,
                                          const __nv_bfloat16* bs, int warp,
                                          int lane) {
  float part[KT / 8][4];
#pragma unroll
  for (int n = 0; n < KT / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
  const __nv_bfloat16* arow =
      as + (16 * warp + lane % 16) * AS + 8 * (lane / 16);
  const __nv_bfloat16* brow = bs + (lane % 16) * BS + 8 * (lane / 16);
#pragma unroll
  for (int k = 0; k < KQ; k += 16) {
    unsigned a[4];
    ldmatrix_a(a, arow + k);
#pragma unroll
    for (int n = 0; n < KT / 16; ++n) {
      unsigned b[4];
      ldmatrix_b2(b, brow + k * BS + 16 * n);
      mma_bf16(part[2 * n], a, b[0], b[1]);
      mma_bf16(part[2 * n + 1], a, b[2], b[3]);
    }
  }
#pragma unroll
  for (int n = 0; n < KT / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
}
