// In-place delay-line shift fused with the all-K partition MAC, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel tpu_audio/ops/pallas_mac.py:mac_shift
// (kernel _mac_shift_kernel), the MAC of tpu_audio/engine/fmajor.py's roll
// mode. For every frequency bin f and delay-line row vi (voice x input
// channel), in the engine's layout fdl f32 [F, VI, 2, Pp] (each row one
// contiguous run of Q = 2*Pp values, q = c*Pp + s):
//
//     fdl'[f, vi, c, 0] = x_new[f, vi, c]
//     fdl'[f, vi, c, s] = fdl[f, vi, c, s - 1]           (s >= 1)
//     m[f, vi, kod]     = sum_{c, s} fdl'[f, vi, c, s] * rhs[f, c, s, kod]
//                       = sum_c x_new[f, vi, c] * rhs[f, c, 0, kod]
//                         + sum_{c, s < Pp-1} fdl[f, vi, c, s] * rhs[f, c, s+1, kod]
//
// The shift stays inside each plane c (the last slot of a plane drops out),
// and fdl' is written over fdl IN PLACE, as the Pallas call aliases its
// delay line in and out. rhs f32 [F, 2, Pp, KOD] is the natural-order bank
// (pack_mac_rhs), x_new f32 [F, VI, 2, 1], m f32 [F, VI, KOD]. Zero-padded
// partitions (Pp > P) stay inert: the last real partition shifts into a pad
// slot, whose rhs rows are zero.
//
// What bounds it on an H100: bytes. A call must read the delay line and
// write it back (2 x 183 MB at 64 voices: F=257, VI=128, Pp=696) and read
// the rhs (F * 2Pp * KOD * 4 B: 23 MB at KOD=16, 92 MB at KOD=64), so
// ~389 MB at KOD=16 and ~458 MB at KOD=64, against 2*F*VI*2Pp*KOD FLOP
// (1.5 and 5.9 GFLOP): at most 12.8 FLOP/byte, below the card's f32
// CUDA-core ridge of ~67 TFLOP/s / 3.35 TB/s = 20. The floor at 3.35 TB/s
// is ~116 us at KOD=16 and ~137 us at KOD=64, provided each byte crosses
// device memory once and the FMAs (~90-100 us of the card's f32 rate at
// KOD=64) overlap the copies.
//
// Design against that bound:
//   - a block owns one bin f, a tile of kRows = 128 delay-line rows (all VI
//     rows at 64 voices: 257 blocks, two resident per SM, one wave) and ALL
//     the KOD columns of those rows at once. Rows are independent, so
//     splitting VI over blocks is race-free; splitting the columns is not (a
//     second block would read rows the first had shifted), and re-reading
//     the line once per column tile is what bound the previous design;
//   - the block streams the reduction axis q in chunks of kQC = 32, tail
//     first, through a ring of kStages = 4 shared-memory stages. A stage
//     holds the chunk's fdl tile [128 rows][32 q] and its pre-shifted rhs
//     tile [32 q][KT]: row q holds rhs[f, q + 1], zero where s = Pp - 1 and
//     past Q, so the OLD value at q pairs with rhs row q and the shifted
//     line never has to exist before the MAC. Shared memory is fixed (104 KB
//     at KT = 64) whatever Pp is;
//   - the stages are filled with cp.async (16 bytes, L2 only), not TMA: the
//     rhs tile starts one row below the chunk and has a zero row at each
//     plane's end, the fdl tile has a ragged top chunk and masked rows, and
//     cp.async's zero-fill form (src-size 0) covers all of that per 16-byte
//     vector with no tensor map to encode on the host for each call; at ~6
//     copies per thread per chunk its instruction cost is small beside the
//     FMAs;
//   - each thread keeps a register micro-tile of kTM rows x kTN columns of
//     the block's [128, KT] output (4 x 8 at KT = 64), read outer-product
//     style from shared memory: per q, kTM row values (a warp's rows fall
//     in distinct banks: the tile's row stride is kQC + 4 floats) and kTN/4
//     float4 of rhs. Columns come in groups of 4 (KOD % 4 == 0 is all the
//     wrapper promises); the column tile KT is 16, 32, 48 or 64, the least
//     that covers KOD, and columns past KOD are zero-filled, never stored;
//   - f32 FMA on the CUDA cores only: no TF32, no tensor cores (the port
//     keeps full f32 on value-carrying products);
//   - the shifted line is written from shared memory, in place, with
//     aligned 16-byte stores: slot q of chunk [a, a + 32) takes old[q - 1]
//     (old[a - 1] from the chunk below) or x_new at a plane's slot 0. A
//     store shifted by one slot would leave every 128-byte line half
//     written until the next chunk: measured on the H100, that store
//     pattern alone cost ~180 us of a ~220 us call at KOD=16. So a chunk is
//     written one iteration late, once the chunk below has landed, and two
//     of the four stages are in flight while the block computes.
//
// The in-place race, and how it is avoided. The chunks are walked from the
// tail (q = Q - 1) toward q = 0. At iteration i the block writes chunk
// i - 1's slots, all of which it has read (chunk i - 1 and chunk i have
// landed); the copies in flight are of chunks i + 1 and i + 2, below them.
// Each slot is written once, by the chunk that holds it; plane 0's last
// slot drops out and never lands in plane 1's slot 0. Chunks may straddle
// the plane boundary.
//
// KOD > 64 (only an explicit 'allk' with more than 16 IRs): the block loops
// over column groups of 64, re-reading the line per group, and writes the
// shifted line in the last group only. KOD <= 64 reads the line once.
//
// bf16 operands (mac_dtype='bf16'): the kernel is a template on the
// operand type T, float or __nv_bfloat16. With T = bf16 the line, x_new and
// rhs are bf16 (JAX casts the new block spectrum to bf16 before it enters
// the line, tpu_audio/engine/fmajor.py:730) and the shifted line is
// written back in bf16, bit for bit the values it read; each value becomes
// an f32 as it leaves shared memory, and products, sums and m are f32 as
// in the f32 form (bf16 x bf16 products are exact in f32). The Pallas
// kernel declares its aliased line f32, so JAX runs bf16 roll mode as the
// roll plus the einsum at fmajor.py:920-923; this kernel stands for that
// pair. A stage holds 8 values per 16-byte copy, half the shared memory;
// the rhs tile moves in 8-byte vectors of 4 columns (a row of rhs starts
// on 8 bytes, not 16, when KOD % 8 == 4); the write-back moves 16-byte
// runs of 8 slots, each lane taking the slot before its run from the lane
// to its left (__shfl_up_sync within the row's 4 lanes) or, for the first
// lane, from the chunk below, as in the f32 form. The race guard is
// unchanged: the tail-first walk writes chunk i - 1 only once chunks i - 1
// and i have landed, and every lane of a warp takes part in each shuffle.
// The bound: the line is read and written in half the bytes, 58.5 / 63.1 /
// 69.7 us at KOD 16 / 36 / 64, under the f32 FMAs at KOD 36 and 64.
//
// Alignment: fdl rows start on 16 bytes only if Q * sizeof(T) is a
// multiple of 16, so the launch refuses an odd Pp for f32 and a Pp that is
// not a multiple of 4 for bf16 (the engine pads Pp to a multiple of 8).
// The launch allocates nothing and does not synchronise; it returns a
// cudaError_t so the caller can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "cp_async.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 128;                  // delay-line rows per block
constexpr int kQC = 32;                     // q per chunk
constexpr int kStages = 4;                  // depth of the cp.async ring
constexpr int kAhead = kStages - 2;         // chunks in flight

// fdl tile row stride in elements: the chunk plus one 16-byte vector, so a
// warp's rows fall in distinct banks (36 floats; 40 bf16 = 20 words)
template <typename T>
__host__ __device__ constexpr int a_stride() {
  return kQC + 16 / static_cast<int>(sizeof(T));
}

template <typename T, int KT>
__host__ __device__ constexpr int stage_elems() {
  return kRows * a_stride<T>() + kQC * KT;
}

template <typename T, int KT>
__global__ void __launch_bounds__(kThreads, 2)
mac_shift_kernel(T* __restrict__ fdl, const T* __restrict__ x_new,
                 const T* __restrict__ rhs, float* __restrict__ m,
                 int vi_count, int pp, int kod) {
  constexpr int kCG = KT == 64 ? 8 : 4;     // column groups of the tile
  constexpr int kNV = KT / (4 * kCG);       // 4-column vectors per thread
  constexpr int kTN = 4 * kNV;              // columns per thread
  constexpr int kRG = kThreads / kCG;       // row groups of the tile
  constexpr int kTM = kRows / kRG;          // rows per thread
  constexpr int kAStride = a_stride<T>();
  constexpr int kVecLen = 16 / static_cast<int>(sizeof(T));  // per 16 B
  constexpr int kVecs = kQC / kVecLen;      // 16-byte vectors per row of a
                                            // chunk
  extern __shared__ __align__(16) float smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int row_tiles = (vi_count + kRows - 1) / kRows;
  const int f = blockIdx.x / row_tiles;
  const int row0 = (blockIdx.x - f * row_tiles) * kRows;
  const int rows = min(kRows, vi_count - row0);
  const int q_total = 2 * pp;
  const int chunks = (q_total + kQC - 1) / kQC;
  const int tid = threadIdx.x;
  const int cg = tid % kCG;                 // a warp's lanes: kCG column
  const int rg = tid / kCG;                 // groups x consecutive rows

  T* line = fdl + ((size_t)f * vi_count + row0) * q_total;
  const T* xn = x_new + ((size_t)f * vi_count + row0) * 2;
  const T* rhs_f = rhs + (size_t)f * q_total * kod;

  for (int col0 = 0; col0 < kod; col0 += KT) {
    const int cols = min(KT, kod - col0);
    const bool last = col0 + KT >= kod;
    if (col0 > 0) __syncthreads();          // every thread is off the ring

    // chunk i of the walk, [a, a + kQC) with a = (chunks - 1 - i) * kQC,
    // into stage i % kStages
    auto load = [&](int i) {
      const int a = (chunks - 1 - i) * kQC;
      T* as = smem + (i % kStages) * stage_elems<T, KT>();
      T* bs = as + kRows * kAStride;
      for (int e = tid; e < kRows * kVecs; e += kThreads) {
        const int r = e / kVecs;
        const int qq = kVecLen * (e % kVecs);
        const bool ok = r < rows && a + qq < q_total;
        copy16(as + r * kAStride + qq,
               ok ? line + (size_t)r * q_total + a + qq : fdl, ok);
      }
      for (int e = tid; e < kQC * (KT / 4); e += kThreads) {
        const int j = e / (KT / 4);
        const int col = 4 * (e % (KT / 4));
        const int q = a + j;
        const int s = q >= pp ? q - pp : q;
        const bool ok = q < q_total && s + 1 < pp && col < cols;
        copy_vec<4 * static_cast<int>(sizeof(T))>(
            bs + j * KT + col,
            ok ? rhs_f + (size_t)(q + 1) * kod + col0 + col : rhs, ok);
      }
    };

    // the shifted slots of chunk i, from its stage and that of chunk i + 1
    // (the chunk below, whose last slot is old[a - 1]); lanes: kVecs
    // float4 of a row x kThreads / kVecs rows
    auto write_back = [&](int i) {
      const int a = (chunks - 1 - i) * kQC;
      const T* cur = smem + (i % kStages) * stage_elems<T, KT>();
      const T* below = smem + ((i + 1) % kStages) * stage_elems<T, KT>();
      const int v = tid % kVecs;
      const int q0 = a + kVecLen * v;
      for (int r0 = 0; r0 < rows; r0 += kThreads / kVecs) {
        const int r = r0 + tid / kVecs;
        const bool live = r < rows && q0 < q_total;
        if constexpr (std::is_same_v<T, float>) {
          const float4 x = live ? *reinterpret_cast<const float4*>(
                                      cur + r * kAStride + 4 * v)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
          // old[q0 - 1] is the last value of the lane to the left
          float prev = __shfl_up_sync(0xffffffffu, x.w, 1, kVecs);
          if (!live) continue;
          if (v == 0 && a > 0) prev = below[r * kAStride + kQC - 1];
          float o[4] = {prev, x.x, x.y, x.z};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = q0 + e >= pp ? 1 : 0;
            if (q0 + e == c * pp) o[e] = xn[2 * r + c];   // a plane's slot 0
          }
          *reinterpret_cast<float4*>(line + (size_t)r * q_total + q0) =
              make_float4(o[0], o[1], o[2], o[3]);
        } else {
          // 8 slots as 4 words of 2 bf16; the low half of a word is the
          // lower slot
          const uint4 x = live ? *reinterpret_cast<const uint4*>(
                                     cur + r * kAStride + kVecLen * v)
                               : make_uint4(0u, 0u, 0u, 0u);
          // old[q0 - 1] is the last value of the lane to the left
          unsigned prev = __shfl_up_sync(0xffffffffu, x.w >> 16, 1, kVecs);
          if (!live) continue;
          if (v == 0 && a > 0)
            prev = *reinterpret_cast<const unsigned short*>(
                below + r * kAStride + kQC - 1);
          const unsigned in[4] = {x.x, x.y, x.z, x.w};
          unsigned short o[8];
          o[0] = static_cast<unsigned short>(prev);
#pragma unroll
          for (int e = 1; e < 8; ++e)
            o[e] = static_cast<unsigned short>(
                (e % 2 ? in[(e - 1) / 2] : in[(e - 1) / 2] >> 16) & 0xffffu);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int c = q0 + e >= pp ? 1 : 0;
            if (q0 + e == c * pp)                        // a plane's slot 0
              o[e] = *reinterpret_cast<const unsigned short*>(xn + 2 * r + c);
          }
          uint4 out;
          out.x = o[0] | (static_cast<unsigned>(o[1]) << 16);
          out.y = o[2] | (static_cast<unsigned>(o[3]) << 16);
          out.z = o[4] | (static_cast<unsigned>(o[5]) << 16);
          out.w = o[6] | (static_cast<unsigned>(o[7]) << 16);
          *reinterpret_cast<uint4*>(line + (size_t)r * q_total + q0) = out;
        }
      }
    };

    float acc[kTM][kTN];
#pragma unroll
    for (int t = 0; t < kTM; ++t)
#pragma unroll
      for (int k = 0; k < kTN; ++k) acc[t][k] = 0.f;

#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      if (i < chunks) load(i);
      commit();
    }
    for (int i = 0; i < chunks; ++i) {
      wait_pending<kAhead - 1>();           // this thread's copies of chunk i
      __syncthreads();                      // everyone's; stage i-2 is free
      if (i + kAhead < chunks) load(i + kAhead);
      commit();
      if (last && i > 0) write_back(i - 1);
      const T* as = smem + (i % kStages) * stage_elems<T, KT>();
      const T* bs = as + kRows * kAStride;
      if constexpr (std::is_same_v<T, float>) {
#pragma unroll 16
        for (int j = 0; j < kQC; ++j) {
          float av[kTM];
#pragma unroll
          for (int t = 0; t < kTM; ++t)
            av[t] = as[(rg + kRG * t) * kAStride + j];
#pragma unroll
          for (int v = 0; v < kNV; ++v) {
            const float4 b = *reinterpret_cast<const float4*>(
                bs + j * KT + 4 * (cg + kCG * v));
#pragma unroll
            for (int t = 0; t < kTM; ++t) {
              acc[t][4 * v + 0] = fmaf(av[t], b.x, acc[t][4 * v + 0]);
              acc[t][4 * v + 1] = fmaf(av[t], b.y, acc[t][4 * v + 1]);
              acc[t][4 * v + 2] = fmaf(av[t], b.z, acc[t][4 * v + 2]);
              acc[t][4 * v + 3] = fmaf(av[t], b.w, acc[t][4 * v + 3]);
            }
          }
        }
      } else {
        // bf16: two q per step (one 32-bit load per row), summed in the
        // same order
#pragma unroll 8
        for (int j = 0; j < kQC; j += 2) {
          float a0[kTM], a1[kTM];
#pragma unroll
          for (int t = 0; t < kTM; ++t) {
            const unsigned u = *reinterpret_cast<const unsigned*>(
                as + (rg + kRG * t) * kAStride + j);
            a0[t] = bf16_lo(u);
            a1[t] = bf16_hi(u);
          }
#pragma unroll
          for (int v = 0; v < kNV; ++v) {
            const int col = 4 * (cg + kCG * v);
            const float4 b0 = bf16x4(*reinterpret_cast<const uint2*>(
                bs + j * KT + col));
            const float4 b1 = bf16x4(*reinterpret_cast<const uint2*>(
                bs + (j + 1) * KT + col));
#pragma unroll
            for (int t = 0; t < kTM; ++t) {
              acc[t][4 * v + 0] = fmaf(a0[t], b0.x, acc[t][4 * v + 0]);
              acc[t][4 * v + 1] = fmaf(a0[t], b0.y, acc[t][4 * v + 1]);
              acc[t][4 * v + 2] = fmaf(a0[t], b0.z, acc[t][4 * v + 2]);
              acc[t][4 * v + 3] = fmaf(a0[t], b0.w, acc[t][4 * v + 3]);
            }
#pragma unroll
            for (int t = 0; t < kTM; ++t) {
              acc[t][4 * v + 0] = fmaf(a1[t], b1.x, acc[t][4 * v + 0]);
              acc[t][4 * v + 1] = fmaf(a1[t], b1.y, acc[t][4 * v + 1]);
              acc[t][4 * v + 2] = fmaf(a1[t], b1.z, acc[t][4 * v + 2]);
              acc[t][4 * v + 3] = fmaf(a1[t], b1.w, acc[t][4 * v + 3]);
            }
          }
        }
      }
    }
    if (last) write_back(chunks - 1);

    // m = the chunks' sums + x_new * rhs[f, c, 0]
#pragma unroll
    for (int t = 0; t < kTM; ++t) {
      const int r = rg + kRG * t;
      if (r >= rows) continue;
      float* out = m + ((size_t)f * vi_count + row0 + r) * kod + col0;
      float x0, x1;
      if constexpr (std::is_same_v<T, float>) {
        x0 = xn[2 * r];
        x1 = xn[2 * r + 1];
      } else {
        const unsigned u = *reinterpret_cast<const unsigned*>(xn + 2 * r);
        x0 = bf16_lo(u);
        x1 = bf16_hi(u);
      }
#pragma unroll
      for (int v = 0; v < kNV; ++v) {
        const int col = 4 * (cg + kCG * v);
        if (col >= cols) continue;
        float4 h0, h1;
        if constexpr (std::is_same_v<T, float>) {
          h0 = __ldg(reinterpret_cast<const float4*>(rhs_f + col0 + col));
          h1 = __ldg(reinterpret_cast<const float4*>(
              rhs_f + (size_t)pp * kod + col0 + col));
        } else {
          h0 = bf16x4(__ldg(reinterpret_cast<const uint2*>(
              rhs_f + col0 + col)));
          h1 = bf16x4(__ldg(reinterpret_cast<const uint2*>(
              rhs_f + (size_t)pp * kod + col0 + col)));
        }
        float4 o;
        o.x = fmaf(x1, h1.x, fmaf(x0, h0.x, acc[t][4 * v + 0]));
        o.y = fmaf(x1, h1.y, fmaf(x0, h0.y, acc[t][4 * v + 1]));
        o.z = fmaf(x1, h1.z, fmaf(x0, h0.z, acc[t][4 * v + 2]));
        o.w = fmaf(x1, h1.w, fmaf(x0, h0.w, acc[t][4 * v + 3]));
        *reinterpret_cast<float4*>(out + col) = o;
      }
    }
  }
}

template <typename T, int KT>
cudaError_t launch(T* a, const T* xn, const T* b, float* out, int f, int vi,
                   int pp, int kod, cudaStream_t s) {
  constexpr size_t smem = kStages * stage_elems<T, KT>() * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      mac_shift_kernel<T, KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const unsigned blocks =
      static_cast<unsigned>(f) * static_cast<unsigned>((vi + kRows - 1) / kRows);
  mac_shift_kernel<T, KT><<<blocks, kThreads, smem, s>>>(a, xn, b, out, vi,
                                                         pp, kod);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
int dispatch(void* fdl, const void* x_new, const void* rhs, void* m, int f,
             int vi, int pp, int kod, void* stream) {
  // a row of fdl is Q = 2 * pp values: 16-byte aligned rows; a bf16
  // x_new row of 2 values is read as one 32-bit word
  constexpr int kPpMultiple = 8 / static_cast<int>(sizeof(T));
  if (f <= 0 || vi <= 0 || pp <= 0 || kod <= 0 || pp % kPpMultiple ||
      kod % 4 || !aligned16(fdl) || !aligned16(rhs) || !aligned16(m) ||
      (sizeof(T) == 2 && reinterpret_cast<uintptr_t>(x_new) % 4))
    return static_cast<int>(cudaErrorInvalidValue);
  T* a = static_cast<T*>(fdl);
  const T* xn = static_cast<const T*>(x_new);
  const T* b = static_cast<const T*>(rhs);
  float* out = static_cast<float*>(m);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kod <= 16)
    return static_cast<int>(launch<T, 16>(a, xn, b, out, f, vi, pp, kod, s));
  if (kod <= 32)
    return static_cast<int>(launch<T, 32>(a, xn, b, out, f, vi, pp, kod, s));
  if (kod <= 48)
    return static_cast<int>(launch<T, 48>(a, xn, b, out, f, vi, pp, kod, s));
  return static_cast<int>(launch<T, 64>(a, xn, b, out, f, vi, pp, kod, s));
}

}  // namespace

// fdl f32 [f, vi, 2, pp], shifted in place; x_new f32 [f, vi, 2, 1];
// rhs f32 [f, 2, pp, kod]; m f32 [f, vi, kod]. pp must be even, kod a
// multiple of 4, and fdl, rhs and m 16-byte aligned. Returns a cudaError_t:
// the launch's, or cudaErrorInvalidValue for arguments the kernel does not
// take.
extern "C" int mac_shift_launch(void* fdl, const void* x_new, const void* rhs,
                                void* m, int f, int vi, int pp, int kod,
                                void* stream) {
  return dispatch<float>(fdl, x_new, rhs, m, f, vi, pp, kod, stream);
}

// The same with fdl, x_new and rhs bf16 (m f32): pp must be a multiple of 4.
extern "C" int mac_shift_bf16_launch(void* fdl, const void* x_new,
                                     const void* rhs, void* m, int f, int vi,
                                     int pp, int kod, void* stream) {
  return dispatch<__nv_bfloat16>(fdl, x_new, rhs, m, f, vi, pp, kod, stream);
}

extern "C" const char* mac_shift_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
