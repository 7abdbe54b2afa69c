// Ring-pointer all-K partition MAC for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpu_audio/ops/pallas_mac.py:ring_mac
// (kernel _ring_mac_kernel), the MAC of tpu_audio/engine/fmajor.py's ring
// mode. For every frequency bin f, delay-line row vi (voice x input
// channel) and bank output column kod:
//
//     m[f, vi, kod] = sum_{c, s} fdl[f, vi, c, s] * rhs2[f, c, Pp - w + s, kod]
//
// with w = wptr mod Pp the newest ring slot, fdl f32 [F, VI, 2, Pp] (the
// engine's layout: each row is one contiguous run of Q = 2*Pp values,
// q = c*Pp + s) and rhs2 f32 [F, 2, 2*Pp, KOD] the doubled, time-reversed
// bank. The window [Pp - w, 2*Pp - w) of each plane pairs slot s with bank
// partition (w - s) mod Pp.
//
// What bounds it on an H100. A call must read the delay line once (183 MB
// at 64 voices: F=257, VI=128, Pp=696), the rhs window once (F * 2Pp * KOD
// * 4 B: 23 MB at KOD=16, 92 MB at KOD=64) and write m, against
// 2*F*VI*2Pp*KOD FLOP. At KOD 16 and 36 that is 7 and 14 FLOP/byte: bytes
// bound it (208 MB ~ 62 us, 239 MB ~ 72 us at 3.35 TB/s). At KOD=64 it is
// 20.7 FLOP/byte, on the card's f32 CUDA-core ridge (67 TFLOP/s / 3.35
// TB/s = 20): 5.86 GFLOP ~ 88 us and 283 MB ~ 85 us, so the copies and the
// FMAs must overlap almost fully to come near either.
//
// Design against that bound:
//   - a block owns one bin f, a tile of kRows = 128 delay-line rows (all VI
//     rows at 64 voices: 257 blocks, two resident per SM, one wave) and ALL
//     the KOD columns of those rows, so the line is read exactly once at
//     every KOD <= 64. The column tile KT is 16, 32, 48 or 64, the least
//     that covers KOD; columns past KOD are zero-filled, never stored;
//   - the block streams the reduction axis q in chunks of kQC = 32 through
//     a ring of kStages = 4 shared-memory stages filled with cp.async (16
//     bytes, L2 only), three chunks in flight while one is computed. A
//     stage holds the chunk's fdl tile [128 rows][32 q] (row stride kQC + 4
//     floats, so a warp's rows fall in distinct banks) and its window tile
//     [32 q][KT]: window row q is rhs2[f, c, Pp - w + s] with c = (q >= Pp)
//     and s = q - c*Pp, computed per row, so a chunk that straddles the
//     plane boundary needs nothing special. cp.async's zero-fill form covers
//     the ragged last chunk, the masked rows and columns. Shared memory is
//     fixed (104 KB at KT = 64) whatever Pp is: no line is too long. Each
//     thread's copies of the next chunk go out two q steps apart among the
//     chunk's FMAs, not in one burst after the barrier: a warp that meets a
//     full copy queue stalls, and with a burst every warp stalls at once;
//   - the ring slot is read from a device int32 (the engine's block
//     counter), the counterpart of Pallas scalar prefetch: the host never
//     syncs to learn it, and every block computes its own window start;
//   - the FMAs are bound by shared memory, not by the FMA units, unless a
//     thread's register tile is large: every 128-bit shared load costs 4 of
//     the SM's 128-byte-per-clock cycles whether or not the warp's lanes
//     share addresses, so a thread with a kTM x kTN tile needs kTM + kTN
//     floats per q for kTM * kTN FMAs, and the SM keeps its 128 FMA lanes
//     busy only if that is <= 1/4 (measured on the H100: 2 x 4, 2 x 12 and
//     4 x 8 tiles ran the FMAs alone at 1/3, 2/5 and 3/5 of the f32 peak).
//     So the block's 256 threads form two groups of 128, each taking one
//     half (16 q) of every chunk, and a thread keeps an 8 x 8 tile of the
//     [128, 64] output at KT = 64 (4 x 12, 4 x 8, 4 x 4 at KT = 48, 32,
//     16), read outer-product style: per q, kTM fdl values (one per row)
//     and kTN/4 float4 of the window. The two groups' sums are added once,
//     through shared memory, at the end;
//   - f32 FMA on the CUDA cores only: no TF32, no tensor cores (the port
//     keeps full f32 on value-carrying products). Each group's sum over
//     half of q then the one add make a two-level sum;
//   - m is stored with aligned 16-byte stores.
//
// What is left (measured on the H100 at 64 voices): the copies alone run at
// ~2.4 TB/s (100 / 112 us at KOD 36 / 64), the FMAs alone at ~63 % of the
// f32 peak (105 / 140 us), and together they take ~152 / ~190 us: the
// copies stall the warps that issue them. One extra warp that issues every
// copy overlaps them better, but a ninth warp caps registers at 96 (spills),
// and 128 compute threads per block leave too few warps for the FMAs; both
// measured slower, as did loading the fdl tile with one 2-D tensor copy
// (TMA) per chunk.
//
// KOD > 64 (only an explicit 'allk' with more than 16 IRs): column groups
// of 64 go to separate blocks (grid y), each re-reading the line. That is
// race-free, since nothing is written in place.
//
// bf16 operands (mac_dtype='bf16'; JAX runs that MAC as the einsum the
// Pallas kernel stands for, bf16 operands with preferred_element_type f32,
// tpu_audio/engine/fmajor.py:908-923): the kernel is a template on the
// operand type T, float or __nv_bfloat16. With T = bf16 the line and the
// window are bf16 in device memory and in shared memory (a 16-byte copy
// carries 8 values, so a stage takes half the shared memory: 56 KB at KT =
// 64), each value becomes an f32 as it leaves shared memory (exact: a bf16
// is the top half of a float), and the products, sums and m stay f32 as in
// the f32 form: bf16 x bf16 products are exact in f32, so m differs from
// the f32 MAC of the upcast operands only in the order of the sums. A
// thread reads two q of a row in one 32-bit load and four window columns
// in one 8-byte load. The window is copied in 8-byte vectors of 4 columns
// (a row of rhs2 starts on 8 bytes, not 16, when KOD % 8 == 4). The bound:
// the line is half the bytes (91.6 MB at 64 voices), so at KOD 36 and 64
// the f32 FMAs (49.2 and 87.5 us at 67 TFLOP/s) bound it, not the bytes
// (36.5 and 43.5 us); tensor-core MMA (bf16 in, f32 accumulate) is left
// for a later design.
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
constexpr int kGroup = 128;                 // threads of one q group
constexpr int kRows = 128;                  // delay-line rows per block
constexpr int kQC = 32;                     // q per chunk
constexpr int kStages = 4;                  // depth of the cp.async ring

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
ring_mac_kernel(const int* __restrict__ wptr, const T* __restrict__ fdl,
                const T* __restrict__ rhs2, float* __restrict__ m,
                int vi_count, int pp, int kod) {
  constexpr int kCG = KT == 64 ? 8 : 4;     // column groups of the tile
  constexpr int kNV = KT / (4 * kCG);       // 4-column vectors per thread
  constexpr int kTN = 4 * kNV;              // columns per thread
  constexpr int kRG = kGroup / kCG;         // row groups of the tile
  constexpr int kTM = kRows / kRG;          // rows per thread
  constexpr int kAStride = a_stride<T>();
  constexpr int kVecLen = 16 / static_cast<int>(sizeof(T));  // per 16 B
  constexpr int kVecs = kQC / kVecLen;      // 16-byte vectors per row of a
                                            // chunk
  constexpr int kHalf = kQC / 2;            // q of a chunk per group
  extern __shared__ __align__(16) float smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int row_tiles = (vi_count + kRows - 1) / kRows;
  const int f = blockIdx.x / row_tiles;
  const int row0 = (blockIdx.x - f * row_tiles) * kRows;
  const int rows = min(kRows, vi_count - row0);
  const int col0 = blockIdx.y * KT;
  const int cols = min(KT, kod - col0);
  const int q_total = 2 * pp;
  const int chunks = (q_total + kQC - 1) / kQC;
  const int tid = threadIdx.x;
  const int group = tid / kGroup;           // which half of each chunk
  const int gtid = tid % kGroup;
  const int cg = gtid % kCG;                // a warp's lanes: kCG column
  const int rg = gtid / kCG;                // groups x consecutive rows

  int w = wptr[0] % pp;
  if (w < 0) w += pp;
  const int start = pp - w;                 // window row of slot 0

  const T* line = fdl + ((size_t)f * vi_count + row0) * q_total;
  const T* rhs_f = rhs2 + (size_t)f * 2 * q_total * kod + col0;

  // copy k of this thread for chunk i, q in [i * kQC, (i + 1) * kQC), into
  // stage i % kStages: the chunk's kFdlCopies fdl vectors, then its window
  // vectors, kThreads apart
  constexpr int kFdlCopies = kRows * kVecs;
  constexpr int kCopies =                   // per thread and chunk
      (kFdlCopies + kQC * KT / 4 + kThreads - 1) / kThreads;
  auto copy = [&](int i, int k) {
    const int a = i * kQC;
    T* as = smem + (i % kStages) * stage_elems<T, KT>();
    const int e = tid + k * kThreads;
    if (e < kFdlCopies) {
      const int r = e / kVecs;
      const int qq = kVecLen * (e % kVecs);
      const bool ok = r < rows && a + qq < q_total;
      copy16(as + r * kAStride + qq,
             ok ? line + (size_t)r * q_total + a + qq : fdl, ok);
    } else if (e - kFdlCopies < kQC * KT / 4) {
      const int j = (e - kFdlCopies) / (KT / 4);
      const int col = 4 * ((e - kFdlCopies) % (KT / 4));
      const int q = a + j;
      const int c = q >= pp ? 1 : 0;
      const bool ok = q < q_total && col < cols;
      const size_t row = (size_t)c * q_total + start + (q - c * pp);
      copy_vec<4 * static_cast<int>(sizeof(T))>(
          as + kRows * kAStride + j * KT + col,
          ok ? rhs_f + row * kod + col : rhs2, ok);
    }
  };

  float acc[kTM][kTN];
#pragma unroll
  for (int t = 0; t < kTM; ++t)
#pragma unroll
    for (int k = 0; k < kTN; ++k) acc[t][k] = 0.f;

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < chunks)
#pragma unroll
      for (int k = 0; k < kCopies; ++k) copy(i, k);
    commit();
  }
  for (int i = 0; i < chunks; ++i) {
    wait_pending<kStages - 2>();            // this thread's copies of chunk i
    __syncthreads();                        // everyone's; stage i-1 is free
    const bool ahead = i + kStages - 1 < chunks;
    const T* as = smem + (i % kStages) * stage_elems<T, KT>();
    const T* bs = as + kRows * kAStride;
    if constexpr (std::is_same_v<T, float>) {
#pragma unroll 8                            // a full unroll spills at KT 48, 64
      for (int jj = 0; jj < kHalf; ++jj) {
        // the next chunk's copies, two steps apart
        if (jj % 2 == 0 && jj / 2 < kCopies && ahead)
          copy(i + kStages - 1, jj / 2);
        const int j = group * kHalf + jj;
        float x[kTM];
#pragma unroll
        for (int t = 0; t < kTM; ++t) x[t] = as[(rg + kRG * t) * kAStride + j];
#pragma unroll
        for (int v = 0; v < kNV; ++v) {
          const float4 b = *reinterpret_cast<const float4*>(
              bs + j * KT + 4 * (cg + kCG * v));
#pragma unroll
          for (int t = 0; t < kTM; ++t) {
            acc[t][4 * v + 0] = fmaf(x[t], b.x, acc[t][4 * v + 0]);
            acc[t][4 * v + 1] = fmaf(x[t], b.y, acc[t][4 * v + 1]);
            acc[t][4 * v + 2] = fmaf(x[t], b.z, acc[t][4 * v + 2]);
            acc[t][4 * v + 3] = fmaf(x[t], b.w, acc[t][4 * v + 3]);
          }
        }
      }
    } else {
      // bf16: two q per step (one 32-bit load per row), the copies one
      // step (two q) apart, as above; q is summed in the same order
#pragma unroll 4
      for (int jp = 0; jp < kHalf / 2; ++jp) {
        if (jp < kCopies && ahead) copy(i + kStages - 1, jp);
        const int j = group * kHalf + 2 * jp;
        float x0[kTM], x1[kTM];
#pragma unroll
        for (int t = 0; t < kTM; ++t) {
          const unsigned u = *reinterpret_cast<const unsigned*>(
              as + (rg + kRG * t) * kAStride + j);
          x0[t] = bf16_lo(u);
          x1[t] = bf16_hi(u);
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
            acc[t][4 * v + 0] = fmaf(x0[t], b0.x, acc[t][4 * v + 0]);
            acc[t][4 * v + 1] = fmaf(x0[t], b0.y, acc[t][4 * v + 1]);
            acc[t][4 * v + 2] = fmaf(x0[t], b0.z, acc[t][4 * v + 2]);
            acc[t][4 * v + 3] = fmaf(x0[t], b0.w, acc[t][4 * v + 3]);
          }
#pragma unroll
          for (int t = 0; t < kTM; ++t) {
            acc[t][4 * v + 0] = fmaf(x1[t], b1.x, acc[t][4 * v + 0]);
            acc[t][4 * v + 1] = fmaf(x1[t], b1.y, acc[t][4 * v + 1]);
            acc[t][4 * v + 2] = fmaf(x1[t], b1.z, acc[t][4 * v + 2]);
            acc[t][4 * v + 3] = fmaf(x1[t], b1.w, acc[t][4 * v + 3]);
          }
        }
      }
    }
    commit();
  }

  // add the two groups' sums: group 1 parks its tile in the (now idle)
  // stages, thread by thread, and group 0 adds it and stores m
  wait_pending<0>();
  __syncthreads();
  float4* park = reinterpret_cast<float4*>(smem_raw);
  if (group == 1) {
#pragma unroll
    for (int t = 0; t < kTM; ++t)
#pragma unroll
      for (int v = 0; v < kNV; ++v)
        park[(t * kNV + v) * kGroup + gtid] =
            make_float4(acc[t][4 * v + 0], acc[t][4 * v + 1],
                        acc[t][4 * v + 2], acc[t][4 * v + 3]);
  }
  __syncthreads();
  if (group == 1) return;
#pragma unroll
  for (int t = 0; t < kTM; ++t) {
    const int r = rg + kRG * t;
    if (r >= rows) continue;
    float* out = m + ((size_t)f * vi_count + row0 + r) * kod + col0;
#pragma unroll
    for (int v = 0; v < kNV; ++v) {
      const int col = 4 * (cg + kCG * v);
      if (col >= cols) continue;
      const float4 o = park[(t * kNV + v) * kGroup + gtid];
      *reinterpret_cast<float4*>(out + col) =
          make_float4(acc[t][4 * v + 0] + o.x, acc[t][4 * v + 1] + o.y,
                      acc[t][4 * v + 2] + o.z, acc[t][4 * v + 3] + o.w);
    }
  }
}

template <typename T, int KT>
cudaError_t launch(const int* w, const T* a, const T* b, float* out, int f,
                   int vi, int pp, int kod, cudaStream_t s) {
  constexpr size_t smem = kStages * stage_elems<T, KT>() * sizeof(T);
  static_assert(smem >= KT * kRows * sizeof(float),
                "the stages must hold group 1's parked sums");
  cudaError_t err = cudaFuncSetAttribute(
      ring_mac_kernel<T, KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const unsigned row_tiles = static_cast<unsigned>((vi + kRows - 1) / kRows);
  const dim3 grid(static_cast<unsigned>(f) * row_tiles,
                  static_cast<unsigned>((kod + KT - 1) / KT));
  ring_mac_kernel<T, KT><<<grid, kThreads, smem, s>>>(w, a, b, out, vi, pp,
                                                      kod);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
int dispatch(const void* wptr, const void* fdl, const void* rhs2, void* m,
             int f, int vi, int pp, int kod, void* stream) {
  // a row of fdl is Q = 2 * pp values: 16-byte aligned rows
  constexpr int kPpMultiple = 8 / static_cast<int>(sizeof(T));
  if (f <= 0 || vi <= 0 || pp <= 0 || kod <= 0 || pp % kPpMultiple ||
      kod % 4 || !aligned16(fdl) || !aligned16(rhs2) || !aligned16(m))
    return static_cast<int>(cudaErrorInvalidValue);
  const int* w = static_cast<const int*>(wptr);
  const T* a = static_cast<const T*>(fdl);
  const T* b = static_cast<const T*>(rhs2);
  float* out = static_cast<float*>(m);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kod <= 16)
    return static_cast<int>(launch<T, 16>(w, a, b, out, f, vi, pp, kod, s));
  if (kod <= 32)
    return static_cast<int>(launch<T, 32>(w, a, b, out, f, vi, pp, kod, s));
  if (kod <= 48)
    return static_cast<int>(launch<T, 48>(w, a, b, out, f, vi, pp, kod, s));
  return static_cast<int>(launch<T, 64>(w, a, b, out, f, vi, pp, kod, s));
}

}  // namespace

// wptr: device int32 block counter (reduced mod pp in the kernel);
// fdl f32 [f, vi, 2, pp]; rhs2 f32 [f, 2, 2*pp, kod]; m f32 [f, vi, kod].
// pp must be even, kod a multiple of 4, and fdl, rhs2 and m 16-byte
// aligned. Returns a cudaError_t: the launch's, or cudaErrorInvalidValue
// for arguments the kernel does not take.
extern "C" int ring_mac_launch(const void* wptr, const void* fdl,
                               const void* rhs2, void* m, int f, int vi,
                               int pp, int kod, void* stream) {
  return dispatch<float>(wptr, fdl, rhs2, m, f, vi, pp, kod, stream);
}

// The same with fdl and rhs2 bf16 (m f32): pp must be a multiple of 4.
extern "C" int ring_mac_bf16_launch(const void* wptr, const void* fdl,
                                    const void* rhs2, void* m, int f, int vi,
                                    int pp, int kod, void* stream) {
  return dispatch<__nv_bfloat16>(wptr, fdl, rhs2, m, f, vi, pp, kod, stream);
}

extern "C" const char* ring_mac_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
