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
// Small row counts (VI not a multiple of 128: a roll session whose voice
// count is no multiple of 64, e.g. 96 voices, VI = 192; a voice-sharded
// roll shard, VI = 64 at 64 voices over voice = 2). A 128-row tile there
// copies, zero-fills and multiplies rows that are dropped. So the f32 form
// takes tiles of kSmallRows = 64 rows in a kernel of its own,
// mac_shift_small_kernel, and so does every VI at KOD <= 16, where two
// 64-row tiles ran the 64-voice line (VI = 128) 3.5 % faster than one
// 128-row tile on the H100. The 128-row kernel stays as it was for VI a
// multiple of 128 at KOD > 16, where the small tiles, each reading its
// bin's rhs, ran 10 % (KOD 36) and 29 % (KOD 64) slower:
//   - VI > 64 splits evenly into ceil(VI / 64) row tiles per bin (VI = 192:
//     3 x 64; measured on the H100, 3 x 64 rows took 251 us against 279
//     for a 128-row tile plus a 64-row one in two launches, at KOD 16);
//     a tile holds one bin, whatever VI;
//   - a block keeps 256 threads; a thread's register tile is 2 rows by KT
//     / 8 columns in float2 pairs (2 x 2 at KT = 16 to 2 x 8 at KT = 64:
//     fewer shared-memory bytes per FMA than half of the 128-row tiles'
//     4 x 8 or 2 x 4), and a thread whose rows lie past VI multiplies
//     nothing; rows past VI are neither copied nor written;
//   - the ring is kSmallStages = 6 chunks deep, four in flight (a ring of
//     4 measured 2-7 % slower at VI = 192, VI = 8 and VI = 64 at KOD 64,
//     2-5 % faster at VI = 64, KOD 16), and the line copies ask L2 for the
//     256 bytes around each 16 (without it, up to 6 % slower);
//   - the walk, the one-late write-back and the order of every output's
//     sum are the 128-row kernel's (32-q chunks from the tail, q ascending
//     within one, the x_new terms last), so every output keeps its bits.
//
// bf16 operands (mac_dtype='bf16'): a kernel of its own,
// mac_shift_bf16_kernel. The line, x_new and rhs are bf16 (JAX casts the
// new block spectrum to bf16 before it enters the line,
// tpu_audio/engine/fmajor.py:730) and the shifted line is written back in
// bf16, bit for bit the values it read; m is f32. The Pallas kernel
// declares its aliased line f32, so JAX runs bf16 roll mode as the roll
// plus the einsum at fmajor.py:920-923; this kernel stands for that pair.
// bf16 x bf16 products are exact in f32, so the product runs on the tensor
// cores with f32 accumulators, the core of ring_mac's bf16 form
// (csrc/ring_mac.cu, mma_bf16.cuh). VI is cut into 16-row warp slabs, and
// a bin's slabs split evenly into row tiles of at most 8 (VI = 128: one
// tile of 8, VI = 64: one of 4, VI = 192: 2 x 6); only the tile's slabs
// are staged, copied, multiplied and written. Each slab's warp takes 16
// rows by all KT columns of the chunk, ldmatrix.x4 of the [16 x slabs]
// [kBQC] line tile (row stride kBQC + 8 bf16, 144 bytes: ldmatrix's rows
// in distinct banks; the write-back reads the same tile) and
// ldmatrix.x4.trans of the pre-shifted rhs tile (row stride KT + 8),
// mma.sync.m16n8k16 bf16 -> f32, each chunk's product summed from zero and
// added into the running f32 sums (a two-level sum). Every block keeps 8
// warps for the copies and the write-back: blocks of one warp per slab ran
// VI = 64 (Pp = 348, KOD 16) at 27.5 us against 22.6, whatever their ring
// depth. The walk, the pre-shifted tile, the write-back and the race guard
// are the f32 form's: the write-back moves 16-byte runs of 8 slots, each
// lane taking the slot before its run from the lane to its left
// (__shfl_up_sync within the row's 8 lanes) or, for the first lane, from
// the chunk below; every lane of a warp takes part in each shuffle.
// With no unpacking and no FMAs left the copies bound it, so a chunk is
// kBQC = 64 q, 128 bytes of each line row as in the f32 form (32-q chunks
// of 64-byte runs measured ~10 % slower on the H100), and the line copies
// ask L2 for the 256-byte block around each 16 bytes (copy16_l2pf):
// kBStages = 4 stages of up to 28 KB at KT = 64 (a 6-chunk ring measured
// no faster), two chunks in flight (kBAhead) while one is multiplied and
// the one above it written back. The rhs tile moves in 16-byte copies of 8
// columns when KOD % 8 == 0, else in 8-byte copies of 4 (a row of rhs then
// starts on 8 bytes only). The bound: bytes, the line read and written in
// half the f32 bytes, 58.8 / 63.8 / 70.9 us at KOD 16 / 36 / 64 (64
// voices).
//
// Alignment: fdl rows start on 16 bytes only if Q values (4 bytes each in
// f32, 2 in bf16) make a multiple of 16, so the launch refuses an odd Pp
// for f32 and a Pp that is not a multiple of 4 for bf16 (the engine pads Pp
// to a multiple of 8).
// The launch allocates nothing and does not synchronise; it returns a
// cudaError_t so the caller can raise. It picks the tiles from VI and KOD;
// each kernel's shared-memory ceiling is raised once per device, not at
// every launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

#include "cp_async.cuh"
#include "launch_once.cuh"
#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kRows = 128;                  // delay-line rows per block
constexpr int kQC = 32;                     // q per chunk
constexpr int kStages = 4;                  // depth of the cp.async ring
constexpr int kAhead = kStages - 2;         // chunks in flight
// fdl tile row stride in floats: the chunk plus one 16-byte vector, so a
// warp's rows fall in distinct banks
constexpr int kAStride = kQC + 4;

template <int KT>
__host__ __device__ constexpr int stage_elems() {
  return kRows * kAStride + kQC * KT;
}

template <int KT>
__global__ void __launch_bounds__(kThreads, 2)
mac_shift_kernel(float* __restrict__ fdl, const float* __restrict__ x_new,
                 const float* __restrict__ rhs, float* __restrict__ m,
                 int vi_count, int pp, int kod) {
  constexpr int kCG = KT == 64 ? 8 : 4;     // column groups of the tile
  constexpr int kNV = KT / (4 * kCG);       // 4-column vectors per thread
  constexpr int kTN = 4 * kNV;              // columns per thread
  constexpr int kRG = kThreads / kCG;       // row groups of the tile
  constexpr int kTM = kRows / kRG;          // rows per thread
  constexpr int kVecs = kQC / 4;            // 16-byte vectors per row of a
                                            // chunk
  extern __shared__ __align__(16) float smem_raw[];
  float* smem = smem_raw;

  const int row_tiles = (vi_count + kRows - 1) / kRows;
  const int f = blockIdx.x / row_tiles;
  const int row0 = (blockIdx.x - f * row_tiles) * kRows;
  const int rows = min(kRows, vi_count - row0);
  const int q_total = 2 * pp;
  const int chunks = (q_total + kQC - 1) / kQC;
  const int tid = threadIdx.x;
  const int cg = tid % kCG;                 // a warp's lanes: kCG column
  const int rg = tid / kCG;                 // groups x consecutive rows

  float* line = fdl + ((size_t)f * vi_count + row0) * q_total;
  const float* xn = x_new + ((size_t)f * vi_count + row0) * 2;
  const float* rhs_f = rhs + (size_t)f * q_total * kod;

  for (int col0 = 0; col0 < kod; col0 += KT) {
    const int cols = min(KT, kod - col0);
    const bool last = col0 + KT >= kod;
    if (col0 > 0) __syncthreads();          // every thread is off the ring

    // chunk i of the walk, [a, a + kQC) with a = (chunks - 1 - i) * kQC,
    // into stage i % kStages
    auto load = [&](int i) {
      const int a = (chunks - 1 - i) * kQC;
      float* as = smem + (i % kStages) * stage_elems<KT>();
      float* bs = as + kRows * kAStride;
      for (int e = tid; e < kRows * kVecs; e += kThreads) {
        const int r = e / kVecs;
        const int qq = 4 * (e % kVecs);
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
        copy16(bs + j * KT + col,
               ok ? rhs_f + (size_t)(q + 1) * kod + col0 + col : rhs, ok);
      }
    };

    // the shifted slots of chunk i, from its stage and that of chunk i + 1
    // (the chunk below, whose last slot is old[a - 1]); lanes: kVecs
    // float4 of a row x kThreads / kVecs rows
    auto write_back = [&](int i) {
      const int a = (chunks - 1 - i) * kQC;
      const float* cur = smem + (i % kStages) * stage_elems<KT>();
      const float* below = smem + ((i + 1) % kStages) * stage_elems<KT>();
      const int v = tid % kVecs;
      const int q0 = a + 4 * v;
      for (int r0 = 0; r0 < rows; r0 += kThreads / kVecs) {
        const int r = r0 + tid / kVecs;
        const bool live = r < rows && q0 < q_total;
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
      const float* as = smem + (i % kStages) * stage_elems<KT>();
      const float* bs = as + kRows * kAStride;
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
    }
    if (last) write_back(chunks - 1);

    // m = the chunks' sums + x_new * rhs[f, c, 0]
#pragma unroll
    for (int t = 0; t < kTM; ++t) {
      const int r = rg + kRG * t;
      if (r >= rows) continue;
      float* out = m + ((size_t)f * vi_count + row0 + r) * kod + col0;
      const float x0 = xn[2 * r];
      const float x1 = xn[2 * r + 1];
#pragma unroll
      for (int v = 0; v < kNV; ++v) {
        const int col = 4 * (cg + kCG * v);
        if (col >= cols) continue;
        const float4 h0 =
            __ldg(reinterpret_cast<const float4*>(rhs_f + col0 + col));
        const float4 h1 = __ldg(reinterpret_cast<const float4*>(
            rhs_f + (size_t)pp * kod + col0 + col));
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

// -- f32 at fewer rows ------------------------------------------------------

constexpr int kSmallRows = 64;              // rows of a small tile
constexpr int kSmallStages = 6;             // depth of a small tile's ring
constexpr int kSmallAhead = kSmallStages - 2;   // chunks in flight
constexpr int kSmallCG = 8;                 // column groups of a small tile
constexpr int kSmallRG = kThreads / kSmallCG;   // its row groups
constexpr int kSmallTM = kSmallRows / kSmallRG; // rows per thread

// a small tile's stage: its line rows, then the pre-shifted rhs tile
template <int KT>
__host__ __device__ constexpr int small_stage_elems() {
  return kSmallRows * kAStride + kQC * KT;
}

// A block: row tile blockIdx.x % row_tiles (tile_rows rows) of bin
// blockIdx.x / row_tiles. The 128-row kernel's walk, write-back and order
// of sums; a thread keeps 2 rows by KT / 8 columns, its columns in float2
// pairs. Rows past VI are neither copied nor written, and a thread whose
// rows all lie past them multiplies nothing
template <int KT>
__global__ void __launch_bounds__(kThreads, 2)
mac_shift_small_kernel(float* __restrict__ fdl,
                       const float* __restrict__ x_new,
                       const float* __restrict__ rhs, float* __restrict__ m,
                       int vi_count, int pp, int kod, int tile_rows,
                       int row_tiles) {
  constexpr int kCG = kSmallCG;
  constexpr int kRG = kSmallRG;
  constexpr int kTM = kSmallTM;
  constexpr int kNV = KT / (2 * kCG);       // float2 pairs a thread
  constexpr int kTN = 2 * kNV;              // columns per thread
  constexpr int kVecs = kQC / 4;            // 16-byte vectors per row of a
                                            // chunk
  constexpr int kRing = kSmallStages;
  constexpr int kStage = small_stage_elems<KT>();
  extern __shared__ __align__(16) float smem_raw[];
  float* smem = smem_raw;

  const int f = blockIdx.x / row_tiles;
  const int row0 = (blockIdx.x - f * row_tiles) * tile_rows;
  const int rows = min(tile_rows, vi_count - row0);
  const int q_total = 2 * pp;
  const int chunks = (q_total + kQC - 1) / kQC;
  const int tid = threadIdx.x;
  const int cg = tid % kCG;                 // a warp's lanes: kCG column
  const int rg = tid / kCG;                 // groups x consecutive rows
  const bool computes = rg < rows;

  float* line = fdl + ((size_t)f * vi_count + row0) * q_total;
  const float* xn = x_new + ((size_t)f * vi_count + row0) * 2;
  const float* rhs_f = rhs + (size_t)f * q_total * kod;

  for (int col0 = 0; col0 < kod; col0 += KT) {
    const int cols = min(KT, kod - col0);
    const bool last = col0 + KT >= kod;
    if (col0 > 0) __syncthreads();          // every thread is off the ring

    // chunk i of the walk, [a, a + kQC) with a = (chunks - 1 - i) * kQC,
    // into stage i % kRing: the tile's line vectors (each also asking L2
    // for the 256 bytes around it), then the pre-shifted rhs tile
    auto load = [&](int i) {
      const int a = (chunks - 1 - i) * kQC;
      float* as = smem + (i % kRing) * kStage;
      for (int e = tid; e < rows * kVecs; e += kThreads) {
        const int r = e / kVecs;
        const int qq = 4 * (e % kVecs);
        const bool ok = a + qq < q_total;
        copy16_l2pf(as + r * kAStride + qq,
                    ok ? line + (size_t)r * q_total + a + qq : fdl, ok);
      }
      float* bs = as + kSmallRows * kAStride;
      for (int e = tid; e < kQC * (KT / 4); e += kThreads) {
        const int j = e / (KT / 4);
        const int col = 4 * (e % (KT / 4));
        const int q = a + j;
        const int s = q >= pp ? q - pp : q;
        const bool ok = q < q_total && s + 1 < pp && col < cols;
        copy16(bs + j * KT + col,
               ok ? rhs_f + (size_t)(q + 1) * kod + col0 + col : rhs, ok);
      }
    };

    // the shifted slots of chunk i, from its stage and that of chunk i + 1
    // (the chunk below, whose last slot is old[a - 1]); lanes: kVecs
    // float4 of a row x kThreads / kVecs rows
    auto write_back = [&](int i) {
      const int a = (chunks - 1 - i) * kQC;
      const float* cur = smem + (i % kRing) * kStage;
      const float* below = smem + ((i + 1) % kRing) * kStage;
      const int v = tid % kVecs;
      const int q0 = a + 4 * v;
      for (int r0 = 0; r0 < rows; r0 += kThreads / kVecs) {
        const int r = r0 + tid / kVecs;
        const bool live = r < rows && q0 < q_total;
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
      }
    };

    float acc[kTM][kTN];
#pragma unroll
    for (int t = 0; t < kTM; ++t)
#pragma unroll
      for (int k = 0; k < kTN; ++k) acc[t][k] = 0.f;

#pragma unroll
    for (int i = 0; i < kSmallAhead; ++i) {
      if (i < chunks) load(i);
      commit();
    }
    for (int i = 0; i < chunks; ++i) {
      wait_pending<kSmallAhead - 1>();      // this thread's copies of chunk i
      __syncthreads();                      // everyone's; stage i-2 is free
      if (i + kSmallAhead < chunks) load(i + kSmallAhead);
      commit();
      if (last && i > 0) write_back(i - 1);
      if (!computes) continue;
      const float* as = smem + (i % kRing) * kStage;
      const float* bs = as + kSmallRows * kAStride;
#pragma unroll 16
      for (int j = 0; j < kQC; ++j) {
        float av[kTM];
#pragma unroll
        for (int t = 0; t < kTM; ++t)
          av[t] = as[(rg + kRG * t) * kAStride + j];
#pragma unroll
        for (int v = 0; v < kNV; ++v) {
          const float2 b = *reinterpret_cast<const float2*>(
              bs + j * KT + 2 * (cg + kCG * v));
#pragma unroll
          for (int t = 0; t < kTM; ++t) {
            acc[t][2 * v + 0] = fmaf(av[t], b.x, acc[t][2 * v + 0]);
            acc[t][2 * v + 1] = fmaf(av[t], b.y, acc[t][2 * v + 1]);
          }
        }
      }
    }
    if (last) write_back(chunks - 1);
    if (!computes) continue;

    // m = the chunks' sums + x_new * rhs[f, c, 0], as the 128-row kernel
#pragma unroll
    for (int t = 0; t < kTM; ++t) {
      const int r = rg + kRG * t;
      if (r >= rows) continue;
      float* out = m + ((size_t)f * vi_count + row0 + r) * kod + col0;
      const float x0 = xn[2 * r];
      const float x1 = xn[2 * r + 1];
#pragma unroll
      for (int v = 0; v < kNV; ++v) {
        const int col = 2 * (cg + kCG * v);
        if (col >= cols) continue;
        const float2 h0 =
            __ldg(reinterpret_cast<const float2*>(rhs_f + col0 + col));
        const float2 h1 = __ldg(reinterpret_cast<const float2*>(
            rhs_f + (size_t)pp * kod + col0 + col));
        float2 o;
        o.x = fmaf(x1, h1.x, fmaf(x0, h0.x, acc[t][2 * v + 0]));
        o.y = fmaf(x1, h1.y, fmaf(x0, h0.y, acc[t][2 * v + 1]));
        *reinterpret_cast<float2*>(out + col) = o;
      }
    }
  }
}

// -- bf16 on the tensor cores ---------------------------------------------

constexpr int kBQC = 64;                    // q per bf16 chunk
constexpr int kBStages = 4;                 // depth of the bf16 ring
constexpr int kBAhead = kBStages - 2;       // chunks in flight
// line tile row stride in bf16: 144 bytes, so ldmatrix's eight 16-byte
// rows fall in distinct banks; the rhs tile's is KT + 8 bf16 for the same
// reason
constexpr int kBAStride = kBQC + 8;

// a chunk's pre-shifted rhs tile, q in [a, a + kBQC): row j holds rhs[f, q +
// 1] for q = a + j, zero at a plane's last slot and past Q; V columns a
// copy (V = 8: 16 bytes, 4: 8), columns past `cols` zero-filled; `threads`
// threads share the copies
template <int KT, int V>
__device__ __forceinline__ void copy_shifted_rhs(bf16* bs, const bf16* rhs_f,
                                                 const bf16* any, int a,
                                                 int pp, int kod, int cols,
                                                 int tid, int threads) {
  constexpr int kPerRow = KT / V;
  const int q_total = 2 * pp;
  for (int e = tid; e < kBQC * kPerRow; e += threads) {
    const int j = e / kPerRow;
    const int col = V * (e % kPerRow);
    const int q = a + j;
    const int s = q >= pp ? q - pp : q;
    const bool ok = q < q_total && s + 1 < pp && col < cols;
    copy_vec<2 * V>(bs + j * (KT + 8) + col,
                    ok ? rhs_f + (size_t)(q + 1) * kod + col : any, ok);
  }
}

constexpr int kBMaxSlabs = kThreads / 32;   // 16-row slabs of a tile

// a stage of a tile of `slabs` 16-row slabs: the slabs' line rows (slab
// w's at rows 16w), then the pre-shifted rhs tile [kBQC q][KT + 8]
template <int KT>
__host__ __device__ constexpr int bf16_stage_elems(int slabs) {
  return 16 * slabs * kBAStride + kBQC * (KT + 8);
}

// A block: row tile blockIdx.x % row_tiles (16 * slabs rows) of bin
// blockIdx.x / row_tiles. Its blockDim.x threads (8 warps) share the
// copies and the write-back; warp w < slabs multiplies slab w. Rows past
// VI are neither copied nor written
template <int KT>
__global__ void __launch_bounds__(kThreads, 2)
mac_shift_bf16_kernel(bf16* __restrict__ fdl, const bf16* __restrict__ x_new,
                      const bf16* __restrict__ rhs, float* __restrict__ m,
                      int vi_count, int pp, int kod, int slabs,
                      int row_tiles) {
  constexpr int kVecs = kBQC / 8;            // 16-byte vectors per line row
  extern __shared__ __align__(16) float smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  // read, not fixed at compile time: with kThreads the compiler unrolls
  // the copy loops, spills at KT >= 32, and the kernel ran 2-25 % slower
  // on the H100
  const int threads = blockDim.x;
  const int stage = bf16_stage_elems<KT>(slabs);
  const int tile_rows = 16 * slabs;
  const int f = blockIdx.x / row_tiles;
  const int row0 = (blockIdx.x - f * row_tiles) * tile_rows;
  const int rows = min(tile_rows, vi_count - row0);
  const int q_total = 2 * pp;
  const int chunks = (q_total + kBQC - 1) / kBQC;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const bool vec16 = kod % 8 == 0;
  const bool computes = warp < slabs && 16 * warp < rows;

  // x_new is addressed where it is read: a pointer to it held across the
  // walk spilled at KT = 64 and ran VI = 192 11 % slower on the H100
  bf16* line = fdl + ((size_t)f * vi_count + row0) * q_total;
  const bf16* rhs_f = rhs + (size_t)f * q_total * kod;

  for (int col0 = 0; col0 < kod; col0 += KT) {
    const int cols = min(KT, kod - col0);
    const bool last = col0 + KT >= kod;
    if (col0 > 0) __syncthreads();          // every thread is off the ring

    // chunk i of the walk, [a, a + kBQC) with a = (chunks - 1 - i) * kBQC,
    // into stage i % kBStages: the tile's line vectors, then the
    // pre-shifted rhs tile
    auto load = [&](int i) {
      const int a = (chunks - 1 - i) * kBQC;
      bf16* as = smem + (i % kBStages) * stage;
      for (int e = tid; e < rows * kVecs; e += threads) {
        const int r = e / kVecs;
        const int qq = 8 * (e % kVecs);
        const bool ok = a + qq < q_total;
        copy16_l2pf(as + r * kBAStride + qq,
                    ok ? line + (size_t)r * q_total + a + qq : fdl, ok);
      }
      bf16* bs = as + tile_rows * kBAStride;
      if (vec16)
        copy_shifted_rhs<KT, 8>(bs, rhs_f + col0, rhs, a, pp, kod, cols, tid,
                                threads);
      else
        copy_shifted_rhs<KT, 4>(bs, rhs_f + col0, rhs, a, pp, kod, cols, tid,
                                threads);
    };

    // the shifted slots of chunk i, from its stage and that of chunk i + 1
    // (the chunk below, whose last slot is old[a - 1]); lanes: kVecs runs
    // of 8 slots of a row x threads / kVecs rows
    auto write_back = [&](int i) {
      const int a = (chunks - 1 - i) * kBQC;
      const bf16* cur = smem + (i % kBStages) * stage;
      const bf16* below = smem + ((i + 1) % kBStages) * stage;
      const int v = tid % kVecs;
      const int q0 = a + 8 * v;
      for (int r0 = 0; r0 < rows; r0 += threads / kVecs) {
        const int r = r0 + tid / kVecs;
        const bool live = r < rows && q0 < q_total;
        // 8 slots as 4 words of 2 bf16; the low half of a word is the
        // lower slot
        const uint4 x = live ? *reinterpret_cast<const uint4*>(
                                   cur + r * kBAStride + 8 * v)
                             : make_uint4(0u, 0u, 0u, 0u);
        // old[q0 - 1] is the last value of the lane to the left
        unsigned prev = __shfl_up_sync(0xffffffffu, x.w >> 16, 1, kVecs);
        if (!live) continue;
        if (v == 0 && a > 0)
          prev = *reinterpret_cast<const unsigned short*>(
              below + r * kBAStride + kBQC - 1);
        const bf16* xn = x_new + ((size_t)f * vi_count + row0 + r) * 2;
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
            o[e] = *reinterpret_cast<const unsigned short*>(xn + c);
        }
        uint4 out;
        out.x = o[0] | (static_cast<unsigned>(o[1]) << 16);
        out.y = o[2] | (static_cast<unsigned>(o[3]) << 16);
        out.z = o[4] | (static_cast<unsigned>(o[5]) << 16);
        out.w = o[6] | (static_cast<unsigned>(o[7]) << 16);
        *reinterpret_cast<uint4*>(line + (size_t)r * q_total + q0) = out;
      }
    };

    float acc[KT / 8][4];
#pragma unroll
    for (int n = 0; n < KT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

    for (int i = 0; i < kBAhead; ++i) {
      if (i < chunks) load(i);
      commit();
    }
    for (int i = 0; i < chunks; ++i) {
      wait_pending<kBAhead - 1>();          // this thread's copies of chunk i
      __syncthreads();                      // everyone's; stage i-2 is free
      if (i + kBAhead < chunks) load(i + kBAhead);
      commit();
      if (last && i > 0) write_back(i - 1);
      const bf16* as = smem + (i % kBStages) * stage;
      if (computes)
        mma_chunk<kBQC, KT, kBAStride, KT + 8>(
            acc, as, as + tile_rows * kBAStride, warp, lane);
    }
    if (last) write_back(chunks - 1);
    if (!computes) continue;

    // m = the chunks' sums + x_new * rhs[f, c, 0], from the C fragments:
    // rows r and r + 8, columns 2t and 2t + 1 of each n8 tile
    const int r = 16 * warp + lane / 4;
    const bf16* xn = x_new + ((size_t)f * vi_count + row0) * 2;
    float x[2][2];                          // [row r, r + 8][plane]
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const unsigned u = r + 8 * h < rows
          ? *reinterpret_cast<const unsigned*>(xn + 2 * (r + 8 * h)) : 0u;
      x[h][0] = bf16_lo(u);
      x[h][1] = bf16_hi(u);
    }
    float* out = m + ((size_t)f * vi_count + row0 + r) * kod + col0;
#pragma unroll
    for (int n = 0; n < KT / 8; ++n) {
      const int col = 8 * n + 2 * (lane % 4);
      if (col >= cols) continue;
      const unsigned h0 = __ldg(reinterpret_cast<const unsigned*>(
          rhs_f + col0 + col));
      const unsigned h1 = __ldg(reinterpret_cast<const unsigned*>(
          rhs_f + (size_t)pp * kod + col0 + col));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (r + 8 * h >= rows) continue;
        const float2 o = make_float2(
            fmaf(x[h][1], bf16_lo(h1),
                 fmaf(x[h][0], bf16_lo(h0), acc[n][2 * h])),
            fmaf(x[h][1], bf16_hi(h1),
                 fmaf(x[h][0], bf16_hi(h0), acc[n][2 * h + 1])));
        *reinterpret_cast<float2*>(out + 8 * h * (size_t)kod + col) = o;
      }
    }
  }
}

// -- launches ---------------------------------------------------------------

// the 128-row tiles (VI a multiple of 128, KT > 16)
template <int KT>
cudaError_t launch(float* a, const float* xn, const float* b, float* out,
                   int f, int vi, int pp, int kod, cudaStream_t s) {
  constexpr size_t smem = kStages * stage_elems<KT>() * sizeof(float);
  static std::atomic<bool> ready[kMaxDevices];
  int dev = 0;
  cudaError_t err = current_device(&dev);
  if (err == cudaSuccess)
    err = allow_smem(mac_shift_kernel<KT>, static_cast<int>(smem), dev,
                     ready);
  if (err != cudaSuccess) return err;
  const unsigned blocks =
      static_cast<unsigned>(f) * static_cast<unsigned>((vi + kRows - 1) / kRows);
  mac_shift_kernel<KT><<<blocks, kThreads, smem, s>>>(a, xn, b, out, vi, pp,
                                                      kod);
  return cudaGetLastError();
}

// The f32 tiles for VI and KT: 128 rows when VI is a multiple of 128 and
// KT > 16; else row tiles of at most 64 rows, an even split of VI > 64
// (VI = 128: 2 x 64, VI = 192: 3 x 64)
template <int KT>
cudaError_t launch_f32(float* a, const float* xn, const float* b, float* out,
                       int f, int vi, int pp, int kod, cudaStream_t s) {
  if constexpr (KT > 16) {
    if (vi % kRows == 0) return launch<KT>(a, xn, b, out, f, vi, pp, kod, s);
  }
  constexpr int kMaxSmem = kSmallStages * small_stage_elems<KT>() *
                           static_cast<int>(sizeof(float));
  static std::atomic<bool> ready[kMaxDevices];
  int dev = 0;
  cudaError_t err = current_device(&dev);
  if (err == cudaSuccess)
    err = allow_smem(mac_shift_small_kernel<KT>, kMaxSmem, dev, ready);
  if (err != cudaSuccess) return err;
  const int row_tiles = (vi + kSmallRows - 1) / kSmallRows;
  const int tile_rows = (vi + row_tiles - 1) / row_tiles;
  // only the stages its chunks fill (a short line: more blocks fit an SM)
  const int chunks = (2 * pp + kQC - 1) / kQC;
  const int smem = std::min(chunks, kSmallStages) * small_stage_elems<KT>() *
                   static_cast<int>(sizeof(float));
  const unsigned blocks =
      static_cast<unsigned>(f) * static_cast<unsigned>(row_tiles);
  mac_shift_small_kernel<KT><<<blocks, kThreads, smem, s>>>(
      a, xn, b, out, vi, pp, kod, tile_rows, row_tiles);
  return cudaGetLastError();
}

// The bf16 tiles for VI: the ceil(VI / 16) slabs of a bin split evenly
// into row tiles of at most 8 slabs (VI = 128: one tile of 8, VI = 192:
// 2 x 6)
template <int KT>
cudaError_t launch_bf16(bf16* a, const bf16* xn, const bf16* b, float* out,
                        int f, int vi, int pp, int kod, cudaStream_t s) {
  constexpr int kMaxSmem = kBStages * bf16_stage_elems<KT>(kBMaxSlabs) *
                           static_cast<int>(sizeof(bf16));
  static std::atomic<bool> ready[kMaxDevices];
  int dev = 0;
  cudaError_t err = current_device(&dev);
  if (err == cudaSuccess)
    err = allow_smem(mac_shift_bf16_kernel<KT>, kMaxSmem, dev, ready);
  if (err != cudaSuccess) return err;
  const int bin_slabs = (vi + 15) / 16;
  const int row_tiles = (bin_slabs + kBMaxSlabs - 1) / kBMaxSlabs;
  const int slabs = (bin_slabs + row_tiles - 1) / row_tiles;
  const int chunks = (2 * pp + kBQC - 1) / kBQC;
  const int smem = std::min(chunks, kBStages) * bf16_stage_elems<KT>(slabs) *
                   static_cast<int>(sizeof(bf16));
  const unsigned blocks =
      static_cast<unsigned>(f) * static_cast<unsigned>(row_tiles);
  mac_shift_bf16_kernel<KT><<<blocks, kThreads, smem, s>>>(
      a, xn, b, out, vi, pp, kod, slabs, row_tiles);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// a row of fdl is Q = 2 * pp values of `bytes` each: rows start on 16 bytes
// for pp a multiple of 8 / bytes; a bf16 x_new row of 2 values is read as
// one 32-bit word
bool refused(const void* fdl, const void* x_new, const void* rhs,
             const void* m, int f, int vi, int pp, int kod, int bytes) {
  return f <= 0 || vi <= 0 || pp <= 0 || kod <= 0 || pp % (8 / bytes) ||
         kod % 4 || !aligned16(fdl) || !aligned16(rhs) || !aligned16(m) ||
         (bytes == 2 && reinterpret_cast<uintptr_t>(x_new) % 4);
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
  if (refused(fdl, x_new, rhs, m, f, vi, pp, kod, 4))
    return static_cast<int>(cudaErrorInvalidValue);
  float* a = static_cast<float*>(fdl);
  const float* xn = static_cast<const float*>(x_new);
  const float* b = static_cast<const float*>(rhs);
  float* out = static_cast<float*>(m);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kod <= 16) return launch_f32<16>(a, xn, b, out, f, vi, pp, kod, s);
  if (kod <= 32) return launch_f32<32>(a, xn, b, out, f, vi, pp, kod, s);
  if (kod <= 48) return launch_f32<48>(a, xn, b, out, f, vi, pp, kod, s);
  return launch_f32<64>(a, xn, b, out, f, vi, pp, kod, s);
}

// The same with fdl, x_new and rhs bf16 (m f32): pp must be a multiple of 4.
extern "C" int mac_shift_bf16_launch(void* fdl, const void* x_new,
                                     const void* rhs, void* m, int f, int vi,
                                     int pp, int kod, void* stream) {
  if (refused(fdl, x_new, rhs, m, f, vi, pp, kod, 2))
    return static_cast<int>(cudaErrorInvalidValue);
  bf16* a = static_cast<bf16*>(fdl);
  const bf16* xn = static_cast<const bf16*>(x_new);
  const bf16* b = static_cast<const bf16*>(rhs);
  float* out = static_cast<float*>(m);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kod <= 16) return launch_bf16<16>(a, xn, b, out, f, vi, pp, kod, s);
  if (kod <= 32) return launch_bf16<32>(a, xn, b, out, f, vi, pp, kod, s);
  if (kod <= 48) return launch_bf16<48>(a, xn, b, out, f, vi, pp, kod, s);
  return launch_bf16<64>(a, xn, b, out, f, vi, pp, kod, s);
}

extern "C" const char* mac_shift_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
