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
//     that covers KOD; columns past KOD are zero-filled, never stored.
//     That holds for VI a multiple of 128; fewer rows take the small tiles
//     below;
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
// Small row counts (VI not a multiple of 128: the cascade's tails at 64
// voices, VI = 8, and at 512, VI = 64; the mesh's voice shards, VI = 64 at
// 64 voices over voice = 2). A 128-row tile there is mostly rows that are
// multiplied and dropped, and halving VI halves the bound, not the time.
// So the f32 form takes tiles of kSmallRows = 64 rows there, in a kernel
// of its own (ring_mac_small_kernel; the 128-row kernel stays as it was:
// one template for both measured 1-2 % slower on the 128-row shapes), and
// the FMA work follows the rows a call has:
//   - VI > 64 splits evenly into ceil(VI / 64) row tiles per bin (VI = 160:
//     3 x 54, not 128 + 32);
//   - VI <= 32 packs several bins into one tile (VI = 8: 8 bins of 8 rows,
//     513 blocks at F = 4097 instead of 4097 blocks of 8 rows): tile row s
//     holds row s / bins of bin f0 + s % bins, so the rows of one thread,
//     kRG apart, share a bin and its window; each bin's window is staged
//     once (16 floats of padding between windows keep a quarter warp's two
//     bins in distinct banks), at most 128 / KT bins a tile;
//   - a block keeps 256 threads and the two q groups, so a thread's
//     register tile is half as tall (2 x 4 to 4 x 8). Measured on the H100
//     at VI = 64 (F = 257, Pp = 696), 128 threads with the full tiles left
//     two warps per scheduler and ran slower than the 128-row tiles at
//     KOD 16 (74 against 68 us); the half tiles cost more shared-memory
//     loads per FMA and still win (54 us);
//   - the ring is kSmallStages = 6 chunks deep (4 and 8 measured slower at
//     VI = 64, KOD 16), the line copies ask L2 for the next chunk's run
//     (copy16_l2pf), and a short line stages only the chunks it has (Q =
//     96: 3 stages), so more blocks fit an SM.
// The order of every output's sum is the 128-row tiles': group 0 takes q
// [32i, 32i + 16) of each chunk i, in order, group 1 the rest, then one
// add. So the outputs are bit for bit those of the 128-row tiles at every
// VI; only which rows and bins share a block changed.
//
// KOD > 64 (only an explicit 'allk' with more than 16 IRs): column groups
// of 64 go to separate blocks (grid y), each re-reading the line. That is
// race-free, since nothing is written in place.
//
// bf16 operands (mac_dtype='bf16'; JAX runs that MAC as the einsum the
// Pallas kernel stands for, bf16 operands with preferred_element_type f32,
// tpu_audio/engine/fmajor.py:908-923): a kernel of its own,
// ring_mac_bf16_kernel, on the tensor cores. Per bin the MAC is a GEMM, M =
// VI rows, K = Q, N = KOD, with A the line tile (k contiguous) and B the
// gathered window (n contiguous). bf16 x bf16 products are exact in f32, so
// an MMA with f32 accumulators computes the JAX einsum's function; only the
// order of the sums differs. What bounds it: bytes. The line is half the f32
// bytes (91.6 MB at 64 voices) and the work 7-21 FLOP/byte, against the
// bf16 tensor-core ridge of ~295: 31.4 / 36.4 / 43.5 us at KOD 16 / 36 / 64.
// The design keeps copies in flight and leaves the tensor cores idle most
// of the time (mma.sync, not wgmma: the full rate buys nothing here):
//   - the same tiles as the f32 form at VI a multiple of 128 (one bin, 128
//     rows, all KT columns, KT 16 to 64) and the same cp.async zero-fill
//     copies (the window row computed per row, columns past KOD zeroed), in
//     chunks of kBQC = 64 q:
//     128 bytes of each line row a chunk, as the f32 form's 32 q. Measured
//     on the H100 at 64 voices, 32-q chunks (64-byte runs per row) held the
//     copies alone to ~1.8-2.0 TB/s, 64-q ones to ~2.2-2.4; the line
//     copies also ask L2 for the 256-byte block around each 16 bytes
//     (copy16_l2pf: the next chunk's run comes in the same DRAM access),
//     ~2.5-2.7 TB/s. kBStages = 4 stages of 28 KB at KT = 64, three chunks
//     in flight while one is multiplied, two blocks per SM;
//   - each of the 8 warps takes 16 rows by all KT columns: per k16 step one
//     ldmatrix.x4 of its A fragment (the tile's row stride of kBQC + 8
//     bf16, 144 bytes, puts ldmatrix's eight 16-byte rows in distinct
//     banks) and KT /
//     16 ldmatrix.x4.trans of B fragments (row stride KT + 8 bf16 for the
//     same reason), then KT / 8 mma.sync.m16n8k16 bf16 -> f32. Nothing is
//     unpacked and no sums are parked: a thread holds KT / 2 f32 sums;
//   - a two-level sum: each chunk's product starts from zero and is added
//     into the running f32 sums with one round-to-nearest add (the tensor
//     core's own adds truncate, so they span 64 products only);
//   - short lines (the 2048-voice cascade's head, Q = 64, and tail, Q = 96:
//     ~8200 tiles of 18-34 KB): the grid holds as many blocks as are resident
//     at once, and each block walks its tiles (tile blockIdx.x, then
//     gridDim.x on) as one stream of chunks, so the ring runs on across a
//     tile's end and the next tile's copies overlap this one's product and
//     stores. m leaves the C fragments as float2 (8 bytes, KOD is even);
//   - fewer rows: a tile is `slabs` 16-row warp slabs of a bin, the
//     ceil(VI / 16) slabs of a bin split evenly into tiles of at most 8
//     (VI = 160: 2 x 80 rows, not 128 + 32), and when a bin has fewer than
//     8 slabs, several bins share a tile (warp w takes slab w % slabs of
//     bin w / slabs; VI = 8: 5 bins at KT = 16, one warp each), as many
//     as keep the stage within the 128-row stage at KT = 64. A block has
//     one warp per slab of its tile, so more blocks fit an SM and keep
//     chunks in flight (VI = 160: blocks of 5 warps, not 8 with 3 idle).
//     With each thread's copy rows worked out once per block, VI = 160
//     took 78 us on the H100, against 100 with 8-warp blocks that divided
//     per copy. A stage holds only the
//     tile's slabs and its bins' windows; rows past VI are not copied (an
//     MMA row's sums are its own, and they are never stored).
// The window moves in 16-byte copies of 8 columns when KOD % 8 == 0, else
// in 8-byte copies of 4 (a row of rhs2 then starts on 8 bytes only).
// KOD > 64 splits into column groups of 64 among the tiles.
//
// Alignment: fdl rows start on 16 bytes only if Q values (4 bytes each in
// f32, 2 in bf16) make a multiple of 16, so the launch refuses an odd Pp
// for f32 and a Pp that is not a multiple of 4 for bf16 (the engine pads Pp
// to a multiple of 8).
// The launch allocates nothing and does not synchronise; it returns a
// cudaError_t so the caller can raise. It picks the tiles from F, VI and
// KOD; the shared-memory ceiling of each instantiation is raised, and the
// SM count and occupancy asked, once per device, not at every launch.

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
constexpr int kGroup = 128;                 // threads of one q group
constexpr int kRows = 128;                  // delay-line rows per block
constexpr int kQC = 32;                     // q per chunk
constexpr int kStages = 4;                  // depth of the cp.async ring
// fdl tile row stride in floats: the chunk plus one 16-byte vector, so a
// warp's rows fall in distinct banks
constexpr int kAStride = kQC + 4;

template <int KT>
__host__ __device__ constexpr int stage_elems() {
  return kRows * kAStride + kQC * KT;
}

template <int KT>
__global__ void __launch_bounds__(kThreads, 2)
ring_mac_kernel(const int* __restrict__ wptr, const float* __restrict__ fdl,
                const float* __restrict__ rhs2, float* __restrict__ m,
                int vi_count, int pp, int kod) {
  constexpr int kCG = KT == 64 ? 8 : 4;     // column groups of the tile
  constexpr int kNV = KT / (4 * kCG);       // 4-column vectors per thread
  constexpr int kTN = 4 * kNV;              // columns per thread
  constexpr int kRG = kGroup / kCG;         // row groups of the tile
  constexpr int kTM = kRows / kRG;          // rows per thread
  constexpr int kVecs = kQC / 4;            // 16-byte vectors per row of a
                                            // chunk
  constexpr int kHalf = kQC / 2;            // q of a chunk per group
  extern __shared__ __align__(16) float smem_raw[];
  float* smem = smem_raw;

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

  const float* line = fdl + ((size_t)f * vi_count + row0) * q_total;
  const float* rhs_f = rhs2 + (size_t)f * 2 * q_total * kod + col0;

  // copy k of this thread for chunk i, q in [i * kQC, (i + 1) * kQC), into
  // stage i % kStages: the chunk's kFdlCopies fdl vectors, then its window
  // vectors, kThreads apart
  constexpr int kFdlCopies = kRows * kVecs;
  constexpr int kCopies =                   // per thread and chunk
      (kFdlCopies + kQC * KT / 4 + kThreads - 1) / kThreads;
  auto copy = [&](int i, int k) {
    const int a = i * kQC;
    float* as = smem + (i % kStages) * stage_elems<KT>();
    const int e = tid + k * kThreads;
    if (e < kFdlCopies) {
      const int r = e / kVecs;
      const int qq = 4 * (e % kVecs);
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
      copy16(as + kRows * kAStride + j * KT + col,
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
    const float* as = smem + (i % kStages) * stage_elems<KT>();
    const float* bs = as + kRows * kAStride;
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

// -- f32 at fewer rows ------------------------------------------------------

constexpr int kSmallRows = 64;              // rows of a small tile
constexpr int kSmallStages = 6;             // depth of a small tile's ring

// The small tile's geometry at a column tile of KT: the two q groups of
// the 128-row tiles, each thread's register tile half as tall
template <int KT>
struct SmallTile {
  static constexpr int kCG = KT == 64 ? 8 : 4;   // column groups of the tile
  static constexpr int kNV = KT / (4 * kCG);     // 4-column vectors a thread
  static constexpr int kTN = 4 * kNV;            // columns per thread
  static constexpr int kRG = kGroup / kCG;       // row groups of the tile
  static constexpr int kTM = kSmallRows / kRG;   // rows per thread
  // bins sharing a tile: as many as keep a thread's rows in one bin
  // (kRG % bins == 0) and their windows within 128 columns' worth
  static constexpr int kMaxBins = 128 / KT < kRG ? 128 / KT : kRG;
  // a bin's window tile [kQC q][KT], 16 floats apart, so a quarter warp's
  // two bins fall in distinct banks
  static constexpr int kWS = kQC * KT + 16;
  static constexpr int kVecs = kQC / 4;     // 16-byte vectors per row of a
                                            // chunk
  static constexpr int kFdlCopies = kSmallRows * kVecs;
  static constexpr int kWinCopies = kQC * KT / 4;   // per bin
  static constexpr int kCopies =            // per thread and chunk
      (kFdlCopies + kMaxBins * kWinCopies + kThreads - 1) / kThreads;
  static_assert(kCopies <= kQC / 4, "a chunk's copies go out two q apart");
  __host__ __device__ static constexpr int stage_elems(int bins) {
    return kSmallRows * kAStride + bins * kWS;
  }
};

// A block: row tile blockIdx.x % row_tiles (tile_rows rows) of the
// 2^lg_bins bins from (blockIdx.x / row_tiles) << lg_bins, columns
// [blockIdx.y * KT, + KT). The 128-row kernel's copies, FMAs and sum, over
// a tile whose row s is row s >> lg_bins of bin f0 + s % bins
template <int KT>
__global__ void __launch_bounds__(kThreads, KT == 64 ? 2 : 3)  // no spills
ring_mac_small_kernel(const int* __restrict__ wptr,
                      const float* __restrict__ fdl,
                      const float* __restrict__ rhs2, float* __restrict__ m,
                      int f_count, int vi_count, int pp, int kod,
                      int tile_rows, int row_tiles, int lg_bins) {
  using T = SmallTile<KT>;
  constexpr int kCG = T::kCG;
  constexpr int kNV = T::kNV;
  constexpr int kTN = T::kTN;
  constexpr int kRG = T::kRG;
  constexpr int kTM = T::kTM;
  constexpr int kVecs = T::kVecs;
  constexpr int kCopies = T::kCopies;
  constexpr int kRing = kSmallStages;
  constexpr int kHalf = kQC / 2;            // q of a chunk per group
  extern __shared__ __align__(16) float smem_raw[];
  float* smem = smem_raw;

  const int bins = 1 << lg_bins;
  const int stage = T::stage_elems(bins);
  const int tile = blockIdx.x / row_tiles;
  const int f0 = tile << lg_bins;
  const int row0 = (blockIdx.x - tile * row_tiles) * tile_rows;
  const int rows = min(tile_rows, vi_count - row0);
  const int col0 = blockIdx.y * KT;
  const int cols = min(KT, kod - col0);
  const int q_total = 2 * pp;
  const int chunks = (q_total + kQC - 1) / kQC;
  const int tid = threadIdx.x;
  const int group = tid / kGroup;           // which half of each chunk
  const int gtid = tid % kGroup;
  const int cg = gtid % kCG;                // a warp's lanes: kCG column
  const int rg = gtid / kCG;                // groups x consecutive rows
  // a thread's rows rg + kRG * t all lie in bin f0 + rg % bins
  const int bin = rg & (bins - 1);

  int w = wptr[0] % pp;
  if (w < 0) w += pp;
  const int start = pp - w;                 // window row of slot 0

  const float* line = fdl + ((size_t)f0 * vi_count + row0) * q_total;
  const float* rhs_f = rhs2 + (size_t)f0 * 2 * q_total * kod + col0;

  // copy k of this thread for chunk i into stage i % kRing: the chunk's
  // kFdlCopies fdl vectors (each also asking L2 for the next chunk's run),
  // then its bins' window vectors, kThreads apart; rows past VI and bins
  // past F are zero-filled
  auto copy = [&](int i, int k) {
    const int a = i * kQC;
    float* as = smem + (i % kRing) * stage;
    const int e = tid + k * kThreads;
    if (e < T::kFdlCopies) {
      const int s = e / kVecs;
      const int qq = 4 * (e % kVecs);
      const int b = s & (bins - 1);
      const int r = s >> lg_bins;
      const bool ok = r < rows && a + qq < q_total && f0 + b < f_count;
      copy16_l2pf(as + s * kAStride + qq,
                  ok ? line + ((size_t)b * vi_count + r) * q_total + a + qq
                     : fdl,
                  ok);
    } else if (e - T::kFdlCopies < bins * T::kWinCopies) {
      const int v = e - T::kFdlCopies;
      const int b = v / T::kWinCopies;
      const int j = (v - b * T::kWinCopies) / (KT / 4);
      const int col = 4 * ((v - b * T::kWinCopies) % (KT / 4));
      const int q = a + j;
      const int c = q >= pp ? 1 : 0;
      const bool ok = q < q_total && col < cols && f0 + b < f_count;
      const size_t row = (size_t)b * 2 * q_total + (size_t)c * q_total
                         + start + (q - c * pp);
      copy16(as + kSmallRows * kAStride + b * T::kWS + j * KT + col,
             ok ? rhs_f + row * kod + col : rhs2, ok);
    }
  };

  float acc[kTM][kTN];
#pragma unroll
  for (int t = 0; t < kTM; ++t)
#pragma unroll
    for (int k = 0; k < kTN; ++k) acc[t][k] = 0.f;

#pragma unroll
  for (int i = 0; i < kRing - 1; ++i) {
    if (i < chunks)
#pragma unroll
      for (int k = 0; k < kCopies; ++k) copy(i, k);
    commit();
  }
  for (int i = 0; i < chunks; ++i) {
    wait_pending<kRing - 2>();              // this thread's copies of chunk i
    __syncthreads();                        // everyone's; stage i-1 is free
    const bool ahead = i + kRing - 1 < chunks;
    const float* as = smem + (i % kRing) * stage;
    const float* bs = as + kSmallRows * kAStride + bin * T::kWS;
#pragma unroll 8
    for (int jj = 0; jj < kHalf; ++jj) {
      // the next chunk's copies, two steps apart
      if (jj % 2 == 0 && jj / 2 < kCopies && ahead)
        copy(i + kRing - 1, jj / 2);
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
    commit();
  }

  // add the two groups' sums, as the 128-row kernel does
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
  if (group == 1 || f0 + bin >= f_count) return;
#pragma unroll
  for (int t = 0; t < kTM; ++t) {
    const int r = (rg + kRG * t) >> lg_bins;
    if (r >= rows) continue;
    float* out = m + ((size_t)(f0 + bin) * vi_count + row0 + r) * kod + col0;
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

// -- bf16 on the tensor cores ---------------------------------------------

constexpr int kWarps = kThreads / 32;       // of a 128-row tile's block
constexpr int kBQC = 64;                    // q per bf16 chunk
constexpr int kBStages = 4;                 // depth of the bf16 ring
// line tile row stride in bf16: 144 bytes, so ldmatrix's eight 16-byte
// rows fall in distinct banks; the window tile's is KT + 8 bf16 for the
// same reason
constexpr int kBAStride = kBQC + 8;

// a stage of a tile of `bins` bins of `slabs` 16-row slabs each: the
// slabs' line rows (warp w's at rows 16w), then each bin's window tile
// [kBQC q][KT + 8]
template <int KT>
__host__ __device__ constexpr int bf16_stage_elems(int slabs, int bins) {
  return bins * (16 * slabs * kBAStride + kBQC * (KT + 8));
}

// the windows of a chunk, q in [a, a + kBQC), of bins f0 .. f0 + bins - 1:
// row j of bin b's tile is rhs2[f0 + b, c, start + s] for q = a + j = c *
// pp + s, V columns a copy (V = 8: 16 bytes, 4: 8); rows past Q and
// columns past `cols` are zero-filled, bins past F not copied
template <int KT, int V>
__device__ __forceinline__ void copy_windows(bf16* bs, const bf16* rhs2,
                                             int f0, int bins, int f_count,
                                             int col0, int a, int pp,
                                             int start, int kod, int cols,
                                             int tid, int threads) {
  constexpr int kPerRow = KT / V;
  constexpr int kPerBin = kBQC * kPerRow;
  const int q_total = 2 * pp;
  for (int e = tid; e < bins * kPerBin; e += threads) {
    const int b = e / kPerBin;
    if (f0 + b >= f_count) break;
    const int j = (e - b * kPerBin) / kPerRow;
    const int col = V * ((e - b * kPerBin) % kPerRow);
    const int q = a + j;
    const int c = q >= pp ? 1 : 0;
    const bool ok = q < q_total && col < cols;
    const size_t row = (size_t)(f0 + b) * 2 * q_total + (size_t)c * q_total
                       + start + (q - c * pp);
    copy_vec<2 * V>(bs + b * kBQC * (KT + 8) + j * (KT + 8) + col,
                    ok ? rhs2 + row * kod + col0 + col : rhs2, ok);
  }
}

// Tiles: row tile k % row_tiles (16 * slabs rows) of the `bins` bins from
// (k / row_tiles) * bins, a column group of KT innermost; block b walks
// tiles b, b + gridDim.x, ... A block has one warp per slab of a tile.
// kFull: the 128-row tiles (8 slabs, one bin), fixed at compile time
template <int KT, bool kFull>
__global__ void __launch_bounds__(kThreads, 2)
ring_mac_bf16_kernel(const int* __restrict__ wptr,
                     const bf16* __restrict__ fdl,
                     const bf16* __restrict__ rhs2, float* __restrict__ m,
                     int f_count, int vi_count, int pp, int kod, int slabs_arg,
                     int row_tiles, int bins_arg) {
  constexpr int kVecs = kBQC / 8;            // 16-byte vectors per line row
  constexpr int kLineCopies = kRows * kVecs / kThreads;  // per thread
  constexpr int kWin = kBQC * (KT + 8);
  extern __shared__ __align__(16) float smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  const int slabs = kFull ? kWarps : slabs_arg;
  const int bins = kFull ? 1 : bins_arg;
  const int threads = 32 * slabs * bins;
  const int stage = bf16_stage_elems<KT>(slabs, bins);
  const int line_rows = 16 * slabs * bins;   // of a stage
  const int tile_rows = 16 * slabs;          // of a bin in a tile
  const int col_groups = (kod + KT - 1) / KT;
  const int tiles = (f_count + bins - 1) / bins * row_tiles * col_groups;
  const int q_total = 2 * pp;
  const int chunks = (q_total + kBQC - 1) / kBQC;
  // this block's tiles are blockIdx.x, + gridDim.x, ...; its chunks one
  // stream, step g = chunk g % chunks of its tile g / chunks
  const int block = blockIdx.x;
  const int blocks = gridDim.x;
  const int steps = ((tiles - 1 - block) / blocks + 1) * chunks;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  // this warp's slab: rows [slab_row, + 16) of its bin's row tile
  const int my_bin = kFull ? 0 : warp / slabs;
  const int slab_row = 16 * (warp - my_bin * slabs);
  // this thread's line copies (a stage's 16 * slabs * bins rows of kVecs
  // vectors over 32 * slabs * bins threads: kLineCopies each): 16 bytes at
  // q offset qq of stage row tid / kVecs + k * threads / kVecs, row
  // copy_row[k] of bin copy_bin[k] of the tile
  const int qq = 8 * (tid % kVecs);
  int copy_bin[kLineCopies], copy_row[kLineCopies];
#pragma unroll
  for (int k = 0; k < kLineCopies; ++k) {
    const int sr = tid / kVecs + k * (threads / kVecs);
    copy_bin[k] = kFull ? 0 : sr / 16 / slabs;
    copy_row[k] = sr - 16 * copy_bin[k] * slabs;
  }

  int w = wptr[0] % pp;
  if (w < 0) w += pp;
  const int start = pp - w;                 // window row of slot 0
  const bool vec16 = kod % 8 == 0;

  struct Tile {
    int f0, row0, col0, rows, cols;
  };
  auto tile = [&](int k) {
    int t = block + k * blocks;
    Tile u;
    u.col0 = (t % col_groups) * KT;
    t /= col_groups;
    u.row0 = (t % row_tiles) * tile_rows;
    u.f0 = (t / row_tiles) * bins;
    u.rows = min(tile_rows, vi_count - u.row0);
    u.cols = min(KT, kod - u.col0);
    return u;
  };

  // the copies of step g; rows past VI are zero-filled in the 128-row
  // tiles and not copied in the small ones, bins past F not copied
  auto load = [&](int g) {
    const Tile u = tile(g / chunks);
    const int a = (g % chunks) * kBQC;
    bf16* as = smem + (g % kBStages) * stage;
    const bf16* line = fdl + ((size_t)u.f0 * vi_count + u.row0) * q_total;
#pragma unroll
    for (int k = 0; k < kLineCopies; ++k) {
      const int sr = tid / kVecs + k * (threads / kVecs);
      const int b = copy_bin[k];
      const int r = copy_row[k];
      const bool row_ok = r < u.rows && (kFull || u.f0 + b < f_count);
      if (kFull || row_ok) {
        const bool ok = row_ok && a + qq < q_total;
        copy16_l2pf(as + sr * kBAStride + qq,
                    ok ? line + ((size_t)b * vi_count + r) * q_total + a + qq
                       : fdl,
                    ok);
      }
    }
    bf16* bs = as + line_rows * kBAStride;
    if (vec16)
      copy_windows<KT, 8>(bs, rhs2, u.f0, bins, f_count, u.col0, a, pp,
                          start, kod, u.cols, tid, threads);
    else
      copy_windows<KT, 4>(bs, rhs2, u.f0, bins, f_count, u.col0, a, pp,
                          start, kod, u.cols, tid, threads);
  };

  float acc[KT / 8][4];
#pragma unroll
  for (int n = 0; n < KT / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int g = 0; g < kBStages - 1; ++g) {
    if (g < steps) load(g);
    commit();
  }
  Tile u = tile(0);
  for (int g = 0; g < steps; ++g) {
    wait_pending<kBStages - 2>();           // this thread's copies of step g
    __syncthreads();                        // everyone's; stage g-1 is free
    if (g + kBStages - 1 < steps) load(g + kBStages - 1);
    commit();
    const int i = g % chunks;
    if (i == 0 && g > 0) u = tile(g / chunks);
    const bool live = kFull || u.f0 + my_bin < f_count;
    const bf16* as = smem + (g % kBStages) * stage;
    if (live && slab_row < u.rows)
      mma_chunk<kBQC, KT, kBAStride, KT + 8>(
          acc, as, as + line_rows * kBAStride + my_bin * kWin, warp, lane);
    if (i == chunks - 1) {
      // the tile's m from the C fragments: rows r and r + 8, columns 2t
      // and 2t + 1 of each n8 tile
      const int r = slab_row + lane / 4;
      float* out = m + ((size_t)(u.f0 + my_bin) * vi_count + u.row0 + r)
                           * kod + u.col0;
#pragma unroll
      for (int n = 0; n < KT / 8; ++n) {
        const int col = 8 * n + 2 * (lane % 4);
        if (live && col < u.cols) {
          if (r < u.rows)
            *reinterpret_cast<float2*>(out + col) =
                make_float2(acc[n][0], acc[n][1]);
          if (r + 8 < u.rows)
            *reinterpret_cast<float2*>(out + 8 * (size_t)kod + col) =
                make_float2(acc[n][2], acc[n][3]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
      }
    }
  }
  wait_pending<0>();
}

// -- launches ---------------------------------------------------------------

// the 128-row tiles (VI a multiple of 128)
template <int KT>
cudaError_t launch(const int* w, const float* a, const float* b, float* out,
                   int f, int vi, int pp, int kod, cudaStream_t s) {
  constexpr size_t smem = kStages * stage_elems<KT>() * sizeof(float);
  static_assert(smem >= KT * kRows * sizeof(float),
                "the stages must hold group 1's parked sums");
  static std::atomic<bool> ready[kMaxDevices];
  int dev = 0;
  cudaError_t err = current_device(&dev);
  if (err == cudaSuccess)
    err = allow_smem(ring_mac_kernel<KT>, static_cast<int>(smem), dev, ready);
  if (err != cudaSuccess) return err;
  const unsigned row_tiles = static_cast<unsigned>((vi + kRows - 1) / kRows);
  const dim3 grid(static_cast<unsigned>(f) * row_tiles,
                  static_cast<unsigned>((kod + KT - 1) / KT));
  ring_mac_kernel<KT><<<grid, kThreads, smem, s>>>(w, a, b, out, vi, pp, kod);
  return cudaGetLastError();
}

// the small tiles: tile_rows rows of each of 2^lg_bins bins
template <int KT>
cudaError_t launch_small(const int* w, const float* a, const float* b,
                         float* out, int f, int vi, int pp, int kod,
                         int tile_rows, int row_tiles, int lg_bins,
                         cudaStream_t s) {
  using T = SmallTile<KT>;
  constexpr int kMaxSmem = kSmallStages * T::stage_elems(T::kMaxBins) *
                           static_cast<int>(sizeof(float));
  static_assert(kSmallStages * T::stage_elems(1) >= KT * kSmallRows,
                "the stages must hold group 1's parked sums");
  static std::atomic<bool> ready[kMaxDevices];
  int dev = 0;
  cudaError_t err = current_device(&dev);
  if (err == cudaSuccess)
    err = allow_smem(ring_mac_small_kernel<KT>, kMaxSmem, dev, ready);
  if (err != cudaSuccess) return err;
  // only the stages its chunks fill (a short line: more blocks fit an SM)
  const int chunks = (2 * pp + kQC - 1) / kQC;
  const int smem = std::max(std::min(chunks, kSmallStages) *
                                T::stage_elems(1 << lg_bins),
                            KT * kSmallRows) *
                   static_cast<int>(sizeof(float));
  const unsigned groups = static_cast<unsigned>(((f - 1) >> lg_bins) + 1);
  const dim3 grid(groups * static_cast<unsigned>(row_tiles),
                  static_cast<unsigned>((kod + KT - 1) / KT));
  ring_mac_small_kernel<KT><<<grid, kThreads, smem, s>>>(
      w, a, b, out, f, vi, pp, kod, tile_rows, row_tiles, lg_bins);
  return cudaGetLastError();
}

// The f32 tiles for VI: 128 rows when VI is a multiple of 128; else row
// tiles of at most 64, an even split of VI > 32, or several bins of VI <=
// 32 rows in one tile (a power of two of them, at most kMaxBins)
template <int KT>
cudaError_t launch_f32(const int* w, const float* a, const float* b,
                       float* out, int f, int vi, int pp, int kod,
                       cudaStream_t s) {
  if (vi % kRows == 0) return launch<KT>(w, a, b, out, f, vi, pp, kod, s);
  constexpr int kMaxBins = SmallTile<KT>::kMaxBins;
  if (2 * vi <= kSmallRows) {
    int lg = 0;
    while ((2 << lg) <= kMaxBins && (vi << (lg + 1)) <= kSmallRows) ++lg;
    return launch_small<KT>(w, a, b, out, f, vi, pp, kod, vi, 1, lg, s);
  }
  const int tiles = (vi + kSmallRows - 1) / kSmallRows;
  return launch_small<KT>(w, a, b, out, f, vi, pp, kod,
                          (vi + tiles - 1) / tiles, tiles, 0, s);
}

// The bf16 tiles for VI: the ceil(VI / 16) slabs of a bin split evenly
// into row tiles of at most 8 slabs; a bin of fewer than 8 slabs shares
// its tile with the next bins, as many as fit the warps and a stage no
// larger than the 128-row stage at KT = 64. The grid holds as many blocks
// as fit the card at once (asked once per device and tile shape), each
// walking its share of the tiles.
template <int KT>
cudaError_t launch_bf16(const int* w, const bf16* a, const bf16* b,
                        float* out, int f, int vi, int pp, int kod,
                        cudaStream_t s) {
  constexpr int kBudget = bf16_stage_elems<64>(kWarps, 1);
  constexpr int kFullSmem = kBStages * bf16_stage_elems<KT>(kWarps, 1) *
                            static_cast<int>(sizeof(bf16));
  constexpr int kMaxSmem =
      kBStages * kBudget * static_cast<int>(sizeof(bf16));
  static std::atomic<bool> ready_full[kMaxDevices], ready[kMaxDevices];
  static std::atomic<int> sms[kMaxDevices];
  // blocks resident per SM, by (slabs - 1) * kWarps + bins - 1
  static std::atomic<int> per_sm[kMaxDevices][kWarps * kWarps];
  int dev = 0;
  cudaError_t err = current_device(&dev);
  if (err == cudaSuccess)
    err = allow_smem(ring_mac_bf16_kernel<KT, true>, kFullSmem, dev,
                     ready_full);
  if (err == cudaSuccess)
    err = allow_smem(ring_mac_bf16_kernel<KT, false>, kMaxSmem, dev, ready);
  if (err != cudaSuccess) return err;

  const int bin_slabs = (vi + 15) / 16;
  const int row_tiles = (bin_slabs + kWarps - 1) / kWarps;
  const int slabs = (bin_slabs + row_tiles - 1) / row_tiles;
  int bins = row_tiles == 1 ? kWarps / slabs : 1;
  while (bins > 1 && bf16_stage_elems<KT>(slabs, bins) > kBudget) --bins;
  const bool full = slabs == kWarps && bins == 1;
  const auto kernel = full ? ring_mac_bf16_kernel<KT, true>
                           : ring_mac_bf16_kernel<KT, false>;
  const int threads = 32 * slabs * bins;    // a warp per slab
  const int smem = kBStages * bf16_stage_elems<KT>(slabs, bins) *
                   static_cast<int>(sizeof(bf16));

  int n_sms = 0;
  err = sm_count(dev, sms, &n_sms);
  if (err != cudaSuccess) return err;
  std::atomic<int>& cached = per_sm[dev][(slabs - 1) * kWarps + bins - 1];
  int resident = cached.load(std::memory_order_relaxed);
  if (resident == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel,
                                                        threads, smem);
    if (err != cudaSuccess) return err;
    resident = std::max(resident, 1);
    cached.store(resident, std::memory_order_relaxed);
  }
  const long long tiles = static_cast<long long>((f + bins - 1) / bins) *
                          row_tiles * ((kod + KT - 1) / KT);
  const unsigned grid = static_cast<unsigned>(
      std::min(tiles, static_cast<long long>(n_sms) * resident));
  kernel<<<grid, threads, smem, s>>>(w, a, b, out, f, vi, pp, kod, slabs,
                                     row_tiles, bins);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// a row of fdl is Q = 2 * pp values of `bytes` each: rows start on 16 bytes
// for pp a multiple of 8 / bytes
bool refused(const void* fdl, const void* rhs2, const void* m, int f, int vi,
             int pp, int kod, int bytes) {
  return f <= 0 || vi <= 0 || pp <= 0 || kod <= 0 || pp % (8 / bytes) ||
         kod % 4 || !aligned16(fdl) || !aligned16(rhs2) || !aligned16(m);
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
  if (refused(fdl, rhs2, m, f, vi, pp, kod, 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const int* w = static_cast<const int*>(wptr);
  const float* a = static_cast<const float*>(fdl);
  const float* b = static_cast<const float*>(rhs2);
  float* out = static_cast<float*>(m);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kod <= 16) return launch_f32<16>(w, a, b, out, f, vi, pp, kod, s);
  if (kod <= 32) return launch_f32<32>(w, a, b, out, f, vi, pp, kod, s);
  if (kod <= 48) return launch_f32<48>(w, a, b, out, f, vi, pp, kod, s);
  return launch_f32<64>(w, a, b, out, f, vi, pp, kod, s);
}

// The same with fdl and rhs2 bf16 (m f32): pp must be a multiple of 4.
extern "C" int ring_mac_bf16_launch(const void* wptr, const void* fdl,
                                    const void* rhs2, void* m, int f, int vi,
                                    int pp, int kod, void* stream) {
  if (refused(fdl, rhs2, m, f, vi, pp, kod, 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const int* w = static_cast<const int*>(wptr);
  const bf16* a = static_cast<const bf16*>(fdl);
  const bf16* b = static_cast<const bf16*>(rhs2);
  float* out = static_cast<float*>(m);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kod <= 16) return launch_bf16<16>(w, a, b, out, f, vi, pp, kod, s);
  if (kod <= 32) return launch_bf16<32>(w, a, b, out, f, vi, pp, kod, s);
  if (kod <= 48) return launch_bf16<48>(w, a, b, out, f, vi, pp, kod, s);
  return launch_bf16<64>(w, a, b, out, f, vi, pp, kod, s);
}

extern "C" const char* ring_mac_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
