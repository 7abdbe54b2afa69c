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
//   - the same tiles as the f32 form (one bin, 128 rows, all KT columns, KT
//     16 to 64) and the same cp.async zero-fill copies (the window row
//     computed per row, columns past KOD zeroed), in chunks of kBQC = 64 q:
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
//     stores. m leaves the C fragments as float2 (8 bytes, KOD is even).
// The window moves in 16-byte copies of 8 columns when KOD % 8 == 0, else
// in 8-byte copies of 4 (a row of rhs2 then starts on 8 bytes only).
// KOD > 64 splits into column groups of 64 among the tiles.
//
// Alignment: fdl rows start on 16 bytes only if Q values (4 bytes each in
// f32, 2 in bf16) make a multiple of 16, so the launch refuses an odd Pp
// for f32 and a Pp that is not a multiple of 4 for bf16 (the engine pads Pp
// to a multiple of 8).
// The launch allocates nothing and does not synchronise; it returns a
// cudaError_t so the caller can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>

#include "cp_async.cuh"
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

// -- bf16 on the tensor cores ---------------------------------------------

constexpr int kBQC = 64;                    // q per bf16 chunk
constexpr int kBStages = 4;                 // depth of the bf16 ring
// line tile row stride in bf16: 144 bytes, so ldmatrix's eight 16-byte
// rows fall in distinct banks; the window tile's is KT + 8 bf16 for the
// same reason
constexpr int kBAStride = kBQC + 8;

template <int KT>
__host__ __device__ constexpr int bf16_stage_elems() {
  return kRows * kBAStride + kBQC * (KT + 8);
}

// a chunk's window tile, q in [a, a + kBQC): row j is rhs2[f, c, start + s]
// for q = a + j = c * pp + s, V columns a copy (V = 8: 16 bytes, 4: 8);
// rows past Q and columns past `cols` are zero-filled
template <int KT, int V>
__device__ __forceinline__ void copy_window(bf16* bs, const bf16* rhs_f,
                                            const bf16* any, int a, int pp,
                                            int start, int kod, int cols,
                                            int tid) {
  constexpr int kPerRow = KT / V;
  const int q_total = 2 * pp;
  for (int e = tid; e < kBQC * kPerRow; e += kThreads) {
    const int j = e / kPerRow;
    const int col = V * (e % kPerRow);
    const int q = a + j;
    const int c = q >= pp ? 1 : 0;
    const bool ok = q < q_total && col < cols;
    const size_t row = (size_t)c * q_total + start + (q - c * pp);
    copy_vec<2 * V>(bs + j * (KT + 8) + col,
                    ok ? rhs_f + row * kod + col : any, ok);
  }
}

template <int KT>
__global__ void __launch_bounds__(kThreads, 2)
ring_mac_bf16_kernel(const int* __restrict__ wptr,
                     const bf16* __restrict__ fdl,
                     const bf16* __restrict__ rhs2, float* __restrict__ m,
                     int f_count, int vi_count, int pp, int kod) {
  constexpr int kStage = bf16_stage_elems<KT>();
  constexpr int kVecs = kBQC / 8;            // 16-byte vectors per line row
  extern __shared__ __align__(16) float smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  const int row_tiles = (vi_count + kRows - 1) / kRows;
  const int col_groups = (kod + KT - 1) / KT;
  const int tiles = f_count * row_tiles * col_groups;
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

  int w = wptr[0] % pp;
  if (w < 0) w += pp;
  const int start = pp - w;                 // window row of slot 0
  const bool vec16 = kod % 8 == 0;

  struct Tile {
    int f, row0, col0, rows, cols;
  };
  auto tile = [&](int k) {
    int t = block + k * blocks;
    Tile u;
    u.col0 = (t % col_groups) * KT;
    t /= col_groups;
    u.row0 = (t % row_tiles) * kRows;
    u.f = t / row_tiles;
    u.rows = min(kRows, vi_count - u.row0);
    u.cols = min(KT, kod - u.col0);
    return u;
  };

  auto load = [&](int g) {
    const Tile u = tile(g / chunks);
    const int a = (g % chunks) * kBQC;
    bf16* as = smem + (g % kBStages) * kStage;
    const bf16* line = fdl + ((size_t)u.f * vi_count + u.row0) * q_total;
    for (int e = tid; e < kRows * kVecs; e += kThreads) {
      const int r = e / kVecs;
      const int qq = 8 * (e % kVecs);
      const bool ok = r < u.rows && a + qq < q_total;
      copy16_l2pf(as + r * kBAStride + qq,
                  ok ? line + (size_t)r * q_total + a + qq : fdl, ok);
    }
    const bf16* rhs_f = rhs2 + (size_t)u.f * 2 * q_total * kod + u.col0;
    bf16* bs = as + kRows * kBAStride;
    if (vec16)
      copy_window<KT, 8>(bs, rhs_f, rhs2, a, pp, start, kod, u.cols, tid);
    else
      copy_window<KT, 4>(bs, rhs_f, rhs2, a, pp, start, kod, u.cols, tid);
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
    const bf16* as = smem + (g % kBStages) * kStage;
    if (16 * warp < u.rows)
      mma_chunk<kBQC, KT, kBAStride, KT + 8>(acc, as, as + kRows * kBAStride,
                                            warp, lane);
    if (i == chunks - 1) {
      // the tile's m from the C fragments: rows r and r + 8, columns 2t
      // and 2t + 1 of each n8 tile
      const int r = 16 * warp + lane / 4;
      float* out = m + ((size_t)u.f * vi_count + u.row0 + r) * kod + u.col0;
#pragma unroll
      for (int n = 0; n < KT / 8; ++n) {
        const int col = 8 * n + 2 * (lane % 4);
        if (col < u.cols) {
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

template <int KT>
cudaError_t launch(const int* w, const float* a, const float* b, float* out,
                   int f, int vi, int pp, int kod, cudaStream_t s) {
  constexpr size_t smem = kStages * stage_elems<KT>() * sizeof(float);
  static_assert(smem >= KT * kRows * sizeof(float),
                "the stages must hold group 1's parked sums");
  cudaError_t err = cudaFuncSetAttribute(
      ring_mac_kernel<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const unsigned row_tiles = static_cast<unsigned>((vi + kRows - 1) / kRows);
  const dim3 grid(static_cast<unsigned>(f) * row_tiles,
                  static_cast<unsigned>((kod + KT - 1) / KT));
  ring_mac_kernel<KT><<<grid, kThreads, smem, s>>>(w, a, b, out, vi, pp, kod);
  return cudaGetLastError();
}

template <int KT>
cudaError_t launch_bf16(const int* w, const bf16* a, const bf16* b,
                        float* out, int f, int vi, int pp, int kod,
                        cudaStream_t s) {
  constexpr int smem = kBStages * bf16_stage_elems<KT>() * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      ring_mac_bf16_kernel<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  // as many blocks as the card holds at once (asked once per build), each
  // walking its share of the tiles
  static const int per_sm = [] {
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, ring_mac_bf16_kernel<KT>, kThreads, smem) != cudaSuccess)
      n = 1;
    return std::max(n, 1);
  }();
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long tiles = static_cast<long long>(f) *
                          ((vi + kRows - 1) / kRows) * ((kod + KT - 1) / KT);
  const unsigned grid = static_cast<unsigned>(
      std::min(tiles, static_cast<long long>(sms) * per_sm));
  ring_mac_bf16_kernel<KT><<<grid, kThreads, smem, s>>>(w, a, b, out, f, vi,
                                                        pp, kod);
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
  if (kod <= 16) return launch<16>(w, a, b, out, f, vi, pp, kod, s);
  if (kod <= 32) return launch<32>(w, a, b, out, f, vi, pp, kod, s);
  if (kod <= 48) return launch<48>(w, a, b, out, f, vi, pp, kod, s);
  return launch<64>(w, a, b, out, f, vi, pp, kod, s);
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
