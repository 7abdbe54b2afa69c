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
// What bounds it on an H100: bytes. At 64 voices (F=257, VI=128, Pp=696,
// KOD=16) one call reads the 183 MB delay line and writes it back, and reads
// 23 MB of rhs: ~389 MB against 1.5 GFLOP, ~4 FLOP/byte, far below the
// card's f32 ridge point, so the floor is ~116 us at 3.35 TB/s.
//
// Design against that bound, after ring_mac.cu:
//   - one block per bin f owns every row of that bin, so no other block
//     ever reads or writes them;
//   - the block stages the bin's rhs column tile in shared memory ONCE,
//     pre-shifted: window row q = c*Pp + s holds rhs[f, c, s + 1] (zero at
//     s = Pp - 1), so the OLD value at q pairs with window row q and the
//     shifted line never has to exist before the MAC; rhs[f, c, 0] is
//     staged beside it for the x_new term. The window's row stride is
//     KT + 1 floats (odd), so 32 lanes reading 32 consecutive rows hit 32
//     distinct banks;
//   - each warp walks groups of kRows rows; 32 lanes read 32 neighbouring q
//     (coalesced 128-byte rows), kUnroll loads per row in flight, and one
//     window value feeds kRows FMAs;
//   - f32 FMA only (no TF32, no tensor cores): each lane sums its share of
//     q, then a warp butterfly adds the 32 partial sums.
//
// The in-place race, and how it is avoided. A lane that writes slot s+1
// clobbers the old value there, which another lane, or the next chunk of
// the same row, may not have read yet. So each warp walks a row's chunks of
// 32*kUnroll values from the TAIL toward q = 0: chunk [a, b) writes
// fdl'[q + 1] for q in [a, b) (never across a plane boundary) and x_new
// into the slot-0 positions it owns, i.e. only addresses >= a, which are
// either in this chunk (loaded already) or in the chunk above (loaded one
// iteration earlier). A __syncwarp() between a chunk's loads and its
// stores orders every lane's read before any lane's write. Each address is
// written exactly once: slot s >= 1 by the owner of slot s - 1, slot 0 by
// its own owner.
//
// The column-tile race, and how it is avoided. ring_mac splits KOD over
// grid.y tiles when a window of all KOD columns does not fit in shared
// memory; here two blocks of one bin would then read rows that the other
// had already shifted. Instead the one block of a bin loops over its column
// tiles (KT = the largest of 16, 8, 4 that divides KOD and fits), restages
// the window for each, and writes the shifted rows only during the LAST
// pass, after its last read of them; a __syncthreads() separates the
// passes. A KOD wider than one tile costs one more read of the delay line
// per extra tile. The launch allocates nothing and does not synchronise;
// it returns a cudaError_t so the caller can raise.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kWarps = 8;                   // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 4;                    // delay-line rows per warp pass
constexpr int kUnroll = 4;                  // q loads per row in flight
constexpr int kChunk = 32 * kUnroll;        // q values per warp chunk

template <int KT>
__global__ void __launch_bounds__(kThreads, 2)
mac_shift_kernel(float* __restrict__ fdl, const float* __restrict__ x_new,
                 const float* __restrict__ rhs, float* __restrict__ m,
                 int vi_count, int pp, int kod) {
  extern __shared__ float smem[];
  const int q_total = 2 * pp;
  float* win = smem;                        // [Q][KT + 1], pre-shifted
  float* head = smem + q_total * (KT + 1);  // [2][KT]: rhs[f, c, 0]

  const int f = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tiles = kod / KT;
  const int chunks = (q_total + kChunk - 1) / kChunk;

  const float* rhs_f = rhs + (size_t)f * q_total * kod;
  float* fdl_f = fdl + (size_t)f * vi_count * q_total;
  const float* xn_f = x_new + (size_t)f * vi_count * 2;

  for (int tile = 0; tile < tiles; ++tile) {
    const int col0 = tile * KT;
    const bool last = tile == tiles - 1;
    if (tile > 0) __syncthreads();          // every warp is done with the window

    // stage: row j = c*pp + s <- rhs[f, c, s + 1, col0:col0+KT] (0 at s = pp-1)
    constexpr int kVec = KT / 4;
    for (int e = threadIdx.x; e < q_total * kVec; e += kThreads) {
      const int j = e / kVec;
      const int v = e - j * kVec;
      const int c = j >= pp ? 1 : 0;
      const int s = j - c * pp;
      float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
      if (s + 1 < pp)
        b = __ldg(reinterpret_cast<const float4*>(
                      rhs_f + ((size_t)c * pp + s + 1) * kod + col0) + v);
      float* dst = win + j * (KT + 1) + 4 * v;
      dst[0] = b.x;
      dst[1] = b.y;
      dst[2] = b.z;
      dst[3] = b.w;
    }
    for (int e = threadIdx.x; e < 2 * KT; e += kThreads) {
      const int c = e / KT;
      head[e] = rhs_f[(size_t)c * pp * kod + col0 + (e - c * KT)];
    }
    __syncthreads();

    for (int row0 = warp * kRows; row0 < vi_count; row0 += kWarps * kRows) {
      float* rows[kRows];
      bool live[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        live[r] = row0 + r < vi_count;
        rows[r] = fdl_f + (size_t)(live[r] ? row0 + r : row0) * q_total;
      }
      float acc[kRows][KT];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int k = 0; k < KT; ++k) acc[r][k] = 0.f;

      // tail-first walk: see the in-place race note at the top
      for (int chunk = chunks - 1; chunk >= 0; --chunk) {
        const int q0 = chunk * kChunk + lane;
        float x[kUnroll][kRows];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int q = q0 + 32 * u;
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            x[u][r] = (live[r] && q < q_total) ? rows[r][q] : 0.f;
        }
        __syncwarp();                       // every read before any write

#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int q = q0 + 32 * u;
          if (q >= q_total) break;
          const float* wrow = win + q * (KT + 1);
#pragma unroll
          for (int k = 0; k < KT; ++k) {
            const float b = wrow[k];
#pragma unroll
            for (int r = 0; r < kRows; ++r)
              acc[r][k] = fmaf(x[u][r], b, acc[r][k]);
          }
        }

        if (last) {
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int q = q0 + 32 * u;
            if (q >= q_total) break;
            const int c = q >= pp ? 1 : 0;
            const int s = q - c * pp;
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              if (!live[r]) continue;
              if (s + 1 < pp) rows[r][q + 1] = x[u][r];
              if (s == 0) rows[r][q] = xn_f[(row0 + r) * 2 + c];
            }
          }
        }
      }

#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int k = 0; k < KT; ++k)
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            acc[r][k] += __shfl_xor_sync(0xffffffffu, acc[r][k], off);

      // every lane holds every sum: add the x_new term, spread the stores
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (!live[r]) continue;
        const float x0 = xn_f[(row0 + r) * 2];
        const float x1 = xn_f[(row0 + r) * 2 + 1];
        float* out = m + ((size_t)f * vi_count + row0 + r) * kod + col0;
#pragma unroll
        for (int k = 0; k < KT; ++k)
          if (((r * KT + k) & 31) == lane)
            out[k] = fmaf(x1, head[KT + k], fmaf(x0, head[k], acc[r][k]));
      }
    }
  }
}

template <int KT>
cudaError_t launch(float* a, const float* xn, const float* b, float* out,
                   int f, int vi, int pp, int kod, size_t smem,
                   cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      mac_shift_kernel<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  mac_shift_kernel<KT><<<f, kThreads, smem, s>>>(a, xn, b, out, vi, pp, kod);
  return cudaGetLastError();
}

size_t smem_bytes(size_t q_total, int kt) {
  return (q_total * (kt + 1) + 2 * kt) * sizeof(float);
}

}  // namespace

// fdl f32 [f, vi, 2, pp], shifted in place; x_new f32 [f, vi, 2, 1];
// rhs f32 [f, 2, pp, kod]; m f32 [f, vi, kod]. kod must be a multiple of 4
// and rhs 16-byte aligned. Returns a cudaError_t: the launch's, or
// cudaErrorInvalidValue when no column tile's window fits in shared memory.
extern "C" int mac_shift_launch(void* fdl, const void* x_new, const void* rhs,
                                void* m, int f, int vi, int pp, int kod,
                                void* stream) {
  int dev = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* a = static_cast<float*>(fdl);
  const float* xn = static_cast<const float*>(x_new);
  const float* b = static_cast<const float*>(rhs);
  float* out = static_cast<float*>(m);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t q_total = 2 * static_cast<size_t>(pp);
  const size_t max_smem = static_cast<size_t>(smem_max);
  if (kod % 16 == 0 && smem_bytes(q_total, 16) <= max_smem)
    return static_cast<int>(launch<16>(a, xn, b, out, f, vi, pp, kod,
                                       smem_bytes(q_total, 16), s));
  if (kod % 8 == 0 && smem_bytes(q_total, 8) <= max_smem)
    return static_cast<int>(launch<8>(a, xn, b, out, f, vi, pp, kod,
                                      smem_bytes(q_total, 8), s));
  if (kod % 4 == 0 && smem_bytes(q_total, 4) <= max_smem)
    return static_cast<int>(launch<4>(a, xn, b, out, f, vi, pp, kod,
                                      smem_bytes(q_total, 4), s));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* mac_shift_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
