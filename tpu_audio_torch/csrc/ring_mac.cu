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
// What bounds it on an H100: bytes. At 64 voices (F=257, VI=128, Pp=696,
// KOD=16) one call reads the 183 MB delay line once plus a 23 MB rhs
// window, ~206 MB, against 1.5 GFLOP: ~7 FLOP/byte, far below the card's
// f32 ridge point, so the floor is ~61 us at 3.35 TB/s.
//
// Design against that bound:
//   - one block per (bin f, tile of KT output columns); the block stages
//     its whole rhs window [Q, KT] into shared memory ONCE, with 16-byte
//     loads, so after staging the only device-memory traffic is the delay
//     line, read exactly once;
//   - each warp walks groups of kRows delay-line rows; the 32 lanes read 32
//     neighbouring q of a row (coalesced 128-byte rows) and kUnroll such
//     loads per row are issued before any arithmetic, to keep bytes in
//     flight;
//   - one window value read from shared memory feeds kRows FMAs, so
//     shared-memory traffic stays below the device-memory time;
//   - the window's row stride is KT + 1 floats (odd), so 32 lanes reading
//     32 consecutive window rows hit 32 distinct banks;
//   - the ring slot is read from a device int32 (the engine's block
//     counter), the counterpart of Pallas scalar prefetch: the host never
//     syncs to learn it;
//   - f32 FMA only (no TF32, no tensor cores): each lane sums its share of
//     q in f32, then a warp butterfly adds the 32 partial sums.
// The column tile KT is the largest of 16, 8, 4 that divides KOD and whose
// window fits in shared memory; a larger KOD costs one more pass over the
// delay line per extra tile. The launch allocates nothing and does not
// synchronise; it returns a cudaError_t so the caller can raise.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kWarps = 8;                   // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 4;                    // delay-line rows per warp pass
constexpr int kUnroll = 4;                  // q loads per row in flight

template <int KT>
__global__ void __launch_bounds__(kThreads, 2)
ring_mac_kernel(const int* __restrict__ wptr, const float* __restrict__ fdl,
                const float* __restrict__ rhs2, float* __restrict__ m,
                int vi_count, int pp, int kod) {
  extern __shared__ float win[];            // [Q][KT + 1]

  const int f = blockIdx.x;
  const int col0 = blockIdx.y * KT;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q_total = 2 * pp;

  int w = wptr[0] % pp;
  if (w < 0) w += pp;
  const int start = pp - w;

  // stage the window: row j = c*pp + s <- rhs2[f, c, start + s, col0:col0+KT]
  const float* rhs_f = rhs2 + (size_t)f * 2 * q_total * kod + col0;
  constexpr int kVec = KT / 4;
  for (int e = threadIdx.x; e < q_total * kVec; e += kThreads) {
    const int j = e / kVec;
    const int v = e - j * kVec;
    const int c = j >= pp ? 1 : 0;
    const size_t src = ((size_t)c * q_total + start + (j - c * pp)) * kod;
    const float4 b = __ldg(reinterpret_cast<const float4*>(rhs_f + src) + v);
    float* dst = win + j * (KT + 1) + 4 * v;
    dst[0] = b.x;
    dst[1] = b.y;
    dst[2] = b.z;
    dst[3] = b.w;
  }
  __syncthreads();

  const float* fdl_f = fdl + (size_t)f * vi_count * q_total;
  for (int row0 = warp * kRows; row0 < vi_count; row0 += kWarps * kRows) {
    const float* rows[kRows];
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

    for (int q0 = lane; q0 < q_total; q0 += 32 * kUnroll) {
      float x[kUnroll][kRows];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int q = q0 + 32 * u;
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          x[u][r] = (live[r] && q < q_total) ? __ldcs(rows[r] + q) : 0.f;
      }
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
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int k = 0; k < KT; ++k)
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          acc[r][k] += __shfl_xor_sync(0xffffffffu, acc[r][k], off);

    // every lane holds every sum; spread the stores over the lanes
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (!live[r]) continue;
      float* out = m + ((size_t)f * vi_count + row0 + r) * kod + col0;
#pragma unroll
      for (int k = 0; k < KT; ++k)
        if (((r * KT + k) & 31) == lane) out[k] = acc[r][k];
    }
  }
}

template <int KT>
cudaError_t launch(const int* w, const float* a, const float* b, float* out,
                   int f, int vi, int pp, int kod, size_t smem,
                   cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      ring_mac_kernel<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(f, kod / KT);
  ring_mac_kernel<KT><<<grid, kThreads, smem, s>>>(w, a, b, out, vi, pp, kod);
  return cudaGetLastError();
}

}  // namespace

// wptr: device int32 block counter (reduced mod pp in the kernel);
// fdl f32 [f, vi, 2, pp]; rhs2 f32 [f, 2, 2*pp, kod]; m f32 [f, vi, kod].
// kod must be a multiple of 4 and every pointer 16-byte aligned. Returns a
// cudaError_t: the launch's, or cudaErrorInvalidValue when no column tile's
// window fits in shared memory.
extern "C" int ring_mac_launch(const void* wptr, const void* fdl,
                               const void* rhs2, void* m, int f, int vi,
                               int pp, int kod, void* stream) {
  int dev = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int* w = static_cast<const int*>(wptr);
  const float* a = static_cast<const float*>(fdl);
  const float* b = static_cast<const float*>(rhs2);
  float* out = static_cast<float*>(m);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t q_total = 2 * static_cast<size_t>(pp);
  const size_t max_smem = static_cast<size_t>(smem_max);
  if (kod % 16 == 0 && q_total * 17 * sizeof(float) <= max_smem)
    return static_cast<int>(launch<16>(w, a, b, out, f, vi, pp, kod,
                                       q_total * 17 * sizeof(float), s));
  if (kod % 8 == 0 && q_total * 9 * sizeof(float) <= max_smem)
    return static_cast<int>(launch<8>(w, a, b, out, f, vi, pp, kod,
                                      q_total * 9 * sizeof(float), s));
  if (kod % 4 == 0 && q_total * 5 * sizeof(float) <= max_smem)
    return static_cast<int>(launch<4>(w, a, b, out, f, vi, pp, kod,
                                      q_total * 5 * sizeof(float), s));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ring_mac_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
