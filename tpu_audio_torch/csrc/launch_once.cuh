// Launch-side state kept once per device by the port's kernels: the
// current device as an index, a kernel's dynamic shared-memory ceiling
// raised once per device, and the device's SM count asked once. Nothing
// here runs at every launch after a device's first, so a launch can be
// captured in a CUDA graph once each of its shapes has run.

#pragma once

#include <cuda_runtime.h>

#include <atomic>

constexpr int kMaxDevices = 64;             // launch state kept per device

// the device this host thread launches on, an index into per-device state
inline cudaError_t current_device(int* dev) {
  cudaError_t err = cudaGetDevice(dev);
  if (err == cudaSuccess && (*dev < 0 || *dev >= kMaxDevices))
    err = cudaErrorInvalidDevice;
  return err;
}

// raise `kernel`'s dynamic shared-memory ceiling to `bytes` on device
// `dev`, once: `done` holds the kernel's flags, one per device
template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, int bytes, int dev,
                       std::atomic<bool> (&done)[kMaxDevices]) {
  if (done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done[dev].store(true, std::memory_order_release);
  return err;
}

// the SM count of device `dev`, asked once: `cache` holds it per device
inline cudaError_t sm_count(int dev, std::atomic<int> (&cache)[kMaxDevices],
                            int* n) {
  *n = cache[dev].load(std::memory_order_relaxed);
  if (*n > 0) return cudaSuccess;
  const cudaError_t err =
      cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) cache[dev].store(*n, std::memory_order_relaxed);
  return err;
}
