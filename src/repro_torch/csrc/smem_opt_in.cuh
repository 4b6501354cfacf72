// The dynamic shared-memory opt-in of a kernel that needs more than 48 KiB,
// taken once per device and kernel rather than on every launch.
//
// cudaFuncSetAttribute is not a stream operation, so a CUDA graph does not
// record it; the port's decode step is captured as a graph (serve/
// engine_api.py), and K4/K6 take the opt-in at grp 6 and 16.  Each launch
// function keeps one SmemOptIn per kernel instantiation (a function-local
// static), so the first launch on a device sets the attribute and every
// later one, a captured one included, finds it set.
#pragma once

#include <atomic>

#include <cuda_runtime.h>

struct SmemOptIn {
  static constexpr int kMaxDevices = 64;
  std::atomic<int> granted[kMaxDevices];   // bytes granted, per device
};

template <typename Kernel>
inline cudaError_t opt_in_smem(SmemOptIn& g, Kernel kern, int bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 0 && dev < SmemOptIn::kMaxDevices &&
      bytes <= g.granted[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev >= 0 && dev < SmemOptIn::kMaxDevices) {
    int seen = g.granted[dev].load(std::memory_order_relaxed);
    while (seen < bytes && !g.granted[dev].compare_exchange_weak(
                               seen, bytes, std::memory_order_release))
      ;
  }
  return err;
}
