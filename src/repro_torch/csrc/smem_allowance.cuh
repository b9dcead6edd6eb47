// A kernel's dynamic shared-memory allowance, set once per device.
#pragma once
#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

// Raises `kernel`'s dynamic shared-memory allowance to `bytes` once per
// device (`done`: a bit per device, one flag per instantiation): the
// attribute stays set, and each cudaFuncSetAttribute call costs the host
// time.
template <typename Kernel>
cudaError_t allow_smem_once(std::atomic<uint64_t>& done, Kernel kernel,
                            size_t bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? 1ull << dev : 0;
  if (done.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}
