// What the C entry points of the kernels with dynamic shared memory share.

#pragma once

#include <cuda_runtime.h>

namespace {

// Dynamic shared memory one block can use on sm_90 (227 KB of the SM's 256):
// SMEM_MAX_BYTES in ops/cuda/build.py.
constexpr int kSmemMaxBytes = 232448;
constexpr int kMaxDevices = 64;

// Permit `kernel` all of a block's dynamic shared memory (a launch above 48 KB
// fails without it) on the current device.  `done` holds one flag a device and
// belongs to this one kernel, so the attribute is set at the first launch and
// later launches pay one cudaGetDevice.  Threads that race set the same value.
template <class Kernel>
cudaError_t permit_shared_memory(Kernel kernel, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMaxBytes);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

}  // namespace
