// A kernel's dynamic shared-memory limit, raised and never lowered.
//
// cudaFuncAttributeMaxDynamicSharedMemorySize belongs to the kernel on the
// current device, not to the calling thread.  When several host threads
// launch one kernel at shapes that need different amounts (the agents'
// optimization threads, each at its own robot's n and s), setting the
// limit to each launch's own need lets one thread lower it between another
// thread's set and launch, and that launch then fails with
// cudaErrorInvalidValue.  Here the limit only ever rises, under one lock,
// so a launch never finds it below what the launch needs.  A limit above a
// launch's need changes nothing about that launch: its occupancy follows
// the bytes it asks for.

#pragma once

#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <utility>

namespace {

cudaError_t raise_smem_limit(const void* kern, int smem) {
  static std::mutex mu;
  static std::map<std::pair<int, const void*>, int> limits;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  int& limit = limits[{device, kern}];
  if (smem <= limit) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) limit = smem;
  return err;
}

}  // namespace
