// Per-kernel launch attributes, set once per (instantiation, device).
//
// A kernel that asks for more than 48 KB of dynamic shared memory must
// first raise its limit with cudaFuncSetAttribute.  That is a host call
// into the CUDA runtime: made before every launch, it adds to every
// launch's host time, so the kernels that need it make it here, once per
// instantiation and device, for the most a block may have on the device.
// The dynamic limit is the block's opt-in maximum less the kernel's own
// static shared memory (the runtime refuses more).  The carveout (by
// default the largest share of the SM's unified L1/shared memory) is set
// here too, so the occupancy the host plans with is what the card gives;
// cudaSharedmemCarveoutDefault keeps the CUDA default.
#pragma once

#include <cuda_runtime.h>

#include <mutex>

namespace repro_torch {

constexpr int kMaxDevices = 64;

// The CUDA error of setting Kernel's attributes on `device` (the current
// device), the same on every call: only the first call sets them.
template <auto Kernel, int Carveout = cudaSharedmemCarveoutMaxShared>
int configure_smem_once(int device) {
  static std::once_flag once[kMaxDevices];
  static int result[kMaxDevices];
  if (device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  std::call_once(once[device], [device] {
    int most = 0;
    cudaFuncAttributes attrs = {};
    cudaError_t err = cudaDeviceGetAttribute(
        &most, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attrs, Kernel);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          most - static_cast<int>(attrs.sharedSizeBytes));
    if (err == cudaSuccess && Carveout != cudaSharedmemCarveoutDefault)
      err = cudaFuncSetAttribute(
          Kernel, cudaFuncAttributePreferredSharedMemoryCarveout, Carveout);
    result[device] = static_cast<int>(err);
  });
  return result[device];
}

}  // namespace repro_torch
