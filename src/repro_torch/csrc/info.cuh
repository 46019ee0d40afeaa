// Resource query of one kernel instantiation, for the budget check
// (src/repro_torch/analysis/budget.py; kernels/info.py binds the entry
// points). Each source's <kernel>_info entry point picks the instantiation
// its launch would take and fills, through kernel_info, the numbers a
// launch of it would see: threads per block, the dynamic shared memory its
// launcher passes, and what CUDA says of the compiled kernel (static shared
// memory, registers per thread, local memory, and the blocks per SM that
// fit at that block size and shared memory).
#pragma once

#include <cuda_runtime.h>

namespace repro {

// Filled in this order by kernel_info.
enum KernelInfoField {
  kInfoThreads = 0,
  kInfoDynamicSmem,
  kInfoStaticSmem,
  kInfoRegisters,
  kInfoLocalBytes,
  kInfoBlocksPerSm,
  kInfoFields
};

// max_dynamic_smem: the dynamic shared-memory limit the kernel's launcher
// sets before its first launch (0 for a kernel whose launcher sets none),
// set here too, so the occupancy is the one its launches get.
inline cudaError_t kernel_info(const void* kernel, int threads,
                               size_t dynamic_smem, int max_dynamic_smem,
                               int device, int* out) {
  if (cudaError_t err = cudaSetDevice(device)) return err;
  if (max_dynamic_smem > 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        max_dynamic_smem);
    if (err != cudaSuccess) return err;
  }
  cudaFuncAttributes a;
  if (cudaError_t err = cudaFuncGetAttributes(&a, kernel)) return err;
  int per_sm = 0;
  if (cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, threads, dynamic_smem))
    return err;
  out[kInfoThreads] = threads;
  out[kInfoDynamicSmem] = (int)dynamic_smem;
  out[kInfoStaticSmem] = (int)a.sharedSizeBytes;
  out[kInfoRegisters] = a.numRegs;
  out[kInfoLocalBytes] = (int)a.localSizeBytes;
  out[kInfoBlocksPerSm] = per_sm;
  return cudaSuccess;
}

}  // namespace repro
