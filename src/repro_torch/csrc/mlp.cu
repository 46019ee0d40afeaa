// Fully fused tiny MLP for Hopper (NeRF's colour MLP on the serve path).
//
// Replaces the JAX package's kernels/fused_mlp/fused_mlp.py:
// fused_mlp_pallas (body _mlp_kernel). One thread block copies a tile of
// kRows input rows into shared memory and runs the shared MLP device code
// (mlp.cuh) on it; hidden activations stay in shared memory.
//
// What bounds it on the card: at NeRF's colour MLP (32 -> 64 x 4 -> 3) a row
// moves 140 bytes and does 29,056 flops, so f32 arithmetic bounds it, not
// memory. The design reads each weight from L1 once per row it multiplies
// and each activation from shared memory, on the CUDA cores; moving the
// products onto the tensor cores (wgmma) is later work.
#include <cuda_runtime.h>

#include "mlp.cuh"

namespace repro {

__global__ void __launch_bounds__(kThreads) mlp_fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ w_in,
    const float* __restrict__ w_hidden, const float* __restrict__ w_out,
    const MlpDims d, float* __restrict__ out, long long n_rows_total) {
  extern __shared__ float smem[];
  float* xs = smem;                                     // kRows x (din + 1)
  float* buf_a = xs + kRows * (d.din + 1);
  float* buf_b = buf_a + kRows * (d.hidden + 1);
  const long long row0 = (long long)blockIdx.x * kRows;
  const int n_rows = (int)min((long long)kRows, n_rows_total - row0);
  for (int idx = threadIdx.x; idx < n_rows * d.din; idx += blockDim.x) {
    const int p = idx / d.din, k = idx - p * d.din;
    xs[p * (d.din + 1) + k] = x[(row0 + p) * d.din + k];
  }
  __syncthreads();
  mlp_tile(xs, buf_a, buf_b, w_in, w_hidden, w_out, d, out, row0, n_rows);
}

}  // namespace repro

// x (B, din) f32; w_in (din, hidden), w_hidden (n_hidden - 1, hidden,
// hidden), w_out (hidden, dout) f32; out (B, dout) f32.
// Launches on `stream` after making `device` current; returns the CUDA
// error of the launch (0 on success).
extern "C" int mlp_fwd(const float* x, const float* w_in, const float* w_hidden,
                       const float* w_out, int din, int hidden, int n_hidden,
                       int dout, float* out, long long n_rows, int device,
                       void* stream) {
  if (cudaError_t err = cudaSetDevice(device)) return err;
  using namespace repro;
  if (n_rows == 0) return cudaSuccess;
  const MlpDims d{din, hidden, n_hidden, dout};
  const size_t smem = mlp_smem_floats(d) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        mlp_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const unsigned blocks = (unsigned)((n_rows + kRows - 1) / kRows);
  mlp_fwd_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, w_in, w_hidden, w_out, d, out, n_rows);
  return cudaGetLastError();
}
