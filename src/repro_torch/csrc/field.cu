// Fused grid encode + MLP (the neural fields processor) for Hopper.
//
// Replaces the JAX package's kernels/fused_field/fused_field.py:
// fused_field_pallas (body _field_kernel). One thread block takes a tile of
// kRows points: its threads encode every (point, level) pair of the tile
// into a shared-memory feature buffer (kRows x L*F f32), then run the MLP
// from there (mlp.cuh). The encoded features never reach device memory.
//
// What bounds it on the card: at Table-I nerf_hash width each point gathers
// 16 levels x 8 corners x F=2 f32 from a 64 MiB table stack (more than the
// 50 MB L2), and then does 22,528 flops of f32 MLP on the CUDA cores. The
// design keeps the gathers of one warp on one level (consecutive threads
// take consecutive points of the same level), so nearby points of a tile
// share table rows in L1/L2, and keeps every activation in shared memory.
// Tensor cores (wgmma), TMA and a persistent schedule are later work.
#include <cstdint>
#include <cuda_runtime.h>

#include "encode.cuh"
#include "mlp.cuh"

namespace repro {

template <int DIM, int F>
__global__ void __launch_bounds__(kThreads) field_fwd_kernel(
    const float* __restrict__ points, const float* __restrict__ tables,
    const LevelMeta meta, int n_levels, int log2_table_size,
    const float* __restrict__ w_in, const float* __restrict__ w_hidden,
    const float* __restrict__ w_out, const MlpDims d, float* __restrict__ out,
    long long n_points) {
  extern __shared__ float smem[];
  float* feat = smem;                                   // kRows x (din + 1)
  float* buf_a = feat + kRows * (d.din + 1);            // kRows x (hidden + 1)
  float* buf_b = buf_a + kRows * (d.hidden + 1);
  const long long row0 = (long long)blockIdx.x * kRows;
  const int n_rows = (int)min((long long)kRows, n_points - row0);
  const uint32_t mask = (uint32_t)((1ull << log2_table_size) - 1ull);
  const size_t level_stride = ((size_t)1 << log2_table_size) * F;

  for (int task = threadIdx.x; task < kRows * n_levels; task += blockDim.x) {
    const int p = task % kRows, level = task / kRows;
    if (p >= n_rows) continue;
    float pt[DIM];
#pragma unroll
    for (int i = 0; i < DIM; ++i) pt[i] = points[(row0 + p) * DIM + i];
    encode_one_level<DIM, F>(pt, tables + level * level_stride, meta.res[level],
                             meta.hashed[level] != 0, mask,
                             feat + p * (d.din + 1) + level * F);
  }
  __syncthreads();
  mlp_tile(feat, buf_a, buf_b, w_in, w_hidden, w_out, d, out, row0, n_rows);
}

template <int DIM, int F>
cudaError_t launch_field(const float* points, const float* tables,
                         const LevelMeta& meta, int n_levels, int log2_table_size,
                         const float* w_in, const float* w_hidden,
                         const float* w_out, const MlpDims& d, float* out,
                         long long n_points, cudaStream_t stream) {
  const size_t smem = mlp_smem_floats(d) * sizeof(float);
  auto kernel = field_fwd_kernel<DIM, F>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const unsigned blocks = (unsigned)((n_points + kRows - 1) / kRows);
  kernel<<<blocks, kThreads, smem, stream>>>(points, tables, meta, n_levels,
                                             log2_table_size, w_in, w_hidden,
                                             w_out, d, out, n_points);
  return cudaGetLastError();
}

}  // namespace repro

// points (B, dim) f32 in [0, 1]; tables (L, 2^log2_table_size, F) f32;
// level_meta: a HOST array of L (resolution, is_hashed) int32 pairs;
// w_in (din, hidden), w_hidden (n_hidden - 1, hidden, hidden),
// w_out (hidden, dout) f32; out (B, dout) f32. din must be L * F.
// Launches on `stream` after making `device` current; returns the CUDA
// error of the launch (0 on success).
extern "C" int field_fwd(const float* points, const float* tables,
                         const int* level_meta, int n_levels,
                         int log2_table_size, int dim, int n_features,
                         const float* w_in, const float* w_hidden,
                         const float* w_out, int din, int hidden, int n_hidden,
                         int dout, float* out, long long n_points,
                         int device, void* stream) {
  if (cudaError_t err = cudaSetDevice(device)) return err;
  using namespace repro;
  if (n_points == 0) return cudaSuccess;
  if (n_levels < 1 || n_levels > kMaxLevels || din != n_levels * n_features ||
      log2_table_size < 1 || log2_table_size > 31)
    return cudaErrorInvalidValue;
  LevelMeta meta;
  for (int l = 0; l < n_levels; ++l) {
    meta.res[l] = level_meta[2 * l];
    meta.hashed[l] = level_meta[2 * l + 1];
  }
  const MlpDims d{din, hidden, n_hidden, dout};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_FIELD_CASE(D, FF)                                                \
  if (dim == D && n_features == FF)                                            \
    return launch_field<D, FF>(points, tables, meta, n_levels, log2_table_size, \
                               w_in, w_hidden, w_out, d, out, n_points, s);
  REPRO_FIELD_CASE(3, 2)
  REPRO_FIELD_CASE(3, 8)
#undef REPRO_FIELD_CASE
  return cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
