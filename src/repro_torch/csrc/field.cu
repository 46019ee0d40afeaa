// Fused grid encode + MLP (the neural fields processor) for Hopper.
//
// Replaces the JAX package's kernels/fused_field/fused_field.py:
// fused_field_pallas (body _field_kernel): field_fwd for f32 tables,
// field_fwd_q for int8 / fp8-e4m3 tables with per-level f32 scales (its
// quantized branch, fused_field.py:41,58,164-166). One thread block takes a
// tile of kRows points: its threads encode every (point, level) pair of the
// tile into a shared-memory feature buffer (kRows x L*F f32), then run the
// MLP from there (mlp.cuh). The encoded features never reach device memory.
//
// What bounds it on the card: at Table-I nerf_hash width each point gathers
// 16 levels x 8 corners x F=2 features from the table stack, and then does
// 22,528 flops of f32 MLP on the CUDA cores. An f32 stack is 64 MiB, more
// than the 50 MB L2; an int8 or fp8 stack is 16 MiB and fits, and a code row
// is one 2-byte load. The design keeps the gathers of one warp on one level
// (consecutive threads take consecutive points of the same level), so
// nearby points of a tile share table rows in L1/L2, and keeps every
// activation in shared memory. The quantized kernel reads its scale per
// (point, level) task from the scene's (L,) scales on the device, so the
// host never reads a scale. Tensor cores (wgmma), TMA and a persistent
// schedule are later work.
#include <cstdint>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include "encode.cuh"
#include "mlp.cuh"

namespace repro {

template <int DIM, int F, typename TableT>
__global__ void __launch_bounds__(kThreads) field_fwd_kernel(
    const float* __restrict__ points, const TableT* __restrict__ tables,
    const float* __restrict__ scales, const LevelMeta meta, int n_levels,
    int log2_table_size, const float* __restrict__ w_in,
    const float* __restrict__ w_hidden, const float* __restrict__ w_out,
    const MlpDims d, float* __restrict__ out, long long n_points) {
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
    encode_one_level<DIM, F, TableT>(
        pt, tables + level * level_stride, meta.res[level],
        meta.hashed[level] != 0, mask, level_scale<TableT>(scales, level),
        feat + p * (d.din + 1) + level * F);
  }
  __syncthreads();
  mlp_tile(feat, buf_a, buf_b, w_in, w_hidden, w_out, d, out, row0, n_rows);
}

template <int DIM, int F, typename TableT>
cudaError_t launch_field(const float* points, const void* tables,
                         const float* scales, const LevelMeta& meta,
                         int n_levels, int log2_table_size, const float* w_in,
                         const float* w_hidden, const float* w_out,
                         const MlpDims& d, float* out, long long n_points,
                         cudaStream_t stream) {
  const size_t smem = mlp_smem_floats(d) * sizeof(float);
  auto kernel = field_fwd_kernel<DIM, F, TableT>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const unsigned blocks = (unsigned)((n_points + kRows - 1) / kRows);
  kernel<<<blocks, kThreads, smem, stream>>>(
      points, static_cast<const TableT*>(tables), scales, meta, n_levels,
      log2_table_size, w_in, w_hidden, w_out, d, out, n_points);
  return cudaGetLastError();
}

// The launch of field_fwd (table_dtype kTableF32, no scales) and
// field_fwd_q (kTableInt8 / kTableFp8E4M3 with scales).
int field_entry(const float* points, const void* tables, const float* scales,
                int table_dtype, const int* level_meta, int n_levels,
                int log2_table_size, int dim, int n_features,
                const float* w_in, const float* w_hidden, const float* w_out,
                int din, int hidden, int n_hidden, int dout, float* out,
                long long n_points, int device, void* stream) {
  if (cudaError_t err = cudaSetDevice(device)) return err;
  if (n_points == 0) return cudaSuccess;
  LevelMeta meta;
  if (!fill_level_meta(level_meta, n_levels, &meta) ||
      din != n_levels * n_features || log2_table_size < 1 ||
      log2_table_size > 31)
    return cudaErrorInvalidValue;
  const MlpDims d{din, hidden, n_hidden, dout};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_FIELD_CASE(D, FF, CODE, T)                                       \
  if (dim == D && n_features == FF && table_dtype == CODE)                     \
    return launch_field<D, FF, T>(points, tables, scales, meta, n_levels,      \
                                  log2_table_size, w_in, w_hidden, w_out, d,   \
                                  out, n_points, s);
  REPRO_FIELD_CASE(3, 2, kTableF32, float)
  REPRO_FIELD_CASE(3, 8, kTableF32, float)
  REPRO_FIELD_CASE(3, 2, kTableInt8, int8_t)
  REPRO_FIELD_CASE(3, 8, kTableInt8, int8_t)
  REPRO_FIELD_CASE(3, 2, kTableFp8E4M3, __nv_fp8_e4m3)
  REPRO_FIELD_CASE(3, 8, kTableFp8E4M3, __nv_fp8_e4m3)
#undef REPRO_FIELD_CASE
  return cudaErrorInvalidValue;
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
  return repro::field_entry(points, tables, nullptr, repro::kTableF32,
                            level_meta, n_levels, log2_table_size, dim,
                            n_features, w_in, w_hidden, w_out, din, hidden,
                            n_hidden, dout, out, n_points, device, stream);
}

// As field_fwd, for a table of int8 (table_dtype 1) or fp8-e4m3 (2) codes;
// `scales` is a DEVICE array of the L per-level f32 scales (the scene's
// (L, 1, 1) grid_scale leaf).
extern "C" int field_fwd_q(const float* points, const void* tables,
                           const float* scales, int table_dtype,
                           const int* level_meta, int n_levels,
                           int log2_table_size, int dim, int n_features,
                           const float* w_in, const float* w_hidden,
                           const float* w_out, int din, int hidden,
                           int n_hidden, int dout, float* out,
                           long long n_points, int device, void* stream) {
  if (table_dtype == repro::kTableF32 || scales == nullptr)
    return cudaErrorInvalidValue;
  return repro::field_entry(points, tables, scales, table_dtype, level_meta,
                            n_levels, log2_table_size, dim, n_features, w_in,
                            w_hidden, w_out, din, hidden, n_hidden, dout, out,
                            n_points, device, stream);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
