// Standalone multi-resolution grid encode for Hopper: the unfused route.
//
// Replaces the JAX package's kernels/hashgrid/hashgrid.py:
// hashgrid_encode_pallas (body _encode_kernel), for f32 and bf16 tables
// and, with per-level f32 scales, for int8 / fp8-e4m3 tables (its quantized
// variant, hashgrid.py:154-155,167,177,221-223). Each thread encodes one
// point at one level with encode_one_level (encode.cuh) and writes its F
// features to the (B, L*F) f32 output in device memory. It is instantiated
// for 3-D and 2-D points, F = 2 and 8, and each table type.
//
// What bounds it on the card: per point and level it gathers 2^d table
// rows and writes F floats; at Table-I nerf_hash width (131,072 points of
// one engine tile) the distinct rows it touches and its (B, 32) f32 output
// are most of its bytes, and it does few flops, so bytes bound it. The
// launch is a (ceil(B / kEncodeRows), L) grid with the level in blockIdx.y:
// the card issues blocks in order of blockIdx.x first, so the blocks of one
// level run together and that level's table (4 MiB in f32, 2 MiB in bf16,
// 1 MiB in int8 or fp8) stays hot in the 50 MB L2 while they gather from
// it. This is the counterpart of the TPU kernel's level groups OUTER
// (hashgrid.py:226-228).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include "encode.cuh"

namespace repro {

constexpr int kEncodeRows = 256;     // points per block, one per thread

template <int DIM, int F, typename TableT>
__global__ void __launch_bounds__(kEncodeRows) encode_fwd_kernel(
    const float* __restrict__ points, const TableT* __restrict__ tables,
    const float* __restrict__ scales, const LevelMeta meta, int n_levels,
    int log2_table_size, float* __restrict__ out, long long n_points) {
  const long long p = (long long)blockIdx.x * kEncodeRows + threadIdx.x;
  const int level = blockIdx.y;
  if (p >= n_points) return;
  const uint32_t mask = (uint32_t)((1ull << log2_table_size) - 1ull);
  const size_t level_stride = ((size_t)1 << log2_table_size) * F;
  float pt[DIM];
#pragma unroll
  for (int i = 0; i < DIM; ++i) pt[i] = points[p * DIM + i];
  float feat[F];
  encode_one_level<DIM, F, TableT>(
      pt, tables + level * level_stride, meta.res[level],
      meta.hashed[level] != 0, mask, level_scale<TableT>(scales, level), feat);
  float* o = out + p * (long long)(n_levels * F) + level * F;
#pragma unroll
  for (int f = 0; f < F; ++f) o[f] = feat[f];
}

template <int DIM, int F, typename TableT>
cudaError_t launch_encode(const float* points, const void* tables,
                          const float* scales, const LevelMeta& meta,
                          int n_levels, int log2_table_size, float* out,
                          long long n_points, cudaStream_t stream) {
  const dim3 grid((unsigned)((n_points + kEncodeRows - 1) / kEncodeRows),
                  (unsigned)n_levels);
  encode_fwd_kernel<DIM, F, TableT><<<grid, kEncodeRows, 0, stream>>>(
      points, static_cast<const TableT*>(tables), scales, meta, n_levels,
      log2_table_size, out, n_points);
  return cudaGetLastError();
}

}  // namespace repro

// points (B, dim) f32 in [0, 1]; tables (L, 2^log2_table_size, F) of
// f32 (table_dtype 0), bf16 (3), or int8 (1) or fp8-e4m3 (2) codes;
// scales: a DEVICE array of the L per-level f32 scales for codes, null for
// f32 and bf16; level_meta: a HOST array of L (resolution, is_hashed)
// int32 pairs; out (B, L * F) f32. Launches on `stream` after making
// `device` current; returns the CUDA error of the launch (0 on success).
extern "C" int encode_fwd(const float* points, const void* tables,
                          const float* scales, int table_dtype,
                          const int* level_meta, int n_levels,
                          int log2_table_size, int dim, int n_features,
                          float* out, long long n_points, int device,
                          void* stream) {
  if (cudaError_t err = cudaSetDevice(device)) return err;
  using namespace repro;
  if (n_points == 0) return cudaSuccess;
  LevelMeta meta;
  if (!fill_level_meta(level_meta, n_levels, &meta) || log2_table_size < 1 ||
      log2_table_size > 31 ||
      (table_dtype == kTableInt8 || table_dtype == kTableFp8E4M3) !=
          (scales != nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_ENCODE_CASE(D, FF, CODE, T)                                      \
  if (dim == D && n_features == FF && table_dtype == CODE)                     \
    return launch_encode<D, FF, T>(points, tables, scales, meta, n_levels,     \
                                   log2_table_size, out, n_points, s);
  REPRO_ENCODE_CASE(3, 2, kTableF32, float)
  REPRO_ENCODE_CASE(3, 8, kTableF32, float)
  REPRO_ENCODE_CASE(3, 2, kTableInt8, int8_t)
  REPRO_ENCODE_CASE(3, 8, kTableInt8, int8_t)
  REPRO_ENCODE_CASE(3, 2, kTableFp8E4M3, __nv_fp8_e4m3)
  REPRO_ENCODE_CASE(3, 8, kTableFp8E4M3, __nv_fp8_e4m3)
  REPRO_ENCODE_CASE(3, 2, kTableBf16, __nv_bfloat16)
  REPRO_ENCODE_CASE(3, 8, kTableBf16, __nv_bfloat16)
  REPRO_ENCODE_CASE(2, 2, kTableF32, float)
  REPRO_ENCODE_CASE(2, 8, kTableF32, float)
  REPRO_ENCODE_CASE(2, 2, kTableInt8, int8_t)
  REPRO_ENCODE_CASE(2, 8, kTableInt8, int8_t)
  REPRO_ENCODE_CASE(2, 2, kTableFp8E4M3, __nv_fp8_e4m3)
  REPRO_ENCODE_CASE(2, 8, kTableFp8E4M3, __nv_fp8_e4m3)
  REPRO_ENCODE_CASE(2, 2, kTableBf16, __nv_bfloat16)
  REPRO_ENCODE_CASE(2, 8, kTableBf16, __nv_bfloat16)
#undef REPRO_ENCODE_CASE
  return cudaErrorInvalidValue;
}
