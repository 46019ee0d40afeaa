// Standalone multi-resolution grid encode for Hopper: the unfused route.
//
// Replaces the JAX package's kernels/hashgrid/hashgrid.py:
// hashgrid_encode_pallas (body _encode_kernel), for f32 and bf16 tables
// and, with per-level f32 scales, for int8 / fp8-e4m3 tables (its quantized
// variant, hashgrid.py:154-155,167,177,221-223). It writes the (B, L*F) f32
// features to device memory. It is instantiated for 3-D and 2-D points,
// F = 2 and 8, each table type, and each level-group size G it takes.
//
// What bounds it on the card: per point and level it gathers 2^d table rows
// from anywhere in a level's table and writes F floats. The bytes bound
// counts each touched row once, but every gather is a request of its own to
// the SM's L1 and, on a miss, a 32-byte sector from L2, so the count of
// gather requests and the latency each waits bound it (on an H100, at nerf's
// 131,072-point tile, int8 tables take a fifth less time than f32 ones, not
// a quarter of it). A thread per (point, level) would have 2^d gathers in
// flight, re-read its point at every level and store 8 bytes at a stride of
// L*F floats, so four blocks, at four times, would fill each output sector.
//
// So a block takes a tile of kEncodeRows points and a group of G
// consecutive levels (the grid is (point tiles, level groups), level groups
// outer: the card issues blocks in blockIdx.x order first, so one group's
// tables stay hot in the 50 MB L2 while its tiles gather, the counterpart
// of the TPU kernel's level-group-outer grid, hashgrid.py:224-231). G comes
// from the wrapper's plan (kernels/hashgrid/hashgrid.py encode_plan), which
// sizes a group's tables against a share of L2; this file only checks that
// it takes that G. Each thread reads its point once per group, issues the
// gathers of all G levels (LevelGather::fetch, G * 2^d rows in flight)
// before it adds any of them up (LevelGather::finish), and writes its G*F
// contiguous floats with 16-byte stores: one whole 32-byte sector for
// nerf's G = 4, F = 2 (8-byte stores where L*F is not a multiple of 4).
// The arithmetic is LevelGather's (encode.cuh): corners in order, fmaf, a
// code times its scale before the FMA. G changes only the order in which
// levels are computed, not the arithmetic of any feature.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include "encode.cuh"
#include "info.cuh"

namespace repro {

constexpr int kEncodeRows = 128;     // points per block, one per thread
constexpr int kMaxGroup = 8;         // levels a group may take
// bytes of one corner's rows a thread may hold across its group's levels
// (G x F x itemsize): bounds the registers of the gathers in flight
constexpr int kGroupRowBytes = 32;

// A group of G levels is taken for tables of TableT with F features when
// its rows fit the register budget and its G*F floats are whole 16-byte
// stores.
template <int F, typename TableT>
constexpr bool takes_group(int g) {
  return g >= 1 && g <= kMaxGroup && (g & (g - 1)) == 0 &&
         g * F * (int)sizeof(TableT) <= kGroupRowBytes && (g * F) % 4 == 0;
}

template <int DIM, int F, typename TableT, int G>
__global__ void __launch_bounds__(kEncodeRows) encode_fwd_kernel(
    const float* __restrict__ points, const TableT* __restrict__ tables,
    const float* __restrict__ scales, const LevelMeta meta, int n_levels,
    int log2_table_size, float* __restrict__ out, long long n_points) {
  const long long p = (long long)blockIdx.x * kEncodeRows + threadIdx.x;
  if (p >= n_points) return;
  const int l0 = blockIdx.y * G;
  const uint32_t mask = (uint32_t)((1ull << log2_table_size) - 1ull);
  const size_t level_stride = ((size_t)1 << log2_table_size) * F;
  float pt[DIM];
#pragma unroll
  for (int i = 0; i < DIM; ++i) pt[i] = __ldg(points + p * DIM + i);
  // every gather of the group in flight before any sum
  LevelGather<DIM, F, TableT> gather[G];
#pragma unroll
  for (int k = 0; k < G; ++k) {
    const int l = l0 + k;
    if (l < n_levels)
      gather[k].fetch(pt, tables + (size_t)l * level_stride, meta.res[l],
                      meta.hashed[l] != 0, mask);
  }
  float feat[G * F];
#pragma unroll
  for (int k = 0; k < G; ++k) {
    const int l = l0 + k;
    float f[F];
#pragma unroll
    for (int c = 0; c < F; ++c) f[c] = 0.f;
    if (l < n_levels) gather[k].finish(level_scale<TableT>(scales, l), f);
#pragma unroll
    for (int c = 0; c < F; ++c) feat[k * F + c] = f[c];
  }
  // the group's G*F floats of row p, ragged in the last group
  float* o = out + p * (long long)(n_levels * F) + (long long)l0 * F;
  const int n_out = min(G, n_levels - l0) * F;
  if ((n_levels * F) % 4 == 0) {       // rows and groups 16-byte aligned
#pragma unroll
    for (int j = 0; j < G * F / 4; ++j)
      if (4 * j < n_out)
        reinterpret_cast<float4*>(o)[j] = make_float4(
            feat[4 * j], feat[4 * j + 1], feat[4 * j + 2], feat[4 * j + 3]);
  } else {                              // F = 2 with L odd: 8-byte aligned
#pragma unroll
    for (int j = 0; j < G * F / 2; ++j)
      if (2 * j < n_out)
        reinterpret_cast<float2*>(o)[j] = make_float2(feat[2 * j],
                                                      feat[2 * j + 1]);
  }
}

template <int DIM, int F, typename TableT, int G>
cudaError_t launch_encode_group(const float* points, const void* tables,
                                const float* scales, const LevelMeta& meta,
                                int n_levels, int log2_table_size, float* out,
                                long long n_points, cudaStream_t stream) {
  if constexpr (takes_group<F, TableT>(G)) {
    const dim3 grid((unsigned)((n_points + kEncodeRows - 1) / kEncodeRows),
                    (unsigned)((n_levels + G - 1) / G));
    encode_fwd_kernel<DIM, F, TableT, G><<<grid, kEncodeRows, 0, stream>>>(
        points, static_cast<const TableT*>(tables), scales, meta, n_levels,
        log2_table_size, out, n_points);
    return cudaGetLastError();
  } else {
    return cudaErrorInvalidValue;
  }
}

template <int DIM, int F, typename TableT>
cudaError_t launch_encode(const float* points, const void* tables,
                          const float* scales, const LevelMeta& meta,
                          int n_levels, int log2_table_size, int group,
                          float* out, long long n_points,
                          cudaStream_t stream) {
  switch (group) {
#define REPRO_ENCODE_GROUP(GG)                                                 \
  case GG:                                                                     \
    return launch_encode_group<DIM, F, TableT, GG>(                            \
        points, tables, scales, meta, n_levels, log2_table_size, out,          \
        n_points, stream);
    REPRO_ENCODE_GROUP(1)
    REPRO_ENCODE_GROUP(2)
    REPRO_ENCODE_GROUP(4)
    REPRO_ENCODE_GROUP(8)
#undef REPRO_ENCODE_GROUP
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace repro

// points (B, dim) f32 in [0, 1]; tables (L, 2^log2_table_size, F) of
// f32 (table_dtype 0), bf16 (3), or int8 (1) or fp8-e4m3 (2) codes;
// scales: a DEVICE array of the L per-level f32 scales for codes, null for
// f32 and bf16; level_meta: a HOST array of L (resolution, is_hashed)
// int32 pairs; group_levels: G, the levels a block takes (the wrapper's
// plan); out (B, L * F) f32, 16-byte aligned. Launches on `stream` after
// making `device` current; returns the CUDA error of the launch (0 on
// success).
extern "C" int encode_fwd(const float* points, const void* tables,
                          const float* scales, int table_dtype,
                          const int* level_meta, int n_levels,
                          int log2_table_size, int dim, int n_features,
                          int group_levels, float* out, long long n_points,
                          int device, void* stream) {
  if (cudaError_t err = cudaSetDevice(device)) return err;
  using namespace repro;
  LevelMeta meta;
  if (!fill_level_meta(level_meta, n_levels, &meta) || log2_table_size < 1 ||
      log2_table_size > 31 ||
      (table_dtype == kTableInt8 || table_dtype == kTableFp8E4M3) !=
          (scales != nullptr) ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return cudaErrorInvalidValue;
  if (n_points == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_ENCODE_CASE(D, FF, CODE, T)                                      \
  if (dim == D && n_features == FF && table_dtype == CODE)                     \
    return launch_encode<D, FF, T>(points, tables, scales, meta, n_levels,     \
                                   log2_table_size, group_levels, out,         \
                                   n_points, s);
  REPRO_GRID_CASES(REPRO_ENCODE_CASE)
#undef REPRO_ENCODE_CASE
  return cudaErrorInvalidValue;
}

namespace repro {

template <int DIM, int F, typename TableT>
cudaError_t encode_info(int group, int device, int* out) {
  switch (group) {
#define REPRO_ENCODE_INFO(GG)                                                  \
  case GG:                                                                     \
    if constexpr (takes_group<F, TableT>(GG))                                  \
      return kernel_info(                                                      \
          reinterpret_cast<const void*>(encode_fwd_kernel<DIM, F, TableT, GG>), \
          kEncodeRows, 0, 0, device, out);                                     \
    return cudaErrorInvalidValue;
    REPRO_ENCODE_INFO(1)
    REPRO_ENCODE_INFO(2)
    REPRO_ENCODE_INFO(4)
    REPRO_ENCODE_INFO(8)
#undef REPRO_ENCODE_INFO
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace repro

// The resources of the encode_fwd instantiation a launch with these
// arguments takes (info.cuh: out holds kInfoFields ints); returns the CUDA
// error (0 on success).
extern "C" int encode_fwd_info(int dim, int n_features, int table_dtype,
                               int group_levels, int device, int* out) {
  using namespace repro;
#define REPRO_ENCODE_INFO_CASE(D, FF, CODE, T)                                 \
  if (dim == D && n_features == FF && table_dtype == CODE)                     \
    return encode_info<D, FF, T>(group_levels, device, out);
  REPRO_GRID_CASES(REPRO_ENCODE_INFO_CASE)
#undef REPRO_ENCODE_INFO_CASE
  return cudaErrorInvalidValue;
}
