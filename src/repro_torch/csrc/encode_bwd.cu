// Backward of the multi-resolution grid encode for Hopper: the table
// gradient's scatter-add (and, when asked, the points' gradient).
//
// No TPU kernel computes it: the JAX package's encode VJP is plain XLA
// (kernels/hashgrid/vjp.py:encode_bwd), the transpose of
// kernels/hashgrid/hashgrid.py:hashgrid_encode_pallas. Given the cotangent
// g (B, L*F) of the features, every point adds w_corner * g[l*F:(l+1)*F]
// into each of the 2^d table rows it read at level l (d_tables), and the
// derivative of the d-linear weights by the point gives d_points.
//
// What bounds it on the card: per point and level, 2^d scattered
// read-modify-writes of F floats into an f32 accumulator of the tables'
// shape. They are atomic adds (reductions, fire and forget), executed at
// the L2 slice that owns the address, so the count of atomic requests and
// whether their rows stay in L2 bound it, not the bytes. Hopper adds a
// row's F floats with one vector atomic (float2 for F = 2, two float4 for
// F = 8; each float is added atomically on its own), so a corner is one
// or two requests, not F. The accumulator of the
// whole grid (64 MiB at nerf's Table-I width, 2 GiB at gia's) does not fit
// the 50 MB L2; one level group's does. So the grid is the forward's:
// (point tiles, level groups), level groups outer, and the card runs every
// tile of one group, whose atomics land in that group's accumulator rows,
// before the next group. G comes from the backward's own plan
// (kernels/hashgrid/hashgrid.py encode_bwd_plan), which sizes a group's
// accumulator against a share of L2: on an H100 at nerf's tile, groups of
// 4 or 8 MiB of accumulator ran fastest, 16 and 32 MiB slower.
//
// Each thread takes one point and the G levels of its block's group: it
// reads its point once and the group's G*F cotangents with 16-byte loads,
// then per level and corner addresses the row through LevelCell
// (encode.cuh), the forward's index and weight math, so it adds into
// exactly the rows the forward read. Sums land in another order from run
// to run: the result is not bit-reproducible, and its tests state a
// tolerance. The table gradient is accumulated in f32 (bf16 tables too: the
// wrapper casts the accumulator once at the end, as the JAX VJP does).
//
// d_points is written only when the points need a gradient: the thread
// owns its point, so it sums its group's terms in registers, in the JAX
// order (levels, then corners, then dimensions), and writes them without
// atomics to its group's slice of a (groups, B, d) buffer, which the
// wrapper sums over groups. Per corner that is gdot = sum_f row_f * g_f on
// the row the forward gathered, then for each dimension i,
// gdot * sign_i * prod_{k != i} s_k * res: the product over the other
// dimensions, never a division by s_i, so a point on a cell face (s_i = 0)
// gets no 0/0.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "encode.cuh"
#include "info.cuh"

namespace repro {

constexpr int kEncodeBwdRows = 128;   // points per block, one per thread
// cotangents a thread holds across its group (G * F): the plan picks G
// within it
constexpr int kMaxGroupFloats = 16;

template <int DIM, int F, typename TableT, int G>
__global__ void __launch_bounds__(kEncodeBwdRows) encode_bwd_kernel(
    const float* __restrict__ points, const TableT* __restrict__ tables,
    const float* __restrict__ g, const LevelMeta meta, int n_levels,
    int log2_table_size, float* __restrict__ d_tables,
    float* __restrict__ d_points_part, long long n_points) {
  const long long p = (long long)blockIdx.x * kEncodeBwdRows + threadIdx.x;
  if (p >= n_points) return;
  const int l0 = blockIdx.y * G;
  const int n_group = min(G, n_levels - l0);
  const uint32_t mask = (uint32_t)((1ull << log2_table_size) - 1ull);
  const size_t level_stride = ((size_t)1 << log2_table_size) * F;
  float pt[DIM];
#pragma unroll
  for (int i = 0; i < DIM; ++i) pt[i] = __ldg(points + p * DIM + i);
  // the group's G*F cotangents of row p, zero past the last level
  float gl[G * F];
  const float* gp = g + p * (long long)(n_levels * F) + (long long)l0 * F;
  if ((G * F) % 4 == 0 && (n_levels * F) % 4 == 0) {   // 16-byte aligned
#pragma unroll
    for (int j = 0; j < G * F / 4; ++j) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (4 * j < n_group * F) v = __ldg(reinterpret_cast<const float4*>(gp) + j);
      gl[4 * j] = v.x; gl[4 * j + 1] = v.y;
      gl[4 * j + 2] = v.z; gl[4 * j + 3] = v.w;
    }
  } else {                              // 8-byte aligned
#pragma unroll
    for (int j = 0; j < G * F / 2; ++j) {
      float2 v = make_float2(0.f, 0.f);
      if (2 * j < n_group * F) v = __ldg(reinterpret_cast<const float2*>(gp) + j);
      gl[2 * j] = v.x; gl[2 * j + 1] = v.y;
    }
  }
  float dp[DIM];
#pragma unroll
  for (int i = 0; i < DIM; ++i) dp[i] = 0.f;
#pragma unroll
  for (int k = 0; k < G; ++k) {
    const int l = l0 + k;
    if (l >= n_levels) break;
    const int res = meta.res[l];
    const bool hashed = meta.hashed[l] != 0;
    const LevelCell<DIM> cell(pt, res);
    float* acc = d_tables + (size_t)l * level_stride;
#pragma unroll
    for (int c = 0; c < (1 << DIM); ++c) {
      const uint32_t row = cell.row(c, res, hashed, mask);
      const float w = cell.weight(c);
      float* a = acc + (size_t)row * F;
      const float* gk = gl + k * F;
      if constexpr (F % 4 == 0) {       // 16-byte rows: float4 atomics
#pragma unroll
        for (int j = 0; j < F / 4; ++j)
          atomicAdd(reinterpret_cast<float4*>(a) + j,
                    make_float4(w * gk[4 * j], w * gk[4 * j + 1],
                                w * gk[4 * j + 2], w * gk[4 * j + 3]));
      } else {                          // 8-byte rows: float2 atomics
#pragma unroll
        for (int j = 0; j < F / 2; ++j)
          atomicAdd(reinterpret_cast<float2*>(a) + j,
                    make_float2(w * gk[2 * j], w * gk[2 * j + 1]));
      }
      if (d_points_part != nullptr) {
        RowBits<F * (int)sizeof(TableT)> r;
        r.load(tables + (size_t)l * level_stride + (size_t)row * F);
        float gdot = 0.f;
#pragma unroll
        for (int f = 0; f < F; ++f)
          gdot += row_value<TableT>(r, f) * gl[k * F + f];
#pragma unroll
        for (int i = 0; i < DIM; ++i) {
          float others = 1.f;
#pragma unroll
          for (int j = 0; j < DIM; ++j)
            if (j != i) others *= cell.side_weight(c, j);
          const float sign = ((c >> i) & 1) ? 1.f : -1.f;
          dp[i] += gdot * sign * others * (float)res;
        }
      }
    }
  }
  if (d_points_part != nullptr) {
    float* o = d_points_part + ((long long)blockIdx.y * n_points + p) * DIM;
#pragma unroll
    for (int i = 0; i < DIM; ++i) o[i] = dp[i];
  }
}

template <int DIM, int F, typename TableT>
cudaError_t launch_encode_bwd(const float* points, const void* tables,
                              const float* g, const LevelMeta& meta,
                              int n_levels, int log2_table_size, int group,
                              float* d_tables, float* d_points_part,
                              long long n_points, cudaStream_t stream) {
  const unsigned tiles =
      (unsigned)((n_points + kEncodeBwdRows - 1) / kEncodeBwdRows);
  switch (group) {
#define REPRO_ENCODE_BWD_GROUP(GG)                                             \
  case GG:                                                                     \
    if constexpr (GG * F <= kMaxGroupFloats) {                                 \
      encode_bwd_kernel<DIM, F, TableT, GG>                                    \
          <<<dim3(tiles, (unsigned)((n_levels + GG - 1) / GG)),                \
             kEncodeBwdRows, 0, stream>>>(                                     \
              points, static_cast<const TableT*>(tables), g, meta, n_levels,   \
              log2_table_size, d_tables, d_points_part, n_points);             \
      return cudaGetLastError();                                               \
    } else {                                                                   \
      return cudaErrorInvalidValue;                                            \
    }
    REPRO_ENCODE_BWD_GROUP(1)
    REPRO_ENCODE_BWD_GROUP(2)
    REPRO_ENCODE_BWD_GROUP(4)
    REPRO_ENCODE_BWD_GROUP(8)
#undef REPRO_ENCODE_BWD_GROUP
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace repro

// points (B, dim) f32 in [0, 1]; tables (L, 2^log2_table_size, F) of f32
// (table_dtype 0) or bf16 (3): codes have no gradient; g (B, L * F) f32,
// 16-byte aligned (8-byte where L * F is not a multiple of 4); level_meta:
// a HOST array of L (resolution, is_hashed) int32 pairs; group_levels: G,
// the backward's plan; d_tables: an f32 accumulator of the tables' shape,
// zeroed by the caller, which the kernel adds into; d_points_part: null,
// or a (ceil(L / G), B, dim) f32 buffer the kernel fills, one slice per
// level group. Launches on `stream` after making `device` current; returns
// the CUDA error of the launch (0 on success).
extern "C" int encode_bwd(const float* points, const void* tables,
                          int table_dtype, const float* g,
                          const int* level_meta, int n_levels,
                          int log2_table_size, int dim, int n_features,
                          int group_levels, float* d_tables,
                          float* d_points_part, long long n_points,
                          int device, void* stream) {
  if (cudaError_t err = cudaSetDevice(device)) return err;
  using namespace repro;
  LevelMeta meta;
  const uintptr_t g_align = (n_levels * n_features) % 4 == 0 ? 16 : 8;
  if (!fill_level_meta(level_meta, n_levels, &meta) || log2_table_size < 1 ||
      log2_table_size > 31 || reinterpret_cast<uintptr_t>(g) % g_align != 0)
    return cudaErrorInvalidValue;
  if (n_points == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_ENCODE_BWD_CASE(D, FF, CODE, T)                                  \
  if (dim == D && n_features == FF && table_dtype == CODE)                     \
    return launch_encode_bwd<D, FF, T>(points, tables, g, meta, n_levels,      \
                                       log2_table_size, group_levels,          \
                                       d_tables, d_points_part, n_points, s);
  REPRO_GRID_TRAIN_CASES(REPRO_ENCODE_BWD_CASE)
#undef REPRO_ENCODE_BWD_CASE
  return cudaErrorInvalidValue;
}

namespace repro {

template <int DIM, int F, typename TableT>
cudaError_t encode_bwd_info(int group, int device, int* out) {
  switch (group) {
#define REPRO_ENCODE_BWD_INFO(GG)                                              \
  case GG:                                                                     \
    if constexpr (GG * F <= kMaxGroupFloats)                                   \
      return kernel_info(                                                      \
          reinterpret_cast<const void*>(encode_bwd_kernel<DIM, F, TableT, GG>), \
          kEncodeBwdRows, 0, 0, device, out);                                  \
    return cudaErrorInvalidValue;
    REPRO_ENCODE_BWD_INFO(1)
    REPRO_ENCODE_BWD_INFO(2)
    REPRO_ENCODE_BWD_INFO(4)
    REPRO_ENCODE_BWD_INFO(8)
#undef REPRO_ENCODE_BWD_INFO
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace repro

// The resources of the encode_bwd instantiation a launch with these
// arguments takes (info.cuh); returns the CUDA error (0 on success).
extern "C" int encode_bwd_info(int dim, int n_features, int table_dtype,
                               int group_levels, int device, int* out) {
  using namespace repro;
#define REPRO_ENCODE_BWD_INFO_CASE(D, FF, CODE, T)                             \
  if (dim == D && n_features == FF && table_dtype == CODE)                     \
    return encode_bwd_info<D, FF, T>(group_levels, device, out);
  REPRO_GRID_TRAIN_CASES(REPRO_ENCODE_BWD_INFO_CASE)
#undef REPRO_ENCODE_BWD_INFO_CASE
  return cudaErrorInvalidValue;
}
