// Fused grid encode + MLP (the neural fields processor) for Hopper.
//
// Replaces the JAX package's kernels/fused_field/fused_field.py:
// fused_field_pallas (body _field_kernel): field_fwd for dense f32 or bf16
// tables, field_fwd_q for int8 / fp8-e4m3 tables with per-level f32 scales
// (its quantized branch, fused_field.py:41,58,164-166). The encoded
// features never reach device memory. It is instantiated for 3-D points
// (nerf, nvr, nsdf) and 2-D ones (gia), for F = 2 (hash and dense grids)
// and F = 8 (tiled), and for each table type.
//
// What bounds it on the card: at Table-I nerf_hash width each point gathers
// 16 levels x 8 corners x F=2 features from the table stack and then runs
// 22,528 flops of MLP. The f32 stack is 64 MiB, more than the 50 MB L2, so
// the gathers wait on HBM latency; a bf16 stack is 32 MiB and an int8 or fp8
// one 16 MiB, which fit. The MLP, on the CUDA cores, took two thirds of the
// time of the previous design, in which each block encoded a tile, waited
// at a barrier, then ran the MLP: gathers and products took turns.
//
// The design overlaps them (warp specialisation). A persistent block, one
// per SM, stages the MLP's weights once (mlp.cuh) and splits its warps in
// two roles over a double-buffered shared-memory feature tile of kFieldRows
// points:
//   - kEncodeWarps encode warps gather tile i+1 into one buffer while
//   - kMlpWarps MLP warps run tile i from the other, 16 rows per warp, on
//     the tensor cores (mma.sync 3xTF32, activations in registers).
// The roles hand buffers over with named barriers: the encode warps
// bar.arrive on FULL[s] when buffer s holds a tile, the MLP warps bar.sync
// on it; the MLP warps bar.arrive on EMPTY[s] once their input layer has
// read buffer s, and the encode warps bar.sync on it before they write s
// again. Consecutive encode lanes take consecutive points of one level, so
// nearby points share table rows in L1/L2, and each lane starts the loads
// of all corners of two levels (one for 32-byte rows) before it adds any
// of them up, to keep more gathers in flight against HBM latency. The encode
// arithmetic is LevelGather's (encode.cuh), unchanged.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include "encode.cuh"
#include "info.cuh"
#include "mlp.cuh"

namespace repro {

constexpr int kEncodeWarps = 8;
constexpr int kMlpWarps = 8;
constexpr int kFieldRows = 16 * kMlpWarps;            // points per tile
constexpr int kFieldThreads = 32 * (kEncodeWarps + kMlpWarps);
constexpr int kFieldHidden = 64;                      // padded hidden width
// named barrier ids (0 is __syncthreads'): FULL[s] and EMPTY[s]
constexpr int kBarFull = 1, kBarEmpty = 3;

// Row stride of the feature tile in floats: din padded to 8, plus 8, so the
// MLP warps' 8-byte A loads hit distinct banks.
__host__ __device__ inline int feat_stride(int din) {
  return 8 * tiles8(din) + 8;
}

inline size_t field_smem_bytes(const MlpDims& d) {
  return (size_t)weight_frags(d, kFieldHidden) * sizeof(float4) +
         (size_t)2 * kFieldRows * feat_stride(d.din) * sizeof(float);
}

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(kFieldThreads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(kFieldThreads) : "memory");
}

// The encode role: tile after tile, every (point, level) feature of the
// tile into its buffer.
template <int DIM, int F, typename TableT>
__device__ __forceinline__ void encode_tiles(
    const float* __restrict__ points, const TableT* __restrict__ tables,
    const float* __restrict__ scales, const LevelMeta& meta, int n_levels,
    int log2_table_size, float* feat, int stride, long long n_points,
    long long n_tiles) {
  constexpr int kGroups = 32 * kEncodeWarps / kFieldRows;   // level groups
  constexpr int kInFlight = F * sizeof(TableT) <= 8 ? 2 : 1;
  static_assert(kGroups * kFieldRows == 32 * kEncodeWarps,
                "encode threads must cover whole tiles");
  const int p = threadIdx.x % kFieldRows, group = threadIdx.x / kFieldRows;
  const uint32_t mask = (uint32_t)((1ull << log2_table_size) - 1ull);
  const size_t level_stride = ((size_t)1 << log2_table_size) * F;
  int i = 0;
  for (long long tile = blockIdx.x; tile < n_tiles;
       tile += gridDim.x, ++i) {
    const int s = i & 1;
    if (i >= 2) bar_sync(kBarEmpty + s);
    float* row = feat + ((size_t)s * kFieldRows + p) * stride;
    const long long point = tile * kFieldRows + p;
    if (point < n_points) {
      float pt[DIM];
#pragma unroll
      for (int k = 0; k < DIM; ++k) pt[k] = __ldg(points + point * DIM + k);
      for (int l0 = group * kInFlight; l0 < n_levels;
           l0 += kGroups * kInFlight) {
        LevelGather<DIM, F, TableT> gather[kInFlight];
#pragma unroll
        for (int k = 0; k < kInFlight; ++k) {
          const int l = l0 + k;
          if (l < n_levels)
            gather[k].fetch(pt, tables + l * level_stride, meta.res[l],
                            meta.hashed[l] != 0, mask);
        }
#pragma unroll
        for (int k = 0; k < kInFlight; ++k) {
          const int l = l0 + k;
          if (l < n_levels) {
            float f[F];
            gather[k].finish(level_scale<TableT>(scales, l), f);
#pragma unroll
            for (int c = 0; c < F; ++c) row[l * F + c] = f[c];
          }
        }
      }
    }
    bar_arrive(kBarFull + s);
  }
}

// The MLP role: each warp takes 16 rows of every tile.
__device__ __forceinline__ void mlp_tiles(const float4* __restrict__ wf,
                                          const float* feat, int stride,
                                          const MlpDims& d,
                                          float* __restrict__ out,
                                          long long n_points,
                                          long long n_tiles) {
  const int m = threadIdx.x / 32 - kEncodeWarps;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  int i = 0;
  for (long long tile = blockIdx.x; tile < n_tiles;
       tile += gridDim.x, ++i) {
    const int s = i & 1;
    bar_sync(kBarFull + s);
    const float* rows = feat + ((size_t)s * kFieldRows + 16 * m) * stride;
    const long long r0 = tile * kFieldRows + 16 * m;
    auto load_a = [&](int j, float (&a)[4]) {
      const int col = 8 * j + 2 * t;
      const float2 u =
          *reinterpret_cast<const float2*>(rows + g * stride + col);
      const float2 v =
          *reinterpret_cast<const float2*>(rows + (g + 8) * stride + col);
      a[0] = u.x;
      a[1] = v.x;
      a[2] = u.y;
      a[3] = v.y;
    };
    // buffer s is free once the input layer has read it, unless no later
    // tile of this block will be encoded into it
    auto release = [&] {
      if (tile + 2LL * gridDim.x < n_tiles) bar_arrive(kBarEmpty + s);
    };
    auto store = [&](int col, int r, float v) {
      if (r0 + r < n_points) out[(r0 + r) * d.dout + col] = v;
    };
    mlp_warp_rows16<kFieldHidden>(load_a, release, store, wf, d);
  }
}

template <int DIM, int F, typename TableT>
__global__ void __launch_bounds__(kFieldThreads, 1) field_fwd_kernel(
    const float* __restrict__ points, const TableT* __restrict__ tables,
    const float* __restrict__ scales, const LevelMeta meta, int n_levels,
    int log2_table_size, const MlpWeights w, const MlpDims d,
    float* __restrict__ out, long long n_points) {
  extern __shared__ float4 smem4[];
  float4* wf = smem4;
  float* feat =
      reinterpret_cast<float*>(smem4 + weight_frags(d, kFieldHidden));
  const int stride = feat_stride(d.din);
  stage_weights(wf, w, d, kFieldHidden);
  // the padding columns past din stay zero: the MLP reads them
  for (int i = threadIdx.x; i < 2 * kFieldRows * stride; i += blockDim.x)
    feat[i] = 0.f;
  __syncthreads();
  const long long n_tiles = (n_points + kFieldRows - 1) / kFieldRows;
  if (threadIdx.x < 32 * kEncodeWarps)
    encode_tiles<DIM, F, TableT>(points, tables, scales, meta, n_levels,
                                 log2_table_size, feat, stride, n_points,
                                 n_tiles);
  else
    mlp_tiles(wf, feat, stride, d, out, n_points, n_tiles);
}

template <int DIM, int F, typename TableT>
cudaError_t launch_field(const float* points, const void* tables,
                         const float* scales, const LevelMeta& meta,
                         int n_levels, int log2_table_size,
                         const MlpWeights& w, const MlpDims& d, float* out,
                         long long n_points, int device, cudaStream_t stream) {
  const size_t smem = field_smem_bytes(d);
  if (smem > kMaxSmemBytes) return cudaErrorInvalidValue;
  auto kernel = field_fwd_kernel<DIM, F, TableT>;
  unsigned grid = 0;
  cudaError_t err = persistent_grid(
      reinterpret_cast<const void*>(kernel), kFieldThreads, smem,
      (n_points + kFieldRows - 1) / kFieldRows, device, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kFieldThreads, smem, stream>>>(
      points, static_cast<const TableT*>(tables), scales, meta, n_levels,
      log2_table_size, w, d, out, n_points);
  return cudaGetLastError();
}

// The launch of field_fwd (kTableF32 / kTableBf16, no scales) and
// field_fwd_q (kTableInt8 / kTableFp8E4M3 with scales).
int field_entry(const float* points, const void* tables, const float* scales,
                int table_dtype, const int* level_meta, int n_levels,
                int log2_table_size, int dim, int n_features,
                const MlpWeights& w, const MlpDims& d, float* out,
                long long n_points, int device, void* stream) {
  if (cudaError_t err = cudaSetDevice(device)) return err;
  LevelMeta meta;
  if (!fill_level_meta(level_meta, n_levels, &meta) ||
      d.din != n_levels * n_features || log2_table_size < 1 ||
      log2_table_size > 31 || d.dout < 1 || d.n_hidden < 1 || d.hidden < 8 ||
      d.hidden > kFieldHidden || d.hidden % 8 != 0)
    return cudaErrorInvalidValue;
  if (n_points == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_FIELD_CASE(D, FF, CODE, T)                                       \
  if (dim == D && n_features == FF && table_dtype == CODE)                     \
    return launch_field<D, FF, T>(points, tables, scales, meta, n_levels,      \
                                  log2_table_size, w, d, out, n_points,        \
                                  device, s);
  REPRO_GRID_CASES(REPRO_FIELD_CASE)
#undef REPRO_FIELD_CASE
  return cudaErrorInvalidValue;
}

}  // namespace repro

// points (B, dim) f32 in [0, 1]; tables (L, 2^log2_table_size, F) of f32
// (table_dtype 0) or bf16 (3); level_meta: a HOST array of L (resolution,
// is_hashed) int32 pairs; w_in (din, hidden), w_hidden (n_hidden - 1,
// hidden, hidden), w_out (hidden, dout), all f32 (w_bf16 = 0) or all bf16
// (1); out (B, dout) f32. din must be L * F and hidden a multiple of 8 up
// to 64, and the staged weights and feature tiles must fit in shared memory
// (kernels/fused_field/fused_field.py field_plan says so before the
// launch). Launches on `stream` after making `device` current; returns the
// CUDA error of the launch (0 on success).
extern "C" int field_fwd(const float* points, const void* tables,
                         int table_dtype, const int* level_meta, int n_levels,
                         int log2_table_size, int dim, int n_features,
                         const void* w_in, const void* w_hidden,
                         const void* w_out, int w_bf16, int din, int hidden,
                         int n_hidden, int dout, float* out,
                         long long n_points, int device, void* stream) {
  using namespace repro;
  if (table_dtype != kTableF32 && table_dtype != kTableBf16)
    return cudaErrorInvalidValue;
  return field_entry(points, tables, nullptr, table_dtype, level_meta,
                     n_levels, log2_table_size, dim, n_features,
                     MlpWeights{w_in, w_hidden, w_out, w_bf16},
                     MlpDims{din, hidden, n_hidden, dout}, out, n_points,
                     device, stream);
}

// As field_fwd, for a table of int8 (table_dtype 1) or fp8-e4m3 (2) codes;
// `scales` is a DEVICE array of the L per-level f32 scales (the scene's
// (L, 1, 1) grid_scale leaf).
extern "C" int field_fwd_q(const float* points, const void* tables,
                           const float* scales, int table_dtype,
                           const int* level_meta, int n_levels,
                           int log2_table_size, int dim, int n_features,
                           const void* w_in, const void* w_hidden,
                           const void* w_out, int w_bf16, int din, int hidden,
                           int n_hidden, int dout, float* out,
                           long long n_points, int device, void* stream) {
  using namespace repro;
  if ((table_dtype != kTableInt8 && table_dtype != kTableFp8E4M3) ||
      scales == nullptr)
    return cudaErrorInvalidValue;
  return field_entry(points, tables, scales, table_dtype, level_meta,
                     n_levels, log2_table_size, dim, n_features,
                     MlpWeights{w_in, w_hidden, w_out, w_bf16},
                     MlpDims{din, hidden, n_hidden, dout}, out, n_points,
                     device, stream);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The resources of the field_fwd / field_fwd_q instantiation a launch with
// these arguments takes, at the MLP dimensions' shared memory (info.cuh);
// returns the CUDA error (0 on success).
extern "C" int field_fwd_info(int dim, int n_features, int table_dtype,
                              int din, int hidden, int n_hidden, int dout,
                              int device, int* out) {
  using namespace repro;
  const MlpDims d{din, hidden, n_hidden, dout};
  if (din < 1 || dout < 1 || n_hidden < 1 || hidden < 8 ||
      hidden > kFieldHidden || hidden % 8 != 0)
    return cudaErrorInvalidValue;
  const size_t smem = field_smem_bytes(d);
#define REPRO_FIELD_INFO_CASE(D, FF, CODE, T)                                  \
  if (dim == D && n_features == FF && table_dtype == CODE)                     \
    return kernel_info(                                                        \
        reinterpret_cast<const void*>(field_fwd_kernel<D, FF, T>),             \
        kFieldThreads, smem, (int)kMaxSmemBytes, device, out);
  REPRO_GRID_CASES(REPRO_FIELD_INFO_CASE)
#undef REPRO_FIELD_INFO_CASE
  return cudaErrorInvalidValue;
}
