// Multi-resolution grid encode of one point at one level: the device body
// of the JAX package's kernels/hashgrid/hashgrid.py:encode_one_level.
//
// Per level: scale the point by the level resolution, take floor and frac
// (frac BEFORE the cell is clipped to res - 1, so a coordinate of exactly
// 1.0 weights the corner at res - 1 with frac 0), then for each of the
// 2^DIM corners compute either the spatial hash (xor of coord * prime, in
// uint32 with wrap-around) or the dense row-major index with stride res + 1,
// mask it into the table with & (T - 1), gather the F features and add them
// with the d-linear weight, in f32.
//
// TableT is the table's storage type: float, or an int8 / fp8-e4m3 code
// with one f32 scale per level (repro_torch.quant). A code row is loaded
// whole (F bytes in one load), each code is converted to f32 (exact: every
// int8 and e4m3 value is an f32) and multiplied by the scale, and only then
// added with the weight: the JAX kernel's order, q.astype(f32) * scale
// before the lerp (hashgrid.py:153-161). A float table takes no multiply.
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_fp8.h>
#include <cuda_runtime.h>

namespace repro {

constexpr int kMaxLevels = 32;

// Table storage codes of the C entry points (kernels/common.py
// TABLE_DTYPE_CODE).
enum TableDtype { kTableF32 = 0, kTableInt8 = 1, kTableFp8E4M3 = 2 };

// Per-level resolution and hashed flag, built on the host and passed by
// value as a kernel parameter.
struct LevelMeta {
  int res[kMaxLevels];
  int hashed[kMaxLevels];
};

// instant-NGP's spatial hash primes (core/encoding.py HASH_PRIMES); i is a
// compile-time constant in the unrolled corner loop, so this folds away.
__device__ __forceinline__ uint32_t hash_prime(int i) {
  return i == 0 ? 1u : (i == 1 ? 2654435761u : 805459861u);
}

// One load of F one-byte codes: an unsigned integer F bytes wide (a row
// of F codes starts at a multiple of F bytes, so the load is aligned).
template <int F> struct CodeRow;
template <> struct CodeRow<2> { using type = unsigned short; };
template <> struct CodeRow<8> { using type = unsigned long long; };

// One code's bits as f32, exactly (torch's .float() of the same code).
template <typename TableT>
__device__ __forceinline__ float code_to_float(uint8_t bits) {
  if constexpr (std::is_same<TableT, int8_t>::value) {
    return (float)(int8_t)bits;
  } else {
    static_assert(std::is_same<TableT, __nv_fp8_e4m3>::value,
                  "table codes are int8 or fp8-e4m3");
    __nv_fp8_e4m3 v;
    v.__x = bits;
    return static_cast<float>(v);
  }
}

// feat[f] = q[f] * scale for the F codes of one row.
template <int F, typename TableT>
__device__ __forceinline__ void load_code_row(const TableT* row, float scale,
                                              float (&feat)[F]) {
  using Word = typename CodeRow<F>::type;
  const Word word = __ldg(reinterpret_cast<const Word*>(row));
#pragma unroll
  for (int f = 0; f < F; ++f)
    feat[f] = code_to_float<TableT>((uint8_t)(word >> (8 * f))) * scale;
}

template <int DIM, int F, typename TableT>
__device__ __forceinline__ void encode_one_level(
    const float (&pt)[DIM], const TableT* __restrict__ table, int res,
    bool hashed, uint32_t mask, float scale, float* __restrict__ feat) {
  float frac[DIM];
  int cell[DIM];
#pragma unroll
  for (int i = 0; i < DIM; ++i) {
    const float pos = pt[i] * (float)res;
    const float c = floorf(pos);
    frac[i] = pos - c;
    cell[i] = min(max((int)c, 0), res - 1);
  }
  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.f;
  const uint32_t side = (uint32_t)(res + 1);
#pragma unroll
  for (int c = 0; c < (1 << DIM); ++c) {
    uint32_t idx = 0u, stride = 1u;
    float w = 1.f;
#pragma unroll
    for (int i = 0; i < DIM; ++i) {
      const int bit = (c >> i) & 1;
      const uint32_t coord = (uint32_t)(cell[i] + bit);
      if (hashed) {
        idx ^= coord * hash_prime(i);
      } else {
        idx += coord * stride;
        stride *= side;
      }
      w *= bit ? frac[i] : 1.f - frac[i];
    }
    const TableT* row = table + (size_t)(idx & mask) * F;
    if constexpr (std::is_same<TableT, float>::value) {
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] = fmaf(w, __ldg(row + f), acc[f]);
    } else {
      float q[F];
      load_code_row<F>(row, scale, q);
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] = fmaf(w, q[f], acc[f]);
    }
  }
#pragma unroll
  for (int f = 0; f < F; ++f) feat[f] = acc[f];
}

// The scale of `level`: read on the device from the scene's (L,) scales;
// a float table has none.
template <typename TableT>
__device__ __forceinline__ float level_scale(const float* __restrict__ scales,
                                             int level) {
  if constexpr (std::is_same<TableT, float>::value) {
    return 1.f;
  } else {
    return __ldg(scales + level);
  }
}

// Copies the host's (L, 2) int32 level table into a LevelMeta; false if L
// is out of range.
inline bool fill_level_meta(const int* level_meta, int n_levels,
                            LevelMeta* meta) {
  if (n_levels < 1 || n_levels > kMaxLevels) return false;
  for (int l = 0; l < n_levels; ++l) {
    meta->res[l] = level_meta[2 * l];
    meta->hashed[l] = level_meta[2 * l + 1];
  }
  return true;
}

}  // namespace repro
