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
// TableT is the table's storage type: f32 or bf16 (dense), or an int8 /
// fp8-e4m3 code with one f32 scale per level (repro_torch.quant). A row is
// loaded whole (F values in one aligned load), each value is converted to
// f32 (exact: every bf16, int8 and e4m3 value is an f32), a code is
// multiplied by its scale, and only then is it added with the weight: the
// JAX kernel's order, astype(f32) (times the scale) before the lerp
// (hashgrid.py:153-158). A dense table takes no multiply.
//
// LevelGather splits one level into fetch (indices, weights, loads) and
// finish (the sums), so that a kernel can put the loads of several levels
// in flight before it adds any of them up: two levels in the fused field
// kernel (field.cu), a level group in the standalone encode (encode.cu).
// The arithmetic is the same either way.
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

namespace repro {

constexpr int kMaxLevels = 32;

// Table storage codes of the C entry points (kernels/common.py
// TABLE_DTYPE_CODE).
enum TableDtype {
  kTableF32 = 0,
  kTableInt8 = 1,
  kTableFp8E4M3 = 2,
  kTableBf16 = 3
};

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

// The raw bits of one table row (F values of TableT), fetched with one
// aligned load of its whole width (two 16-byte loads for 32 bytes). A row
// starts at a multiple of its own size, which the wrappers check.
template <int kBytes> struct RowBits;
template <> struct RowBits<2> {
  uint32_t w[1];
  __device__ __forceinline__ void load(const void* p) {
    w[0] = __ldg(static_cast<const unsigned short*>(p));
  }
};
template <> struct RowBits<4> {
  uint32_t w[1];
  __device__ __forceinline__ void load(const void* p) {
    w[0] = __ldg(static_cast<const unsigned int*>(p));
  }
};
template <> struct RowBits<8> {
  uint32_t w[2];
  __device__ __forceinline__ void load(const void* p) {
    const uint2 v = __ldg(static_cast<const uint2*>(p));
    w[0] = v.x;
    w[1] = v.y;
  }
};
template <> struct RowBits<16> {
  uint32_t w[4];
  __device__ __forceinline__ void load(const void* p) {
    const uint4 v = __ldg(static_cast<const uint4*>(p));
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  }
};
template <> struct RowBits<32> {
  uint32_t w[8];
  __device__ __forceinline__ void load(const void* p) {
    const uint4 a = __ldg(static_cast<const uint4*>(p));
    const uint4 b = __ldg(static_cast<const uint4*>(p) + 1);
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
    w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
  }
};

template <typename TableT>
__host__ __device__ constexpr bool is_code() {
  return std::is_same<TableT, int8_t>::value ||
         std::is_same<TableT, __nv_fp8_e4m3>::value;
}

// Value f of a row as f32, exactly (torch's .float() of the same element):
// f32 as it is, bf16 by __bfloat162float, an int8 or e4m3 code by its
// exact conversion (the scale is applied by the caller).
template <typename TableT, int kBytes>
__device__ __forceinline__ float row_value(const RowBits<kBytes>& r, int f) {
  if constexpr (std::is_same<TableT, float>::value) {
    return __uint_as_float(r.w[f]);
  } else if constexpr (std::is_same<TableT, __nv_bfloat16>::value) {
    __nv_bfloat16_raw raw;
    raw.x = (unsigned short)(r.w[f / 2] >> (16 * (f & 1)));
    return __bfloat162float(__nv_bfloat16(raw));
  } else if constexpr (std::is_same<TableT, int8_t>::value) {
    return (float)(int8_t)(uint8_t)(r.w[f / 4] >> (8 * (f & 3)));
  } else {
    static_assert(std::is_same<TableT, __nv_fp8_e4m3>::value,
                  "tables are f32, bf16, int8 or fp8-e4m3");
    __nv_fp8_e4m3 v;
    v.__x = (uint8_t)(r.w[f / 4] >> (8 * (f & 3)));
    return static_cast<float>(v);
  }
}

// The gathers of one point at one level, split in two so that a caller can
// start the loads of several levels before it adds any of them up.
template <int DIM, int F, typename TableT>
struct LevelGather {
  static constexpr int kCorners = 1 << DIM;
  RowBits<F * (int)sizeof(TableT)> row[kCorners];
  float w[kCorners];

  // Corner rows and d-linear weights of pt at this level; loads the rows.
  __device__ __forceinline__ void fetch(const float (&pt)[DIM],
                                        const TableT* __restrict__ table,
                                        int res, bool hashed, uint32_t mask) {
    float frac[DIM];
    int cell[DIM];
#pragma unroll
    for (int i = 0; i < DIM; ++i) {
      const float pos = pt[i] * (float)res;
      const float c = floorf(pos);
      frac[i] = pos - c;
      cell[i] = min(max((int)c, 0), res - 1);
    }
    const uint32_t side = (uint32_t)(res + 1);
#pragma unroll
    for (int c = 0; c < kCorners; ++c) {
      uint32_t idx = 0u, stride = 1u;
      float wc = 1.f;
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
        wc *= bit ? frac[i] : 1.f - frac[i];
      }
      w[c] = wc;
      row[c].load(table + (size_t)(idx & mask) * F);
    }
  }

  // feat[f] = sum over corners, in order, of w * value (a code's value is
  // q * scale, taken before the FMA: the JAX order).
  __device__ __forceinline__ void finish(float scale, float (&feat)[F]) const {
#pragma unroll
    for (int f = 0; f < F; ++f) feat[f] = 0.f;
#pragma unroll
    for (int c = 0; c < kCorners; ++c) {
#pragma unroll
      for (int f = 0; f < F; ++f) {
        float v = row_value<TableT>(row[c], f);
        if constexpr (is_code<TableT>()) v *= scale;
        feat[f] = fmaf(w[c], v, feat[f]);
      }
    }
  }
};

// The scale of `level`: read on the device from the scene's (L,) scales;
// a dense (f32 or bf16) table has none.
template <typename TableT>
__device__ __forceinline__ float level_scale(const float* __restrict__ scales,
                                             int level) {
  if constexpr (is_code<TableT>()) {
    return __ldg(scales + level);
  } else {
    return 1.f;
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
