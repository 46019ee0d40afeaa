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
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro {

constexpr int kMaxLevels = 32;

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

template <int DIM, int F>
__device__ __forceinline__ void encode_one_level(
    const float (&pt)[DIM], const float* __restrict__ table, int res,
    bool hashed, uint32_t mask, float* __restrict__ feat) {
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
    const float* row = table + (size_t)(idx & mask) * F;
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = fmaf(w, __ldg(row + f), acc[f]);
  }
#pragma unroll
  for (int f = 0; f < F; ++f) feat[f] = acc[f];
}

}  // namespace repro
