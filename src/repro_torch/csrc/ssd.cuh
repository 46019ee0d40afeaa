// Pieces that Mamba-2's SSD kernels share (ssd.cu, the intra-chunk term;
// ssd_inter.cu, the inter-chunk term): bf16 tensor-core products with mma.sync
// and ldmatrix, the padded row stride of a block staged in shared memory, and
// the shared-memory limit of one block.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

// Shared memory one block may use on Hopper (227 KB).
constexpr size_t kSsdMaxSmemBytes = 232448;

// A staged row's stride in bf16 for rows of w values: 16 bytes of padding
// keep the ldmatrix row addresses of 8 consecutive rows on distinct bank
// groups.
__host__ __device__ constexpr int row_stride(int w) { return w + 8; }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a * b, mma.sync m16n8k16, bf16 operands, f32 accumulation. Lane
// (g = lane / 4, t = lane % 4) holds A's (g, 2t..2t+1), (g+8, 2t..),
// (g, 2t+8..), (g+8, 2t+8..); B's (2t..2t+1, g), (2t+8.., g); C's (g, 2t..)
// and (g+8, 2t..).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8. Plain: lane (g, t) receives row g, columns
// 2t..2t+1 of each; .trans: rows 2t..2t+1 of column g.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* row) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* row) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// Raises the kernel's dynamic shared-memory limit to what a launch needs.
inline cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem > kSsdMaxSmemBytes) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace repro
