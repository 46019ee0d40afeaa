// Fully fused tiny MLP for Hopper (NeRF's colour MLP on the serve path).
//
// Replaces the JAX package's kernels/fused_mlp/fused_mlp.py:
// fused_mlp_pallas (body _mlp_kernel).
//
// What bounds it on the card: at NeRF's colour MLP (32 -> 64 x 4 -> 3) a row
// moves 140 bytes and does 29,056 flops, so the products bound it, not
// memory: 131,072 rows take 3.8 GFLOP, three times over in 3xTF32.
//
// The design puts the products on the tensor cores (mlp.cuh: mma.sync
// m16n8k8 TF32, 3xTF32 for f32 accuracy). The grid is persistent: one block
// per SM that fits, each staging every weight into shared memory once
// (116 KB for the colour MLP, split and in fragment order) and then looping
// its warps over 16-row tiles. A warp reads its tile's inputs straight from
// device memory into A fragments, keeps the activations in registers
// through every layer and writes only the (rows, dout) output. There is no
// block-wide barrier after the staging.
#include <cstdint>

#include <cuda_runtime.h>

#include "info.cuh"
#include "mlp.cuh"

namespace repro {

// Warps per block: 16 at hidden width 64; 8 at 128, whose accumulators take
// twice the registers.
template <int kHidden>
__host__ __device__ constexpr int mlp_warps() {
  return kHidden <= 64 ? 16 : 8;
}

template <int kHidden>
__global__ void __launch_bounds__(32 * mlp_warps<kHidden>(), 1) mlp_fwd_kernel(
    const float* __restrict__ x, const MlpWeights w, const MlpDims d,
    float* __restrict__ out, long long n_rows) {
  extern __shared__ float4 wf[];
  stage_weights(wf, w, d, kHidden);
  __syncthreads();
  constexpr int kWarps = mlp_warps<kHidden>();
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const long long n_tiles = (n_rows + 15) / 16;
  const bool even = (d.din & 1) == 0;
  for (long long tile = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
       tile < n_tiles; tile += (long long)gridDim.x * kWarps) {
    const long long r0 = tile * 16;
    const long long ra = r0 + g, rb = r0 + g + 8;
    auto load_a = [&](int j, float (&a)[4]) {
      const int col = 8 * j + 2 * t;
      const long long rows[2] = {ra, rb};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v0 = 0.f, v1 = 0.f;
        if (rows[h] < n_rows && col < d.din) {
          const float* p = x + rows[h] * d.din + col;
          if (even) {
            const float2 v = __ldg(reinterpret_cast<const float2*>(p));
            v0 = v.x;
            v1 = v.y;
          } else {
            v0 = __ldg(p);
            if (col + 1 < d.din) v1 = __ldg(p + 1);
          }
        }
        a[h] = v0;          // rows g (h = 0) and g + 8 (h = 1), column 2t
        a[h + 2] = v1;      // the same rows, column 2t + 1
      }
    };
    auto store = [&](int col, int r, float v) {
      if (r0 + r < n_rows) out[(r0 + r) * d.dout + col] = v;
    };
    mlp_warp_rows16<kHidden>(load_a, [] {}, store, wf, d);
  }
}

template <int kHidden>
cudaError_t launch_mlp(const float* x, const MlpWeights& w, const MlpDims& d,
                       float* out, long long n_rows, int device,
                       cudaStream_t stream) {
  const size_t smem = (size_t)weight_frags(d, kHidden) * sizeof(float4);
  if (smem > kMaxSmemBytes) return cudaErrorInvalidValue;
  constexpr int kWarps = mlp_warps<kHidden>(), kThreads = 32 * kWarps;
  auto kernel = mlp_fwd_kernel<kHidden>;
  const long long tiles = (n_rows + 15) / 16;
  unsigned grid = 0;
  cudaError_t err = persistent_grid(reinterpret_cast<const void*>(kernel),
                                    kThreads, smem,
                                    (tiles + kWarps - 1) / kWarps, device,
                                    &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(x, w, d, out, n_rows);
  return cudaGetLastError();
}

}  // namespace repro

// x (B, din) f32; w_in (din, hidden), w_hidden (n_hidden - 1, hidden,
// hidden), w_out (hidden, dout), all f32 (w_bf16 = 0) or all bf16 (1);
// out (B, dout) f32; x 8-byte aligned when din is even (its rows are read
// two floats at a time). hidden is a multiple of 8 up to 128, and the staged
// weights must fit in shared memory (kernels/fused_mlp/fused_mlp.py
// mlp_plan says so before the launch). Launches on `stream` after making
// `device` current; returns the CUDA error of the launch (0 on success).
extern "C" int mlp_fwd(const float* x, const void* w_in, const void* w_hidden,
                       const void* w_out, int w_bf16, int din, int hidden,
                       int n_hidden, int dout, float* out, long long n_rows,
                       int device, void* stream) {
  if (cudaError_t err = cudaSetDevice(device)) return err;
  using namespace repro;
  if (din < 1 || dout < 1 || n_hidden < 1 || hidden < 8 || hidden > 128 ||
      hidden % 8 != 0 ||
      (din % 2 == 0 && reinterpret_cast<uintptr_t>(x) % 8 != 0))
    return cudaErrorInvalidValue;
  if (n_rows == 0) return cudaSuccess;
  const MlpDims d{din, hidden, n_hidden, dout};
  const MlpWeights w{w_in, w_hidden, w_out, w_bf16};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return hidden <= 64 ? launch_mlp<64>(x, w, d, out, n_rows, device, s)
                      : launch_mlp<128>(x, w, d, out, n_rows, device, s);
}

// The resources of the mlp_fwd instantiation a launch with these MLP
// dimensions takes, at their shared memory (info.cuh); returns the CUDA
// error (0 on success).
extern "C" int mlp_fwd_info(int din, int hidden, int n_hidden, int dout,
                            int device, int* out) {
  using namespace repro;
  if (din < 1 || dout < 1 || n_hidden < 1 || hidden < 8 || hidden > 128 ||
      hidden % 8 != 0)
    return cudaErrorInvalidValue;
  const MlpDims d{din, hidden, n_hidden, dout};
  if (hidden <= 64)
    return kernel_info(reinterpret_cast<const void*>(mlp_fwd_kernel<64>),
                       32 * mlp_warps<64>(),
                       (size_t)weight_frags(d, 64) * sizeof(float4),
                       (int)kMaxSmemBytes, device, out);
  return kernel_info(reinterpret_cast<const void*>(mlp_fwd_kernel<128>),
                     32 * mlp_warps<128>(),
                     (size_t)weight_frags(d, 128) * sizeof(float4),
                     (int)kMaxSmemBytes, device, out);
}
