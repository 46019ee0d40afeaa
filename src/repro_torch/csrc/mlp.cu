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
//
// NeRF's colour head (mlp_fwd_kernel<kHidden, NerfHead>, entry point
// mlp_fwd_head) replaces no TPU kernel: the JAX package leaves the head
// (exp, the SH direction encoding, the colour input's concat, sigmoid, the
// output's concat) to XLA around its MLP kernel. It was added to keep the
// (B, 32) colour input and the head's other intermediates out of device
// memory: op by op they cost about a kilobyte of copies a row, against
// which the MLP's own 128 bytes in and 12 out are small. The instantiation
// computes the SH of the row's direction in registers (k-tiles 0-1), reads
// the density features (k-tiles 2-3) and writes only the (B, 4) [rgb,
// sigma] rows: 76 bytes read and 16 written a row. What bounds it is what
// bounds the colour MLP, the products (29,056 flops a row, three times over
// in 3xTF32); the SH, exp and sigmoid add about 70 f32 operations a row.
// It is the same template, so a trace names it mlp_fwd_kernel too.
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

// Marks the colour-head instantiation of mlp_fwd_kernel.
struct NerfHead {};

// The constants of core/encoding.py sh_encode, rounded from double to f32
// as PyTorch rounds a Python float for an f32 tensor.
constexpr float kSh0 = (float)0.28209479177387814;
constexpr float kSh1 = (float)0.48860251190291987;
constexpr float kSh4 = (float)1.0925484305920792;
constexpr float kSh6 = (float)0.94617469575755997;
constexpr float kSh6b = (float)0.31539156525251999;
constexpr float kSh8 = (float)0.54627421529603959;
constexpr float kSh9 = (float)0.59004358992664352;
constexpr float kSh10 = (float)2.8906114426405538;
constexpr float kSh11 = (float)0.45704579946446572;
constexpr float kSh12 = (float)0.3731763325901154;
constexpr float kSh14 = (float)1.4453057213202769;

__device__ __forceinline__ float pick4(int t, float a, float b, float c,
                                       float d) {
  return t == 0 ? a : t == 1 ? b : t == 2 ? c : d;
}

// Columns 2t, 2t+1, 8+2t and 9+2t of the degree-4 real SH of direction
// (x, y, z), in sh_encode's operations and order, each rounded as its own
// PyTorch op rounds it: the _rn intrinsics keep nvcc from contracting a
// product and a sum into one FMA.
__device__ __forceinline__ void sh_columns(float x, float y, float z, int t,
                                           float (&c)[4]) {
  const float xx = __fmul_rn(x, x), yy = __fmul_rn(y, y),
              zz = __fmul_rn(z, z);
  const float xy = __fmul_rn(x, y), yz = __fmul_rn(y, z),
              xz = __fmul_rn(x, z);
  const float xx_yy = __fsub_rn(xx, yy);
  const float one_5zz = __fsub_rn(1.f, __fmul_rn(5.f, zz));
  const float s[16] = {
      kSh0,
      __fmul_rn(-kSh1, y),
      __fmul_rn(kSh1, z),
      __fmul_rn(-kSh1, x),
      __fmul_rn(kSh4, xy),
      __fmul_rn(-kSh4, yz),
      __fsub_rn(__fmul_rn(kSh6, zz), kSh6b),
      __fmul_rn(-kSh4, xz),
      __fmul_rn(kSh8, xx_yy),
      __fmul_rn(__fmul_rn(kSh9, y), __fadd_rn(__fmul_rn(-3.f, xx), yy)),
      __fmul_rn(__fmul_rn(kSh10, xy), z),
      __fmul_rn(__fmul_rn(kSh11, y), one_5zz),
      __fmul_rn(__fmul_rn(kSh12, z), __fsub_rn(__fmul_rn(5.f, zz), 3.f)),
      __fmul_rn(__fmul_rn(kSh11, x), one_5zz),
      __fmul_rn(__fmul_rn(kSh14, z), xx_yy),
      __fmul_rn(__fmul_rn(kSh9, x), __fadd_rn(-xx, __fmul_rn(3.f, yy)))};
  c[0] = pick4(t, s[0], s[2], s[4], s[6]);
  c[1] = pick4(t, s[1], s[3], s[5], s[7]);
  c[2] = pick4(t, s[8], s[10], s[12], s[14]);
  c[3] = pick4(t, s[9], s[11], s[13], s[15]);
}

// NeRF's colour head: out (B, 4) = [sigmoid(MLP([SH(dirs), dfeat])),
// exp(dfeat[:, 0])] for dfeat (B, 16) and dirs (B, 3), the MLP 32 -> dout 3.
// The prologue of each 16-row tile computes the lane's SH columns of rows g
// and g + 8 and writes sigma (lane t = 0); load_a gives k-tiles 0-1 from
// the SH and reads k-tiles 2-3 from dfeat; store writes the sigmoid.
template <int kHidden, typename Head>
__global__ void __launch_bounds__(32 * mlp_warps<kHidden>(), 1) mlp_fwd_kernel(
    const float* __restrict__ dfeat, const float* __restrict__ dirs,
    const MlpWeights w, const MlpDims d, float* __restrict__ out,
    long long n_rows) {
  extern __shared__ float4 wf[];
  stage_weights(wf, w, d, kHidden);
  __syncthreads();
  constexpr int kWarps = mlp_warps<kHidden>();
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const long long n_tiles = (n_rows + 15) / 16;
  for (long long tile = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
       tile < n_tiles; tile += (long long)gridDim.x * kWarps) {
    const long long r0 = tile * 16;
    const long long rows[2] = {r0 + g, r0 + g + 8};
    float sh[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (rows[h] < n_rows) {
        const float* p = dirs + rows[h] * 3;
        sh_columns(__ldg(p), __ldg(p + 1), __ldg(p + 2), t, sh[h]);
        if (t == 0) out[rows[h] * 4 + 3] = expf(__ldg(dfeat + rows[h] * 16));
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) sh[h][i] = 0.f;
      }
    }
    auto load_a = [&](int j, float (&a)[4]) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v0 = 0.f, v1 = 0.f;
        if (j < 2) {
          v0 = j == 0 ? sh[h][0] : sh[h][2];
          v1 = j == 0 ? sh[h][1] : sh[h][3];
        } else if (rows[h] < n_rows) {
          const float2 v = __ldg(reinterpret_cast<const float2*>(
              dfeat + rows[h] * 16 + 8 * (j - 2) + 2 * t));
          v0 = v.x;
          v1 = v.y;
        }
        a[h] = v0;          // rows g (h = 0) and g + 8 (h = 1), column 2t
        a[h + 2] = v1;      // the same rows, column 2t + 1
      }
    };
    auto store = [&](int col, int r, float v) {
      if (r0 + r < n_rows) out[(r0 + r) * 4 + col] = 1.f / (1.f + expf(-v));
    };
    mlp_warp_rows16<kHidden>(load_a, [] {}, store, wf, d);
  }
}

using MlpKernel = void (*)(const float*, const MlpWeights, const MlpDims,
                          float*, long long);
using HeadKernel = void (*)(const float*, const float*, const MlpWeights,
                           const MlpDims, float*, long long);

// Launches `kernel`, an instantiation of mlp_fwd_kernel at hidden width
// kHidden, on its persistent grid with the staged weights' shared memory;
// `args` are the kernel's arguments.
template <int kHidden, typename Kernel, typename... Args>
cudaError_t launch_mlp(Kernel kernel, const MlpDims& d, long long n_rows,
                       int device, cudaStream_t stream, Args... args) {
  const size_t smem = (size_t)weight_frags(d, kHidden) * sizeof(float4);
  if (smem > kMaxSmemBytes) return cudaErrorInvalidValue;
  constexpr int kWarps = mlp_warps<kHidden>(), kThreads = 32 * kWarps;
  const long long tiles = (n_rows + 15) / 16;
  unsigned grid = 0;
  cudaError_t err = persistent_grid(reinterpret_cast<const void*>(kernel),
                                    kThreads, smem,
                                    (tiles + kWarps - 1) / kWarps, device,
                                    &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(args...);
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
  return hidden <= 64
             ? launch_mlp<64>(static_cast<MlpKernel>(mlp_fwd_kernel<64>), d,
                              n_rows, device, s, x, w, d, out, n_rows)
             : launch_mlp<128>(static_cast<MlpKernel>(mlp_fwd_kernel<128>),
                               d, n_rows, device, s, x, w, d, out, n_rows);
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
    return kernel_info(reinterpret_cast<const void*>(
                           static_cast<MlpKernel>(mlp_fwd_kernel<64>)),
                       32 * mlp_warps<64>(),
                       (size_t)weight_frags(d, 64) * sizeof(float4),
                       (int)kMaxSmemBytes, device, out);
  return kernel_info(reinterpret_cast<const void*>(
                         static_cast<MlpKernel>(mlp_fwd_kernel<128>)),
                     32 * mlp_warps<128>(),
                     (size_t)weight_frags(d, 128) * sizeof(float4),
                     (int)kMaxSmemBytes, device, out);
}

// NeRF's colour head in one launch (mlp_fwd_kernel<kHidden, NerfHead>):
// dfeat (B, 16) f32, the density MLP's output, 8-byte aligned; dirs (B, 3)
// f32; the colour MLP's weights as mlp_fwd takes them, with din 32 (the 16
// SH columns, then dfeat) and dout 3; out (B, 4) f32 = [sigmoid(rgb),
// exp(dfeat[:, 0])]. Launches on `stream` after making `device` current;
// returns the CUDA error of the launch (0 on success).
extern "C" int mlp_fwd_head(const float* dfeat, const float* dirs,
                            const void* w_in, const void* w_hidden,
                            const void* w_out, int w_bf16, int din,
                            int hidden, int n_hidden, int dout, float* out,
                            long long n_rows, int device, void* stream) {
  if (cudaError_t err = cudaSetDevice(device)) return err;
  using namespace repro;
  if (din != 32 || dout != 3 || n_hidden < 1 || hidden < 8 ||
      hidden > 128 || hidden % 8 != 0 ||
      reinterpret_cast<uintptr_t>(dfeat) % 8 != 0)
    return cudaErrorInvalidValue;
  if (n_rows == 0) return cudaSuccess;
  const MlpDims d{din, hidden, n_hidden, dout};
  const MlpWeights w{w_in, w_hidden, w_out, w_bf16};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return hidden <= 64
             ? launch_mlp<64>(
                   static_cast<HeadKernel>(mlp_fwd_kernel<64, NerfHead>), d,
                   n_rows, device, s, dfeat, dirs, w, d, out, n_rows)
             : launch_mlp<128>(
                   static_cast<HeadKernel>(mlp_fwd_kernel<128, NerfHead>), d,
                   n_rows, device, s, dfeat, dirs, w, d, out, n_rows);
}
