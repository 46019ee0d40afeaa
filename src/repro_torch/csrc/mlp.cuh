// Tensor-core MLP device code, shared by the standalone MLP kernel (mlp.cu)
// and the fused field kernel (field.cu): a bias-free ReLU MLP run by one
// warp over 16 rows, every layer an mma.sync.m16n8k8 TF32 product with f32
// accumulation, in the 3xTF32 split that keeps f32 accuracy.
//
// 3xTF32. A TF32 operand keeps 11 significant bits. Each f32 value a is
// split as a = hi + lo, hi = tf32(a), lo = tf32(a - hi), and a product is
// taken as lo*hi' + hi*lo' + hi*hi' (the lo*lo' term is below f32's last
// bit), accumulated in f32. One TF32 pass alone would miss the kernels'
// 1e-4 parity: the density MLP's output goes through exp(sigma).
//
// Weights. Each block stages every layer's weights into shared memory once,
// already split and laid out in mma fragment order: for k-tile j and
// n-tile n, lane (g = lane / 4, t = lane % 4) finds one float4
// {hi(W[8j+2t][8n+g]), hi(W[8j+2t+1][8n+g]), lo(...), lo(...)}, so a B
// fragment is one conflict-free 16-byte shared load. K and N are zero-padded
// to multiples of 8 (as the JAX kernel pads to 128 lanes), the hidden width
// to kHidden (64 or 128): a zero row or column adds exact zeros.
//
// Activations never leave the warp. mma's accumulator gives lane (g, t)
// columns 2t and 2t+1 of rows g and g+8 of each 8-wide n-tile; its A operand
// wants columns t and t+4. Taking the k order inside every 8-wide k-tile as
// (0, 2, 4, 6, 1, 3, 5, 7), for A and B alike, makes the two layouts the
// same, so a layer's accumulators are the next layer's A fragments in
// registers: no shared-memory round trip and no barrier between layers.
//
// Why mma.sync and not wgmma: wgmma works on 64-row warpgroup tiles with B
// in swizzled shared memory and asynchronous completion; mma.sync keeps one
// warp's 16 rows in registers through every layer and is the simpler design
// to get right first. wgmma and TMA are later work.
#pragma once

#include <cstdint>
#include <mutex>
#include <vector>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

// Shared memory one block may use on Hopper (227 KB).
constexpr size_t kMaxSmemBytes = 232448;

struct MlpDims {
  int din;       // input width
  int hidden;    // hidden width (a multiple of 8)
  int n_hidden;  // hidden layers; n_hidden - 1 hidden-to-hidden matrices
  int dout;      // output width
};

// The MLP's weights in device memory: row-major (in, out) matrices of f32
// or bf16 (w_bf16), converted to f32 exactly when they are staged.
struct MlpWeights {
  const void* w_in;       // (din, hidden)
  const void* w_hidden;   // (n_hidden - 1, hidden, hidden)
  const void* w_out;      // (hidden, dout)
  int w_bf16;
};

__host__ __device__ inline int tiles8(int n) { return (n + 7) / 8; }

// float4 fragments of the staged weights for a padded hidden width hp.
__host__ __device__ inline int weight_frags(const MlpDims& d, int hp) {
  const int nt = hp / 8;
  return 32 * (tiles8(d.din) * nt + (d.n_hidden - 1) * nt * nt +
               nt * tiles8(d.dout));
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// hi/lo TF32 split of four A values.
__device__ __forceinline__ void split_tf32(const float (&a)[4],
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = tf32_rna(a[i]);
    lo[i] = tf32_rna(a[i] - __uint_as_float(hi[i]));
  }
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += A * B in 3xTF32, the small products first.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           const float4 b) {
  const uint32_t bh0 = __float_as_uint(b.x), bh1 = __float_as_uint(b.y);
  const uint32_t bl0 = __float_as_uint(b.z), bl1 = __float_as_uint(b.w);
  mma_tf32(c, a_lo, bh0, bh1);
  mma_tf32(c, a_hi, bl0, bl1);
  mma_tf32(c, a_hi, bh0, bh1);
}

__device__ __forceinline__ float load_weight(const void* w, int w_bf16,
                                             size_t i) {
  return w_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(w)[i])
                : static_cast<const float*>(w)[i];
}

// Stages one (K, N) matrix as kt x nt fragment tiles (see the note above).
__device__ __forceinline__ void stage_matrix(float4* dst, const void* w,
                                             int w_bf16, int K, int N, int kt,
                                             int nt) {
  for (int idx = threadIdx.x; idx < kt * nt * 32; idx += blockDim.x) {
    const int lane = idx & 31, tile = idx >> 5;
    const int j = tile / nt, n = tile - j * nt;
    const int k0 = 8 * j + 2 * (lane & 3), col = 8 * n + (lane >> 2);
    float x[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      x[i] = (k0 + i < K && col < N)
                 ? load_weight(w, w_bf16, (size_t)(k0 + i) * N + col)
                 : 0.f;
    const uint32_t h0 = tf32_rna(x[0]), h1 = tf32_rna(x[1]);
    const uint32_t l0 = tf32_rna(x[0] - __uint_as_float(h0));
    const uint32_t l1 = tf32_rna(x[1] - __uint_as_float(h1));
    dst[idx] = make_float4(__uint_as_float(h0), __uint_as_float(h1),
                           __uint_as_float(l0), __uint_as_float(l1));
  }
}

// Every thread of the block stages all weights, padded to hidden width hp.
__device__ __forceinline__ void stage_weights(float4* dst, const MlpWeights& w,
                                              const MlpDims& d, int hp) {
  const int nt = hp / 8, kt_in = tiles8(d.din);
  stage_matrix(dst, w.w_in, w.w_bf16, d.din, d.hidden, kt_in, nt);
  dst += 32 * kt_in * nt;
  const size_t hh = (size_t)d.hidden * d.hidden;
  for (int l = 0; l < d.n_hidden - 1; ++l) {
    const void* wl = w.w_bf16
        ? (const void*)(static_cast<const __nv_bfloat16*>(w.w_hidden) + l * hh)
        : (const void*)(static_cast<const float*>(w.w_hidden) + l * hh);
    stage_matrix(dst, wl, w.w_bf16, d.hidden, d.hidden, nt, nt);
    dst += 32 * nt * nt;
  }
  stage_matrix(dst, w.w_out, w.w_bf16, d.hidden, d.dout, nt, tiles8(d.dout));
}

// One warp runs the MLP on 16 rows. load_a(j, a) fills the A values of
// input k-tile j for this lane: a[0], a[2] = columns 8j+2t, 8j+2t+1 of row
// g; a[1], a[3] the same of row g+8 (zero past din or past the last row).
// release() runs once the input layer has read its last input.
// store(col, r, v) writes output column col of tile row r (r = g or g+8);
// it is called for col < dout only. wf: the staged weights.
template <int kHidden, typename LoadA, typename Release, typename Store>
__device__ __forceinline__ void mlp_warp_rows16(LoadA load_a, Release release,
                                                Store store,
                                                const float4* __restrict__ wf,
                                                const MlpDims& d) {
  constexpr int NT = kHidden / 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  // input layer: k-tiles of din at run time, n-tiles unrolled
  const int kt_in = tiles8(d.din);
  for (int j = 0; j < kt_in; ++j) {
    float a[4];
    load_a(j, a);
    uint32_t hi[4], lo[4];
    split_tf32(a, hi, lo);
#pragma unroll
    for (int n = 0; n < NT; ++n)
      mma_3xtf32(acc[n], hi, lo, wf[(j * NT + n) * 32 + lane]);
  }
  release();
  wf += 32 * kt_in * NT;

  // hidden layers: the ReLU'd accumulators are the next A fragments
  for (int l = 0; l < d.n_hidden - 1; ++l) {
    float nxt[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) nxt[n][i] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float a[4] = {fmaxf(acc[j][0], 0.f), fmaxf(acc[j][2], 0.f),
                          fmaxf(acc[j][1], 0.f), fmaxf(acc[j][3], 0.f)};
      uint32_t hi[4], lo[4];
      split_tf32(a, hi, lo);
#pragma unroll
      for (int n = 0; n < NT; ++n)
        mma_3xtf32(nxt[n], hi, lo, wf[(j * NT + n) * 32 + lane]);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] = nxt[n][i];
    wf += 32 * NT * NT;
  }

  // output layer, no activation: n-tiles of dout at run time
  const int nt_out = tiles8(d.dout);
  for (int n = 0; n < nt_out; ++n) {
    float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float a[4] = {fmaxf(acc[j][0], 0.f), fmaxf(acc[j][2], 0.f),
                          fmaxf(acc[j][1], 0.f), fmaxf(acc[j][3], 0.f)};
      uint32_t hi[4], lo[4];
      split_tf32(a, hi, lo);
      mma_3xtf32(c, hi, lo, wf[(j * nt_out + n) * 32 + lane]);
    }
    const int col = 8 * n + 2 * t;
    if (col < d.dout) {
      store(col, g, c[0]);
      store(col, g + 8, c[2]);
    }
    if (col + 1 < d.dout) {
      store(col + 1, g, c[1]);
      store(col + 1, g + 8, c[3]);
    }
  }
}

// Persistent grid: at most as many blocks as fit on the card at once, and
// no more than the work needs. The cap depends only on the kernel, its block
// and shared-memory sizes and the device, so it is worked out at the first
// launch of each (raising the kernel's dynamic shared-memory limit to
// kMaxSmemBytes, reading the SM count and the occupancy) and looked up after
// that: a steady launch makes no runtime call for it.
inline cudaError_t persistent_grid(const void* kernel, int threads,
                                   size_t smem, long long blocks_needed,
                                   int device, unsigned* grid) {
  struct Cap {
    const void* kernel;
    int threads;
    size_t smem;
    int device;
    long long blocks;
  };
  static std::mutex mu;
  static std::vector<Cap> caps;
  long long cap = 0;
  {
    std::lock_guard<std::mutex> lock(mu);
    for (const Cap& c : caps)
      if (c.kernel == kernel && c.threads == threads && c.smem == smem &&
          c.device == device)
        cap = c.blocks;
  }
  if (cap == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kMaxSmemBytes);
    if (err != cudaSuccess) return err;
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cap = (long long)sms * per_sm;
    std::lock_guard<std::mutex> lock(mu);
    caps.push_back({kernel, threads, smem, device, cap});
  }
  *grid = (unsigned)(blocks_needed < cap ? blocks_needed : cap);
  return cudaSuccess;
}

}  // namespace repro
