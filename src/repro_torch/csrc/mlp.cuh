// Fully fused, bias-free ReLU MLP over a tile of rows held in shared memory.
//
// Shared by the fused field kernel (field.cu, after the encode) and the
// standalone MLP kernel (mlp.cu). The whole block works on one tile of
// kRows rows: every layer reads its input activations from shared memory
// and writes the next layer's into the other of two shared buffers, so no
// activation ever reaches device memory; only the last layer writes the
// (rows, dout) output. Weights are read through the read-only data cache:
// at most 57 KiB per MLP, they stay resident in L1 for the whole block.
//
// Activation rows are stored with a stride of (width + 1) floats. Threads
// of a warp that read the same column of different rows then hit different
// shared-memory banks; threads that read the same row get a broadcast.
#pragma once

#include <cuda_runtime.h>

namespace repro {

// Rows (points) per thread block, and threads per block, for both kernels.
constexpr int kRows = 64;
constexpr int kThreads = 256;

struct MlpDims {
  int din;       // input width
  int hidden;    // hidden width
  int n_hidden;  // hidden layers; n_hidden - 1 hidden-to-hidden matrices
  int dout;      // output width
};

// Floats of shared memory one block needs: the input tile plus two
// ping-pong activation buffers.
inline size_t mlp_smem_floats(const MlpDims& d) {
  return (size_t)kRows * ((d.din + 1) + 2 * (d.hidden + 1));
}

// out[p][j] = relu(sum_k in[p][k] * w[k][j]) for every row p < n_rows.
__device__ __forceinline__ void dense_relu_layer(
    const float* in, int in_dim, const float* __restrict__ w, int out_dim,
    float* out, int n_rows) {
  const int in_stride = in_dim + 1, out_stride = out_dim + 1;
  for (int idx = threadIdx.x; idx < n_rows * out_dim; idx += blockDim.x) {
    const int p = idx / out_dim, j = idx - p * out_dim;
    const float* x = in + p * in_stride;
    float acc = 0.f;
    for (int k = 0; k < in_dim; ++k) acc = fmaf(x[k], __ldg(w + k * out_dim + j), acc);
    out[p * out_stride + j] = fmaxf(acc, 0.f);
  }
}

// Runs the MLP on the first n_rows rows of the shared tile `x` (row stride
// din + 1) and writes them to rows row0 .. row0 + n_rows - 1 of `out`
// (row-major, dout wide). buf_a and buf_b each hold kRows * (hidden + 1)
// floats. Every thread of the block must call it.
__device__ __forceinline__ void mlp_tile(
    const float* x, float* buf_a, float* buf_b, const float* __restrict__ w_in,
    const float* __restrict__ w_hidden, const float* __restrict__ w_out,
    const MlpDims d, float* __restrict__ out, long long row0, int n_rows) {
  dense_relu_layer(x, d.din, w_in, d.hidden, buf_a, n_rows);
  __syncthreads();
  float* cur = buf_a;
  float* nxt = buf_b;
  for (int l = 0; l < d.n_hidden - 1; ++l) {
    dense_relu_layer(cur, d.hidden, w_hidden + (size_t)l * d.hidden * d.hidden,
                     d.hidden, nxt, n_rows);
    __syncthreads();
    float* t = cur; cur = nxt; nxt = t;
  }
  const int hs = d.hidden + 1;
  for (int idx = threadIdx.x; idx < n_rows * d.dout; idx += blockDim.x) {
    const int p = idx / d.dout, j = idx - p * d.dout;
    const float* h = cur + p * hs;
    float acc = 0.f;
    for (int k = 0; k < d.hidden; ++k) acc = fmaf(h[k], __ldg(w_out + k * d.dout + j), acc);
    out[(row0 + p) * d.dout + j] = acc;
  }
}

}  // namespace repro
