// Mamba-2's inter-chunk SSD term for Hopper, forward and backward.
//
// Replaces no TPU kernel: the JAX package's models/ssm.py:ssd_chunked takes
// this term in XLA (a lax.scan over the chunks). In the port's ssd_chunked it
// was plain PyTorch: B and C repeated over each group's heads as (b, nc, q, h,
// n) bf16 tensors, their products with the per-position weights, an einsum for
// the chunk states, a Python loop over the chunks carrying the (b, h, p, n)
// state, and an einsum for the carried state's contribution y_inter. At
// granite-4.0-h-small's layer (b 2, 32 chunks of 256, 128 heads of 64, d_state
// 128, one group) each repeated tensor is 537 MB, and autograd's backward of
// the loop zero-fills a whole chunk-state tensor for every chunk. The useful
// work reads x, B, C and the per-position scalars once and moves the (b, nc,
// h, p, n) chunk states a few times: bytes (HBM) bound it, not the products.
//
// The term, for batch row b, chunk c, head h of group h / rep and the chunk's
// positions q, cl = cums at the chunk's last position; every rounding is the
// plain route's (the same f32 operations in the same order, built without
// fast math):
//   w_q = bf16(exp(cl - cums_q) * dt_q), decay = bf16(exp(cl)),
//   outw_q = bf16(exp(cums_q))
//   S_c[p][n] = bf16(sum_q bf16(w_q B_q[n]) x_q[p])          (f32 sum)
//   s_0 = 0, s_{c+1} = bf16(bf16(s_c decay_c) + S_c[p][n]), prev_c = s_c
//   y_q[p] = bf16(sum_n bf16(outw_q C_q[n]) prev_c[p][n])    (f32 sum)
// Given the same chunk states the recurrence is bit for bit the plain loop.
//
// Forward (ssd_inter_fwd), three kernels in order on one stream:
//   chunk_state: one block per (chunk, hb heads of one group). The chunk's B
//     rows are staged once in shared memory and serve the hb heads (no
//     repeat); per head x's rows are staged and 8 warps take S = x^T u on the
//     tensor cores (mma.sync m16n8k16 bf16, f32 sums), u's B fragments scaled
//     by w and rounded in registers.
//   scan_fwd: one block per (b, h), the state in registers, a loop over the
//     chunks: writes prev_c (saved for the backward) and the final state.
//   inter_out: one block per (chunk, hb heads): the chunk's C rows staged
//     once, prev_c per head; each warp owns 16-row tiles of y = v prev_c^T.
// Backward (ssd_inter_bwd), rounding where autograd's bf16 tensors round
// (d prev, dv, du, their products with the weights, dB, dC, dx):
//   chunk_state again: d prev_c = bf16(sum_q bf16(outw_q C_q[n]) dy_q[p]).
//   scan_bwd: one block per (b, h), the reverse recurrence from g = the final
//     state's gradient: d S_c = g, d decay_c = bf16(sum bf16(g s_c)), g =
//     bf16(bf16(g decay_c) + d prev_c); no zero fill per chunk.
//   inter_dm, C's side: one block per (chunk, group, 64 positions), a loop
//     over the group's heads: dv = bf16(dy prev_c), dC = bf16(the heads' sum
//     of bf16(dv outw)), d outw = bf16(sum_n bf16(dv C)); B's side alike with
//     x, d S_c and w, plus dx = bf16(sum_n u d S_c). A group's sums stay in
//     registers: no partials, no atomics.
//   scalar_bwd: one block per (chunk, 32 heads): d cums and d dt from d
//     outw, dw and d decay in f32, as autograd takes them through the exps
//     and the casts.
// Every sum runs in a fixed order: the results are the same every run.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "info.cuh"
#include "ssd.cuh"

namespace repro {
namespace {

constexpr int kInterWarps = 8;
constexpr int kInterThreads = 32 * kInterWarps;
constexpr int kInterMaxChunk = 256;
// positions of a chunk one inter_dm block takes: 4 warps of 16 rows, each
// row's columns split between two warps
constexpr int kDmRows = 64;

// The weight of a position: a chunk state's w_q, or y_inter's outw_q.
enum WeightKind { kStateWeight = 0, kOutWeight = 1 };

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// w_q or outw_q of head hh at position j of chunk bc, rounded as the plain
// route rounds it; cums, dt (chunks, q, h) f32.
__device__ __forceinline__ float position_weight(int kind, const float* cums,
                                                 const float* dt, long long bc,
                                                 int j, int q, int h, int hh) {
  const float cq = cums[(bc * q + j) * h + hh];
  if (kind == kOutWeight) return bf16_round(expf(cq));
  const float cl = cums[(bc * q + q - 1) * h + hh];
  return bf16_round(expf(cl - cq) * dt[(bc * q + j) * h + hh]);
}

// A bf16 pair times (lo, hi), each product rounded to bf16.
__device__ __forceinline__ uint32_t scale_pair(uint32_t v, float lo,
                                               float hi) {
  const __nv_bfloat162 b = *reinterpret_cast<__nv_bfloat162*>(&v);
  return pack_bf16(__low2float(b) * lo, __high2float(b) * hi);
}

// The recurrence's step on a pair: bf16(bf16(s d) + add).
__device__ __forceinline__ __nv_bfloat162 carry(__nv_bfloat162 s, float d,
                                                __nv_bfloat162 add) {
  return __floats2bfloat162_rn(
      bf16_round(__low2float(s) * d) + __low2float(add),
      bf16_round(__high2float(s) * d) + __high2float(add));
}

// `rows` rows of W bf16 values into shared memory at row_stride(W), from row
// row0 of a tensor whose rows are `ld` elements apart, from column `col`; 16
// bytes a load.
template <int W>
__device__ __forceinline__ void stage(__nv_bfloat16* dst,
                                      const __nv_bfloat16* src, long long row0,
                                      int rows, long long ld, long long col) {
  constexpr int V = W / 8;
  for (int idx = threadIdx.x; idx < rows * V; idx += blockDim.x) {
    const int j = idx / V, v = idx - j * V;
    *reinterpret_cast<uint4*>(dst + j * row_stride(W) + 8 * v) =
        *reinterpret_cast<const uint4*>(src + (row0 + j) * ld + col + 8 * v);
  }
}

__host__ __device__ inline size_t state_smem(int q, int p, int n) {
  return (size_t)q * (row_stride(n) + row_stride(p)) * 2 +
         (size_t)q * sizeof(float);
}

__host__ __device__ inline size_t out_smem(int q, int p, int n) {
  return (size_t)(q + p) * row_stride(n) * 2 + (size_t)q * sizeof(float);
}

__host__ __device__ inline size_t dm_smem(int p, int n) {
  return (size_t)kDmRows * (row_stride(n) + row_stride(p)) * 2 +
         (size_t)p * row_stride(n) * 2 + 3 * (size_t)kDmRows * sizeof(float);
}

// out (chunks, h, P, N) bf16: out[p][n] = bf16(sum_q X_q[p] bf16(s_q M_q[n]))
// for each chunk and head, s the weight `kind` names. X: rows of chunk
// positions (chunks * q of them, ldx elements apart), each h heads of P
// values; M: rows ldm apart, each g groups of N values. Block: chunk bc =
// blockIdx.x / (h / hb), heads hb * (blockIdx.x % (h / hb)) and the hb - 1
// after it, all of one group. WN warps across n (16 columns each), WM across
// p; with N = 16 the warps past P / 16 idle.
template <int P, int N>
__global__ void __launch_bounds__(kInterThreads, 2) chunk_state_kernel(
    const __nv_bfloat16* __restrict__ X, const __nv_bfloat16* __restrict__ M,
    const float* __restrict__ cums, const float* __restrict__ dt,
    __nv_bfloat16* __restrict__ out, long long ldx, long long ldm, int q,
    int h, int g, int hb, int kind) {
  constexpr int LDM = row_stride(N), LDX = row_stride(P);
  constexpr int WN = N / 16 < kInterWarps ? N / 16 : kInterWarps;
  constexpr int WM = kInterWarps / WN;
  constexpr int NT = N / 16 / WN;                 // n tiles of 16 a warp
  constexpr int MT = (P / 16 + WM - 1) / WM;      // p tiles of 16 a warp
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ms = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* xs = ms + q * LDM;
  float* ss = reinterpret_cast<float*>(xs + q * LDX);

  const int per_chunk = h / hb;
  const long long bc = blockIdx.x / per_chunk;
  const int h0 = hb * (int)(blockIdx.x % per_chunk);
  const int gi = h0 / (h / g);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, t = lane & 3;
  const int lm = lane >> 3, lr = lane & 7;   // ldmatrix: matrix, row
  const int wn = warp % WN, wm = warp / WN;

  stage<N>(ms, M, bc * q, q, ldm, (long long)gi * N);
  for (int hh = h0; hh < h0 + hb; ++hh) {
    stage<P>(xs, X, bc * q, q, ldx, (long long)hh * P);
    for (int j = threadIdx.x; j < q; j += blockDim.x)
      ss[j] = position_weight(kind, cums, dt, bc, j, q, h, hh);
    __syncthreads();

    float acc[MT][NT][2][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[i][j][k >> 2][k & 3] = 0.f;
    for (int k0 = 0; k0 < q; k0 += 16) {
      const float s0 = ss[k0 + 2 * t], s1 = ss[k0 + 2 * t + 1];
      const float s8 = ss[k0 + 2 * t + 8], s9 = ss[k0 + 2 * t + 9];
      // u's B fragments (k = position, n): rows k0.., columns of tile j
      uint32_t b[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        ldsm_x4_trans(b[j], ms + (k0 + lr + 8 * (lm & 1)) * LDM +
                                16 * (wn + WN * j) + 8 * (lm >> 1));
        b[j][0] = scale_pair(b[j][0], s0, s1);
        b[j][1] = scale_pair(b[j][1], s8, s9);
        b[j][2] = scale_pair(b[j][2], s0, s1);
        b[j][3] = scale_pair(b[j][3], s8, s9);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int mt = wm + WM * i;
        if (mt >= P / 16) continue;
        // x^T's A fragments (m = p, k = position)
        uint32_t a[4];
        ldsm_x4_trans(a, xs + (k0 + 8 * (lm >> 1) + lr) * LDX + 16 * mt +
                             8 * (lm & 1));
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          mma_bf16(acc[i][j][0], a, b[j][0], b[j][1]);
          mma_bf16(acc[i][j][1], a, b[j][2], b[j][3]);
        }
      }
    }
    __nv_bfloat16* o = out + (bc * h + hh) * (long long)(P * N);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int mt = wm + WM * i;
      if (mt >= P / 16) continue;
      const int row = 16 * mt + gr;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int col = 16 * (wn + WN * j) + 8 * half + 2 * t;
          *reinterpret_cast<uint32_t*>(o + row * N + col) =
              pack_bf16(acc[i][j][half][0], acc[i][j][half][1]);
          *reinterpret_cast<uint32_t*>(o + (row + 8) * N + col) =
              pack_bf16(acc[i][j][half][2], acc[i][j][half][3]);
        }
    }
    __syncthreads();
  }
}

// The forward recurrence. states, prev (chunks, h, E) bf16, final_state (b,
// h, E), E = P * N; cums (chunks, q, h). Block: batch row blockIdx.x / h,
// head blockIdx.x % h; each thread carries PER pairs of the state.
template <int E>
__global__ void __launch_bounds__(kInterThreads) scan_fwd_kernel(
    const __nv_bfloat16* __restrict__ states, const float* __restrict__ cums,
    __nv_bfloat16* __restrict__ prev, __nv_bfloat16* __restrict__ final_state,
    int nc, int q, int h) {
  constexpr int PAIRS = E / 2;
  constexpr int PER = (PAIRS + kInterThreads - 1) / kInterThreads;
  const long long bi = blockIdx.x / h;
  const int hh = blockIdx.x % h;
  __nv_bfloat162 s[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) s[k] = __floats2bfloat162_rn(0.f, 0.f);
  for (int c = 0; c < nc; ++c) {
    const long long bc = bi * nc + c;
    const float d = bf16_round(expf(cums[(bc * q + q - 1) * h + hh]));
    const __nv_bfloat162* src =
        reinterpret_cast<const __nv_bfloat162*>(states) + (bc * h + hh) * PAIRS;
    __nv_bfloat162* dst =
        reinterpret_cast<__nv_bfloat162*>(prev) + (bc * h + hh) * PAIRS;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int idx = threadIdx.x + kInterThreads * k;
      if (idx < PAIRS) {
        const __nv_bfloat162 add = src[idx];
        dst[idx] = s[k];
        s[k] = carry(s[k], d, add);
      }
    }
  }
  __nv_bfloat162* fin =
      reinterpret_cast<__nv_bfloat162*>(final_state) + (bi * h + hh) * PAIRS;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int idx = threadIdx.x + kInterThreads * k;
    if (idx < PAIRS) fin[idx] = s[k];
  }
}

// y (chunks, q, h, P) bf16: y_q[p] = bf16(sum_n bf16(outw_q C_q[n])
// prev[p][n]); C rows ldc apart (g groups of N); prev (chunks, h, P, N).
// Block as chunk_state_kernel's; warp w owns the 16-row tiles w, w + 8.
template <int P, int N>
__global__ void __launch_bounds__(kInterThreads, 2) inter_out_kernel(
    const __nv_bfloat16* __restrict__ C, const __nv_bfloat16* __restrict__ prev,
    const float* __restrict__ cums, __nv_bfloat16* __restrict__ y,
    long long ldc, int q, int h, int g, int hb) {
  constexpr int LD = row_stride(N);
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* cs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ps = cs + q * LD;
  float* ss = reinterpret_cast<float*>(ps + P * LD);

  const int per_chunk = h / hb;
  const long long bc = blockIdx.x / per_chunk;
  const int h0 = hb * (int)(blockIdx.x % per_chunk);
  const int gi = h0 / (h / g);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, t = lane & 3;
  const int lm = lane >> 3, lr = lane & 7;

  stage<N>(cs, C, bc * q, q, ldc, (long long)gi * N);
  for (int hh = h0; hh < h0 + hb; ++hh) {
    stage<N>(ps, prev + (bc * h + hh) * (long long)(P * N), 0, P, N, 0);
    for (int j = threadIdx.x; j < q; j += blockDim.x)
      ss[j] = position_weight(kOutWeight, cums, nullptr, bc, j, q, h, hh);
    __syncthreads();
    for (int it = warp; it < q / 16; it += kInterWarps) {
      const int ra = 16 * it + gr;
      const float sa = ss[ra], sb = ss[ra + 8];
      float acc[P / 8][4];
#pragma unroll
      for (int j = 0; j < P / 8; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[j][k] = 0.f;
#pragma unroll
      for (int k0 = 0; k0 < N; k0 += 16) {
        // v's A fragments (m = position, k = n), rounded from C outw
        uint32_t a[4];
        ldsm_x4(a, cs + (16 * it + lr + 8 * (lm & 1)) * LD + k0 +
                       8 * (lm >> 1));
        a[0] = scale_pair(a[0], sa, sa);
        a[1] = scale_pair(a[1], sb, sb);
        a[2] = scale_pair(a[2], sa, sa);
        a[3] = scale_pair(a[3], sb, sb);
#pragma unroll
        for (int n2 = 0; n2 < P / 16; ++n2) {
          // prev^T's B fragments (k = n, n = p): prev's rows p
          uint32_t b[4];
          ldsm_x4(b, ps + (16 * n2 + lr + 8 * (lm >> 1)) * LD + k0 +
                         8 * (lm & 1));
          mma_bf16(acc[2 * n2], a, b[0], b[1]);
          mma_bf16(acc[2 * n2 + 1], a, b[2], b[3]);
        }
      }
      __nv_bfloat16* ya = y + ((bc * q + ra) * h + hh) * (long long)P + 2 * t;
      __nv_bfloat16* yb =
          y + ((bc * q + ra + 8) * h + hh) * (long long)P + 2 * t;
#pragma unroll
      for (int j = 0; j < P / 8; ++j) {
        *reinterpret_cast<uint32_t*>(ya + 8 * j) = pack_bf16(acc[j][0],
                                                             acc[j][1]);
        *reinterpret_cast<uint32_t*>(yb + 8 * j) = pack_bf16(acc[j][2],
                                                             acc[j][3]);
      }
    }
    __syncthreads();
  }
}

// The reverse recurrence. dfinal (b, h, E) bf16 or null (a zero gradient);
// prev, dprev, dstates (chunks, h, E) bf16; ddecay (chunks, h) f32, each the
// bf16 value autograd's sum rounds to. Block and threads as scan_fwd_kernel's.
template <int E>
__global__ void __launch_bounds__(kInterThreads) scan_bwd_kernel(
    const __nv_bfloat16* __restrict__ dfinal,
    const __nv_bfloat16* __restrict__ prev,
    const __nv_bfloat16* __restrict__ dprev, const float* __restrict__ cums,
    __nv_bfloat16* __restrict__ dstates, float* __restrict__ ddecay, int nc,
    int q, int h) {
  constexpr int PAIRS = E / 2;
  constexpr int PER = (PAIRS + kInterThreads - 1) / kInterThreads;
  __shared__ float part[kInterWarps];
  const long long bi = blockIdx.x / h;
  const int hh = blockIdx.x % h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __nv_bfloat162 gs[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int idx = threadIdx.x + kInterThreads * k;
    gs[k] = dfinal != nullptr && idx < PAIRS
                ? reinterpret_cast<const __nv_bfloat162*>(dfinal)
                      [(bi * h + hh) * PAIRS + idx]
                : __floats2bfloat162_rn(0.f, 0.f);
  }
  for (int c = nc - 1; c >= 0; --c) {
    const long long bc = bi * nc + c;
    const long long base = (bc * h + hh) * PAIRS;
    const float d = bf16_round(expf(cums[(bc * q + q - 1) * h + hh]));
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int idx = threadIdx.x + kInterThreads * k;
      if (idx < PAIRS) {
        reinterpret_cast<__nv_bfloat162*>(dstates)[base + idx] = gs[k];
        const __nv_bfloat162 s =
            reinterpret_cast<const __nv_bfloat162*>(prev)[base + idx];
        sum += bf16_round(__low2float(gs[k]) * __low2float(s));
        sum += bf16_round(__high2float(gs[k]) * __high2float(s));
        if (c > 0)
          gs[k] = carry(gs[k], d,
                        reinterpret_cast<const __nv_bfloat162*>(dprev)
                            [base + idx]);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) part[warp] = sum;
    __syncthreads();
    if (threadIdx.x == 0) {
      float total = 0.f;
      for (int w = 0; w < kInterWarps; ++w) total += part[w];
      ddecay[bc * h + hh] = bf16_round(total);
    }
    __syncthreads();
  }
}

// One side of the backward's per-position terms, for chunk bc, group gi and
// the kDmRows positions from r0 (a block's tile); per head hh of the group,
// with D = bf16(X S_hh) (X's rows as chunk_state_kernel's, S (chunks, h, P,
// N)):
//   dM_q[n] = bf16(the heads' f32 sum of bf16(D_q[n] s_q))    (chunks, q, g, N)
//   ds_q    = bf16(sum_n bf16(D_q[n] M_q[n]))                 (chunks, q, h) f32
//   with DX: dx_q[p] = bf16(sum_n bf16(s_q M_q[n]) S_hh[p][n]) (chunks, q, h, P)
// For C: X = dy, S = prev, M = C, s = outw; for B: X = x, S = d chunk states,
// M = B, s = w, and dx. Warp (wr, wc): rows 16 wr.. of the block, and half of
// the n columns (of dx's p columns); with N (P) = 16 the wc = 1 warps idle.
template <int P, int N, bool DX>
__global__ void __launch_bounds__(kInterThreads, 2) inter_dm_kernel(
    const __nv_bfloat16* __restrict__ X, const __nv_bfloat16* __restrict__ S,
    const __nv_bfloat16* __restrict__ M, const float* __restrict__ cums,
    const float* __restrict__ dt, __nv_bfloat16* __restrict__ dM,
    float* __restrict__ ds, __nv_bfloat16* __restrict__ dx, long long ldx,
    long long ldm, int q, int h, int g, int kind) {
  constexpr int LDN = row_stride(N), LDX = row_stride(P);
  constexpr int NW = N >= 32 ? N / 2 : N;   // n columns a warp
  constexpr int PW = P >= 32 ? P / 2 : P;   // dx columns a warp
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ms = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* xs = ms + kDmRows * LDN;
  __nv_bfloat16* sts = xs + kDmRows * LDX;
  float* ss = reinterpret_cast<float*>(sts + P * LDN);
  float* rowsum = ss + kDmRows;                 // (2, kDmRows)

  const int tiles = (q + kDmRows - 1) / kDmRows;
  const long long bcg = blockIdx.x / tiles;
  const int r0 = kDmRows * (int)(blockIdx.x % tiles);
  const long long bc = bcg / g;
  const int gi = (int)(bcg % g), rep = h / g;
  const int rows = q - r0 < kDmRows ? q - r0 : kDmRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, t = lane & 3;
  const int lm = lane >> 3, lr = lane & 7;
  const int wr = warp & 3, wc = warp >> 2;
  const int ra = 16 * wr + gr;                  // this lane's rows ra, ra + 8
  const bool live = 16 * wr < rows;
  const bool n_live = live && (N >= 32 || wc == 0);
  const bool p_live = DX && live && (P >= 32 || wc == 0);

  float dm[NW / 8][4];
#pragma unroll
  for (int j = 0; j < NW / 8; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) dm[j][k] = 0.f;
  stage<N>(ms, M, bc * q + r0, rows, ldm, (long long)gi * N);
  for (int hh = gi * rep; hh < (gi + 1) * rep; ++hh) {
    stage<P>(xs, X, bc * q + r0, rows, ldx, (long long)hh * P);
    stage<N>(sts, S + (bc * h + hh) * (long long)(P * N), 0, P, N, 0);
    for (int j = threadIdx.x; j < rows; j += blockDim.x)
      ss[j] = position_weight(kind, cums, dt, bc, r0 + j, q, h, hh);
    __syncthreads();
    if (n_live) {
      const float sa = ss[ra], sb = ss[ra + 8];
      float acc[NW / 8][4];
#pragma unroll
      for (int j = 0; j < NW / 8; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[j][k] = 0.f;
#pragma unroll
      for (int k0 = 0; k0 < P; k0 += 16) {
        // X's A fragments (m = position, k = p)
        uint32_t a[4];
        ldsm_x4(a, xs + (16 * wr + lr + 8 * (lm & 1)) * LDX + k0 +
                       8 * (lm >> 1));
#pragma unroll
        for (int j2 = 0; j2 < NW / 16; ++j2) {
          // S's B fragments (k = p, n): S's rows p
          uint32_t b[4];
          ldsm_x4_trans(b, sts + (k0 + lr + 8 * (lm & 1)) * LDN + wc * NW +
                               16 * j2 + 8 * (lm >> 1));
          mma_bf16(acc[2 * j2], a, b[0], b[1]);
          mma_bf16(acc[2 * j2 + 1], a, b[2], b[3]);
        }
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NW / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = ra + 8 * (e >> 1);
          const int n = wc * NW + 8 * j + 2 * t + (e & 1);
          const float dv = bf16_round(acc[j][e]);
          dm[j][e] += bf16_round(dv * (e < 2 ? sa : sb));
          rs[e >> 1] += bf16_round(dv * __bfloat162float(ms[r * LDN + n]));
        }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        rs[k] += __shfl_xor_sync(0xffffffffu, rs[k], 1);
        rs[k] += __shfl_xor_sync(0xffffffffu, rs[k], 2);
      }
      if (t == 0) {
        rowsum[wc * kDmRows + ra] = rs[0];
        rowsum[wc * kDmRows + ra + 8] = rs[1];
      }
    }
    if (p_live) {
      const float sa = ss[ra], sb = ss[ra + 8];
      float acc[PW / 8][4];
#pragma unroll
      for (int j = 0; j < PW / 8; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[j][k] = 0.f;
#pragma unroll
      for (int k0 = 0; k0 < N; k0 += 16) {
        // u's A fragments (m = position, k = n), rounded from M s
        uint32_t a[4];
        ldsm_x4(a, ms + (16 * wr + lr + 8 * (lm & 1)) * LDN + k0 +
                       8 * (lm >> 1));
        a[0] = scale_pair(a[0], sa, sa);
        a[1] = scale_pair(a[1], sb, sb);
        a[2] = scale_pair(a[2], sa, sa);
        a[3] = scale_pair(a[3], sb, sb);
#pragma unroll
        for (int n2 = 0; n2 < PW / 16; ++n2) {
          // S^T's B fragments (k = n, n = p): S's rows p
          uint32_t b[4];
          ldsm_x4(b, sts + (wc * PW + 16 * n2 + lr + 8 * (lm >> 1)) * LDN +
                          k0 + 8 * (lm & 1));
          mma_bf16(acc[2 * n2], a, b[0], b[1]);
          mma_bf16(acc[2 * n2 + 1], a, b[2], b[3]);
        }
      }
      __nv_bfloat16* xa = dx + ((bc * q + r0 + ra) * h + hh) * (long long)P +
                          wc * PW + 2 * t;
      __nv_bfloat16* xb =
          dx + ((bc * q + r0 + ra + 8) * h + hh) * (long long)P + wc * PW +
          2 * t;
#pragma unroll
      for (int j = 0; j < PW / 8; ++j) {
        *reinterpret_cast<uint32_t*>(xa + 8 * j) = pack_bf16(acc[j][0],
                                                             acc[j][1]);
        *reinterpret_cast<uint32_t*>(xb + 8 * j) = pack_bf16(acc[j][2],
                                                             acc[j][3]);
      }
    }
    __syncthreads();
    for (int j = threadIdx.x; j < rows; j += blockDim.x) {
      float v = rowsum[j];
      if (N >= 32) v += rowsum[kDmRows + j];
      ds[(bc * q + r0 + j) * h + hh] = bf16_round(v);
    }
  }
  if (n_live) {
    __nv_bfloat16* da =
        dM + ((bc * q + r0 + ra) * g + gi) * (long long)N + wc * NW + 2 * t;
    __nv_bfloat16* db =
        dM + ((bc * q + r0 + ra + 8) * g + gi) * (long long)N + wc * NW +
        2 * t;
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      *reinterpret_cast<uint32_t*>(da + 8 * j) = pack_bf16(dm[j][0], dm[j][1]);
      *reinterpret_cast<uint32_t*>(db + 8 * j) = pack_bf16(dm[j][2], dm[j][3]);
    }
  }
}

// dcums and ddt (chunks, q, h) f32 of the inter-chunk term from dw (the
// chunk-state weights' gradient), dout (outw's) and ddecay (chunks, h), as
// autograd takes them through the casts and exps: with e = exp(cl - cums_q)
// and t_q = (dw_q dt_q) e, ddt_q = dw_q e and dcums_q = dout_q exp(cums_q) -
// t_q, the last position adding sum_q t_q + ddecay exp(cl). Block: chunk
// blockIdx.x, kScalarHeads heads from kScalarHeads * blockIdx.y; a warp
// takes one position of its 32 heads (one 128-byte row), the block's
// kInterWarps warps every kInterWarps-th position, and their sums of t meet
// in shared memory.
constexpr int kScalarHeads = 32;

__global__ void __launch_bounds__(kInterThreads) scalar_bwd_kernel(
    const float* __restrict__ cums, const float* __restrict__ dt,
    const float* __restrict__ dw, const float* __restrict__ dout,
    const float* __restrict__ ddecay, float* __restrict__ dcums,
    float* __restrict__ ddt, int q, int h) {
  __shared__ float part[kInterWarps][kScalarHeads];
  const long long bc = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int hh = kScalarHeads * blockIdx.y + lane;
  const bool on = hh < h;
  const float cl = on ? cums[(bc * q + q - 1) * h + hh] : 0.f;
  float tsum = 0.f;
  for (int j = warp; on && j < q; j += kInterWarps) {
    const long long i = (bc * q + j) * h + hh;
    const float cq = cums[i];
    const float e = expf(cl - cq);
    const float tj = (dw[i] * dt[i]) * e;
    tsum += tj;
    ddt[i] = dw[i] * e;
    if (j != q - 1) dcums[i] = dout[i] * expf(cq) - tj;
  }
  part[warp][lane] = tsum;
  __syncthreads();
  if (warp == 0 && on) {
    float total = 0.f;
    for (int w = 0; w < kInterWarps; ++w) total += part[w][lane];
    const long long i = (bc * q + q - 1) * h + hh;
    const float tl = dw[i] * dt[i];   // e = 1 at the last position
    dcums[i] = dout[i] * expf(cl) - tl + (total + ddecay[bc * h + hh] *
                                                      expf(cl));
  }
}

using StateKernel = void (*)(const __nv_bfloat16*, const __nv_bfloat16*,
                             const float*, const float*, __nv_bfloat16*,
                             long long, long long, int, int, int, int, int);
using ScanFwdKernel = void (*)(const __nv_bfloat16*, const float*,
                               __nv_bfloat16*, __nv_bfloat16*, int, int, int);
using OutKernel = void (*)(const __nv_bfloat16*, const __nv_bfloat16*,
                           const float*, __nv_bfloat16*, long long, int, int,
                           int, int);
using ScanBwdKernel = void (*)(const __nv_bfloat16*, const __nv_bfloat16*,
                               const __nv_bfloat16*, const float*,
                               __nv_bfloat16*, float*, int, int, int);
using DmKernel = void (*)(const __nv_bfloat16*, const __nv_bfloat16*,
                          const __nv_bfloat16*, const float*, const float*,
                          __nv_bfloat16*, float*, __nv_bfloat16*, long long,
                          long long, int, int, int, int);

// The instantiations: head dims p of 16, 32, 64 and d_states n of 16 and 128,
// those the card tests hold against the plain term (null for any other).
#define SSD_INTER_CASES(X) \
  X(16, 16) X(16, 128) X(32, 16) X(32, 128) X(64, 16) X(64, 128)

StateKernel state_kernel(int p, int n) {
#define CASE(P, N) \
  if (p == P && n == N) return chunk_state_kernel<P, N>;
  SSD_INTER_CASES(CASE)
#undef CASE
  return nullptr;
}

ScanFwdKernel scan_fwd(int p, int n) {
#define CASE(P, N) \
  if (p == P && n == N) return scan_fwd_kernel<P * N>;
  SSD_INTER_CASES(CASE)
#undef CASE
  return nullptr;
}

OutKernel out_kernel(int p, int n) {
#define CASE(P, N) \
  if (p == P && n == N) return inter_out_kernel<P, N>;
  SSD_INTER_CASES(CASE)
#undef CASE
  return nullptr;
}

ScanBwdKernel scan_bwd(int p, int n) {
#define CASE(P, N) \
  if (p == P && n == N) return scan_bwd_kernel<P * N>;
  SSD_INTER_CASES(CASE)
#undef CASE
  return nullptr;
}

DmKernel dm_kernel(int p, int n, bool with_dx) {
#define CASE(P, N)                                                   \
  if (p == P && n == N)                                              \
    return with_dx ? &inter_dm_kernel<P, N, true>                   \
                   : &inter_dm_kernel<P, N, false>;
  SSD_INTER_CASES(CASE)
#undef CASE
  return nullptr;
}

// Chunks of q = 16..256 positions (a multiple of 16), head dims p of 16, 32
// or 64, d_states n of 16 or 128, h heads in g groups, hb heads a block
// dividing h / g.
bool inter_dims_ok(int q, int h, int p, int g, int n, int hb) {
  return q >= 16 && q <= kInterMaxChunk && q % 16 == 0 &&
         (p == 16 || p == 32 || p == 64) && (n == 16 || n == 128) && g >= 1 &&
         h >= g && h % g == 0 && hb >= 1 && (h / g) % hb == 0;
}

// A row pointer and row stride the 16-byte loads take: both multiples of 16
// bytes, the stride at least the row's `width` values.
bool rows_ok(const void* ptr, long long ld, long long width) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && ld % 8 == 0 &&
         ld >= width;
}

}  // namespace
}  // namespace repro

// The forward. x: the chunked activations, rows of h * p bf16 values (one a
// position, batch * nc * q of them) ldx apart; B, C: rows of g * n bf16 ldb,
// ldc apart; cums, dt (batch * nc, q, h) f32. Writes states (batch * nc, h,
// p, n) bf16, the chunk states; prev (the same shape), the state before each
// chunk; final_state (batch, h, p, n) and y (batch * nc, q, h, p), the
// term. hb heads a block. Launches the three kernels on `stream` after making
// `device` current; returns the first CUDA error (0 on success).
extern "C" int ssd_inter_fwd(const void* x, const void* B, const void* C,
                             const float* cums, const float* dt, void* states,
                             void* prev, void* final_state, void* y,
                             long long ldx, long long ldb, long long ldc,
                             int batch, int nc, int q, int h, int p, int g,
                             int n, int hb, int device, void* stream) {
  if (cudaError_t err = cudaSetDevice(device)) return err;
  using namespace repro;
  const long long chunks = (long long)batch * nc;
  if (!inter_dims_ok(q, h, p, g, n, hb) || batch < 0 || nc < 1 ||
      chunks * (h / hb) > 0x7fffffffLL || !rows_ok(x, ldx, (long long)h * p) ||
      !rows_ok(B, ldb, (long long)g * n) || !rows_ok(C, ldc, (long long)g * n))
    return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
  auto st = static_cast<cudaStream_t>(stream);
  auto bf = [](const void* v) { return static_cast<const __nv_bfloat16*>(v); };
  auto bfw = [](void* v) { return static_cast<__nv_bfloat16*>(v); };

  const StateKernel sk = state_kernel(p, n);
  const size_t s_smem = state_smem(q, p, n);
  if (cudaError_t err = allow_smem(reinterpret_cast<const void*>(sk), s_smem))
    return err;
  sk<<<(unsigned)(chunks * (h / hb)), kInterThreads, s_smem, st>>>(
      bf(x), bf(B), cums, dt, bfw(states), ldx, ldb, q, h, g, hb,
      kStateWeight);
  if (cudaError_t err = cudaGetLastError()) return err;
  const ScanFwdKernel sf = scan_fwd(p, n);
  sf<<<(unsigned)(batch * h), kInterThreads, 0, st>>>(
      bf(states), cums, bfw(prev), bfw(final_state), nc, q, h);
  if (cudaError_t err = cudaGetLastError()) return err;
  const OutKernel ok = out_kernel(p, n);
  const size_t o_smem = out_smem(q, p, n);
  if (cudaError_t err = allow_smem(reinterpret_cast<const void*>(ok), o_smem))
    return err;
  ok<<<(unsigned)(chunks * (h / hb)), kInterThreads, o_smem, st>>>(
      bf(C), bf(prev), cums, bfw(y), ldc, q, h, g, hb);
  return cudaGetLastError();
}

// The backward of ssd_inter_fwd: dy as y (contiguous), dfinal as
// final_state or null (a zero gradient); x, B, C, cums, dt and prev as there.
// Scratch: dprev and dstates as prev (bf16), dw and dout (batch * nc, q, h)
// f32, ddecay (batch * nc, h) f32. Writes dx as y, dB and dC (batch * nc, q,
// g, n) bf16, dcums and ddt as cums. Launches five kernels on `stream`;
// returns the first CUDA error (0 on success).
extern "C" int ssd_inter_bwd(
    const void* dy, const void* dfinal, const void* x, const void* B,
    const void* C, const float* cums, const float* dt, const void* prev,
    void* dprev, void* dstates, float* dw, float* dout, float* ddecay,
    void* dx, void* dB, void* dC, float* dcums, float* ddt, long long ldx,
    long long ldb, long long ldc, int batch, int nc, int q, int h, int p,
    int g, int n, int hb, int device, void* stream) {
  if (cudaError_t err = cudaSetDevice(device)) return err;
  using namespace repro;
  const long long chunks = (long long)batch * nc;
  const long long ldy = (long long)h * p;
  const int tiles = (q + kDmRows - 1) / kDmRows;
  if (!inter_dims_ok(q, h, p, g, n, hb) || batch < 0 || nc < 1 ||
      chunks * (h / hb) > 0x7fffffffLL || chunks * g * tiles > 0x7fffffffLL ||
      !rows_ok(dy, ldy, ldy) || !rows_ok(x, ldx, ldy) ||
      !rows_ok(B, ldb, (long long)g * n) ||
      !rows_ok(C, ldc, (long long)g * n) ||
      reinterpret_cast<uintptr_t>(dfinal) % 4 != 0)
    return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
  auto st = static_cast<cudaStream_t>(stream);
  auto bf = [](const void* v) { return static_cast<const __nv_bfloat16*>(v); };
  auto bfw = [](void* v) { return static_cast<__nv_bfloat16*>(v); };

  const StateKernel sk = state_kernel(p, n);
  const size_t s_smem = state_smem(q, p, n);
  if (cudaError_t err = allow_smem(reinterpret_cast<const void*>(sk), s_smem))
    return err;
  sk<<<(unsigned)(chunks * (h / hb)), kInterThreads, s_smem, st>>>(
      bf(dy), bf(C), cums, dt, bfw(dprev), ldy, ldc, q, h, g, hb, kOutWeight);
  if (cudaError_t err = cudaGetLastError()) return err;
  const ScanBwdKernel sb = scan_bwd(p, n);
  sb<<<(unsigned)(batch * h), kInterThreads, 0, st>>>(
      bf(dfinal), bf(prev), bf(dprev), cums, bfw(dstates), ddecay, nc, q, h);
  if (cudaError_t err = cudaGetLastError()) return err;
  const size_t d_smem = dm_smem(p, n);
  const unsigned dm_blocks = (unsigned)(chunks * g * tiles);
  const DmKernel dmc = dm_kernel(p, n, false), dmb = dm_kernel(p, n, true);
  if (cudaError_t err = allow_smem(reinterpret_cast<const void*>(dmc), d_smem))
    return err;
  if (cudaError_t err = allow_smem(reinterpret_cast<const void*>(dmb), d_smem))
    return err;
  dmc<<<dm_blocks, kInterThreads, d_smem, st>>>(
      bf(dy), bf(prev), bf(C), cums, dt, bfw(dC), dout, nullptr, ldy, ldc, q,
      h, g, kOutWeight);
  if (cudaError_t err = cudaGetLastError()) return err;
  dmb<<<dm_blocks, kInterThreads, d_smem, st>>>(
      bf(x), bf(dstates), bf(B), cums, dt, bfw(dB), dw, bfw(dx), ldx, ldb, q,
      h, g, kStateWeight);
  if (cudaError_t err = cudaGetLastError()) return err;
  const dim3 scalar_grid((unsigned)chunks,
                         (unsigned)((h + kScalarHeads - 1) / kScalarHeads));
  scalar_bwd_kernel<<<scalar_grid, kInterThreads, 0, st>>>(
      cums, dt, dw, dout, ddecay, dcums, ddt, q, h);
  return cudaGetLastError();
}

// The resources of one kernel of ssd_inter_fwd (stage 0 chunk_state, 1
// scan_fwd, 2 inter_out) or ssd_inter_bwd (0 chunk_state, 1 scan_bwd, 2
// inter_dm for C, 3 inter_dm for B with dx, 4 scalar_bwd) at chunk q, head
// dim p and d_state n, at its shared memory (info.cuh); returns the CUDA
// error (0 on success).
extern "C" int ssd_inter_fwd_info(int q, int p, int n, int stage, int device,
                                  int* out) {
  using namespace repro;
  if (!inter_dims_ok(q, 1, p, 1, n, 1)) return cudaErrorInvalidValue;
  switch (stage) {
    case 0:
      return kernel_info(reinterpret_cast<const void*>(state_kernel(p, n)),
                         kInterThreads, state_smem(q, p, n),
                         (int)state_smem(q, p, n), device, out);
    case 1:
      return kernel_info(reinterpret_cast<const void*>(scan_fwd(p, n)),
                         kInterThreads, 0, 0, device, out);
    case 2:
      return kernel_info(reinterpret_cast<const void*>(out_kernel(p, n)),
                         kInterThreads, out_smem(q, p, n),
                         (int)out_smem(q, p, n), device, out);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int ssd_inter_bwd_info(int q, int p, int n, int stage, int device,
                                  int* out) {
  using namespace repro;
  if (!inter_dims_ok(q, 1, p, 1, n, 1)) return cudaErrorInvalidValue;
  switch (stage) {
    case 0:
      return kernel_info(reinterpret_cast<const void*>(state_kernel(p, n)),
                         kInterThreads, state_smem(q, p, n),
                         (int)state_smem(q, p, n), device, out);
    case 1:
      return kernel_info(reinterpret_cast<const void*>(scan_bwd(p, n)),
                         kInterThreads, 0, 0, device, out);
    case 2:
    case 3:
      return kernel_info(
          reinterpret_cast<const void*>(dm_kernel(p, n, stage == 3)),
          kInterThreads, dm_smem(p, n), (int)dm_smem(p, n), device, out);
    case 4:
      return kernel_info(reinterpret_cast<const void*>(scalar_bwd_kernel),
                         kInterThreads, 0, 0, device, out);
    default:
      return cudaErrorInvalidValue;
  }
}
