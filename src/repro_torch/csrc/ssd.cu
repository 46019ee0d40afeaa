// Mamba-2's intra-chunk SSD term for Hopper, forward and backward.
//
// Replaces no TPU kernel: the JAX package's models/ssm.py:ssd_chunked takes
// this term in XLA. In the port's ssd_chunked it was plain PyTorch over
// (b, nc, q, q, h) f32 tensors (the segment sums, their mask, exp, the decay
// L, the products C.B L and their bf16 cast): at granite-4.0-h-small's shape
// (b 2, 8,192 tokens, q 256, h 128) each of them is 2.15 GB, written and read
// back several times in the forward, again in the recompute and again in
// autograd's backward of each op. The useful work is small: per (b, c, h) a
// lower-triangular (q, q) matrix times a (q, p) block. So the kernels keep
// the (q, q) matrices on chip and read only x, dy, C.B and the per-position
// scalars; what bounds them is those bytes (HBM), not the products.
//
// The term, for each batch row b, chunk c and head h (group gi = h / rep):
//   m[i][j] = bf16(f32(CB[i][j]) * (exp(cums_i - cums_j) * dt_j))  j <= i
//   m[i][j] = 0                                                      j > i
//   y[i] = sum_j m[i][j] x[j]       (f32 sum, stored in the activation dtype)
// m rounds exactly as the plain route's (CBh * L).to(bf16): the same f32
// operations in the same order (built without fast math). The exp of a
// segment above the diagonal is never taken: it can overflow once training
// grows dt, and the plain route masks it to -inf before its exp.
//
// Forward (ssd_intra_fwd): one block per (b, c, h), 8 warps. The block stages
// the head's x rows (q x p bf16) and its cums and dt in shared memory; each
// warp owns 16-row tiles of y (tiles t and 15 - t, so every warp does the
// same number of products), builds m's A fragments in registers from C.B
// (read from L2: one (q, q) matrix serves every head of a group) and takes
// the products with mma.sync m16n8k16 bf16, f32 accumulation, x's B
// fragments by ldmatrix.trans. Tiles above the diagonal are skipped.
//
// Backward (ssd_intra_bwd), with dM = dy x^T (f32, never stored):
//   dx[j]    = sum_{i >= j} m[i][j] dy[i]
//   dCB[i][j] = sum over the group's heads of dM[i][j] l[i][j]
//   dcums_i  = sum_j dM CB l [i][j]  -  sum_i' dM CB l [i'][i]
//   ddt_j    = sum_i dM CB e [i][j]       (e = exp(cums_i - cums_j), l = e dt_j)
// One block per (b, c, R heads of one group), 8 warps; each warp owns 16-
// column (j) tiles, paired as in the forward. Per head the block stages dy
// (q x p) and the scalars; per (j tile, i tile) a warp takes dM^T = x dy^T
// on the tensor cores, recomputes m, e and l in registers, turns m^T's
// accumulator layout into the next product's A fragments (as flash
// attention does with its probabilities) and accumulates dx = m^T dy. The
// column sums stay in the warp; the row sums go to a per-warp row of shared
// memory, summed over the warps in a fixed order. dCB over the R heads is
// summed in shared memory (each warp its own tiles, in a fixed order) and
// written once per block as an f32 partial; the wrapper adds the rep / R
// partials of a group. No float atomics: the result is the same every run.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "info.cuh"
#include "ssd.cuh"

namespace repro {
namespace {

constexpr int kSsdWarps = 8;
constexpr int kSsdThreads = 32 * kSsdWarps;
constexpr int kSsdMaxChunk = 256;    // 16 tiles of 16: two a warp at most

// The warp that owns 16-row (16-column) tile `tile` of a chunk: tiles t and
// 15 - t go to warp t, which then has the same number of tile products as
// any other warp when the chunk has 16 tiles.
__host__ __device__ inline int tile_owner(int tile) {
  return tile < kSsdWarps ? tile : 2 * kSsdWarps - 1 - tile;
}

// dCB tiles (one per (j tile, i tile >= j tile)) the busiest warp keeps.
__host__ __device__ inline int bwd_slots(int tiles) {
  int most = 0;
  for (int w = 0; w < kSsdWarps; ++w) {
    int n = 0;
    for (int jt = 0; jt < tiles; ++jt)
      if (tile_owner(jt) == w) n += tiles - jt;
    most = n > most ? n : most;
  }
  return most;
}

__host__ __device__ inline size_t fwd_smem(int q, int p) {
  return (size_t)q * row_stride(p) * 2 + 2 * (size_t)q * sizeof(float);
}

// dy rows, cums and dt, the warps' row sums, the column sums, dCB's tiles.
__host__ __device__ inline size_t bwd_smem(int q, int p) {
  return (size_t)q * row_stride(p) * 2 + 2 * (size_t)q * sizeof(float) +
         (size_t)kSsdWarps * q * sizeof(float) + (size_t)q * sizeof(float) +
         (size_t)kSsdWarps * bwd_slots(q / 16) * 256 * sizeof(float);
}

// The q rows of head hh of chunk bc from a (b, nc, q, h, P) tensor into a
// (q, row_stride(P)) block of shared memory, 16 bytes a load.
template <int P>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           long long bc, int hh, int q,
                                           int h) {
  constexpr int V = P / 8;
  for (int idx = threadIdx.x; idx < q * V; idx += blockDim.x) {
    const int j = idx / V, v = idx - j * V;
    *reinterpret_cast<uint4*>(dst + j * row_stride(P) + 8 * v) =
        *reinterpret_cast<const uint4*>(
            src + ((bc * q + j) * h + hh) * (long long)P + 8 * v);
  }
}

// cums and dt of head hh over chunk bc's q positions.
__device__ __forceinline__ void stage_scalars(float* cs, float* ds,
                                              const float* cums,
                                              const float* dt, long long bc,
                                              int hh, int q, int h) {
  for (int j = threadIdx.x; j < q; j += blockDim.x) {
    cs[j] = cums[(bc * q + j) * h + hh];
    ds[j] = dt[(bc * q + j) * h + hh];
  }
}

// m[i][j] and m[i][j+1] as a bf16 pair, cbrow = row i of C.B.
__device__ __forceinline__ uint32_t m_pair(const __nv_bfloat16* cbrow, int i,
                                           int j, float ci, const float* cs,
                                           const float* ds) {
  const __nv_bfloat162 c = *reinterpret_cast<const __nv_bfloat162*>(cbrow + j);
  const float m0 =
      j <= i ? __bfloat162float(c.x) * (expf(ci - cs[j]) * ds[j]) : 0.f;
  const float m1 = j + 1 <= i ? __bfloat162float(c.y) *
                                    (expf(ci - cs[j + 1]) * ds[j + 1])
                              : 0.f;
  return pack_bf16(m0, m1);
}

// x, y (b, nc, q, h, P) bf16; cb (b, nc, g, q, q) bf16; cums, dt (b, nc, q,
// h) f32. Block: chunk bc = blockIdx.x / h, head blockIdx.x % h. Three
// blocks share an SM (at most 85 registers: granite's layer takes 0.59 ms on
// an H100, against 0.75 at two). Some minimum must be given: without one
// ptxas spills the P = 32 instantiation.
template <int P>
__global__ void __launch_bounds__(kSsdThreads, 3)
ssd_intra_fwd_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ cb,
    const float* __restrict__ cums, const float* __restrict__ dt,
    __nv_bfloat16* __restrict__ y, int q, int h, int g) {
  constexpr int LD = row_stride(P);
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  float* cs = reinterpret_cast<float*>(xs + q * LD);
  float* ds = cs + q;

  const long long bc = blockIdx.x / h;
  const int hh = blockIdx.x % h;
  const __nv_bfloat16* cbm = cb + (bc * g + hh / (h / g)) * q * (long long)q;
  stage_rows<P>(xs, x, bc, hh, q, h);
  stage_scalars(cs, ds, cums, dt, bc, hh, q, h);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, t = lane & 3;
  const int lm = lane >> 3, lr = lane & 7;   // ldmatrix: matrix, row
  const int tiles = q / 16;
  for (int it = 0; it < tiles; ++it) {
    if (tile_owner(it) != warp) continue;
    const int ia = 16 * it + gr, ib = ia + 8;
    const float ca = cs[ia], cb_b = cs[ib];
    const __nv_bfloat16* rowa = cbm + (long long)ia * q;
    const __nv_bfloat16* rowb = cbm + (long long)ib * q;
    float acc[P / 8][4];
#pragma unroll
    for (int n = 0; n < P / 8; ++n)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[n][k] = 0.f;
    for (int jt = 0; jt <= it; ++jt) {
      const int j = 16 * jt + 2 * t;
      const uint32_t a[4] = {m_pair(rowa, ia, j, ca, cs, ds),
                             m_pair(rowb, ib, j, cb_b, cs, ds),
                             m_pair(rowa, ia, j + 8, ca, cs, ds),
                             m_pair(rowb, ib, j + 8, cb_b, cs, ds)};
      const __nv_bfloat16* xrow =
          xs + (16 * jt + lr + 8 * (lm & 1)) * LD + 8 * (lm >> 1);
#pragma unroll
      for (int n2 = 0; n2 < P / 16; ++n2) {
        uint32_t b[4];
        ldsm_x4_trans(b, xrow + 16 * n2);
        mma_bf16(acc[2 * n2], a, b[0], b[1]);
        mma_bf16(acc[2 * n2 + 1], a, b[2], b[3]);
      }
    }
    __nv_bfloat16* ya = y + ((bc * q + ia) * h + hh) * (long long)P + 2 * t;
    __nv_bfloat16* yb = y + ((bc * q + ib) * h + hh) * (long long)P + 2 * t;
#pragma unroll
    for (int n = 0; n < P / 8; ++n) {
      *reinterpret_cast<uint32_t*>(ya + 8 * n) = pack_bf16(acc[n][0],
                                                           acc[n][1]);
      *reinterpret_cast<uint32_t*>(yb + 8 * n) = pack_bf16(acc[n][2],
                                                           acc[n][3]);
    }
  }
}

// dy, x, dx (b, nc, q, h, P) bf16; cb (b, nc, g, q, q) bf16; cums, dt,
// dcums, ddt (b, nc, q, h) f32; dcb_part (b, nc, g, rep / R, q, q) f32.
// Block: chunk bc = blockIdx.x / (h / R), heads R * (blockIdx.x % (h / R))
// and the R - 1 after it, all of one group (R divides rep).
template <int P>
__global__ void __launch_bounds__(kSsdThreads, 1) ssd_intra_bwd_kernel(
    const __nv_bfloat16* __restrict__ dy, const __nv_bfloat16* __restrict__ x,
    const __nv_bfloat16* __restrict__ cb, const float* __restrict__ cums,
    const float* __restrict__ dt, __nv_bfloat16* __restrict__ dx,
    float* __restrict__ dcums, float* __restrict__ ddt,
    float* __restrict__ dcb_part, int q, int h, int g, int R) {
  constexpr int LD = row_stride(P);
  const int tiles = q / 16, slots = bwd_slots(tiles);
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* dys = reinterpret_cast<__nv_bfloat16*>(smem);
  float* cs = reinterpret_cast<float*>(dys + q * LD);
  float* ds = cs + q;
  float* rowpart = ds + q;                    // (kSsdWarps, q)
  float* colsum = rowpart + kSsdWarps * q;    // (q,)
  float* dcbs = colsum + q;                   // (kSsdWarps, slots, 2, 32, 4)

  const int groups = h / R;
  const long long bc = blockIdx.x / groups;
  const int h0 = R * (int)(blockIdx.x % groups);
  const int rep = h / g, gi = h0 / rep;
  const __nv_bfloat16* cbm = cb + (bc * g + gi) * q * (long long)q;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, t = lane & 3;
  const int lm = lane >> 3, lr = lane & 7;
  float* myslots = dcbs + warp * slots * 256;
  for (int k = threadIdx.x; k < kSsdWarps * slots * 256; k += blockDim.x)
    dcbs[k] = 0.f;

  for (int hh = h0; hh < h0 + R; ++hh) {
    stage_rows<P>(dys, dy, bc, hh, q, h);
    stage_scalars(cs, ds, cums, dt, bc, hh, q, h);
    for (int k = threadIdx.x; k < kSsdWarps * q; k += blockDim.x)
      rowpart[k] = 0.f;
    __syncthreads();
    int slot = 0;
    for (int jt = 0; jt < tiles; ++jt) {
      if (tile_owner(jt) != warp) continue;
      const int ja = 16 * jt + gr, jb = ja + 8;
      const __nv_bfloat16* xa =
          x + ((bc * q + ja) * h + hh) * (long long)P + 2 * t;
      const __nv_bfloat16* xb =
          x + ((bc * q + jb) * h + hh) * (long long)P + 2 * t;
      uint32_t xf[P / 16][4];    // A fragments of x's rows ja, jb
#pragma unroll
      for (int ks = 0; ks < P / 16; ++ks) {
        xf[ks][0] = ld_u32(xa + 16 * ks);
        xf[ks][1] = ld_u32(xb + 16 * ks);
        xf[ks][2] = ld_u32(xa + 16 * ks + 8);
        xf[ks][3] = ld_u32(xb + 16 * ks + 8);
      }
      const float cj[2] = {cs[ja], cs[jb]}, dj[2] = {ds[ja], ds[jb]};
      const int jj[2] = {ja, jb};
      float col[2] = {0.f, 0.f}, ddj[2] = {0.f, 0.f};
      float dxa[P / 8][4];
#pragma unroll
      for (int n = 0; n < P / 8; ++n)
#pragma unroll
        for (int k = 0; k < 4; ++k) dxa[n][k] = 0.f;

      for (int it = jt; it < tiles; ++it, ++slot) {
        const int i0 = 16 * it;
        // dM^T for rows j, columns i: entry [nt][2 s + k] is (jj[s],
        // i0 + 8 nt + 2 t + k)
        float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        const __nv_bfloat16* dyrow =
            dys + (i0 + lr + 8 * (lm >> 1)) * LD + 8 * (lm & 1);
#pragma unroll
        for (int ks = 0; ks < P / 16; ++ks) {
          uint32_t b[4];
          ldsm_x4(b, dyrow + 16 * ks);
          mma_bf16(s[0], xf[ks], b[0], b[1]);
          mma_bf16(s[1], xf[ks], b[2], b[3]);
        }
        // this lane's 8 entries of the tile's dCB sum, [4 nt + 2 s + k]
        float* sl = myslots + slot * 256 + lane * 4;
        const float4 lo = *reinterpret_cast<float4*>(sl);
        const float4 hi = *reinterpret_cast<float4*>(sl + 128);
        float acc8[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        float mt[2][4], rsum[2][2];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int i = i0 + 8 * nt + 2 * t + k;
            const float ci = cs[i];
            rsum[nt][k] = 0.f;
#pragma unroll
            for (int sj = 0; sj < 2; ++sj) {
              const int e4 = 2 * sj + k;
              mt[nt][e4] = 0.f;
              if (jj[sj] <= i) {
                const float cbf = __bfloat162float(cbm[(long long)i * q +
                                                       jj[sj]]);
                const float e = expf(ci - cj[sj]);
                const float l = e * dj[sj];
                const float dm = s[nt][e4];
                const float dmcb = dm * cbf;
                const float dsv = dmcb * l;
                mt[nt][e4] = cbf * l;
                rsum[nt][k] += dsv;
                col[sj] += dsv;
                ddj[sj] += dmcb * e;
                acc8[4 * nt + e4] += dm * l;
              }
            }
          }
        *reinterpret_cast<float4*>(sl) =
            make_float4(acc8[0], acc8[1], acc8[2], acc8[3]);
        *reinterpret_cast<float4*>(sl + 128) =
            make_float4(acc8[4], acc8[5], acc8[6], acc8[7]);

        // dx += m^T dy: m^T's accumulator layout is the A fragment
        const uint32_t a[4] = {pack_bf16(mt[0][0], mt[0][1]),
                               pack_bf16(mt[0][2], mt[0][3]),
                               pack_bf16(mt[1][0], mt[1][1]),
                               pack_bf16(mt[1][2], mt[1][3])};
        const __nv_bfloat16* dyt =
            dys + (i0 + lr + 8 * (lm & 1)) * LD + 8 * (lm >> 1);
#pragma unroll
        for (int n2 = 0; n2 < P / 16; ++n2) {
          uint32_t b[4];
          ldsm_x4_trans(b, dyt + 16 * n2);
          mma_bf16(dxa[2 * n2], a, b[0], b[1]);
          mma_bf16(dxa[2 * n2 + 1], a, b[2], b[3]);
        }

        // row sums over this tile's 16 j: over the lanes' g
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            float v = rsum[nt][k];
            v += __shfl_xor_sync(0xffffffffu, v, 4);
            v += __shfl_xor_sync(0xffffffffu, v, 8);
            v += __shfl_xor_sync(0xffffffffu, v, 16);
            if (gr == 0) rowpart[warp * q + i0 + 8 * nt + 2 * t + k] += v;
          }
      }

      // column sums over every i: over the lanes' t
#pragma unroll
      for (int sj = 0; sj < 2; ++sj) {
        float c = col[sj], d = ddj[sj];
        c += __shfl_xor_sync(0xffffffffu, c, 1);
        c += __shfl_xor_sync(0xffffffffu, c, 2);
        d += __shfl_xor_sync(0xffffffffu, d, 1);
        d += __shfl_xor_sync(0xffffffffu, d, 2);
        if (t == 0) {
          colsum[jj[sj]] = c;
          ddt[(bc * q + jj[sj]) * h + hh] = d;
        }
      }
      __nv_bfloat16* dxr_a =
          dx + ((bc * q + ja) * h + hh) * (long long)P + 2 * t;
      __nv_bfloat16* dxr_b =
          dx + ((bc * q + jb) * h + hh) * (long long)P + 2 * t;
#pragma unroll
      for (int n = 0; n < P / 8; ++n) {
        *reinterpret_cast<uint32_t*>(dxr_a + 8 * n) =
            pack_bf16(dxa[n][0], dxa[n][1]);
        *reinterpret_cast<uint32_t*>(dxr_b + 8 * n) =
            pack_bf16(dxa[n][2], dxa[n][3]);
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < q; i += blockDim.x) {
      float r = 0.f;
      for (int w = 0; w < kSsdWarps; ++w) r += rowpart[w * q + i];
      dcums[(bc * q + i) * h + hh] = r - colsum[i];
    }
    __syncthreads();
  }

  // this block's dCB partial: each warp's tiles, zeros above the diagonal
  float* part = dcb_part + ((bc * g + gi) * (rep / R) + (h0 % rep) / R) *
                               q * (long long)q;
  int slot = 0;
  for (int jt = 0; jt < tiles; ++jt) {
    if (tile_owner(jt) != warp) continue;
    for (int it = 0; it < tiles; ++it) {
      const float* sl = myslots + slot * 256 + lane * 4;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e4 = 0; e4 < 4; ++e4) {
          const int i = 16 * it + 8 * nt + 2 * t + (e4 & 1);
          const int j = 16 * jt + gr + 8 * (e4 >> 1);
          part[(long long)i * q + j] =
              it < jt ? 0.f : sl[128 * nt + e4];
        }
      if (it >= jt) ++slot;
    }
  }
}

using FwdKernel = void (*)(const __nv_bfloat16*, const __nv_bfloat16*,
                           const float*, const float*, __nv_bfloat16*, int,
                           int, int);
using BwdKernel = void (*)(const __nv_bfloat16*, const __nv_bfloat16*,
                           const __nv_bfloat16*, const float*, const float*,
                           __nv_bfloat16*, float*, float*, float*, int, int,
                           int, int);

// The instantiations for head dim p: 16, 32 or 64, the head dims the card
// tests hold against the plain term (null for any other p).
FwdKernel fwd_kernel(int p) {
  switch (p) {
    case 16: return ssd_intra_fwd_kernel<16>;
    case 32: return ssd_intra_fwd_kernel<32>;
    case 64: return ssd_intra_fwd_kernel<64>;
    default: return nullptr;
  }
}

BwdKernel bwd_kernel(int p) {
  switch (p) {
    case 16: return ssd_intra_bwd_kernel<16>;
    case 32: return ssd_intra_bwd_kernel<32>;
    case 64: return ssd_intra_bwd_kernel<64>;
    default: return nullptr;
  }
}

// Chunks of q = 16..256 positions (a multiple of 16), head dims p of 16, 32
// or 64, h heads in g groups.
bool dims_ok(int q, int h, int p, int g) {
  return q >= 16 && q <= kSsdMaxChunk && q % 16 == 0 &&
         (p == 16 || p == 32 || p == 64) && g >= 1 && h >= g && h % g == 0;
}

}  // namespace
}  // namespace repro

// x (chunks = b * nc, q, h, p) bf16, the chunked activations; cb (chunks,
// g, q, q) bf16, C.B of each chunk and group; cums, dt (chunks, q, h) f32,
// the within-chunk cumsum of dt A and dt; y (chunks, q, h, p) bf16, the
// intra-chunk term. All contiguous, x 16-byte aligned, cb 4-byte aligned.
// Launches on `stream` after making `device` current; returns the CUDA error
// of the launch (0 on success).
extern "C" int ssd_intra_fwd(const void* x, const void* cb, const float* cums,
                             const float* dt, void* y, long long chunks,
                             int q, int h, int p, int g, int device,
                             void* stream) {
  if (cudaError_t err = cudaSetDevice(device)) return err;
  using namespace repro;
  if (!dims_ok(q, h, p, g) || chunks < 0 || chunks * h > 0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(cb) % 4 != 0)
    return cudaErrorInvalidValue;
  if (chunks == 0) return cudaSuccess;
  const FwdKernel kernel = fwd_kernel(p);
  const size_t smem = fwd_smem(q, p);
  if (cudaError_t err = allow_smem(reinterpret_cast<const void*>(kernel),
                                   smem))
    return err;
  kernel<<<(unsigned)(chunks * h), kSsdThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(cb), cums, dt,
      static_cast<__nv_bfloat16*>(y), q, h, g);
  return cudaGetLastError();
}

// The backward of ssd_intra_fwd: dy as y, x, cb, cums, dt as there; writes
// dx (as x), dcums and ddt (as cums), and dcb_part (chunks, g, rep / R, q,
// q) f32, the sums of dCB over each R consecutive heads of a group (R
// divides rep = h / g), zero above the diagonal. dy 16-byte aligned, x
// 4-byte aligned.
// Launches on `stream` after making `device` current; returns the CUDA error
// of the launch (0 on success).
extern "C" int ssd_intra_bwd(const void* dy, const void* x, const void* cb,
                             const float* cums, const float* dt, void* dx,
                             float* dcums, float* ddt, float* dcb_part,
                             long long chunks, int q, int h, int p, int g,
                             int R, int device, void* stream) {
  if (cudaError_t err = cudaSetDevice(device)) return err;
  using namespace repro;
  if (!dims_ok(q, h, p, g) || R < 1 || (h / g) % R != 0 || chunks < 0 ||
      chunks * (h / R) > 0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(dy) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(cb) % 4 != 0)
    return cudaErrorInvalidValue;
  if (chunks == 0) return cudaSuccess;
  const BwdKernel kernel = bwd_kernel(p);
  const size_t smem = bwd_smem(q, p);
  if (cudaError_t err = allow_smem(reinterpret_cast<const void*>(kernel),
                                   smem))
    return err;
  kernel<<<(unsigned)(chunks * (h / R)), kSsdThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(dy),
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(cb), cums, dt,
      static_cast<__nv_bfloat16*>(dx), dcums, ddt, dcb_part, q, h, g, R);
  return cudaGetLastError();
}

// The resources of the ssd_intra_fwd / ssd_intra_bwd instantiation a launch
// at chunk q and head dim p takes, at its shared memory (info.cuh); returns
// the CUDA error (0 on success).
extern "C" int ssd_intra_fwd_info(int q, int p, int device, int* out) {
  using namespace repro;
  if (!dims_ok(q, 1, p, 1)) return cudaErrorInvalidValue;
  return kernel_info(reinterpret_cast<const void*>(fwd_kernel(p)),
                     kSsdThreads, fwd_smem(q, p), (int)fwd_smem(q, p), device,
                     out);
}

extern "C" int ssd_intra_bwd_info(int q, int p, int device, int* out) {
  using namespace repro;
  if (!dims_ok(q, 1, p, 1)) return cudaErrorInvalidValue;
  return kernel_info(reinterpret_cast<const void*>(bwd_kernel(p)),
                     kSsdThreads, bwd_smem(q, p), (int)bwd_smem(q, p), device,
                     out);
}
