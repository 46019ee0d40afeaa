// Emission-absorption compositing for Hopper.
//
// Replaces the JAX package's kernels/ray_march/ray_march.py:
// composite_pallas (body _composite_kernel). Per ray of S samples:
//   log1m = -sigma dt;  alpha = 1 - exp(log1m);
//   T = exp(cumsum(log1m) - log1m)  (the exclusive transmittance);
//   w = T alpha;  pixel = sum w rgb;  opacity = sum w
// which is the JAX kernel's formulation term for term.
//
// What bounds it on the card: 16 bytes read per sample (rgb and sigma) and
// 16 written per ray, against a few flops, so bytes bound it; at the served
// tile (4096 rays x 32 samples, 2.16 MB) that bound (0.65 us) is below the
// cost of a launch, so the launch and the latency of one pass of loads set
// its time, and the design spends as little of that latency as it can. A
// thread per ray would walk S dependent steps, with neighbouring lanes 512
// bytes apart (each load touching 32 sectors for 4 useful bytes each), on
// 32 blocks of 128 rays: 100 of the 132 SMs idle.
//
// So the lanes run over samples. A segment of W lanes (W the next power of
// two of S, at most 32; 32 / W rays share a warp when S < 32) takes one
// ray, and kCompositeWarps warps make a block: the served tile launches 512
// blocks. Each lane reads its sample: where rgb and sigma are the field's
// packed (R, S, 4) output (sigma 3 floats after rgb, sample stride 4,
// 16-byte aligned; the wrapper checks and passes `packed`) with one 16-byte
// load, so a warp reads 512 contiguous bytes; otherwise through the given
// strides, coalesced when samples are contiguous. A (1, S) dts broadcast
// comes in with ray stride 0. The transmittance is an inclusive scan of
// log1m over the segment (__shfl_up_sync, log2 W steps) plus the carried
// total of the earlier W-sample chunks; the exclusive term is
// exp(incl - log1m), as in the JAX kernel. pixel and opacity are summed
// over the segment with __shfl_xor_sync, and the segment's first lane
// writes them. The sums are taken as a tree, not in sample order, so the
// result differs from the plain version's in the last bits (atol 1e-4 +
// rtol 1e-4 is the stated tolerance).
#include <cstdint>
#include <cuda_runtime.h>

#include "info.cuh"

namespace repro {

constexpr int kCompositeWarps = 8;          // warps per block

template <bool kPacked>
__global__ void __launch_bounds__(32 * kCompositeWarps) composite_fwd_kernel(
    const float* __restrict__ rgb, long long rgb_ray, long long rgb_sample,
    const float* __restrict__ sigma, long long sig_ray, long long sig_sample,
    const float* __restrict__ dts, long long dt_ray, long long dt_sample,
    float* __restrict__ pixel, float* __restrict__ opacity, long long n_rays,
    int n_samples, int width) {
  const int lane = threadIdx.x & 31;
  const int sub = lane & (width - 1);          // the lane's place in its ray
  const long long warp = (long long)blockIdx.x * kCompositeWarps +
                         threadIdx.x / 32;
  const long long r = warp * (32 / width) + lane / width;
  // lanes past the last ray or sample take part in the shuffles with zero
  // samples
  const bool ray_ok = r < n_rays;
  float carry = 0.f, acc_r = 0.f, acc_g = 0.f, acc_b = 0.f, acc_w = 0.f;
  for (int s0 = 0; s0 < n_samples; s0 += width) {
    const int s = s0 + sub;
    float cr = 0.f, cg = 0.f, cb = 0.f, log1m = 0.f;
    if (ray_ok && s < n_samples) {
      float sg;
      if constexpr (kPacked) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(
            rgb + r * rgb_ray + 4ll * s));
        cr = v.x; cg = v.y; cb = v.z; sg = v.w;
      } else {
        const float* c = rgb + r * rgb_ray + s * rgb_sample;
        cr = __ldg(c); cg = __ldg(c + 1); cb = __ldg(c + 2);
        sg = __ldg(sigma + r * sig_ray + s * sig_sample);
      }
      log1m = -sg * __ldg(dts + r * dt_ray + s * dt_sample);
    }
    // inclusive scan of log1m over the segment
    float incl = log1m;
    for (int d = 1; d < width; d <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, incl, d, width);
      if (sub >= d) incl += t;
    }
    const float csum = carry + incl;
    const float alpha = 1.f - expf(log1m);
    const float w = expf(csum - log1m) * alpha;
    acc_r = fmaf(w, cr, acc_r);
    acc_g = fmaf(w, cg, acc_g);
    acc_b = fmaf(w, cb, acc_b);
    acc_w += w;
    carry = __shfl_sync(0xffffffffu, csum, width - 1, width);
  }
  for (int m = width >> 1; m > 0; m >>= 1) {
    acc_r += __shfl_xor_sync(0xffffffffu, acc_r, m, width);
    acc_g += __shfl_xor_sync(0xffffffffu, acc_g, m, width);
    acc_b += __shfl_xor_sync(0xffffffffu, acc_b, m, width);
    acc_w += __shfl_xor_sync(0xffffffffu, acc_w, m, width);
  }
  if (ray_ok && sub == 0) {
    pixel[3 * r] = acc_r;
    pixel[3 * r + 1] = acc_g;
    pixel[3 * r + 2] = acc_b;
    opacity[r] = acc_w;
  }
}

}  // namespace repro

// rgb: channel stride 1, (ray, sample) strides in floats; sigma and dts:
// (ray, sample) strides in floats (a ray stride of 0 broadcasts a row).
// pixel (R, 3) and opacity (R,) f32, contiguous. lanes_per_ray: a power of
// two from 1 to 32 (kernels/ray_march/ray_march.py composite_plan). packed:
// rgb and sigma are the columns of one (R, S, 4) array, 16-byte aligned,
// which is checked here again. Launches on `stream` after making `device`
// current; returns the CUDA error of the launch (0 on success).
extern "C" int composite_fwd(const float* rgb, long long rgb_ray,
                             long long rgb_sample, const float* sigma,
                             long long sig_ray, long long sig_sample,
                             const float* dts, long long dt_ray,
                             long long dt_sample, float* pixel, float* opacity,
                             long long n_rays, int n_samples,
                             int lanes_per_ray, int packed, int device,
                             void* stream) {
  if (cudaError_t err = cudaSetDevice(device)) return err;
  using namespace repro;
  const int w = lanes_per_ray;
  if (w < 1 || w > 32 || (w & (w - 1)) != 0)
    return cudaErrorInvalidValue;
  if (packed &&
      (reinterpret_cast<uintptr_t>(rgb) % 16 != 0 || sigma != rgb + 3 ||
       rgb_sample != 4 || sig_sample != 4 || sig_ray != rgb_ray ||
       rgb_ray % 4 != 0))
    return cudaErrorInvalidValue;
  if (n_rays == 0) return cudaSuccess;
  const long long rays_per_block = (long long)kCompositeWarps * (32 / w);
  const unsigned blocks =
      (unsigned)((n_rays + rays_per_block - 1) / rays_per_block);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (packed)
    composite_fwd_kernel<true><<<blocks, 32 * kCompositeWarps, 0, s>>>(
        rgb, rgb_ray, rgb_sample, sigma, sig_ray, sig_sample, dts, dt_ray,
        dt_sample, pixel, opacity, n_rays, n_samples, w);
  else
    composite_fwd_kernel<false><<<blocks, 32 * kCompositeWarps, 0, s>>>(
        rgb, rgb_ray, rgb_sample, sigma, sig_ray, sig_sample, dts, dt_ray,
        dt_sample, pixel, opacity, n_rays, n_samples, w);
  return cudaGetLastError();
}

// The resources of the composite_fwd instantiation for the packed (1) or
// strided (0) layout (info.cuh); returns the CUDA error (0 on success).
extern "C" int composite_fwd_info(int packed, int device, int* out) {
  using namespace repro;
  const void* kernel =
      packed ? reinterpret_cast<const void*>(composite_fwd_kernel<true>)
             : reinterpret_cast<const void*>(composite_fwd_kernel<false>);
  return kernel_info(kernel, 32 * kCompositeWarps, 0, 0, device, out);
}
