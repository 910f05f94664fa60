// K15: the sun's direct term, one launch a shaded surface.
//
// It replaces no Pallas kernel: the JAX package writes this term in jnp
// (incarnation_tpu/renderer/frame.py:535-570 with kernels/shading.py
// brdf_response :77-129 and directional_light_radiance). The torch twin
// (kernels/shading.py sun_term_plain) runs about 45 eager launches over
// the (H, W, 1) and (H, W, 3) planes of a frame: the sun's radiance, the
// Cook-Torrance and Lambert terms (with the transmission and clearcoat
// terms where the scene has extras), the visibility, the masked add into
// the frame's HDR. Here it is one launch, a thread a pixel, which reads
// base_color and mrao in place (16-byte pixels, their first three and two
// channels), n, v and the HDR (12-byte pixels), the mask, an optional
// (H, W) visibility (K14's map tap or a given one: the RT frame's) and
// optional extras, with the sun's direction and colour-intensity read on
// the card, and writes a new (H, W, 3) output (never in place: the HDR it
// reads may be the gbuffer's emissive plane).
//
// Rounding: the twin's operations in its order (built --fmad=false): the
// dot products left to right (mathutils.dot3), normalize as v times the
// reciprocal of sqrt(dot + 1e-20), 0.5 / t as torch's reciprocal times
// 0.5, (1 - u)^5 as mathutils.ipow's x * ((x x)(x x)), torch.clamp's NaN
// passing through (fminf / fmaxf alone would drop it), each Python number
// the float torch rounds it to ((float) of its double), torch.where's 0.0
// where n.l <= 0 (or NaN) and the masked add of +0.0 (so an uncovered -0
// becomes +0). So every value equals the twin's bit for bit.
//
// What bounds it: bytes. A covered pixel reads 16 B of base colour, 16 of
// mrao (whole pixels), 12 each of n, v and the HDR, 4 of visibility and
// its mask byte, and writes 12: 85 B (12 more with extras); an uncovered
// pixel reads its mask and HDR and writes 12: 25 B. At 1920x1088, 76%
// covered: 148 MB, 0.044 ms at 3.35 TB/s. Its ~190 float operations a
// covered pixel take 0.006 ms at 67 TFLOP/s.

#include <cuda_runtime.h>
#include <stdint.h>

#define K15_THREADS 256
// a Python number, as torch rounds it to float
#define PYF(x) ((float)(x))
#define K15_PI PYF(3.141592653589793)
#define K15_INV_PI PYF(0.3183098861837907)

// torch.clamp(x, lo, hi) and torch.clamp(x, min=lo): a NaN passes
__device__ __forceinline__ float k15_clamp(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float k15_clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

// shading.ggx_distribution
__device__ __forceinline__ float k15_ggx(float no_h, float rough) {
  const float a = rough * rough;
  const float a2 = a * a;
  const float nh = k15_clamp_min(no_h, 0.0f);
  const float denom = nh * nh * (a2 - 1.0f) + 1.0f;
  return a2 / k15_clamp_min(K15_PI * denom * denom, PYF(1e-4));
}

// shading.g_smith_ggx_correlated
__device__ __forceinline__ float k15_smith(float no_v, float no_l,
                                           float rough) {
  const float a2 = rough * rough;
  const float ggx_v = no_l * sqrtf(no_v * no_v * (1.0f - a2) + a2);
  const float ggx_l = no_v * sqrtf(no_l * no_l * (1.0f - a2) + a2);
  return (1.0f / k15_clamp_min(ggx_v + ggx_l, PYF(1e-5))) * 0.5f;
}

// mathutils.ipow(1 - u, 5)
__device__ __forceinline__ float k15_pow5(float u) {
  const float x = 1.0f - u;
  const float x2 = x * x;
  return x * (x2 * x2);
}

__device__ __forceinline__ float k15_dot(const float (&a)[3],
                                         const float (&b)[3]) {
  return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2];
}

__global__ void __launch_bounds__(K15_THREADS)
k15_sun_term_kernel(const float* __restrict__ hdr,    // (H, W, 3)
                    const float4* __restrict__ base,  // (H, W, 4)
                    const float4* __restrict__ mrao,  // (H, W, 4)
                    const float* __restrict__ nrm,    // (H, W, 3)
                    const float* __restrict__ view,   // (H, W, 3)
                    const uint8_t* __restrict__ mask, // (H, W)
                    const float* __restrict__ vis,    // (H, W) or NULL
                    const float* __restrict__ extras, // (H, W, 3) or NULL
                    const float* __restrict__ sun_dir,  // (3,)
                    const float* __restrict__ sun_ci,   // (4,)
                    float* __restrict__ out, long long n_px) {
  const long long i = (long long)blockIdx.x * K15_THREADS + threadIdx.x;
  if (i >= n_px) return;
  float h[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) h[k] = __ldg(hdr + 3 * i + k);
  float sun[3] = {0.0f, 0.0f, 0.0f};
  if (__ldg(mask + i)) {
    float n[3], v[3], l[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      n[k] = __ldg(nrm + 3 * i + k);
      v[k] = __ldg(view + 3 * i + k);
      l[k] = __ldg(sun_dir + k);
    }
    const float no_l = k15_clamp(k15_dot(n, l), 0.0f, 1.0f);
    // torch.where(no_l > 0, out, 0.0): nothing more to compute otherwise
    if (no_l > 0.0f) {
      const float no_v = k15_clamp(k15_dot(n, v), 0.0f, 1.0f);
      float hv[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) hv[k] = l[k] + v[k];
      const float rs = 1.0f / sqrtf(k15_dot(hv, hv) + PYF(1e-20));
#pragma unroll
      for (int k = 0; k < 3; ++k) hv[k] = hv[k] * rs;
      const float no_h = k15_clamp(k15_dot(n, hv), 0.0f, 1.0f);
      const float vo_h = k15_clamp(k15_dot(v, hv), 0.0f, 1.0f);
      const float4 bc = __ldg(base + i);
      const float4 mr = __ldg(mrao + i);
      const float b[3] = {bc.x, bc.y, bc.z};
      const float metal = mr.x, rough = mr.y;
      const float om = 1.0f - metal;
      float tr = 0.0f, cc = 0.0f, ccr = 0.0f;
      if (extras) {
        tr = __ldg(extras + 3 * i);
        cc = __ldg(extras + 3 * i + 1);
        ccr = k15_clamp_min(__ldg(extras + 3 * i + 2), PYF(0.03));
      }
      const float d = k15_ggx(no_h, rough);
      const float fw = k15_pow5(vo_h);
      const float g = k15_smith(no_v, no_l, rough);
      const float den = k15_clamp_min(no_v * 4.0f * no_l, PYF(1e-3));
      float fc = 0.0f, fr_cc = 0.0f;
      if (extras) {
        fc = (fw + PYF(0.04) * (1.0f - fw)) * cc;
        fr_cc = (k15_ggx(no_h, ccr) * fc * k15_smith(no_v, no_l, ccr)) /
                den;
      }
      const float rad_scale = __ldg(sun_ci + 3) * 100.0f;
      const float vv = vis ? __ldg(vis + i) : 1.0f;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float f0 = metal * b[k] + om * PYF(0.04);
        float albedo = om * b[k];
        if (extras) albedo = albedo * (1.0f - tr);
        const float f = fw + f0 * (1.0f - fw);
        const float fr = d * f * g / den;
        const float fd = albedo * K15_INV_PI;
        float o = fr + (1.0f - f) * fd;
        if (extras) o = o * (1.0f - fc) + fr_cc;
        o = o * (rad_scale * __ldg(sun_ci + k)) * no_l;
        sun[k] = vis ? o * vv : o;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) out[3 * i + k] = h[k] + sun[k];
}

extern "C" int k15_sun_term(const float* hdr, const float* base,
                            const float* mrao, const float* nrm,
                            const float* view, const uint8_t* mask,
                            const float* vis, const float* extras,
                            const float* sun_dir, const float* sun_ci,
                            float* out, long long n_px, void* stream) {
  if (n_px < 1 || ((uintptr_t)base | (uintptr_t)mrao) % 16)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n_px + K15_THREADS - 1) / K15_THREADS);
  k15_sun_term_kernel<<<blocks, K15_THREADS, 0, (cudaStream_t)stream>>>(
      hdr, reinterpret_cast<const float4*>(base),
      reinterpret_cast<const float4*>(mrao), nrm, view, mask, vis, extras,
      sun_dir, sun_ci, out, n_px);
  return (int)cudaGetLastError();
}
