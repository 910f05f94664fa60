// K15: the sun's direct term, one launch a shaded surface.
//
// It replaces no Pallas kernel: the JAX package writes this term in jnp
// (incarnation_tpu/renderer/frame.py:535-570 with kernels/shading.py
// brdf_response :77-129 and directional_light_radiance). The torch twin
// (kernels/shading.py sun_term_plain) runs about 45 eager launches over
// the (H, W, 1) and (H, W, 3) planes of a frame: the sun's radiance, the
// Cook-Torrance and Lambert terms (with the transmission and clearcoat
// terms where the scene has extras), the visibility, the masked add into
// the frame's HDR. Here it is one launch, which reads base_color and mrao
// in place (16-byte pixels, their first three and two channels), n, v and
// the HDR (12-byte pixels), the mask, optional extras and the visibility's
// source, with the sun's direction and colour-intensity read on the card,
// and writes a new (H, W, 3) output (never in place: the HDR it reads may
// be the gbuffer's emissive plane).
//
// Roles, by the visibility's source:
// - none, or a given (H, W) plane (the RT frame's): k15_sun_term_kernel,
//   a thread a pixel.
// - map: the sun map's tap inside the launch (K14's tap, csrc/
//   k14_tap.cuh), formed in registers and only where it can change the
//   result: at a covered pixel whose n.l > 0 (a lit pixel; elsewhere the
//   twin's torch.where and masked add drop the visibility). Without the
//   checkerboard, k15_sun_term_kernel<true>: a lit pixel taps its own
//   position, noise at (x, row0 + y). With it, k15_sun_checker_kernel: a
//   thread a horizontal pair of a row, as K14's checkerboard kernel. A lit
//   fetching pixel takes its own tap, noise at the compacted (i, row0 +
//   y); a lit non-fetching pixel of pair i takes the fill of tap_i and
//   tap_j (k14_fill_pair). So pair i's fetching pixel is tapped when pair i
//   holds a lit pixel or the pair whose fill reads it has a lit
//   non-fetching pixel: a ballot of the lanes' lit non-fetching pixels
//   says which, and tap_j comes by a shuffle from the next or previous
//   lane; the lane at the warp's edge whose neighbour lies in another warp
//   taps it itself. The bias's n.l is the fetching pixel's own
//   (n.x s.x + n.z s.z) + n.y s.y (K14's), not the BRDF's dot3.
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
// Each pixel's HDR is loaded before its shading, so that the loads are in
// flight through it (the map role 0.0326 against 0.0345 ms with them
// after it, tools/torch_kernel_ab.py).
//
// What bounds it: bytes. Every pixel reads its mask and HDR and writes
// 12 B (25 B); a covered pixel reads its normal (12); a lit one its view
// vector (12), base colour and mrao (16 each, whole pixels), and its
// visibility (4, a given plane), extras (12) or its tap (the map role:
// its world position, 12, and a texel of the map). chip_smoke.py counts
// them on each launch's inputs (K15_* and the map role's taps).

#include <cuda_runtime.h>
#include <stdint.h>

#include "k14_tap.cuh"

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

// the planes a launch reads and writes
struct K15Args {
  const float* __restrict__ hdr;      // (H, W, 3)
  const float4* __restrict__ base;    // (H, W, 4)
  const float4* __restrict__ mrao;    // (H, W, 4)
  const float* __restrict__ nrm;      // (H, W, 3)
  const float* __restrict__ view;     // (H, W, 3)
  const uint8_t* __restrict__ mask;   // (H, W)
  const float* __restrict__ vis;      // (H, W) or NULL
  const float* __restrict__ extras;   // (H, W, 3) or NULL
  const float* __restrict__ sun_dir;  // (3,)
  const float* __restrict__ sun_ci;   // (4,)
  const float* __restrict__ wp;       // (H, W, 3) with the map, or NULL
  float* __restrict__ out;            // (H, W, 3)
};

// pixel i's sun term before its visibility, into o; false (and o unset)
// where the twin's torch.where and masked add give 0: uncovered, or
// n.l <= 0 (or NaN)
__device__ __forceinline__ bool k15_shade(const K15Args& a, size_t i,
                                          float (&o)[3]) {
  if (!__ldg(a.mask + i)) return false;
  float n[3], v[3], l[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    n[k] = __ldg(a.nrm + 3 * i + k);
    v[k] = __ldg(a.view + 3 * i + k);
    l[k] = __ldg(a.sun_dir + k);
  }
  const float no_l = k15_clamp(k15_dot(n, l), 0.0f, 1.0f);
  // torch.where(no_l > 0, out, 0.0): nothing more to compute otherwise
  if (!(no_l > 0.0f)) return false;
  const float no_v = k15_clamp(k15_dot(n, v), 0.0f, 1.0f);
  float hv[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) hv[k] = l[k] + v[k];
  const float rs = 1.0f / sqrtf(k15_dot(hv, hv) + PYF(1e-20));
#pragma unroll
  for (int k = 0; k < 3; ++k) hv[k] = hv[k] * rs;
  const float no_h = k15_clamp(k15_dot(n, hv), 0.0f, 1.0f);
  const float vo_h = k15_clamp(k15_dot(v, hv), 0.0f, 1.0f);
  const float4 bc = __ldg(a.base + i);
  const float4 mr = __ldg(a.mrao + i);
  const float b[3] = {bc.x, bc.y, bc.z};
  const float metal = mr.x, rough = mr.y;
  const float om = 1.0f - metal;
  float tr = 0.0f, cc = 0.0f, ccr = 0.0f;
  if (a.extras) {
    tr = __ldg(a.extras + 3 * i);
    cc = __ldg(a.extras + 3 * i + 1);
    ccr = k15_clamp_min(__ldg(a.extras + 3 * i + 2), PYF(0.03));
  }
  const float d = k15_ggx(no_h, rough);
  const float fw = k15_pow5(vo_h);
  const float g = k15_smith(no_v, no_l, rough);
  const float den = k15_clamp_min(no_v * 4.0f * no_l, PYF(1e-3));
  float fc = 0.0f, fr_cc = 0.0f;
  if (a.extras) {
    fc = (fw + PYF(0.04) * (1.0f - fw)) * cc;
    fr_cc = (k15_ggx(no_h, ccr) * fc * k15_smith(no_v, no_l, ccr)) / den;
  }
  const float rad_scale = __ldg(a.sun_ci + 3) * 100.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float f0 = metal * b[k] + om * PYF(0.04);
    float albedo = om * b[k];
    if (a.extras) albedo = albedo * (1.0f - tr);
    const float f = fw + f0 * (1.0f - fw);
    const float fr = d * f * g / den;
    const float fd = albedo * K15_INV_PI;
    float ok = fr + (1.0f - f) * fd;
    if (a.extras) ok = ok * (1.0f - fc) + fr_cc;
    o[k] = ok * (rad_scale * __ldg(a.sun_ci + k)) * no_l;
  }
  return true;
}

// pixel i's HDR, loaded before its shading so that the loads are in
// flight through it
__device__ __forceinline__ void k15_hdr(const K15Args& a, size_t i,
                                        float (&h)[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) h[k] = __ldg(a.hdr + 3 * i + k);
}

// out = hdr + the masked sun term of pixel i (+0.0 where unlit: an
// uncovered -0 becomes +0, as the twin's masked add)
__device__ __forceinline__ void k15_write(const K15Args& a, size_t i,
                                          const float (&h)[3], bool lit,
                                          const float (&o)[3], float vv,
                                          bool scale) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float s = !lit ? 0.0f : scale ? o[k] * vv : o[k];
    a.out[3 * i + k] = h[k] + s;
  }
}

// a thread a pixel: the visibility given (vis), none, or with MAP the
// map's tap of each lit pixel at its own position
template <bool MAP>
__global__ void __launch_bounds__(K15_THREADS)
k15_sun_term_kernel(K15Args a, K14Map mp, int width, int row0,
                    long long n_px) {
  const long long i = (long long)blockIdx.x * K15_THREADS + threadIdx.x;
  if (i >= n_px) return;
  float h[3], o[3];
  k15_hdr(a, (size_t)i, h);
  const bool lit = k15_shade(a, (size_t)i, o);
  float vv = 1.0f;
  if (lit && MAP) {
    float m[4][3];
    k14_load_vp(mp, m);
    vv = k14_tap(mp, m, a.wp, (size_t)i, (unsigned)(i % width),
                 (unsigned)(row0 + i / width));
  } else if (lit && a.vis) {
    vv = __ldg(a.vis + i);
  }
  k15_write(a, (size_t)i, h, lit, o, vv, MAP || a.vis);
}

// the map role under the checkerboard: a thread a horizontal pair of a
// row, rows in blockIdx.y
__global__ void __launch_bounds__(K15_THREADS)
k15_sun_checker_kernel(K15Args a, K14Map mp, int width, int row0,
                       int parity) {
  const int y = blockIdx.y, hw = width / 2;
  const int i = blockIdx.x * K15_THREADS + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int rp = k14_fetch_lane(row0, y, parity);
  const unsigned ny = (unsigned)(row0 + y);
  const size_t row = (size_t)y * width;
  const bool in = i < hw;
  const size_t pf = row + 2 * i + rp, pn = row + 2 * i + (1 - rp);
  float hf[3], hn[3], of[3], on[3];
  if (in) {
    k15_hdr(a, pf, hf);
    k15_hdr(a, pn, hn);
  }
  const bool lit_f = in && k15_shade(a, pf, of);
  const bool lit_n = in && k15_shade(a, pn, on);
  // the lanes whose non-fetching pixel is lit read their neighbour pair's
  // tap: lane - 1's reads this lane's where lane 0 fetches, lane + 1's
  // where lane 1 does (across the warp's edge the reader taps it itself)
  const unsigned fill = __ballot_sync(0xffffffffu, lit_n);
  const bool read = rp == 0 ? lane > 0 && (fill >> (lane - 1)) & 1u
                            : lane < 31 && (fill >> (lane + 1)) & 1u;
  const int j = in ? k14_fill_pair(i, rp, hw) : -1;
  const bool edge = lit_n && j >= 0 && (rp == 0 ? lane == 31 : lane == 0);
  float m[4][3];
  if (in && (lit_f || lit_n || read || edge)) k14_load_vp(mp, m);
  float val = 0.0f;
  if (in && (lit_f || lit_n || read))
    val = k14_tap(mp, m, a.wp, pf, (unsigned)i, ny);
  const float from = rp == 0 ? __shfl_down_sync(0xffffffffu, val, 1)
                             : __shfl_up_sync(0xffffffffu, val, 1);
  if (!in) return;
  float nb = val;                               // the row's end: clamped
  if (edge)
    nb = k14_tap(mp, m, a.wp, row + 2 * j + rp, (unsigned)j, ny);
  else if (j >= 0)
    nb = from;
  k15_write(a, pf, hf, lit_f, of, val, true);
  k15_write(a, pn, hn, lit_n, on, k14_fill(val, nb), true);
}

extern "C" int k15_sun_term(const float* hdr, const float* base,
                            const float* mrao, const float* nrm,
                            const float* view, const uint8_t* mask,
                            const float* vis, const float* extras,
                            const float* sun_dir, const float* sun_ci,
                            float* out, int width, int height,
                            const float* wp, const float* depth,
                            const float* sun_vp, int side, float bias_scale,
                            int dither, unsigned seed_x, unsigned seed_y,
                            int parity, int row0, void* stream) {
  const bool map = depth != nullptr;
  if (width < 1 || height < 1 || ((uintptr_t)base | (uintptr_t)mrao) % 16 ||
      (map && (!wp || !sun_vp || vis || side < 1 || parity < -1 ||
               parity > 1 || row0 < 0 || (parity >= 0 && width % 2))))
    return (int)cudaErrorInvalidValue;
  K15Args a;
  a.hdr = hdr;
  a.base = reinterpret_cast<const float4*>(base);
  a.mrao = reinterpret_cast<const float4*>(mrao);
  a.nrm = nrm;
  a.view = view;
  a.mask = mask;
  a.vis = vis;
  a.extras = extras;
  a.sun_dir = sun_dir;
  a.sun_ci = sun_ci;
  a.wp = wp;
  a.out = out;
  // the tap's n.l: the pixel's own normal and the sun's direction
  const K14Map mp = k14_map(depth, sun_vp, side, bias_scale, dither, seed_x,
                            seed_y, nrm, sun_dir);
  const cudaStream_t s = (cudaStream_t)stream;
  const long long n_px = (long long)width * height;
  const unsigned blocks = (unsigned)((n_px + K15_THREADS - 1) / K15_THREADS);
  if (!map)
    k15_sun_term_kernel<false><<<blocks, K15_THREADS, 0, s>>>(
        a, mp, width, row0, n_px);
  else if (parity < 0)
    k15_sun_term_kernel<true><<<blocks, K15_THREADS, 0, s>>>(
        a, mp, width, row0, n_px);
  else
    k15_sun_checker_kernel<<<dim3((width / 2 + K15_THREADS - 1) /
                                      K15_THREADS,
                                  height),
                             K15_THREADS, 0, s>>>(a, mp, width, row0,
                                                  parity);
  return (int)cudaGetLastError();
}
