// K8: sky lighting, the image-based lighting of every covered pixel.
//
// It replaces no Pallas kernel: the JAX package writes this pass in jnp
// (incarnation_tpu/kernels/skylight.py sky_lighting :19-158, exact path,
// with kernels/ibl.py sample_cube, sample_env_brdf, env_brdf_approx and
// sh_irradiance). Its torch twin (kernels/skylight.py sky_lighting_plain)
// launches about 1,100 elementwise kernels over full-frame tensors when
// the env BRDF is the analytic fit (two 16 x 16 Chebyshev tensor sums),
// the raster frame's slowest pass; here it is one kernel.
//
// One thread per pixel. An uncovered pixel writes exact zeros (the twin's
// torch.where(mask, radiance, 0), whatever its radiance). A covered one
// computes in registers: the SH9 irradiance at its normal (or bent normal)
// for the diffuse lobe; the reflected direction, its cube face and uv and
// the trilinear fetch of the prefiltered cube (two levels, four texels of
// three floats each, an L2-resident table); the env BRDF, either the
// analytic fit at (NoV, 1 - roughness) or the bilinear LUT fetch (packed
// (S*S, 8) rows or the raw (S, S, 2) image); with extras the clearcoat
// lobe (a second cube fetch and env-BRDF evaluation); the AO blend, the
// sky brightness and the HBAO scale.
//
// Stochastic roles (skylight.py:62-125 in the JAX package, while TAA
// accumulates): the probe fetched at one dithered mip, bilinear or one
// jittered texel of its RGBE table; with extras one lobe a pixel and
// frame (k8_sky_stochastic_kernel); with the checkerboard half the pixels
// fetch (k8_sky_checker_kernel: a fetching and a filling warp over a row
// span of 31 pairs, every lane of the fetching warp fetching in one
// round).
//
// Tables: the Chebyshev coefficients (2 x 256 floats) and the cube's level
// bases and sizes are kernel parameters, passed by value from host tables
// the wrapper builds once per coefficient set and per probe. The loops over
// them are unrolled, so each coefficient is an operand read from the
// constant bank (one broadcast to the warp), and no table is copied to the
// card per call.
//
// Arithmetic: every operation is the twin's, in the twin's order, built
// --fmad=false (kernels/build.py), and every constant is the float the
// twin's Python scalar rounds to. The dot products are mathutils.dot3's,
// left to right; mathutils.normalize is v * (1 / sqrt(dot3 + 1e-20)); pow
// and sqrt are the libdevice functions torch calls. The analytic env-BRDF
// fit is the one place K8 fuses: each Chebyshev recurrence step, T_k =
// (2 t) T[k-1] - T[k-2], and each product of the tensor sums (row by row,
// g = c_i0 T_0(v), then g += c_ij T_j(v) left to right, then out +=
// T_i(u) g) is one explicit FFMA (__fmaf_rn, which --fmad=false leaves
// alone), and the twin (ibl.env_brdf_approx) rounds each of those steps
// once, exactly (mathutils.fma), as XLA's CPU build fuses them in the JAX
// package's jitted frame. The fit is ill-conditioned in f32 (an ulp of
// T_i(u) moves A by about 1e-2), so K8 and its twin fuse exactly the same
// steps. The SH irradiance is one chain of FFMAs from zero per channel,
// which the twin's ibl.sh_irradiance rounds the same way (mathutils.fma).
// So K8 equals its twin bit for bit (chip_smoke.py holds it to K8_TOL of
// the peak radiance and logs the error).
//
// Mapping: a warp of k8_sky_kernel and k8_sky_stochastic_kernel shades an
// 8 x 4 tile of pixels, so the warps that straddle a coverage edge, whose
// lanes diverge, are fewer than with 32 pixels of a row, and a warp's
// reflected directions lie closer together; a block of 128 threads (a
// 16 x 8 tile) leaves less of an SM idle at the end of a launch than one
// of 256 (each a few percent on the bench frame; PERF.md). The
// checkerboard's mapping is its own (k8_sky_checker_kernel).
//
// What bounds it: a covered pixel reads 57 bytes (base colour and mrao as
// 16-byte rows, n, v, the mask byte), +12 with extras, +4 with HBAO, +12
// with bent normals, and writes 12: about 0.043 ms at 1920 x 1088 and
// 3.35 TB/s. The analytic env BRDF costs about 1,200 float operations a
// lobe (a fused multiply-add counts two), about 0.034 ms at 67 TFLOP/s for
// 1.6 M covered pixels (chip_smoke.py counts both), so the pass sits near
// the line between the two bounds; as 552 FFMAs the fit issues about 650
// instructions a lobe, about 1,200 with each multiply and add apart. The
// checkerboard role moves less (half the pixels fetch one texel, 0.035
// ms at 3.35 TB/s) and still evaluates the fit for every covered pixel:
// the fit and the loads of each pixel's 12-byte rows, at two pixels'
// stride in a warp of the row span, bound it, not the fetch (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#define K8_THREADS 128
#define CHEB_N 16
#define MAX_LEVELS 16

// flags (kernels/skylight.py)
#define F_DIFFUSE 1
#define F_SPECULAR 2
#define F_LIGHTING_ONLY 4
#define F_ANALYTIC 8
#define F_LUT_PACKED 16
#define F_DITHER 32   // the stochastic probe fetch: one dithered mip
#define F_JITTER 64   // its one jittered texel, from the RGBE table
#define F_CHECKER 128 // fetched by half the pixels (the checkerboard)

// frame_noise's channels (kernels/skylight.py N_*)
#define N_PROBE_LOD 2246822519u
#define N_PROBE_JX 3323198485u
#define N_PROBE_JY 2654435769u
#define N_LOBE 2357136044u

struct Cheb {
  float a[CHEB_N * CHEB_N];  // CHEB_A, row-major
  float b[CHEB_N * CHEB_N];  // CHEB_B
};

struct Cube {
  int base[MAX_LEVELS];
  int size[MAX_LEVELS];
  int levels;
  int packed;  // +x / +y neighbours from the clamped texel (CubeMips.packed)
};

// kernels/ibl.py _SH_K and _SH_A, float32 values
#define SH_K0 0.282095f
#define SH_K1 0.488603f
#define SH_K4 1.092548f
#define SH_K6 0.315392f
#define SH_K8 0.546274f
#define SH_A0 3.14159274101257324f
#define SH_A1 2.094395f
#define SH_A2 0.785398f
#define INV_PI 0.318309873342514038f  // float(1 / pi)

// torch.maximum / minimum / clamp propagate a NaN
__device__ __forceinline__ float tmax(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fmaxf(a, b);
}
__device__ __forceinline__ float tmin(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fminf(a, b);
}
__device__ __forceinline__ float clamp_lo(float x, float lo) {
  return x < lo ? lo : x;
}
__device__ __forceinline__ float clamp01(float x) {
  return tmin(tmax(x, 0.0f), 1.0f);
}
__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// mathutils.dot3: (x + y) + z
__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// ibl.sh_irradiance: the basis times the band weights, then the (9, 3)
// product as one fused chain per channel, as the twin rounds it
__device__ __forceinline__ void sh_irradiance(const float* d, const float* sh,
                                              float* irr) {
  const float x = d[0], y = d[1], z = d[2];
  float b[9];
  b[0] = SH_K0 * SH_A0;
  b[1] = (SH_K1 * y) * SH_A1;
  b[2] = (SH_K1 * z) * SH_A1;
  b[3] = (SH_K1 * x) * SH_A1;
  b[4] = ((SH_K4 * x) * y) * SH_A2;
  b[5] = ((SH_K4 * y) * z) * SH_A2;
  b[6] = (SH_K6 * ((3.0f * z) * z - 1.0f)) * SH_A2;
  b[7] = ((SH_K4 * x) * z) * SH_A2;
  b[8] = (SH_K8 * (x * x - y * y)) * SH_A2;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 9; ++k)
      acc = __fmaf_rn(b[k], __ldg(sh + 3 * k + c), acc);
    irr[c] = acc;
  }
}

// ibl.dir_to_face_uv
__device__ __forceinline__ void face_uv(const float* d, int& face, float& u,
                                        float& v) {
  const float x = d[0], y = d[1], z = d[2];
  const float ax = fabsf(x), ay = fabsf(y), az = fabsf(z);
  const bool is_x = (ax >= ay) && (ax >= az);
  const bool is_y = !is_x && (ay >= az);
  face = is_x ? (x >= 0.0f ? 0 : 1)
              : (is_y ? (y >= 0.0f ? 2 : 3) : (z >= 0.0f ? 4 : 5));
  const float s = clamp_lo(is_x ? ax : (is_y ? ay : az), 1e-12f);
  float vx, vy;
  if (face == 0) vx = -z / s;
  else if (face == 1) vx = z / s;
  else if (face == 5) vx = -x / s;
  else vx = x / s;
  if (face == 2) vy = -z / s;
  else if (face == 3) vy = z / s;
  else vy = y / s;
  u = (vx + 1.0f) * 0.5f;
  v = (1.0f - vy) * 0.5f;
}

// ibl._sample_cube_level: bilinear, clamped at the face's edges
__device__ __forceinline__ void cube_level(const float* __restrict__ flat,
                                           const Cube& cube, int base, int s,
                                           int face, float u, float v,
                                           float* out) {
  const float sf = (float)s;
  const float fx = u * sf - 0.5f;
  const float fy = v * sf - 0.5f;
  const int x0 = (int)floorf(fx);
  const int y0 = (int)floorf(fy);
  const float tx = fx - (float)x0;
  const float ty = fy - (float)y0;
  const int hi = s - 1;
  const int x0c = min(max(x0, 0), hi);
  const int y0c = min(max(y0, 0), hi);
  const int x1c = cube.packed ? min(x0c + 1, hi) : min(max(x0 + 1, 0), hi);
  const int y1c = cube.packed ? min(y0c + 1, hi) : min(max(y0 + 1, 0), hi);
  const int row0 = base + (face * s + y0c) * s;
  const int row1 = base + (face * s + y1c) * s;
  const float* t00 = flat + 3 * (row0 + x0c);
  const float* t10 = flat + 3 * (row0 + x1c);
  const float* t01 = flat + 3 * (row1 + x0c);
  const float* t11 = flat + 3 * (row1 + x1c);
  const float ux = 1.0f - tx, uy = 1.0f - ty;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float top = __ldg(t00 + c) * ux + __ldg(t10 + c) * tx;
    const float bot = __ldg(t01 + c) * ux + __ldg(t11 + c) * tx;
    out[c] = top * uy + bot * ty;
  }
}

// ibl.sample_cube at a float mip
__device__ __forceinline__ void sample_cube(const float* __restrict__ flat,
                                            const Cube& cube, int face,
                                            float u, float v, float lod,
                                            float* out) {
  const int last = cube.levels - 1;
  lod = tmin(tmax(lod, 0.0f), (float)last);
  const int l0 = clampi((int)floorf(lod), 0, last);
  const int l1 = min(l0 + 1, last);
  const float frac = lod - (float)l0;
  float s0[3], s1[3];
  cube_level(flat, cube, cube.base[l0], cube.size[l0], face, u, v, s0);
  cube_level(flat, cube, cube.base[l1], cube.size[l1], face, u, v, s1);
  const float uf = 1.0f - frac;
#pragma unroll
  for (int c = 0; c < 3; ++c) out[c] = s0[c] * uf + s1[c] * frac;
}

// the Chebyshev polynomials T_0..T_15 at t: T_k = (2 t) T_{k-1} - T_{k-2},
// one FFMA a step (2 t is exact; the product and the sum round once)
__device__ __forceinline__ void cheb(float t, float* ts) {
  const float t2 = 2.0f * t;
  ts[0] = 1.0f;
  ts[1] = t;
#pragma unroll
  for (int k = 2; k < CHEB_N; ++k)
    ts[k] = __fmaf_rn(t2, ts[k - 1], -ts[k - 2]);
}

// sum_i T_i(u) (sum_j c_ij T_j(v)), in the twin's order: each row
// g = c_i0 T_0(v), then g = fma(c_ij, T_j(v), g) for j = 1..15; the sum
// starts at T_0(u) g_0, then out = fma(T_i(u), g_i, out). The coefficients
// stay constant-bank operands of the FFMAs.
__device__ __forceinline__ float cheb_tensor(const float* c, const float* tu,
                                             const float* tv) {
  float out = 0.0f;
#pragma unroll
  for (int i = 0; i < CHEB_N; ++i) {
    float g = c[i * CHEB_N] * tv[0];
#pragma unroll
    for (int j = 1; j < CHEB_N; ++j)
      g = __fmaf_rn(c[i * CHEB_N + j], tv[j], g);
    out = i == 0 ? tu[0] * g : __fmaf_rn(tu[i], g, out);
  }
  return out;
}

// ibl.env_brdf_approx(no_v, roughness) -> (A, B)
__device__ __forceinline__ void env_brdf_analytic(const Cheb& ch, float no_v,
                                                  float roughness, float* ab) {
  const float nov = clamp01(no_v);
  const float r = clamp01(roughness);
  float tu[CHEB_N], tv[CHEB_N];
  cheb(2.0f * powf(clamp_lo(nov, 1e-8f), 0.25f) - 1.0f, tu);
  cheb(2.0f * r - 1.0f, tv);
  const float an = cheb_tensor(ch.a, tu, tv);
  cheb(2.0f * sqrtf(r) - 1.0f, tv);
  const float bn = cheb_tensor(ch.b, tu, tv);
  const float inv = 1.0f / clamp_lo(nov, 1.0f / 256.0f);
  ab[0] = an * inv;
  ab[1] = bn * inv;
}

// ibl.sample_env_brdf(lut, no_v, roughness) -> (A, B)
__device__ __forceinline__ void env_brdf_lut(const float* __restrict__ lut,
                                             int size, bool packed,
                                             float no_v, float roughness,
                                             float* ab) {
  const float sf = (float)size;
  const float fx = clamp01(no_v) * sf - 0.5f;
  const float fy = clamp01(roughness) * sf - 0.5f;
  const int x0 = clampi((int)floorf(fx), 0, size - 1);
  const int y0 = clampi((int)floorf(fy), 0, size - 1);
  const float tx = fx - (float)x0;
  const float ty = fy - (float)y0;
  const float ux = 1.0f - tx, uy = 1.0f - ty;
  if (packed) {
    const float4* row = reinterpret_cast<const float4*>(lut) +
                        2 * (y0 * size + x0);
    const float4 p = __ldg(row), q = __ldg(row + 1);
    const float top0 = p.x * ux + p.z * tx, top1 = p.y * ux + p.w * tx;
    const float bot0 = q.x * ux + q.z * tx, bot1 = q.y * ux + q.w * tx;
    ab[0] = top0 * uy + bot0 * ty;
    ab[1] = top1 * uy + bot1 * ty;
    return;
  }
  const int x1 = min(x0 + 1, size - 1);
  const int y1 = min(y0 + 1, size - 1);
  const float2* f = reinterpret_cast<const float2*>(lut);
  const float2 a = __ldg(f + y0 * size + x0), b = __ldg(f + y0 * size + x1);
  const float2 c = __ldg(f + y1 * size + x0), d = __ldg(f + y1 * size + x1);
  const float top0 = a.x * ux + b.x * tx, top1 = a.y * ux + b.y * tx;
  const float bot0 = c.x * ux + d.x * tx, bot1 = c.y * ux + d.y * tx;
  ab[0] = top0 * uy + bot0 * ty;
  ab[1] = top1 * uy + bot1 * ty;
}

// resolve.frame_noise: a uniform in [0, 1) from the uint32 hash of the
// whole-frame pixel (x, y) xor the channel's seed (frame x mult, wrapped)
__device__ __forceinline__ float frame_noise(uint32_t x, uint32_t y,
                                             uint32_t seed) {
  uint32_t h = (x * 374761393u + y * 668265263u) ^ seed;
  h = (h ^ (h >> 13)) * 1274126177u;
  return (float)((h >> 16) & 0xFFFFu) * (1.0f / 65536.0f);
}

// A pixel's NoV and, with the lobe (extras), the clearcoat lobe's weight
// fc and whether this pixel and frame pick it
struct Lobe {
  float no_v, fc;
  bool pick;
};

// skylight.py's NoV and lobe pick (sky_lighting_plain): shading.f_schlick
// (NoV, 0.04) x cc, (1 - u)^5 as mathutils.ipow, picked where the pixel's
// noise is below it
__device__ __forceinline__ Lobe pixel_lobe(const float* nn, const float* vv,
                                           const float* ex, bool lobe,
                                           uint32_t px, uint32_t py,
                                           uint32_t frame) {
  Lobe b;
  b.no_v = clamp_lo(dot3(nn, vv), 0.01f);
  b.fc = 0.0f;
  b.pick = false;
  if (lobe) {
    const float x = 1.0f - b.no_v;
    const float x2 = x * x;
    const float f = x * (x2 * x2);
    b.fc = (f + 0.04f * (1.0f - f)) * ex[1];
    b.pick = frame_noise(px, py, frame * N_LOBE) < b.fc;
  }
  return b;
}

// The stochastic probe fetch of one pixel: the reflected direction's face
// and uv, and the dithered mip
struct Tap {
  int face;
  float u, v, lod;
};

// skylight.py's stochastic specular set-up (sky_lighting_plain): the lod
// roughness (or, where the coat lobe is picked, its roughness) x (levels
// - 1) + noise, in the twin's operations
__device__ __forceinline__ Tap spec_tap(const float* nn, const float* vv,
                                        float roughness, const float* ex,
                                        const Lobe& b, float mips1,
                                        uint32_t px, uint32_t py,
                                        uint32_t frame) {
  Tap t;
  const float vn2 = 2.0f * dot3(vv, nn);
  float r[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) r[c] = vn2 * nn[c] - vv[c];
  const float inv = 1.0f / sqrtf(dot3(r, r) + 1e-20f);
#pragma unroll
  for (int c = 0; c < 3; ++c) r[c] = r[c] * inv;
  face_uv(r, t.face, t.u, t.v);
  const float lod = b.pick ? clamp_lo(ex[2], 0.03f) * mips1
                           : roughness * mips1;
  t.lod = lod + frame_noise(px, py, frame * N_PROBE_LOD);
  return t;
}

// ibl.sample_cube(single_mip=True) at the tap: level floor(lod) of the
// clamped lod, bilinear, or with rgbe the one texel floor(uv s - 0.5 +
// j), clamped to the face, decoded as mantissa x 2^(e - 136)
// (ibl.rgbe_decode; the power of two built from its bits)
__device__ __forceinline__ void probe_fetch(const float* __restrict__ flat,
                                            const uint32_t* __restrict__ rgbe,
                                            const Cube& cube, const Tap& t,
                                            uint32_t px, uint32_t py,
                                            uint32_t frame, float* out) {
  const int last = cube.levels - 1;
  const float lod = tmin(tmax(t.lod, 0.0f), (float)last);
  const int l0 = clampi((int)floorf(lod), 0, last);
  const int s = cube.size[l0];
  if (!rgbe) {
    cube_level(flat, cube, cube.base[l0], s, t.face, t.u, t.v, out);
    return;
  }
  const float sf = (float)s;
  const float jx = frame_noise(px, py, frame * N_PROBE_JX);
  const float jy = frame_noise(px, py, frame * N_PROBE_JY);
  const int x = clampi((int)floorf(t.u * sf - 0.5f + jx), 0, s - 1);
  const int y = clampi((int)floorf(t.v * sf - 0.5f + jy), 0, s - 1);
  const uint32_t w = __ldg(rgbe + cube.base[l0] + (t.face * s + y) * s + x);
  const int p = (int)((w >> 24) & 0xFFu) - 136;
  const float scale = __int_as_float(p >= -126 ? (p + 127) << 23
                                               : 1 << (p + 149));
  out[0] = (float)(w & 0xFFu) * scale;
  out[1] = (float)((w >> 8) & 0xFFu) * scale;
  out[2] = (float)((w >> 16) & 0xFFu) * scale;
}

__device__ __forceinline__ void load3(const float* __restrict__ a, int i,
                                      float* o) {
  o[0] = __ldg(a + 3 * i);
  o[1] = __ldg(a + 3 * i + 1);
  o[2] = __ldg(a + 3 * i + 2);
}

// The arguments both stochastic kernels take
#define K8S_PARAMS                                                           \
  const float4 *__restrict__ base_color, const float4 *__restrict__ mrao,    \
      const uint8_t *__restrict__ mask, const float *__restrict__ n,         \
      const float *__restrict__ v, const float *__restrict__ bent,           \
      const float *__restrict__ hbao, const float *__restrict__ extras,      \
      const float *__restrict__ sh, const float *__restrict__ cube_flat,     \
      const uint32_t *__restrict__ rgbe, const float *__restrict__ lut,      \
      int lut_size, float sky, int flags, const Cube cube,                   \
      const Cheb cheb_tab, float *__restrict__ out, int width, int height,   \
      uint32_t frame, int parity, int row0

// A covered pixel's radiance in a stochastic role but for its probe
// fetch: the diffuse lobe (scaled by 1 - fc with the lobe), and the
// specular term's factor k = f0 A + B of the picked lobe (the coat's env
// BRDF at its roughness with f0 0.04, or the base lobe's with its f0)
struct Lit {
  float rad[3], k[3];
  float ao, ao_blend, one_aob;
};

// The exact role's diffuse lobe and the picked lobe's env BRDF of
// covered pixel i, its lobe b given, in the twin's operations (the twin
// evaluates both lobes' env BRDF and selects; only the picked one is
// evaluated here)
__device__ __forceinline__ Lit stochastic_lit(
    const float4* __restrict__ base_color, const float4* __restrict__ mrao,
    const float* __restrict__ bent, const float* __restrict__ sh,
    const float* __restrict__ lut, int lut_size, float sky, int flags,
    const Cheb& cheb_tab, int i, const float* nn, const float* ex,
    bool lobe, const Lobe& b) {
  Lit L;
  const float4 bc = __ldg(base_color + i);
  const float4 mr = __ldg(mrao + i);
  float base[3] = {bc.x, bc.y, bc.z};
  if (flags & F_LIGHTING_ONLY) base[0] = base[1] = base[2] = 0.5f;
  const float metallic = mr.x, roughness = mr.y;
  L.ao = mr.z;
  L.ao_blend = mr.w;
  const float one_m = 1.0f - metallic;
  L.one_aob = 1.0f - L.ao_blend;
#pragma unroll
  for (int c = 0; c < 3; ++c) L.rad[c] = L.k[c] = 0.0f;

  if (flags & F_DIFFUSE) {
    float sn[3];
    if (bent) load3(bent, i, sn);
    else sn[0] = nn[0], sn[1] = nn[1], sn[2] = nn[2];
    float irr[3];
    sh_irradiance(sn, sh, irr);
    const float one_t = 1.0f - ex[0];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float albedo = one_m * base[c];
      if (lobe) albedo = albedo * one_t;
      const float d = ((albedo * INV_PI) * irr[c]) * 5.0f;
      L.rad[c] = 0.0f + sky * (d * L.one_aob + (L.ao * d) * L.ao_blend);
    }
  }

  if (flags & F_SPECULAR) {
    const float rough = b.pick ? clamp_lo(ex[2], 0.03f) : roughness;
    float ab[2];
    if (flags & F_ANALYTIC)
      env_brdf_analytic(cheb_tab, b.no_v, 1.0f - rough, ab);
    else
      env_brdf_lut(lut, lut_size, flags & F_LUT_PACKED, b.no_v, rough, ab);
    const float one_fc = 1.0f - b.fc;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float f0 = b.pick ? 0.04f : metallic * base[c] + one_m * 0.04f;
      L.k[c] = f0 * ab[0] + ab[1];
      if (lobe) L.rad[c] = L.rad[c] * one_fc;
    }
  }
  return L;
}

// ... and with its probe fetch (or the checkerboard's fill) pre: the
// specular term pre k, the AO blend and the HBAO scale
__device__ __forceinline__ void stochastic_radiance(
    const Lit& L, const float* pre, const float* __restrict__ hbao,
    float sky, int flags, int i, float* rad) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    rad[c] = L.rad[c];
    if (flags & F_SPECULAR) {
      const float spec = pre[c] * L.k[c];
      rad[c] = rad[c] + sky * (spec * L.one_aob + (L.ao * spec) * L.ao_blend);
    }
  }
  if (hbao) {
    const float a = __ldg(hbao + i);
#pragma unroll
    for (int c = 0; c < 3; ++c) rad[c] = rad[c] * a;
  }
}

// K8's stochastic roles without the checkerboard (F_DITHER, with or
// without F_JITTER): the exact role's diffuse lobe, and the specular lobe
// from one dithered mip of the probe (with F_JITTER one texel of its RGBE
// table); with extras one lobe a pixel and frame, the coat lobe with
// probability fc, its env BRDF alone evaluated (the twin evaluates both
// and selects). One thread a pixel, a warp an 8 x 4 tile as
// k8_sky_kernel's.
__global__ void __launch_bounds__(K8_THREADS)
k8_sky_stochastic_kernel(K8S_PARAMS) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x = blockIdx.x * 16 + (warp & 1) * 8 + (lane & 7);
  const int y = blockIdx.y * 8 + (warp >> 1) * 4 + (lane >> 3);
  if (x >= width || y >= height) return;
  const int i = y * width + x;
  float* o = out + 3 * i;
  if (!mask[i]) {
    o[0] = 0.0f;
    o[1] = 0.0f;
    o[2] = 0.0f;
    return;
  }
  const uint32_t px = (uint32_t)x, py = (uint32_t)(row0 + y);
  const bool specular = flags & F_SPECULAR;
  const bool lobe = extras != nullptr;
  float nn[3], vv[3], ex[3] = {0.0f, 0.0f, 0.0f};
  float pre[3] = {0.0f, 0.0f, 0.0f};
  load3(n, i, nn);
  if (lobe) load3(extras, i, ex);
  Lobe b = {0.0f, 0.0f, false};
  if (specular) {
    load3(v, i, vv);
    b = pixel_lobe(nn, vv, ex, lobe, px, py, frame);
    const Tap t = spec_tap(nn, vv, __ldg(mrao + i).y, ex, b,
                           (float)(cube.levels - 1), px, py, frame);
    probe_fetch(cube_flat, (flags & F_JITTER) ? rgbe : nullptr, cube, t, px,
                py, frame, pre);
  }
  const Lit L = stochastic_lit(base_color, mrao, bent, sh, lut, lut_size,
                               sky, flags, cheb_tab, i, nn, ex, lobe, b);
  float rad[3];
  stochastic_radiance(L, pre, hbao, sky, flags, i, rad);
  o[0] = rad[0];
  o[1] = rad[1];
  o[2] = rad[2];
}

// K8's checkerboard roles (F_DITHER | F_CHECKER, with or without
// F_JITTER; an even width), skylight.py:62-125 of the JAX package with
// kernels/checker.py:30-61 (compact and expand): the probe of the
// stochastic roles, fetched by half the pixels. In each horizontal pair
// of a row the pixel of the fetching parity, x & 1 == q = (row0 + y +
// parity) & 1, fetches where it or a horizontal neighbour is covered; a
// covered pixel of the other parity takes the mean of its two
// neighbours' fetches, 0.5 (l + r), edge-clamped at the image's row ends
// (x == 0: l = r; x == width - 1: r = l).
//
// A block takes a span of K8C_PAIRS x-pairs (K8C_SPAN pixels, x0 even)
// in each of K8C_ROWS image rows, with two warps a row. The fetching warp
// takes the pixels x0 + 2 k - q, lane k: the span's K8C_PAIRS fetching
// pixels and the one beyond its end (q = 0: x0 + K8C_SPAN) or before its
// start (q = 1: x0 - 1), the halo, which the neighbouring span fetches as
// well. So every lane of it fetches, in one round (the tile kernel before
// this one alternated fetching and filling lanes in 8-pixel rows, and the
// filling lane at each row's end fetched its outer neighbour in a second
// round of its own: the set-up and fetch twice a warp). A fetching lane
// puts its fetch in shared memory, arrives at the block's named barrier
// without waiting, and shades its own pixel (the halo lane shades
// nothing). The filling warp shades the span's filling pixels, lane l
// the pixel x0 + 2 l + 1 - q: all but the probe term first (the
// env-BRDF fit, which hides the fetch round), then it waits at the
// barrier and takes the mean of the fetching lanes l and l + 1. Each
// pixel's inputs are loaded once, by the lane that shades it. A lane
// past the image's edge keeps zeros; an uncovered pixel writes zeros.
//
// What was measured against it (PERF.md): a fetch round of lanes
// apart from the shading ones loaded the fetching pixels' inputs twice
// and ran slower than the tile kernel fetching every pixel; a warp
// looping over two shading rounds made nvcc hoist the fit's Chebyshev
// coefficients out of the loop and spill them; 2-D spans (7 pairs x 4
// rows, 3 x 8), the inputs or the output staged in shared memory for
// 16-byte words, and register caps for more blocks an SM ran slower.
#define K8C_PAIRS 31
#define K8C_SPAN (2 * K8C_PAIRS)
#define K8C_ROWS 2
#define K8C_THREADS (64 * K8C_ROWS)  // a fetching and a filling warp a row
static_assert(K8C_PAIRS + 1 == 32, "a fetching warp: the pairs and halo");

__global__ void __launch_bounds__(K8C_THREADS)
k8_sky_checker_kernel(K8S_PARAMS) {
  __shared__ float fetched[K8C_ROWS][3][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool filling = warp >= K8C_ROWS;
  const int r = filling ? warp - K8C_ROWS : warp;
  const int x0 = blockIdx.x * K8C_SPAN, y = blockIdx.y * K8C_ROWS + r;
  const int span = min(K8C_SPAN, width - x0);
  const int q = (row0 + y + parity) & 1;
  // this lane's pixel: a fetching one (the halo included) or a filling one
  const int dx = filling ? 2 * lane + 1 - q : 2 * lane - q;
  const int x = x0 + dx;
  const bool in = y < height && x >= 0 && x < width;
  const bool shade = in && dx >= 0 && dx < span;
  const int i = in ? y * width + x : 0;
  const bool cov = in && mask[i];
  const bool specular = flags & F_SPECULAR;
  const bool lobe = extras != nullptr;
  const uint32_t px = (uint32_t)x, py = (uint32_t)(row0 + y);

  float nn[3], vv[3], ex[3] = {0.0f, 0.0f, 0.0f};
  Lobe b = {0.0f, 0.0f, false};
  float pre[3] = {0.0f, 0.0f, 0.0f};
  if (!filling) {
    // the fetch, where the pixel or a horizontal neighbour is covered
    if (specular && in &&
        (cov || (x > 0 && mask[i - 1]) || (x + 1 < width && mask[i + 1]))) {
      load3(n, i, nn);
      load3(v, i, vv);
      if (lobe) load3(extras, i, ex);
      b = pixel_lobe(nn, vv, ex, lobe, px, py, frame);
      const Tap tap = spec_tap(nn, vv, __ldg(mrao + i).y, ex, b,
                               (float)(cube.levels - 1), px, py, frame);
      probe_fetch(cube_flat, (flags & F_JITTER) ? rgbe : nullptr, cube, tap,
                  px, py, frame, pre);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) fetched[r][c][lane] = pre[c];
    // the fetches are out: the filling warps may read them
    asm volatile("bar.arrive 1, %0;" ::"n"(K8C_THREADS) : "memory");
    if (!shade) return;
    if (cov && !specular && !bent) load3(n, i, nn);
    if (cov && !specular && lobe) load3(extras, i, ex);
  } else if (cov) {
    if (specular || !bent) load3(n, i, nn);
    if (lobe) load3(extras, i, ex);
    if (specular) {
      load3(v, i, vv);
      b = pixel_lobe(nn, vv, ex, lobe, px, py, frame);
    }
  }
  Lit L;
  if (cov)
    L = stochastic_lit(base_color, mrao, bent, sh, lut, lut_size, sky, flags,
                       cheb_tab, i, nn, ex, lobe, b);
  if (filling) {
    asm volatile("bar.sync 1, %0;" ::"n"(K8C_THREADS) : "memory");
    if (!shade) return;
    // the mean of the fetching lanes l and l + 1, edge-clamped
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float a = fetched[r][c][lane], e = fetched[r][c][lane + 1];
      if (x == 0) a = e;
      if (x == width - 1) e = a;
      pre[c] = 0.5f * (a + e);
    }
  }
  float rad[3] = {0.0f, 0.0f, 0.0f};
  if (cov) stochastic_radiance(L, pre, hbao, sky, flags, i, rad);
  float* o = out + 3 * i;
  o[0] = rad[0];
  o[1] = rad[1];
  o[2] = rad[2];
}

__global__ void __launch_bounds__(K8_THREADS)
k8_sky_kernel(const float4* __restrict__ base_color,
              const float4* __restrict__ mrao,
              const uint8_t* __restrict__ mask, const float* __restrict__ n,
              const float* __restrict__ v, const float* __restrict__ bent,
              const float* __restrict__ hbao,
              const float* __restrict__ extras, const float* __restrict__ sh,
              const float* __restrict__ cube_flat,
              const float* __restrict__ lut, int lut_size, float sky,
              int flags, const Cube cube, const Cheb cheb_tab,
              float* __restrict__ out, int width, int height) {
  // a warp shades an 8 x 4 tile, a block (2 x 2 warps) a 16 x 8 tile
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x = blockIdx.x * 16 + (warp & 1) * 8 + (lane & 7);
  const int y = blockIdx.y * 8 + (warp >> 1) * 4 + (lane >> 3);
  if (x >= width || y >= height) return;
  const int i = y * width + x;
  float* o = out + 3 * i;
  if (!mask[i]) {
    o[0] = 0.0f;
    o[1] = 0.0f;
    o[2] = 0.0f;
    return;
  }
  const float4 bc = __ldg(base_color + i);
  const float4 mr = __ldg(mrao + i);
  float base[3] = {bc.x, bc.y, bc.z};
  if (flags & F_LIGHTING_ONLY) base[0] = base[1] = base[2] = 0.5f;
  const float metallic = mr.x, roughness = mr.y, ao = mr.z, ao_blend = mr.w;
  const float one_m = 1.0f - metallic;
  const float one_aob = 1.0f - ao_blend;
  float ex[3] = {0.0f, 0.0f, 0.0f};
  if (extras) {
    ex[0] = __ldg(extras + 3 * i);
    ex[1] = __ldg(extras + 3 * i + 1);
    ex[2] = __ldg(extras + 3 * i + 2);
  }
  float nn[3] = {__ldg(n + 3 * i), __ldg(n + 3 * i + 1), __ldg(n + 3 * i + 2)};
  float rad[3] = {0.0f, 0.0f, 0.0f};

  if (flags & F_DIFFUSE) {
    float sn[3] = {nn[0], nn[1], nn[2]};
    if (bent) {
      sn[0] = __ldg(bent + 3 * i);
      sn[1] = __ldg(bent + 3 * i + 1);
      sn[2] = __ldg(bent + 3 * i + 2);
    }
    float irr[3];
    sh_irradiance(sn, sh, irr);
    const float one_t = 1.0f - ex[0];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float albedo = one_m * base[c];
      if (extras) albedo = albedo * one_t;
      const float d = ((albedo * INV_PI) * irr[c]) * 5.0f;
      rad[c] = 0.0f + sky * (d * one_aob + (ao * d) * ao_blend);
    }
  }

  if (flags & F_SPECULAR) {
    const float vv[3] = {__ldg(v + 3 * i), __ldg(v + 3 * i + 1),
                         __ldg(v + 3 * i + 2)};
    const float no_v = clamp_lo(dot3(nn, vv), 0.01f);
    const float vn2 = 2.0f * dot3(vv, nn);
    float r[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) r[c] = vn2 * nn[c] - vv[c];
    const float inv = 1.0f / sqrtf(dot3(r, r) + 1e-20f);
#pragma unroll
    for (int c = 0; c < 3; ++c) r[c] = r[c] * inv;
    int face;
    float fu, fv;
    face_uv(r, face, fu, fv);
    const float mips1 = (float)(cube.levels - 1);
    const bool analytic = flags & F_ANALYTIC;
    const bool packed_lut = flags & F_LUT_PACKED;

    float pre[3], ab[2];
    sample_cube(cube_flat, cube, face, fu, fv, roughness * mips1, pre);
    if (analytic) env_brdf_analytic(cheb_tab, no_v, 1.0f - roughness, ab);
    else env_brdf_lut(lut, lut_size, packed_lut, no_v, roughness, ab);
    float spec[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float f0 = metallic * base[c] + one_m * 0.04f;
      spec[c] = pre[c] * (f0 * ab[0] + ab[1]);
    }
    if (extras) {
      const float cc = ex[1];
      const float ccr = clamp_lo(ex[2], 0.03f);
      // shading.f_schlick(NoV, 0.04) x cc, (1 - u)^5 as mathutils.ipow
      const float x = 1.0f - no_v;
      const float x2 = x * x;
      const float f = x * (x2 * x2);
      const float fc = (f + 0.04f * (1.0f - f)) * cc;
      float pre_cc[3], ab_cc[2];
      sample_cube(cube_flat, cube, face, fu, fv, ccr * mips1, pre_cc);
      if (analytic) env_brdf_analytic(cheb_tab, no_v, 1.0f - ccr, ab_cc);
      else env_brdf_lut(lut, lut_size, packed_lut, no_v, ccr, ab_cc);
      const float k_cc = 0.04f * ab_cc[0] + ab_cc[1];
      const float one_fc = 1.0f - fc;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        spec[c] = spec[c] * one_fc + (pre_cc[c] * k_cc) * fc;
        rad[c] = rad[c] * one_fc;
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c)
      rad[c] = rad[c] + sky * (spec[c] * one_aob + (ao * spec[c]) * ao_blend);
  }
  if (hbao) {
    const float a = __ldg(hbao + i);
#pragma unroll
    for (int c = 0; c < 3; ++c) rad[c] = rad[c] * a;
  }
  o[0] = rad[0];
  o[1] = rad[1];
  o[2] = rad[2];
}

// levels: the cube's bases then its sizes, n_levels each (host memory);
// cheb: CHEB_A then CHEB_B, 512 floats (host memory), needed with
// F_ANALYTIC and F_SPECULAR. The stochastic roles (F_DITHER): rgbe, the
// cube's RGBE words (F_JITTER); frame, the frame index that seeds the
// noise; parity (F_CHECKER) and row0, the band's first row in the frame.
extern "C" int k8_sky_lighting(const float* base_color, const float* mrao,
                               const uint8_t* mask, const float* n,
                               const float* v, const float* bent,
                               const float* hbao, const float* extras,
                               const float* sh, const float* cube_flat,
                               int cube_rows, const int* levels, int n_levels,
                               int cube_packed, const float* lut, int lut_size,
                               const float* cheb, float sky_brightness,
                               int flags, float* out, int width, int height,
                               const uint32_t* rgbe, int frame, int parity,
                               int row0, void* stream) {
  if (width < 0 || height < 0 || n_levels < 1 || n_levels > MAX_LEVELS ||
      !levels || row0 < 0 || (flags & ~255))
    return (int)cudaErrorInvalidValue;
  // the stochastic roles: the jittered texel reads the RGBE table, the
  // checkerboard needs an even width, both need the dithered mip
  const bool dither = flags & F_DITHER;
  if ((flags & (F_JITTER | F_CHECKER)) && !dither)
    return (int)cudaErrorInvalidValue;
  if (((flags & F_JITTER) && !rgbe) || ((flags & F_CHECKER) && (width & 1)))
    return (int)cudaErrorInvalidValue;
  // base colour and mrao load as 16-byte rows, the packed LUT as two
  // 16-byte words, the raw LUT as 8-byte pairs
  if (((uintptr_t)base_color | (uintptr_t)mrao) & 15u)
    return (int)cudaErrorInvalidValue;
  const bool specular = flags & F_SPECULAR;
  if (specular && (flags & F_ANALYTIC) && !cheb)
    return (int)cudaErrorInvalidValue;
  if (specular && !(flags & F_ANALYTIC) &&
      (!lut || lut_size < 1 ||
       ((uintptr_t)lut & ((flags & F_LUT_PACKED) ? 15u : 7u))))
    return (int)cudaErrorInvalidValue;
  Cube cube;
  cube.levels = n_levels;
  cube.packed = cube_packed;
  for (int l = 0; l < n_levels; ++l) {
    cube.base[l] = levels[l];
    cube.size[l] = levels[n_levels + l];
    // every texel of the level lies inside the table
    if (cube.base[l] < 0 || cube.size[l] < 1 ||
        (long long)cube.base[l] + 6LL * cube.size[l] * cube.size[l] >
            (long long)cube_rows)
      return (int)cudaErrorInvalidValue;
  }
  for (int l = n_levels; l < MAX_LEVELS; ++l) cube.base[l] = cube.size[l] = 0;
  Cheb tab;
  for (int k = 0; k < CHEB_N * CHEB_N; ++k) {
    tab.a[k] = cheb ? cheb[k] : 0.0f;
    tab.b[k] = cheb ? cheb[CHEB_N * CHEB_N + k] : 0.0f;
  }
  if (width == 0 || height == 0) return (int)cudaSuccess;
  const dim3 blocks((width + 15) / 16, (height + 7) / 8);
  const float4* bc4 = reinterpret_cast<const float4*>(base_color);
  const float4* mr4 = reinterpret_cast<const float4*>(mrao);
  if (flags & F_CHECKER) {
    const dim3 spans((width + K8C_SPAN - 1) / K8C_SPAN,
                     (height + K8C_ROWS - 1) / K8C_ROWS);
    k8_sky_checker_kernel<<<spans, K8C_THREADS, 0, (cudaStream_t)stream>>>(
        bc4, mr4, mask, n, v, bent, hbao, extras, sh, cube_flat, rgbe, lut,
        lut_size, sky_brightness, flags, cube, tab, out, width, height,
        (uint32_t)frame, parity & 1, row0);
  } else if (dither)
    k8_sky_stochastic_kernel<<<blocks, K8_THREADS, 0,
                               (cudaStream_t)stream>>>(
        bc4, mr4, mask, n, v, bent, hbao, extras, sh, cube_flat, rgbe, lut,
        lut_size, sky_brightness, flags, cube, tab, out, width, height,
        (uint32_t)frame, parity & 1, row0);
  else
    k8_sky_kernel<<<blocks, K8_THREADS, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(base_color),
        reinterpret_cast<const float4*>(mrao), mask, n, v, bent, hbao, extras,
        sh, cube_flat, lut, lut_size, sky_brightness, flags, cube, tab, out,
        width, height);
  return (int)cudaGetLastError();
}

// K12: the sky background, environment_background's dynamic-sky role.
//
// It replaces no Pallas kernel: the JAX package writes this pass in jnp
// (incarnation_tpu/kernels/skylight.py environment_background :159-177,
// with kernels/sky.py sky_radiance :95-107), and its frame adds it to the
// HDR (renderer/frame.py:397). Its torch twin (kernels/skylight.py
// environment_background_plain) evaluates the Preetham sky at every pixel
// of the frame in about 60 full-frame elementwise passes, masks out the
// covered ones and adds the result to the HDR; here it is one launch.
//
// Each pixel (x, y) not covered by geometry gets 1000 x Preetham radiance
// along its view ray: the pixel centre at reverse-Z depth 1e-4 through the
// inverse view-projection (a device pointer), minus the eye, normalized;
// theta = acos(clamp(d.y)), gamma = acos(clamp(d . sun)), the Perez
// function of both over its value at the zenith, times the zenith's Yxy,
// to RGB. A covered pixel's background is +0.0 (the twin's
// torch.where(mask, 0, radiance)).
//
// Roles: the background alone (hdr NULL: a covered pixel writes +0.0),
// and the accumulate role the frame takes, which reads the (H, W, 3) HDR
// and writes hdr + background to a new tensor (never in place: the HDR
// may be the gbuffer's emissive plane): an uncovered pixel hdr + rad, a
// covered one hdr + 0.0f, so a -0.0 becomes +0.0 and a NaN stays NaN, as
// the twin's add.
//
// The per-frame values (theta_s = acos(clamp(sun.y)), the zenith Yxy,
// Perez(0, theta_s)), the Perez coefficients, the inverse view-projection,
// the eye and the sun are functions of the sun direction and the matrices
// (device pointers) and the turbidity (by value, as a double): one thread
// of each block forms them, in the twin's order, from the same double
// expressions the twin's Python evaluates (sky.py perez_coefficients,
// _zenith_yxy) rounded to float as torch rounds a Python scalar, into
// shared memory behind one barrier, so no table is copied from host
// memory and every thread reads the same bits. The blocks are persistent
// (as many as fit on the card at once), each walking tiles a grid apart,
// so that work is done once a block.
//
// Arithmetic: every operation is the twin's, in the twin's order
// (--fmad=false): the 4x4 product and the XYZ -> RGB product are sums left
// to right (mathutils.rows_mat), the dot products mathutils.dot3, each
// division by a Python number (the width and height) a multiplication by
// its float reciprocal as torch does it on the card; acosf, cosf, expf,
// tanf and sqrtf are the functions torch calls; clamp propagates a NaN as
// torch's does. So K12 equals its twin bit for bit.
//
// What bounds it: by the count of operations, bytes. The accumulate role
// reads the 1-byte mask and the 12-byte HDR and writes 12 bytes of every
// pixel (52.2 MB at 1920 x 1088, 0.0156 ms at 3.35 TB/s); the uncovered
// pixels' Preetham chain is 134 float operations a pixel, each
// transcendental counted one (chip_smoke.py K12_OPS_PER_SKY). In
// instructions it costs more: 11 IEEE divisions, two acosf, two cosf and
// six expf, several hundred a pixel. So each pixel's cos(theta),
// cos(gamma) and Y / y are taken once (the twin's values, 15% faster than
// once a channel), and the HDR's loads start before the mask test
// (0.0267 against 0.0303 ms after it); writing a tile's output through
// shared memory (0.0340 against 0.0264 ms), four pixels a thread with one
// 4-byte mask load (0.0358 against 0.0268), two tiles a thread's
// iteration (0.0263, no faster than the loads first) and a tile's sky
// pixels handed to whole warps by a ballot and a prefix sum (0.0337
// against 0.0297) were slower or no faster (PERF.md).

#define K12_TILE_W 32
#define K12_TILE_H 8
#define K12_THREADS (K12_TILE_W * K12_TILE_H)

__device__ __forceinline__ float k12_clamp(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float k12_clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

// sky.py _perez of one channel: (1 + A e^(B / cos_t)) (1 + C e^(D g) +
// E cos(g)^2), given cos_t = max(cos(theta), 1e-5) and cos(g), which the
// three channels share
__device__ __forceinline__ float k12_perez(float cos_t, float gamma,
                                           float cg, float a, float b,
                                           float c, float d, float e) {
  return (1.0f + a * expf(b / cos_t)) *
         ((1.0f + c * expf(d * gamma)) + (e * cg) * cg);
}

// the per-frame values every pixel reads
struct K12Frame {
  float pa[3], pb[3], pc[3], pd[3], pe[3];  // the Perez coefficients
  float zen[3];                             // the zenith's Yxy
  float f0[3];                              // Perez(0, theta_s)
  float m[16];                              // the inverse view-projection
  float eye[3], sun[3];
  float inv_w, inv_h;
};

// K12Frame's values, as the twin forms them
__device__ void k12_frame(K12Frame& f, const float* __restrict__ eye,
                          const float* __restrict__ ivp,
                          const float* __restrict__ sun, double t,
                          int width, int height) {
  // the Perez coefficients (sky.py perez_coefficients), the float of each
  // double expression
  f.pa[0] = (float)(0.1787 * t - 1.4630);
  f.pa[1] = (float)(-0.0193 * t - 0.2592);
  f.pa[2] = (float)(-0.0167 * t - 0.2608);
  f.pb[0] = (float)(-0.3554 * t + 0.4275);
  f.pb[1] = (float)(-0.0665 * t + 0.0008);
  f.pb[2] = (float)(-0.0950 * t + 0.0092);
  f.pc[0] = (float)(-0.0227 * t + 5.3251);
  f.pc[1] = (float)(-0.0004 * t + 0.2125);
  f.pc[2] = (float)(-0.0079 * t + 0.2102);
  f.pd[0] = (float)(0.1206 * t - 2.5771);
  f.pd[1] = (float)(-0.0641 * t - 0.8989);
  f.pd[2] = (float)(-0.0441 * t - 1.6537);
  f.pe[0] = (float)(-0.0670 * t + 0.3703);
  f.pe[1] = (float)(-0.0033 * t + 0.0452);
  f.pe[2] = (float)(-0.0109 * t + 0.0529);
  const float sy = __ldg(sun + 1);
  // the zenith (sky.py _zenith_yxy), t a float where the twin multiplies
  // a tensor by it
  const float tf = (float)t;
  const float ths = acosf(k12_clamp(sy, 0.0f, 1.0f));
  const float chi = (float)(4.0 / 9.0 - t / 120.0) *
                    ((float)3.141592653589793 - 2.0f * ths);
  const float zen_y = (((float)(4.0453 * t - 4.9710) * tanf(chi)) -
                       (float)(0.2155 * t)) + (float)2.4192;
  const float th = ths, th2 = ths * ths, th3 = th2 * ths;
  const float zen_x =
      (((((float)0.00165 * th3 - (float)0.00375 * th2) +
         (float)0.00209 * th) * tf) * tf +
       (((((float)-0.02903 * th3 + (float)0.06377 * th2) -
          (float)0.03202 * th) + (float)0.00394) * tf)) +
      ((((float)0.11693 * th3 - (float)0.21196 * th2) +
        (float)0.06052 * th) + (float)0.25886);
  const float zen_z =
      (((((float)0.00275 * th3 - (float)0.00610 * th2) +
         (float)0.00317 * th) * tf) * tf +
       (((((float)-0.04214 * th3 + (float)0.08970 * th2) -
          (float)0.04153 * th) + (float)0.00516) * tf)) +
      ((((float)0.15346 * th3 - (float)0.26756 * th2) +
        (float)0.06670 * th) + (float)0.26688);
  f.zen[0] = zen_y;
  f.zen[1] = zen_x;
  f.zen[2] = zen_z;
#pragma unroll
  for (int c = 0; c < 3; ++c)
    f.f0[c] = k12_perez(k12_clamp_min(cosf(0.0f), (float)1e-5), ths,
                        cosf(ths), f.pa[c], f.pb[c], f.pc[c], f.pd[c],
                        f.pe[c]);
#pragma unroll
  for (int i = 0; i < 16; ++i) f.m[i] = __ldg(ivp + i);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    f.eye[k] = __ldg(eye + k);
    f.sun[k] = __ldg(sun + k);
  }
  f.inv_w = 1.0f / (float)width;
  f.inv_h = 1.0f / (float)height;
}

// 1000 x Preetham radiance along the view ray of pixel (x, y)
__device__ __forceinline__ void k12_sky(const K12Frame& f, int x, int y,
                                        float (&o)[3]) {
  // the view ray (environment_background_plain): NDC of the pixel centre
  // at depth 1e-4, through the inverse view-projection
  const float n0 = 2.0f * ((float)x + 0.5f) * f.inv_w - 1.0f;
  const float n1 = -2.0f * ((float)y + 0.5f) * f.inv_h + 1.0f;
  const float n2 = (float)1e-4;
  float w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    w[j] = ((n0 * f.m[j] + n1 * f.m[4 + j]) + n2 * f.m[8 + j]) +
           1.0f * f.m[12 + j];
  const float den = fabsf(w[3]) > (float)1e-20 ? w[3] : 1.0f;
  const float vx = w[0] / den - f.eye[0], vy = w[1] / den - f.eye[1],
              vz = w[2] / den - f.eye[2];
  const float rn =
      1.0f / sqrtf(((vx * vx + vy * vy) + vz * vz) + (float)1e-20);
  const float dx = vx * rn, dy = vy * rn, dz = vz * rn;
  // sky.py sky_radiance
  const float theta = acosf(k12_clamp(dy, 0.0f, 1.0f));
  const float gamma = acosf(k12_clamp(
      (dx * f.sun[0] + dy * f.sun[1]) + dz * f.sun[2], 0.0f, 1.0f));
  const float cos_t = k12_clamp_min(cosf(theta), (float)1e-5);
  const float cg = cosf(gamma);
  float yxy[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    yxy[c] = f.zen[c] * (k12_perez(cos_t, gamma, cg, f.pa[c], f.pb[c],
                                   f.pc[c], f.pd[c], f.pe[c]) / f.f0[c]);
  // sky.py _yxy_to_rgb, row k of _XYZ2RGB the weights of X, Y, Z
  const float rgb[3][3] = {
      {(float)3.2404542, (float)-0.9692660, (float)0.0556434},
      {(float)-1.5371385, (float)1.8760108, (float)-0.2040259},
      {(float)-0.4985314, (float)0.0415560, (float)1.0572252}};
  const float yl = yxy[0], cx = yxy[1];
  const float cy = k12_clamp_min(yxy[2], (float)1e-6);
  const float q = yl / cy;
  const float big_x = cx * q;
  const float big_z = ((1.0f - cx) - cy) * q;
#pragma unroll
  for (int j = 0; j < 3; ++j)
    o[j] = 1000.0f *
           ((big_x * rgb[0][j] + yl * rgb[1][j]) + big_z * rgb[2][j]);
}

__global__ void __launch_bounds__(K12_THREADS)
k12_sky_background_kernel(const uint8_t* __restrict__ mask,  // (H, W)
                          const float* __restrict__ eye,     // (3,)
                          const float* __restrict__ ivp,     // (4, 4)
                          const float* __restrict__ sun,     // (3,)
                          double t, int width, int height,
                          const float* __restrict__ hdr,     // or NULL
                          float* __restrict__ out) {          // (H, W, 3)
  __shared__ K12Frame f;
  if (threadIdx.x == 0) k12_frame(f, eye, ivp, sun, t, width, height);
  __syncthreads();
  const int tiles_x = (width + K12_TILE_W - 1) / K12_TILE_W;
  const int tiles = tiles_x * ((height + K12_TILE_H - 1) / K12_TILE_H);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int x = (tile % tiles_x) * K12_TILE_W + (threadIdx.x % K12_TILE_W);
    const int y = (tile / tiles_x) * K12_TILE_H + (threadIdx.x / K12_TILE_W);
    if (x >= width || y >= height) continue;
    const size_t i = (size_t)y * width + x;
    // the HDR's loads first, in flight through the mask test and the sky
    float h[3] = {0.0f, 0.0f, 0.0f};
    if (hdr) {
#pragma unroll
      for (int k = 0; k < 3; ++k) h[k] = __ldg(hdr + 3 * i + k);
    }
    float o[3] = {0.0f, 0.0f, 0.0f};
    if (!mask[i]) k12_sky(f, x, y, o);
    if (hdr) {
      // torch's hdr + background: +0.0 where covered
#pragma unroll
      for (int k = 0; k < 3; ++k) o[k] = h[k] + o[k];
    }
    out[3 * i] = o[0];
    out[3 * i + 1] = o[1];
    out[3 * i + 2] = o[2];
  }
}

extern "C" int k12_sky_background(const uint8_t* mask, const float* eye,
                                  const float* ivp, const float* sun,
                                  double turbidity, int width, int height,
                                  const float* hdr, float* out,
                                  void* stream) {
  if (width < 0 || height < 0) return (int)cudaErrorInvalidValue;
  if (width == 0 || height == 0) return (int)cudaSuccess;
  static int grid = 0;  // persistent blocks: as many as fit at once
  if (grid == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, k12_sky_background_kernel, K12_THREADS, 0);
    if (e != cudaSuccess) return (int)e;
    grid = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long tiles =
      (long long)((width + K12_TILE_W - 1) / K12_TILE_W) *
      ((height + K12_TILE_H - 1) / K12_TILE_H);
  const int blocks = tiles < grid ? (int)tiles : grid;
  k12_sky_background_kernel<<<blocks, K12_THREADS, 0,
                              (cudaStream_t)stream>>>(
      mask, eye, ivp, sun, turbidity, width, height, hdr, out);
  return (int)cudaGetLastError();
}
