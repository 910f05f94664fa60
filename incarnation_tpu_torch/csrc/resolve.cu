// K5: material resolve into the GBuffer. K6: the masked layers' alpha test.
//
// Neither replaces a Pallas kernel: the JAX package writes both in jnp
// (incarnation_tpu/kernels/resolve.py resolve_gbuffer :242-376 and
// masked_alpha :107-181, exact paths, with scene/textures.py
// sample_material_stack :970 and sample_stack_alpha :1016). In the port
// their torch twins (kernels/resolve.py resolve_gbuffer_plain and
// masked_alpha_plain) launch about 3,000 small kernels per call, most of
// the raster frame's time, so each is one kernel here.
//
// K5, one thread per pixel: the TBN basis from the 16 interp channels,
// the LOD from the analytic UV derivatives, two bilinear levels of the
// block-compressed material stack (8 core words and 6 extras words per 4x4
// block, the twin's _fetch_texel) blended by the LOD's fraction, sRGB
// decode, the mat_params factors and the normal mapping, world_from_depth
// through inv_view_proj, and the packed GBuffer planes (base + opacity,
// octahedral normal, mrao, emissive x 20000, world position, uv, extras,
// mask), zero where tri < 0 (uv everywhere); optionally the unencoded
// mapped normal. A covered pixel reads 4 texels of 2 levels, 14 words
// each; an empty pixel reads its tri and uv and writes zeros.
//
// K6, one thread per pixel of a peel: the LOD capped at half an amask
// cell, one bilinear level of the u8 alpha mirror, alpha = mat_params[6]
// x a_tex, and the pass threshold: alphaCutoff, or for BLEND the
// screen-door hash of the pixel's whole-frame position (row0: a band's
// first row), at least 1e-3. Like the twin it computes every pixel, hit or
// not.
//
// Arithmetic: every operation is the twin's, in the twin's order, built
// --fmad=false (kernels/build.py), and every constant is the float the
// twin's Python scalar rounds to. Where torch on the card divides by a
// Python number it multiplies by the scalar's float reciprocal, and so do
// these kernels; torch.sum of a row of three adds (x + z) + y there (the
// octahedral encoding's L1 norm), and so does K5. What K5 cannot follow is
// torch.cross and torch.matmul (world_from_depth), which round in their
// own order (fused multiply-adds, cuBLAS): K5 adds left to right, and its
// floats agree with the twin to a tolerance (chip_smoke.py K5_RTOL), the
// mask exactly. K6 follows the twin operation for operation (sqrt and
// log2 are the same libdevice functions), so its alpha and threshold are
// expected to equal the twin's bit for bit, and its pass/fail decisions
// must.
//
// What bounds them: bytes. K5 reads tri and uv for every pixel, 13 more
// floats for a covered one, and each texture block it touches; it writes
// 85 B a pixel (97 with the mapped normal): at 1920x1088 about 0.09 ms at
// 3.35 TB/s, against 859-1,123 float operations a covered pixel (about
// 0.03 ms at 67 TFLOP/s; chip_smoke.py counts both). K6 reads 7 interp
// channels and writes 8 B a pixel, ~0.02 ms. Design for now: simple and right, one thread per pixel, no shared
// memory; the texel gathers are dependent (meta row, then block words,
// then the bit unpack) and served by L1/L2.

#include <cuda_runtime.h>
#include <stdint.h>

#define RS_THREADS 256

// interp channels (kernels/raster.py INTERP_CHANNELS layout)
#define CH_U 0
#define CH_V 1
#define CH_WN 2
#define CH_WT 5
#define CH_SIGN 8
#define CH_MAT 9
#define CH_DUDX 10
#define CH_DUDY 11
#define CH_DVDX 12
#define CH_DVDY 13

#define META_COLS 6
#define PARAM_COLS 16
#define CORE_WORDS 8
#define EXTRA_WORDS 6
#define ALPHA_WORDS 4
#define ADDRESS_WRAP 0
#define ADDRESS_CLAMP 1
#define AMASK_CELLS 32
#define NCH 14  // stack channels K5 reads: core 8 + extras 6

// torch.maximum / minimum / clamp propagate a NaN; fmaxf would drop it
__device__ __forceinline__ float tmax(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fmaxf(a, b);
}
__device__ __forceinline__ float tmin(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fminf(a, b);
}
__device__ __forceinline__ float clamp_lo(float x, float lo) {
  return x < lo ? lo : x;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// torch.remainder on ints: the result takes the divisor's sign
__device__ __forceinline__ int pymod(int a, int n) {
  const int r = a % n;
  return r < 0 ? r + n : r;
}

// textures.py _address
__device__ __forceinline__ int address(int c, int n, int mode) {
  if (mode == ADDRESS_WRAP) return pymod(c, n);
  if (mode == ADDRESS_CLAMP) return min(max(c, 0), n - 1);
  const int p = pymod(c, 2 * n);
  return p < n ? p : 2 * n - 1 - p;
}

// textures.py _level_offset_blocks: block offset of mip `level`
__device__ __forceinline__ int level_offset_blocks(int size, int levels,
                                                   int level) {
  const int s4 = max(size >> 2, 1);
  const int l4max = max(levels - 3, 0);
  const int lc = min(level, l4max);
  const int sl4 = max(s4 >> lc, 1);
  return (4 * s4 * s4 - 4 * sl4 * sl4) / 3 + max(level - l4max, 0);
}

// textures.py _level_offset: texel offset of mip `level` (alpha mirror)
__device__ __forceinline__ int level_offset_texels(int size, int level) {
  const int sl = size >> level;
  return (4 * size * size - 4 * sl * sl) / 3;
}

__device__ __forceinline__ float u8f(uint32_t w, int sh) {
  return (float)((w >> sh) & 0xFFu) * (float)(1.0 / 255.0);
}

__device__ __forceinline__ float sel3(uint32_t w, int sh) {
  return (float)((w >> sh) & 3u) * (float)(1.0 / 3.0);
}

__device__ __forceinline__ void dec565(uint32_t c, float* o) {
  o[0] = (float)(c & 31u) * (float)(1.0 / 31.0);
  o[1] = (float)((c >> 5) & 63u) * (float)(1.0 / 63.0);
  o[2] = (float)((c >> 11) & 31u) * (float)(1.0 / 31.0);
}

__device__ __forceinline__ float lerp(float a, float b, float f) {
  return a + (b - a) * f;
}

struct Stack {
  const uint32_t* flat;    // (n_flat, 8) core blocks
  const uint32_t* extra;   // (n_extra, 6) extras blocks; n_extra <= 1: none
  int n_flat, n_extra;
};

// textures.py _fetch_texel: channels 0-13 of texel (x, y) of the mip whose
// blocks start at `base` (extras at `ebase`, -1 = none), size s
__device__ __forceinline__ void fetch_texel(const Stack& st, int base,
                                            int ebase, int x, int y, int s,
                                            float* o) {
  const int s4 = max(s >> 2, 1);
  const int brel = (y >> 2) * s4 + (x >> 2);
  const int sh = (((y & 3) << 2) | (x & 3)) << 1;
  const uint4* wp = reinterpret_cast<const uint4*>(
      st.flat + (size_t)CORE_WORDS * clampi(base + brel, 0, st.n_flat - 1));
  const uint4 lo = __ldg(wp), hi = __ldg(wp + 1);
  float c0[3], c1[3];
  dec565(lo.x & 0xFFFFu, c0);
  dec565((lo.x >> 16) & 0xFFFFu, c1);
  const float fb = sel3(lo.y, sh);
#pragma unroll
  for (int k = 0; k < 3; ++k) o[k] = lerp(c0[k], c1[k], fb);
  o[3] = lerp(u8f(lo.z, 0), u8f(lo.z, 8), sel3(hi.y, sh));
  const float fn = sel3(hi.z, sh);
  o[4] = lerp(u8f(lo.z, 16), u8f(lo.w, 0), fn);
  o[5] = lerp(u8f(lo.z, 24), u8f(lo.w, 8), fn);
  const float fm = sel3(hi.w, sh);
  o[6] = lerp(u8f(lo.w, 16), u8f(hi.x, 0), fm);
  o[7] = lerp(u8f(lo.w, 24), u8f(hi.x, 8), fm);
  if (st.n_extra <= 1 || ebase < 0) {
#pragma unroll
    for (int k = 8; k < NCH; ++k) o[k] = 1.0f;
    return;
  }
  const uint32_t* e = st.extra + (size_t)EXTRA_WORDS *
      clampi(max(ebase, 0) + brel, 0, st.n_extra - 1);
  const uint32_t e0w = __ldg(e), e1w = __ldg(e + 1), e2w = __ldg(e + 2),
                 e3w = __ldg(e + 3), e4w = __ldg(e + 4), e5w = __ldg(e + 5);
  dec565(e0w & 0xFFFFu, c0);
  dec565((e0w >> 16) & 0xFFFFu, c1);
  const float fe = sel3(e1w, sh);
#pragma unroll
  for (int k = 0; k < 3; ++k) o[8 + k] = lerp(c0[k], c1[k], fe);
  o[11] = lerp(u8f(e2w, 0), u8f(e2w, 8), sel3(e4w, sh));
  const float ftc = sel3(e5w, sh);
  o[12] = lerp(u8f(e2w, 16), u8f(e3w, 0), ftc);
  o[13] = lerp(u8f(e2w, 24), u8f(e3w, 8), ftc);
}

// textures.py _stack_bilinear, accumulated as acc += w * bilinear: the
// twin's top = f00 (1 - tx) + f10 tx, bot likewise, top (1 - ty) + bot ty,
// then scaled by the level's trilinear weight w and added to acc (first:
// acc = that product, as out0 (1 - frac) is the first term of the sum)
__device__ __forceinline__ void bilinear_level(const Stack& st, int base,
                                               int ebase, int s, float u,
                                               float v, int mode, float w,
                                               bool first, float* acc) {
  const float sf = (float)s;
  const float fx = u * sf - 0.5f;
  const float fy = v * sf - 0.5f;
  const int x0 = (int)floorf(fx);
  const int y0 = (int)floorf(fy);
  const float tx = fx - (float)x0;
  const float ty = fy - (float)y0;
  const float omtx = 1.0f - tx, omty = 1.0f - ty;
  const int xa = address(x0, s, mode), xb = address(x0 + 1, s, mode);
  const int ya = address(y0, s, mode), yb = address(y0 + 1, s, mode);
  float top[NCH], bot[NCH], f[NCH];
  fetch_texel(st, base, ebase, xa, ya, s, f);
#pragma unroll
  for (int k = 0; k < NCH; ++k) top[k] = f[k] * omtx;
  fetch_texel(st, base, ebase, xb, ya, s, f);
#pragma unroll
  for (int k = 0; k < NCH; ++k) top[k] = top[k] + f[k] * tx;
  fetch_texel(st, base, ebase, xa, yb, s, f);
#pragma unroll
  for (int k = 0; k < NCH; ++k) bot[k] = f[k] * omtx;
  fetch_texel(st, base, ebase, xb, yb, s, f);
#pragma unroll
  for (int k = 0; k < NCH; ++k) {
    bot[k] = bot[k] + f[k] * tx;
    const float b = top[k] * omty + bot[k] * ty;
    acc[k] = first ? b * w : acc[k] + b * w;
  }
}

// resolve.py _interp_lod: the mip level of the analytic UV footprint
__device__ __forceinline__ float interp_lod(const float* interp, size_t i,
                                            size_t plane, int size) {
  const float dudx = interp[CH_DUDX * plane + i];
  const float dudy = interp[CH_DUDY * plane + i];
  const float dvdx = interp[CH_DVDX * plane + i];
  const float dvdy = interp[CH_DVDY * plane + i];
  const float rho = tmax(sqrtf(dudx * dudx + dvdx * dvdx),
                         sqrtf(dudy * dudy + dvdy * dvdy)) * (float)size;
  return log2f(clamp_lo(rho, (float)1e-8));
}

// textures.srgb_to_linear; the two divisions by Python numbers are torch's
// multiplications by their float reciprocals on the card
__device__ __forceinline__ float srgb_to_linear(float c) {
  c = fminf(fmaxf(c, 0.0f), 1.0f);
  return c <= (float)0.04045
             ? c * (1.0f / (float)12.92)
             : powf((c + (float)0.055) * (1.0f / (float)1.055), (float)2.4);
}

// mathutils.normalize: v (1 / sqrt(dot3(v, v) + 1e-20)), dot3 left to right
__device__ __forceinline__ void normalize3(float* v) {
  const float s = (v[0] * v[0] + v[1] * v[1]) + v[2] * v[2];
  const float inv = 1.0f / sqrtf(s + (float)1e-20);
  v[0] = v[0] * inv;
  v[1] = v[1] * inv;
  v[2] = v[2] * inv;
}

__global__ void __launch_bounds__(RS_THREADS)
k5_resolve_kernel(const int* __restrict__ tri, const float* __restrict__ depth,
                  const float* __restrict__ interp,
                  const float* __restrict__ ivp, Stack st,
                  const int* __restrict__ meta, int n_meta,
                  const float* __restrict__ params, int n_params,
                  float* __restrict__ base_out, float* __restrict__ nrm_out,
                  float* __restrict__ mrao_out, float* __restrict__ emis_out,
                  uint8_t* __restrict__ mask_out,
                  float* __restrict__ wpos_out, float* __restrict__ uv_out,
                  float* __restrict__ extras_out, float* __restrict__ n3_out,
                  int width, int height) {
  const int i = blockIdx.x * RS_THREADS + threadIdx.x;
  if (i >= width * height) return;
  const size_t plane = (size_t)width * height;
  const float u = interp[CH_U * plane + i];
  const float v = interp[CH_V * plane + i];
  uv_out[2 * i] = u;
  uv_out[2 * i + 1] = v;
  const bool covered = tri[i] >= 0;
  mask_out[i] = covered ? 1 : 0;
  if (!covered) {
#pragma unroll
    for (int k = 0; k < 4; ++k) base_out[4 * i + k] = 0.0f;
    nrm_out[2 * i] = 0.0f;
    nrm_out[2 * i + 1] = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) mrao_out[4 * i + k] = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      emis_out[3 * i + k] = 0.0f;
      wpos_out[3 * i + k] = 0.0f;
      extras_out[3 * i + k] = 0.0f;
      if (n3_out) n3_out[3 * i + k] = 0.0f;
    }
    return;
  }

  // the TBN basis
  float n[3], t[3], b[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    n[k] = interp[(CH_WN + k) * plane + i];
    t[k] = interp[(CH_WT + k) * plane + i];
  }
  normalize3(n);
  normalize3(t);
  const float sign = interp[CH_SIGN * plane + i];
  b[0] = (n[1] * t[2] - n[2] * t[1]) * sign;
  b[1] = (n[2] * t[0] - n[0] * t[2]) * sign;
  b[2] = (n[0] * t[1] - n[1] * t[0]) * sign;
  normalize3(b);

  // the material and its trilinear stack fetch (sample_material_stack)
  const int mat = (int)interp[CH_MAT * plane + i];
  const int* m = meta + (size_t)META_COLS * clampi(mat, 0, n_meta - 1);
  const int mbase = m[0], size = m[1], levels = m[2], mode = m[3];
  const int ebase = m[4];
  float lod = interp_lod(interp, i, plane, size);
  lod = tmin(clamp_lo(lod, 0.0f), (float)(levels - 1));
  const int l0 = (int)floorf(lod);
  const int l1 = min(l0 + 1, levels - 1);
  const float frac = lod - (float)l0;
  float ch[NCH];
  const int off0 = level_offset_blocks(size, levels, l0);
  bilinear_level(st, mbase + off0, ebase >= 0 ? ebase + off0 : -1,
                 max(size >> l0, 1), u, v, mode, 1.0f - frac, true, ch);
  const int off1 = level_offset_blocks(size, levels, l1);
  bilinear_level(st, mbase + off1, ebase >= 0 ? ebase + off1 : -1,
                 max(size >> l1, 1), u, v, mode, frac, false, ch);

  // decode_stack_channels and the mat_params factors
  const float* fac =
      params + (size_t)PARAM_COLS * clampi(mat, 0, n_params - 1);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    base_out[4 * i + k] = fac[3 + k] * srgb_to_linear(ch[k]);
    emis_out[3 * i + k] = fac[k] * srgb_to_linear(ch[8 + k]) * 20000.0f;
  }
  base_out[4 * i + 3] = fac[6] * ch[3];
  mrao_out[4 * i] = fac[7] * ch[6];
  mrao_out[4 * i + 1] = fac[8] * ch[7];
  mrao_out[4 * i + 2] = ch[11];
  mrao_out[4 * i + 3] = fac[9];
  extras_out[3 * i] = fac[13] * ch[12];
  extras_out[3 * i + 1] = fac[14] * ch[13];
  extras_out[3 * i + 2] = fac[15];

  // normal mapping
  const float nx = (ch[4] * 2.0f - 1.0f) * fac[10];
  const float ny = (ch[5] * 2.0f - 1.0f) * fac[10];
  const float nz = sqrtf(clamp_lo(1.0f - (nx * nx + ny * ny), (float)1e-6));
  float nm[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) nm[k] = (nx * t[k] + ny * b[k]) + nz * n[k];
  normalize3(nm);
  if (n3_out) {
#pragma unroll
    for (int k = 0; k < 3; ++k) n3_out[3 * i + k] = nm[k];
  }
  // mathutils.oct_encode (torch.sum of the row of three: (x + z) + y)
  const float l1n = (fabsf(nm[0]) + fabsf(nm[2])) + fabsf(nm[1]);
  const float ox = nm[0] / l1n, oy = nm[1] / l1n, oz = nm[2] / l1n;
  float ex = ox, ey = oy;
  if (!(oz >= 0.0f)) {
    ex = (1.0f - fabsf(oy)) * (ox >= 0.0f ? 1.0f : -1.0f);
    ey = (1.0f - fabsf(ox)) * (oy >= 0.0f ? 1.0f : -1.0f);
  }
  nrm_out[2 * i] = ex * 0.5f + 0.5f;
  nrm_out[2 * i + 1] = ey * 0.5f + 0.5f;

  // world_from_depth: (2 xs / width - 1, -2 ys / height + 1, depth, 1)
  // times inv_view_proj (row vector), divided by w
  const int x = i % width, y = i / width;
  const float ndc[4] = {
      (2.0f * ((float)x + 0.5f)) * (1.0f / (float)width) - 1.0f,
      (-2.0f * ((float)y + 0.5f)) * (1.0f / (float)height) + 1.0f,
      depth[i], 1.0f};
  float wp[4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
    wp[c] = ((ndc[0] * ivp[c] + ndc[1] * ivp[4 + c]) + ndc[2] * ivp[8 + c])
            + ndc[3] * ivp[12 + c];
  const float wd = fabsf(wp[3]) > (float)1e-20 ? wp[3] : 1.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) wpos_out[3 * i + k] = wp[k] / wd;
}

__global__ void __launch_bounds__(RS_THREADS)
k6_masked_alpha_kernel(const float* __restrict__ interp,
                       const int* __restrict__ meta, int n_meta,
                       const float* __restrict__ params, int n_params,
                       const uint32_t* __restrict__ amirror, int n_alpha,
                       float* __restrict__ alpha_out,
                       float* __restrict__ thresh_out, int width, int height,
                       int row0) {
  const int i = blockIdx.x * RS_THREADS + threadIdx.x;
  if (i >= width * height) return;
  const size_t plane = (size_t)width * height;
  const int mat = (int)interp[CH_MAT * plane + i];
  const int* m = meta + (size_t)META_COLS * clampi(mat, 0, n_meta - 1);
  const int size = m[1], levels = m[2], mode = m[3], abase = m[5];
  // no coarser than half an amask cell (the in-race reject bound)
  float lod = interp_lod(interp, i, plane, size);
  lod = tmin(lod, log2f(clamp_lo((float)size * (1.0f / (2.0f * AMASK_CELLS)),
                                 1.0f)));
  // sample_stack_alpha: one bilinear level of the u8 mirror
  lod = tmin(clamp_lo(lod, 0.0f), (float)(levels - 1));
  const int l0 = (int)floorf(lod);
  const int b0 = abase + level_offset_texels(size, l0);
  const int s0 = max(size >> l0, 1);
  const float sf = (float)s0;
  const float fx = interp[CH_U * plane + i] * sf - 0.5f;
  const float fy = interp[CH_V * plane + i] * sf - 0.5f;
  const int x0 = (int)floorf(fx);
  const int y0 = (int)floorf(fy);
  const float tx = fx - (float)x0;
  const float ty = fy - (float)y0;
  const int xs[2] = {address(x0, s0, mode), address(x0 + 1, s0, mode)};
  const int ys[2] = {address(y0, s0, mode), address(y0 + 1, s0, mode)};
  float a[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int idx = b0 + ys[k >> 1] * s0 + xs[k & 1];
    const uint32_t w = __ldg(amirror + (size_t)ALPHA_WORDS *
                                 clampi(idx >> 4, 0, n_alpha - 1) +
                             ((idx >> 2) & 3));
    a[k] = u8f(w, (idx & 3) * 8);
  }
  const float top = a[0] * (1.0f - tx) + a[1] * tx;
  const float bot = a[2] * (1.0f - tx) + a[3] * tx;
  const float a_tex = top * (1.0f - ty) + bot * ty;
  const float* fac =
      params + (size_t)PARAM_COLS * clampi(mat, 0, n_params - 1);
  alpha_out[i] = fac[6] * a_tex;
  // resolve._pixel_noise: the uint32 hash of the whole-frame pixel
  const uint32_t px = (uint32_t)(i % width);
  const uint32_t py = (uint32_t)(row0 + i / width);
  uint32_t h = px * 374761393u + py * 668265263u;
  h = (h ^ (h >> 13)) * 1274126177u;
  const float noise = (float)((h >> 16) & 0xFFFFu) * (1.0f / 65536.0f);
  thresh_out[i] = fac[12] >= 2.0f ? tmax(noise, (float)1e-3) : fac[11];
}

extern "C" int k5_resolve(const int* tri, const float* depth,
                          const float* interp, const float* inv_view_proj,
                          const uint32_t* flat, int n_flat,
                          const uint32_t* extra, int n_extra,
                          const int* meta, int n_meta, const float* params,
                          int n_params, float* base_color, float* normals,
                          float* mrao, float* emissive, uint8_t* mask,
                          float* world_pos, float* uv, float* extras,
                          float* n3, int width, int height, void* stream) {
  if (n_flat < 1 || n_extra < 1 || n_meta < 1 || n_params < 1)
    return (int)cudaErrorInvalidValue;
  const Stack st = {flat, extra, n_flat, n_extra};
  const int n = width * height;
  const int blocks = (n + RS_THREADS - 1) / RS_THREADS;
  k5_resolve_kernel<<<blocks, RS_THREADS, 0, (cudaStream_t)stream>>>(
      tri, depth, interp, inv_view_proj, st, meta, n_meta, params, n_params,
      base_color, normals, mrao, emissive, mask, world_pos, uv, extras, n3,
      width, height);
  return (int)cudaGetLastError();
}

extern "C" int k6_masked_alpha(const float* interp, const int* meta,
                               int n_meta, const float* params, int n_params,
                               const uint32_t* amirror, int n_alpha,
                               float* alpha, float* thresh, int width,
                               int height, int row0, void* stream) {
  if (n_meta < 1 || n_params < 1 || n_alpha < 1 || row0 < 0)
    return (int)cudaErrorInvalidValue;
  const int n = width * height;
  const int blocks = (n + RS_THREADS - 1) / RS_THREADS;
  k6_masked_alpha_kernel<<<blocks, RS_THREADS, 0, (cudaStream_t)stream>>>(
      interp, meta, n_meta, params, n_params, amirror, n_alpha, alpha,
      thresh, width, height, row0);
  return (int)cudaGetLastError();
}
