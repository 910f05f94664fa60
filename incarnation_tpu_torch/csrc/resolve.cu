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
// K5's decal role, k5_decal_step, is the decal layer's whole step: the
// fetch of the decal pixels that pass the depth test under the layer's
// chunk capacity, and their composite into the GBuffer (k5_decal_kernel).
//
// K6, the alpha test of a masked peel's pixel: the LOD capped at half an
// amask cell, one bilinear level of the u8 alpha mirror, alpha =
// mat_params[6] x a_tex, and the pass threshold: alphaCutoff, or for BLEND
// the screen-door hash of the pixel's whole-frame position (row0: a band's
// first row), at least 1e-3. Two entries: k6_masked_alpha, one thread per
// pixel, hit or not, as masked_alpha's contract asks; and k6_masked_peel,
// the frame's whole peel step (kernels/resolve.py masked_peel): the chunk
// rank, the alpha test of the hit pixels and the accumulate.
//
// Stochastic roles (the JAX package's estimators while TAA accumulates,
// resolve.py:78-226): the mip floor(lod + xi), with max_aniso > 1 the
// footprint's minor-axis mip and the uv moved along its major axis; one
// bilinear level or one jittered texel floor(u s - 0.5 + j) of it; for
// K5 the checkerboard half-rate fetch and for both a chunk capacity (the
// first covered 128-pixel chunks fetch; the others read zero channels in
// K5 and alpha 1.0 in K6). Each noise is the JAX _frame_noise hash of
// the whole-frame pixel and the frame index, computed here; the twins
// build the same noise as tensors (resolve.frame_noise).
//
// Arithmetic: every operation is the twin's, in the twin's order, built
// --fmad=false (kernels/build.py), and every constant is the float the
// twin's Python scalar rounds to. Where torch on the card divides by a
// Python number it multiplies by the scalar's float reciprocal, and so do
// these kernels; torch.sum of a row of three adds (x + z) + y there (the
// octahedral encoding's L1 norm), and so does K5. The twin's cross
// product is mathutils.cross3 (each product and difference rounded on its
// own, as here). What K5 cannot follow is torch.matmul (world_from_depth),
// which rounds in cuBLAS's order: K5 adds left to right, and its floats
// agree with the twin to a tolerance (chip_smoke.py K5_RTOL), the mask
// exactly; its decal step writes no world position and is expected to
// equal its twin bit for bit. K6 follows the twin operation for operation (sqrt and
// log2 are the same libdevice functions), so its alpha and threshold are
// expected to equal the twin's bit for bit, and its pass/fail decisions
// must.
//
// What bounds them: bytes. K5 reads tri and uv for every pixel, 13 more
// floats for a covered one, and each texture block it touches; it writes
// 85 B a pixel (97 with the mapped normal): at 1920x1088 about 0.09 ms at
// 3.35 TB/s, against 859-1,123 float operations a covered pixel (about
// 0.03 ms at 67 TFLOP/s; chip_smoke.py counts both). k6_masked_alpha reads
// 7 interp channels and writes 8 B a pixel, ~0.02 ms; the peel step's
// bytes are counted at k6_peel_kernel.
//
// K5's design for the card. A covered pixel's texture work is bound by
// instruction throughput (about 200 instructions a texel, 8 texels), a warp's
// lanes each decoding their own texels. So: a block shades a 32 x 8 pixel tile,
// a warp one row of it, so that the rows' texel footprints meet in one SM's L1
// (a 256 x 1 strip took 14% longer). The GBuffer planes leave as whole rows:
// 16- and 8-byte stores of the 4- and 2-channel planes, and the 3-channel
// planes and the mask staged in shared memory and written as 16-byte words (a
// lane writing its own channels one float at a time touched 3-4 times the
// sectors its bytes need). The wrap and mirror addresses' remainders are masks
// where the size is a power of two, as every size
// textures.build_material_stacks makes is (divisions before). The second level
// is skipped where its weight is 0, and the TBN basis is read after the texture
// work, prefetched into L1 before it, which keeps the kernel at 80 registers.
// Measured and left out (PERF.md): one load per distinct block of a footprint
// (the conditional loads cost more than they saved), and a warp decoding each
// distinct block of its footprints once into shared memory (1.8-1.9x this
// kernel's time: the key matching, the syncs and the code size). None of this
// changes an operation of a pixel: the planes are the same bits as those of the
// one-thread-per-pixel kernel that came before.

#include <cuda_runtime.h>
#include <stdint.h>

#define RS_THREADS 256
#define K5_TW 32  // K5's tile: a warp's row
#define K5_TH (RS_THREADS / K5_TW)  // and the block's rows, a warp each

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
  const uint32_t* flat;    // (n_flat, 8) core blocks, 16-byte aligned
  const uint32_t* extra;   // (n_extra, 6) extras blocks, 8-byte aligned;
                           // n_extra <= 1: none
  int n_flat, n_extra;
};

// One 4x4 block of the stack: its 8 core words and, where the material
// has extras blocks, its 6 extras words (24-byte rows, 8-byte aligned)
struct Block {
  uint4 lo, hi;
  uint2 e01, e23, e45;
};

// the block `brel` of the mip whose blocks start at `base` (extras at
// `ebase`), clamped into the tables as the twin's gathers clamp
__device__ __forceinline__ Block load_block(const Stack& st, int base,
                                            int ebase, int brel, bool ex) {
  Block b;
  const uint4* wp = reinterpret_cast<const uint4*>(
      st.flat + (size_t)CORE_WORDS * clampi(base + brel, 0, st.n_flat - 1));
  b.lo = __ldg(wp);
  b.hi = __ldg(wp + 1);
  if (ex) {
    const uint2* e = reinterpret_cast<const uint2*>(
        st.extra + (size_t)EXTRA_WORDS *
                       clampi(ebase + brel, 0, st.n_extra - 1));
    b.e01 = __ldg(e);
    b.e23 = __ldg(e + 1);
    b.e45 = __ldg(e + 2);
  } else {
    b.e01 = b.e23 = b.e45 = make_uint2(0u, 0u);
  }
  return b;
}

// textures.py _fetch_texel: channels 0-13 of the texel at bit shift `sh`
// of block b (ex: the material has extras blocks, else channels 8-13 are 1)
__device__ __forceinline__ void decode_texel(const Block& b, bool ex, int sh,
                                             float* o) {
  float c0[3], c1[3];
  dec565(b.lo.x & 0xFFFFu, c0);
  dec565((b.lo.x >> 16) & 0xFFFFu, c1);
  const float fb = sel3(b.lo.y, sh);
#pragma unroll
  for (int k = 0; k < 3; ++k) o[k] = lerp(c0[k], c1[k], fb);
  o[3] = lerp(u8f(b.lo.z, 0), u8f(b.lo.z, 8), sel3(b.hi.y, sh));
  const float fn = sel3(b.hi.z, sh);
  o[4] = lerp(u8f(b.lo.z, 16), u8f(b.lo.w, 0), fn);
  o[5] = lerp(u8f(b.lo.z, 24), u8f(b.lo.w, 8), fn);
  const float fm = sel3(b.hi.w, sh);
  o[6] = lerp(u8f(b.lo.w, 16), u8f(b.hi.x, 0), fm);
  o[7] = lerp(u8f(b.lo.w, 24), u8f(b.hi.x, 8), fm);
  if (!ex) {
#pragma unroll
    for (int k = 8; k < NCH; ++k) o[k] = 1.0f;
    return;
  }
  dec565(b.e01.x & 0xFFFFu, c0);
  dec565((b.e01.x >> 16) & 0xFFFFu, c1);
  const float fe = sel3(b.e01.y, sh);
#pragma unroll
  for (int k = 0; k < 3; ++k) o[8 + k] = lerp(c0[k], c1[k], fe);
  o[11] = lerp(u8f(b.e23.x, 0), u8f(b.e23.x, 8), sel3(b.e45.x, sh));
  const float ftc = sel3(b.e45.y, sh);
  o[12] = lerp(u8f(b.e23.x, 16), u8f(b.e23.y, 0), ftc);
  o[13] = lerp(u8f(b.e23.x, 24), u8f(b.e23.y, 8), ftc);
}

// a texel's 2-bit selector shift in its block
__device__ __forceinline__ int texel_shift(int x, int y) {
  return (((y & 3) << 2) | (x & 3)) << 1;
}

// (c mod m), m >= 1, as pymod: a mask where m is a power of two (every
// size textures.build_material_stacks makes), a division otherwise
__device__ __forceinline__ int mod_pos(int c, int m) {
  return (m & (m - 1)) == 0 ? (c & (m - 1)) : pymod(c, m);
}

// textures.py _address: texel c of a size-n axis, wrapped, clamped or
// mirrored, each remainder a mask where n is a power of two
__device__ __forceinline__ int address(int c, int n, int mode) {
  if (mode == ADDRESS_CLAMP) return min(max(c, 0), n - 1);
  if (mode == ADDRESS_WRAP) return mod_pos(c, n);
  const int p = mod_pos(c, 2 * n);
  return p < n ? p : 2 * n - 1 - p;
}

// textures.py _address of texels c and c + 1: the integers address(c, n,
// mode) and address(c + 1, n, mode) give
__device__ __forceinline__ void address_pair(int c, int n, int mode, int& a,
                                             int& b) {
  if (mode == ADDRESS_CLAMP) {
    a = min(max(c, 0), n - 1);
    b = min(max(c + 1, 0), n - 1);
    return;
  }
  const int m = mode == ADDRESS_WRAP ? n : 2 * n;
  a = mod_pos(c, m);
  b = mod_pos(c + 1, m);
  if (mode != ADDRESS_WRAP) {
    a = a < n ? a : 2 * n - 1 - a;
    b = b < n ? b : 2 * n - 1 - b;
  }
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
  int xa, xb, ya, yb;
  address_pair(x0, s, mode, xa, xb);
  address_pair(y0, s, mode, ya, yb);
  const bool ex = st.n_extra > 1 && ebase >= 0;
  const int s4 = max(s >> 2, 1);
  const int ca = xa >> 2, cb = xb >> 2;
  const int ra = (ya >> 2) * s4, rb = (yb >> 2) * s4;
  float top[NCH], bot[NCH], f[NCH];
  decode_texel(load_block(st, base, ebase, ra + ca, ex), ex,
               texel_shift(xa, ya), f);
#pragma unroll
  for (int k = 0; k < NCH; ++k) top[k] = f[k] * omtx;
  decode_texel(load_block(st, base, ebase, ra + cb, ex), ex,
               texel_shift(xb, ya), f);
#pragma unroll
  for (int k = 0; k < NCH; ++k) top[k] = top[k] + f[k] * tx;
  decode_texel(load_block(st, base, ebase, rb + ca, ex), ex,
               texel_shift(xa, yb), f);
#pragma unroll
  for (int k = 0; k < NCH; ++k) bot[k] = f[k] * omtx;
  decode_texel(load_block(st, base, ebase, rb + cb, ex), ex,
               texel_shift(xb, yb), f);
#pragma unroll
  for (int k = 0; k < NCH; ++k) {
    bot[k] = bot[k] + f[k] * tx;
    const float b = top[k] * omty + bot[k] * ty;
    acc[k] = first ? b * w : acc[k] + b * w;
  }
}

// asks for the line holding p in L1, without waiting for it
__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
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
// multiplications by their reciprocals on the card, each taken in double
// and rounded to float ((float)(1.0 / 1.055), not 1.0f / 1.055f: the two
// differ, and with the latter K5's base colour and emissive missed the
// twin's bits at 83% of the covered pixels)
__device__ __forceinline__ float srgb_to_linear(float c) {
  c = fminf(fmaxf(c, 0.0f), 1.0f);
  return c <= (float)0.04045
             ? c * (float)(1.0 / 12.92)
             : powf((c + (float)0.055) * (float)(1.0 / 1.055), (float)2.4);
}

// mathutils.normalize: v (1 / sqrt(dot3(v, v) + 1e-20)), dot3 left to right
__device__ __forceinline__ void normalize3(float* v) {
  const float s = (v[0] * v[0] + v[1] * v[1]) + v[2] * v[2];
  const float inv = 1.0f / sqrtf(s + (float)1e-20);
  v[0] = v[0] * inv;
  v[1] = v[1] * inv;
  v[2] = v[2] * inv;
}

// One warp's row of the 3-channel planes and the mask, staged in shared
// memory so that each row goes out as 16-byte stores
struct Stage {
  float emis[K5_TW * 3], wpos[K5_TW * 3], extras[K5_TW * 3], n3[K5_TW * 3];
  uint8_t mask[K5_TW];
};

// Where one pixel's channels go: its 4- and 2-channel planes straight to
// the GBuffer, its 3-channel ones (3 floats each) to its warp's stage
struct Out {
  float4* base;
  float4* mrao;
  float2* nrm;
  float *emis, *wpos, *extras, *n3;
};

// resolve._frame_noise / resolve.frame_noise: a uniform in [0, 1) from the
// uint32 hash of the whole-frame pixel (x, y) xor the channel's seed
// (frame_index x mult, wrapped to 32 bits)
__device__ __forceinline__ float frame_noise(uint32_t x, uint32_t y,
                                             uint32_t seed) {
  uint32_t h = (x * 374761393u + y * 668265263u) ^ seed;
  h = (h ^ (h >> 13)) * 1274126177u;
  return (float)((h >> 16) & 0xFFFFu) * (1.0f / 65536.0f);
}

// frame_noise's channels (kernels/resolve.py N_*)
#define N_ANISO 2428444049u
#define N_LOD 2654435761u
#define N_ALPHA_LOD 741103597u
#define N_JX 1181783497u
#define N_JY 3267000013u
#define N_BLEND 1597334677u

// the stochastic roles' settings (kernels/resolve.py R_*): the frame index
// that seeds the noise, the anisotropy limit and its float reciprocal (the
// twin's division by a Python number on the card), the checker parity,
// the band's first row, and the chunk keep flags (NULL: every chunk)
struct Stoch {
  uint32_t frame;
  float max_aniso, inv_aniso;
  int parity, row0;
  const uint8_t* keep;
};

// resolve._stochastic_lod's uv step: with max_aniso > 1, (u, v) moved
// along the footprint's major axis (rx >= ry: x) by (xi - 0.5), the step
// clamped to +-half_cell where half_cell > 0
__device__ __forceinline__ void aniso_step(float dudx, float dudy, float dvdx,
                                           float dvdy, float rx, float ry,
                                           uint32_t px, uint32_t py,
                                           const Stoch& sc, float half_cell,
                                           float& u, float& v) {
  const bool x_major = rx >= ry;
  float mx = x_major ? dudx : dudy;
  float my = x_major ? dvdx : dvdy;
  if (half_cell > 0.0f) {
    mx = tmin(tmax(mx, -half_cell), half_cell);
    my = tmin(tmax(my, -half_cell), half_cell);
  }
  const float d = frame_noise(px, py, sc.frame * N_ANISO) - 0.5f;
  u = u + mx * d;
  v = v + my * d;
}

// resolve._stochastic_lod at pixel i, whole-frame (px, py): with
// max_aniso > 1 the minor-axis mip and (u, v) moved along the major axis
// (aniso_step), else the footprint's mip; then floor(lod + noise)
__device__ __forceinline__ float stochastic_lod(
    const float* __restrict__ interp, size_t i, size_t plane, int size,
    uint32_t px, uint32_t py, const Stoch& sc, uint32_t lod_mult,
    float half_cell, float& u, float& v) {
  float lod;
  if (sc.max_aniso > 1.0f) {
    const float dudx = interp[CH_DUDX * plane + i];
    const float dudy = interp[CH_DUDY * plane + i];
    const float dvdx = interp[CH_DVDX * plane + i];
    const float dvdy = interp[CH_DVDY * plane + i];
    const float rx = sqrtf(dudx * dudx + dvdx * dvdx);
    const float ry = sqrtf(dudy * dudy + dvdy * dvdy);
    const float rmax = tmax(rx, ry), rmin = tmin(rx, ry);
    const float rho = tmax(rmin, rmax * sc.inv_aniso) * (float)size;
    lod = log2f(clamp_lo(rho, (float)1e-8));
    aniso_step(dudx, dudy, dvdx, dvdy, rx, ry, px, py, sc, half_cell, u, v);
  } else {
    lod = interp_lod(interp, i, plane, size);
  }
  return floorf(lod + frame_noise(px, py, sc.frame * lod_mult));
}

// the uv of pixel i that stochastic_lod moves, without its mip: the
// checkerboard's pixels that fetch nothing
__device__ __forceinline__ void moved_uv(const float* __restrict__ interp,
                                         size_t i, size_t plane, uint32_t px,
                                         uint32_t py, const Stoch& sc,
                                         float& u, float& v) {
  if (!(sc.max_aniso > 1.0f)) return;
  const float dudx = interp[CH_DUDX * plane + i];
  const float dudy = interp[CH_DUDY * plane + i];
  const float dvdx = interp[CH_DVDX * plane + i];
  const float dvdy = interp[CH_DVDY * plane + i];
  aniso_step(dudx, dudy, dvdx, dvdy, sqrtf(dudx * dudx + dvdx * dvdx),
             sqrtf(dudy * dudy + dvdy * dvdy), px, py, sc, 0.0f, u, v);
}

// textures.py sample_material_stack's fetch of one level: l0 = floor of
// the LOD clamped to the chain; bilinear (K5_DITHER) or the one texel
// floor(u s - 0.5 + j) (K5_JITTER, _stack_point), channels 0-13 into ch
template <bool POINT>
__device__ __forceinline__ void level_fetch(const Stack& st, const int* m,
                                            float lod, float u, float v,
                                            float jx, float jy, float* ch) {
  const int mbase = m[0], size = m[1], levels = m[2], mode = m[3];
  const int ebase = m[4];
  lod = tmin(clamp_lo(lod, 0.0f), (float)(levels - 1));
  const int l0 = (int)floorf(lod);
  const int off = level_offset_blocks(size, levels, l0);
  const int eb = ebase >= 0 ? ebase + off : -1;
  const int s = max(size >> l0, 1);
  if (!POINT) {
    bilinear_level(st, mbase + off, eb, s, u, v, mode, 1.0f, true, ch);
    return;
  }
  const float sf = (float)s;
  const int xa = address((int)floorf(u * sf - 0.5f + jx), s, mode);
  const int ya = address((int)floorf(v * sf - 0.5f + jy), s, mode);
  const bool ex = st.n_extra > 1 && eb >= 0;
  const int s4 = max(s >> 2, 1);
  decode_texel(load_block(st, mbase + off, eb, (ya >> 2) * s4 + (xa >> 2),
                          ex),
               ex, texel_shift(xa, ya), ch);
}

// the exact role's trilinear stack fetch (sample_material_stack) of pixel
// i: where the LOD's fraction is 0 (magnified, or clamped to the last
// level) the second level's term is acc + b x 0 == acc exactly (texel
// values are finite in [0, 1], acc >= +0) and is skipped; a NaN fraction
// is not 0 and takes it
__device__ __forceinline__ void trilinear_fetch(
    const Stack& st, const int* m, const float* __restrict__ interp, size_t i,
    size_t plane, float u, float v, float* ch) {
  const int mbase = m[0], size = m[1], levels = m[2], mode = m[3];
  const int ebase = m[4];
  float lod = interp_lod(interp, i, plane, size);
  lod = tmin(clamp_lo(lod, 0.0f), (float)(levels - 1));
  const int l0 = (int)floorf(lod);
  const int l1 = min(l0 + 1, levels - 1);
  const float frac = lod - (float)l0;
  const int off0 = level_offset_blocks(size, levels, l0);
  bilinear_level(st, mbase + off0, ebase >= 0 ? ebase + off0 : -1,
                 max(size >> l0, 1), u, v, mode, 1.0f - frac, true, ch);
  if (frac != 0.0f) {
    const int off1 = level_offset_blocks(size, levels, l1);
    bilinear_level(st, mbase + off1, ebase >= 0 ? ebase + off1 : -1,
                   max(size >> l1, 1), u, v, mode, frac, false, ch);
  }
}

// the mapped world normal of pixel i from its stack channels ch and its
// material's factors fac, in the twin's operations and order: the TBN
// basis from the interp channels (mathutils.cross3's products), the
// normal map's xy and its z, normalized
__device__ __forceinline__ void mapped_normal(
    const float* ch, const float* fac, const float* __restrict__ interp,
    size_t i, size_t plane, float* nm) {
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
  const float nx = (ch[4] * 2.0f - 1.0f) * fac[10];
  const float ny = (ch[5] * 2.0f - 1.0f) * fac[10];
  const float nz = sqrtf(clamp_lo(1.0f - (nx * nx + ny * ny), (float)1e-6));
#pragma unroll
  for (int k = 0; k < 3; ++k) nm[k] = (nx * t[k] + ny * b[k]) + nz * n[k];
  normalize3(nm);
}

// mathutils.oct_encode (torch.sum of the row of three: (x + z) + y)
__device__ __forceinline__ float2 oct_encode(const float* nm) {
  const float l1n = (fabsf(nm[0]) + fabsf(nm[2])) + fabsf(nm[1]);
  const float ox = nm[0] / l1n, oy = nm[1] / l1n, oz = nm[2] / l1n;
  float ex = ox, ey = oy;
  if (!(oz >= 0.0f)) {
    ex = (1.0f - fabsf(oy)) * (ox >= 0.0f ? 1.0f : -1.0f);
    ey = (1.0f - fabsf(ox)) * (oy >= 0.0f ? 1.0f : -1.0f);
  }
  return make_float2(ex * 0.5f + 0.5f, ey * 0.5f + 0.5f);
}

// the shading of covered pixel i at (x, y) from its stack channels ch, in
// the twin's operations and order, each plane written as soon as it is
// known
__device__ __forceinline__ void shade_pixel(
    const float* ch, const float* __restrict__ depth,
    const float* __restrict__ interp, const float* __restrict__ ivp, int mat,
    const float* __restrict__ params, int n_params, size_t i, size_t plane,
    int x, int y, int width, int height, const Out& o) {
  // decode_stack_channels and the mat_params factors
  const float* fac =
      params + (size_t)PARAM_COLS * clampi(mat, 0, n_params - 1);
  *o.base = make_float4(fac[3] * srgb_to_linear(ch[0]),
                        fac[4] * srgb_to_linear(ch[1]),
                        fac[5] * srgb_to_linear(ch[2]), fac[6] * ch[3]);
#pragma unroll
  for (int k = 0; k < 3; ++k)
    o.emis[k] = fac[k] * srgb_to_linear(ch[8 + k]) * 20000.0f;
  *o.mrao = make_float4(fac[7] * ch[6], fac[8] * ch[7], ch[11], fac[9]);
  o.extras[0] = fac[13] * ch[12];
  o.extras[1] = fac[14] * ch[13];
  o.extras[2] = fac[15];

  float nm[3];
  mapped_normal(ch, fac, interp, i, plane, nm);
#pragma unroll
  for (int k = 0; k < 3; ++k) o.n3[k] = nm[k];
  *o.nrm = oct_encode(nm);

  // world_from_depth: (2 xs / width - 1, -2 ys / height + 1, depth, 1)
  // times inv_view_proj (row vector), divided by w
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
  for (int k = 0; k < 3; ++k) o.wpos[k] = wp[k] / wd;
}

// n floats of a warp's staged row s out to g: 16-byte stores from g's
// first 16-byte boundary on, 4-byte ones before it and after the last
__device__ __forceinline__ void flush_floats(float* __restrict__ g,
                                             const float* s, int n,
                                             int lane) {
  const int head = min(
      (int)(((16u - ((uint32_t)(uintptr_t)g & 15u)) & 15u) >> 2), n);
  const int nv = (n - head) >> 2, done = head + (nv << 2);
  if (lane < head) g[lane] = s[lane];
  for (int j = lane; j < nv; j += 32) {
    float4 q;
    if (head == 0) {
      q = reinterpret_cast<const float4*>(s)[j];
    } else {
      const float* e = s + head + 4 * j;
      q = make_float4(e[0], e[1], e[2], e[3]);
    }
    reinterpret_cast<float4*>(g + head)[j] = q;
  }
  if (lane < n - done) g[done + lane] = s[done + lane];
}

// n bytes of a warp's staged row s out to g, the same way
__device__ __forceinline__ void flush_bytes(uint8_t* __restrict__ g,
                                            const uint8_t* s, int n,
                                            int lane) {
  const int head = min((int)((16u - ((uint32_t)(uintptr_t)g & 15u)) & 15u),
                       n);
  const int nv = (n - head) >> 4, done = head + (nv << 4);
  if (lane < head) g[lane] = s[lane];
  if (lane < nv) {
    const uint8_t* e = s + head + 16 * lane;
    uint32_t q[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      q[k] = (uint32_t)e[4 * k] | ((uint32_t)e[4 * k + 1] << 8) |
             ((uint32_t)e[4 * k + 2] << 16) | ((uint32_t)e[4 * k + 3] << 24);
    reinterpret_cast<uint4*>(g + head)[lane] =
        make_uint4(q[0], q[1], q[2], q[3]);
  }
  if (lane < n - done) g[done + lane] = s[done + lane];
}

// pixel i's planes: shaded from its stack channels ch where covered,
// zeros where not; its 4- and 2-channel planes straight to the GBuffer,
// its 3-channel ones and its mask to slot s of its warp's stage
__device__ __forceinline__ void pixel_planes(
    bool covered, const float* ch, const float* __restrict__ depth,
    const float* __restrict__ interp, const float* __restrict__ ivp, int mat,
    const float* __restrict__ params, int n_params, size_t i, size_t plane,
    int x, int y, int width, int height, float* __restrict__ base_out,
    float* __restrict__ nrm_out, float* __restrict__ mrao_out, Stage& sg,
    int s) {
  sg.mask[s] = covered ? 1 : 0;
  const Out o = {reinterpret_cast<float4*>(base_out) + i,
                 reinterpret_cast<float4*>(mrao_out) + i,
                 reinterpret_cast<float2*>(nrm_out) + i, sg.emis + 3 * s,
                 sg.wpos + 3 * s, sg.extras + 3 * s, sg.n3 + 3 * s};
  if (covered) {
    shade_pixel(ch, depth, interp, ivp, mat, params, n_params, i, plane, x,
                y, width, height, o);
  } else {
    *o.base = *o.mrao = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    *o.nrm = make_float2(0.0f, 0.0f);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      o.emis[k] = o.wpos[k] = o.extras[k] = o.n3[k] = 0.0f;
  }
}

// a warp's staged row of tw pixels out, from flat pixel r0 on
__device__ __forceinline__ void flush_row(
    const Stage& sg, size_t r0, int tw, int lane, float* __restrict__ emis_out,
    float* __restrict__ wpos_out, float* __restrict__ extras_out,
    float* __restrict__ n3_out, uint8_t* __restrict__ mask_out) {
  flush_floats(emis_out + 3 * r0, sg.emis, 3 * tw, lane);
  flush_floats(wpos_out + 3 * r0, sg.wpos, 3 * tw, lane);
  flush_floats(extras_out + 3 * r0, sg.extras, 3 * tw, lane);
  if (n3_out) flush_floats(n3_out + 3 * r0, sg.n3, 3 * tw, lane);
  flush_bytes(mask_out + r0, sg.mask, tw, lane);
}

// K5's roles (kernels/resolve.py R_* and role_name): the exact
// trilinear fetch; the dithered single mip, bilinear; one jittered texel
// of it. The checkerboard of jittered texels is k5_checker_kernel.
#define K5_EXACT 0
#define K5_DITHER 1
#define K5_JITTER 2

// A block shades a 32 x 8 tile, a warp one row of it: neighbouring rows
// share texture blocks in the SM's L1. Each pixel's 4- and 2-channel
// planes go out as one 16- or 8-byte store a lane (a row of the tile is
// contiguous in (H, W, C)); the 3-channel planes and the mask are staged
// in shared memory and written as the row's 16-byte words. Lanes past
// the image's right edge and warps below it store nothing. Three blocks
// an SM hold the exact role to 80 registers, no spills (an earlier
// version at 111 registers, 2 blocks an SM, ran the opaque layer 1.18x as
// long).
//
// The stochastic roles compute every pixel's uv moved along its major
// axis (the twin's gb.uv) and its dithered mip, and fetch one level of
// the stack for a covered pixel: bilinear, or the one jittered texel.
// With chunk keep flags, a covered pixel of a dropped 128-pixel chunk
// fetches nothing and reads zero channels.
template <int ROLE>
__global__ void __launch_bounds__(RS_THREADS, 3)
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
                  int width, int height, Stoch sc) {
  __shared__ __align__(16) Stage stage[K5_TH];
  const int lane = threadIdx.x & 31, row = threadIdx.x >> 5;
  const int y = blockIdx.y * K5_TH + row;
  if (y >= height) return;  // the whole warp
  const int x0 = blockIdx.x * K5_TW, x = x0 + lane;
  const int tw = min(K5_TW, width - x0);
  const size_t plane = (size_t)width * height;
  const size_t row0 = (size_t)y * width + x0;
  const uint32_t py = (uint32_t)(sc.row0 + y);
  Stage& sg = stage[row];
  const size_t i = row0 + lane;
  if (lane < tw) {
    float u = interp[CH_U * plane + i];
    float v = interp[CH_V * plane + i];
    const bool covered = tri[i] >= 0;
    const int mat = (int)interp[CH_MAT * plane + i];
    const int* m = meta + (size_t)META_COLS * clampi(mat, 0, n_meta - 1);
    // a pixel of a chunk the capacity drops reads zero channels
    const bool dropped = sc.keep && !sc.keep[i >> 7];
    float ch[NCH];
    if (ROLE == K5_EXACT) {
      if (covered) {
        // the depth and TBN channels, read after the texture work
        prefetch_l1(depth + i);
#pragma unroll
        for (int c = CH_WN; c <= CH_SIGN; ++c)
          prefetch_l1(interp + c * plane + i);
        if (!dropped) trilinear_fetch(st, m, interp, i, plane, u, v, ch);
      }
    } else {
      const float lod = stochastic_lod(interp, i, plane, m[1], (uint32_t)x,
                                       py, sc, N_LOD, 0.0f, u, v);
      if (covered && !dropped)
        level_fetch<ROLE == K5_JITTER>(
            st, m, lod, u, v, frame_noise((uint32_t)x, py, sc.frame * N_JX),
            frame_noise((uint32_t)x, py, sc.frame * N_JY), ch);
    }
    if (dropped) {
#pragma unroll
      for (int k = 0; k < NCH; ++k) ch[k] = 0.0f;
    }
    reinterpret_cast<float2*>(uv_out)[i] = make_float2(u, v);
    pixel_planes(covered, ch, depth, interp, ivp, mat, params, n_params, i,
                 plane, x, y, width, height, base_out, nrm_out, mrao_out, sg,
                 lane);
  }
  __syncwarp();
  flush_row(sg, row0, tw, lane, emis_out, wpos_out, extras_out, n3_out,
            mask_out);
}

// The checkerboard role (R_DITHER | R_JITTER | R_CHECKER, an even width):
// in each horizontal pair of a row the pixel of the fetching parity (x & 1
// == q = (row0 + y + parity) & 1) fetches one jittered texel of its
// dithered mip where it or a horizontal neighbour is covered; a covered
// pixel of the other parity takes the mean of its two neighbours' texels,
// edge-clamped at the row's ends.
//
// A warp shades a span of K5C_PAIRS x-pairs of a row (62 pixels, x0 even)
// and first fetches the 32 texels those need, one a lane: lane l the
// pixel x0 + 2 l - q, i.e. the span's own 31 and the one beyond its end
// (q = 0: x0 + 62) or before its start (q = 1: x0 - 1), which the
// neighbouring span's warp fetches as well. So every lane fetches, in one
// round (a warp whose fetching and filling lanes alternate fetches with
// half its lanes). The texels and the fetching pixels' moved uv go to
// shared memory; then the warp shades the span's pixels in two rounds of
// 32, as k5_resolve_kernel shades its row, a filling pixel computing only
// its moved uv: the pair l's fetching pixel takes lane l + q's texel, its
// filling pixel the mean of lanes l and l + 1. Four blocks an SM (64
// registers, no spills) ran it 9% faster than three (80 registers); five
// and six spill and ran 13% and 36% slower than four. With
// one texel a fetching pixel, the shading and the planes bound it: the
// same layer with every covered pixel fetching its texel takes as long
// (PERF.md).
#define K5C_PAIRS 31
#define K5C_SPAN (2 * K5C_PAIRS)

struct Fetched {
  float ch[NCH][32];
  float u[32], v[32];
};

__global__ void __launch_bounds__(RS_THREADS, 4)
k5_checker_kernel(const int* __restrict__ tri, const float* __restrict__ depth,
                  const float* __restrict__ interp,
                  const float* __restrict__ ivp, Stack st,
                  const int* __restrict__ meta, int n_meta,
                  const float* __restrict__ params, int n_params,
                  float* __restrict__ base_out, float* __restrict__ nrm_out,
                  float* __restrict__ mrao_out, float* __restrict__ emis_out,
                  uint8_t* __restrict__ mask_out,
                  float* __restrict__ wpos_out, float* __restrict__ uv_out,
                  float* __restrict__ extras_out, float* __restrict__ n3_out,
                  int width, int height, Stoch sc) {
  __shared__ __align__(16) Stage stage[K5_TH];
  __shared__ Fetched fetched[K5_TH];
  const int lane = threadIdx.x & 31, row = threadIdx.x >> 5;
  const int y = blockIdx.y * K5_TH + row;
  if (y >= height) return;  // the whole warp
  const int x0 = blockIdx.x * K5C_SPAN;
  const size_t plane = (size_t)width * height;
  const size_t rowpx = (size_t)y * width;
  const uint32_t py = (uint32_t)(sc.row0 + y);
  const int q = (sc.row0 + y + sc.parity) & 1;
  Fetched& f = fetched[row];
  {
    const int xf = x0 + 2 * lane - q;
    float ch[NCH];
#pragma unroll
    for (int k = 0; k < NCH; ++k) ch[k] = 0.0f;
    float u = 0.0f, v = 0.0f;
    if (xf >= 0 && xf < width) {
      const size_t i = rowpx + xf;
      u = interp[CH_U * plane + i];
      v = interp[CH_V * plane + i];
      if (tri[i] >= 0 || (xf > 0 && tri[i - 1] >= 0) ||
          (xf + 1 < width && tri[i + 1] >= 0)) {
        const int* m = meta + (size_t)META_COLS *
                                  clampi((int)interp[CH_MAT * plane + i], 0,
                                         n_meta - 1);
        const float lod = stochastic_lod(interp, i, plane, m[1],
                                         (uint32_t)xf, py, sc, N_LOD, 0.0f,
                                         u, v);
        level_fetch<true>(st, m, lod, u, v,
                          frame_noise((uint32_t)xf, py, sc.frame * N_JX),
                          frame_noise((uint32_t)xf, py, sc.frame * N_JY), ch);
      } else {
        moved_uv(interp, i, plane, (uint32_t)xf, py, sc, u, v);
      }
    }
#pragma unroll
    for (int k = 0; k < NCH; ++k) f.ch[k][lane] = ch[k];
    f.u[lane] = u;
    f.v[lane] = v;
  }
  __syncwarp();
  Stage& sg = stage[row];
  const int span = min(K5C_SPAN, width - x0);
  for (int r0 = 0; r0 < span; r0 += 32) {
    const int tw = min(32, span - r0);
    const int p = r0 + lane, x = x0 + p, l = p >> 1;
    const size_t i = rowpx + x;
    if (lane < tw) {
      const bool covered = tri[i] >= 0;
      const int mat = (int)interp[CH_MAT * plane + i];
      float u, v, ch[NCH];
      if ((p & 1) == q) {
        u = f.u[l + q];
        v = f.v[l + q];
        if (covered) {
#pragma unroll
          for (int k = 0; k < NCH; ++k) ch[k] = f.ch[k][l + q];
        }
      } else {
        u = interp[CH_U * plane + i];
        v = interp[CH_V * plane + i];
        moved_uv(interp, i, plane, (uint32_t)x, py, sc, u, v);
        if (covered) {
#pragma unroll
          for (int k = 0; k < NCH; ++k) {
            float a = f.ch[k][l], b = f.ch[k][l + 1];
            if (x == 0) a = b;
            if (x == width - 1) b = a;
            ch[k] = 0.5f * (a + b);
          }
        }
      }
      reinterpret_cast<float2*>(uv_out)[i] = make_float2(u, v);
      pixel_planes(covered, ch, depth, interp, ivp, mat, params, n_params, i,
                   plane, x, y, width, height, base_out, nrm_out, mrao_out,
                   sg, lane);
    }
    __syncwarp();
    flush_row(sg, rowpx + x0 + r0, tw, lane, emis_out, wpos_out, extras_out,
              n3_out, mask_out);
    __syncwarp();
  }
}

// K6's alpha test of pixel i, whole-frame (px, py), as the twin's
// masked_alpha_plain: the material's mip (the stochastic roles' dithered
// one, its anisotropic step clamped to half an amask cell's uv) capped at
// half an amask cell, one bilinear level of the u8 alpha mirror or its one
// jittered texel, alpha = mat_params[6] x a_tex (a_tex 1.0 in a dropped
// chunk), and the pass threshold: alphaCutoff, or for BLEND the
// screen-door hash of the pixel seeded by the frame index (0 on the exact
// path), at least 1e-3
template <bool STOCH>
__device__ __forceinline__ void k6_alpha(
    const float* __restrict__ interp, size_t i, size_t plane,
    const int* __restrict__ meta, int n_meta,
    const float* __restrict__ params, int n_params,
    const uint32_t* __restrict__ amirror, int n_alpha, uint32_t px,
    uint32_t py, const Stoch& sc, bool jitter, bool dropped, float& alpha,
    float& thresh) {
  const int mat = (int)interp[CH_MAT * plane + i];
  float a_tex = 1.0f;
  if (!dropped) {
    const int* m = meta + (size_t)META_COLS * clampi(mat, 0, n_meta - 1);
    const int size = m[1], levels = m[2], mode = m[3], abase = m[5];
    float u = interp[CH_U * plane + i];
    float v = interp[CH_V * plane + i];
    float lod;
    if (STOCH)
      lod = stochastic_lod(interp, i, plane, size, px, py, sc, N_ALPHA_LOD,
                           0.5f / AMASK_CELLS, u, v);
    else
      lod = interp_lod(interp, i, plane, size);
    // no coarser than half an amask cell (the in-race reject bound)
    lod = tmin(lod, log2f(clamp_lo(
                        (float)size * (1.0f / (2.0f * AMASK_CELLS)), 1.0f)));
    // sample_stack_alpha: one bilinear level of the u8 mirror, or its one
    // jittered texel
    lod = tmin(clamp_lo(lod, 0.0f), (float)(levels - 1));
    const int l0 = (int)floorf(lod);
    const int b0 = abase + level_offset_texels(size, l0);
    const int s0 = max(size >> l0, 1);
    const float sf = (float)s0;
    if (STOCH && jitter) {
      const float jx = frame_noise(px, py, sc.frame * N_JX);
      const float jy = frame_noise(px, py, sc.frame * N_JY);
      const int xa = address((int)floorf(u * sf - 0.5f + jx), s0, mode);
      const int ya = address((int)floorf(v * sf - 0.5f + jy), s0, mode);
      const int idx = b0 + ya * s0 + xa;
      a_tex = u8f(__ldg(amirror + (size_t)ALPHA_WORDS *
                            clampi(idx >> 4, 0, n_alpha - 1) +
                        ((idx >> 2) & 3)),
                  (idx & 3) * 8);
    } else {
      const float fx = u * sf - 0.5f;
      const float fy = v * sf - 0.5f;
      const int x0 = (int)floorf(fx);
      const int y0 = (int)floorf(fy);
      const float tx = fx - (float)x0;
      const float ty = fy - (float)y0;
      int xs[2], ys[2];
      address_pair(x0, s0, mode, xs[0], xs[1]);
      address_pair(y0, s0, mode, ys[0], ys[1]);
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
      a_tex = top * (1.0f - ty) + bot * ty;
    }
  }
  const float* fac =
      params + (size_t)PARAM_COLS * clampi(mat, 0, n_params - 1);
  alpha = fac[6] * a_tex;
  const float noise = frame_noise(px, py, sc.frame * N_BLEND);
  thresh = fac[12] >= 2.0f ? tmax(noise, (float)1e-3) : fac[11];
}

// K6 alone (masked_alpha): one thread per pixel of the layer, hit or not,
// as the twin's contract asks; the frame's peels take k6_peel_kernel
template <bool STOCH>
__global__ void __launch_bounds__(RS_THREADS)
k6_masked_alpha_kernel(const float* __restrict__ interp,
                       const int* __restrict__ meta, int n_meta,
                       const float* __restrict__ params, int n_params,
                       const uint32_t* __restrict__ amirror, int n_alpha,
                       float* __restrict__ alpha_out,
                       float* __restrict__ thresh_out, int width, int height,
                       Stoch sc, bool jitter) {
  const int i = blockIdx.x * RS_THREADS + threadIdx.x;
  if (i >= width * height) return;
  float alpha, thresh;
  k6_alpha<STOCH>(interp, i, (size_t)width * height, meta, n_meta, params,
                  n_params, amirror, n_alpha, (uint32_t)(i % width),
                  (uint32_t)(sc.row0 + i / width), sc, jitter,
                  sc.keep && !sc.keep[i >> 7], alpha, thresh);
  alpha_out[i] = alpha;
  thresh_out[i] = thresh;
}

// K6 as one masked peel's step (masked_peel): the chunk rank, the alpha
// test and the accumulate of renderer/frame.py's peel loop in one launch.
//
// A warp takes a 128-pixel chunk of the flat image (kernels/resolve.py
// CHUNK_PX), a lane its pixels lane + 32 k, k < 4 (each load of the warp
// 128 contiguous bytes), a block K6_WARPS chunks. Its chunks' "any hit" is
// a warp vote; under a chunk capacity, a block takes its chunks by an
// atomic ticket and their rank among the chunks with a hit by a decoupled
// look-back over the blocks of earlier tickets (as K10's over rows,
// csrc/bin.cu): the ticket, not blockIdx, orders the blocks, so a block
// waits only on blocks already running. A chunk ranked at or past the
// capacity reads alpha 1.0 (the twin's chunk_keep). A miss pixel reads its
// triangle and writes its z_limit (0); a hit pixel reads its 7 interp
// channels and its accumulated triangle and takes the alpha test; a pixel
// whose fragment passes where none has yet copies the peel's triangle,
// depth and 16 channels into the accumulators, and one that fails there
// continues: its z_limit is its depth. The blocks sum the continuing
// pixels and the chunks with a hit; the last block to finish (a
// __threadfence and an atomic count) writes the peel's overflow (the
// continuing pixels) and the chunk overflow (max(hit chunks - capacity,
// 0), folded into the frame's running max), and zeroes the state words,
// so that the next launch starts from zero with no memset and no host
// synchronisation. The words lead the wrapper's scratch, per (device,
// stream): the ticket, the finished blocks, the two sums, then a
// look-back word a block.
//
// What bounds it: bytes. Every pixel's triangle in and z_limit out (8 B);
// a hit pixel's 7 channels and accumulated triangle (32 B); a newly
// passing one's depth and 16 channels in, its accumulators out (136 B):
// about 0.006-0.012 ms a peel at the atrium's coverage (chip_smoke.py
// counts each launch's). Its floating point work, ~50 operations a hit
// pixel, is far below that.
#define K6_WARPS 8
#define K6_THREADS (K6_WARPS * 32)
#define K6_CHUNK 128
#define K6_PX (K6_CHUNK / 32)  // pixels a lane
#define K6_INTERP 16           // interp channels (kernels/raster.py)
#define K6_TICKET 0
#define K6_DONE 1
#define K6_CONT 2
#define K6_ACTIVE 3
#define K6_LOOKBACK 4
#define K6_LOOKBACK_SPAN 4     // blocks a lane, a round
// a look-back word: its flag in the high half, a count in the low
#define LB_AGGREGATE 1ull
#define LB_PREFIX 2ull
#define FULL_MASK 0xffffffffu

__device__ __forceinline__ int warp_incl_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(FULL_MASK, v, d);
    if (lane >= d) v += o;
  }
  return v;
}

// Warp 0 of the block of ticket r: the chunks with a hit in the blocks of
// earlier tickets (agg: this block's). Publishes the block's count at once
// and its inclusive prefix when known; a block with no hit chunk needs no
// prefix and does not wait (the blocks after it add its 0 on their way
// back; block 0 always publishes a prefix). Each lane reads
// K6_LOOKBACK_SPAN blocks a round, nearest first.
__device__ int k6_look_back(volatile unsigned long long* words, int r,
                            int agg) {
  const int lane = threadIdx.x & 31;
  if (r == 0) {
    if (lane == 0) words[0] = (LB_PREFIX << 32) | (unsigned)agg;
    return 0;
  }
  if (lane == 0) words[r] = (LB_AGGREGATE << 32) | (unsigned)agg;
  if (agg == 0) return 0;
  int before = 0;
  for (int j = r - 1;;) {
    unsigned long long w[K6_LOOKBACK_SPAN];
    int first = K6_LOOKBACK_SPAN;  // the lane's nearest prefix
#pragma unroll
    for (int u = 0; u < K6_LOOKBACK_SPAN; ++u) {
      const int at = j - K6_LOOKBACK_SPAN * lane - u;
      w[u] = at >= 0 ? words[at] : (LB_PREFIX << 32);
    }
#pragma unroll
    for (int u = K6_LOOKBACK_SPAN - 1; u >= 0; --u)
      if ((w[u] >> 32) == LB_PREFIX) first = u;
    const unsigned prefixes =
        __ballot_sync(FULL_MASK, first < K6_LOOKBACK_SPAN);
    const int stop = prefixes ? __ffs(prefixes) - 1 : 32;
    const int stop_u = __shfl_sync(FULL_MASK, first, stop & 31);
    const int lim = lane < stop ? K6_LOOKBACK_SPAN
                                : lane == stop ? stop_u + 1 : 0;
    int v = 0;
    bool unready = false;
#pragma unroll
    for (int u = 0; u < K6_LOOKBACK_SPAN; ++u)
      if (u < lim) {
        unready |= (w[u] >> 32) == 0;
        v += (int)(unsigned)w[u];
      }
    // a block before has not published: spin
    if (__ballot_sync(FULL_MASK, unready)) continue;
    before += __shfl_sync(FULL_MASK, warp_incl_scan(v), 31);
    if (prefixes) break;
    j -= K6_LOOKBACK_SPAN * 32;
  }
  if (lane == 0) words[r] = (LB_PREFIX << 32) | (unsigned)(before + agg);
  return before;
}

// Thread 0 of a block of K6's peel step or K5's decal step: under a chunk
// capacity (cap >= 0) the block's ticket, which orders the look-back (the
// last ticket resets the counter: every block has taken its own);
// without one, blockIdx.x
__device__ __forceinline__ int k6_ticket(unsigned long long* state,
                                         int cap) {
  int r = blockIdx.x;
  if (cap >= 0) {
    r = (int)atomicAdd(&state[K6_TICKET], 1ull);
    if (r == (int)gridDim.x - 1) atomicExch(&state[K6_TICKET], 0ull);
  }
  return r;
}

// Every thread of the block of ticket blk, under a chunk capacity: whether
// its warp's chunk (any: the lane's pixels hold a hit) ranks at or past
// cap among the chunks with a hit, by the block's scan and the look-back;
// adds the block's chunks with a hit to state[K6_ACTIVE]. rank: the
// block's K6_WARPS shared words.
__device__ __forceinline__ bool k6_chunk_dropped(bool any, int cap, int blk,
                                                 unsigned long long* state,
                                                 int* rank) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool hit_chunk = __any_sync(FULL_MASK, any);
  if (lane == 0) rank[warp] = hit_chunk;
  __syncthreads();
  if (warp == 0) {
    const int a = lane < K6_WARPS ? rank[lane] : 0;
    const int incl = warp_incl_scan(a);
    const int agg = __shfl_sync(FULL_MASK, incl, 31);
    const int before = k6_look_back(state + K6_LOOKBACK, blk, agg);
    if (lane < K6_WARPS) rank[lane] = before + incl - a;
    if (lane == 0 && agg)
      atomicAdd(&state[K6_ACTIVE], (unsigned long long)agg);
  }
  __syncthreads();
  return rank[warp] >= cap;
}

template <bool STOCH>
__global__ void __launch_bounds__(K6_THREADS)
k6_peel_kernel(const int* __restrict__ m_tri,
               const float* __restrict__ m_depth,
               const float* __restrict__ m_interp,
               const int* __restrict__ meta, int n_meta,
               const float* __restrict__ params, int n_params,
               const uint32_t* __restrict__ amirror, int n_alpha,
               int* __restrict__ acc_tri, float* __restrict__ acc_depth,
               float* __restrict__ acc_interp, float* __restrict__ z_limit,
               long long* __restrict__ chunk_over,
               long long* __restrict__ overflow,
               unsigned long long* __restrict__ state, int width, int height,
               Stoch sc, bool jitter, int cap) {
  __shared__ int blk, conts, rank[K6_WARPS];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = width * height;
  if (threadIdx.x == 0) {
    blk = k6_ticket(state, cap);
    conts = 0;
  }
  __syncthreads();
  const int i0 = (blk * K6_WARPS + warp) * K6_CHUNK;
  int tri[K6_PX];
  bool any = false;
#pragma unroll
  for (int k = 0; k < K6_PX; ++k) {
    const int i = i0 + lane + 32 * k;
    tri[k] = i < n ? m_tri[i] : -1;
    any |= tri[k] >= 0;
  }
  const bool dropped =
      cap >= 0 && k6_chunk_dropped(any, cap, blk, state, rank);
  // the chunk's first pixel in the whole frame (the rows of a band start
  // at row0)
  const int cy = i0 / width, cx = i0 - cy * width;
  int cont = 0;
#pragma unroll
  for (int k = 0; k < K6_PX; ++k) {
    const int i = i0 + lane + 32 * k;
    if (i >= n) break;
    float zl = 0.0f;
    if (tri[k] >= 0) {
      int x = cx + lane + 32 * k, y = cy;
      if (x >= width) {
        const int wraps = x / width;
        y += wraps;
        x -= wraps * width;
      }
      const int prev = acc_tri[i];
      float alpha, thresh;
      k6_alpha<STOCH>(m_interp, i, n, meta, n_meta, params, n_params,
                      amirror, n_alpha, (uint32_t)x, (uint32_t)(sc.row0 + y),
                      sc, jitter, dropped, alpha, thresh);
      if (prev < 0) {
        const float d = m_depth[i];
        if (alpha >= thresh) {
          acc_tri[i] = tri[k];
          acc_depth[i] = d;
#pragma unroll
          for (int c = 0; c < K6_INTERP; ++c)
            acc_interp[(size_t)c * n + i] = m_interp[(size_t)c * n + i];
        } else {
          zl = d;
          ++cont;
        }
      }
    }
    z_limit[i] = zl;
  }
  cont = __reduce_add_sync(FULL_MASK, cont);
  if (lane == 0 && cont) atomicAdd(&conts, cont);
  __syncthreads();
  if (threadIdx.x == 0) {
    if (conts) atomicAdd(&state[K6_CONT], (unsigned long long)conts);
    __threadfence();
    last = atomicAdd(&state[K6_DONE], 1ull) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last block: the peel's counts, and the state zero again
  __threadfence();
  if (threadIdx.x == 0) {
    *overflow = (long long)atomicExch(&state[K6_CONT], 0ull);
    if (cap >= 0) {
      const long long act = (long long)atomicExch(&state[K6_ACTIVE], 0ull);
      const long long over = act > cap ? act - cap : 0;
      if (over > *chunk_over) *chunk_over = over;
    }
    atomicExch(&state[K6_DONE], 0ull);
  }
  if (cap >= 0)
    for (int b = threadIdx.x; b < (int)gridDim.x; b += K6_THREADS)
      state[K6_LOOKBACK + b] = 0ull;
}

// K5's decal role: the decal layer's whole step (kernels/resolve.py
// decal_step; renderer/frame.py's decal pass, frame.py:339-359 in JAX):
// the decal layer's material fetch under its chunk capacity, its depth
// test against the scene and its composite into the GBuffer, in one
// launch. It replaces the decal layer's K5 launch, which wrote all nine
// GBuffer planes of every pixel, and the eager torch around it: the chunk
// keep flags, the chunk overflow and the composite (about 23 operators
// over full-frame planes).
//
// The grid is K6's peel step's: a warp takes a 128-pixel chunk, a lane
// its pixels lane + 32 k, k < 4, a block K6_WARPS chunks; under a chunk
// capacity a block takes its chunks by an atomic ticket and their rank
// among the chunks with a decal pixel by the decoupled look-back over the
// blocks of earlier tickets (k6_look_back), and the last block to finish
// writes the overflow (max(chunks with a decal pixel - capacity, 0)) and
// leaves the state words zero (the same scratch as K6's step). Without a
// capacity block 0 writes the overflow 0. A pixel outside the decal layer,
// or in a chunk ranked at or past the capacity, fetches and writes
// nothing. A decal pixel that passes the depth test d_depth >= depth -
// 1e-5 takes K5's fetch of its role (its uv step and mip, then the
// trilinear, bilinear or one jittered texel) and blends gb (1 - a) + d a
// into the base colour (a the decal's opacity); where a > 0.5 it replaces
// the normals and mrao with the decal's and writes the octahedral decode
// of the decal's normal into n3 (where given). Every operation is the
// twin's, in its order (K5's fetch and normal, then the composite; the
// twin's cross product is mathutils.cross3 and its decode sums the norm
// as dot3 does), so the planes equal decal_step_plain's bit for bit.
//
// What bounds it: bytes. Every pixel's d_tri read once (4 B, 8.4 MB at
// 1920x1088: 0.0025 ms at 3.35 TB/s) and a look-back word a block; a decal
// pixel reads d_depth and depth (8 B); one that passes reads its 7 interp
// channels (uv, material, derivatives; 7 more, the TBN basis, where it
// replaces the normal), its texture blocks and material rows, and
// reads and writes 16-52 B of planes. Its float work (K5's fetch and
// normal, ~1,000 operations a passing pixel) is far below that unless
// most of the frame is decal.

// mathutils' decode of the octahedral normal e into n (3 floats), the
// norm a dot3 sum (kernels/resolve.py _oct_decode)
__device__ __forceinline__ void oct_decode(float2 e, float* n) {
  const float fx = e.x * 2.0f - 1.0f, fy = e.y * 2.0f - 1.0f;
  const float nz = (1.0f - fabsf(fx)) - fabsf(fy);
  const float m = -nz;
  const float t = m != m ? m : fminf(fmaxf(m, 0.0f), 1.0f);  // torch.clamp
  const float nx = fx + (fx >= 0.0f ? -t : t);
  const float ny = fy + (fy >= 0.0f ? -t : t);
  const float len = sqrtf((nx * nx + ny * ny) + nz * nz);
  n[0] = nx / len;
  n[1] = ny / len;
  n[2] = nz / len;
}

// one decal pixel i at whole-frame (px, py) that passed the depth test:
// its fetch (K5's, of ROLE), then the composite into base, nrm, mrao, n3
template <int ROLE>
__device__ __forceinline__ void decal_pixel(
    const Stack& st, const int* __restrict__ meta, int n_meta,
    const float* __restrict__ params, int n_params,
    const float* __restrict__ interp, size_t i, size_t plane, uint32_t px,
    uint32_t py, const Stoch& sc, float* __restrict__ base,
    float* __restrict__ nrm, float* __restrict__ mrao,
    float* __restrict__ n3) {
  float u = interp[CH_U * plane + i];
  float v = interp[CH_V * plane + i];
  const int mat = (int)interp[CH_MAT * plane + i];
  const int* m = meta + (size_t)META_COLS * clampi(mat, 0, n_meta - 1);
  float ch[NCH];
  if (ROLE == K5_EXACT) {
    trilinear_fetch(st, m, interp, i, plane, u, v, ch);
  } else {
    const float lod = stochastic_lod(interp, i, plane, m[1], px, py, sc,
                                     N_LOD, 0.0f, u, v);
    level_fetch<ROLE == K5_JITTER>(st, m, lod, u, v,
                                   frame_noise(px, py, sc.frame * N_JX),
                                   frame_noise(px, py, sc.frame * N_JY), ch);
  }
  const float* fac =
      params + (size_t)PARAM_COLS * clampi(mat, 0, n_params - 1);
  const float a = fac[6] * ch[3];
  const float oma = 1.0f - a;
  float4* bp = reinterpret_cast<float4*>(base) + i;
  float4 g = *bp;
  g.x = g.x * oma + (fac[3] * srgb_to_linear(ch[0])) * a;
  g.y = g.y * oma + (fac[4] * srgb_to_linear(ch[1])) * a;
  g.z = g.z * oma + (fac[5] * srgb_to_linear(ch[2])) * a;
  *bp = g;
  if (a > 0.5f) {
    float nm[3];
    mapped_normal(ch, fac, interp, i, plane, nm);
    const float2 e = oct_encode(nm);
    reinterpret_cast<float2*>(nrm)[i] = e;
    reinterpret_cast<float4*>(mrao)[i] =
        make_float4(fac[7] * ch[6], fac[8] * ch[7], ch[11], fac[9]);
    if (n3) oct_decode(e, n3 + 3 * i);
  }
}

template <int ROLE>
__global__ void __launch_bounds__(K6_THREADS)
k5_decal_kernel(const int* __restrict__ d_tri,
                const float* __restrict__ d_depth,
                const float* __restrict__ d_interp,
                const float* __restrict__ depth, Stack st,
                const int* __restrict__ meta, int n_meta,
                const float* __restrict__ params, int n_params,
                float* __restrict__ base, float* __restrict__ nrm,
                float* __restrict__ mrao, float* __restrict__ n3,
                long long* __restrict__ overflow,
                unsigned long long* __restrict__ state, int width,
                int height, Stoch sc, int cap) {
  __shared__ int blk, rank[K6_WARPS];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = width * height;
  if (threadIdx.x == 0) blk = k6_ticket(state, cap);
  __syncthreads();
  const int i0 = (blk * K6_WARPS + warp) * K6_CHUNK;
  int tri[K6_PX];
  bool any = false;
#pragma unroll
  for (int k = 0; k < K6_PX; ++k) {
    const int i = i0 + lane + 32 * k;
    tri[k] = i < n ? d_tri[i] : -1;
    any |= tri[k] >= 0;
  }
  const bool dropped =
      cap >= 0 && k6_chunk_dropped(any, cap, blk, state, rank);
  if (any && !dropped) {
    // the chunk's first pixel (a band's rows start at row0)
    const int cy = i0 / width, cx = i0 - cy * width;
#pragma unroll
    for (int k = 0; k < K6_PX; ++k) {
      const int i = i0 + lane + 32 * k;
      if (tri[k] < 0 || !(d_depth[i] >= depth[i] - 1e-5f)) continue;
      int x = cx + lane + 32 * k, y = cy;
      if (x >= width) {
        const int wraps = x / width;
        y += wraps;
        x -= wraps * width;
      }
      decal_pixel<ROLE>(st, meta, n_meta, params, n_params, d_interp, i, n,
                        (uint32_t)x, (uint32_t)(sc.row0 + y), sc, base, nrm,
                        mrao, n3);
    }
  }
  if (cap < 0) {
    if (blockIdx.x == 0 && threadIdx.x == 0) *overflow = 0;
    return;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(&state[K6_DONE], 1ull) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last block: the overflow, and the state zero again
  __threadfence();
  if (threadIdx.x == 0) {
    const long long act = (long long)atomicExch(&state[K6_ACTIVE], 0ull);
    *overflow = act > cap ? act - cap : 0;
    atomicExch(&state[K6_DONE], 0ull);
  }
  for (int b = threadIdx.x; b < (int)gridDim.x; b += K6_THREADS)
    state[K6_LOOKBACK + b] = 0ull;
}

// role: kernels/resolve.py's R_* flags (0: exact); frame, max_aniso,
// parity and row0 as Stoch; keep: a byte per 128-pixel chunk (NULL: every
// chunk). The checkerboard needs the jittered texel, an even width and no
// keep flags.
extern "C" int k5_resolve(const int* tri, const float* depth,
                          const float* interp, const float* inv_view_proj,
                          const uint32_t* flat, int n_flat,
                          const uint32_t* extra, int n_extra,
                          const int* meta, int n_meta, const float* params,
                          int n_params, float* base_color, float* normals,
                          float* mrao, float* emissive, uint8_t* mask,
                          float* world_pos, float* uv, float* extras,
                          float* n3, int width, int height, int role,
                          int frame, float max_aniso, int parity, int row0,
                          const uint8_t* keep, void* stream) {
  if (n_flat < 1 || n_extra < 1 || n_meta < 1 || n_params < 1 || row0 < 0)
    return (int)cudaErrorInvalidValue;
  // the 16- and 8-byte loads and stores
  if (((uintptr_t)flat | (uintptr_t)base_color | (uintptr_t)mrao) & 15u ||
      ((uintptr_t)extra | (uintptr_t)normals | (uintptr_t)uv) & 7u)
    return (int)cudaErrorInvalidValue;
  const bool dither = role & 1, jitter = role & 2, checker = role & 4;
  if ((role & ~7) || (!dither && role) || (checker && (!jitter || width & 1 ||
                                                      keep)) ||
      (keep && ((long long)width * height) % 128))
    return (int)cudaErrorInvalidValue;
  const Stack st = {flat, extra, n_flat, n_extra};
  const Stoch sc = {(uint32_t)frame, max_aniso, 1.0f / max_aniso, parity & 1,
                    row0, keep};
  const dim3 grid((width + K5_TW - 1) / K5_TW, (height + K5_TH - 1) / K5_TH);
#define K5_ARGS                                                            \
  tri, depth, interp, inv_view_proj, st, meta, n_meta, params, n_params,   \
      base_color, normals, mrao, emissive, mask, world_pos, uv, extras, n3, \
      width, height, sc
  if (checker)
    k5_checker_kernel<<<dim3((width + K5C_SPAN - 1) / K5C_SPAN, grid.y),
                        RS_THREADS, 0, (cudaStream_t)stream>>>(K5_ARGS);
  else if (jitter)
    k5_resolve_kernel<K5_JITTER>
        <<<grid, RS_THREADS, 0, (cudaStream_t)stream>>>(K5_ARGS);
  else if (dither)
    k5_resolve_kernel<K5_DITHER>
        <<<grid, RS_THREADS, 0, (cudaStream_t)stream>>>(K5_ARGS);
  else
    k5_resolve_kernel<K5_EXACT>
        <<<grid, RS_THREADS, 0, (cudaStream_t)stream>>>(K5_ARGS);
#undef K5_ARGS
  return (int)cudaGetLastError();
}

// role: R_DITHER, with R_JITTER the one texel (0: exact); frame seeds the
// BLEND threshold on every role
extern "C" int k6_masked_alpha(const float* interp, const int* meta,
                               int n_meta, const float* params, int n_params,
                               const uint32_t* amirror, int n_alpha,
                               float* alpha, float* thresh, int width,
                               int height, int row0, int role, int frame,
                               float max_aniso, const uint8_t* keep,
                               void* stream) {
  if (n_meta < 1 || n_params < 1 || n_alpha < 1 || row0 < 0 || (role & ~3) ||
      role == 2 || (keep && ((long long)width * height) % 128))
    return (int)cudaErrorInvalidValue;
  const Stoch sc = {(uint32_t)frame, max_aniso, 1.0f / max_aniso, 0, row0,
                    keep};
  const int n = width * height;
  const int blocks = (n + RS_THREADS - 1) / RS_THREADS;
  if (role & 1)
    k6_masked_alpha_kernel<true><<<blocks, RS_THREADS, 0,
                                   (cudaStream_t)stream>>>(
        interp, meta, n_meta, params, n_params, amirror, n_alpha, alpha,
        thresh, width, height, sc, role & 2);
  else
    k6_masked_alpha_kernel<false><<<blocks, RS_THREADS, 0,
                                    (cudaStream_t)stream>>>(
        interp, meta, n_meta, params, n_params, amirror, n_alpha, alpha,
        thresh, width, height, sc, false);
  return (int)cudaGetLastError();
}

// One masked peel's step (k6_peel_kernel): the peel's m_tri, m_depth and
// m_interp, the material tables, the accumulators acc_tri, acc_depth,
// acc_interp and z_limit (updated in place), the frame's running chunk
// overflow and this peel's overflow (int64 scalars), the scratch (state,
// state_words int64 words, zero), the size and row0, the role (as
// k6_masked_alpha's), the frame index, max_aniso and the chunk capacity
// (-1: none; it needs whole 128-pixel chunks)
extern "C" int k6_masked_peel(const int* m_tri, const float* m_depth,
                              const float* m_interp, const int* meta,
                              int n_meta, const float* params, int n_params,
                              const uint32_t* amirror, int n_alpha,
                              int* acc_tri, float* acc_depth,
                              float* acc_interp, float* z_limit,
                              long long* chunk_over, long long* overflow,
                              unsigned long long* state, int state_words,
                              int width, int height, int row0, int role,
                              int frame, float max_aniso, int capacity,
                              void* stream) {
  const long long n = (long long)width * height;
  const int blocks = (int)((n + K6_WARPS * K6_CHUNK - 1) /
                           (K6_WARPS * K6_CHUNK));
  if (n_meta < 1 || n_params < 1 || n_alpha < 1 || row0 < 0 || (role & ~3) ||
      role == 2 || n < 1 || n > (1LL << 30) ||
      (capacity >= 0 && n % K6_CHUNK) ||
      state_words < K6_LOOKBACK + (capacity >= 0 ? blocks : 0))
    return (int)cudaErrorInvalidValue;
  const Stoch sc = {(uint32_t)frame, max_aniso, 1.0f / max_aniso, 0, row0,
                    nullptr};
  const int cap = capacity < 0 ? -1 : capacity;
#define K6_PEEL_ARGS                                                       \
  m_tri, m_depth, m_interp, meta, n_meta, params, n_params, amirror,       \
      n_alpha, acc_tri, acc_depth, acc_interp, z_limit, chunk_over,        \
      overflow, state, width, height, sc
  if (role & 1)
    k6_peel_kernel<true><<<blocks, K6_THREADS, 0, (cudaStream_t)stream>>>(
        K6_PEEL_ARGS, role & 2, cap);
  else
    k6_peel_kernel<false><<<blocks, K6_THREADS, 0, (cudaStream_t)stream>>>(
        K6_PEEL_ARGS, false, cap);
#undef K6_PEEL_ARGS
  return (int)cudaGetLastError();
}

// The decal layer's step (k5_decal_kernel): the decal layer's d_tri,
// d_depth and d_interp, the scene's depth, the material tables, the
// GBuffer's base colour, normals and mrao and n3 (NULL: none), updated in
// place, the overflow out (an int64 scalar), the scratch (state,
// state_words int64 words, zero: K6's step's), the size, the role (R_*
// without the checkerboard), the frame index, max_aniso, row0 and the
// chunk capacity (-1: none; it needs whole 128-pixel chunks)
extern "C" int k5_decal_step(const int* d_tri, const float* d_depth,
                             const float* d_interp, const float* depth,
                             const uint32_t* flat, int n_flat,
                             const uint32_t* extra, int n_extra,
                             const int* meta, int n_meta,
                             const float* params, int n_params,
                             float* base_color, float* normals, float* mrao,
                             float* n3, long long* overflow,
                             unsigned long long* state, int state_words,
                             int width, int height, int role, int frame,
                             float max_aniso, int row0, int capacity,
                             void* stream) {
  const long long n = (long long)width * height;
  const int blocks = (int)((n + K6_WARPS * K6_CHUNK - 1) /
                           (K6_WARPS * K6_CHUNK));
  if (n_flat < 1 || n_extra < 1 || n_meta < 1 || n_params < 1 || row0 < 0 ||
      (role & ~3) || role == 2 || n < 1 || n > (1LL << 30) ||
      (capacity >= 0 && n % K6_CHUNK) ||
      state_words < K6_LOOKBACK + (capacity >= 0 ? blocks : 0))
    return (int)cudaErrorInvalidValue;
  // the 16- and 8-byte loads and stores
  if (((uintptr_t)flat | (uintptr_t)base_color | (uintptr_t)mrao) & 15u ||
      ((uintptr_t)extra | (uintptr_t)normals) & 7u)
    return (int)cudaErrorInvalidValue;
  const Stack st = {flat, extra, n_flat, n_extra};
  const Stoch sc = {(uint32_t)frame, max_aniso, 1.0f / max_aniso, 0, row0,
                    nullptr};
  const int cap = capacity < 0 ? -1 : capacity;
#define K5D_ARGS                                                         \
  d_tri, d_depth, d_interp, depth, st, meta, n_meta, params, n_params,   \
      base_color, normals, mrao, n3, overflow, state, width, height, sc, \
      cap
  if (role & 2)
    k5_decal_kernel<K5_JITTER>
        <<<blocks, K6_THREADS, 0, (cudaStream_t)stream>>>(K5D_ARGS);
  else if (role & 1)
    k5_decal_kernel<K5_DITHER>
        <<<blocks, K6_THREADS, 0, (cudaStream_t)stream>>>(K5D_ARGS);
  else
    k5_decal_kernel<K5_EXACT>
        <<<blocks, K6_THREADS, 0, (cudaStream_t)stream>>>(K5D_ARGS);
#undef K5D_ARGS
  return (int)cudaGetLastError();
}
