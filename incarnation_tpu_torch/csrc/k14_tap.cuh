// K14's tap of the sun shadow map, the device code that K14 (shadow.cu)
// and K15's map role (shading.cu) share, so one source defines the tap.
//
// The tap, the twin's (kernels/shadow.py sun_map_tap and
// sun_visibility_plain) operation by operation (--fmad=false):
// s = ((x m0j + y m1j) + z m2j) + m3j (mathutils.rows_mat and the affine
// row), inside |sx|, |sy| <= 1 from the raw s, u = (sx 0.5 + 0.5) S,
// v = (0.5 - sy 0.5) S, with dither u += (xi - 0.5) 2 (xi the frame noise,
// the JAX package's uint32 hash: frame_noise's int64 arithmetic modulo
// 2^32 is this uint32 arithmetic, the seed frame * mult formed on the
// host), nan_to_num, a float clamp to [0, S - 1], truncation, one texel at
// v S + u of the f32 (S, S) map; bias (1.5 + 2 (1 - clamp(n.l, 0, 1)))
// (2 / S) with 2 / S the float torch rounds it to and torch's clamp (a
// NaN passes), its n.l the fetching pixel's own normal dotted with the sun
// direction as torch.sum(n * sun_dir, -1) sums three on the card:
// (x + z) + y, each product rounded; visibility 0 where inside and
// map > sz + bias, else 1.
//
// The checkerboard (kernels/checker.py): in each horizontal pair i of a
// row y, the lane (row0 + y + parity) & 1 fetches, with its noise hashed
// at the compacted position (i, row0 + y); the other lane takes
// 0.5 (val_i + val_j), j = i + 1 where lane 0 fetches and i - 1 where
// lane 1 does, val_j clamped to val_i at the row's ends.

#pragma once

#include <cuda_runtime.h>
#include <float.h>

struct K14Map {
  const float* __restrict__ depth;  // (S, S)
  int side;                         // S
  float fside, hi;                  // S, S - 1 as floats
  float bias_scale;                 // float(2 / S)
  bool dither;
  unsigned seed_x, seed_y;          // frame * N_PCF_X, frame * N_PCF_Y
  const float* __restrict__ vp;     // sun_vp (4, 4), on the card
  const float* __restrict__ nrm;    // (H, W, 3) normals
  const float* __restrict__ sun;    // sun_dir (3,), on the card
};

// the K14Map of a launch: the map's constants and its device pointers
inline K14Map k14_map(const float* depth, const float* sun_vp, int side,
                      float bias_scale, int dither, unsigned seed_x,
                      unsigned seed_y, const float* nrm, const float* sun) {
  K14Map mp;
  mp.depth = depth;
  mp.side = side;
  mp.fside = (float)side;
  mp.hi = (float)(side - 1);
  mp.bias_scale = bias_scale;
  mp.dither = dither != 0;
  mp.seed_x = seed_x;
  mp.seed_y = seed_y;
  mp.vp = sun_vp;                 // read on the card: no copy to the host
  mp.nrm = nrm;
  mp.sun = sun;
  return mp;
}

// the slope bias's n.l of pixel px: torch.sum(n * sun_dir, -1) on the
// card, (x + z) + y
__device__ __forceinline__ float k14_ndl(const K14Map& mp, size_t px) {
  const float* n = mp.nrm + 3 * px;
  return (__ldg(n) * __ldg(mp.sun) + __ldg(n + 2) * __ldg(mp.sun + 2)) +
         __ldg(n + 1) * __ldg(mp.sun + 1);
}

// sun_vp's rows 0-3, columns 0-2: the product's matrix and the affine row
__device__ __forceinline__ void k14_load_vp(const K14Map& mp,
                                            float (&m)[4][3]) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int j = 0; j < 3; ++j) m[k][j] = __ldg(mp.vp + 4 * k + j);
}

// frame_noise: the JAX package's hash of (x, y) xor the channel's seed
__device__ __forceinline__ float k14_noise(unsigned x, unsigned y,
                                           unsigned seed) {
  unsigned h = (x * 374761393u + y * 668265263u) ^ seed;
  h = (h ^ (h >> 13)) * 1274126177u;
  return (float)((h >> 16) & 0xFFFFu) / 65536.0f;
}

// torch.nan_to_num, then torch.clamp to [0, hi]
__device__ __forceinline__ float k14_coord(float a, float hi) {
  a = isnan(a) ? 0.0f : a == INFINITY ? FLT_MAX : a == -INFINITY ? -FLT_MAX
                                                                   : a;
  return fminf(fmaxf(a, 0.0f), hi);
}

// the visibility of fetching pixel px of the (H, W, 3) world positions
// wp, its noise coordinates (nx, ny)
__device__ __forceinline__ float k14_tap(const K14Map& mp,
                                         const float (&m)[4][3],
                                         const float* __restrict__ wp,
                                         size_t px, unsigned nx,
                                         unsigned ny) {
  const float* p = wp + 3 * px;
  const float x = __ldg(p), y = __ldg(p + 1), z = __ldg(p + 2);
  float s[3];
#pragma unroll
  for (int j = 0; j < 3; ++j)
    s[j] = ((x * m[0][j] + y * m[1][j]) + z * m[2][j]) + m[3][j];
  const bool inside = s[0] >= -1.0f && s[0] <= 1.0f && s[1] >= -1.0f &&
                      s[1] <= 1.0f;
  float u = (s[0] * 0.5f + 0.5f) * mp.fside;
  float v = (0.5f - s[1] * 0.5f) * mp.fside;
  if (mp.dither) {
    u = u + (k14_noise(nx, ny, mp.seed_x) - 0.5f) * 2.0f;
    v = v + (k14_noise(nx, ny, mp.seed_y) - 0.5f) * 2.0f;
  }
  const int ui = (int)k14_coord(u, mp.hi), vi = (int)k14_coord(v, mp.hi);
  const float d = __ldg(mp.depth + (size_t)vi * mp.side + ui);
  // torch.clamp(n_dot_l, 0, 1): a NaN stays NaN (and then never occludes)
  const float ndl = k14_ndl(mp, px);
  const float c = isnan(ndl) ? ndl : fminf(fmaxf(ndl, 0.0f), 1.0f);
  const float bias = (1.5f + 2.0f * (1.0f - c)) * mp.bias_scale;
  return inside && d > s[2] + bias ? 0.0f : 1.0f;
}

// the checkerboard's fetching lane of row y (0 or 1), the same for the
// whole row
__device__ __forceinline__ int k14_fetch_lane(int row0, int y, int parity) {
  return (row0 + y + parity) & 1;
}

// the pair whose tap the filling pixel of pair i takes beside its own:
// i + 1 where lane 0 fetches, i - 1 where lane 1 does; -1 past the row's
// ends (where the fill is clamped to val_i)
__device__ __forceinline__ int k14_fill_pair(int i, int rp, int pairs) {
  const int j = rp == 0 ? i + 1 : i - 1;
  return j < 0 || j >= pairs ? -1 : j;
}

// checker.expand's fill of a non-fetching pixel
__device__ __forceinline__ float k14_fill(float val_i, float val_j) {
  return 0.5f * (val_i + val_j);
}
