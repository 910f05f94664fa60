// K14: the sun shadow-map tap, one launch a frame.
//
// It replaces no Pallas kernel: the JAX package writes this pass in jnp
// (incarnation_tpu/kernels/shadow.py sun_visibility :103-154 with _noise
// :157-164, called at renderer/frame.py:545). The torch twin
// (kernels/shadow.py sun_visibility_plain) runs about 80 eager launches a
// frame over the 2,088,960 pixels of a 1920 x 1088 frame: the
// checkerboard's compaction copies, two noise hashes of about 10 int64
// passes each, a matmul, the clamps and casts, the gather, the bias and
// the checkerboard's expansion. Here it is one launch, which reads
// world_pos and n_dot_l in place and writes the (H, W) visibility.
//
// Roles (one C entry, k14_sun_tap): exact (no dither, no checkerboard), a
// tap jittered by the frame noise (dither), and either of them under the
// checkerboard half-rate fetch (parity >= 0; kernels/checker.py). In each,
// the slope bias's n.l is given as an (H, W) plane, or formed from the
// normal (H, W, 3) and the sun direction (3,) read on the card (the "+nl"
// roles, which the frame's sun term takes: kernels/shading.py sun_term),
// as the twin's torch.sum(normal * sun_dir, -1) sums three on the card:
// (x + z) + y, each product rounded.
// - Without the checkerboard, k14_tap_kernel: a thread a pixel.
// - With it, k14_checker_kernel: a thread per horizontal pair of a row,
//   rows in blockIdx.y. The fetching lane of pair i in row y is
//   (row0 + y + parity) & 1, and its noise hashes the compacted position
//   (i, row0 + y), as the twin's tap of checker.compact's (H, W/2)
//   inputs. The other lane takes 0.5 (val_i + val_i+-1) (lane 0 fetching:
//   the pair to the right; lane 1: to the left), clamped to val_i at the
//   row's ends (checker.expand). The neighbour's value comes by a shuffle
//   from the next or previous lane; the one lane at the warp's edge whose
//   neighbour lies in another warp computes that tap itself (the map is
//   4 MiB and stays in L2). A thread writes its pair as one float2.
//
// The tap, the twin's (sun_map_tap) operation by operation (--fmad=false):
// s = ((x m0j + y m1j) + z m2j) + m3j (mathutils.rows_mat and the affine
// row), inside |sx|, |sy| <= 1 from the raw s, u = (sx 0.5 + 0.5) S,
// v = (0.5 - sy 0.5) S, with dither u += (xi - 0.5) 2 (xi the frame noise,
// the JAX package's uint32 hash: frame_noise's int64 arithmetic modulo
// 2^32 is this uint32 arithmetic, the seed frame * mult formed on the
// host), nan_to_num, a float clamp to [0, S - 1], truncation, one texel at
// v S + u of the f32 (S, S) map; bias (1.5 + 2 (1 - clamp(n.l, 0, 1)))
// (2 / S) with 2 / S the float torch rounds it to and torch's clamp (a
// NaN passes); visibility 0 where inside and map > sz + bias, else 1. So
// every value equals the twin's bit for bit.
//
// What bounds it: bytes. Each fetching pixel reads 16 B (position and
// n.l; 24 B with the normal in n.l's place), every pixel writes 4 B, and each texel read comes once from the
// 4 MiB map (about 48,000 texels on the atrium frame): 42 MB (0.0125 ms
// at 3.35 TB/s) without the checkerboard, 25 MB (0.0075 ms) with it.
// Operations are 35 a fetching pixel, 45 with dither and its 20 integer
// ones (0.001 ms at 67 TFLOP/s).

#include <cuda_runtime.h>
#include <float.h>

#define K14_THREADS 256

struct K14Map {
  const float* __restrict__ depth;  // (S, S)
  int side;                         // S
  float fside, hi;                  // S, S - 1 as floats
  float bias_scale;                 // float(2 / S)
  bool dither;
  unsigned seed_x, seed_y;          // frame * N_PCF_X, frame * N_PCF_Y
  const float* __restrict__ vp;     // sun_vp (4, 4), on the card
  const float* __restrict__ nrm;    // (H, W, 3) normals, or NULL: n.l given
  const float* __restrict__ sun;    // sun_dir (3,), on the card, with nrm
};

// the slope bias's n.l of pixel px: given, or formed from the normal as
// torch.sum(n * sun_dir, -1) on the card, (x + z) + y
__device__ __forceinline__ float k14_ndl(const K14Map& mp,
                                         const float* __restrict__ ndl,
                                         size_t px) {
  if (!mp.nrm) return __ldg(ndl + px);
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

// the visibility of one fetching pixel: its position p, its n.l, its
// noise coordinates (nx, ny)
__device__ __forceinline__ float k14_tap(const K14Map& mp,
                                         const float (&m)[4][3],
                                         const float* __restrict__ p,
                                         float ndl, unsigned nx,
                                         unsigned ny) {
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
  const float c = isnan(ndl) ? ndl : fminf(fmaxf(ndl, 0.0f), 1.0f);
  const float bias = (1.5f + 2.0f * (1.0f - c)) * mp.bias_scale;
  return inside && d > s[2] + bias ? 0.0f : 1.0f;
}

__global__ void __launch_bounds__(K14_THREADS)
k14_tap_kernel(K14Map mp, const float* __restrict__ wp,
               const float* __restrict__ ndl, int width, int height,
               int row0, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * K14_THREADS + threadIdx.x;
  if (i >= (long long)width * height) return;
  const int x = (int)(i % width), y = (int)(i / width);
  float m[4][3];
  k14_load_vp(mp, m);
  out[i] = k14_tap(mp, m, wp + 3 * i, k14_ndl(mp, ndl, i), (unsigned)x,
                   (unsigned)(row0 + y));
}

__global__ void __launch_bounds__(K14_THREADS)
k14_checker_kernel(K14Map mp, const float* __restrict__ wp,
                   const float* __restrict__ ndl, int width, int row0,
                   int parity, float* __restrict__ out) {
  const int y = blockIdx.y, hw = width / 2;
  const int i = blockIdx.x * K14_THREADS + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int rp = (row0 + y + parity) & 1;      // the fetching lane
  const unsigned ny = (unsigned)(row0 + y);
  const size_t row = (size_t)y * width;
  float m[4][3];
  k14_load_vp(mp, m);
  float val = 0.0f;
  if (i < hw) {
    const size_t px = row + 2 * i + rp;
    val = k14_tap(mp, m, wp + 3 * px, k14_ndl(mp, ndl, px), (unsigned)i,
                  ny);
  }
  // the neighbour pair's value: i + 1 where lane 0 fetches, i - 1 where
  // lane 1 does (rp is the same for the whole row, so for the warp)
  const float from = rp == 0 ? __shfl_down_sync(0xffffffffu, val, 1)
                             : __shfl_up_sync(0xffffffffu, val, 1);
  if (i >= hw) return;
  const int j = rp == 0 ? i + 1 : i - 1;
  float nb;
  if (j < 0 || j >= hw) {
    nb = val;                                   // the row's end: clamped
  } else if (rp == 0 ? lane == 31 : lane == 0) {
    const size_t px = row + 2 * j + rp;         // across the warp's edge
    nb = k14_tap(mp, m, wp + 3 * px, k14_ndl(mp, ndl, px), (unsigned)j,
                 ny);
  } else {
    nb = from;
  }
  const float fill = 0.5f * (val + nb);
  reinterpret_cast<float2*>(out + row)[i] =
      rp == 0 ? make_float2(val, fill) : make_float2(fill, val);
}

extern "C" int k14_sun_tap(const float* wp, const float* ndl,
                           const float* depth, const float* sun_vp,
                           int width, int height, int side, float bias_scale,
                           int dither, unsigned seed_x, unsigned seed_y,
                           int parity, int row0, float* out,
                           const float* nrm, const float* sun, void* stream) {
  if (width < 1 || height < 1 || side < 1 || parity < -1 || parity > 1 ||
      row0 < 0 || (parity >= 0 && width % 2) || (!nrm) != (!sun) ||
      (!nrm) == (!ndl))
    return (int)cudaErrorInvalidValue;
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
  const cudaStream_t s = (cudaStream_t)stream;
  if (parity < 0) {
    const long long n = (long long)width * height;
    const unsigned blocks = (unsigned)((n + K14_THREADS - 1) / K14_THREADS);
    k14_tap_kernel<<<blocks, K14_THREADS, 0, s>>>(mp, wp, ndl, width,
                                                  height, row0, out);
  } else {
    const dim3 grid((width / 2 + K14_THREADS - 1) / K14_THREADS, height);
    k14_checker_kernel<<<grid, K14_THREADS, 0, s>>>(mp, wp, ndl, width,
                                                    row0, parity, out);
  }
  return (int)cudaGetLastError();
}
