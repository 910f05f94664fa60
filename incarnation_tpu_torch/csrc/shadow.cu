// K14: the sun shadow-map tap alone.
//
// It replaces no Pallas kernel: the JAX package writes this pass in jnp
// (incarnation_tpu/kernels/shadow.py sun_visibility :103-154 with _noise
// :157-164, called at renderer/frame.py:545). The torch twin
// (kernels/shadow.py sun_visibility_plain) runs about 80 eager launches a
// frame over the 2,088,960 pixels of a 1920 x 1088 frame: the
// checkerboard's compaction copies, two noise hashes of about 10 int64
// passes each, a matmul, the clamps and casts, the gather, the bias and
// the checkerboard's expansion. Here it is one launch, which reads
// world_pos and the normals in place and writes the (H, W) visibility.
//
// The frame's sun term taps the map inside K15's launch (csrc/shading.cu,
// its map role), so no frame launches K14; this entry is the tap alone,
// which chip_smoke.py, the tools and the card tests hold to the twin at
// every pixel. The tap's device code and the checkerboard's rule are
// csrc/k14_tap.cuh, which K15 includes too.
//
// Roles (one C entry, k14_sun_tap): exact (no dither, no checkerboard), a
// tap jittered by the frame noise (dither), and either of them under the
// checkerboard half-rate fetch (parity >= 0; kernels/checker.py). In each
// (the "+nl" roles), the slope bias's n.l is formed from the normal
// (H, W, 3) and the sun direction (3,) read on the card.
// - Without the checkerboard, k14_tap_kernel: a thread a pixel.
// - With it, k14_checker_kernel: a thread per horizontal pair of a row,
//   rows in blockIdx.y. The fetching lane's tap and the other lane's fill
//   follow k14_tap.cuh. The neighbour's value comes by a shuffle from the
//   next or previous lane; the one lane at the warp's edge whose
//   neighbour lies in another warp computes that tap itself (the map is
//   4 MiB and stays in L2). A thread writes its pair as one float2.
//
// What bounds it: bytes. Each fetching pixel reads 24 B (its position and
// its normal), every pixel writes 4 B, and each texel read comes once from
// the 4 MiB map (about 48,000 texels on the atrium frame). Under the
// checkerboard the fetching lanes read every second 12-byte pixel, which
// touches every 32-byte sector of both planes, so DRAM moves them whole.
// Operations are 40 a fetching pixel, 50 with dither and its 20 integer
// ones (0.001 ms at 67 TFLOP/s).

#include "k14_tap.cuh"

#define K14_THREADS 256

__global__ void __launch_bounds__(K14_THREADS)
k14_tap_kernel(K14Map mp, const float* __restrict__ wp, int width,
               int height, int row0, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * K14_THREADS + threadIdx.x;
  if (i >= (long long)width * height) return;
  const int x = (int)(i % width), y = (int)(i / width);
  float m[4][3];
  k14_load_vp(mp, m);
  out[i] = k14_tap(mp, m, wp, (size_t)i, (unsigned)x, (unsigned)(row0 + y));
}

__global__ void __launch_bounds__(K14_THREADS)
k14_checker_kernel(K14Map mp, const float* __restrict__ wp, int width,
                   int row0, int parity, float* __restrict__ out) {
  const int y = blockIdx.y, hw = width / 2;
  const int i = blockIdx.x * K14_THREADS + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int rp = k14_fetch_lane(row0, y, parity);
  const unsigned ny = (unsigned)(row0 + y);
  const size_t row = (size_t)y * width;
  float m[4][3];
  k14_load_vp(mp, m);
  float val = 0.0f;
  if (i < hw) val = k14_tap(mp, m, wp, row + 2 * i + rp, (unsigned)i, ny);
  // the neighbour pair's value: i + 1 where lane 0 fetches, i - 1 where
  // lane 1 does (rp is the same for the whole row, so for the warp)
  const float from = rp == 0 ? __shfl_down_sync(0xffffffffu, val, 1)
                             : __shfl_up_sync(0xffffffffu, val, 1);
  if (i >= hw) return;
  const int j = k14_fill_pair(i, rp, hw);
  float nb;
  if (j < 0) {
    nb = val;                                   // the row's end: clamped
  } else if (rp == 0 ? lane == 31 : lane == 0) {
    nb = k14_tap(mp, m, wp, row + 2 * j + rp, (unsigned)j, ny);
  } else {
    nb = from;
  }
  const float fill = k14_fill(val, nb);
  reinterpret_cast<float2*>(out + row)[i] =
      rp == 0 ? make_float2(val, fill) : make_float2(fill, val);
}

extern "C" int k14_sun_tap(const float* wp, const float* depth,
                           const float* sun_vp, int width, int height,
                           int side, float bias_scale, int dither,
                           unsigned seed_x, unsigned seed_y, int parity,
                           int row0, float* out, const float* nrm,
                           const float* sun, void* stream) {
  if (width < 1 || height < 1 || side < 1 || parity < -1 || parity > 1 ||
      row0 < 0 || (parity >= 0 && width % 2) || !nrm || !sun)
    return (int)cudaErrorInvalidValue;
  const K14Map mp = k14_map(depth, sun_vp, side, bias_scale, dither, seed_x,
                            seed_y, nrm, sun);
  const cudaStream_t s = (cudaStream_t)stream;
  if (parity < 0) {
    const long long n = (long long)width * height;
    const unsigned blocks = (unsigned)((n + K14_THREADS - 1) / K14_THREADS);
    k14_tap_kernel<<<blocks, K14_THREADS, 0, s>>>(mp, wp, width, height,
                                                  row0, out);
  } else {
    const dim3 grid((width / 2 + K14_THREADS - 1) / K14_THREADS, height);
    k14_checker_kernel<<<grid, K14_THREADS, 0, s>>>(mp, wp, width, row0,
                                                    parity, out);
  }
  return (int)cudaGetLastError();
}
