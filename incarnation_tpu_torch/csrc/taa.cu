// K3: the TAA resolve, and its history fetch alone.
//
// Replaces the Pallas kernel incarnation_tpu/kernels/taa.py
// _taa_fetch_kernel (launched by _history_fetch_pallas), and the jnp around
// it in taa_resolve (taa.py:248-383): the neighbourhood clamp and the blend.
// Two C entries:
// - k3_taa_fetch: the reprojected bilinear history fetch alone
//   (kernels/taa.py history_fetch; m read on the card). Per pixel it
//   reprojects the pixel centre through m = inv_view_proj @ prev_view_proj
//   at its depth (taa.py:140-149) and fetches last frame's accumulation
//   bilinearly with edge clamp.
// - k3_taa_resolve: the whole resolve in one launch (kernels/taa.py
//   taa_resolve on CUDA tensors; its twin taa_resolve_plain). Per pixel:
//   the fetch in one of three roles (K3_REPROJECT: the fetch above, m by
//   value; K3_SHIFT: the static camera's constant sub-pixel shift, its
//   whole and fractional pixels by value, as bilinear_const_shift forms
//   them on the host; K3_GIVEN: a prev_color tensor, the stochastic
//   history fetch's), the 3x3 min and max of the current HDR with
//   replicate edges (a band of a band-sharded frame reads its neighbours'
//   rows above and below in their place), the clamp, the two luminance
//   weights and the 0.1 / 0.9 blend, into a new (H, W, 3) output.
//
// Design for Hopper: one thread per pixel, blocks of 32 x 8 pixels, so
// that most of the nine 3x3 neighbours a thread reads were loaded by its
// own block (L1); the fetch's loads are issued first. The kernel is bound
// by its instructions, not its bytes, so the neighbourhood takes fminf and
// fmaxf with one NaN flag a channel in place of a NaN test in each min and
// max. An exact f32 bilinear fetch from
// the (H, W, 3) history: no +-16-row / +-1-tile window and no bf16
// history, which exist on the TPU only to keep the fetch inside VMEM and
// on the MXU. The fetch arithmetic is one __device__ function
// (k3_reproject) that both kernels call.
//
// Rounding: the twin's operations in its order (built --fmad=false):
// torch.minimum / maximum propagate a NaN (fminf does not): the clamp's
// min and max take the NaN operand first, and the neighbourhood's are NaN
// once a NaN is seen;
// 1.0 / (1.0 + lum) is torch's reciprocal times 1.0; lum is three
// separately rounded products summed left to right; each Python number is
// the float torch rounds it to, (float) of its double. So every value
// equals the twin's bit for bit.
//
// y_off: a band of a band-sharded frame (dist/sharding.py) passes its
// history with y_off halo rows copied from the neighbouring bands above and
// below the (height, width) viewport; rows then address into the halo
// before they clamp (taa.py _bilinear_image y_off). 0 for a whole frame.
//
// What bounds it: bytes. The fetch alone: 4 B depth + 12 B of history (the
// fetch is local, so each history texel is read about once) + 12 B out per
// pixel = 58 MB at 1920x1088, ~17 us at 3.35 TB/s. The resolve adds the
// current HDR's 12 B a pixel: 84 MB, ~25 us (K3_SHIFT reads no depth,
// K3_GIVEN a prev_color in the history's place). Staging the block's
// pixels and their ring in shared memory before or after the fetch was
// slower (PERF.md, the kernel table).

#include <cuda_runtime.h>

#define K3_THREADS 256
#define K3R_BX 32
#define K3R_BY 8

#define K3_REPROJECT 0
#define K3_SHIFT 1
#define K3_GIVEN 2

// The resolve's fetch, by value (kernels/taa.py K3Params)
struct K3Params {
  float m[16];        // inv_view_proj @ prev_view_proj, row-major (K3_REPROJECT)
  int ix, iy;         // the shift's whole pixels (K3_SHIFT)
  float tx, ty;       // its fractions
  float rx, ry;       // float(1 - tx), float(1 - ty), as torch rounds them
  int role;           // K3_REPROJECT, K3_SHIFT or K3_GIVEN
};

// the reprojected bilinear fetch of pixel (x, y) at depth z: the twin's
// reproject_uv and bilinear_image, operation by operation
__device__ __forceinline__ void k3_reproject(const float* __restrict__ history,
                                             const float* m, float z, int x,
                                             int y, int width, int height,
                                             int y_off, float (&c)[3]) {
  const float xs = (float)x + 0.5f;
  const float ys = (float)y + 0.5f;
  const float nx = 2.0f * xs / (float)width - 1.0f;
  const float ny = -2.0f * ys / (float)height + 1.0f;
  const float cx = nx * m[0] + ny * m[4] + z * m[8] + m[12];
  const float cy = nx * m[1] + ny * m[5] + z * m[9] + m[13];
  const float cw = nx * m[3] + ny * m[7] + z * m[11] + m[15];
  const float inv_w = fabsf(cw) > 1e-20f ? 1.0f / cw : 0.0f;
  const float u = 0.5f * cx * inv_w + 0.5f;
  const float v = -0.5f * cy * inv_w + 0.5f;
  const float fx = u * (float)width - 0.5f;
  const float fy = v * (float)height - 0.5f;
  // floor, kept in [-1, size] (rows: [-1 - y_off, height + y_off]) before
  // the int conversion (the twin does the same, so far-off reprojections
  // clamp identically)
  const float x0f = fminf(fmaxf(floorf(fx), -1.0f), (float)width);
  const float y0f = fminf(fmaxf(floorf(fy), -1.0f - (float)y_off),
                          (float)(height + y_off));
  const int x0 = (int)x0f;
  const int y0 = (int)y0f;
  const float tx = fx - x0f;
  const float ty = fy - y0f;
  const int x0c = min(max(x0, 0), width - 1);
  const int x1c = min(max(x0 + 1, 0), width - 1);
  const int y0c = min(max(y0, -y_off), height - 1 + y_off) + y_off;
  const int y1c = min(max(y0 + 1, -y_off), height - 1 + y_off) + y_off;
  const float* h00 = history + 3 * ((size_t)y0c * width + x0c);
  const float* h01 = history + 3 * ((size_t)y0c * width + x1c);
  const float* h10 = history + 3 * ((size_t)y1c * width + x0c);
  const float* h11 = history + 3 * ((size_t)y1c * width + x1c);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float top = __ldg(h00 + k) * (1.0f - tx) + __ldg(h01 + k) * tx;
    const float bot = __ldg(h10 + k) * (1.0f - tx) + __ldg(h11 + k) * tx;
    c[k] = top * (1.0f - ty) + bot * ty;
  }
}

__global__ void __launch_bounds__(K3_THREADS)
k3_taa_fetch_kernel(const float* __restrict__ history,  // (H + 2 y_off, W, 3)
                    const float* __restrict__ depth,    // (H, W)
                    const float* __restrict__ m,        // (4, 4) row-major
                    float* __restrict__ out,            // (H, W, 3)
                    int width, int height, int y_off) {
  const int i = blockIdx.x * K3_THREADS + threadIdx.x;
  if (i >= width * height) return;
  float mm[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) mm[k] = __ldg(m + k);
  float c[3];
  k3_reproject(history, mm, depth[i], i % width, i / width, width, height,
               y_off, c);
#pragma unroll
  for (int k = 0; k < 3; ++k) out[3 * i + k] = c[k];
}

// torch.minimum / torch.maximum: a NaN operand wins, the first one first
__device__ __forceinline__ float k3_min(float a, float b) {
  return a != a ? a : b != b ? b : fminf(a, b);
}
__device__ __forceinline__ float k3_max(float a, float b) {
  return a != a ? a : b != b ? b : fmaxf(a, b);
}

// _luminance_weight: 1 / (1 + lum), torch's reciprocal times 1.0
__device__ __forceinline__ float k3_lum_weight(const float (&c)[3]) {
  const float lum = (c[0] * (float)0.299 + c[1] * (float)0.587) +
                    c[2] * (float)0.114;
  return 1.0f / (lum + 1.0f);
}

__global__ void __launch_bounds__(K3R_BX * K3R_BY)
k3_taa_resolve_kernel(const float* __restrict__ cur,      // (H, W, 3)
                      const float* __restrict__ history,  // (H + 2 y_off, W, 3)
                      const float* __restrict__ depth,    // (H, W)
                      const float* __restrict__ prev,     // (H, W, 3) or NULL
                      const float* __restrict__ above,    // (1, W, 3) or NULL
                      const float* __restrict__ below,    // (1, W, 3) or NULL
                      const K3Params p, float* __restrict__ out, int width,
                      int height, int y_off) {
  const int x = blockIdx.x * K3R_BX + threadIdx.x;
  const int y = blockIdx.y * K3R_BY + threadIdx.y;
  if (x >= width || y >= height) return;
  const size_t i = (size_t)y * width + x;

  // the fetch first, so that its loads are in flight with the
  // neighbourhood's
  float pc[3];
  if (p.role == K3_REPROJECT) {
    k3_reproject(history, p.m, __ldg(depth + i), x, y, width, height, y_off,
                 pc);
  } else if (p.role == K3_SHIFT) {
    // bilinear_const_shift: the replicate pad is a clamp into the history
    // with its halo rows (|shift| <= 3 stays inside the pad of 4)
    const int hh = height + 2 * y_off;
    const int r0 = min(max(y + y_off + p.iy, 0), hh - 1);
    const int r1 = min(max(y + y_off + p.iy + 1, 0), hh - 1);
    const int c0 = min(max(x + p.ix, 0), width - 1);
    const int c1 = min(max(x + p.ix + 1, 0), width - 1);
    const float* g00 = history + 3 * ((size_t)r0 * width + c0);
    const float* g01 = history + 3 * ((size_t)r0 * width + c1);
    const float* g10 = history + 3 * ((size_t)r1 * width + c0);
    const float* g11 = history + 3 * ((size_t)r1 * width + c1);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float top = __ldg(g00 + k) * p.rx + __ldg(g01 + k) * p.tx;
      const float bot = __ldg(g10 + k) * p.rx + __ldg(g11 + k) * p.tx;
      pc[k] = top * p.ry + bot * p.ty;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 3; ++k) pc[k] = __ldg(prev + 3 * i + k);
  }

  // the 3x3 neighbourhood in the twin's order: rows -1, 0, 1 (a band's
  // halo row past its top and bottom, else the edge row), columns -1, 0,
  // 1 in each, clamped into the frame, the centre skipped; mins and maxs
  // start at the centre. torch.minimum and maximum make the running min
  // and max NaN from the first NaN on: fminf and fmaxf in the same order
  // give every other value's bits, and a NaN seen makes both NaN.
  float c[3], lo[3], hi[3];
  bool nan[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    c[k] = lo[k] = hi[k] = __ldg(cur + 3 * i + k);
    nan[k] = isnan(c[k]);
  }
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
    const int yy = y + dy;
    const float* row;
    if (yy < 0)
      row = above ? above : cur;
    else if (yy >= height)
      row = below ? below : cur + 3 * (size_t)(height - 1) * width;
    else
      row = cur + 3 * (size_t)yy * width;
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      if (dx == 0 && dy == 0) continue;
      const float* s = row + 3 * min(max(x + dx, 0), width - 1);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float v = __ldg(s + k);
        lo[k] = fminf(lo[k], v);
        hi[k] = fmaxf(hi[k], v);
        nan[k] = nan[k] || isnan(v);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k)
    if (nan[k]) lo[k] = hi[k] = __int_as_float(0x7fffffff);
  float cl[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) cl[k] = k3_min(k3_max(pc[k], lo[k]), hi[k]);
  const float w_cur = k3_lum_weight(c) * (float)0.1;
  const float w_prev = k3_lum_weight(cl) * (float)0.9;
  const float wsum = w_cur + w_prev;
#pragma unroll
  for (int k = 0; k < 3; ++k)
    out[3 * i + k] = (c[k] * w_cur + cl[k] * w_prev) / wsum;
}

extern "C" int k3_taa_fetch(const float* history, const float* depth,
                            const float* m, float* out, int width,
                            int height, int y_off, void* stream) {
  if (y_off < 0) return (int)cudaErrorInvalidValue;
  const int n = width * height;
  const int blocks = (n + K3_THREADS - 1) / K3_THREADS;
  k3_taa_fetch_kernel<<<blocks, K3_THREADS, 0, (cudaStream_t)stream>>>(
      history, depth, m, out, width, height, y_off);
  return (int)cudaGetLastError();
}

extern "C" int k3_taa_resolve(const float* cur, const float* history,
                              const float* depth, const float* prev,
                              const float* above, const float* below,
                              K3Params p, float* out, int width, int height,
                              int y_off, void* stream) {
  if (width < 1 || height < 1 || y_off < 0 || p.role < K3_REPROJECT ||
      p.role > K3_GIVEN || (p.role == K3_GIVEN && !prev) ||
      (p.role != K3_GIVEN && !history) || (p.role == K3_REPROJECT && !depth) ||
      (!above) != (!below))
    return (int)cudaErrorInvalidValue;
  const dim3 block(K3R_BX, K3R_BY);
  const dim3 grid((width + K3R_BX - 1) / K3R_BX,
                  (height + K3R_BY - 1) / K3R_BY);
  k3_taa_resolve_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      cur, history, depth, prev, above, below, p, out, width, height, y_off);
  return (int)cudaGetLastError();
}
