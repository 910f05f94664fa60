// K3: TAA history fetch.
//
// Replaces the Pallas kernel incarnation_tpu/kernels/taa.py
// _taa_fetch_kernel (launched by _history_fetch_pallas). Per pixel it
// reprojects the pixel centre through m = inv_view_proj @ prev_view_proj
// at its depth (taa.py:140-149) and fetches last frame's accumulation
// bilinearly with edge clamp.
//
// Design for Hopper: one thread per pixel with an exact f32 bilinear fetch
// from the (H, W, 3) history -- no +-16-row / +-1-tile window and no bf16
// history, which exist on the TPU only to keep the fetch inside VMEM and on
// the MXU. This is the twin _bilinear_image's function exactly.
//
// y_off: a band of a band-sharded frame (dist/sharding.py) passes its
// history with y_off halo rows copied from the neighbouring bands above and
// below the (height, width) viewport; rows then address into the halo
// before they clamp (taa.py _bilinear_image y_off). 0 for a whole frame.
//
// What bounds it: 4 B depth + 12 B of history (the fetch is local, so each
// history texel is read about once) + 12 B out per pixel = 58 MB at
// 1920x1088, ~17 us at 3.35 TB/s. Built with --fmad=false to round as the
// twin does.

#include <cuda_runtime.h>

#define K3_THREADS 256

__global__ void __launch_bounds__(K3_THREADS)
k3_taa_fetch_kernel(const float* __restrict__ history,  // (H + 2 y_off, W, 3)
                    const float* __restrict__ depth,    // (H, W)
                    const float* __restrict__ m,        // (4, 4) row-major
                    float* __restrict__ out,            // (H, W, 3)
                    int width, int height, int y_off) {
  const int i = blockIdx.x * K3_THREADS + threadIdx.x;
  if (i >= width * height) return;
  const int x = i % width;
  const int y = i / width;
  const float xs = (float)x + 0.5f;
  const float ys = (float)y + 0.5f;
  const float z = depth[i];
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
  const float* h00 = history + 3 * (y0c * width + x0c);
  const float* h01 = history + 3 * (y0c * width + x1c);
  const float* h10 = history + 3 * (y1c * width + x0c);
  const float* h11 = history + 3 * (y1c * width + x1c);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float top = h00[c] * (1.0f - tx) + h01[c] * tx;
    float bot = h10[c] * (1.0f - tx) + h11[c] * tx;
    out[3 * i + c] = top * (1.0f - ty) + bot * ty;
  }
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
