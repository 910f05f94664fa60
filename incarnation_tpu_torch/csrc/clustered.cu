// K2: clustered punctual lighting.
//
// Replaces the Pallas kernel incarnation_tpu/kernels/clustered.py
// _clustered_block_kernel (launched by _clustered_lighting_pallas). It
// computes the same function as the dense twin clustered_lighting_dense:
// per covered pixel, the cluster id (x cell, y cell, exponential z slice of
// its depth) selects the cluster's light bitmask words, and every light
// whose bit is set adds punctual radiance (range falloff x spot window x
// 10000 x intensity) x (GGX Cook-Torrance + Lambert) into RGB, lights in
// ascending index.
//
// Design for Hopper: one thread per pixel. The TPU kernel walks a per
// 32x128-block light list and selects among <= 2x2 cluster cells (the
// _pallas_cells_ok restriction); here each thread reads its own cluster's
// (C, W32) mask words directly, so any frame size and cluster grid runs.
//
// What bounds it: arithmetic per (pixel, light of its cluster), not bytes
// (64 B/px of gbuffer in and out, ~42 us at 3.35 TB/s at 1920x1088). The
// clusters are conservative spheres, so many of a cluster's lights add
// exactly nothing at a given pixel. The design:
// - a prologue stages per-light constants in shared memory once per block
//   (position, 10000 x intensity x colour, range, spot direction, cos_out
//   and the spot scale) and the z-slice bounds, found per pixel by a
//   binary search (the count of bounds <= view z, the twin's slice);
// - a light whose contribution is exactly +0.0 in the twin is skipped
//   before the BRDF: the pixel lies beyond its range (falloff 0), outside
//   its spot cone (window 0) or behind the surface (NoL <= 0). Every other
//   factor is finite, so the twin adds +0.0 there and the sums, in
//   ascending light order, are unchanged;
// - D x G / (4 NoV NoL) takes one division instead of three, and the spot
//   scale is per light, not per pixel: 7 IEEE divisions per light instead
//   of 11. The light direction keeps the twin's three divisions: a 1-ulp
//   change there reaches NoH, which a glossy GGX lobe amplifies, while the
//   shared division comes after it and moves the product by a few ulps
//   (tests/test_torch_k2_cull.py emulates this arithmetic on the CPU and
//   holds it to the twin). Everything else keeps the twin's operation
//   order (built --fmad=false);
// - a warp shades an 8x4 pixel block, whose lanes share a cluster more
//   often than a 32-pixel row does, so fewer lanes idle while the lane with
//   the most lights finishes.

#include <cuda_runtime.h>
#include <stdint.h>

#define K2_BLOCK_W 32   // a block shades 32 x 8 pixels: 4 x 2 warps of 8 x 4
#define K2_BLOCK_H 8
#define K2_THREADS (K2_BLOCK_W * K2_BLOCK_H)
#define LIGHT_ROW 16
#define LC 16           // floats of per-light constants in shared memory
#define K2_PI 3.14159265358979f
#define K2_INV_PI 0.318309886183791f

__device__ __forceinline__ float clamp01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

__device__ __forceinline__ float pow5(float x) {
  float x2 = x * x;
  return x2 * x2 * x;
}

// Per-light constants: [0..2] position, [3..5] 10000 x intensity x colour,
// [6] range, [7] max(range, 1e-8), [8..10] spot direction, [11] cos_out,
// [12] spot scale 1 / max(cos_in - cos_out, 1e-3), [13] 1 for a spot light.
__global__ void __launch_bounds__(K2_THREADS)
k2_clustered_kernel(const float* __restrict__ base_color,  // (H, W, 4)
                    const float* __restrict__ mrao,        // (H, W, 4)
                    const float* __restrict__ nrm,         // (H, W, 3)
                    const float* __restrict__ view,        // (H, W, 3)
                    const float* __restrict__ wpos,        // (H, W, 3)
                    const uint8_t* __restrict__ mask,      // (H, W)
                    const float* __restrict__ depth,       // (H, W)
                    const int* __restrict__ cluster_mask,  // (C, W32)
                    int w32,
                    const float* __restrict__ lights,      // (L, 16)
                    int num_lights,
                    const float* __restrict__ bounds,      // (gz - 1,)
                    int gx, int gy, int gz, float near_plane,
                    float* __restrict__ out,                // (H, W, 3)
                    int width, int height) {
  extern __shared__ float smem[];
  float* s_light = smem;                       // (num_lights, LC)
  float* s_bounds = smem + num_lights * LC;    // (gz - 1,)
  for (int li = threadIdx.x; li < num_lights; li += K2_THREADS) {
    const float* L = lights + li * LIGHT_ROW;
    float* c = s_light + li * LC;
    const float inten = 10000.0f * L[7];
    c[0] = L[0];
    c[1] = L[1];
    c[2] = L[2];
    c[3] = inten * L[4];
    c[4] = inten * L[5];
    c[5] = inten * L[6];
    c[6] = L[8];
    c[7] = fmaxf(L[8], 1e-8f);
    c[8] = L[9];
    c[9] = L[10];
    c[10] = L[11];
    c[11] = L[13];
    c[12] = 1.0f / fmaxf(L[12] - L[13], 1e-3f);
    c[13] = L[3] == 2.0f ? 1.0f : 0.0f;
  }
  for (int k = threadIdx.x; k < gz - 1; k += K2_THREADS)
    s_bounds[k] = bounds[k];
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x = blockIdx.x * K2_BLOCK_W + (warp & 3) * 8 + (lane & 7);
  const int y = blockIdx.y * K2_BLOCK_H + (warp >> 2) * 4 + (lane >> 3);
  if (x >= width || y >= height) return;
  const int i = y * width + x;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  if (mask[i]) {
    // cluster id (clustered.py pixel_cluster_id): the z slice is the count
    // of bounds <= view z, by binary search over the ascending bounds
    const float view_z = near_plane / fmaxf(depth[i], 1e-6f);
    int lo = 0, hi = gz - 1;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (view_z >= s_bounds[mid]) lo = mid + 1;
      else hi = mid;
    }
    int cx = min(max(x * gx / width, 0), gx - 1);
    int cy = min(max(y * gy / height, 0), gy - 1);
    const int cid = gx * gy * lo + gx * cy + cx;

    const float br = base_color[4 * i], bg = base_color[4 * i + 1],
                bb = base_color[4 * i + 2];
    const float metallic = mrao[4 * i], rough = mrao[4 * i + 1];
    const float nx = nrm[3 * i], ny = nrm[3 * i + 1], nz = nrm[3 * i + 2];
    const float vx = view[3 * i], vy = view[3 * i + 1], vz = view[3 * i + 2];
    const float px = wpos[3 * i], py = wpos[3 * i + 1], pz = wpos[3 * i + 2];
    const float f0r = metallic * br + (1.0f - metallic) * 0.04f;
    const float f0g = metallic * bg + (1.0f - metallic) * 0.04f;
    const float f0b = metallic * bb + (1.0f - metallic) * 0.04f;
    const float fdr = (1.0f - metallic) * br * K2_INV_PI;
    const float fdg = (1.0f - metallic) * bg * K2_INV_PI;
    const float fdb = (1.0f - metallic) * bb * K2_INV_PI;
    const float no_v = clamp01(nx * vx + ny * vy + nz * vz);
    const float a = rough * rough;
    const float a2 = a * a;

    for (int w = 0; w < w32; ++w) {
      unsigned int word = (unsigned int)cluster_mask[cid * w32 + w];
      while (word) {
        const int li = w * 32 + (__ffs(word) - 1);
        word &= word - 1u;
        if (li >= num_lights) break;
        const float* c = s_light + li * LC;
        // punctual radiance (shading.punctual_light); the exact-zero tests
        // first, each with the twin's arithmetic
        const float lx = c[0] - px, ly = c[1] - py, lz = c[2] - pz;
        const float dist_sq = lx * lx + ly * ly + lz * lz;
        const float dist = sqrtf(dist_sq);
        float falloff = 1.0f;
        if (c[6] > 0.0f) {
          const float q = dist / c[7];
          const float q2 = q * q;
          falloff = fmaxf(fminf(1.0f - q2 * q2, 1.0f), 0.0f);
          if (falloff == 0.0f) continue;        // beyond the range
        }
        const float dl = fmaxf(dist, 1e-8f);
        const float ldx = lx / dl, ldy = ly / dl, ldz = lz / dl;
        float angular = 1.0f;
        if (c[13] != 0.0f) {
          const float cd = c[8] * ldx + c[9] * ldy + c[10] * ldz;
          const float cos_out = c[11], scale = c[12];
          float ang = clamp01(cd * scale - cos_out * scale);
          ang = ang * ang;
          angular = cd > cos_out ? ang : 0.0f;
          if (angular == 0.0f) continue;        // outside the cone
        }
        // BRDF (shading.brdf_response)
        const float no_l = clamp01(nx * ldx + ny * ldy + nz * ldz);
        if (!(no_l > 0.0f)) continue;           // behind the surface
        const float radial = c[6] > 0.0f ? falloff / fmaxf(dist_sq, 1e-4f)
                                         : 1.0f / fmaxf(dist_sq, 1e-4f);
        float hx = ldx + vx, hy = ldy + vy, hz = ldz + vz;
        const float hs = 1.0f / sqrtf(hx * hx + hy * hy + hz * hz + 1e-20f);
        hx = hx * hs;
        hy = hy * hs;
        hz = hz * hs;
        const float no_h = clamp01(nx * hx + ny * hy + nz * hz);
        const float vo_h = clamp01(vx * hx + vy * hy + vz * hz);
        const float denom = no_h * no_h * (a2 - 1.0f) + 1.0f;
        const float fw = pow5(1.0f - vo_h);
        const float ggx_v = no_l * sqrtf(no_v * no_v * (1.0f - a) + a);
        const float ggx_l = no_v * sqrtf(no_l * no_l * (1.0f - a) + a);
        // D x G / (4 NoV NoL) in one division (the twin divides three
        // times; each factor comes after the ulp-sensitive NoH, so the
        // product moves by a few ulps, not more)
        const float dg = (a2 * 0.5f) /
            (fmaxf(K2_PI * denom * denom, 1e-4f) *
             fmaxf(ggx_v + ggx_l, 1e-5f) * fmaxf(4.0f * no_v * no_l, 1e-3f));
        const float fr_r = fw + f0r * (1.0f - fw);
        const float fr_g = fw + f0g * (1.0f - fw);
        const float fr_b = fw + f0b * (1.0f - fw);
        const float rad_r = c[3] * radial * angular;
        const float rad_g = c[4] * radial * angular;
        const float rad_b = c[5] * radial * angular;
        acc_r += (dg * fr_r + (1.0f - fr_r) * fdr) * rad_r * no_l;
        acc_g += (dg * fr_g + (1.0f - fr_g) * fdg) * rad_g * no_l;
        acc_b += (dg * fr_b + (1.0f - fr_b) * fdb) * rad_b * no_l;
      }
    }
  }
  out[3 * i] = acc_r;
  out[3 * i + 1] = acc_g;
  out[3 * i + 2] = acc_b;
}

extern "C" int k2_clustered(const float* base_color, const float* mrao,
                            const float* nrm, const float* view,
                            const float* wpos, const uint8_t* mask,
                            const float* depth, const int* cluster_mask,
                            int w32, const float* lights, int num_lights,
                            const float* bounds, int gx, int gy, int gz,
                            float near_plane, float* out, int width,
                            int height, void* stream) {
  const size_t smem = sizeof(float) * ((size_t)num_lights * LC +
                                       (size_t)(gz > 1 ? gz - 1 : 1));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        k2_clustered_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((width + K2_BLOCK_W - 1) / K2_BLOCK_W,
                  (height + K2_BLOCK_H - 1) / K2_BLOCK_H);
  k2_clustered_kernel<<<grid, K2_THREADS, smem, (cudaStream_t)stream>>>(
      base_color, mrao, nrm, view, wpos, mask, depth, cluster_mask, w32,
      lights, num_lights, bounds, gx, gy, gz, near_plane, out, width,
      height);
  return (int)cudaGetLastError();
}
