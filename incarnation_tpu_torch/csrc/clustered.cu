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

// K11: the light-cluster grid, the (C, W32) bitmask words K2 reads.
//
// It replaces no Pallas kernel: the JAX package writes this pass in jnp
// (incarnation_tpu/kernels/clustered.py build_light_clusters :103-148 with
// _cluster_corners :47-100). Its torch twin (kernels/clustered.py
// build_light_clusters_plain) runs about 40 eager operators a frame over
// tensors of a few thousand rows; here it is one launch, which takes the
// projection, the inverse view-projection and the light table as device
// pointers (no copy to the host, no synchronize).
//
// A warp per cluster (id x + gx y + gx gy z, the reference's). First the
// block stages each light's position, range (MAX_LIGHT_RANGE where range
// <= 0) and whether it is active (punctual, index < count) in shared
// memory, while its warps go on to the planes: lanes 0-7 form the
// cluster's 8 NDC corners (the slice's view depths by powf, projected to
// NDC z) and their world positions; lanes 0-5 its 6 planes from three
// corners each (shuffles): the normal cross(b - a, c - a), the offset -n.a
// and |n|; every lane then takes the 30 plane values (shuffles). For each
// word w of 32 lights, lane k tests light 32 w + k: it is inside where it
// is active and dot(n, p) + d + |n| r >= 0 for all six planes, and the
// warp's ballot is the word. culled = active x C - sum(inside): each warp
// adds popc(active) - popc(inside) of its words; a block sums its warps'
// in shared memory and adds the sum to a 64-bit counter of the wrapper's
// scratch; the last block (an atomic ticket) writes the count and leaves
// the scratch zero. Integer sums, so the count is exact in any order.
//
// Arithmetic: the twin's, operation by operation (--fmad=false): the
// products with the projection and the inverse view-projection are sums
// left to right (mathutils.rows_mat), the cross products and dot products
// mathutils.cross3 and dot3, each division by a Python number (a grid
// size) a multiplication by its float reciprocal as torch does it on the
// card, the others IEEE divisions; powf and sqrtf are the functions torch
// calls. So the words equal the twin's bit for bit.
//
// What bounds it: not bytes (the two matrices, 20 bytes a light, 4 bytes a
// word and the count: about 43 KB at 16 x 9 x 24 and 66 lights, 13 ns at
// 3.35 TB/s) nor operations (1.3 x 10^7, 0.19 us at 67 TFLOP/s): a
// launch and latency. A block of K11_WARPS clusters, so that the 3,456
// clusters of the default grid spread over every SM in one wave; the light
// rows staged once a block, so that no warp waits on a load of them after
// its planes (14% faster than each lane loading its light per word;
// PERF.md).

#define K11_WARPS 8
#define K11_THREADS (K11_WARPS * 32)
#define K11_MAX_LIGHT_RANGE 4.0f   // clustered.py MAX_LIGHT_RANGE
#define K11_LIGHT_DIRECTIONAL 0    // scene/lights.py LIGHT_DIRECTIONAL

// the three corners (a, b, c) of each plane: near, far, left, right, top,
// bottom (clustered.py build_light_clusters_plain)
__constant__ int k11_plane_corners[6][3] = {
    {0, 1, 3}, {4, 7, 5}, {0, 3, 4}, {1, 5, 2}, {2, 6, 3}, {0, 4, 1}};

__global__ void __launch_bounds__(K11_THREADS)
k11_light_grid_kernel(const float* __restrict__ proj,      // (4, 4)
                      const float* __restrict__ ivp,       // (4, 4)
                      const float* __restrict__ xform,     // (L, 4, 4)
                      const float* __restrict__ range,     // (L,)
                      const int* __restrict__ type,        // (L,)
                      int num_lights, int count, int w32, int gx, int gy,
                      int gz, float near_plane, float depth_ratio,
                      float step_x, float step_y,
                      int* __restrict__ words,             // (C, w32)
                      long long* __restrict__ culled,      // ()
                      unsigned long long* __restrict__ scratch) {
  __shared__ int s_culled[K11_WARPS];
  extern __shared__ float4 s_light[];          // (L,) x, y, z, r
  int* s_active = (int*)(s_light + num_lights);
  for (int l = threadIdx.x; l < num_lights; l += K11_THREADS) {
    const float rg = __ldg(range + l);
    s_light[l] = make_float4(__ldg(xform + 16 * l + 12),
                             __ldg(xform + 16 * l + 13),
                             __ldg(xform + 16 * l + 14),
                             rg > 0.0f ? rg : K11_MAX_LIGHT_RANGE);
    s_active[l] = __ldg(type + l) != K11_LIGHT_DIRECTIONAL && l < count;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int clusters = gx * gy * gz;
  const int cid = blockIdx.x * K11_WARPS + warp;
  int warp_culled = 0;
  float pl[6][5];
  if (cid < clusters) {
    const int cx = cid % gx, cy = (cid / gx) % gy, cz = cid / (gx * gy);
    // corner k of lane k & 7 (_cluster_corners): x0 or x0 + sx, y0 - sy or
    // y0, the near slice for k < 4, the far one after
    const int k = lane & 7;
    const float x0 = 2.0f * (float)cx * (1.0f / (float)gx) - 1.0f;
    const float y0 = -(2.0f * (float)cy * (1.0f / (float)gy) - 1.0f);
    const float e = (k < 4 ? (float)cz : (float)cz + 1.0f) *
                    (1.0f / (float)gz);
    const float zv = near_plane * powf(depth_ratio, e);
    const float pz = ((0.0f * __ldg(proj + 2) + 0.0f * __ldg(proj + 6)) +
                      zv * __ldg(proj + 10)) + 1.0f * __ldg(proj + 14);
    const float pw = ((0.0f * __ldg(proj + 3) + 0.0f * __ldg(proj + 7)) +
                      zv * __ldg(proj + 11)) + 1.0f * __ldg(proj + 15);
    const bool right = k == 1 || k == 2 || k == 5 || k == 6;
    const bool bottom = k == 0 || k == 1 || k == 4 || k == 5;
    const float nx = (right ? x0 + step_x : x0) + 0.0f;
    const float ny = (bottom ? y0 - step_y : y0) + 0.0f;
    const float nz = pz / pw + 0.0f;
    float w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[j] = ((nx * __ldg(ivp + j) + ny * __ldg(ivp + 4 + j)) +
              nz * __ldg(ivp + 8 + j)) + 1.0f * __ldg(ivp + 12 + j);
    const float px = w[0] / w[3], py = w[1] / w[3], pzw = w[2] / w[3];

    // plane p of lane p (lanes 6-31 form plane 0 again, unused)
    const int p = lane < 6 ? lane : 0;
    const int ia = k11_plane_corners[p][0], ib = k11_plane_corners[p][1],
              ic = k11_plane_corners[p][2];
    const float ax = __shfl_sync(0xffffffffu, px, ia),
                ay = __shfl_sync(0xffffffffu, py, ia),
                az = __shfl_sync(0xffffffffu, pzw, ia);
    const float bx = __shfl_sync(0xffffffffu, px, ib),
                by = __shfl_sync(0xffffffffu, py, ib),
                bz = __shfl_sync(0xffffffffu, pzw, ib);
    const float qx = __shfl_sync(0xffffffffu, px, ic),
                qy = __shfl_sync(0xffffffffu, py, ic),
                qz = __shfl_sync(0xffffffffu, pzw, ic);
    const float ux = bx - ax, uy = by - ay, uz = bz - az;
    const float vx = qx - ax, vy = qy - ay, vz = qz - az;
    const float n0 = uy * vz - uz * vy;
    const float n1 = uz * vx - ux * vz;
    const float n2 = ux * vy - uy * vx;
    const float d = -((n0 * ax + n1 * ay) + n2 * az);
    const float len = sqrtf((n0 * n0 + n1 * n1) + n2 * n2);
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      pl[q][0] = __shfl_sync(0xffffffffu, n0, q);
      pl[q][1] = __shfl_sync(0xffffffffu, n1, q);
      pl[q][2] = __shfl_sync(0xffffffffu, n2, q);
      pl[q][3] = __shfl_sync(0xffffffffu, d, q);
      pl[q][4] = __shfl_sync(0xffffffffu, len, q);
    }
  }
  __syncthreads();
  if (cid < clusters) {
    for (int wi = 0; wi < w32; ++wi) {
      const int li = wi * 32 + lane;
      bool active = false, inside = false;
      if (li < num_lights) {
        const float4 lt = s_light[li];
        const float lx = lt.x, ly = lt.y, lz = lt.z, r = lt.w;
        active = s_active[li] != 0;
        inside = active;
#pragma unroll
        for (int q = 0; q < 6; ++q) {
          const float t = (((pl[q][0] * lx + pl[q][1] * ly) + pl[q][2] * lz) +
                           pl[q][3]) + pl[q][4] * r;
          inside = inside && t >= 0.0f;
        }
      }
      const unsigned int word = __ballot_sync(0xffffffffu, inside);
      const unsigned int on = __ballot_sync(0xffffffffu, active);
      if (lane == 0) words[(size_t)cid * w32 + wi] = (int)word;
      warp_culled += __popc(on) - __popc(word);
    }
  }
  if (lane == 0) s_culled[warp] = warp_culled;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long sum = 0;
    for (int i = 0; i < K11_WARPS; ++i) sum += s_culled[i];
    atomicAdd(scratch, (unsigned long long)sum);
    __threadfence();
    const unsigned long long ticket = atomicAdd(scratch + 1, 1ull);
    if (ticket == gridDim.x - 1) {
      // every other block's sum is in: write the count, leave zeros
      __threadfence();
      *culled = (long long)atomicExch(scratch, 0ull);
      atomicExch(scratch + 1, 0ull);
    }
  }
}

extern "C" int k11_light_grid(const float* proj, const float* ivp,
                              const float* xform, const float* range,
                              const int* type, int num_lights, int count,
                              int w32, int gx, int gy, int gz,
                              float near_plane, float depth_ratio,
                              float step_x, float step_y, int* words,
                              long long* culled,
                              unsigned long long* scratch, void* stream) {
  if (gx < 1 || gy < 1 || gz < 1 || num_lights < 1 || count < 0 ||
      w32 != (num_lights + 31) / 32 || !scratch)
    return (int)cudaErrorInvalidValue;
  const int blocks = (gx * gy * gz + K11_WARPS - 1) / K11_WARPS;
  const size_t smem = (size_t)num_lights * (sizeof(float4) + sizeof(int));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        k11_light_grid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  k11_light_grid_kernel<<<blocks, K11_THREADS, smem, (cudaStream_t)stream>>>(
      proj, ivp, xform, range, type, num_lights, count, w32, gx, gy, gz,
      near_plane, depth_ratio, step_x, step_y, words, culled, scratch);
  return (int)cudaGetLastError();
}
