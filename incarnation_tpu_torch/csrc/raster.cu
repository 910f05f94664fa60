// K1: tile fine rasterizer with attribute evaluation.
//
// Replaces the Pallas kernel incarnation_tpu/kernels/raster.py
// _raster_kernel (launched by rasterize_tiles). It computes the same
// function: per screen tile, every (tile, triangle) pair binned to the tile
// plus the every-tile big-triangle list is tested against the tile's pixels
// (3 edge forms >= 0, 0 <= z <= 1, optional strict z < z_limit, optional
// certainly-transparent amask rejection), the reverse-Z depth race keeps
// the largest z, and pass 2 evaluates the winner's attribute planes into 16
// channels (u, v, world normal, world tangent, sign, material id, analytic
// UV derivatives, 2 zero pads).
//
// The depth-only role (the sun shadow map; raster.py RasterParams.depth_only)
// is a compile-time variant of the same kernel, k1_raster_kernel<true>: it
// takes no attribute rows and no amask table, stages no UV planes, runs no
// pass 2 and writes tri and depth only (8 B/px).
//
// Design for Hopper, not the TPU layout: one block per tile, 256 threads,
// each thread owning up to 8 pixels of the (at most 2048-pixel) tile. The
// tile's pairs are staged 128 at a time in shared memory (setup rows read
// by triangle id) and every thread walks them. Each pixel keeps its best
// candidate as ONE 64-bit key (float bits of z << 32 | triangle id + 1): z
// is >= 0 so its bits order like the float, and the max picks the largest
// z and, on equal z, the largest id -- a deterministic tie-break (the TPU
// kernel's depends on pair order). Pass 2 reads the winner's 29-float
// attribute row by triangle id (no pair matching, no one-hot select).
//
// What bounds it: at 1920x1088 the outputs alone are 72 B/px (16 f32
// channels + tri + depth) = 150 MB, ~45 us at 3.35 TB/s; the edge tests
// cost ~20 flops per (pair, pixel). Built with --fmad=false so the edge
// forms round exactly as the plain PyTorch twin's separate multiply and
// add, which makes coverage on the card match the twin bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#define K1_THREADS 256
#define K1_MAX_PPT 8
#define K1_CHUNK 128
#define SETUP_ROWS 12
#define ATTR_ROWS 29
#define AMASK_LANES 34
#define INTERP_CHANNELS 16

__device__ __forceinline__ float addr01(float x, int mode) {
  // amask address mode (raster.py mask_reject addr01): 0 wrap, 1 clamp,
  // 2 mirror; clamped into [0, 1 - 1e-6]
  if (mode == 1) return fminf(fmaxf(x, 0.0f), 0.999999f);
  if (mode == 2) {
    float period = x - 2.0f * floorf(0.5f * x);
    float mir = period < 1.0f ? period : 2.0f - period;
    return fminf(fmaxf(mir, 0.0f), 0.999999f);
  }
  return x - floorf(x);
}

__device__ __forceinline__ int cell_index(float x) {
  int c = (int)(x * 32.0f);
  return c < 0 ? 0 : (c > 31 ? 31 : c);
}

// True when the fragment's UV cell is certainly transparent in its own
// material's 32x32 amask bitplane.
__device__ __forceinline__ bool mask_reject(const float* m, int mat,
                                            float colf, float rowf,
                                            const int* __restrict__ table) {
  float d = m[6] * colf + m[7] * rowf + m[8];
  float inv = fabsf(d) > 1e-20f ? 1.0f / d : 0.0f;
  float u = (m[0] * colf + m[1] * rowf + m[2]) * inv;
  float v = (m[3] * colf + m[4] * rowf + m[5]) * inv;
  const int* row = table + mat * AMASK_LANES;
  int mode = row[32];
  int cell = cell_index(addr01(v, mode)) * 32 + cell_index(addr01(u, mode));
  unsigned int word = (unsigned int)row[cell >> 5];
  return ((word >> (cell & 31)) & 1u) != 0u;
}

template <bool DEPTH_ONLY>
__global__ void __launch_bounds__(K1_THREADS)
k1_raster_kernel(const int* __restrict__ pair_tri,
                 const int* __restrict__ starts,
                 const int* __restrict__ counts,
                 const int* __restrict__ big_tri,
                 const int* __restrict__ big_count,
                 const float* __restrict__ setup,
                 const float* __restrict__ attr,
                 const float* __restrict__ zlim,
                 const int* __restrict__ mask_table, int mask_rows,
                 int* __restrict__ tri_out, float* __restrict__ depth_out,
                 float* __restrict__ interp_out,
                 int width, int height, int tile_h, int tile_w,
                 int tiles_x) {
  __shared__ float s_setup[K1_CHUNK][SETUP_ROWS];
  __shared__ int s_id[K1_CHUNK];
  // UV planes and material of each staged pair: the masked role only
  __shared__ float s_uvd[DEPTH_ONLY ? 1 : K1_CHUNK][9];
  __shared__ int s_mat[DEPTH_ONLY ? 1 : K1_CHUNK];

  const int tile = blockIdx.x;
  const int ty = tile / tiles_x;
  const int tx = tile - ty * tiles_x;
  const int n = tile_h * tile_w;
  const int tid = threadIdx.x;

  float colf[K1_MAX_PPT], rowf[K1_MAX_PPT], zl[K1_MAX_PPT];
  unsigned long long best[K1_MAX_PPT];
  int live_local = 0;
#pragma unroll
  for (int k = 0; k < K1_MAX_PPT; ++k) {
    int p = tid + k * K1_THREADS;
    int py = p / tile_w;
    int gx = tx * tile_w + (p - py * tile_w);
    int gy = ty * tile_h + py;
    colf[k] = (float)gx + 0.5f;
    rowf[k] = (float)gy + 0.5f;
    best[k] = 0ull;
    // pixels beyond the frame read a z limit of 0 (the TPU wrapper pads
    // z_limit with zeros), so they take no fragment
    zl[k] = (zlim != nullptr && p < n && gx < width && gy < height)
                ? zlim[gy * width + gx] : 0.0f;
    live_local |= (p < n && zl[k] > 0.0f);
  }

  int count = counts[tile];
  const int start = starts[tile];
  int bigcnt = big_count[0];
  if (zlim != nullptr) {
    // depth-peel early exit: a tile whose limits are all 0 takes nothing
    if (!__syncthreads_or(live_local)) {
      count = 0;
      bigcnt = 0;
    }
  }
  const int total = count + bigcnt;
  const bool masked = !DEPTH_ONLY && mask_table != nullptr;

  for (int base = 0; base < total; base += K1_CHUNK) {
    const int nb = min(K1_CHUNK, total - base);
    __syncthreads();
    for (int j = tid; j < nb; j += K1_THREADS) {
      int q = base + j;
      int t = q < count ? pair_tri[start + q] : big_tri[q - count];
      s_id[j] = t;
#pragma unroll
      for (int r = 0; r < SETUP_ROWS; ++r)
        s_setup[j][r] = setup[(size_t)t * SETUP_ROWS + r];
      if constexpr (!DEPTH_ONLY) {
        if (masked) {
#pragma unroll
          for (int r = 0; r < 9; ++r)
            s_uvd[j][r] = attr[(size_t)t * ATTR_ROWS + r];
          int mat = (int)attr[(size_t)t * ATTR_ROWS + 28];
          s_mat[j] = mat < 0 ? 0 : (mat >= mask_rows ? mask_rows - 1 : mat);
        }
      }
    }
    __syncthreads();
    for (int j = 0; j < nb; ++j) {
      const float* c = s_setup[j];
      const unsigned long long lo = (unsigned long long)(s_id[j] + 1);
#pragma unroll
      for (int k = 0; k < K1_MAX_PPT; ++k) {
        if (tid + k * K1_THREADS >= n) break;
        float e0 = c[0] * colf[k] + c[1] * rowf[k] + c[2];
        float e1 = c[3] * colf[k] + c[4] * rowf[k] + c[5];
        float e2 = c[6] * colf[k] + c[7] * rowf[k] + c[8];
        float z = c[9] * colf[k] + c[10] * rowf[k] + c[11];
        bool cov = e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f && z <= 1.0f &&
                   z >= 0.0f;
        if (zlim != nullptr) cov = cov && z < zl[k];
        if constexpr (!DEPTH_ONLY) {
          if (cov && masked)
            cov = !mask_reject(s_uvd[j], s_mat[j], colf[k], rowf[k],
                               mask_table);
        }
        if (cov) {
          unsigned long long key =
              ((unsigned long long)(__float_as_uint(z) & 0x7fffffffu) << 32) |
              lo;
          best[k] = key > best[k] ? key : best[k];
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < K1_MAX_PPT; ++k) {
    int p = tid + k * K1_THREADS;
    if (p >= n) break;
    int py = p / tile_w;
    int gx = tx * tile_w + (p - py * tile_w);
    int gy = ty * tile_h + py;
    if (gx >= width || gy >= height) continue;
    size_t o = (size_t)gy * width + gx;
    const bool has = best[k] != 0ull;
    const int id = has ? (int)((best[k] & 0xffffffffull) - 1ull) : -1;
    tri_out[o] = id;
    depth_out[o] = has ? __uint_as_float((unsigned int)(best[k] >> 32)) : 0.0f;
    if constexpr (!DEPTH_ONLY) {
      const size_t plane = (size_t)width * height;
      float ch[INTERP_CHANNELS];
#pragma unroll
      for (int q = 0; q < INTERP_CHANNELS; ++q) ch[q] = 0.0f;
      if (has) {
        // pass 2: the winner's attribute planes, as raster.py:963-984
        const float* a = attr + (size_t)id * ATTR_ROWS;
        float cf = colf[k], rf = rowf[k];
        float d = a[6] * cf + a[7] * rf + a[8];
        float inv_d = fabsf(d) > 1e-20f ? 1.0f / d : 0.0f;
        float u = (a[0] * cf + a[1] * rf + a[2]) * inv_d;
        float v = (a[3] * cf + a[4] * rf + a[5]) * inv_d;
        ch[0] = u;
        ch[1] = v;
        ch[2] = (a[9] * cf + a[10] * rf + a[11]) * inv_d;
        ch[3] = (a[12] * cf + a[13] * rf + a[14]) * inv_d;
        ch[4] = (a[15] * cf + a[16] * rf + a[17]) * inv_d;
        ch[5] = (a[18] * cf + a[19] * rf + a[20]) * inv_d;
        ch[6] = (a[21] * cf + a[22] * rf + a[23]) * inv_d;
        ch[7] = (a[24] * cf + a[25] * rf + a[26]) * inv_d;
        ch[8] = a[27];
        ch[9] = a[28];
        ch[10] = (a[0] - u * a[6]) * inv_d;
        ch[11] = (a[1] - u * a[7]) * inv_d;
        ch[12] = (a[3] - v * a[6]) * inv_d;
        ch[13] = (a[4] - v * a[7]) * inv_d;
      }
#pragma unroll
      for (int q = 0; q < INTERP_CHANNELS; ++q)
        interp_out[q * plane + o] = ch[q];
    }
  }
}

extern "C" int k1_raster(const int* pair_tri, const int* starts,
                         const int* counts, const int* big_tri,
                         const int* big_count, const float* setup,
                         const float* attr, const float* zlim,
                         const int* mask_table, int mask_rows, int* tri_out,
                         float* depth_out, float* interp_out, int width,
                         int height, int tile_h, int tile_w, int tiles_x,
                         int num_tiles, void* stream) {
  if (tile_h * tile_w > K1_THREADS * K1_MAX_PPT)
    return (int)cudaErrorInvalidValue;
  k1_raster_kernel<false><<<num_tiles, K1_THREADS, 0, (cudaStream_t)stream>>>(
      pair_tri, starts, counts, big_tri, big_count, setup, attr, zlim,
      mask_table, mask_rows, tri_out, depth_out, interp_out, width, height,
      tile_h, tile_w, tiles_x);
  return (int)cudaGetLastError();
}

// The depth-only role: no attribute rows, no amask table, no interp output.
extern "C" int k1_raster_depth(const int* pair_tri, const int* starts,
                               const int* counts, const int* big_tri,
                               const int* big_count, const float* setup,
                               const float* zlim, int* tri_out,
                               float* depth_out, int width, int height,
                               int tile_h, int tile_w, int tiles_x,
                               int num_tiles, void* stream) {
  if (tile_h * tile_w > K1_THREADS * K1_MAX_PPT)
    return (int)cudaErrorInvalidValue;
  k1_raster_kernel<true><<<num_tiles, K1_THREADS, 0, (cudaStream_t)stream>>>(
      pair_tri, starts, counts, big_tri, big_count, setup, nullptr, zlim,
      nullptr, 0, tri_out, depth_out, nullptr, width, height, tile_h, tile_w,
      tiles_x);
  return (int)cudaGetLastError();
}
