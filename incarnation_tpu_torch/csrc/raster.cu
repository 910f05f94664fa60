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
// Each pixel keeps its best candidate as ONE 64-bit key (float bits of z <<
// 32 | triangle id + 1): z is >= 0 so its bits order like the float, and the
// max picks the largest z and, on equal z, the largest id. A max does not
// depend on order, so the pairs of one tile may be raced in any grouping.
//
// What bounds it on the H100, and what the design does about it:
// - Load balance. A tile's list ranges from a few pairs to thousands (the
//   sun view stacks storeys and foliage into a few tiles). One block per
//   tile left the launch to the block with the longest list. Here each
//   tile's list (its CSR slice, then the big list) is cut into work items
//   of at most K1_ITEM pairs. Persistent blocks, as many as fit on the
//   card, start on item blockIdx.x and take the next items from a global
//   counter, so the tail is one item. Item t is tile t's first; the extra
//   items of long tiles follow, and where a tile has any, each block lays
//   them out (a scan of the tile counts in shared memory) while its first
//   item's z limits load. A tile with one item races in registers and
//   writes its outputs.
//   A tile with several writes each item's keys to its own slot of a
//   scratch buffer (plain stores, nothing to clear); the item that arrives
//   last at the tile's counter reduces the slots with a max and writes the
//   outputs. The counters are zero when a launch starts and when it ends:
//   the last item of a tile resets the tile's counter and the launch's last
//   take resets the work counter, so a call is one kernel and no memset.
// - Pixel tests. Each warp owns a 32x8 sub-tile (lane: one column, 8
//   rows, so a warp's stores are whole 128-byte rows). Lanes test 32
//   staged pairs at once against the sub-tile as a whole
//   (subtile_may_cover: each plane at the box corner that maximises or
//   minimises it, with a margin above the rounding of the per-pixel
//   evaluation), and the warp walks only the pairs the ballot keeps. A
//   triangle of a few dozen pixels costs its one or two sub-tiles, not the
//   tile. The exact per-pixel test, rounded as the twin's separate multiply
//   and add (built --fmad=false), alone decides coverage, so coverage
//   matches the twin bit for bit.
// - Latency. A small launch (a peel over a few tiles) is a chain of
//   dependent loads, so each is issued as early as it can be: the next
//   item is taken from the counter before the current one is tested, its
//   setup rows (and, in the masked role, its UV planes and material) are
//   copied into the other half of a double buffer with cp.async while the
//   current item's outputs are written, and its z limits are loaded before
//   its rows are waited for. A block's first item stages no rows when its
//   tile's limits are all 0.
// What is left: the outputs, 72 B/px (16 f32 channels + tri + depth; 8 B/px
// depth-only), and 16 flops per (pair, covered pixel).

#include <cuda_runtime.h>
#include <stdint.h>

#define K1_THREADS 256
#define K1_WARPS 8
#define K1_PPL 8          // pixels per lane: one column of 8 rows
#define K1_SUB_W 32       // a warp's sub-tile: 32 columns (one per lane)
#define K1_SUB_H 8        // x 8 rows
#define K1_ITEM 256       // pairs per work item
#define K1_TILE_PX (K1_THREADS * K1_PPL)
#define SETUP_ROWS 12
#define ATTR_ROWS 29
#define AMASK_LANES 34
#define INTERP_CHANNELS 16
#define UV_ROWS 10        // 9 UV plane floats + the material id
#define FULL_MASK 0xffffffffu

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
// material's 32x32 amask bitplane. m: 9 UV plane floats + material id.
__device__ __forceinline__ bool mask_reject(const float* m, int mask_rows,
                                            float colf, float rowf,
                                            const int* __restrict__ table) {
  float d = m[6] * colf + m[7] * rowf + m[8];
  float inv = fabsf(d) > 1e-20f ? 1.0f / d : 0.0f;
  float u = (m[0] * colf + m[1] * rowf + m[2]) * inv;
  float v = (m[3] * colf + m[4] * rowf + m[5]) * inv;
  int mat = (int)m[9];
  mat = mat < 0 ? 0 : (mat >= mask_rows ? mask_rows - 1 : mat);
  const int* row = table + mat * AMASK_LANES;
  int mode = row[32];
  int cell = cell_index(addr01(v, mode)) * 32 + cell_index(addr01(u, mode));
  unsigned int word = (unsigned int)row[cell >> 5];
  return ((word >> (cell & 31)) & 1u) != 0u;
}

// Largest value of a*x + b*y + c over the box [x0, x1] x [y0, y1], plus
// (sign +1) or the smallest minus (sign -1) a margin of 1e-6 of
// |a| x1 + |b| y1 + |c| (coordinates are >= 0): the per-pixel evaluation and
// this one each round within 3 ulps of that sum (2e-7), so the margin holds
// both. raster.py subtile_may_cover is the same arithmetic.
__device__ __forceinline__ float plane_bound(float a, float b, float c,
                                             float x0, float x1, float y0,
                                             float y1, bool upper) {
  float xm = (a > 0.0f) == upper ? x1 : x0;
  float ym = (b > 0.0f) == upper ? y1 : y0;
  float m = a * xm + b * ym + c;
  float margin = 1e-6f * (fabsf(a) * x1 + fabsf(b) * y1 + fabsf(c)) + 1e-30f;
  return upper ? m + margin : m - margin;
}

// False only when no pixel centre of the box can pass the exact test
// (3 edges >= 0, 0 <= z <= 1, z < a limit <= zl_max). NaN keeps the pair.
__device__ __forceinline__ bool subtile_may_cover(const float* c, float x0,
                                                  float x1, float y0, float y1,
                                                  float zl_max) {
  if (plane_bound(c[0], c[1], c[2], x0, x1, y0, y1, true) < 0.0f) return false;
  if (plane_bound(c[3], c[4], c[5], x0, x1, y0, y1, true) < 0.0f) return false;
  if (plane_bound(c[6], c[7], c[8], x0, x1, y0, y1, true) < 0.0f) return false;
  if (plane_bound(c[9], c[10], c[11], x0, x1, y0, y1, true) < 0.0f)
    return false;
  float zmin = plane_bound(c[9], c[10], c[11], x0, x1, y0, y1, false);
  return !(zmin > 1.0f) && !(zmin > zl_max);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Counters, zero at the start and the end of a launch: [0] the work counter
// (items taken past the grid's first), [1, nt + 1) per-tile arrival
// counters.
//
// Items: tile t takes n_t = ceil(pairs / K1_ITEM) items, at least one. Its
// first is item t; the other n_t - 1 are numbered from nt on, tile by tile.
// Where a tile has any, each block lays them out in shared memory
// (base[t]: the first extra item of tile t, less nt; base[nt]: how many
// extra items there are), and returns that count.
__device__ __forceinline__ int items_of_tile(int total) {
  return total > K1_ITEM ? (total + K1_ITEM - 1) / K1_ITEM : 1;
}

__device__ int plan_extra_items(const int* __restrict__ counts, int bigcnt,
                                int num_tiles, int* base) {
  __shared__ int s_warp[K1_WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (num_tiles + K1_THREADS - 1) / K1_THREADS;
  const int t0 = min(tid * per, num_tiles);
  const int t1 = min(t0 + per, num_tiles);
  int sum = 0;
  for (int t = t0; t < t1; ++t) {
    const int n = items_of_tile(counts[t] + bigcnt) - 1;
    base[t] = n;
    sum += n;
  }
  int x = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(FULL_MASK, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  int run = x - sum;
  for (int w = 0; w < warp; ++w) run += s_warp[w];
  for (int t = t0; t < t1; ++t) {
    const int n = base[t];
    base[t] = run;
    run += n;
  }
  if (tid == K1_THREADS - 1) base[num_tiles] = run;
  __syncthreads();
  return base[num_tiles];
}

struct Item {
  int tile, chunk, n_items, q0, nb, count, start;
};

// Item g: tile g's first item, or (g >= nt) the extra item g - nt of the
// last tile t with base[t] <= g - nt, which has extra items.
__device__ __forceinline__ Item item_of(int g, const int* base, int num_tiles,
                                        const int* __restrict__ starts,
                                        const int* __restrict__ counts,
                                        int bigcnt) {
  Item it;
  if (g < num_tiles) {
    it.tile = g;
    it.chunk = 0;
  } else {
    const int e = g - num_tiles;
    int lo = 0, hi = num_tiles - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (base[mid] <= e) lo = mid;
      else hi = mid - 1;
    }
    it.tile = lo;
    it.chunk = e - base[lo] + 1;
  }
  it.count = counts[it.tile];
  it.start = starts[it.tile];
  it.n_items = items_of_tile(it.count + bigcnt);
  it.q0 = it.chunk * K1_ITEM;
  it.nb = min(K1_ITEM, it.count + bigcnt - it.q0);
  return it;
}

template <bool DEPTH_ONLY>
__global__ void __launch_bounds__(K1_THREADS, 2)
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
                 int tiles_x, int num_tiles,
                 unsigned long long* __restrict__ partial, int max_items,
                 int* __restrict__ counters) {
  __shared__ __align__(16) float s_setup[2][K1_ITEM][SETUP_ROWS];
  __shared__ int s_id[2][K1_ITEM];
  // UV planes and material of each staged pair: the masked role only
  __shared__ float s_uv[DEPTH_ONLY ? 1 : 2][DEPTH_ONLY ? 1 : K1_ITEM]
                       [UV_ROWS];
  __shared__ int s_next;
  __shared__ int s_last;
  extern __shared__ int s_base[];   // (num_tiles + 1) extra-item offsets

  int* const counter = counters;
  int* const arrive = counters + 1;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nsx = (tile_w + K1_SUB_W - 1) / K1_SUB_W;
  const int nsy = (tile_h + K1_SUB_H - 1) / K1_SUB_H;
  const int sy = warp / nsx, sx = warp - (warp / nsx) * nsx;
  const bool warp_in = sy < nsy;
  const int lc = sx * K1_SUB_W + lane;   // the lane's column in the tile
  const int lr0 = sy * K1_SUB_H;         // and its first row
  const bool masked = !DEPTH_ONLY && mask_table != nullptr;
  const int bigcnt = big_count[0];

  auto stage = [&](const Item& it, int b) {
    for (int j = tid; j < it.nb; j += K1_THREADS) {
      const int q = it.q0 + j;
      const int t = q < it.count ? pair_tri[it.start + q]
                                 : big_tri[q - it.count];
      s_id[b][j] = t;
      const float* row = setup + (size_t)t * SETUP_ROWS;
      cp_async16(&s_setup[b][j][0], row);
      cp_async16(&s_setup[b][j][4], row + 4);
      cp_async16(&s_setup[b][j][8], row + 8);
      if constexpr (!DEPTH_ONLY) {
        if (masked) {
          const float* a = attr + (size_t)t * ATTR_ROWS;
#pragma unroll
          for (int r = 0; r < 9; ++r) cp_async4(&s_uv[b][j][r], a + r);
          cp_async4(&s_uv[b][j][9], a + 28);
        }
      }
    }
  };

  // the current item and its tile's pixel centres and z limits, loaded
  // before the item's rows are waited for
  Item it;
  int tx = 0, ty = 0;
  float colf = 0.0f, rowf[K1_PPL], zl[K1_PPL];
  bool live_local = false;
  float zl_max = 0.0f;
  auto load_tile = [&](const Item& next) {
    it = next;
    ty = it.tile / tiles_x;
    tx = it.tile - ty * tiles_x;
    colf = (float)(tx * tile_w + lc) + 0.5f;
    live_local = false;
    zl_max = 0.0f;
#pragma unroll
    for (int k = 0; k < K1_PPL; ++k) {
      const int gy = ty * tile_h + lr0 + k;
      const int gx = tx * tile_w + lc;
      const bool in_tile = warp_in && lc < tile_w && lr0 + k < tile_h;
      rowf[k] = (float)gy + 0.5f;
      // pixels beyond the frame read a z limit of 0 (the TPU wrapper pads
      // z_limit with zeros), so they take no fragment
      zl[k] = zlim == nullptr ? 2.0f
              : (in_tile && gx < width && gy < height)
                  ? zlim[gy * width + gx] : 0.0f;
      if (!in_tile) zl[k] = 0.0f;
      live_local |= zl[k] > 0.0f;
      zl_max = fmaxf(zl_max, zl[k]);
    }
  };

  // Each item is preceded by a take of the item after it (tid 0), whose
  // number is read after the tests. Every block's last take lies past the
  // tiles' first items, so every block needs the extra items' count (and,
  // where there are any, their layout); a block whose first item is a
  // tile's first takes and loads the tile's limits before that, any other
  // block after it.
  int g = blockIdx.x;
  int b = 0;
  int taken = 0;
  const bool first_of_tile = g < num_tiles;
  if (first_of_tile) {
    if (tid == 0) taken = atomicAdd(counter, 1);
    load_tile(item_of(g, s_base, num_tiles, starts, counts, bigcnt));
  }
  // the layout is needed only where a tile has more than one item
  bool long_local = false;
  for (int t = tid; t < num_tiles; t += K1_THREADS)
    long_local |= counts[t] + bigcnt > K1_ITEM;
  const int n_items =
      num_tiles + (__syncthreads_or(long_local)
                       ? plan_extra_items(counts, bigcnt, num_tiles, s_base)
                       : 0);
  if (!first_of_tile && g < n_items) {
    if (tid == 0) taken = atomicAdd(counter, 1);
    load_tile(item_of(g, s_base, num_tiles, starts, counts, bigcnt));
  }
  // the first item's rows; none for a tile whose z limits are all 0
  if (g < n_items && (zlim == nullptr || __syncthreads_or(live_local) != 0))
    stage(it, 0);
  cp_async_commit();

  while (g < n_items) {
    cp_async_wait_all();
    // a tile whose limits are all 0 takes nothing (the depth-peel early
    // exit); without z_limit every pixel of the tile is live
    bool tile_live = true;
    if (zlim == nullptr) __syncthreads();
    else tile_live = __syncthreads_or(live_local) != 0;
    unsigned long long best[K1_PPL];
#pragma unroll
    for (int k = 0; k < K1_PPL; ++k) best[k] = 0ull;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      zl_max = fmaxf(zl_max, __shfl_xor_sync(FULL_MASK, zl_max, o));

    if (zl_max > 0.0f) {
      const float x0 = (float)(tx * tile_w + sx * K1_SUB_W) + 0.5f;
      const float y0 = (float)(ty * tile_h + sy * K1_SUB_H) + 0.5f;
      const float x1 = x0 + (float)(K1_SUB_W - 1);
      const float y1 = y0 + (float)(K1_SUB_H - 1);
      const float zl_box = zlim == nullptr ? 1.0f : zl_max;
      for (int j0 = 0; j0 < it.nb; j0 += 32) {
        const int j = j0 + lane;
        const bool may = j < it.nb &&
            subtile_may_cover(s_setup[b][j], x0, x1, y0, y1, zl_box);
        unsigned int m = __ballot_sync(FULL_MASK, may);
        while (m) {
          const int jj = j0 + __ffs(m) - 1;
          m &= m - 1u;
          const float* c = s_setup[b][jj];
          const unsigned long long lo =
              (unsigned long long)(s_id[b][jj] + 1);
#pragma unroll
          for (int k = 0; k < K1_PPL; ++k) {
            float e0 = c[0] * colf + c[1] * rowf[k] + c[2];
            float e1 = c[3] * colf + c[4] * rowf[k] + c[5];
            float e2 = c[6] * colf + c[7] * rowf[k] + c[8];
            float z = c[9] * colf + c[10] * rowf[k] + c[11];
            bool cov = e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f &&
                       z <= 1.0f && z >= 0.0f && z < zl[k];
            if constexpr (!DEPTH_ONLY) {
              if (cov && masked)
                cov = !mask_reject(s_uv[b][jj], mask_rows, colf, rowf[k],
                                   mask_table);
            }
            if (cov) {
              unsigned long long key =
                  ((unsigned long long)(__float_as_uint(z) & 0x7fffffffu)
                   << 32) | lo;
              best[k] = key > best[k] ? key : best[k];
            }
          }
        }
      }
    }

    // the next item's rows land in buffer b ^ 1 while g's outputs are
    // written. Each block that enters the loop ends on one take past the
    // last item, so the takes are numbered 0 .. n_items - 1 and the last
    // one resets the counter.
    if (tid == 0) {
      s_next = gridDim.x + taken;
      if (taken == n_items - 1) atomicExch(counter, 0);
    }
    __syncthreads();
    const int gn = s_next;
    Item next;
    if (gn < n_items) {
      next = item_of(gn, s_base, num_tiles, starts, counts, bigcnt);
      stage(next, b ^ 1);
    }
    cp_async_commit();

    bool write = true;
    if (it.n_items > 1) {
      // several items race this tile: publish the keys, and the item that
      // arrives last reduces them
      // the wrapper sized the slots from shapes (raster.py k1_max_items)
      if (g >= max_items) __trap();
      if (tile_live) {
        unsigned long long* slot = partial + (size_t)g * K1_TILE_PX;
#pragma unroll
        for (int k = 0; k < K1_PPL; ++k) slot[k * K1_THREADS + tid] = best[k];
      }
      __threadfence();
      __syncthreads();
      if (tid == 0) {
        s_last = atomicAdd(&arrive[it.tile], 1) == it.n_items - 1;
        if (s_last) atomicExch(&arrive[it.tile], 0);
      }
      __syncthreads();
      write = s_last != 0;
      if (write && tile_live) {
        __threadfence();
        for (int i = 0; i < it.n_items; ++i) {
          // the tile's items: itself, then its extra items from nt on
          const int gi = i == 0 ? it.tile : num_tiles + s_base[it.tile] + i - 1;
          const unsigned long long* slot = partial + (size_t)gi * K1_TILE_PX;
#pragma unroll
          for (int k = 0; k < K1_PPL; ++k) {
            unsigned long long v = __ldcg(slot + k * K1_THREADS + tid);
            best[k] = v > best[k] ? v : best[k];
          }
        }
      }
    }

    if (write) {
#pragma unroll
      for (int k = 0; k < K1_PPL; ++k) {
        const int gx = tx * tile_w + lc;
        const int gy = ty * tile_h + lr0 + k;
        if (!warp_in || lc >= tile_w || lr0 + k >= tile_h || gx >= width ||
            gy >= height)
          continue;
        const size_t o = (size_t)gy * width + gx;
        const bool has = best[k] != 0ull;
        const int id = has ? (int)((best[k] & 0xffffffffull) - 1ull) : -1;
        tri_out[o] = id;
        depth_out[o] =
            has ? __uint_as_float((unsigned int)(best[k] >> 32)) : 0.0f;
        if constexpr (!DEPTH_ONLY) {
          const size_t plane = (size_t)width * height;
          float ch[INTERP_CHANNELS];
#pragma unroll
          for (int q = 0; q < INTERP_CHANNELS; ++q) ch[q] = 0.0f;
          if (has) {
            // pass 2: the winner's attribute planes, as raster.py:963-984
            const float* a = attr + (size_t)id * ATTR_ROWS;
            float cf = colf, rf = rowf[k];
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
    g = gn;
    b ^= 1;
    if (g < n_items) {
      if (tid == 0) taken = atomicAdd(counter, 1);
      load_tile(next);
    }
  }
  cp_async_wait_all();
}

// Shared memory beyond the kernel's static buffers: the item offsets.
static size_t plan_bytes(int num_tiles) {
  return sizeof(int) * (size_t)(num_tiles + 1);
}

// Persistent blocks on the current device: as many as fit on it at once,
// at most one per item. Returns 0 and sets *grid, or a CUDA error.
template <bool DEPTH_ONLY>
static int grid_size(int max_items, size_t smem, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(k1_raster_kernel<DEPTH_ONLY>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, k1_raster_kernel<DEPTH_ONLY>, K1_THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = sms * (per_sm > 0 ? per_sm : 1);
  *grid = max_items < blocks ? max_items : blocks;
  return 0;
}

// The caller's view of the schedule must be this file's: item_pairs and
// tile_px (the key slots' size) are raster.py's K1_ITEM_PAIRS and
// K1_TILE_PX, from which it sized the scratch.
static bool args_fit(int tile_h, int tile_w, int item_pairs, int tile_px,
                     int max_items) {
  return tile_h > 0 && tile_w > 0 &&
         ((tile_h + K1_SUB_H - 1) / K1_SUB_H) *
                 ((tile_w + K1_SUB_W - 1) / K1_SUB_W) <= K1_WARPS &&
         item_pairs == K1_ITEM && tile_px == K1_TILE_PX && max_items > 0;
}

// partial: max_items * K1_TILE_PX uint64 per-item keys, which the wrapper
// allocates for each call (max_items bounds the item count from shapes,
// raster.py k1_max_items; an item past it traps). counters: num_tiles + 1
// int32, zero before the call and left zero by it (the wrapper keeps one
// buffer per device and stream).
extern "C" int k1_raster(const int* pair_tri, const int* starts,
                         const int* counts, const int* big_tri,
                         const int* big_count, const float* setup,
                         const float* attr, const float* zlim,
                         const int* mask_table, int mask_rows, int* tri_out,
                         float* depth_out, float* interp_out, int width,
                         int height, int tile_h, int tile_w, int tiles_x,
                         int num_tiles, void* partial, int max_items,
                         int* counters, int item_pairs, int tile_px,
                         void* stream) {
  if (!args_fit(tile_h, tile_w, item_pairs, tile_px, max_items))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = plan_bytes(num_tiles);
  int grid = 0;
  int rc = grid_size<false>(max_items, smem, &grid);
  if (rc) return rc;
  k1_raster_kernel<false><<<grid, K1_THREADS, smem, s>>>(
      pair_tri, starts, counts, big_tri, big_count, setup, attr, zlim,
      mask_table, mask_rows, tri_out, depth_out, interp_out, width, height,
      tile_h, tile_w, tiles_x, num_tiles, (unsigned long long*)partial,
      max_items, counters);
  return (int)cudaGetLastError();
}

// The depth-only role: no attribute rows, no amask table, no interp output.
extern "C" int k1_raster_depth(const int* pair_tri, const int* starts,
                               const int* counts, const int* big_tri,
                               const int* big_count, const float* setup,
                               const float* zlim, int* tri_out,
                               float* depth_out, int width, int height,
                               int tile_h, int tile_w, int tiles_x,
                               int num_tiles, void* partial,
                               int max_items, int* counters, int item_pairs,
                               int tile_px, void* stream) {
  if (!args_fit(tile_h, tile_w, item_pairs, tile_px, max_items))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = plan_bytes(num_tiles);
  int grid = 0;
  int rc = grid_size<true>(max_items, smem, &grid);
  if (rc) return rc;
  k1_raster_kernel<true><<<grid, K1_THREADS, smem, s>>>(
      pair_tri, starts, counts, big_tri, big_count, setup, nullptr, zlim,
      nullptr, 0, tri_out, depth_out, nullptr, width, height, tile_h, tile_w,
      tiles_x, num_tiles, (unsigned long long*)partial, max_items, counters);
  return (int)cudaGetLastError();
}
