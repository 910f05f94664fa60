// K10: layered binning, the raster's per-tile triangle lists.
//
// It replaces no Pallas kernel: the JAX package writes this pass in jnp
// (incarnation_tpu/kernels/raster.py bin_triangles_layered :384-640), one
// XLA sort of every candidate (bucket, triangle) key. Its torch twin
// (kernels/raster.py bin_triangles_layered_plain) gathers the candidates
// by boolean masks and sorts them, and so makes the host wait for the card
// several times a call, twice a frame (the camera pass and the sun's
// depth-only pass). K10 is a stable counting sort with no global sort and
// no host synchronisation: every output's shape comes from the params.
//
// The contract (JAX's): a valid triangle whose tile bbox spans
// span <= bin_max_span tiles is small; one with span in (bin_max_span,
// bin_mid_span] is a mid, and the first mid_tri_capacity mids in triangle
// order fit; the rest, and every larger one, are big. Buckets 0..L-1 are
// each layer's big list, bucket L + l*NT + tile layer l's tile. A small or
// fitted mid triangle has a pair in every tile of its bbox, a big one a
// single pair in its layer's big bucket. The pairs are ordered by
// (bucket, triangle) and cut at pair_capacity: pair_tri holds the kept
// pairs, then zeros, pair_capacity + 1 slots; a tile's starts and counts
// are its bucket's slice of the cut stream, big_tri[l] the first
// big_tri_capacity entries of bucket l, then zeros.
//
// The steps, each its own C entry (kernels/raster.py K10's variants):
// 1. k10_mids (only with the mid tier): each block of K10_TRIS triangles
//    counts its mids.
// 2. k10_hist: each block classifies its triangles (a block-wide scan of
//    the mids over the blocks before it decides which fit) and counts its
//    pairs per bucket in shared memory: one row of a (block, bucket) table.
// 3. k10_scan: a thread per bucket scans its column over the blocks: each
//    block's first slot within the bucket, and the bucket's total.
// 4. k10_finalize: one block scans the bucket totals: each bucket's first
//    slot, the tiles' starts and counts, the big counts, `overflow` and the
//    number of kept pairs.
// 5. k10_scatter: each block classifies its triangles again, counts each
//    walking warp's pairs per bucket, turns the counts into first slots
//    (the bucket's, the block's within it, the warps' before it), and each
//    walking warp walks its triangles in order, 32 at a time: their pairs
//    flattened in (triangle, k) order, 32 pairs a step, a lane each, the
//    lanes that share a bucket ranked by lane (__match_any_sync), which is
//    triangle order since a triangle's pairs lie in distinct buckets. A
//    slot at or past pair_capacity is dropped; the tail and the big lists'
//    unused entries are zero-filled.
// The order within a bucket is thus the triangle order across blocks
// (the table's scan), across the walking warps of a block (their counts'
// scan) and within a warp (the walk), the same on every run.
//
// What bounds it: bytes. A triangle's bbox (16 B), valid flag (1 B) and
// layer (4 B) are read once, pair_tri, the tile lists and the big lists
// written once: about 0.002 ms for each of the atrium's two passes at
// 3.35 TB/s (chip_smoke.py counts them); its integer operations, a few a
// pair, take less. It runs far above that (PERF.md): five launches, a
// single-block bucket scan, the (blocks x buckets) table written, scanned
// and read, and each block's serial walk; the atrium's camera pass crowds
// its mids into a few blocks (119 of its 244 in one), whose walk and
// counting take longest. Measured on the card and dropped (PERF.md): a walk
// of one triangle a step with a lane per pair (2.2-2.5x slower); a warp
// per bucket in the table's scan (1.2-2.6x slower than a thread per bucket
// with 16 loads in flight); walks cut by pairs instead of by triangles, the
// first slots prefetched, 16-bit run slots for 8 walking warps (the
// scatter 1.1x slower on the camera pass, 1.3x on the sun's).

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#define K10_THREADS 256
#define K10_ITEMS 8                             // triangles a thread
#define K10_TRIS (K10_THREADS * K10_ITEMS)      // triangles a block
#define K10_WARPS (K10_THREADS / 32)
#define K10_FINAL_THREADS 1024
#define K10_SCAN_THREADS 128
#define K10_SCAN_BATCH 16
// the scatter's shared memory: a pair descriptor per triangle, then a
// first-slot row of every bucket per walking warp; walking warps are cut
// (8, 4, 2, 1) until it fits K10_SMEM_TARGET (two blocks an SM), else one
#define K10_DESC_BYTES (K10_TRIS * 8)
#define K10_SMEM_TARGET (100 * 1024)
// a block's shared memory on an H100, less 2 KB for the kernels' static
// arrays (kernels/raster.py K10_MAX_BUCKETS)
#define K10_SMEM_MAX (232448 - 2048)
#define K10_NPARAMS 15

struct BinParams {   // kernels/raster.py _k10_params, after the count
  int t;         // triangles
  int nl;        // layers
  int nt;        // tiles a layer
  int tiles_x, tiles_y, tile_w, tile_h;
  int span_cap;  // bin_max_span
  int mid_span;  // bin_mid_span, 0 with the mid tier off
  int mid_cap;   // mid_tri_capacity
  int cap;       // pair_capacity
  int big_cap;   // big_tri_capacity
  int nb;        // buckets, nl + nl * nt
  int nblocks;   // blocks of K10_TRIS triangles
};

// torch's // on int32
__device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b;
  return (q * b != a && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// A triangle's pairs: n of them, pair k in bucket
// base + (k / sw) * tiles_x + k % sw (a big triangle: base = its layer,
// n = sw = 1).
struct Pairs {
  int base, n, sw, layer;
};

enum { NONE = 0, SMALL = 1, MID = 2, BIG = 3 };

// Triangle i's tier and pairs (a mid as if it fits). A valid triangle's
// bbox is K9's, inclusive and inside the frame; one that is not, or whose
// layer is out of range, emits nothing.
__device__ __forceinline__ int classify(const BinParams& p,
                                        const int4* __restrict__ bbox,
                                        const bool* __restrict__ valid,
                                        const int* __restrict__ layer, int i,
                                        Pairs& out) {
  out.base = 0;
  out.n = 0;
  out.sw = 1;
  out.layer = 0;
  if (i >= p.t || !valid[i]) return NONE;
  const int4 b = bbox[i];
  const int l = layer ? layer[i] : 0;
  const int tx0 = floordiv(b.x, p.tile_w), ty0 = floordiv(b.y, p.tile_h);
  const int tx1 = floordiv(b.z, p.tile_w), ty1 = floordiv(b.w, p.tile_h);
  if (l < 0 || l >= p.nl || tx0 < 0 || ty0 < 0 || tx1 < tx0 || ty1 < ty0 ||
      tx1 >= p.tiles_x || ty1 >= p.tiles_y)
    return NONE;
  const int sw = tx1 - tx0 + 1;
  const int span = sw * (ty1 - ty0 + 1);
  out.layer = l;
  if (span <= p.span_cap || span <= p.mid_span) {
    out.base = p.nl + l * p.nt + ty0 * p.tiles_x + tx0;
    out.n = span;
    out.sw = sw;
    return span <= p.span_cap ? SMALL : MID;
  }
  out.base = l;
  out.n = 1;
  return BIG;
}

__device__ __forceinline__ int pair_bucket(const BinParams& p, int base,
                                           int sw, int k) {
  const int dy = k / sw;
  return base + dy * p.tiles_x + (k - dy * sw);
}

// counts[bucket] += 1 for each of the triangle's pairs, in k order without
// a division (a mid's up to bin_mid_span pairs are one thread's serial work)
__device__ __forceinline__ void count_pairs(const BinParams& p,
                                            const Pairs& pr, int* counts) {
  int row = pr.base, dx = 0;
  for (int k = 0; k < pr.n; ++k) {
    atomicAdd(&counts[row + dx], 1);
    if (++dx == pr.sw) {
      dx = 0;
      row += p.tiles_x;
    }
  }
}

#define FULL 0xffffffffu

// inclusive prefix of v over the warp's lanes
__device__ __forceinline__ int warp_scan(int v) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int x = __shfl_up_sync(FULL, v, off);
    if (lane >= off) v += x;
  }
  return v;
}

// Exclusive prefix of v over the block's threads (in threadIdx order),
// and the block's sum in *total; every thread of the block calls it
// (blockDim.x a multiple of 32). tmp: 32 ints of shared memory.
__device__ int block_scan(int v, int* tmp, int* total) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nwarps = blockDim.x / 32;
  const int incl = warp_scan(v);
  if (lane == 31) tmp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int x = warp_scan(lane < nwarps ? tmp[lane] : 0);
    if (lane < nwarps) tmp[lane] = x;
  }
  __syncthreads();
  const int before = warp ? tmp[warp - 1] : 0;
  *total = tmp[nwarps - 1];
  __syncthreads();
  return before + incl - v;
}

// The pairs of this thread's K10_ITEMS consecutive triangles of the block,
// with each mid's fit decided: the mids before it are the blocks' before
// (mid_count) and this block's threads' before (a block scan), in
// triangle order, as JAX's cumsum over all triangles.
__device__ void block_pairs(const BinParams& p, const int4* __restrict__ bbox,
                            const bool* __restrict__ valid,
                            const int* __restrict__ layer,
                            const int* __restrict__ mid_count, int* tmp,
                            Pairs pr[K10_ITEMS]) {
  const int i0 = blockIdx.x * K10_TRIS + threadIdx.x * K10_ITEMS;
  int tier[K10_ITEMS];
  int mids = 0;
#pragma unroll
  for (int q = 0; q < K10_ITEMS; ++q) {
    tier[q] = classify(p, bbox, valid, layer, i0 + q, pr[q]);
    mids += tier[q] == MID;
  }
  if (p.mid_span == 0) return;
  int before = 0, total;
  for (int b = threadIdx.x; b < (int)blockIdx.x; b += blockDim.x)
    before += mid_count[b];
  block_scan(before, tmp, &total);
  int pos = total + block_scan(mids, tmp, &before);
#pragma unroll
  for (int q = 0; q < K10_ITEMS; ++q) {
    if (tier[q] != MID) continue;
    if (pos >= p.mid_cap) {  // beyond the mid capacity: a big triangle
      pr[q].base = pr[q].layer;
      pr[q].n = 1;
      pr[q].sw = 1;
    }
    ++pos;
  }
}

extern __shared__ __align__(16) unsigned char k10_smem[];

__global__ void __launch_bounds__(K10_THREADS)
    k10_mids_kernel(BinParams p, const int4* __restrict__ bbox,
                    const bool* __restrict__ valid,
                    const int* __restrict__ layer, int* __restrict__ mid_count) {
  __shared__ int tmp[32];
  const int i0 = blockIdx.x * K10_TRIS + threadIdx.x * K10_ITEMS;
  int mids = 0;
  for (int q = 0; q < K10_ITEMS; ++q) {
    Pairs pr;
    mids += classify(p, bbox, valid, layer, i0 + q, pr) == MID;
  }
  int total;
  block_scan(mids, tmp, &total);
  if (threadIdx.x == 0) mid_count[blockIdx.x] = total;
}

__global__ void __launch_bounds__(K10_THREADS)
    k10_hist_kernel(BinParams p, const int4* __restrict__ bbox,
                    const bool* __restrict__ valid,
                    const int* __restrict__ layer,
                    const int* __restrict__ mid_count,
                    int* __restrict__ table) {
  __shared__ int tmp[32];
  int* hist = (int*)k10_smem;  // nb
  for (int b = threadIdx.x; b < p.nb; b += blockDim.x) hist[b] = 0;
  __syncthreads();
  Pairs pr[K10_ITEMS];
  block_pairs(p, bbox, valid, layer, mid_count, tmp, pr);
#pragma unroll
  for (int q = 0; q < K10_ITEMS; ++q) count_pairs(p, pr[q], hist);
  __syncthreads();
  int* row = table + (size_t)blockIdx.x * p.nb;
  for (int b = threadIdx.x; b < p.nb; b += blockDim.x) row[b] = hist[b];
}

// a thread per bucket: its column of the table, in block order, becomes
// each block's first slot within the bucket
__global__ void __launch_bounds__(K10_SCAN_THREADS)
    k10_scan_kernel(BinParams p, int* __restrict__ table,
                    int* __restrict__ total) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= p.nb) return;
  int run = 0;
  int* col = table + b;
  // K10_SCAN_BATCH loads in flight before their stores
  for (int blk0 = 0; blk0 < p.nblocks; blk0 += K10_SCAN_BATCH) {
    int v[K10_SCAN_BATCH];
#pragma unroll
    for (int q = 0; q < K10_SCAN_BATCH; ++q)
      v[q] = blk0 + q < p.nblocks ? col[(size_t)(blk0 + q) * p.nb] : 0;
#pragma unroll
    for (int q = 0; q < K10_SCAN_BATCH; ++q) {
      if (blk0 + q < p.nblocks) col[(size_t)(blk0 + q) * p.nb] = run;
      run += v[q];
    }
  }
  total[b] = run;
}

// one block: each bucket's first slot s and end e over all pairs, then
// the cut: a tile's start min(s, cap) and count min(e, cap) - min(s, cap),
// a layer's big count min(that, big_cap) and big overflow the rest; the
// kept pairs min(all, cap) and overflow max(all - cap, 0)
__global__ void __launch_bounds__(K10_FINAL_THREADS)
    k10_finalize_kernel(BinParams p, const int* __restrict__ total,
                        int* __restrict__ bstart, int* __restrict__ starts,
                        int* __restrict__ counts, int* __restrict__ big_count,
                        int* __restrict__ big_over, int* __restrict__ overflow,
                        int* __restrict__ kept) {
  __shared__ int tmp[32];
  int carry = 0;
  for (int c0 = 0; c0 < p.nb; c0 += blockDim.x) {
    const int b = c0 + threadIdx.x;
    const int v = b < p.nb ? total[b] : 0;
    int sum;
    const int s = carry + block_scan(v, tmp, &sum);
    if (b < p.nb) {
      const int e = s + v;
      const int sc = min(s, p.cap), n = min(e, p.cap) - sc;
      bstart[b] = s;
      if (b < p.nl) {
        const int bc = min(n, p.big_cap);
        big_count[b] = bc;
        big_over[b] = n - bc;
      } else {
        starts[b - p.nl] = sc;
        counts[b - p.nl] = n;
      }
    }
    carry += sum;
  }
  if (threadIdx.x == 0) {
    overflow[0] = max(carry - p.cap, 0);
    kept[0] = min(carry, p.cap);
  }
}

__global__ void __launch_bounds__(K10_THREADS)
    k10_scatter_kernel(BinParams p, int walkers, const int4* __restrict__ bbox,
                       const bool* __restrict__ valid,
                       const int* __restrict__ layer,
                       const int* __restrict__ mid_count,
                       const int* __restrict__ table,
                       const int* __restrict__ bstart,
                       const int* __restrict__ big_count,
                       const int* __restrict__ kept, int* __restrict__ pair_tri,
                       int* __restrict__ big_tri) {
  __shared__ int tmp[32];
  __shared__ int ends[K10_WARPS * 32];
  int2* desc = (int2*)k10_smem;                     // K10_TRIS: base, n | sw
  int* slot = (int*)(k10_smem + K10_DESC_BYTES);    // walkers x nb
  const int nb = p.nb, per = K10_TRIS / walkers;
  for (int x = threadIdx.x; x < walkers * nb; x += blockDim.x) slot[x] = 0;
  __syncthreads();
  Pairs pr[K10_ITEMS];
  block_pairs(p, bbox, valid, layer, mid_count, tmp, pr);
  // each walking warp's pairs per bucket (a thread's triangles all lie in
  // one warp's range: per is a multiple of K10_ITEMS)
  const int local0 = threadIdx.x * K10_ITEMS;
  int* mine = slot + (local0 / per) * nb;
#pragma unroll
  for (int q = 0; q < K10_ITEMS; ++q) {
    desc[local0 + q] = make_int2(pr[q].base, pr[q].n | (pr[q].sw << 16));
    count_pairs(p, pr[q], mine);
  }
  __syncthreads();
  // counts -> first slots: the bucket's, this block's within it, then the
  // walking warps' in order
  const int* row = table + (size_t)blockIdx.x * nb;
  for (int b = threadIdx.x; b < nb; b += blockDim.x) {
    int run = bstart[b] + row[b];
    for (int w = 0; w < walkers; ++w) {
      const int c = slot[w * nb + b];
      slot[w * nb + b] = run;
      run += c;
    }
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp < walkers) {
    // The walk: 32 triangles at a time, their pairs flattened in (triangle,
    // k) order and taken 32 at a time, a lane each. Lanes whose pairs share
    // a bucket are ranked by lane (__match_any_sync), which is triangle
    // order, since a triangle's pairs lie in distinct buckets.
    int* next = slot + warp * nb;
    int* incl_of = ends + warp * 32;  // the 32 triangles' running pair ends
    const int tri0 = blockIdx.x * K10_TRIS;
    for (int j0 = warp * per; j0 < (warp + 1) * per; j0 += 32) {
      const int incl = warp_scan(desc[j0 + lane].y & 0xffff);
      const int total = __shfl_sync(FULL, incl, 31);
      if (total == 0) continue;
      incl_of[lane] = incl;
      __syncwarp();
      for (int p0 = 0; p0 < total; p0 += 32) {
        const int q = p0 + lane;
        int b = -1, tri = 0;
        if (q < total) {
          int s = 0;  // the first of the 32 whose pairs end past q
#pragma unroll
          for (int step = 16; step; step >>= 1)
            if (incl_of[s + step - 1] <= q) s += step;
          const int2 d = desc[j0 + s];
          b = pair_bucket(p, d.x, (unsigned)d.y >> 16,
                          q - incl_of[s] + (d.y & 0xffff));
          tri = tri0 + j0 + s;
        }
        const unsigned peers = __match_any_sync(FULL, b);
        const int at = b >= 0 ? next[b] : 0;
        __syncwarp();
        if (b >= 0) {
          const int rank = __popc(peers & ((1u << lane) - 1));
          if (rank == __popc(peers) - 1) next[b] = at + rank + 1;
          const int pos = at + rank;
          if (pos < p.cap) {
            pair_tri[pos] = tri;
            if (b < p.nl && pos - bstart[b] < big_count[b])
              big_tri[b * p.big_cap + pos - bstart[b]] = tri;
          }
        }
        __syncwarp();
      }
    }
  }
  // zeros: pair_tri past the kept pairs (its trailing slot included) and
  // the big lists past their counts
  const int stride = gridDim.x * blockDim.x;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  for (int i = kept[0] + g; i <= p.cap; i += stride) pair_tri[i] = 0;
  for (int x = g; x < p.nl * p.big_cap; x += stride)
    if (x % p.big_cap >= big_count[x / p.big_cap]) big_tri[x] = 0;
}

static int params_of(const int* prm, BinParams* p) {
  if (prm[0] != K10_NPARAMS) return (int)cudaErrorInvalidValue;
  memcpy(p, prm + 1, sizeof(BinParams));
  return 0;
}

static int grid_of(const BinParams& p) { return p.nblocks; }

extern "C" int k10_mids(const int* prm, const int4* bbox, const bool* valid,
                        const int* layer, int* mid_count, cudaStream_t s) {
  BinParams p;
  if (params_of(prm, &p)) return (int)cudaErrorInvalidValue;
  k10_mids_kernel<<<grid_of(p), K10_THREADS, 0, s>>>(p, bbox, valid, layer,
                                                     mid_count);
  return (int)cudaGetLastError();
}

extern "C" int k10_hist(const int* prm, const int4* bbox, const bool* valid,
                        const int* layer, const int* mid_count, int* table,
                        cudaStream_t s) {
  BinParams p;
  if (params_of(prm, &p)) return (int)cudaErrorInvalidValue;
  const int bytes = p.nb * 4;
  if (bytes > K10_SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      k10_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  k10_hist_kernel<<<grid_of(p), K10_THREADS, bytes, s>>>(
      p, bbox, valid, layer, mid_count, table);
  return (int)cudaGetLastError();
}

extern "C" int k10_scan(const int* prm, int* table, int* total,
                        cudaStream_t s) {
  BinParams p;
  if (params_of(prm, &p)) return (int)cudaErrorInvalidValue;
  const int grid = (p.nb + K10_SCAN_THREADS - 1) / K10_SCAN_THREADS;
  k10_scan_kernel<<<grid, K10_SCAN_THREADS, 0, s>>>(p, table, total);
  return (int)cudaGetLastError();
}

extern "C" int k10_finalize(const int* prm, const int* total, int* bstart,
                            int* starts, int* counts, int* big_count,
                            int* big_over, int* overflow, int* kept,
                            cudaStream_t s) {
  BinParams p;
  if (params_of(prm, &p)) return (int)cudaErrorInvalidValue;
  k10_finalize_kernel<<<1, K10_FINAL_THREADS, 0, s>>>(
      p, total, bstart, starts, counts, big_count, big_over, overflow, kept);
  return (int)cudaGetLastError();
}

extern "C" int k10_scatter(const int* prm, const int4* bbox, const bool* valid,
                           const int* layer, const int* mid_count,
                           const int* table, const int* bstart,
                           const int* big_count, const int* kept,
                           int* pair_tri, int* big_tri, cudaStream_t s) {
  BinParams p;
  if (params_of(prm, &p)) return (int)cudaErrorInvalidValue;
  int walkers = K10_WARPS;
  while (walkers > 1 && K10_DESC_BYTES + walkers * p.nb * 4 > K10_SMEM_TARGET)
    walkers /= 2;
  const int bytes = K10_DESC_BYTES + walkers * p.nb * 4;
  if (bytes > K10_SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      k10_scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  k10_scatter_kernel<<<grid_of(p), K10_THREADS, bytes, s>>>(
      p, walkers, bbox, valid, layer, mid_count, table, bstart, big_count,
      kept, pair_tri, big_tri);
  return (int)cudaGetLastError();
}
