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
// Three launches a binning, each a C entry (kernels/raster.py K10's
// variants); a row is K10_TRIS consecutive triangles, a group 32 of them,
// and a row's pair stream is cut into ranges, one for each of its walkers
// (up to 16 warps, as many as the scatter's rows of 16-bit offsets fit in
// K10_SMEM_TARGET, two blocks an SM; walkers_of):
// 1. k10_count: a block takes a row by an atomic ticket, classifies its
//    triangles once, decides which mids fit by a single-pass chained scan
//    of the rows' mid counts (a decoupled look-back: each row publishes
//    its count, then its inclusive prefix, in one 64-bit word; a lane
//    reads K10_LOOKBACK_SPAN rows a round), writes each triangle's pair
//    descriptor (first bucket, pairs, tile span), and has each walker
//    count its range's pairs per bucket, 32 pairs a step, a lane a pair.
//    The walkers' counts become each walker's offset within the row's run
//    of a bucket (the walkers' before it), kept for the scatter, and the
//    row's count, a row of a (row, bucket) table.
// 2. k10_scan: a block per 32 buckets scans their columns over the rows,
//    each warp holding K10_SCAN_ROWS rows at once (each row's first slot
//    within the bucket, and the bucket's total); the last block to finish
//    (a __threadfence() and an atomic count) scans the bucket totals: each
//    bucket's first slot, the tiles' starts and counts, the big counts,
//    `overflow` and the kept pairs.
// 3. k10_scatter: a block a row, its descriptors and the walkers' offsets
//    staged in shared memory, each bucket's first slot for the row (the
//    bucket's, then the row's within it) beside them. Each walker walks its
//    range again; lanes that share a bucket are ranked by lane
//    (__match_any_sync), which is triangle order since a triangle's pairs
//    lie in distinct buckets. A slot at or past pair_capacity is dropped;
//    the tail and the big lists' unused entries are zero-filled.
// The order within a bucket is thus the triangle order across rows (the
// table's scan), across walkers (contiguous ranges of the row's stream)
// and within a walker (its steps, then lanes), the same on every run.
//
// A walk (warp_pairs) gathers a group's triangles with pairs to the low
// lanes; a step's pair then belongs to the triangle at the step's start
// plus those that start before it in the step (a ballot, an OR across
// the warp and a popc), and its bucket is base + k + (k / sw) *
// (tiles_x - sw), the quotient a multiply-high by the triangle's
// reciprocal. The ranges are cut by cost (warp_range: a group costs as
// much as a step of 32 pairs), so that a walker that crosses many groups
// with few pairs ends with one whose range lies in a crowded group.
//
// The look-back spins, so a block waits only on rows whose tickets came
// before its own, taken by blocks already running: the ticket, not
// blockIdx, orders the rows, and holds however few blocks are resident.
// The look-back words and both counters live at the front of the
// wrapper's scratch, per (device, stream); each binning leaves them zero
// (the last ticket resets the ticket count, k10_scan the look-back words,
// its last block its own count), so the next binning starts from zero
// with no memset and no host synchronisation.
//
// What bounds it: bytes. A triangle's bbox (16 B), valid flag (1 B) and
// layer (4 B) are read once, pair_tri, the tile lists and the big lists
// written once: about 0.002 ms for each of the atrium's two passes at
// 3.35 TB/s (chip_smoke.py counts them); its integer operations, a few a
// pair, take less. It runs far above that (PERF.md): three launches'
// fixed costs (about 0.0057 ms back to back), the walks (each step and
// group a chain of shuffles, ballots and shared-memory atomics of about
// 550-700 cycles, tools/torch_kernel_ab.py --timeline; a row is walked
// twice), and the walkers' offsets, written and read once a row (80 KB a
// row on the camera pass). Measured on the card and dropped (PERF.md):
// two steps' buckets found at once (1.04x slower on the camera pass),
// 1024-thread blocks a row (the sun pass 1.09-1.14x slower: 142 rows on
// 132 SMs take a second wave), the offsets counted in the scatter (the
// camera 1.04x, the sun 1.13x slower).

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#define K10_TRIS 2048                                   // triangles a row
#define K10_COUNT_THREADS 512
#define K10_ITEMS (K10_TRIS / K10_COUNT_THREADS)        // triangles a thread
#define K10_COUNT_WARPS (K10_COUNT_THREADS / 32)
#define K10_SCATTER_THREADS 512
#define K10_WALKERS (K10_SCATTER_THREADS / 32)          // at most
#define K10_GROUPS (K10_TRIS / 32)                      // 32 triangles each
#define K10_PREFETCH 8                          // buckets a thread at once
#define K10_LOOKBACK_SPAN 4                     // rows a lane, a round
#define K10_GROUP_COST 32                       // a group's walk, in pairs
#define K10_SCAN_WARPS 8
#define K10_SCAN_THREADS (K10_SCAN_WARPS * 32)
#define K10_SCAN_ROWS 24                        // rows a warp holds at once
// the scatter's dynamic shared memory (scatter_bytes): walkers are cut
// until it fits K10_SMEM_TARGET (two blocks an SM), to one, which fits
// K10_SMEM_MAX; k10_count holds the row's descriptors and the walkers'
// counts
#define K10_SMEM_TARGET (110 * 1024)
// a block's shared memory on an H100, less 2 KB for the static arrays
// (kernels/raster.py K10_MAX_BUCKETS)
#define K10_SMEM_MAX (232448 - 2048)
#define K10_NPARAMS 15
// the state words at the front of the scratch: the ticket count, the
// count of finished k10_scan blocks, then a look-back word a row
#define K10_TICKET 0
#define K10_DONE 1
#define K10_LOOKBACK 2
// a look-back word: its flag in the high half, a count in the low
#define K10_AGGREGATE 1ull
#define K10_PREFIX 2ull

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
  int nblocks;   // rows of K10_TRIS triangles
};

// A tool-only build (tools/torch_kernel_ab.py --timeline passes
// -DK10_TIMELINE; the main path's build never does): each block of the
// counting, scatter and scan steps writes %globaltimer at its start and
// end and clock64() at block-wide marks between, and k10_timeline copies
// them out. In the main path's build the marks are empty.
#ifdef K10_TIMELINE
#define K10_TL_BLOCKS 4096
#define K10_TL_SLOTS 8  // globaltimer start, end, SM id, then 5 clock64 marks
__device__ unsigned long long k10_tl[3][K10_TL_BLOCKS][K10_TL_SLOTS];
__device__ __forceinline__ unsigned long long tl_clock() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
// mark 0 is the block's start, K10_TL_END its end; every thread calls it
#define K10_TL_END 99
__device__ __forceinline__ void tl_mark(int step, int mark) {
  __syncthreads();
  if (threadIdx.x || blockIdx.x >= K10_TL_BLOCKS) return;
  unsigned long long* row = k10_tl[step][blockIdx.x];
  if (mark == 0) {
    unsigned smid;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
    row[0] = tl_clock();
    row[2] = smid;
  }
  if (mark == K10_TL_END) {
    row[1] = tl_clock();
    mark = 4;
  }
  row[3 + mark] = clock64();
}
// and per block and warp, each warp's groups, steps and cycles in each
// of its walks: the counting step's and the scatter's
#define K10_TL_WARPS 16
__device__ unsigned long long k10_tlw[K10_TL_BLOCKS][K10_TL_WARPS][2][3];
__device__ __forceinline__ void tl_warp(int phase, int2 gs, long long t0) {
  const long long t = clock64();
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 || blockIdx.x >= K10_TL_BLOCKS || warp >= K10_TL_WARPS)
    return;
  unsigned long long* w = k10_tlw[blockIdx.x][warp][phase];
  w[0] = gs.x;
  w[1] = gs.y;
  w[2] = t - t0;
}
#define TLW_START const long long tlw_t0 = clock64()
#define TLW_STOP(phase, gs) tl_warp(phase, gs, tlw_t0)
static cudaError_t copy_and_zero(void* out, const void* symbol, size_t n) {
  cudaError_t e = cudaMemcpyFromSymbol(out, symbol, n);
  void* at;
  if (e == cudaSuccess) e = cudaGetSymbolAddress(&at, symbol);
  if (e == cudaSuccess) e = cudaMemset(at, 0, n);
  return e;
}
// copies every row of the steps to out (3 x K10_TL_BLOCKS x K10_TL_SLOTS),
// then the warps' (K10_TL_BLOCKS x K10_TL_WARPS x 2 x 3), and zeroes them
extern "C" int k10_timeline(unsigned long long* out) {
  cudaError_t e = copy_and_zero(out, k10_tl, sizeof(k10_tl));
  if (e == cudaSuccess)
    e = copy_and_zero(out + sizeof(k10_tl) / 8, k10_tlw, sizeof(k10_tlw));
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  return (int)e;
}
#else
#define tl_mark(step, mark)
#define TLW_START
#define TLW_STOP(phase, gs) (void)(gs)
#endif

// torch's // on int32
__device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b;
  return (q * b != a && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// a // size, by an arithmetic shift where size is 2^shift (shift >= 0)
__device__ __forceinline__ int tile_of(int a, int size, int shift) {
  return shift >= 0 ? a >> shift : floordiv(a, size);
}

// log2 of a power of two, else -1
__device__ __forceinline__ int shift_of(int size) {
  return size > 0 && !(size & (size - 1)) ? __ffs(size) - 1 : -1;
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
__device__ __forceinline__ int classify(const BinParams& p, int shift_w,
                                        int shift_h,
                                        const int4* __restrict__ bbox,
                                        const bool* __restrict__ valid,
                                        const int* __restrict__ layer, int i,
                                        Pairs& out) {
  out.base = 0;
  out.n = 0;
  out.sw = 1;
  out.layer = 0;
  if (i >= p.t) return NONE;
  const int4 b = bbox[i];  // loaded beside its flag, not after it
  if (!valid[i]) return NONE;
  const int l = layer ? layer[i] : 0;
  const int tx0 = tile_of(b.x, p.tile_w, shift_w);
  const int ty0 = tile_of(b.y, p.tile_h, shift_h);
  const int tx1 = tile_of(b.z, p.tile_w, shift_w);
  const int ty1 = tile_of(b.w, p.tile_h, shift_h);
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

// The pairs [lo, hi) of a warp's 32 triangles, flattened in (triangle, k)
// order (lane j's triangle: first bucket base, n pairs, tile span sw), 32
// a step, a lane each: fn(bucket, lane of the pair's triangle) on every
// lane, with bucket -1 where a lane has no pair. Every lane calls it with
// the same lo and hi; inv: 32 bytes of the warp's shared memory. The
// triangles with pairs are first gathered to the low lanes, in order, so
// that the triangle of a step's pair is the one at the step's start plus
// the triangles that start in the step before it: one ballot, one OR
// across the warp and a popc, not a search. Returns the steps.
template <class F>
__device__ __forceinline__ int warp_pairs(const BinParams& p, int base,
                                          int n, int sw, int lo, int hi,
                                          unsigned char* inv, F&& fn) {
  const int lane = threadIdx.x % 32;
  const unsigned below = (1u << lane) - 1;
  const unsigned some = __ballot_sync(FULL, n > 0);
  if (n > 0) inv[__popc(some & below)] = (unsigned char)lane;
  __syncwarp();
  const int src = lane < __popc(some) ? inv[lane] : lane;
  __syncwarp();
  const int n_src = __shfl_sync(FULL, n, src);
  const int cn = lane < __popc(some) ? n_src : 0;
  const int cbase = __shfl_sync(FULL, base, src);
  const int csw = __shfl_sync(FULL, sw, src);
  const int incl = warp_scan(cn);
  const int excl = incl - cn;
  // pair k lies in bucket base + k + (k / sw) * (tiles_x - sw), and
  // k / sw = umulhi(k, m) with m = 2^32 / sw rounded up (k itself for
  // sw = 1, m = 0): exact for k and sw below 2^16
  const unsigned m = csw > 1 ? 0xffffffffu / (unsigned)csw + 1u : 0u;
  const int wrap = p.tiles_x - csw;
  for (int p0 = lo; p0 < hi; p0 += 32) {
    const int q = p0 + lane;
    // the triangle at the step's start, and those that start after it
    const int at0 = __popc(__ballot_sync(FULL, incl <= p0));
    const unsigned starts = __reduce_or_sync(
        FULL, cn > 0 && excl > p0 && excl < p0 + 32 ? 1u << (excl - p0) : 0u);
    const int s = (at0 + __popc(starts & ((2u << lane) - 1))) & 31;
    const int sb = __shfl_sync(FULL, cbase, s);
    const unsigned sm = __shfl_sync(FULL, m, s);
    const int swrap = __shfl_sync(FULL, wrap, s);
    const int k = q - __shfl_sync(FULL, excl, s);
    const int slane = __shfl_sync(FULL, src, s);
    int b = -1;
    if (q < hi) {
      const int dy = sm ? (int)__umulhi((unsigned)k, sm) : k;
      b = sb + k + dy * swrap;
    }
    fn(b, slane);
  }
  return hi > lo ? (hi - lo + 31) / 32 : 0;
}

// The length of the run of neighbouring lanes whose bucket equals this
// lane's, at the run's first lane; 0 at the others and where b < 0. A
// step's pairs of small triangles often share a tile: one atomic a run.
__device__ __forceinline__ int run_head(int b) {
  const int lane = threadIdx.x % 32;
  const int prev = __shfl_up_sync(FULL, b, 1);
  const unsigned heads = __ballot_sync(FULL, lane == 0 || prev != b);
  if (b < 0 || !((heads >> lane) & 1)) return 0;
  const unsigned later = heads & ~((2u << lane) - 1);
  return (later ? __ffs(later) - 1 : 32) - lane;
}

// Warp 0 of row r's block: the mids of the rows before it, from the
// look-back words (agg: this row's mids). Publishes the row's count at
// once and its inclusive prefix when known; waits only on rows of earlier
// tickets. Each lane reads K10_LOOKBACK_SPAN rows a round, nearest
// first. A row with no mid needs no prefix and does not wait: the rows
// after it add its count of 0 on their way back (row 0 always publishes
// a prefix).
__device__ int look_back(volatile unsigned long long* words, int r, int agg) {
  const int lane = threadIdx.x % 32;
  if (r == 0) {
    if (lane == 0) words[0] = (K10_PREFIX << 32) | (unsigned)agg;
    return 0;
  }
  if (lane == 0) words[r] = (K10_AGGREGATE << 32) | (unsigned)agg;
  if (agg == 0) return 0;
  int before = 0;
  for (int j = r - 1;;) {
    // lane x reads rows j - SPAN * x - u; rows before 0 read as a prefix
    // of 0
    unsigned long long w[K10_LOOKBACK_SPAN];
    int first = K10_LOOKBACK_SPAN;  // the lane's nearest prefix
#pragma unroll
    for (int u = 0; u < K10_LOOKBACK_SPAN; ++u) {
      const int at = j - K10_LOOKBACK_SPAN * lane - u;
      w[u] = at >= 0 ? words[at] : (K10_PREFIX << 32);
    }
#pragma unroll
    for (int u = K10_LOOKBACK_SPAN - 1; u >= 0; --u)
      if ((w[u] >> 32) == K10_PREFIX) first = u;
    const unsigned prefixes = __ballot_sync(FULL, first < K10_LOOKBACK_SPAN);
    const int stop = prefixes ? __ffs(prefixes) - 1 : 32;
    const int stop_u = __shfl_sync(FULL, first, stop & 31);
    // the rows up to the nearest prefix, or all of this round's
    const int lim = lane < stop ? K10_LOOKBACK_SPAN
                                : lane == stop ? stop_u + 1 : 0;
    int v = 0;
    bool unready = false;
#pragma unroll
    for (int u = 0; u < K10_LOOKBACK_SPAN; ++u)
      if (u < lim) {
        unready |= (w[u] >> 32) == 0;
        v += (int)(unsigned)w[u];
      }
    // a row before has not published: spin
    if (__ballot_sync(FULL, unready)) continue;
    before += __shfl_sync(FULL, warp_scan(v), 31);
    if (prefixes) break;
    j -= K10_LOOKBACK_SPAN * 32;
  }
  if (lane == 0) words[r] = (K10_PREFIX << 32) | (unsigned)(before + agg);
  return before;
}

// lane's triangle of group g of a row of ntris (rdesc: the row's
// descriptors): its descriptor, (0, 0) past the row's end
__device__ __forceinline__ int2 group_desc(const int2* rdesc, int ntris,
                                           int g) {
  const int i = g * 32 + threadIdx.x % 32;
  return i < ntris ? rdesc[i] : make_int2(0, 0);
}

// A warp's range [lo, hi) of a row's pair stream, group by group of 32
// triangles (grp: each group's first pair in the row, then all; rdesc the
// row's ntris descriptors, its first triangle tri0), the next group's
// descriptors loaded while one is walked: fn(bucket, triangle) a pair, as
// warp_pairs (inv: its 32 bytes). Returns (groups, steps).
template <class F>
__device__ __forceinline__ int2 walk(const BinParams& p, const int2* rdesc,
                                     int ntris, const int* grp, int tri0,
                                     int lo, int hi, unsigned char* inv,
                                     F&& fn) {
  const int lane = threadIdx.x % 32;
  // the last group that starts at or before lo
  int g = __popc(__ballot_sync(FULL, grp[lane] <= lo)) +
          __popc(__ballot_sync(FULL, grp[lane + 32] <= lo)) - 1;
  int2 next = group_desc(rdesc, ntris, g);
  int2 done = make_int2(0, 0);
  for (; g < K10_GROUPS && grp[g] < hi; ++g) {
    const int2 d = next;
    if (g + 1 < K10_GROUPS) next = group_desc(rdesc, ntris, g + 1);
    const int g0 = grp[g], t0 = tri0 + g * 32;
    done.x += 1;
    done.y += warp_pairs(p, d.x, d.y & 0xffff, (int)((unsigned)d.y >> 16),
                         max(lo - g0, 0), min(hi, grp[g + 1]) - g0, inv,
                         [&](int b, int s) { fn(b, t0 + s); });
  }
  return done;
}

// The pair at cost c of a row's stream cut by cost: a group of 32
// triangles costs K10_GROUP_COST (its scan and descriptors, about a step
// of 32 pairs) before its pairs, one each; grp: each group's first pair,
// then all. Every lane calls it with the same c.
__device__ __forceinline__ int pair_at_cost(const int* grp, int c) {
  const int lane = threadIdx.x % 32;
  // the last group whose cost starts at or before c
  const int g =
      __popc(__ballot_sync(FULL, lane * K10_GROUP_COST + grp[lane] <= c)) +
      __popc(__ballot_sync(FULL, (lane + 32) * K10_GROUP_COST +
                                     grp[lane + 32] <= c)) - 1;
  const int x = c - g * K10_GROUP_COST - grp[g] - K10_GROUP_COST;
  return grp[g] + min(max(x, 0), grp[g + 1] - grp[g]);
}

// Warp w of n's share of a row's pair stream, [lo, hi): the stream cut
// into n ranges of even cost (pair_at_cost), so that a warp whose range
// crosses many groups with few pairs walks no longer than one whose range
// lies in a group of many
__device__ __forceinline__ int2 warp_range(const int* grp, int w, int n) {
  const long long all = K10_GROUPS * K10_GROUP_COST + grp[K10_GROUPS];
  return make_int2(pair_at_cost(grp, (int)(all * w / n)),
                   pair_at_cost(grp, (int)(all * (w + 1) / n)));
}

// Warp 0: grp's K10_GROUPS pair counts become each group's first pair in
// the row, then the row's pairs in grp[K10_GROUPS]
__device__ __forceinline__ void scan_groups(int* grp) {
  const int lane = threadIdx.x % 32;
  const int a = grp[2 * lane], c = grp[2 * lane + 1];
  const int incl = warp_scan(a + c);
  grp[2 * lane] = incl - a - c;
  grp[2 * lane + 1] = incl - c;
  if (lane == 31) grp[K10_GROUPS] = incl;
}

// n words of shared memory (16-byte aligned) zeroed by the block, 16
// bytes a thread at a time
__device__ __forceinline__ void zero_words(unsigned* at, int n) {
  int4* z = (int4*)at;
  for (int x = threadIdx.x; x < n / 4; x += blockDim.x)
    z[x] = make_int4(0, 0, 0, 0);
  for (int x = n / 4 * 4 + threadIdx.x; x < n; x += blockDim.x) at[x] = 0;
}

extern __shared__ __align__(16) unsigned char k10_smem[];

__global__ void __launch_bounds__(K10_COUNT_THREADS, 2)
    k10_count_kernel(BinParams p, const int4* __restrict__ bbox,
                     const bool* __restrict__ valid,
                     const int* __restrict__ layer,
                     unsigned long long* __restrict__ state,
                     int walkers, int2* __restrict__ desc,
                     int* __restrict__ table, unsigned* __restrict__ woff) {
  __shared__ int row_of, mids_before;
  // each (item, warp)'s mids, then their exclusive prefix in triangle order
  __shared__ int mids[K10_ITEMS * K10_COUNT_WARPS];
  __shared__ int grp[K10_GROUPS + 1];
  __shared__ unsigned char inv[K10_COUNT_WARPS][32];  // warp_pairs'
  int2* stage = (int2*)k10_smem;                   // the row's descriptors
  // each walker's pairs per bucket, 16 bits a bucket, two a word
  const int nbp = p.nb + (p.nb & 1), words = nbp / 2;
  unsigned* cnt = (unsigned*)(k10_smem + K10_TRIS * 8);  // walkers x words
  tl_mark(0, 0);
  if (threadIdx.x == 0) {
    const int r = (int)atomicAdd(&state[K10_TICKET], 1ull);
    // the last ticket: every block has taken its own
    if (r == (int)gridDim.x - 1) atomicExch(&state[K10_TICKET], 0ull);
    row_of = r;
  }
  zero_words(cnt, walkers * words);
  __syncthreads();
  const int r = row_of;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int tri0 = r * K10_TRIS;
  // item q: triangle tri0 + q * threads + threadIdx.x, of group
  // q * warps + warp
  Pairs pr[K10_ITEMS];
  int tier[K10_ITEMS];
  const int shift_w = shift_of(p.tile_w), shift_h = shift_of(p.tile_h);
#pragma unroll
  for (int q = 0; q < K10_ITEMS; ++q)
    tier[q] = classify(p, shift_w, shift_h, bbox, valid, layer,
                       tri0 + q * K10_COUNT_THREADS + threadIdx.x, pr[q]);
  tl_mark(0, 1);
  if (p.mid_span) {
    unsigned is_mid[K10_ITEMS];
#pragma unroll
    for (int q = 0; q < K10_ITEMS; ++q) {
      is_mid[q] = __ballot_sync(FULL, tier[q] == MID);
      if (lane == 0) mids[q * K10_COUNT_WARPS + warp] = __popc(is_mid[q]);
    }
    __syncthreads();
    if (warp == 0) {
      // 64 (item, warp) counts in triangle order, two a lane
      const int a = mids[2 * lane], c = mids[2 * lane + 1];
      const int incl = warp_scan(a + c);
      mids[2 * lane] = incl - a - c;
      mids[2 * lane + 1] = incl - c;
      const int before =
          look_back(state + K10_LOOKBACK, r, __shfl_sync(FULL, incl, 31));
      if (lane == 0) mids_before = before;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < K10_ITEMS; ++q) {
      if (tier[q] != MID) continue;
      const int pos = mids_before + mids[q * K10_COUNT_WARPS + warp] +
                      __popc(is_mid[q] & ((1u << lane) - 1));
      if (pos >= p.mid_cap) {  // beyond the mid capacity: a big triangle
        pr[q].base = pr[q].layer;
        pr[q].n = 1;
        pr[q].sw = 1;
      }
    }
  }
  tl_mark(0, 2);
  // the descriptors, to the scatter and to this block's walks, and each
  // group's pairs
#pragma unroll
  for (int q = 0; q < K10_ITEMS; ++q) {
    const int local = q * K10_COUNT_THREADS + threadIdx.x;
    const int2 d = make_int2(pr[q].base, pr[q].n | (pr[q].sw << 16));
    if (tri0 + local < p.t) desc[tri0 + local] = d;
    stage[local] = d;
    const int tot = __shfl_sync(FULL, warp_scan(pr[q].n), 31);
    if (lane == 0) grp[q * K10_COUNT_WARPS + warp] = tot;
  }
  __syncthreads();
  if (warp == 0) scan_groups(grp);
  __syncthreads();
  // the row's pairs per bucket and walker: its pair stream cut as the
  // scatter cuts it, a range a walker
  if (warp < walkers) {
    const int2 range = warp_range(grp, warp, walkers);
    unsigned* mine = cnt + warp * words;
    TLW_START;
    const int2 gs = walk(p, stage, K10_TRIS, grp, tri0, range.x, range.y,
                         inv[warp], [&](int b, int) {
                           if (const int n = run_head(b))
                             atomicAdd(mine + b / 2,
                                       (unsigned)n << (16 * (b & 1)));
                         });
    TLW_STOP(0, gs);
  }
  __syncthreads();
  tl_mark(0, 3);
  // each walker's offset within the row's run of a bucket (the walkers'
  // pairs before it), to the scatter, and the row's pairs per bucket, a
  // row of the table: a word of two buckets at a time (each half stays
  // below K10_TRIS, so no carry crosses)
  int* row = table + (size_t)r * p.nb;
  unsigned* out = woff + (size_t)r * K10_WALKERS * words;
  for (int x = threadIdx.x; x < words; x += blockDim.x) {
    unsigned c[K10_WALKERS];  // the walkers' counts, read at once
#pragma unroll
    for (int w = 0; w < K10_WALKERS; ++w)
      c[w] = w < walkers ? cnt[w * words + x] : 0;
    unsigned run = 0;
#pragma unroll
    for (int w = 0; w < K10_WALKERS; ++w) {
      if (w < walkers && walkers > 1) out[w * words + x] = run;
      run += c[w];
    }
    row[2 * x] = (int)(run & 0xffff);
    if (2 * x + 1 < p.nb) row[2 * x + 1] = (int)(run >> 16);
  }
  tl_mark(0, K10_TL_END);
}

// A block per 32 buckets, a lane per bucket: each warp holds
// K10_SCAN_ROWS rows of the columns at a time, the warps' sums give each
// its first slot, and the column's running sum carries over to the next
// K10_SCAN_WARPS x K10_SCAN_ROWS rows; so each row's count becomes the
// row's first slot within the bucket. The last block then scans the
// bucket totals: each bucket's first slot s and end e over all pairs, and
// the cut: a tile's start min(s, cap) and count min(e, cap) - min(s, cap),
// a layer's big count min(that, big_cap) and big overflow the rest; the
// kept pairs min(all, cap), overflow max(all - cap, 0) and the other
// layers' overflow 0
__global__ void __launch_bounds__(K10_SCAN_THREADS)
    k10_scan_kernel(BinParams p, unsigned long long* __restrict__ state,
                    int* __restrict__ table, int* __restrict__ total,
                    int* __restrict__ bstart, int* __restrict__ starts,
                    int* __restrict__ counts, int* __restrict__ big_count,
                    int* __restrict__ big_over, int* __restrict__ overflow,
                    int* __restrict__ kept) {
  __shared__ int tmp[32];
  __shared__ int part[K10_SCAN_WARPS][32];
  __shared__ bool last;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int b = blockIdx.x * 32 + lane;
  tl_mark(2, 0);
  int carry = 0;
  for (int r0 = 0; r0 < p.nblocks; r0 += K10_SCAN_WARPS * K10_SCAN_ROWS) {
    const int rw = r0 + warp * K10_SCAN_ROWS;
    int v[K10_SCAN_ROWS];
    int sum = 0;
#pragma unroll
    for (int u = 0; u < K10_SCAN_ROWS; ++u) {
      v[u] = b < p.nb && rw + u < p.nblocks
                 ? table[(size_t)(rw + u) * p.nb + b]
                 : 0;
      sum += v[u];
    }
    part[warp][lane] = sum;
    __syncthreads();
    int run = carry;
    for (int w = 0; w < K10_SCAN_WARPS; ++w) {
      if (w < warp) run += part[w][lane];
      carry += part[w][lane];
    }
#pragma unroll
    for (int u = 0; u < K10_SCAN_ROWS; ++u) {
      if (b < p.nb && rw + u < p.nblocks)
        table[(size_t)(rw + u) * p.nb + b] = run;
      run += v[u];
    }
    __syncthreads();
  }
  if (warp == 0 && b < p.nb) total[b] = carry;
  tl_mark(2, 1);
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  // k10_count's look-back words, zero for the next binning
  for (int x = g; x < p.nblocks; x += gridDim.x * blockDim.x)
    state[K10_LOOKBACK + x] = 0;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned long long done = atomicAdd(&state[K10_DONE], 1ull);
    last = done == gridDim.x - 1;
    if (last) atomicExch(&state[K10_DONE], 0ull);
  }
  __syncthreads();
  tl_mark(2, 2);
  if (!last) {
    tl_mark(2, K10_TL_END);
    return;
  }
  __threadfence();
  // the totals through L2 into shared memory; each thread scans a run of
  // consecutive buckets there, and the outputs go out coalesced
  int* pre = (int*)k10_smem;  // nb
  for (int b0 = threadIdx.x; b0 < p.nb; b0 += K10_PREFETCH * blockDim.x) {
    int v[K10_PREFETCH];  // loads in flight together
#pragma unroll
    for (int u = 0; u < K10_PREFETCH; ++u) {
      const int b = b0 + u * blockDim.x;
      v[u] = b < p.nb ? __ldcg(total + b) : 0;
    }
#pragma unroll
    for (int u = 0; u < K10_PREFETCH; ++u)
      if (b0 + u * blockDim.x < p.nb) pre[b0 + u * blockDim.x] = v[u];
  }
  __syncthreads();
  const int per = (p.nb + blockDim.x - 1) / blockDim.x;
  const int b0 = min((int)threadIdx.x * per, p.nb), b1 = min(b0 + per, p.nb);
  int sum = 0;
  for (int b = b0; b < b1; ++b) sum += pre[b];
  int all;
  int s = block_scan(sum, tmp, &all);
  for (int b = b0; b < b1; ++b) {
    const int v = pre[b];
    pre[b] = s;
    s += v;
  }
  __syncthreads();
  for (int b = threadIdx.x; b < p.nb; b += blockDim.x) {
    const int s0 = pre[b], e = b + 1 < p.nb ? pre[b + 1] : all;
    const int sc = min(s0, p.cap), n = min(e, p.cap) - sc;
    bstart[b] = s0;
    if (b < p.nl) {
      const int bc = min(n, p.big_cap);
      big_count[b] = bc;
      big_over[b] = n - bc;
    } else {
      starts[b - p.nl] = sc;
      counts[b - p.nl] = n;
    }
  }
  if (threadIdx.x == 0) {
    overflow[0] = max(all - p.cap, 0);
    overflow[1] = 0;
    kept[0] = min(all, p.cap);
  }
  tl_mark(2, K10_TL_END);
}

// The scatter's shared memory (bytes) with w walkers: the row's
// descriptors, each bucket's first slot for the row (int32, padded to 16
// bytes), then with several walkers a row of 16-bit offsets per walker (an
// even count a row); a bucket gets at most one pair of a triangle, so a
// row's offsets stay below K10_TRIS. With one walker it fits
// K10_SMEM_MAX up to K10_MAX_BUCKETS.
static int scatter_bytes(int nb, int w) {
  const int nb4 = (nb + 3) & ~3, nbp = nb + (nb & 1);
  return K10_TRIS * 8 + nb4 * 4 + (w > 1 ? w * nbp * 2 : 0);
}

// a row's walkers, the same in k10_count and k10_scatter: the most (at
// most one a warp) whose offsets fit two scatter blocks an SM, else one
static int walkers_of(int nb) {
  int walkers = K10_WALKERS;
  while (walkers > 1 && scatter_bytes(nb, walkers) > K10_SMEM_TARGET)
    --walkers;
  return walkers;
}

__global__ void __launch_bounds__(K10_SCATTER_THREADS, 2)
    k10_scatter_kernel(BinParams p, int walkers,
                       const int2* __restrict__ desc,
                       const int* __restrict__ table,
                       const int* __restrict__ bstart,
                       const int* __restrict__ big_count,
                       const int* __restrict__ kept,
                       const unsigned* __restrict__ woff,
                       int* __restrict__ pair_tri, int* __restrict__ big_tri) {
  __shared__ int grp[K10_GROUPS + 1];  // each group's first pair, then all
  __shared__ unsigned char inv[K10_WALKERS][32];  // warp_pairs'
  const int r = blockIdx.x, nb = p.nb;
  const int nbp = nb + (nb & 1), words = nbp / 2;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int tri0 = r * K10_TRIS, ntris = min(K10_TRIS, p.t - tri0);
  int2* rdesc = (int2*)k10_smem;                   // the row's descriptors
  int* base = (int*)(k10_smem + K10_TRIS * 8);     // nb
  unsigned short* off = (unsigned short*)(base + ((nb + 3) & ~3));
  tl_mark(1, 0);
  for (int i = threadIdx.x; i < K10_TRIS; i += blockDim.x)
    rdesc[i] = i < ntris ? desc[tri0 + i] : make_int2(0, 0);
  // each walker's offsets (k10_count), 16 bytes a load, K10_PREFETCH
  // loads a thread in flight (the row's offsets start 16-byte aligned)
  if (walkers > 1) {
    const int4* in = (const int4*)(woff + (size_t)r * K10_WALKERS * words);
    int4* to = (int4*)off;
    const int n4 = walkers * words / 4;
    for (int x0 = threadIdx.x; x0 < n4; x0 += K10_PREFETCH * blockDim.x) {
      int4 v[K10_PREFETCH];
#pragma unroll
      for (int u = 0; u < K10_PREFETCH; ++u) {
        const int x = x0 + u * blockDim.x;
        v[u] = x < n4 ? in[x] : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < K10_PREFETCH; ++u)
        if (x0 + u * blockDim.x < n4) to[x0 + u * blockDim.x] = v[u];
    }
    const unsigned* in1 = (const unsigned*)in;
    for (int x = 4 * n4 + threadIdx.x; x < walkers * words; x += blockDim.x)
      ((unsigned*)off)[x] = in1[x];
  }
  __syncthreads();
  // each group's pairs, a warp's groups loaded at once
  {
    constexpr int per = K10_GROUPS / K10_WALKERS;
    int n[per];
#pragma unroll
    for (int u = 0; u < per; ++u)
      n[u] = group_desc(rdesc, ntris, warp + u * K10_WALKERS).y & 0xffff;
#pragma unroll
    for (int u = 0; u < per; ++u) {
      const int tot = __shfl_sync(FULL, warp_scan(n[u]), 31);
      if (lane == 0) grp[warp + u * K10_WALKERS] = tot;
    }
  }
  __syncthreads();
  if (warp == 0) scan_groups(grp);
  __syncthreads();
  tl_mark(1, 1);
  const int2 range = warp_range(grp, min(warp, walkers - 1), walkers);
  const int lo = range.x, hi = range.y;
  unsigned short* mine = off + warp * nbp;
  tl_mark(1, 2);
  // each bucket's first slot for the row: the bucket's, then this row's
  // within it, K10_PREFETCH buckets a thread at once
  const int* row = table + (size_t)r * nb;
  for (int b0 = threadIdx.x; b0 < nb; b0 += K10_PREFETCH * blockDim.x) {
    int first[K10_PREFETCH];
#pragma unroll
    for (int u = 0; u < K10_PREFETCH; ++u) {
      const int b = b0 + u * blockDim.x;
      first[u] = b < nb ? bstart[b] + row[b] : 0;
    }
#pragma unroll
    for (int u = 0; u < K10_PREFETCH; ++u)
      if (b0 + u * blockDim.x < nb) base[b0 + u * blockDim.x] = first[u];
  }
  __syncthreads();
  tl_mark(1, 3);
  if (warp < walkers) {
    // one walker: base is its running slot; several: its offsets
    TLW_START;
    const int2 gs = walk(p, rdesc, ntris, grp, tri0, lo, hi, inv[warp],
                         [&](int b, int tri) {
      const unsigned peers = __match_any_sync(FULL, b);
      const int o = b >= 0 ? (walkers > 1 ? mine[b] : 0) : 0;
      const int first = b >= 0 ? base[b] + o : 0;
      __syncwarp();
      if (b >= 0) {
        const int rank = __popc(peers & ((1u << lane) - 1));
        if (rank == __popc(peers) - 1) {
          if (walkers > 1)
            mine[b] = (unsigned short)(o + rank + 1);
          else
            base[b] = first + rank + 1;
        }
        const int pos = first + rank;
        if (pos < p.cap) {
          pair_tri[pos] = tri;
          if (b < p.nl && pos - bstart[b] < big_count[b])
            big_tri[b * p.big_cap + pos - bstart[b]] = tri;
        }
      }
      __syncwarp();
    });
    TLW_STOP(1, gs);
  }
  tl_mark(1, K10_TL_END);
  // zeros: pair_tri past the kept pairs (its trailing slot included) and
  // the big lists past their counts
  const int stride = gridDim.x * blockDim.x;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  for (int i = kept[0] + g; i <= p.cap; i += stride) pair_tri[i] = 0;
  for (int x = g; x < p.nl * p.big_cap; x += stride)
    if (x % p.big_cap >= big_count[x / p.big_cap]) big_tri[x] = 0;
}

// the fixed cost of a launch: chip_smoke.py times it back to back
__global__ void k10_empty_kernel() {}

static int params_of(const int* prm, BinParams* p) {
  if (prm[0] != K10_NPARAMS) return (int)cudaErrorInvalidValue;
  memcpy(p, prm + 1, sizeof(BinParams));
  return 0;
}

extern "C" int k10_count(const int* prm, const int4* bbox, const bool* valid,
                         const int* layer, unsigned long long* state,
                         int2* desc, int* table, unsigned* woff,
                         cudaStream_t s) {
  BinParams p;
  if (params_of(prm, &p)) return (int)cudaErrorInvalidValue;
  const int walkers = walkers_of(p.nb);
  const int bytes = K10_TRIS * 8 + walkers * (p.nb + (p.nb & 1)) * 2;
  if (bytes > K10_SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      k10_count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  k10_count_kernel<<<p.nblocks, K10_COUNT_THREADS, bytes, s>>>(
      p, bbox, valid, layer, state, walkers, desc, table, woff);
  return (int)cudaGetLastError();
}

extern "C" int k10_scan(const int* prm, unsigned long long* state, int* table,
                        int* total, int* bstart, int* starts, int* counts,
                        int* big_count, int* big_over, int* overflow,
                        int* kept, cudaStream_t s) {
  BinParams p;
  if (params_of(prm, &p)) return (int)cudaErrorInvalidValue;
  const int bytes = p.nb * 4;  // the last block's bucket totals
  if (bytes > K10_SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      k10_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const int grid = (p.nb + 31) / 32;
  k10_scan_kernel<<<grid, K10_SCAN_THREADS, bytes, s>>>(
      p, state, table, total, bstart, starts, counts, big_count, big_over,
      overflow, kept);
  return (int)cudaGetLastError();
}

extern "C" int k10_scatter(const int* prm, const int2* desc, const int* table,
                           const int* bstart, const int* big_count,
                           const int* kept, const unsigned* woff,
                           int* pair_tri, int* big_tri, cudaStream_t s) {
  BinParams p;
  if (params_of(prm, &p)) return (int)cudaErrorInvalidValue;
  const int walkers = walkers_of(p.nb);
  const int bytes = scatter_bytes(p.nb, walkers);
  if (bytes > K10_SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      k10_scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  k10_scatter_kernel<<<p.nblocks, K10_SCATTER_THREADS, bytes, s>>>(
      p, walkers, desc, table, bstart, big_count, kept, woff, pair_tri,
      big_tri);
  return (int)cudaGetLastError();
}

extern "C" int k10_empty(cudaStream_t s) {
  k10_empty_kernel<<<1, 32, 0, s>>>();
  return (int)cudaGetLastError();
}
