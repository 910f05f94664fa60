// K4: BVH traversal, closest-hit and any-hit, over either BVH layout, with
// an optional alpha filter inside the walk.
//
// Replaces the traced wavefront loop of incarnation_tpu/kernels/bvh.py
// trace / occluded (bvh.py:1108, :1241): a jnp step (_step_wide,
// bvh.py:914-987, or the binary _step, :844-900) inside lax.fori_loop /
// while_loop, wrapped in compaction ladders that exist for the TPU's
// lock-step wavefront (_compact :990, _SCHEDULES :1034). It is not a Pallas
// kernel there; on the GPU it has to be one, because torch has no
// device-side loop (a torch step is some fifty launches, and the walk
// hundreds of steps).
//
// Design for Hopper: one thread per ray walks the threaded rows
// stacklessly, with the layout a compile-time role:
// - wide (LAYOUT 0): as _step_wide does, a leaf row tests its 4 inline
//   triangles in order, then follows its miss link; an internal row
//   slab-tests its 8 child boxes in storage order and takes the hit child
//   with the smallest position in the ray's octant order (3-bit fields of
//   the row's iperm word), else the miss link. Every lane a step may use
//   (the 48 box or geometry lanes, the flag and 8 child ids, the octant's
//   (iperm, miss) pair) is loaded in one round of 16-byte loads before the
//   flag is known, so a step waits for memory once; the tests are
//   branch-free, so their loads and arithmetic overlap.
// - binary merged (LAYOUT 1) and split (LAYOUT 2): as _step does, the ray
//   reads node cur of its octant's table (okt_off = octant x nodes): the
//   merged row at cur + okt_off with its (hit, miss) links at lanes 13, 14,
//   or the row at cur and the split link pair at cur + okt_off. A step
//   loads the row's box, flag and links (48 of its 192 bytes: the merged
//   table, about 240 MB for the atrium, does not fit the 50 MB L2, so the
//   bytes count), and a leaf's 48 lanes after its flag. A leaf tests its 4
//   slots and follows the miss link; an internal row slab-tests its box,
//   pruned by min(t_best, tmax), and follows the hit link on a hit, else
//   the miss link; the next node is link - okt_off.
// A leaf slot is accepted where it is a filled triangle with t < t_best
// (strict) and t <= tmax and, in the alpha role (ALPHA), where the path
// tracer's opacity test passes (kernels/pathtrace.py _alpha_at_hit: the
// hit's UV from tri_vtx and uvs, the prim's alpha mode and material, the
// u8 alpha mirror sampled bilinearly at mip 0 with the material's address
// mode, times the material's alpha factor, against its cutoff or, for
// BLEND prims, the ray's noise value). The test runs only where a slot
// would otherwise be accepted: the same result as the twin's test of
// every slot, with fewer fetches. Any-hit stops at the first accepted
// slot. A ray that has visited max_steps rows stops with its best hit and
// counts in `trunc`.
//
// Arithmetic: the reference's, term by term (the inv_d guard, o + d tmin,
// tmax - tmin, Moller-Trumbore with jnp.cross's products and the dot
// products as the multiply-adds XLA's CPU build fuses), built --fmad=false
// except those multiply-adds, each one FFMA rounded once. The twin
// (kernels/bvh.py trace_plain, _fma) computes the same single roundings
// exactly, so K4 equals it bit for bit and agrees with the JAX trace to
// rounding.
//
// Scheduling: where a launch has more rays than one wave of blocks has
// lanes, its blocks are persistent (as many as fit on the card) and a
// warp takes 32 ray ids from a work counter, refilling its idle lanes once
// K4_REFILL of them are idle (Aila and Laine's persistent while-while loop
// with dynamic fetch, "Understanding the Efficiency of Ray Traversal on
// GPUs", HPG 2009): walks of very different lengths no longer hold a warp
// for its longest ray. Smaller launches (the alpha peels) run a thread per
// ray. A ray's result does not depend on its lane.
//
// What bounds it: the rows a walk touches, through dependent loads (each
// step needs the last one's link). On the H100 a step's loads cost more
// than its tests: testing children in octant order and stopping at the
// first hit (10-16% fewer box tests on the atrium's rays) loads a box
// after the row's order is known and made every wide role 1.5-1.7x
// slower; sorting the rays by octant in a pre-pass and prefetching a row's
// boxes into L1 did not pay either (PERF.md).
//
// Counters: each warp (persistent) or block adds its truncated rays to
// counters[0], each block counts its arrival in counters[1], and the last
// block to arrive writes the total to *trunc_out and zeroes all three
// counters (counters[2]: the work counter), so they stay zero between
// launches and a call needs no memset.

#include <cuda_runtime.h>
#include <math_constants.h>

#define K4_THREADS 128
#define K4_LANES 80
#define K4_THREAD 64
#define K4_FULL 0xffffffffu
// a persistent warp refills its idle lanes from the work counter once
// this many of its 32 are idle (the least time per PT sample and RT frame
// among 4-32 on the H100, tools/torch_kernel_ab.py)
#define K4_REFILL 8

// a * b + c rounded once (one FFMA): the twin's _fma computes the same
// single rounding exactly, from f64 with a correction at f32 midpoints.
__device__ __forceinline__ float k4_fma(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}

// One ray's walk state, in registers.
struct K4Ray {
  float ox, oy, oz;      // o + d tmin
  float dx, dy, dz;
  float ix, iy, iz;      // the guarded reciprocal direction
  float tm, tmax_eff;    // tmin, tmax - tmin
  float t_best, bu, bv;
  int okt, best_tri, cur, steps;
};

// Moller-Trumbore against the triangle g = [v0, e1, e2] (bvh.py:822-841),
// each cross-product term and dot product a fused multiply-add as XLA
// compiles jnp.cross and jnp.sum: t, or +inf where the ray misses or meets
// a culled backface.
__device__ __forceinline__ float k4_triangle(const float* g, const K4Ray& r,
                                             bool cull, float& u, float& v) {
  const float v0x = g[0], v0y = g[1], v0z = g[2];
  const float e1x = g[3], e1y = g[4], e1z = g[5];
  const float e2x = g[6], e2y = g[7], e2z = g[8];
  const float px = k4_fma(r.dy, e2z, -(r.dz * e2y));
  const float py = k4_fma(r.dz, e2x, -(r.dx * e2z));
  const float pz = k4_fma(r.dx, e2y, -(r.dy * e2x));
  const float det = k4_fma(e1z, pz, k4_fma(e1y, py, e1x * px));
  const bool big = fabsf(det) > 1e-12f;
  bool ok = cull ? det < -1e-12f : big;
  const float inv = 1.0f / (big ? det : 1.0f);
  const float tx = r.ox - v0x, ty = r.oy - v0y, tz = r.oz - v0z;
  u = k4_fma(tz, pz, k4_fma(ty, py, tx * px)) * inv;
  const float qx = k4_fma(ty, e1z, -(tz * e1y));
  const float qy = k4_fma(tz, e1x, -(tx * e1z));
  const float qz = k4_fma(tx, e1y, -(ty * e1x));
  v = k4_fma(r.dz, qz, k4_fma(r.dy, qy, r.dx * qx)) * inv;
  const float t = k4_fma(e2z, qz, k4_fma(e2y, qy, e2x * qx)) * inv;
  ok = ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > 0.0f;
  return ok ? t : CUDART_INF_F;
}

// slab test of the box [lo, hi] from tn = 0 and tf = limit: the running
// bounds in the twin's order
__device__ __forceinline__ bool k4_slab(float lox, float loy, float loz,
                                        float hix, float hiy, float hiz,
                                        const K4Ray& r, float limit) {
  float tn = 0.0f, tf = limit;
  {
    const float t0 = (lox - r.ox) * r.ix;
    const float t1 = (hix - r.ox) * r.ix;
    tn = fmaxf(tn, fminf(t0, t1));
    tf = fminf(tf, fmaxf(t0, t1));
  }
  {
    const float t0 = (loy - r.oy) * r.iy;
    const float t1 = (hiy - r.oy) * r.iy;
    tn = fmaxf(tn, fminf(t0, t1));
    tf = fminf(tf, fmaxf(t0, t1));
  }
  {
    const float t0 = (loz - r.oz) * r.iz;
    const float t1 = (hiz - r.oz) * r.iz;
    tn = fmaxf(tn, fminf(t0, t1));
    tf = fminf(tf, fmaxf(t0, t1));
  }
  return tn <= tf;
}

// The alpha role's inputs (kernels/bvh.py _K4Alpha): the scene and texture
// tensors the opacity test reads, and one BLEND noise value per ray.
struct K4Alpha {
  const int* tri_vtx;          // (T, 3)
  const float* uvs;            // (V, 2)
  const int* tri_prim;         // (T,)
  const int* prim_alpha_mode;  // (P,) 0 opaque, 1 mask, >= 2 blend
  const int* prim_material;    // (P,)
  const float* mat_params;     // (NM, mat_stride)
  const int* meta;             // (n_meta, 6) texture stack meta
  const int* alpha_words;      // (alpha_rows, 4) u8 alpha mirror words
  const float* noise;          // (R,)
  int mat_stride, n_meta, alpha_rows, n_mat;
};

// scene/textures.py _address: wrap, clamp or mirror an integer texel
// coordinate into [0, n)
__device__ __forceinline__ int k4_address(int c, int n, int mode) {
  if (mode == 0) {
    const int r = c % n;
    return r < 0 ? r + n : r;
  }
  if (mode == 1) return min(max(c, 0), n - 1);
  int p = c % (2 * n);
  if (p < 0) p += 2 * n;
  return p < n ? p : 2 * n - 1 - p;
}

// one u8 texel of the alpha mirror, 4 texels per word, 4 words per row
__device__ __forceinline__ float k4_alpha_texel(const K4Alpha& A, int b0,
                                                int s0, int x, int y) {
  const int idx = b0 + y * s0 + x;
  const int row = min(max(idx >> 4, 0), A.alpha_rows - 1);
  const int word = __ldg(A.alpha_words + 4 * row + ((idx >> 2) & 3));
  return (float)((word >> ((idx & 3) * 8)) & 0xFF) * (1.0f / 255.0f);
}

// kernels/pathtrace.py _alpha_at_hit for one hit, the twin's operations in
// its order: true = accept
__device__ bool k4_alpha_accept(const K4Alpha& A, int tri, float u, float v,
                                int ray) {
  const int safe = max(tri, 0);
  const int i0 = __ldg(A.tri_vtx + 3 * safe + 0);
  const int i1 = __ldg(A.tri_vtx + 3 * safe + 1);
  const int i2 = __ldg(A.tri_vtx + 3 * safe + 2);
  const float a0x = __ldg(A.uvs + 2 * i0), a0y = __ldg(A.uvs + 2 * i0 + 1);
  const float a1x = __ldg(A.uvs + 2 * i1), a1y = __ldg(A.uvs + 2 * i1 + 1);
  const float a2x = __ldg(A.uvs + 2 * i2), a2y = __ldg(A.uvs + 2 * i2 + 1);
  const float ux = (a0x + u * (a1x - a0x)) + v * (a2x - a0x);
  const float uy = (a0y + u * (a1y - a0y)) + v * (a2y - a0y);
  const int prim = max(__ldg(A.tri_prim + safe), 0);
  const int mode = __ldg(A.prim_alpha_mode + prim);
  const int mat = __ldg(A.prim_material + prim);
  // textures.sample_stack_alpha at mip 0
  const int* meta = A.meta + 6 * min(max(mat, 0), A.n_meta - 1);
  const int base = __ldg(meta + 5), size = __ldg(meta + 1);
  const int address = __ldg(meta + 3);
  const float sf = (float)size;
  const float fx = ux * sf - 0.5f;
  const float fy = uy * sf - 0.5f;
  const int x0 = (int)floorf(fx);
  const int y0 = (int)floorf(fy);
  const float tx = fx - (float)x0;
  const float ty = fy - (float)y0;
  const int xa = k4_address(x0, size, address);
  const int xb = k4_address(x0 + 1, size, address);
  const int ya = k4_address(y0, size, address);
  const int yb = k4_address(y0 + 1, size, address);
  const float top = k4_alpha_texel(A, base, size, xa, ya) * (1.0f - tx)
      + k4_alpha_texel(A, base, size, xb, ya) * tx;
  const float bot = k4_alpha_texel(A, base, size, xa, yb) * (1.0f - tx)
      + k4_alpha_texel(A, base, size, xb, yb) * tx;
  const float a_tex = top * (1.0f - ty) + bot * ty;
  const float* fac = A.mat_params
      + (size_t)min(max(mat, 0), A.n_mat - 1) * A.mat_stride;
  const float alpha = __ldg(fac + 6) * a_tex;
  const float thresh = mode >= 2 ? fmaxf(__ldg(A.noise + ray), 1e-3f)
                                 : __ldg(fac + 11);
  return mode == 0 || alpha >= thresh;
}

// The row's first 48 lanes, loaded at once (12 16-byte loads).
__device__ __forceinline__ void k4_load48(const float4* r4, float* L) {
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    const float4 w = __ldg(r4 + j);
    L[4 * j + 0] = w.x;
    L[4 * j + 1] = w.y;
    L[4 * j + 2] = w.z;
    L[4 * j + 3] = w.w;
  }
}

// The 4 inline slots of a leaf row L (geometry, id lane, double-sided
// lane; wide or binary: the same lanes) in order, each tested branch-free
// (a slot whose id is negative is never accepted: skipping its test ahead
// did not pay on the H100); returns true when an any-hit ray accepted one.
template <bool ANY_HIT, bool ALPHA>
__device__ __forceinline__ bool k4_leaf(const float* L, K4Ray& r,
                                        const K4Alpha& A, int ray) {
  const int o9s[4] = {0, 15, 24, 33};
  const int oid[4] = {10, 42, 43, 44};
  const int ods[4] = {11, 45, 46, 47};
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int tri = (int)L[oid[s]];
    float u, v;
    const float t_hit = k4_triangle(L + o9s[s], r, L[ods[s]] < 0.5f, u, v);
    if (tri >= 0 && t_hit < r.t_best && t_hit <= r.tmax_eff
        && (!ALPHA || k4_alpha_accept(A, tri, u, v, ray))) {
      r.t_best = t_hit;
      r.best_tri = tri;
      r.bu = u;
      r.bv = v;
      if (ANY_HIT) return true;
    }
  }
  return false;
}

// Ray i's walk state at the start (the reference's ray setup,
// bvh.py:1122-1138).
__device__ __forceinline__ void k4_setup(K4Ray& r, int i,
                                         const float* origins,
                                         const float* dirs,
                                         const float* tmin_ray, float tmin,
                                         float tmax) {
  r.tm = tmin_ray != nullptr ? __ldg(tmin_ray + i) : tmin;
  r.dx = __ldg(dirs + 3 * i + 0);
  r.dy = __ldg(dirs + 3 * i + 1);
  r.dz = __ldg(dirs + 3 * i + 2);
  r.ox = k4_fma(r.dx, r.tm, __ldg(origins + 3 * i + 0));
  r.oy = k4_fma(r.dy, r.tm, __ldg(origins + 3 * i + 1));
  r.oz = k4_fma(r.dz, r.tm, __ldg(origins + 3 * i + 2));
  r.tmax_eff = tmax - r.tm;
  r.ix = 1.0f / (fabsf(r.dx) > 1e-12f ? r.dx
                 : (r.dx >= 0.0f ? 1e-12f : -1e-12f));
  r.iy = 1.0f / (fabsf(r.dy) > 1e-12f ? r.dy
                 : (r.dy >= 0.0f ? 1e-12f : -1e-12f));
  r.iz = 1.0f / (fabsf(r.dz) > 1e-12f ? r.dz
                 : (r.dz >= 0.0f ? 1e-12f : -1e-12f));
  r.okt = (r.dx < 0.0f) + 2 * (r.dy < 0.0f) + 4 * (r.dz < 0.0f);
  r.t_best = CUDART_INF_F;
  r.bu = 0.0f;
  r.bv = 0.0f;
  r.best_tri = -1;
  r.cur = 0;
  r.steps = 0;
}

// One step of ray r's walk: the row cur. Returns true when the walk is
// done (an any-hit ray accepted a slot, or the next link is -1).
template <bool ANY_HIT, int LAYOUT, bool ALPHA>
__device__ __forceinline__ bool k4_step(K4Ray& r, const float* rows,
                                        const int* links, int nodes,
                                        const K4Alpha& A, int ray) {
  ++r.steps;
  int nxt;
  float L[48];
  if (LAYOUT == 0) {
    // every lane the step may use, in one round of loads: the 48 box or
    // leaf lanes, the flag and child ids, the octant's (iperm, miss)
    const float* row = rows + (size_t)r.cur * K4_LANES;
    const float4* r4 = reinterpret_cast<const float4*>(row);
    const float4 w12 = __ldg(r4 + 12);   // flag, -, child 0, child 1
    const float4 c13 = __ldg(r4 + 13);   // children 2-5
    const float4 c14 = __ldg(r4 + 14);   // children 6, 7
    const float2 th = __ldg(
        reinterpret_cast<const float2*>(row + K4_THREAD + 2 * r.okt));
    k4_load48(r4, L);
    nxt = (int)th.y;                      // the miss link
    if (w12.x > 0.5f) {
      if (k4_leaf<ANY_HIT, ALPHA>(L, r, A, ray)) return true;
    } else {
      // 8 child slabs in storage order, the hit child with the smallest
      // octant position wins
      const float cid_f[8] = {w12.z, w12.w, c13.x, c13.y,
                              c13.z, c13.w, c14.x, c14.y};
      const int iperm = (int)th.x;
      const float limit = fminf(r.t_best, r.tmax_eff);
      int best_pos = 8;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int cid = (int)cid_f[k];
        const int pos = (iperm >> (3 * k)) & 7;
        const bool hit = k4_slab(L[6 * k], L[6 * k + 1], L[6 * k + 2],
                                 L[6 * k + 3], L[6 * k + 4], L[6 * k + 5],
                                 r, limit);
        if (hit & (cid >= 0) & (pos < best_pos)) {
          best_pos = pos;
          nxt = cid;
        }
      }
    }
    if (nxt < 0) return true;
    r.cur = nxt;
    return false;
  }
  // binary: the flag and links, and the box of an internal row (95% of
  // the steps), first; a leaf's slots after its flag
  const int okt_off = r.okt * nodes;
  const size_t at = (size_t)(LAYOUT == 1 ? r.cur + okt_off : r.cur);
  const float4* r4 = reinterpret_cast<const float4*>(rows + at * 48);
  const float4 q0 = __ldg(r4), q1 = __ldg(r4 + 1);  // the box: lanes 0:6
  const float4 q3 = __ldg(r4 + 3);                   // flag, hit, miss
  int hit_l, miss_l;
  if (LAYOUT == 1) {
    hit_l = (int)q3.y;
    miss_l = (int)q3.z;
  } else {
    const int2 lk = __ldg(reinterpret_cast<const int2*>(links)
                          + r.cur + okt_off);
    hit_l = lk.x;
    miss_l = lk.y;
  }
  nxt = miss_l;
  if (q3.x > 0.5f) {
    k4_load48(r4, L);
    if (k4_leaf<ANY_HIT, ALPHA>(L, r, A, ray)) return true;
  } else if (k4_slab(q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, r,
                     fminf(r.t_best, r.tmax_eff))) {
    nxt = hit_l;
  }
  if (nxt < 0) return true;
  r.cur = nxt - okt_off;
  return false;
}

__device__ __forceinline__ void k4_write(const K4Ray& r, int i, float* t_out,
                                         int* tri_out, float* u_out,
                                         float* v_out, int* steps_out) {
  t_out[i] = r.best_tri >= 0 ? r.t_best + r.tm : CUDART_INF_F;
  tri_out[i] = r.best_tri;
  u_out[i] = r.bu;
  v_out[i] = r.bv;
  if (steps_out != nullptr) steps_out[i] = r.steps;
}

template <bool ANY_HIT, int LAYOUT, bool ALPHA, bool PERSIST>
__global__ void __launch_bounds__(K4_THREADS)
k4_trace_kernel(const float* __restrict__ rows,      // see LAYOUT
                const int* __restrict__ links,       // (8N, 2), LAYOUT 2
                int nodes,                           // N per octant table
                const float* __restrict__ origins,   // (R, 3)
                const float* __restrict__ dirs,      // (R, 3)
                const float* __restrict__ tmin_ray,  // (R,) or NULL
                float tmin, float tmax, int n_rays, int max_steps,
                float* __restrict__ t_out, int* __restrict__ tri_out,
                float* __restrict__ u_out, float* __restrict__ v_out,
                int* __restrict__ steps_out,         // (R,) or NULL
                int* __restrict__ counters,  // [trunc, arrivals, work]
                int* __restrict__ trunc_out, K4Alpha alpha) {
  int n_trunc = 0;
  K4Ray r;
  if (PERSIST) {
    const unsigned lane = threadIdx.x & 31u;
    int i = -1;            // this lane's ray, -1: idle
    bool more = true;      // the work counter may hold rays (warp-uniform)
    for (;;) {
      const unsigned idle = __ballot_sync(K4_FULL, i < 0);
      if (more && __popc(idle) >= K4_REFILL) {
        const int want = __popc(idle);
        int base = 0;
        if (lane == 0) base = atomicAdd(&counters[2], want);
        base = __shfl_sync(K4_FULL, base, 0);
        more = base + want < n_rays;
        if (idle == K4_FULL && base >= n_rays) break;
        const int j = base + __popc(idle & ((1u << lane) - 1u));
        if (i < 0 && j < n_rays) {
          i = j;
          k4_setup(r, i, origins, dirs, tmin_ray, tmin, tmax);
        }
      } else if (idle == K4_FULL) {
        break;
      }
      if (i >= 0) {
        const bool done = k4_step<ANY_HIT, LAYOUT, ALPHA>(r, rows, links,
                                                           nodes, alpha, i);
        if (done || r.steps >= max_steps) {
          n_trunc += !done;
          k4_write(r, i, t_out, tri_out, u_out, v_out, steps_out);
          i = -1;
        }
      }
    }
    n_trunc = (int)__reduce_add_sync(K4_FULL, (unsigned)n_trunc);
    if (lane == 0 && n_trunc) atomicAdd(&counters[0], n_trunc);
    __syncthreads();
  } else {
    const int i = blockIdx.x * K4_THREADS + threadIdx.x;
    if (i < n_rays) {
      k4_setup(r, i, origins, dirs, tmin_ray, tmin, tmax);
      bool done = false;
      while (!done && r.steps < max_steps)
        done = k4_step<ANY_HIT, LAYOUT, ALPHA>(r, rows, links, nodes,
                                               alpha, i);
      n_trunc = !done;
      k4_write(r, i, t_out, tri_out, u_out, v_out, steps_out);
    }
    n_trunc = __syncthreads_count(n_trunc);
    if (threadIdx.x == 0 && n_trunc) atomicAdd(&counters[0], n_trunc);
  }
  if (threadIdx.x == 0) {
    __threadfence();
    const unsigned arrived = atomicAdd((unsigned*)&counters[1], 1u);
    if (arrived == gridDim.x - 1) {
      *trunc_out = atomicExch(&counters[0], 0);
      atomicExch(&counters[1], 0);
      atomicExch(&counters[2], 0);
    }
  }
}

// Persistent blocks, as many as fit on the card at once (at most as many
// as the rays need), where the rays outnumber their lanes; else one thread
// per ray. Returns 0 and sets *grid and *persist, or a CUDA error.
template <bool ANY_HIT, int LAYOUT, bool ALPHA>
static int k4_grid(int n_rays, int* grid, bool* persist) {
  const int need = (n_rays + K4_THREADS - 1) / K4_THREADS;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, k4_trace_kernel<ANY_HIT, LAYOUT, ALPHA, true>, K4_THREADS,
        0);
  if (e != cudaSuccess) return (int)e;
  const int fit = sms * (per_sm > 0 ? per_sm : 1);
  *persist = need > fit;
  *grid = *persist && fit < need ? fit : need;
  return 0;
}

template <bool ANY_HIT, int LAYOUT, bool ALPHA>
static int k4_launch(cudaStream_t s, const K4Alpha& alpha,
                     const float* rows, const int* links, int nodes,
                     const float* origins, const float* dirs,
                     const float* tmin_ray, float tmin, float tmax,
                     int n_rays, int max_steps, float* t_out, int* tri_out,
                     float* u_out, float* v_out, int* steps_out,
                     int* counters, int* trunc_out) {
  int blocks = 0;
  bool persist = false;
  const int e = k4_grid<ANY_HIT, LAYOUT, ALPHA>(n_rays, &blocks, &persist);
  if (e != 0) return e;
  if (persist)
    k4_trace_kernel<ANY_HIT, LAYOUT, ALPHA, true><<<blocks, K4_THREADS, 0,
                                                    s>>>(
        rows, links, nodes, origins, dirs, tmin_ray, tmin, tmax, n_rays,
        max_steps, t_out, tri_out, u_out, v_out, steps_out, counters,
        trunc_out, alpha);
  else
    k4_trace_kernel<ANY_HIT, LAYOUT, ALPHA, false><<<blocks, K4_THREADS, 0,
                                                     s>>>(
        rows, links, nodes, origins, dirs, tmin_ray, tmin, tmax, n_rays,
        max_steps, t_out, tri_out, u_out, v_out, steps_out, counters,
        trunc_out, alpha);
  return 0;
}

template <bool ANY_HIT, int LAYOUT>
static int k4_launch_role(cudaStream_t s, const K4Alpha* alpha,
                          const float* rows, const int* links, int nodes,
                          const float* origins, const float* dirs,
                          const float* tmin_ray, float tmin, float tmax,
                          int n_rays, int max_steps, float* t_out,
                          int* tri_out, float* u_out, float* v_out,
                          int* steps_out, int* counters, int* trunc_out) {
  if (alpha != nullptr)
    return k4_launch<ANY_HIT, LAYOUT, true>(
        s, *alpha, rows, links, nodes, origins, dirs, tmin_ray, tmin, tmax,
        n_rays, max_steps, t_out, tri_out, u_out, v_out, steps_out,
        counters, trunc_out);
  return k4_launch<ANY_HIT, LAYOUT, false>(
      s, K4Alpha{}, rows, links, nodes, origins, dirs, tmin_ray, tmin, tmax,
      n_rays, max_steps, t_out, tri_out, u_out, v_out, steps_out, counters,
      trunc_out);
}

// layout: 0 wide (rows (N, 80)), 1 binary merged (rows (8N, 48)), 2 binary
// split (rows (N, 48), int32 links (8N, 2)); nodes: N. counters: 3
// int32, zero before the call and left zero by it. alpha: NULL, or the alpha
// role's table.
extern "C" int k4_trace(const float* rows, const int* links, int nodes,
                        int layout, const float* origins, const float* dirs,
                        const float* tmin_ray, float tmin, float tmax,
                        int any_hit, int n_rays, int max_steps, float* t_out,
                        int* tri_out, float* u_out, float* v_out,
                        int* steps_out, int* counters, int* trunc_out,
                        const K4Alpha* alpha, void* stream) {
  if (n_rays <= 0 || max_steps <= 0 || nodes <= 0 || layout < 0
      || layout > 2 || (layout == 2 && links == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define K4_ARGS s, alpha, rows, links, nodes, origins, dirs, tmin_ray, \
    tmin, tmax, n_rays, max_steps, t_out, tri_out, u_out, v_out, \
    steps_out, counters, trunc_out
  int e;
  if (any_hit) {
    if (layout == 0) e = k4_launch_role<true, 0>(K4_ARGS);
    else if (layout == 1) e = k4_launch_role<true, 1>(K4_ARGS);
    else e = k4_launch_role<true, 2>(K4_ARGS);
  } else {
    if (layout == 0) e = k4_launch_role<false, 0>(K4_ARGS);
    else if (layout == 1) e = k4_launch_role<false, 1>(K4_ARGS);
    else e = k4_launch_role<false, 2>(K4_ARGS);
  }
#undef K4_ARGS
  if (e != 0) return e;
  return (int)cudaGetLastError();
}
