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
//   triangles, then follows its miss link; an internal row slab-tests its
//   8 child boxes in storage order and takes the hit child with the
//   smallest position in the ray's octant order (3-bit fields of the row's
//   iperm word), else the miss link. The 320-byte row is read with 16-byte
//   loads (the leaf's 48 geometry lanes or the internal row's 48 box lanes
//   and 8 child ids) plus the octant's (iperm, miss) pair.
// - binary merged (LAYOUT 1) and split (LAYOUT 2): as _step does, the ray
//   reads node cur of its octant's table (okt_off = octant x nodes): the
//   merged row at cur + okt_off with its (hit, miss) links at lanes 13, 14,
//   or the row at cur and the split link pair at cur + okt_off. A leaf
//   tests its 4 slots and follows the miss link; an internal row
//   slab-tests its own box, pruned by min(t_best, tmax), and follows the
//   hit link on a hit, else the miss link; the next node is link - okt_off.
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
// counts in `trunc`. Built --fmad=false, with the reference's arithmetic
// term by term (the inv_d guard, o + d tmin, tmax - tmin, Moller-Trumbore
// with jnp.cross's products and the dot products as the multiply-adds
// XLA's CPU build fuses, each emulated through f64 and rounded twice), so
// it agrees bit for bit with its twin (kernels/bvh.py trace_plain) and to
// rounding with the JAX trace.
//
// What bounds it: the rows a walk touches. The atrium's wide table is
// about 32 MB and stays in the 50 MB L2 (the merged binary one, about
// 240 MB, does not); each step is a chain of dependent loads, so latency
// (and warp divergence between rays) rules, not bytes. Warp-coherent
// traversal, short stacks in shared memory and treelet prefetch are for a
// later change.
//
// trunc: each block adds its truncated rays to counters[0] and counts its
// arrival in counters[1]; the last block to arrive writes the total to
// *trunc_out and zeroes both, so the counters stay zero between launches
// and a call needs no memset.

#include <cuda_runtime.h>
#include <math_constants.h>

#define K4_THREADS 128
#define K4_LANES 80
#define K4_FLAG 48
#define K4_THREAD 64

// a * b + c, a fused multiply-add emulated through f64: the f64 product of
// two f32 values is exact, the f64 sum rounds once and the cast to f32
// again, so in rare ties it can differ from a single-rounding FMA by an
// ulp. It is the very expression of the twin's _fma, so both round alike
// on any device.
__device__ __forceinline__ float k4_fma(float a, float b, float c) {
  return (float)((double)a * (double)b + (double)c);
}

// Moller-Trumbore against the triangle [v0, e1, e2] at L[o9..o9+9]
// (bvh.py:822-841), each cross-product term and dot product in fused
// multiply-adds as XLA compiles jnp.cross and jnp.sum: t, or +inf where the
// ray misses or meets a culled backface.
__device__ __forceinline__ float k4_triangle(const float* L, int o9,
                                             float ox, float oy, float oz,
                                             float dx, float dy, float dz,
                                             bool cull, float& u, float& v) {
  const float v0x = L[o9 + 0], v0y = L[o9 + 1], v0z = L[o9 + 2];
  const float e1x = L[o9 + 3], e1y = L[o9 + 4], e1z = L[o9 + 5];
  const float e2x = L[o9 + 6], e2y = L[o9 + 7], e2z = L[o9 + 8];
  const float px = k4_fma(dy, e2z, -(dz * e2y));
  const float py = k4_fma(dz, e2x, -(dx * e2z));
  const float pz = k4_fma(dx, e2y, -(dy * e2x));
  const float det = k4_fma(e1z, pz, k4_fma(e1y, py, e1x * px));
  const bool big = fabsf(det) > 1e-12f;
  bool ok = cull ? det < -1e-12f : big;
  const float inv = 1.0f / (big ? det : 1.0f);
  const float tx = ox - v0x, ty = oy - v0y, tz = oz - v0z;
  u = k4_fma(tz, pz, k4_fma(ty, py, tx * px)) * inv;
  const float qx = k4_fma(ty, e1z, -(tz * e1y));
  const float qy = k4_fma(tz, e1x, -(tx * e1z));
  const float qz = k4_fma(tx, e1y, -(ty * e1x));
  v = k4_fma(dz, qz, k4_fma(dy, qy, dx * qx)) * inv;
  const float t = k4_fma(e2z, qz, k4_fma(e2y, qy, e2x * qx)) * inv;
  ok = ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > 0.0f;
  return ok ? t : CUDART_INF_F;
}

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

// The 4 inline slots of a leaf row L (geometry, id lane, double-sided
// lane) in order; returns true when an any-hit ray accepted one.
template <bool ANY_HIT, bool ALPHA>
__device__ __forceinline__ bool k4_leaf(const float* L, float ox, float oy,
                                        float oz, float dx, float dy,
                                        float dz, float tmax_eff,
                                        float& t_best, int& best_tri,
                                        float& bu, float& bv,
                                        const K4Alpha& A, int ray) {
  const int o9s[4] = {0, 15, 24, 33};
  const int oid[4] = {10, 42, 43, 44};
  const int ods[4] = {11, 45, 46, 47};
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    float u, v;
    const float t_hit = k4_triangle(L, o9s[s], ox, oy, oz, dx, dy, dz,
                                    L[ods[s]] < 0.5f, u, v);
    const int tri = (int)L[oid[s]];
    if (tri >= 0 && t_hit < t_best && t_hit <= tmax_eff
        && (!ALPHA || k4_alpha_accept(A, tri, u, v, ray))) {
      t_best = t_hit;
      best_tri = tri;
      bu = u;
      bv = v;
      if (ANY_HIT) return true;
    }
  }
  return false;
}

// slab test of the box [lo @ L[b..b+3], hi @ L[b+3..b+6]] from tn = 0 and
// tf = limit: the running bounds in the twin's order
__device__ __forceinline__ bool k4_slab(const float* L, int b, float ox,
                                        float oy, float oz, float ix,
                                        float iy, float iz, float limit) {
  float tn = 0.0f, tf = limit;
  {
    const float t0 = (L[b + 0] - ox) * ix;
    const float t1 = (L[b + 3] - ox) * ix;
    tn = fmaxf(tn, fminf(t0, t1));
    tf = fminf(tf, fmaxf(t0, t1));
  }
  {
    const float t0 = (L[b + 1] - oy) * iy;
    const float t1 = (L[b + 4] - oy) * iy;
    tn = fmaxf(tn, fminf(t0, t1));
    tf = fminf(tf, fmaxf(t0, t1));
  }
  {
    const float t0 = (L[b + 2] - oz) * iz;
    const float t1 = (L[b + 5] - oz) * iz;
    tn = fmaxf(tn, fminf(t0, t1));
    tf = fminf(tf, fmaxf(t0, t1));
  }
  return tn <= tf;
}

template <bool ANY_HIT, int LAYOUT, bool ALPHA>
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
                int* __restrict__ counters,          // [trunc, arrivals]
                int* __restrict__ trunc_out, K4Alpha alpha) {
  const int i = blockIdx.x * K4_THREADS + threadIdx.x;
  bool truncated = false;
  if (i < n_rays) {
    const float tm = tmin_ray != nullptr ? tmin_ray[i] : tmin;
    const float dx = dirs[3 * i + 0];
    const float dy = dirs[3 * i + 1];
    const float dz = dirs[3 * i + 2];
    const float ox = k4_fma(dx, tm, origins[3 * i + 0]);
    const float oy = k4_fma(dy, tm, origins[3 * i + 1]);
    const float oz = k4_fma(dz, tm, origins[3 * i + 2]);
    const float tmax_eff = tmax - tm;
    const float ix = 1.0f / (fabsf(dx) > 1e-12f ? dx
                             : (dx >= 0.0f ? 1e-12f : -1e-12f));
    const float iy = 1.0f / (fabsf(dy) > 1e-12f ? dy
                             : (dy >= 0.0f ? 1e-12f : -1e-12f));
    const float iz = 1.0f / (fabsf(dz) > 1e-12f ? dz
                             : (dz >= 0.0f ? 1e-12f : -1e-12f));
    const int okt = (dx < 0.0f) + 2 * (dy < 0.0f) + 4 * (dz < 0.0f);
    const int okt_off = okt * nodes;

    float t_best = CUDART_INF_F, bu = 0.0f, bv = 0.0f;
    int best_tri = -1;
    int cur = 0;
    int steps = 0;
    bool done = false;
    while (steps < max_steps) {
      ++steps;
      int nxt;
      float L[48];
      if (LAYOUT == 0) {
        const float* row = rows + (size_t)cur * K4_LANES;
        const float4* r4 = reinterpret_cast<const float4*>(row);
        const float4 w12 = __ldg(r4 + 12);   // flag, -, child 0, child 1
        const float2 th = __ldg(
            reinterpret_cast<const float2*>(row + K4_THREAD + 2 * okt));
        nxt = (int)th.y;                      // the miss link
        k4_load48(r4, L);
        if (w12.x > 0.5f) {
          if (k4_leaf<ANY_HIT, ALPHA>(L, ox, oy, oz, dx, dy, dz, tmax_eff,
                                      t_best, best_tri, bu, bv, alpha, i)) {
            done = true;
            break;
          }
        } else {
          // 8 child slabs in storage order, the hit child with the
          // smallest octant position wins
          const float4 c13 = __ldg(r4 + 13);
          const float4 c14 = __ldg(r4 + 14);
          const float cid_f[8] = {w12.z, w12.w, c13.x, c13.y,
                                  c13.z, c13.w, c14.x, c14.y};
          const int iperm = (int)th.x;
          const float limit = fminf(t_best, tmax_eff);
          int best_pos = 8;
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const int cid = (int)cid_f[k];
            const int pos = (iperm >> (3 * k)) & 7;
            if (k4_slab(L, 6 * k, ox, oy, oz, ix, iy, iz, limit) && cid >= 0
                && pos < best_pos) {
              best_pos = pos;
              nxt = cid;
            }
          }
        }
      } else {
        const size_t r = (size_t)(LAYOUT == 1 ? cur + okt_off : cur);
        const float4* r4 = reinterpret_cast<const float4*>(rows + r * 48);
        k4_load48(r4, L);
        int hit_l, miss_l;
        if (LAYOUT == 1) {
          hit_l = (int)L[13];
          miss_l = (int)L[14];
        } else {
          const int2 lk = __ldg(reinterpret_cast<const int2*>(links)
                                + cur + okt_off);
          hit_l = lk.x;
          miss_l = lk.y;
        }
        nxt = miss_l;
        if (L[12] > 0.5f) {
          if (k4_leaf<ANY_HIT, ALPHA>(L, ox, oy, oz, dx, dy, dz, tmax_eff,
                                      t_best, best_tri, bu, bv, alpha, i)) {
            done = true;
            break;
          }
        } else if (k4_slab(L, 0, ox, oy, oz, ix, iy, iz,
                           fminf(t_best, tmax_eff))) {
          nxt = hit_l;
        }
      }
      if (nxt < 0) {
        done = true;
        break;
      }
      cur = LAYOUT == 0 ? nxt : nxt - okt_off;
    }
    truncated = !done;
    t_out[i] = best_tri >= 0 ? t_best + tm : CUDART_INF_F;
    tri_out[i] = best_tri;
    u_out[i] = bu;
    v_out[i] = bv;
    if (steps_out != nullptr) steps_out[i] = steps;
  }
  const int n_trunc = __syncthreads_count(truncated);
  if (threadIdx.x == 0) {
    if (n_trunc) atomicAdd(&counters[0], n_trunc);
    __threadfence();
    const unsigned arrived = atomicAdd((unsigned*)&counters[1], 1u);
    if (arrived == gridDim.x - 1) {
      *trunc_out = atomicExch(&counters[0], 0);
      atomicExch(&counters[1], 0);
    }
  }
}

template <bool ANY_HIT, int LAYOUT>
static void k4_launch(int blocks, cudaStream_t s, const K4Alpha* alpha,
                      const float* rows, const int* links, int nodes,
                      const float* origins, const float* dirs,
                      const float* tmin_ray, float tmin, float tmax,
                      int n_rays, int max_steps, float* t_out, int* tri_out,
                      float* u_out, float* v_out, int* steps_out,
                      int* counters, int* trunc_out) {
  if (alpha != nullptr) {
    k4_trace_kernel<ANY_HIT, LAYOUT, true><<<blocks, K4_THREADS, 0, s>>>(
        rows, links, nodes, origins, dirs, tmin_ray, tmin, tmax, n_rays,
        max_steps, t_out, tri_out, u_out, v_out, steps_out, counters,
        trunc_out, *alpha);
  } else {
    k4_trace_kernel<ANY_HIT, LAYOUT, false><<<blocks, K4_THREADS, 0, s>>>(
        rows, links, nodes, origins, dirs, tmin_ray, tmin, tmax, n_rays,
        max_steps, t_out, tri_out, u_out, v_out, steps_out, counters,
        trunc_out, K4Alpha{});
  }
}

// layout: 0 wide (rows (N, 80)), 1 binary merged (rows (8N, 48)), 2 binary
// split (rows (N, 48), int32 links (8N, 2)); nodes: N. alpha: NULL, or the
// alpha role's table.
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
  const int blocks = (n_rays + K4_THREADS - 1) / K4_THREADS;
  cudaStream_t s = (cudaStream_t)stream;
#define K4_ARGS blocks, s, alpha, rows, links, nodes, origins, dirs, \
    tmin_ray, tmin, tmax, n_rays, max_steps, t_out, tri_out, u_out, v_out, \
    steps_out, counters, trunc_out
  if (any_hit) {
    if (layout == 0) k4_launch<true, 0>(K4_ARGS);
    else if (layout == 1) k4_launch<true, 1>(K4_ARGS);
    else k4_launch<true, 2>(K4_ARGS);
  } else {
    if (layout == 0) k4_launch<false, 0>(K4_ARGS);
    else if (layout == 1) k4_launch<false, 1>(K4_ARGS);
    else k4_launch<false, 2>(K4_ARGS);
  }
#undef K4_ARGS
  return (int)cudaGetLastError();
}
