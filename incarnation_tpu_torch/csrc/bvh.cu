// K4: BVH traversal, closest-hit and any-hit.
//
// Replaces the traced wavefront loop of incarnation_tpu/kernels/bvh.py
// trace / occluded (bvh.py:1108, :1241): a jnp step (_step_wide,
// bvh.py:914-987) inside lax.fori_loop / while_loop, wrapped in compaction
// ladders that exist for the TPU's lock-step wavefront (_compact :990,
// _SCHEDULES_WIDE :1058). It is not a Pallas kernel there; on the GPU it has
// to be one, because torch has no device-side loop (a torch step is some
// fifty launches, and the walk hundreds of steps).
//
// Design for Hopper: one thread per ray walks the 8-wide threaded rows
// stacklessly, exactly as _step_wide does: a leaf row tests its 4 inline
// triangles in slot order (strict t < t_best, t <= tmax), then follows its
// miss link; an internal row slab-tests its 8 child boxes in storage order
// and takes the hit child with the smallest position in the ray's octant
// order (3-bit fields of the row's iperm word), else the miss link. The
// 320-byte row is read with 16-byte loads (the leaf's 48 geometry lanes or
// the internal row's 48 box lanes and 8 child ids) plus the octant's
// (iperm, miss) pair. Any-hit stops at the first accepted slot. A ray that
// has visited max_steps rows stops with its best hit and counts in
// `trunc`. Built --fmad=false, with the reference's arithmetic term by
// term (the inv_d guard, o + d tmin, tmax - tmin, Moller-Trumbore with
// jnp.cross's products and the dot products as the multiply-adds XLA's CPU
// build fuses, each emulated through f64 and rounded twice), so it agrees
// bit for bit with its twin (kernels/bvh.py trace_plain) and to rounding
// with the JAX trace.
//
// What bounds it: the rows a walk touches. The atrium's table is about
// 26 MB and stays in the 50 MB L2; each step is a chain of dependent
// loads, so latency (and warp divergence between rays) rules, not bytes.
// Warp-coherent traversal, short stacks in shared memory and treelet
// prefetch are for a later change.
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

template <bool ANY_HIT>
__global__ void __launch_bounds__(K4_THREADS)
k4_trace_kernel(const float* __restrict__ rows,      // (N, 80)
                const float* __restrict__ origins,   // (R, 3)
                const float* __restrict__ dirs,      // (R, 3)
                const float* __restrict__ tmin_ray,  // (R,) or NULL
                float tmin, float tmax, int n_rays, int max_steps,
                float* __restrict__ t_out, int* __restrict__ tri_out,
                float* __restrict__ u_out, float* __restrict__ v_out,
                int* __restrict__ steps_out,         // (R,) or NULL
                int* __restrict__ counters,          // [trunc, arrivals]
                int* __restrict__ trunc_out) {
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

    float t_best = CUDART_INF_F, bu = 0.0f, bv = 0.0f;
    int best_tri = -1;
    int cur = 0;
    int steps = 0;
    bool done = false;
    while (steps < max_steps) {
      const float* row = rows + (size_t)cur * K4_LANES;
      const float4* r4 = reinterpret_cast<const float4*>(row);
      const float4 w12 = __ldg(r4 + 12);     // flag, -, child 0, child 1
      const float2 th = __ldg(
          reinterpret_cast<const float2*>(row + K4_THREAD + 2 * okt));
      const int miss = (int)th.y;
      ++steps;
      int nxt = miss;
      float L[48];
      k4_load48(r4, L);
      if (w12.x > 0.5f) {
        // leaf: slots a, b, c, d (geometry, id lane, double-sided lane)
        const int o9s[4] = {0, 15, 24, 33};
        const int oid[4] = {10, 42, 43, 44};
        const int ods[4] = {11, 45, 46, 47};
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          float u, v;
          const float t_hit = k4_triangle(L, o9s[s], ox, oy, oz, dx, dy, dz,
                                          L[ods[s]] < 0.5f, u, v);
          const int tri = (int)L[oid[s]];
          if (tri >= 0 && t_hit < t_best && t_hit <= tmax_eff) {
            t_best = t_hit;
            best_tri = tri;
            bu = u;
            bv = v;
            if (ANY_HIT) {
              done = true;
              break;
            }
          }
        }
        if (done) break;
      } else {
        // internal: 8 child slabs in storage order, the hit child with the
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
          float tn = 0.0f, tf = limit;
          {
            const float t0 = (L[6 * k + 0] - ox) * ix;
            const float t1 = (L[6 * k + 3] - ox) * ix;
            tn = fmaxf(tn, fminf(t0, t1));
            tf = fminf(tf, fmaxf(t0, t1));
          }
          {
            const float t0 = (L[6 * k + 1] - oy) * iy;
            const float t1 = (L[6 * k + 4] - oy) * iy;
            tn = fmaxf(tn, fminf(t0, t1));
            tf = fminf(tf, fmaxf(t0, t1));
          }
          {
            const float t0 = (L[6 * k + 2] - oz) * iz;
            const float t1 = (L[6 * k + 5] - oz) * iz;
            tn = fmaxf(tn, fminf(t0, t1));
            tf = fminf(tf, fmaxf(t0, t1));
          }
          const int cid = (int)cid_f[k];
          const int pos = (iperm >> (3 * k)) & 7;
          if (tn <= tf && cid >= 0 && pos < best_pos) {
            best_pos = pos;
            nxt = cid;
          }
        }
      }
      if (nxt < 0) {
        done = true;
        break;
      }
      cur = nxt;
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

extern "C" int k4_trace(const float* rows, const float* origins,
                        const float* dirs, const float* tmin_ray, float tmin,
                        float tmax, int any_hit, int n_rays, int max_steps,
                        float* t_out, int* tri_out, float* u_out,
                        float* v_out, int* steps_out, int* counters,
                        int* trunc_out, void* stream) {
  if (n_rays <= 0 || max_steps <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (n_rays + K4_THREADS - 1) / K4_THREADS;
  cudaStream_t s = (cudaStream_t)stream;
  if (any_hit) {
    k4_trace_kernel<true><<<blocks, K4_THREADS, 0, s>>>(
        rows, origins, dirs, tmin_ray, tmin, tmax, n_rays, max_steps, t_out,
        tri_out, u_out, v_out, steps_out, counters, trunc_out);
  } else {
    k4_trace_kernel<false><<<blocks, K4_THREADS, 0, s>>>(
        rows, origins, dirs, tmin_ray, tmin, tmax, n_rays, max_steps, t_out,
        tri_out, u_out, v_out, steps_out, counters, trunc_out);
  }
  return (int)cudaGetLastError();
}
