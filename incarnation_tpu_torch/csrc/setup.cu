// K9: triangle setup, the raster's geometry front end.
//
// It replaces no Pallas kernel: the JAX package writes this pass in jnp
// (incarnation_tpu/kernels/raster.py prepare_geometry :1207-1383). Its torch
// twin (kernels/raster.py prepare_geometry_plain) launches about 300
// elementwise kernels over every triangle of the scene, twice a frame (the
// camera pass and the sun's depth-only pass, kernels/shadow.py); here it is
// one kernel, the two 4x4 products per mesh instance included: K9 takes the
// (meshes, 4, 4) mesh transforms and the scene rotation and view-projection
// (4x4 each, on the card; the wrapper passes pointers, since passing them by
// value would copy them to the host, a synchronize per pass) and forms
// local_to_world = T @ R and local_to_clip = local_to_world @ VP itself, so
// a pass is one launch and no torch.matmul.
//
// The products: each thread forms its own mesh's 25 values (224 float
// operations, its mesh's transform read as four 16-byte rows, the two
// matrices as loads every lane of the warp shares). A block that formed
// each of its meshes' values once in shared memory, 16 threads a mesh, was
// slower on the depth-only pass (PERF.md): its reductions and barriers
// cost more than the products, and it spilled.
//
// One thread per triangle: the three corners' clip positions, world normals
// and tangents from tri_corner (36 rows of T floats, read coalesced) and its
// mesh's row; the 2D-homogeneous edge functions, det and the validity test
// (primitive or meshlet visibility, tri_visible, w > eps, |det| > 1e-12,
// front face, double-sided or crossing w = eps); the edge functions signed
// by det and the depth plane; the integer bbox of the polygon clipped at
// w = eps (in-front corners and the crossing edges' intersections); and,
// unless the role is depth-only, the 29 attribute planes. The setup rows
// (48 B) and attribute rows (116 B) of a block's triangles are staged in
// shared memory and written as contiguous runs, so each warp's stores cover
// whole sectors.
//
// Arithmetic: every operation is the twin's, in the twin's order, each
// multiply and add rounded on its own (--fmad=false, kernels/build.py), the
// sums left to right (the 4x4 products too: mathutils.rows_mat); a
// division by the Python number eps is, as torch does it on the card, a
// multiplication by its float reciprocal; 1 / |det| is an IEEE division
// (torch's reciprocal); minimum, maximum and clamp propagate a NaN as
// torch's do; the bbox is floor(clamp(x, -2e6, 2e6)) cast to int. So K9
// equals its twin bit for bit (chip_smoke.py holds every launch to that),
// and K1 downstream sees the same setup values.
//
// What bounds it: bytes. A triangle reads 144 B of corners (36 B of
// positions in the depth-only role) and 8-12 B of ids, and writes 48 B of
// setup, 16 of bbox, 4 of id, 1 of valid and, with attributes, 116 of
// planes: about 0.029 ms for the atrium's 289,068 triangles at 3.35 TB/s
// (0.010 ms depth-only), against 466 float operations (250 depth-only)
// and 224 a mesh for the products (chip_smoke.py counts both).

#include <cuda_runtime.h>
#include <stdint.h>

#define K9_THREADS 128
#define SETUP_ROWS 12
#define ATTR_ROWS 29
#define W_EPS 1e-3f
#define INV_W_EPS (1.0f / W_EPS)  // torch's x / eps on the card
#define BIG_F 2.0e6f

// torch.maximum / minimum / clamp propagate a NaN
__device__ __forceinline__ float tmax(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fmaxf(a, b);
}
__device__ __forceinline__ float tmin(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fminf(a, b);
}
__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}
// floor(clamp(x, -2e6, 2e6)).to(int32)
__device__ __forceinline__ int ifloor(float x) {
  return (int)floorf(tmin(tmax(x, -BIG_F), BIG_F));
}

// row i of local_to_world = T @ R (T one mesh's transform, R the scene
// rotation), each entry's sum left to right over k, every multiply and add
// rounded on its own (--fmad=false), as the twin's mathutils.rows_mat
__device__ __forceinline__ void world_row(const float4* __restrict__ xf,
                                          const float4* __restrict__ rot,
                                          int i, float* r) {
  const float4 a = __ldg(xf + i);
  const float4 b0 = __ldg(rot), b1 = __ldg(rot + 1), b2 = __ldg(rot + 2),
               b3 = __ldg(rot + 3);
  r[0] = a.x * b0.x + a.y * b1.x + a.z * b2.x + a.w * b3.x;
  r[1] = a.x * b0.y + a.y * b1.y + a.z * b2.y + a.w * b3.y;
  r[2] = a.x * b0.z + a.y * b1.z + a.z * b2.z + a.w * b3.z;
  r[3] = a.x * b0.w + a.y * b1.w + a.z * b2.w + a.w * b3.w;
}

// entry j of row r @ VP (a row of local_to_clip), left to right
__device__ __forceinline__ float clip_entry(const float* r,
                                            const float* __restrict__ vp,
                                            int j) {
  return r[0] * __ldg(vp + j) + r[1] * __ldg(vp + 4 + j) +
         r[2] * __ldg(vp + 8 + j) + r[3] * __ldg(vp + 12 + j);
}

// one mesh's row (raster._mesh_rows): local_to_clip (16), then the 3x3 of
// local_to_world (9)
__device__ __forceinline__ void mesh_row(const float4* __restrict__ xf,
                                         const float4* __restrict__ rot,
                                         const float* __restrict__ vp,
                                         float* m) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float r[4];
    world_row(xf, rot, i, r);
#pragma unroll
    for (int j = 0; j < 4; ++j) m[4 * i + j] = clip_entry(r, vp, j);
    if (i < 3) {
#pragma unroll
      for (int j = 0; j < 3; ++j) m[16 + 3 * i + j] = r[j];
    }
  }
}

struct Acc {  // the clipped polygon's running bbox
  float mnx, mxx, mny, mxy;
  __device__ __forceinline__ void add(float x, float y, bool ok) {
    if (!ok) return;
    mnx = tmin(mnx, x);
    mxx = tmax(mxx, x);
    mny = tmin(mny, y);
    mxy = tmax(mxy, y);
  }
};

// ATTR: the camera pass's role, with attribute planes; without, the
// depth-only role reads only the corners' positions
template <bool ATTR>
__global__ void __launch_bounds__(K9_THREADS)
k9_setup_kernel(const float* __restrict__ corner, int t_count,
                const int* __restrict__ tri_mesh,
                const float4* __restrict__ mesh_xf, int n_mesh,
                const float4* __restrict__ rot, const float* __restrict__ vp,
                const int* __restrict__ tri_prim,
                const uint8_t* __restrict__ prim_visible,
                const int* __restrict__ prim_double_sided,
                const int* __restrict__ prim_material, int n_prims,
                const int* __restrict__ tri_meshlet,
                const int* __restrict__ meshlet_prim,
                const uint8_t* __restrict__ meshlet_visible, int n_meshlets,
                const uint8_t* __restrict__ tri_visible, int all_double_sided,
                int width, int height, float* __restrict__ setup,
                int* __restrict__ ids, uint8_t* __restrict__ valid_out,
                int* __restrict__ bbox, float* __restrict__ attr) {
  __shared__ float stage[K9_THREADS * ATTR_ROWS];
  const int first = blockIdx.x * K9_THREADS;
  const int t = first + threadIdx.x;
  const int n_here = min(K9_THREADS, t_count - first);
  const bool live = t < t_count;
  float e[3][3], zp[3], a[3][9];
  float tri_mat = 0.0f;
  if (live) {
    // the mesh's local-to-clip (16) and local-to-world 3x3 (9), formed
    // here; the scene's tables are consistent, the clamp only keeps the
    // reads inside them
    const int mesh = clampi(__ldg(tri_mesh + t), 0, n_mesh - 1);
    float m[25];
    mesh_row(mesh_xf + 4 * mesh, rot, vp, m);
    float clip[3][4];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float* c = corner + (12 * k) * (size_t)t_count + t;
      const size_t s = (size_t)t_count;
      const float px = __ldg(c), py = __ldg(c + s), pz = __ldg(c + 2 * s);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        clip[k][j] = px * m[j] + py * m[4 + j] + pz * m[8 + j] + m[12 + j];
      if (!ATTR) continue;
      // attributes: u, v, world normal, world tangent, tangent sign
      a[k][0] = __ldg(c + 10 * s);
      a[k][1] = __ldg(c + 11 * s);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        a[k][2 + j] = __ldg(c + 3 * s) * m[16 + j] +
                      __ldg(c + 4 * s) * m[19 + j] +
                      __ldg(c + 5 * s) * m[22 + j];
        a[k][5 + j] = __ldg(c + 6 * s) * m[16 + j] +
                      __ldg(c + 7 * s) * m[19 + j] +
                      __ldg(c + 8 * s) * m[22 + j];
      }
      a[k][8] = __ldg(c + 9 * s);
    }
    // screen-space homogeneous corners (sx, sy, w)
    float p[3][3];
    const float wf = (float)width, hf = (float)height;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      p[k][0] = (0.5f * clip[k][0] + 0.5f * clip[k][3]) * wf;
      p[k][1] = (-0.5f * clip[k][1] + 0.5f * clip[k][3]) * hf;
      p[k][2] = clip[k][3];
    }
    // e_k = cross(p_{k+1}, p_{k+2})
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float* u = p[(k + 1) % 3];
      const float* v = p[(k + 2) % 3];
      e[k][0] = u[1] * v[2] - u[2] * v[1];
      e[k][1] = u[2] * v[0] - u[0] * v[2];
      e[k][2] = u[0] * v[1] - u[1] * v[0];
    }
    const float det = p[0][0] * e[0][0] + p[0][1] * e[0][1] +
                      p[0][2] * e[0][2];

    const int prim = __ldg(tri_prim + t);
    int ds, mat;
    bool vis;
    if (meshlet_visible) {
      const int ml = clampi(__ldg(tri_meshlet + t), 0, n_meshlets - 1);
      const int mp = clampi(__ldg(meshlet_prim + ml), 0, n_prims - 1);
      ds = __ldg(prim_double_sided + mp);
      vis = meshlet_visible[ml] && prim_visible[mp];
      mat = __ldg(prim_material + mp);
    } else {
      const int row = clampi(prim, 0, n_prims - 1);
      ds = __ldg(prim_double_sided + row);
      vis = prim_visible[row];
      mat = __ldg(prim_material + row);
    }
    const bool double_sided = ds > 0 || all_double_sided;
    tri_mat = (float)mat;
    const bool front = det < 0.0f;
    const float wmin = tmin(tmin(p[0][2], p[1][2]), p[2][2]);
    const float wmax = tmax(tmax(p[0][2], p[1][2]), p[2][2]);
    const bool crossing = wmin <= W_EPS && wmax > W_EPS;
    bool valid = prim >= 0 && vis;
    if (tri_visible) valid = valid && tri_visible[t];
    valid = valid && wmax > W_EPS && fabsf(det) > 1e-12f &&
            (front || double_sided || crossing);

    const float sgn = det >= 0.0f ? 1.0f : -1.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int j = 0; j < 3; ++j) e[k][j] = e[k][j] * sgn;
    const float adet = fabsf(det);
    const float rcp = 1.0f / adet;
    const float inv_det = adet > 1e-12f ? rcp : 0.0f;
    const float z0 = clip[0][2] * inv_det, z1 = clip[1][2] * inv_det,
                z2 = clip[2][2] * inv_det;
#pragma unroll
    for (int j = 0; j < 3; ++j)
      zp[j] = e[0][j] * z0 + e[1][j] * z1 + e[2][j] * z2;

    // the bbox of the polygon clipped at w = eps
    Acc b = {BIG_F, -BIG_F, BIG_F, -BIG_F};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float wv = p[k][2];
      const float wsafe = wv < W_EPS ? W_EPS : wv;
      b.add(p[k][0] / wsafe, p[k][1] / wsafe, wv > W_EPS);
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float* pi = p[k];
      const float* pj = p[(k + 1) % 3];
      const float wa = pi[2], wb = pj[2];
      const bool oke = (wa > W_EPS) != (wb > W_EPS);
      const float den = wa - wb;
      const float te = (wa - W_EPS) / (fabsf(den) > 1e-20f ? den : 1.0f);
      b.add((pi[0] + te * (pj[0] - pi[0])) * INV_W_EPS,
            (pi[1] + te * (pj[1] - pi[1])) * INV_W_EPS, oke);
    }
    const int mnx = ifloor(b.mnx), mxx = ifloor(b.mxx);
    const int mny = ifloor(b.mny), mxy = ifloor(b.mxy);
    valid = valid && mxx >= 0 && mnx <= width - 1 && mxy >= 0 &&
            mny <= height - 1;
    reinterpret_cast<int4*>(bbox)[t] =
        make_int4(clampi(mnx, 0, width - 1), clampi(mny, 0, height - 1),
                  clampi(mxx, 0, width - 1), clampi(mxy, 0, height - 1));
    valid_out[t] = valid;
    ids[t] = t;

    float* row = stage + threadIdx.x * SETUP_ROWS;
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int j = 0; j < 3; ++j) row[3 * k + j] = e[k][j];
#pragma unroll
    for (int j = 0; j < 3; ++j) row[9 + j] = zp[j];
  }
  __syncthreads();
  // the block's setup rows, one contiguous run
  for (int j = threadIdx.x; j < n_here * SETUP_ROWS; j += K9_THREADS)
    setup[(size_t)first * SETUP_ROWS + j] = stage[j];
  if (!ATTR) return;
  __syncthreads();
  if (live) {
    float* row = stage + threadIdx.x * ATTR_ROWS;
    int r = 0;
    // planes of u and v, the barycentric denominator, then normal and
    // tangent; the corner-0 tangent sign and the material id
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if (c == 2) {
#pragma unroll
        for (int j = 0; j < 3; ++j) row[r++] = e[0][j] + e[1][j] + e[2][j];
      }
#pragma unroll
      for (int j = 0; j < 3; ++j)
        row[r++] = a[0][c] * e[0][j] + a[1][c] * e[1][j] + a[2][c] * e[2][j];
    }
    row[r++] = a[0][8];
    row[r] = tri_mat;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < n_here * ATTR_ROWS; j += K9_THREADS)
    attr[(size_t)first * ATTR_ROWS + j] = stage[j];
}

// mesh_xf: the (n_mesh, 4, 4) mesh transforms; rot and vp: the scene
// rotation and the view-projection, 4x4 each, on the card; all three
// 16-byte aligned
extern "C" int k9_setup(const float* corner, int t_count, const int* tri_mesh,
                        const float* mesh_xf, int n_mesh, const float* rot,
                        const float* vp, const int* tri_prim,
                        const uint8_t* prim_visible,
                        const int* prim_double_sided, const int* prim_material,
                        int n_prims, const int* tri_meshlet,
                        const int* meshlet_prim,
                        const uint8_t* meshlet_visible, int n_meshlets,
                        const uint8_t* tri_visible, int all_double_sided,
                        int width, int height, float* setup, int* ids,
                        uint8_t* valid, int* bbox, float* attr,
                        void* stream) {
  if (t_count < 0 || n_mesh < 1 || n_prims < 1 || width < 1 || height < 1 ||
      (meshlet_visible && (n_meshlets < 1 || !tri_meshlet || !meshlet_prim)))
    return (int)cudaErrorInvalidValue;
  // bbox rows are stored, and the matrices' rows loaded, as 16-byte words
  if (((uintptr_t)bbox | (uintptr_t)mesh_xf | (uintptr_t)rot |
       (uintptr_t)vp) & 15u)
    return (int)cudaErrorInvalidValue;
  const float4* xf4 = reinterpret_cast<const float4*>(mesh_xf);
  const float4* rot4 = reinterpret_cast<const float4*>(rot);
  if (t_count == 0) return (int)cudaSuccess;
  const int blocks = (t_count + K9_THREADS - 1) / K9_THREADS;
  if (attr)
    k9_setup_kernel<true><<<blocks, K9_THREADS, 0, (cudaStream_t)stream>>>(
        corner, t_count, tri_mesh, xf4, n_mesh, rot4, vp, tri_prim,
        prim_visible, prim_double_sided, prim_material, n_prims, tri_meshlet,
        meshlet_prim, meshlet_visible, n_meshlets, tri_visible,
        all_double_sided, width, height, setup, ids, valid, bbox, attr);
  else
    k9_setup_kernel<false><<<blocks, K9_THREADS, 0, (cudaStream_t)stream>>>(
        corner, t_count, tri_mesh, xf4, n_mesh, rot4, vp, tri_prim,
        prim_visible, prim_double_sided, prim_material, n_prims, tri_meshlet,
        meshlet_prim, meshlet_visible, n_meshlets, tri_visible,
        all_double_sided, width, height, setup, ids, valid, bbox, nullptr);
  return (int)cudaGetLastError();
}
