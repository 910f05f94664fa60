// K13: the frustum cull, one launch a list of bounding spheres.
//
// It replaces no Pallas kernel: the JAX package writes this pass in jnp
// (incarnation_tpu/kernels/cull.py cull_primitives :34-56 with
// frustum_planes :17-32; its frame calls it for the primitives and the
// meshlets, renderer/frame.py:142, :152). The torch twin
// (kernels/cull.py cull_primitives_plain) runs about 20 eager operators a
// call over a few thousand rows; here a call is one launch, which reads
// the mesh table, the scene rotation and the view-projection as device
// pointers (no copy to the host, no synchronize).
//
// One block of K13_THREADS threads, so that the culled count is a block
// sum and needs no ticket across blocks. Threads 0-5 form the six
// Gribb-Hartmann planes of view_proj (left, right, bottom, top, near,
// far), divided by their normals' length, in shared memory. Then thread t
// takes spheres t, t + K13_THREADS, ...: its mesh (a negative id wraps by
// M, as torch and JAX index; an id still outside the table is clamped into
// it, as JAX's gather does), the part of the mesh's world matrix
// (mesh_transforms x scene_rotation) that the test reads, rows 0-3 of
// columns 0-2, the world centre, the radius times the largest norm of the
// matrix's 3 x 3 rows, the six plane distances and the mesh's visibility;
// it writes the mask byte and counts what it culled. The block sums the
// counts (a warp sum, then shared memory) and thread 0 writes the int64:
// 0 for the empty list.
//
// Arithmetic: the twin's, operation by operation (--fmad=false): each
// product of a row and a matrix summed left to right
// (mathutils.rows_mat), each norm sqrtf of a dot3 sum (x + y) + z, the
// plane division a true IEEE division, the 1e-12 floor and the largest
// norm as torch's clamp and amax (a NaN passes through both). So the mask
// and the count equal the twin's bit for bit.
//
// What bounds it: not bytes (21 B a sphere, 68 a mesh, the two matrices:
// 72 KB for the atrium frame's 3,434 meshlets, 0.02 us at 3.35 TB/s) nor
// operations (79 a sphere): a launch and the latency of each round's
// dependent loads (the mesh id, then its matrix and visibility).
// The world matrix is formed in every thread for its sphere, from the
// mesh's rows and the rotation (both stay in L1), as K9 forms its two
// products: no second pass over the meshes and no shared table, so any M
// fits.

#include <cuda_runtime.h>

#define K13_THREADS 1024

__device__ __forceinline__ float k13_amax(float a, float b) {
  // torch.amax: the larger, or a NaN where either is one
  return (isnan(b) || b > a) && !isnan(a) ? b : a;
}

__global__ void __launch_bounds__(K13_THREADS)
k13_cull_kernel(const float4* __restrict__ sphere,   // (P,) x, y, z, r
                const int* __restrict__ mesh,        // (P,)
                const float* __restrict__ xform,     // (M, 4, 4)
                const int* __restrict__ visible,     // (M,)
                const float* __restrict__ rot,       // (4, 4)
                const float* __restrict__ vp,        // (4, 4)
                int num_spheres, int num_meshes,
                unsigned char* __restrict__ inside,  // (P,)
                long long* __restrict__ culled) {    // ()
  __shared__ float s_plane[6][4];
  __shared__ int s_culled;
  const int t = threadIdx.x;
  if (t == 0) s_culled = 0;
  if (t < 6) {
    // planes (frustum_planes): column 3 plus or minus column 0 or 1,
    // column 2, column 3 minus column 2, each of the 4 components k
    float q[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float c0 = __ldg(vp + 4 * k), c1 = __ldg(vp + 4 * k + 1),
                  c2 = __ldg(vp + 4 * k + 2), c3 = __ldg(vp + 4 * k + 3);
      q[k] = t == 0 ? c3 + c0 : t == 1 ? c3 - c0 : t == 2 ? c3 + c1
           : t == 3 ? c3 - c1 : t == 4 ? c2 : c3 - c2;
    }
    const float norm = sqrtf((q[0] * q[0] + q[1] * q[1]) + q[2] * q[2]);
    const float den = norm < 1e-12f ? 1e-12f : norm;   // NaN stays NaN
#pragma unroll
    for (int k = 0; k < 4; ++k) s_plane[t][k] = q[k] / den;
  }
  __syncthreads();
  float r[4][3];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int j = 0; j < 3; ++j) r[k][j] = __ldg(rot + 4 * k + j);
  int mine = 0;
#pragma unroll 4
  for (int i = t; i < num_spheres; i += K13_THREADS) {
    int m = __ldg(mesh + i);
    if (m < 0) m += num_meshes;
    m = min(max(m, 0), num_meshes - 1);
    const float* x = xform + 16 * m;
    // world rows 0-3, columns 0-2: sum over k of xform[m][i][k] rot[k][j]
    float w[4][3];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float x0 = __ldg(x + 4 * a), x1 = __ldg(x + 4 * a + 1),
                  x2 = __ldg(x + 4 * a + 2), x3 = __ldg(x + 4 * a + 3);
#pragma unroll
      for (int j = 0; j < 3; ++j)
        w[a][j] = ((x0 * r[0][j] + x1 * r[1][j]) + x2 * r[2][j]) +
                  x3 * r[3][j];
    }
    const float4 s = __ldg(sphere + i);
    float c[3];
#pragma unroll
    for (int j = 0; j < 3; ++j)
      c[j] = ((s.x * w[0][j] + s.y * w[1][j]) + s.z * w[2][j]) +
             1.0f * w[3][j];
    float scale = 0.0f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float n = sqrtf((w[a][0] * w[a][0] + w[a][1] * w[a][1]) +
                            w[a][2] * w[a][2]);
      scale = a == 0 ? n : k13_amax(scale, n);
    }
    const float neg_radius = -(s.w * scale);
    bool in = __ldg(visible + m) > 0;
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      const float d = ((c[0] * s_plane[q][0] + c[1] * s_plane[q][1]) +
                       c[2] * s_plane[q][2]) + s_plane[q][3];
      in = in && d > neg_radius;
    }
    inside[i] = in;
    mine += !in;
  }
  const int warp_sum = __reduce_add_sync(0xffffffffu, mine);
  if ((t & 31) == 0) atomicAdd(&s_culled, warp_sum);
  __syncthreads();
  if (t == 0) *culled = (long long)s_culled;
}

extern "C" int k13_cull(const float* sphere, const int* mesh,
                        const float* xform, const int* visible,
                        const float* rot, const float* vp, int num_spheres,
                        int num_meshes, unsigned char* inside,
                        long long* culled, void* stream) {
  if (num_spheres < 0 || num_meshes < 0 ||
      (num_spheres > 0 && num_meshes < 1) || !rot || !vp || !culled)
    return (int)cudaErrorInvalidValue;
  k13_cull_kernel<<<1, K13_THREADS, 0, (cudaStream_t)stream>>>(
      (const float4*)sphere, mesh, xform, visible, rot, vp, num_spheres,
      num_meshes, inside, culled);
  return (int)cudaGetLastError();
}
