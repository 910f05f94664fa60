// K13: the frustum cull of a frame's lists of bounding spheres (its
// primitives and its meshlets), all of them in one launch.
//
// It replaces no Pallas kernel: the JAX package writes this pass in jnp
// (incarnation_tpu/kernels/cull.py cull_primitives :34-56 with
// frustum_planes :17-32; its frame calls it for the primitives and the
// meshlets, renderer/frame.py:142, :152). The torch twin
// (kernels/cull.py cull_primitives_plain, once a list) runs about 20 eager
// operators a list over a few thousand rows; here the frame's lists are
// one launch, which reads the mesh table, the scene rotation and the
// view-projection as device pointers (no copy to the host, no
// synchronize).
//
// Each list of P spheres takes ceil(P / K13_THREADS) blocks of one grid,
// a sphere a thread, so the atrium's 3,434 meshlets and 64 primitives
// spread over 28 blocks of as many SMs (one block a list would take four
// rounds of dependent loads a thread, and a launch a list). A thread loads its sphere and its
// mesh id first; meanwhile lanes 0-5 of each warp form the six
// Gribb-Hartmann planes of view_proj (left, right, bottom, top, near,
// far), divided by their normals' length, and shuffle them to the warp's
// other lanes: no block barrier stands before the sphere's loads. Then
// the thread takes its mesh (a negative id wraps by M, as torch and JAX
// index; an id still outside the table is clamped into it, as JAX's
// gather does), the part of the mesh's world matrix (mesh_transforms x
// scene_rotation) that the test reads, rows 0-3 of columns 0-2, the world
// centre, the radius times the largest norm of the matrix's 3 x 3 rows,
// the six plane distances and the mesh's visibility; it writes the mask
// byte and counts what it culled.
//
// Each list's culled count is summed across its blocks with no memset and
// no host sync by a ticket, as K11's: a block adds its count into its
// list's word of a per-(device, stream) scratch, then takes a ticket, and
// the last block writes every list's int64 count and leaves the scratch
// zero. The empty list writes 0. (A thread-block cluster a list, its
// blocks summing in distributed shared memory, measured slower: PERF.md.)
//
// The lists' masks are one buffer, list 1's after list 0's, and the entry
// takes each list's pointers and length as plain arguments: the wrapper
// builds no host array and splits no tensor before the launch.
//
// Arithmetic: the twin's, operation by operation (--fmad=false): each
// product of a row and a matrix summed left to right
// (mathutils.rows_mat), each norm sqrtf of a dot3 sum (x + y) + z, the
// plane division a true IEEE division, the 1e-12 floor and the largest
// norm as torch's clamp and amax (a NaN passes through both). So the masks
// and the counts equal the twin's bit for bit.
//
// What bounds it: not bytes (21 B a sphere, 68 a mesh, the two matrices:
// 73 KB for the atrium frame's 3,498 spheres, 0.02 us at 3.35 TB/s) nor
// operations (79 a sphere): a launch and the latency of its dependent
// loads (the mesh id, then its matrix and visibility) and of the count's
// sum across blocks. The world matrix is formed in every thread for its
// sphere, from the mesh's rows and the rotation (both stay in L1), as K9
// forms its two products: no second pass over the meshes and no shared
// table, so any M fits.

#include <cuda_runtime.h>

#define K13_THREADS 128
#define K13_MAX_LISTS 2
#define K13_FULL 0xffffffffu

// one list: its spheres (x, y, z, r), mesh ids and mask out, its length,
// and its first block
struct K13List {
  const float4* sphere;
  const int* mesh;
  unsigned char* inside;
  int count, first_block;
};

struct K13Lists {
  K13List l[K13_MAX_LISTS];
  int n;
};

__device__ __forceinline__ float k13_amax(float a, float b) {
  // torch.amax: the larger, or a NaN where either is one
  return (isnan(b) || b > a) && !isnan(a) ? b : a;
}

// the six planes of vp, normalized, in every lane of the warp: lane p < 6
// forms plane p (frustum_planes: column 3 plus or minus column 0 or 1,
// column 2, column 3 minus column 2, each of the 4 components k) and the
// warp's lanes read them by shuffles
__device__ __forceinline__ void k13_planes(const float* __restrict__ vp,
                                           float pl[6][4]) {
  const int lane = threadIdx.x & 31;
  float q[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (lane < 6) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float c0 = __ldg(vp + 4 * k), c1 = __ldg(vp + 4 * k + 1),
                  c2 = __ldg(vp + 4 * k + 2), c3 = __ldg(vp + 4 * k + 3);
      q[k] = lane == 0 ? c3 + c0 : lane == 1 ? c3 - c0 : lane == 2 ? c3 + c1
           : lane == 3 ? c3 - c1 : lane == 4 ? c2 : c3 - c2;
    }
    const float norm = sqrtf((q[0] * q[0] + q[1] * q[1]) + q[2] * q[2]);
    const float den = norm < 1e-12f ? 1e-12f : norm;   // NaN stays NaN
#pragma unroll
    for (int k = 0; k < 4; ++k) q[k] = q[k] / den;
  }
#pragma unroll
  for (int p = 0; p < 6; ++p)
#pragma unroll
    for (int k = 0; k < 4; ++k) pl[p][k] = __shfl_sync(K13_FULL, q[k], p);
}

// whether sphere s of mesh id m (as loaded) is inside the planes and its
// mesh visible
__device__ __forceinline__ bool k13_inside(
    float4 s, int m, const float* __restrict__ xform,
    const int* __restrict__ visible, const float r[4][3], int num_meshes,
    const float pl[6][4]) {
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
    const float d = ((c[0] * pl[q][0] + c[1] * pl[q][1]) + c[2] * pl[q][2]) +
                    pl[q][3];
    in = in && d > neg_radius;
  }
  return in;
}

__device__ __forceinline__ void k13_rotation(const float* __restrict__ rot,
                                             float r[4][3]) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int j = 0; j < 3; ++j) r[k][j] = __ldg(rot + 4 * k + j);
}

// A sphere a thread over every list's blocks; state holds the blocks'
// ticket, then a culled sum a list (zero between launches)
__global__ void __launch_bounds__(K13_THREADS)
k13_cull_kernel(K13Lists lists, const float* __restrict__ xform,
                const int* __restrict__ visible,
                const float* __restrict__ rot,
                const float* __restrict__ vp, int num_meshes,
                long long* __restrict__ culled,
                unsigned int* __restrict__ state) {
  __shared__ int s_warp[K13_THREADS / 32];
  __shared__ bool last;
  const int t = threadIdx.x;
  int li = 0;
#pragma unroll
  for (int k = 1; k < K13_MAX_LISTS; ++k)
    if (k < lists.n && (int)blockIdx.x >= lists.l[k].first_block) li = k;
  const K13List& l = lists.l[li];
  const int i = ((int)blockIdx.x - l.first_block) * K13_THREADS + t;
  const bool live = i < l.count;
  int m = 0;
  float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (live) {
    m = __ldg(l.mesh + i);
    s = __ldg(l.sphere + i);
  }
  float pl[6][4], r[4][3];
  k13_planes(vp, pl);
  k13_rotation(rot, r);
  int out = 0;
  if (live) {
    const bool in = k13_inside(s, m, xform, visible, r, num_meshes, pl);
    l.inside[i] = in;
    out = !in;
  }
  out = __reduce_add_sync(K13_FULL, out);
  if ((t & 31) == 0) s_warp[t >> 5] = out;
  __syncthreads();
  if (t == 0) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < K13_THREADS / 32; ++w) sum += s_warp[w];
    if (sum) atomicAdd(&state[1 + li], (unsigned int)sum);
    __threadfence();
    last = atomicAdd(&state[0], 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last || t >= lists.n) return;
  // the last block: each list's count, and the state zero again
  __threadfence();
  culled[t] = (long long)atomicExch(&state[1 + t], 0u);
  if (t == 0) atomicExch(&state[0], 0u);
}

// n_lists lists (1 or K13_MAX_LISTS = 2): list k's spheres, mesh ids and
// length (sphere1, mesh1, count1 unread for one list), the masks of both
// (list 1's at inside + count0), the mesh transforms, visibility, scene
// rotation and view_proj, the mesh count, culled (n_lists int64 counts)
// and the ticket's scratch (1 + K13_MAX_LISTS words, zero)
extern "C" int k13_cull(int n_lists, const float* sphere0, const int* mesh0,
                        int count0, const float* sphere1, const int* mesh1,
                        int count1, unsigned char* inside,
                        const float* xform, const int* visible,
                        const float* rot, const float* vp, int num_meshes,
                        long long* culled, unsigned int* state,
                        void* stream) {
  if (n_lists < 1 || n_lists > K13_MAX_LISTS || num_meshes < 0 || !rot ||
      !vp || !culled || !state)
    return (int)cudaErrorInvalidValue;
  if (n_lists < 2) count1 = 0;
  if (count0 < 0 || count1 < 0 ||
      (count0 + count1 > 0 && num_meshes < 1))
    return (int)cudaErrorInvalidValue;
  const int blocks0 = (count0 + K13_THREADS - 1) / K13_THREADS;
  const int blocks1 = (count1 + K13_THREADS - 1) / K13_THREADS;
  K13Lists lists;
  lists.n = n_lists;
  lists.l[0] = K13List{(const float4*)sphere0, mesh0, inside, count0, 0};
  lists.l[1] = n_lists > 1
      ? K13List{(const float4*)sphere1, mesh1, inside + count0, count1,
                blocks0}
      : K13List{nullptr, nullptr, nullptr, 0, 1 << 30};
  const int blocks = blocks0 + blocks1;
  k13_cull_kernel<<<blocks > 0 ? blocks : 1, K13_THREADS, 0,
                    (cudaStream_t)stream>>>(lists, xform, visible, rot, vp,
                                            num_meshes, culled, state);
  return (int)cudaGetLastError();
}
