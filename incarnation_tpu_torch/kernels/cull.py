"""Frustum culling: bounding sphere vs view frustum (port of
incarnation_tpu/kernels/cull.py). Works at primitive and at meshlet
granularity (pass the meshlet spheres and their mesh ids).

cull_lists culls a frame's lists of spheres (its primitives and its
meshlets) in one launch of K13 (csrc/cull.cu) on CUDA tensors, and
cull_primitives one list by the same kernel; on CPU tensors they run the
plain twin, cull_primitives_plain (once a list), the torch code the
kernel was written from.
"""

from __future__ import annotations

import ctypes

import torch

from .build import Kernel, zero_scratch
from ..core import mathutils as mu

_P, _I = ctypes.c_void_p, ctypes.c_int
K13_MAX_LISTS = 2              # csrc/cull.cu
# the list count, each list's spheres, mesh ids and length (K13_MAX_LISTS
# of them), the masks out (one buffer, list after list), the mesh
# transforms, mesh visibility, scene rotation, view_proj, the mesh count,
# the counts out (int64 a list) and the ticket's scratch
K13 = Kernel("cull", "k13_cull",
             [_I] + [_P, _P, _I] * K13_MAX_LISTS + [_P] * 5 + [_I, _P, _P])
# K13's ticket and a culled sum a list, int32 words it leaves zero
_K13_SCRATCH: dict = {}
_NO_LIST = (0, 0, 0)


def _check(name, t, dtype, shape, dev):
    if t.dtype != dtype or t.shape != shape or t.device != dev \
            or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous {dtype} tensor "
                         f"{shape} on {dev}")


def frustum_planes(view_proj):
    """Six Gribb-Hartmann planes from a row-vector view-proj matrix:
    (6, 4), dot([p, 1], plane) >= 0 inside."""
    m = view_proj
    return torch.stack([
        m[:, 3] + m[:, 0],   # left
        m[:, 3] - m[:, 0],   # right
        m[:, 3] + m[:, 1],   # bottom
        m[:, 3] - m[:, 1],   # top
        m[:, 2],             # near
        m[:, 3] - m[:, 2],   # far
    ])


def cull_lists(lists, mesh_transforms, mesh_visible, scene_rotation,
               view_proj):
    """lists: [(bsphere (P, 4), mesh (P,))], at most K13_MAX_LISTS ->
    [(visible (P,) bool, culled count () i64)] a list, each as
    cull_primitives gives it. CUDA tensors launch K13 once for all the
    lists, with no copy and no synchronize; CPU tensors take the twin,
    cull_primitives_plain a list."""
    if not mesh_transforms.is_cuda:
        return cull_lists_plain(lists, mesh_transforms, mesh_visible,
                                scene_rotation, view_proj)
    n = len(lists)
    if not 1 <= n <= K13_MAX_LISTS:
        raise ValueError(f"cull_lists: need 1 to {K13_MAX_LISTS} lists")
    dev = mesh_transforms.device
    m = mesh_transforms.shape[0]
    _check("mesh_transforms", mesh_transforms, torch.float32, (m, 4, 4), dev)
    _check("mesh_visible", mesh_visible, torch.int32, (m,), dev)
    _check("scene_rotation", scene_rotation, torch.float32, (4, 4), dev)
    _check("view_proj", view_proj, torch.float32, (4, 4), dev)
    args = []
    for bsphere, mesh in lists:
        p = bsphere.shape[0]
        _check("bsphere", bsphere, torch.float32, (p, 4), dev)
        _check("mesh", mesh, torch.int32, (p,), dev)
        if p and not m:
            raise ValueError("mesh_transforms: no mesh for the spheres")
        at = bsphere.data_ptr()
        if at % 16:
            raise ValueError("bsphere: K13 reads its rows as float4, "
                             "16-byte aligned")
        args += (at, mesh.data_ptr(), p)
    p0 = args[2]
    inside = torch.empty(p0 if n == 1 else p0 + args[5], dtype=torch.bool,
                         device=dev)
    culled = torch.empty(n, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    K13(n, *args, *_NO_LIST * (K13_MAX_LISTS - n), inside.data_ptr(),
        mesh_transforms.data_ptr(), mesh_visible.data_ptr(),
        scene_rotation.data_ptr(), view_proj.data_ptr(), m,
        culled.data_ptr(),
        zero_scratch(_K13_SCRATCH, dev, 1 + K13_MAX_LISTS, torch.int32,
                     stream).data_ptr(), stream=stream)
    if n == 1:
        return [(inside, culled[0])]
    c0, c1 = culled.unbind()
    return [(inside[:p0], c0), (inside[p0:], c1)]


def cull_lists_plain(lists, mesh_transforms, mesh_visible, scene_rotation,
                     view_proj):
    """K13's twin for a frame's lists: cull_primitives_plain a list."""
    return [cull_primitives_plain(b, mh, mesh_transforms, mesh_visible,
                                  scene_rotation, view_proj)
            for b, mh in lists]


def cull_primitives(bsphere, mesh, mesh_transforms, mesh_visible,
                    scene_rotation, view_proj):
    """-> (visible (P,) bool, culled count () i64). Spheres are object
    space; the radius scales by the largest world-axis scale. CUDA tensors
    launch K13 (csrc/cull.cu) once, a list of one (cull_lists); CPU
    tensors take the twin, cull_primitives_plain. A mesh id outside
    [-M, M) is the caller's error: the twin raises, K13 clamps it into
    the table."""
    return cull_lists([(bsphere, mesh)], mesh_transforms, mesh_visible,
                      scene_rotation, view_proj)[0]


def cull_primitives_plain(bsphere, mesh, mesh_transforms, mesh_visible,
                          scene_rotation, view_proj):
    """K13's plain twin in torch, every sum in K13's fixed order: each
    product of a row and a matrix left to right (mathutils.rows_mat),
    each norm the square root of a dot3 sum, the plane division a true
    division -> (visible (P,) bool, culled count () i64)."""
    world = mu.rows_mat(mesh_transforms, scene_rotation)   # (M, 4, 4)
    xf = world[mesh.long()]                                  # (P, 4, 4)
    c = bsphere[:, :3]
    # [c, 1] by each row's own matrix, k = 0..3 left to right
    center = (c[:, 0:1] * xf[:, 0, :3] + c[:, 1:2] * xf[:, 1, :3]
              + c[:, 2:3] * xf[:, 2, :3]) + 1.0 * xf[:, 3, :3]
    rows = xf[:, :3, :3]
    scale = torch.amax(torch.sqrt(mu.dot3(rows, rows)), dim=-1)
    radius = bsphere[:, 3] * scale
    planes = frustum_planes(view_proj)
    norm = torch.sqrt(mu.dot3(planes[:, :3], planes[:, :3]))
    planes = planes / torch.clamp(norm, min=1e-12)[:, None]
    d = mu.rows_mat(center, planes[:, :3].T) + planes[:, 3]  # (P, 6)
    inside = torch.all(d > -radius[:, None], dim=-1)
    inside &= mesh_visible[mesh.long()] > 0
    return inside, torch.sum(~inside)
