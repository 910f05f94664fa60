"""Frustum culling: bounding sphere vs view frustum (port of
incarnation_tpu/kernels/cull.py). Works at primitive and at meshlet
granularity (pass the meshlet spheres and their mesh ids).

cull_primitives is K13 (csrc/cull.cu) on CUDA tensors, one launch a call;
on CPU tensors it runs its plain twin, cull_primitives_plain, the torch
code the kernel was written from.
"""

from __future__ import annotations

import ctypes

import torch

from .build import Kernel, ptr
from ..core import mathutils as mu

_P, _I = ctypes.c_void_p, ctypes.c_int
# spheres, mesh ids, mesh transforms, mesh visibility, scene rotation,
# view_proj, the sphere count, the mesh count, the mask and the count out
K13 = Kernel("cull", "k13_cull", [_P] * 6 + [_I, _I, _P, _P])


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


def cull_primitives(bsphere, mesh, mesh_transforms, mesh_visible,
                    scene_rotation, view_proj):
    """-> (visible (P,) bool, culled count () i64). Spheres are object
    space; the radius scales by the largest world-axis scale. CUDA tensors
    launch K13 (csrc/cull.cu) once; CPU tensors take the twin,
    cull_primitives_plain. A mesh id outside [-M, M) is the caller's
    error: the twin raises, K13 clamps it into the table."""
    if not bsphere.is_cuda:
        return cull_primitives_plain(bsphere, mesh, mesh_transforms,
                                     mesh_visible, scene_rotation, view_proj)
    dev = bsphere.device
    p = bsphere.shape[0]
    m = mesh_transforms.shape[0]
    for name, t, shape, dt in (
            ("bsphere", bsphere, (p, 4), torch.float32),
            ("mesh", mesh, (p,), torch.int32),
            ("mesh_transforms", mesh_transforms, (m, 4, 4), torch.float32),
            ("mesh_visible", mesh_visible, (m,), torch.int32),
            ("scene_rotation", scene_rotation, (4, 4), torch.float32),
            ("view_proj", view_proj, (4, 4), torch.float32)):
        if t.dtype != dt or t.device != dev or not t.is_contiguous() \
                or tuple(t.shape) != shape:
            raise ValueError(f"{name}: need a contiguous {dt} tensor "
                             f"{shape} on {dev}")
    if p and not m:
        raise ValueError("mesh_transforms: no mesh for the spheres")
    if bsphere.data_ptr() % 16:
        raise ValueError("bsphere: K13 reads its rows as float4, 16-byte "
                         "aligned")
    inside = torch.empty(p, dtype=torch.bool, device=dev)
    culled = torch.empty((), dtype=torch.int64, device=dev)
    K13(ptr(bsphere), ptr(mesh), ptr(mesh_transforms), ptr(mesh_visible),
        ptr(scene_rotation), ptr(view_proj), p, m, ptr(inside), ptr(culled))
    return inside, culled


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
