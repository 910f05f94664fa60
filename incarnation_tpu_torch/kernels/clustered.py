"""Clustered punctual lighting (port of incarnation_tpu/kernels/clustered.py).

A gx x gy x gz cluster grid with exponential view-space z slices; each
cluster keeps a light BITMASK ((C, W32) int32 words) from one dense
(clusters x lights) sphere-vs-frustum test: K11 (csrc/clustered.cu) on
CUDA tensors, its twin build_light_clusters_plain on CPU ones. Shading: K2
(csrc/clustered.cu) on CUDA tensors, the dense all-lights twin
clustered_lighting_dense on CPU ones.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from . import shading
from .build import Kernel, ptr, zero_scratch
from ..core import mathutils as mu
from ..scene import lights as lights_mod

MAX_LIGHT_RANGE = 4.0  # ref: cluster-culling.hlsli:4


def cluster_grid_shape(config):
    return (config.light_cluster_dim_x, config.light_cluster_dim_y,
            config.light_cluster_dim_z)


def _cluster_corners(config, proj, inv_view_proj, near: float):
    """World-space corner points for every cluster: (Z, Y, X, 8, 3). The
    two products with proj and inv_view_proj are mathutils.rows_mat's
    sums (K11's order; a matmul's is its library's own)."""
    gx, gy, gz = cluster_grid_shape(config)
    far = config.cluster_depth_extent
    dev = proj.device
    ix = torch.arange(gx, dtype=torch.float32, device=dev)
    iy = torch.arange(gy, dtype=torch.float32, device=dev)
    iz = torch.arange(gz, dtype=torch.float32, device=dev)
    ndc_x0 = 2.0 * ix / gx - 1.0
    ndc_y0 = -(2.0 * iy / gy - 1.0)
    sx = 2.0 / gx
    sy = 2.0 / gy
    z0_view = near * (far / near) ** (iz / gz)
    z1_view = near * (far / near) ** ((iz + 1.0) / gz)

    def ndc_z(zv):
        p = mu.rows_mat(torch.stack([torch.zeros_like(zv),
                                     torch.zeros_like(zv), zv,
                                     torch.ones_like(zv)], -1), proj)
        return p[..., 2] / p[..., 3]

    nz0 = ndc_z(z0_view)
    nz1 = ndc_z(z1_view)
    x0 = ndc_x0[None, None, :]
    y0 = ndc_y0[None, :, None]
    z_near = nz0[:, None, None]
    z_far = nz1[:, None, None]
    zero = torch.zeros((gz, gy, gx), dtype=torch.float32, device=dev)

    def corner(x, y, z):
        return torch.stack([x + zero, y + zero, z + zero,
                            torch.ones_like(zero)], -1)

    corners_ndc = torch.stack([
        corner(x0, y0 - sy, z_near),
        corner(x0 + sx, y0 - sy, z_near),
        corner(x0 + sx, y0, z_near),
        corner(x0, y0, z_near),
        corner(x0, y0 - sy, z_far),
        corner(x0 + sx, y0 - sy, z_far),
        corner(x0 + sx, y0, z_far),
        corner(x0, y0, z_far),
    ], dim=-2)                                # (gz, gy, gx, 8, 4)
    w = mu.rows_mat(corners_ndc, inv_view_proj)
    return w[..., :3] / w[..., 3:]


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# proj, inv_view_proj, light transforms, ranges, types, lights, count, W32,
# gx, gy, gz, near, far / near, 2 / gx, 2 / gy, words, culled, scratch
K11 = Kernel("clustered", "k11_light_grid",
             [_P] * 5 + [_I] * 6 + [_F] * 4 + [_P] * 3)
_K11_SCRATCH: dict = {}


def _k11_scratch(dev):
    """K11's two 64-bit words, the culled sum and the block ticket
    (build.zero_scratch)."""
    return zero_scratch(_K11_SCRATCH, dev, 2, torch.int64)


def build_light_clusters(lights: lights_mod.LightTable, config, proj,
                         inv_view_proj, near: float):
    """-> (mask (C, W32) int32, culled count int64). C = gx*gy*gz
    flattened as x + gx*y + gx*gy*z (the reference's cluster id). CUDA
    tensors launch K11 (csrc/clustered.cu) once; CPU tensors take the
    twin, build_light_clusters_plain."""
    if not proj.is_cuda:
        return build_light_clusters_plain(lights, config, proj,
                                          inv_view_proj, near)
    gx, gy, gz = cluster_grid_shape(config)
    dev = proj.device
    for name, t, shape, dt in (
            ("proj", proj, (4, 4), torch.float32),
            ("inv_view_proj", inv_view_proj, (4, 4), torch.float32),
            ("lights.transform", lights.transform, None, torch.float32),
            ("lights.range", lights.range, None, torch.float32),
            ("lights.type", lights.type, None, torch.int32)):
        if t.dtype != dt or t.device != dev or not t.is_contiguous() \
                or (shape is not None and tuple(t.shape) != shape):
            raise ValueError(f"{name}: need a contiguous {dt} tensor "
                             f"{shape or ''} on {dev}")
    l_total = lights.type.shape[0]
    if tuple(lights.transform.shape) != (l_total, 4, 4) \
            or tuple(lights.range.shape) != (l_total,):
        raise ValueError("lights: need (L, 4, 4) transforms, (L,) ranges")
    w32 = (l_total + 31) // 32
    words = torch.empty((gx * gy * gz, w32), dtype=torch.int32, device=dev)
    culled = torch.empty((), dtype=torch.int64, device=dev)
    far = config.cluster_depth_extent
    K11(ptr(proj), ptr(inv_view_proj), ptr(lights.transform),
        ptr(lights.range), ptr(lights.type), l_total, int(lights.count), w32,
        gx, gy, gz, float(near), far / near, 2.0 / gx, 2.0 / gy, ptr(words),
        ptr(culled), ptr(_k11_scratch(dev)))
    return words, culled


def build_light_clusters_plain(lights: lights_mod.LightTable, config, proj,
                               inv_view_proj, near: float):
    """K11's plain twin: the dense (clusters x lights) sphere-against-planes
    test in torch, each sum in K11's fixed order (mathutils.rows_mat,
    cross3, dot3) -> (mask (C, W32) int32, culled count)."""
    p = _cluster_corners(config, proj, inv_view_proj, near)

    def plane(a, b, c):
        n = mu.cross3(b - a, c - a)
        d = -mu.dot3(n, a, keepdim=True)
        return torch.cat([n, d], -1)

    planes = torch.stack([
        plane(p[..., 0, :], p[..., 1, :], p[..., 3, :]),   # near
        plane(p[..., 4, :], p[..., 7, :], p[..., 5, :]),   # far
        plane(p[..., 0, :], p[..., 3, :], p[..., 4, :]),   # left
        plane(p[..., 1, :], p[..., 5, :], p[..., 2, :]),   # right
        plane(p[..., 2, :], p[..., 6, :], p[..., 3, :]),   # top
        plane(p[..., 0, :], p[..., 4, :], p[..., 1, :]),   # bottom
    ], dim=-2).reshape(-1, 6, 4)               # (C, 6, 4)

    lp = lights.transform[:, 3, :3]
    lrange = torch.where(lights.range > 0.0, lights.range, MAX_LIGHT_RANGE)
    l_total = lights.type.shape[0]
    li = torch.arange(l_total, device=lp.device)
    active = (lights.type != lights_mod.LIGHT_DIRECTIONAL) \
        & (li < lights.count)
    n = planes[..., :3]
    # (C, 6, L): n . p + d + |n| r, the sum (C, 6, 1) x (L,) left to right
    dot = (n[..., 0:1] * lp[:, 0] + n[..., 1:2] * lp[:, 1]
           + n[..., 2:3] * lp[:, 2])
    d = (dot + planes[..., 3:4]
         + torch.sqrt(mu.dot3(n, n, keepdim=True)) * lrange)
    inside = torch.all(d >= 0.0, dim=1) & active[None, :]    # (C, L)
    culled = torch.sum(active) * planes.shape[0] - torch.sum(inside)

    w32 = (l_total + 31) // 32
    bits = torch.nn.functional.pad(inside, (0, w32 * 32 - l_total))
    bits = bits.reshape(-1, w32, 32).to(torch.int64)
    weights = torch.bitwise_left_shift(
        torch.ones(32, dtype=torch.int64, device=lp.device),
        torch.arange(32, device=lp.device))
    words = torch.sum(bits * weights, dim=-1)
    # uint32 -> int32 two's complement (bit 31 set reads negative)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32), culled


def _slice_bounds(near: float, far: float, gz: int):
    """f32 view-z lower bounds of slices 1..gz-1 (exponential slicing)."""
    return tuple(
        np.float32(near * math.exp(math.log(far / near) * k / gz))
        for k in range(1, gz))


@functools.lru_cache(maxsize=16)
def _slice_bounds_on(near: float, far: float, gz: int, device):
    """_slice_bounds as an f32 tensor on `device`, made once per key: a
    copy from host memory waits for the stream, so K2's wrapper does not
    make one per call."""
    return torch.tensor(_slice_bounds(near, far, gz) or (0.0,),
                        dtype=torch.float32, device=device)


def _slice_of(view_z, bounds):
    cz = torch.zeros(view_z.shape, dtype=torch.int32, device=view_z.device)
    for b in bounds:
        cz = cz + (view_z >= float(b)).to(torch.int32)
    return cz


def slice_by_search(view_z, bounds):
    """K2's z-slice lookup (csrc/clustered.cu): the count of the ascending
    f32 `bounds` tensor's entries <= view_z, by the kernel's binary search.
    Equal to _slice_of's count for non-decreasing bounds."""
    lo = torch.zeros(view_z.shape, dtype=torch.int64, device=view_z.device)
    hi = torch.full_like(lo, bounds.shape[0])
    while bool((lo < hi).any()):
        active = lo < hi
        mid = (lo + hi) // 2
        ge = view_z >= bounds[torch.clamp(mid, max=bounds.shape[0] - 1)]
        lo = torch.where(active & ge, mid + 1, lo)
        hi = torch.where(active & ~ge, mid, hi)
    return lo.to(torch.int32)


def pixel_cluster_id(depth, config, near: float, width: int, height: int):
    """Per-pixel flattened cluster id; view z = near / depth."""
    gx, gy, gz = cluster_grid_shape(config)
    view_z = near / torch.clamp(depth, min=1e-6)
    cz = _slice_of(view_z, _slice_bounds(near, config.cluster_depth_extent,
                                         gz))
    xs = torch.arange(width, dtype=torch.int32, device=depth.device)
    ys = torch.arange(height, dtype=torch.int32, device=depth.device)
    cx = torch.clamp(xs * gx // width, 0, gx - 1)[None, :]
    cy = torch.clamp(ys * gy // height, 0, gy - 1)[:, None]
    return (gx * gy) * cz + gx * cy + cx


K2 = Kernel("clustered", "k2_clustered",
            [_P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _P, _I, _I, _I, _F,
             _P, _I, _I])


def light_rows(lights: lights_mod.LightTable):
    """(L, 16) f32 rows: pos(3), type, color(3), intensity, range,
    spot_dir(3), cos_inner, cos_outer, 2 pads."""
    return torch.cat([
        lights.transform[:, 3, :3],
        lights.type[:, None].to(torch.float32),
        lights.color,
        lights.intensity[:, None],
        lights.range[:, None],
        lights_mod.light_direction_toward(lights.transform),
        torch.cos(lights.spot_angles[:, 0:1]),
        torch.cos(lights.spot_angles[:, 1:2]),
        torch.zeros((lights.type.shape[0], 2), dtype=torch.float32,
                    device=lights.color.device),
    ], dim=-1).contiguous()


def clustered_lighting(gb, n, v, depth, lights: lights_mod.LightTable,
                       cluster_mask, config, near: float,
                       width: int, height: int):
    """Additive punctual-light radiance (H, W, 3) gated by the cluster
    bitmask grid (ref: lighting/clustered-lighting.hlsl). CUDA tensors
    launch K2; CPU tensors take the dense twin."""
    if not depth.is_cuda:
        return clustered_lighting_plain(gb, n, v, depth, lights, cluster_mask,
                                        config, near, width, height)
    gx, gy, gz = cluster_grid_shape(config)
    dev = depth.device
    f32 = torch.float32
    planes = dict(base_color=(gb.base_color, f32, 4), mrao=(gb.mrao, f32, 4),
                  n=(n, f32, 3), v=(v, f32, 3),
                  world_pos=(gb.world_pos, f32, 3))
    for name, (t, dt, c) in planes.items():
        if t.dtype != dt or t.device != dev or not t.is_contiguous() \
                or tuple(t.shape) != (height, width, c):
            raise ValueError(f"{name}: need contiguous ({height}, {width}, "
                             f"{c}) {dt} on {dev}")
    if depth.dtype != f32 or tuple(depth.shape) != (height, width) \
            or not depth.is_contiguous():
        raise ValueError("depth: need contiguous (H, W) float32")
    if cluster_mask.dtype != torch.int32 or cluster_mask.device != dev \
            or cluster_mask.shape[0] != gx * gy * gz:
        raise ValueError("cluster_mask: need (gx*gy*gz, W32) int32")
    mask = gb.mask.to(torch.uint8).contiguous()
    cmask = cluster_mask.contiguous()
    rows = light_rows(lights)
    bounds = _slice_bounds_on(float(near), config.cluster_depth_extent, gz,
                              dev)
    out = torch.empty((height, width, 3), dtype=f32, device=dev)
    K2(ptr(gb.base_color), ptr(gb.mrao), ptr(n), ptr(v), ptr(gb.world_pos),
       ptr(mask), ptr(depth), ptr(cmask), cmask.shape[1], ptr(rows),
       rows.shape[0], ptr(bounds), gx, gy, gz, float(near), ptr(out),
       width, height)
    return out


def zero_light_tests(lights: lights_mod.LightTable, i: int, world_pos, n):
    """K2's exact-zero tests for light i at every pixel, in the twin's
    arithmetic (shading.punctual_light, brdf_response): -> (beyond its
    range, outside its spot cone, behind the surface), (...) bool each,
    applied in that order (a later one only where the earlier ones fail).
    Where any holds, the twin's contribution of the light is exactly
    +0.0 and K2 skips its BRDF."""
    lvec = lights.transform[i, 3, :3] - world_pos
    dist_sq = mu.dot3(lvec, lvec)
    dist = torch.sqrt(dist_sq)
    rng = lights.range[i]
    q = dist / torch.clamp(rng, min=1e-8)
    falloff = torch.clamp(torch.clamp(1.0 - mu.ipow(q, 4), max=1.0), min=0.0)
    beyond = (rng > 0.0) & (falloff == 0.0)
    l = lvec / torch.clamp(dist, min=1e-8)[..., None]
    spot_dir = lights_mod.light_direction_toward(lights.transform[i])
    cd = mu.dot3(spot_dir, l)
    cos_outer = torch.cos(lights.spot_angles[i, 1])
    cos_inner = torch.cos(lights.spot_angles[i, 0])
    scale = 1.0 / torch.clamp(cos_inner - cos_outer, min=1e-3)
    ang = torch.clamp(cd * scale - cos_outer * scale, 0.0, 1.0)
    angular = torch.where(cd > cos_outer, ang * ang, 0.0)
    outside = ~beyond & (lights.type[i] == lights_mod.LIGHT_SPOT) \
        & (angular == 0.0)
    no_l = torch.clamp(mu.dot3(n, l), 0.0, 1.0)
    behind = ~beyond & ~outside & ~(no_l > 0.0)
    return beyond, outside, behind


def clustered_lighting_plain(gb, n, v, depth, lights, cluster_mask, config,
                             near: float, width: int, height: int):
    """K2's plain twin with K2's arguments: each pixel's cluster words, then
    the dense all-lights loop."""
    cid = pixel_cluster_id(depth, config, near, width, height)
    return clustered_lighting_dense(gb, n, v, cluster_mask[cid.long()],
                                    lights)


def clustered_lighting_dense(gb, n, v, words, lights: lights_mod.LightTable):
    """All-lights loop gated by each pixel's cluster words (H, W, W32) —
    the plain twin of K2 (clustered.py:213)."""
    base = gb.base_color[..., :3]
    metallic = gb.mrao[..., 0]
    roughness = gb.mrao[..., 1]
    acc = torch.zeros_like(base)
    for i in range(lights.type.shape[0]):
        on_bit = ((words[..., i // 32] >> (i % 32)) & 1) > 0
        l, radiance = shading.punctual_light(
            lights.type[i], lights.transform[i], lights.color[i],
            lights.intensity[i], lights.range[i], lights.spot_angles[i],
            gb.world_pos)
        lit = shading.brdf_response(base, metallic, roughness, n, v, l,
                                    radiance)
        acc = acc + torch.where((on_bit & gb.mask)[..., None], lit, 0.0)
    return acc
