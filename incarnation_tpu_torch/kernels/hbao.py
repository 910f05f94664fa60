"""Ray-traced ambient occlusion and bent normals, HBIL style (port of
incarnation_tpu/kernels/hbao.py; ref: shaders/postprocess/hbao.hlsl).

For each pixel, 4 azimuthal slices around the view direction; per slice,
the front and back horizon angles come from a binary search of up to 4
short occlusion rays (length 1.0, ending once the interval is under 5
degrees); AO and the bent normal integrate analytically from the angles.
The search runs in lock step over the pixels, as in the JAX package; each
step traces only the rays still searching (K4 any-hit on the card), which
leaves every other pixel's interval as it was.
"""

from __future__ import annotations

import math

import torch

from ..core import mathutils as mu
from . import bvh as bvh_mod

NUM_SLICES = 4
MAX_TRACES_PER_SLICE = 4
TERMINATE_THRESHOLD = math.pi / 36.0
MAX_TRACE_LENGTH = 1.0


def _horizon_angle(bvh, start, origin, slice_x, slice_y, active):
    """Lock-step binary search (ref: hbao.hlsl ComputeHorizonAngle)."""
    lo = torch.zeros_like(start)
    hi = start
    for _ in range(MAX_TRACES_PER_SLICE):
        searching = active & ((hi - lo) > TERMINATE_THRESHOLD)
        mid = lo + 0.5 * (hi - lo)
        idx = torch.nonzero(searching).squeeze(1)
        if idx.numel() == 0:
            continue
        m = mid[idx][..., None]
        d = torch.cos(m) * slice_y[idx] + torch.sin(m) * slice_x[idx]
        hit = bvh_mod.occluded(bvh, origin[idx], d, tmin=0.1,
                               tmax=MAX_TRACE_LENGTH, role="hbao")
        hi = hi.index_put((idx,), torch.where(hit, mid[idx], hi[idx]))
        lo = lo.index_put((idx,), torch.where(hit, lo[idx], mid[idx]))
    return hi


def hbao(bvh, gb, depth, fc, width: int, height: int):
    """-> (ao (H, W) f32, bent normals (H, W, 2) oct-encoded). Origins and
    directions are inverse-rotated into the BVH's unrotated world space."""
    inv = fc.inv_scene_rotation
    r3 = inv[:3, :3]
    wp = gb.world_pos.reshape(-1, 3)
    n = mu.oct_decode(gb.normals).reshape(-1, 3)
    active = gb.mask.reshape(-1)

    at = mu.normalize(fc.eye - wp)
    right = mu.normalize(torch.cross(at, fc.camera_up.expand_as(at), dim=-1))
    up = torch.cross(right, at, dim=-1)
    wp_b = wp @ r3 + inv[3, :3]
    at_b = at @ r3

    sum_ao = torch.zeros(wp.shape[0], device=wp.device)
    bent = torch.zeros_like(wp)
    for i in range(NUM_SLICES):
        phi = i * (math.pi / NUM_SLICES)
        slice_x = math.cos(phi) * right + math.sin(phi) * up
        pn_x = torch.sum(n * slice_x, -1)
        pn_y = torch.sum(n * at, -1)
        t = -pn_x / torch.where(torch.abs(pn_y) > 1e-6, pn_y, 1e-6)
        start = torch.arccos(torch.clamp(t / torch.sqrt(1.0 + t * t),
                                         -1.0, 1.0))
        sx_b = slice_x @ r3
        th1 = _horizon_angle(bvh, start, wp_b, sx_b, at_b, active)
        th0 = -_horizon_angle(bvh, start, wp_b, -sx_b, at_b, active)
        nx = 0.5 * (th1 - th0 + torch.sin(th0) * torch.cos(th0)
                    - torch.sin(th1) * torch.cos(th1))
        ny = 0.5 * (2.0 - torch.cos(th0) ** 2 - torch.cos(th1) ** 2)
        sum_ao = sum_ao + pn_x * nx + pn_y * ny
        bent = bent + mu.normalize(slice_x * nx[..., None]
                                   + at * ny[..., None])

    ao = torch.clamp(sum_ao / NUM_SLICES, 0.0, 1.0)
    ao = torch.where(active, ao, 1.0)   # cleared to 1 without geometry
    bent_n = mu.normalize(torch.where(active[..., None], bent, n))
    return (ao.reshape(height, width),
            mu.oct_encode(bent_n).reshape(height, width, 2))
