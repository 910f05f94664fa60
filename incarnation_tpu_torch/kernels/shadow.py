"""Sun shadow map (port of incarnation_tpu/kernels/shadow.py).

The reference traces a per-pixel DXR shadow ray toward the sun in its
DirectLighting pass (ref: shaders/lighting/common.hlsli:91-116). The raster
frame's stand-in is a rasterized orthographic shadow map: K1 renders the
sun view's depth in its depth-only role once per frame, and the screen pass
compares each pixel's sun-space depth with one tap of the map:
shading.sun_term's map role, whose K15 launch taps the map itself (csrc/
shading.cu with csrc/k14_tap.cuh), and its twin sun_visibility_plain.
The tap alone is sun_visibility: K14 (csrc/shadow.cu) on CUDA tensors,
the twin on CPU ones.

The map stays float32: the JAX package's packing to u16 words is an
approximation the port does not make, so the port's depth agrees with it to
half a quantisation step.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core import mathutils as mu
from . import checker
from . import raster as raster_mod
from .build import Kernel, ptr
from .resolve import frame_noise

# frame_noise's channels of the jittered tap (JAX shadow.py)
N_PCF_X, N_PCF_Y = 2246822519, 3266489917
_M32 = 0xFFFFFFFF

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
# world_pos, the map, sun_vp, width, height, the map's side, the bias scale
# 2 / side, dither on, the two noise seeds, the checker parity (-1: none),
# row0, the output, the normals and sun_dir
K14 = Kernel("shadow", "k14_sun_tap",
             [_P] * 3 + [_I, _I, _I, _F, _I, _U, _U, _I, _I, _P, _P, _P])


def map_args(resolution: int, dither, checker_parity) -> tuple:
    """The map's constants that K14's and K15's C entries take: (side,
    bias scale 2 / side, dither on, the two noise seeds, the checker parity
    or -1)."""
    s = int(resolution)
    frame = 0 if dither is None else int(dither)
    cp = -1 if checker_parity is None else int(checker_parity) & 1
    return (s, 2.0 / s, int(dither is not None), (frame * N_PCF_X) & _M32,
            (frame * N_PCF_Y) & _M32, cp)


def sun_view_proj(sun_dir, center, radius) -> np.ndarray:
    """Orthographic reverse-Z view-proj (row-vector convention) looking
    along -sun_dir, fitted to the bounding sphere (center, radius).

    NDC z = (far - z_view) / (far - near): 1 nearest the sun, 0 at the far
    side, the same max-wins depth convention as the camera rasterizer.
    Host-side (numpy): runs once per frame in FrameConstants.make."""
    sun_dir = np.asarray(sun_dir, np.float32)
    sun_dir = sun_dir / max(np.linalg.norm(sun_dir), 1e-8)
    center = np.asarray(center, np.float32)
    radius = float(radius)
    look = -sun_dir                       # light travel direction
    up_hint = np.asarray([0.0, 1.0, 0.0], np.float32)
    if abs(float(look @ up_hint)) > 0.95:
        up_hint = np.asarray([1.0, 0.0, 0.0], np.float32)
    right = np.cross(up_hint, look)
    right /= max(np.linalg.norm(right), 1e-8)
    up = np.cross(look, right)
    pos = center + sun_dir * (radius * 1.05)
    view = mu.view_matrix(pos, right, up, look)
    near, far = 0.0, 2.1 * radius
    proj = np.zeros((4, 4), np.float32)
    proj[0, 0] = 1.0 / radius
    proj[1, 1] = 1.0 / radius
    proj[2, 2] = -1.0 / (far - near)
    proj[3, 2] = far / (far - near)
    proj[3, 3] = 1.0
    return (view @ proj).astype(np.float32)


def shadow_params(resolution: int, config) -> raster_mod.RasterParams:
    """Raster params for the sun depth pass: square, depth-only, 16-row
    tiles whatever the display tile height, its own pair capacity. The
    shadow_bin_overflow counter depends on these values."""
    return raster_mod.RasterParams(
        width=resolution, height=resolution,
        tile_h=16, tile_w=config.raster_tile_w,
        pair_capacity=config.shadow_pair_capacity,
        bin_max_span=config.bin_max_span,
        big_tri_capacity=config.big_tri_capacity,
        depth_only=True)


def render_sun_shadow_map(scene, scene_rotation, sun_vp,
                          params: raster_mod.RasterParams):
    """Rasterize sun-view depth for the whole scene: every primitive of a
    visible mesh that is not a decal casts, and casters are never culled
    against the camera. Every face casts, front or back, double-sided or
    not: a shadow ray from a receiver is blocked by the caster's face that
    looks at the receiver, which from the sun is often the back face (the
    JAX map culls single-sided back faces and lets light through such
    walls). Alpha-masked primitives cast opaque shadows (the alpha-tested
    peel is a camera-pass refinement).
    -> ((S, S) f32 depth, stats {bin_overflow, big_overflow})."""
    prim_visible = ((scene.mesh_visible[
        torch.clamp(scene.prim_mesh, min=0).long()] > 0)
        & (scene.prim_is_decal == 0))
    prep = raster_mod.prepare_geometry(scene, scene_rotation, sun_vp,
                                       prim_visible, params,
                                       emit_attributes=False,
                                       all_double_sided=True)
    _, depth, stats = raster_mod.raster_depth(prep, params)
    return depth, stats


def sun_visibility(world_pos, n_dot_l, shadow_depth, sun_vp,
                   resolution: int, dither=None, checker_parity=None,
                   row0: int = 0, *, normal=None, sun_dir=None):
    """Per-pixel sun visibility from the shadow map, one tap.

    world_pos: (H, W, 3) in the (rotated) space the map was rendered in;
    n_dot_l: (H, W) for the slope-scaled bias; shadow_depth: the (S, S) f32
    map of render_sun_shadow_map. dither: the frame index, for one tap
    jittered within a 2-texel box (its expectation the 2x2 box PCF, which
    the TAA accumulation integrates); checker_parity: the checkerboard
    half-rate fetch (kernels/checker.py), whose fetching half hashes its
    noise at its compacted (H, W/2) positions, as the JAX package's
    (shadow.py:103-154); row0: the first row's index in the whole frame.
    normal (H, W, 3) and sun_dir (3,) with n_dot_l None: the bias's n.l is
    torch.sum(normal * sun_dir, -1) (K14's "+nl" roles form it
    themselves). -> (H, W) f32, 0 (occluded), 1, or a tent of the two.

    CUDA tensors launch K14 (csrc/shadow.cu) once in a "+nl" role, which
    reads world_pos and the normals in place (contiguous, never copied); a
    given n_dot_l is refused there. The frame's sun term taps the map
    inside K15 (shading.sun_term), so no frame calls this on the card.
    CPU tensors take the twin, sun_visibility_plain, in either form."""
    if not world_pos.is_cuda:
        return sun_visibility_plain(world_pos, n_dot_l, shadow_depth, sun_vp,
                                    resolution, dither, checker_parity, row0,
                                    normal=normal, sun_dir=sun_dir)
    if n_dot_l is not None or normal is None or sun_dir is None:
        raise ValueError("sun_visibility on the card takes the \"+nl\" form: "
                         "n_dot_l None, normal and sun_dir given")
    dev = world_pos.device
    h, w = world_pos.shape[:2]
    s = int(resolution)
    check_map_inputs(dev, h, w, world_pos, shadow_depth, sun_vp, s,
                     checker_parity, normal=normal, sun_dir=sun_dir)
    out = torch.empty((h, w), dtype=torch.float32, device=dev)
    if not h * w:
        return out
    side, scale, dith, seed_x, seed_y, cp = map_args(s, dither,
                                                     checker_parity)
    K14(ptr(world_pos), ptr(shadow_depth), ptr(sun_vp), w, h, side, scale,
        dith, seed_x, seed_y, cp, int(row0), ptr(out), ptr(normal),
        ptr(sun_dir), name=role_name(dither, checker_parity, True))
    return out


def check_map_inputs(dev, h: int, w: int, world_pos, shadow_depth, sun_vp,
                     resolution: int, checker_parity, **more):
    """Raises ValueError unless the map tap's tensors (and `more`, name to
    tensor: the normals (H, W, 3), sun_dir (3,)) are contiguous float32 on
    dev of their shapes, the map has a texel, and a checkerboard's width
    is even."""
    s = int(resolution)
    shapes = {"world_pos": (h, w, 3), "normal": (h, w, 3),
              "sun_dir": (3,), "shadow_depth": (s, s), "sun_vp": (4, 4)}
    for name, t in (("world_pos", world_pos), *more.items(),
                    ("shadow_depth", shadow_depth), ("sun_vp", sun_vp)):
        shape = shapes[name]
        if t is None or t.dtype != torch.float32 or t.device != dev \
                or not t.is_contiguous() or tuple(t.shape) != shape:
            raise ValueError(f"{name}: need a contiguous float32 tensor "
                             f"{shape} on {dev}")
    if s < 1:
        raise ValueError("resolution: need a map of at least one texel")
    if checker_parity is not None and w % 2:
        raise ValueError("the checkerboard needs an even width")


def role_name(dither, checker_parity, from_normal: bool = False) -> str:
    """K14's role of a call, the name its launch counts under in
    K14.by_name: exact, dither, checker or dither_checker, with "+nl"
    where it forms n.l from the normal."""
    parts = (["dither"] if dither is not None else []) \
        + (["checker"] if checker_parity is not None else [])
    return ("_".join(parts) or "exact") + ("+nl" if from_normal else "")


def sun_map_tap(world_pos, sun_vp, resolution: int, dither=None,
                row0: int = 0):
    """The map tap of sun_visibility_plain's fetching pixels, in K14's
    order: -> (sun-space depth (H, W), inside the map (H, W) bool, flat
    texel index (H, W) int64). The sun-space product is
    mathutils.rows_mat's sum and the affine row; each Python number is
    the float torch rounds it to."""
    s = mu.rows_mat(world_pos, sun_vp[:3, :3]) + sun_vp[3, :3]
    sx, sy, sz = s[..., 0], s[..., 1], s[..., 2]
    inside = (sx >= -1.0) & (sx <= 1.0) & (sy >= -1.0) & (sy <= 1.0)
    u = (sx * 0.5 + 0.5) * resolution
    v = (0.5 - sy * 0.5) * resolution
    if dither is not None:
        shape, dev = world_pos.shape[:2], world_pos.device
        u = u + (frame_noise(shape, dither, N_PCF_X, dev, row0) - 0.5) * 2.0
        v = v + (frame_noise(shape, dither, N_PCF_Y, dev, row0) - 0.5) * 2.0
    # clamp as floats, then truncate: a float-to-int cast of a value out
    # of range (or NaN) differs between devices. Inside the map this is
    # the reference's truncate-then-clamp; outside, `inside` decides.
    hi = float(resolution - 1)
    u = torch.clamp(torch.nan_to_num(u), 0.0, hi)
    v = torch.clamp(torch.nan_to_num(v), 0.0, hi)
    return sz, inside, v.to(torch.int64) * resolution + u.to(torch.int64)


def sun_visibility_plain(world_pos, n_dot_l, shadow_depth, sun_vp,
                         resolution: int, dither=None, checker_parity=None,
                         row0: int = 0, *, normal=None, sun_dir=None):
    """K14's plain twin in torch (sun_visibility's arguments and result):
    n.l from the normal where it is not given, the checkerboard as
    checker.compact, the tap, checker.expand."""
    if n_dot_l is None:
        n_dot_l = torch.sum(normal * sun_dir, -1)
    if checker_parity is not None:
        cp = int(checker_parity) & 1
        vis = sun_visibility_plain(checker.compact(cp, world_pos, row0),
                                   checker.compact(cp, n_dot_l, row0),
                                   shadow_depth, sun_vp, resolution, dither,
                                   row0=row0)
        return checker.expand(cp, vis, row0)
    sz, inside, lin = sun_map_tap(world_pos, sun_vp, resolution, dither, row0)
    d = shadow_depth.reshape(-1)[lin]          # one flat-index fetch
    # Slope-scaled bias in NDC-z units (the depth range spans 2.1 x the
    # radius; 2-texel worst-case slope + a constant offset).
    bias = (1.5 + 2.0 * (1.0 - torch.clamp(n_dot_l, 0.0, 1.0))) * (
        2.0 / resolution)
    occluded = d > sz + bias
    return torch.where(inside & occluded, 0.0, 1.0)
