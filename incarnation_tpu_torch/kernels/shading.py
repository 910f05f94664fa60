"""PBR BRDF + analytic light evaluation over pixel tensors (port of
incarnation_tpu/kernels/shading.py), including the reference's scale
factors: directional x100, punctual x10000. The frame's sun term
(sun_term) is K15 (csrc/shading.cu) on CUDA tensors and its twin
sun_term_plain on CPU ones."""

from __future__ import annotations

import ctypes

import torch

from . import shadow as shadow_mod
from .build import Kernel, ptr
from ..core import mathutils as mu
from ..scene import lights as lights_mod

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
# hdr, base_color, mrao, n, v, mask, visibility, extras (NULL: none),
# sun_dir, sun_color_intensity, out, width, height; then the map role's
# world_pos, map (NULL: no map), sun_vp, the map's side, the bias scale,
# dither on, the two noise seeds, the checker parity (-1: none) and row0
K15 = Kernel("shading", "k15_sun_term",
             [_P] * 11 + [_I, _I] + [_P] * 3
             + [_I, _F, _I, _U, _U, _I, _I])

_PI = mu.PI


def ggx_distribution(no_h, roughness):
    a = roughness * roughness
    a2 = a * a
    no_h = torch.clamp(no_h, min=0.0)
    denom = no_h * no_h * (a2 - 1.0) + 1.0
    return a2 / torch.clamp(_PI * denom * denom, min=1e-4)


def f_schlick(u, f0):
    f = mu.ipow(1.0 - u, 5)
    return f + f0 * (1.0 - f)


def g_smith_ggx_correlated(no_v, no_l, roughness):
    a2 = roughness * roughness
    ggx_v = no_l * torch.sqrt(no_v * no_v * (1.0 - a2) + a2)
    ggx_l = no_v * torch.sqrt(no_l * no_l * (1.0 - a2) + a2)
    return 0.5 / torch.clamp(ggx_v + ggx_l, min=1e-5)


def g_schlick_ggx(u, k):
    return u / (u * (1.0 - k) + k)


def g_smith_direct(no_v, no_l, roughness):
    a2 = roughness * roughness
    k = (a2 + 1.0) ** 2 / 8.0
    return g_schlick_ggx(no_v, k) * g_schlick_ggx(no_l, k)


def g_smith_ibl(no_v, no_l, roughness):
    a2 = roughness * roughness
    k = 0.5 * a2 * a2
    return g_schlick_ggx(no_v, k) * g_schlick_ggx(no_l, k)


def exposure_from_ev100(ev100):
    """1 / (2^EV100 * 1.2)."""
    return 1.0 / (2.0 ** ev100 * 1.2)


def aces_film(x):
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def _last(x, n):
    return x[..., None] if x.dim() < n.dim() else x


def brdf_response(base_color, metallic, roughness, n, v, l, radiance_in,
                  visibility=1.0, transmission=None, clearcoat=None,
                  cc_roughness=None):
    """Cook-Torrance specular + Lambert diffuse (+ the optional
    transmission and clearcoat terms); returns outgoing radiance (..., 3)."""
    no_l = torch.clamp(mu.dot3(n, l, keepdim=True), 0.0, 1.0)
    no_v = torch.clamp(mu.dot3(n, v, keepdim=True), 0.0, 1.0)
    h = mu.normalize(l + v)
    no_h = torch.clamp(mu.dot3(n, h, keepdim=True), 0.0, 1.0)
    vo_h = torch.clamp(mu.dot3(v, h, keepdim=True), 0.0, 1.0)
    metallic = _last(metallic, n)
    roughness = _last(roughness, n)
    f0 = metallic * base_color + (1.0 - metallic) * 0.04
    albedo = (1.0 - metallic) * base_color
    if transmission is not None:
        albedo = albedo * (1.0 - _last(transmission, n))
    d = ggx_distribution(no_h, roughness)
    f = f_schlick(vo_h, f0)
    g = g_smith_ggx_correlated(no_v, no_l, roughness)
    fr = (d * f * g) / torch.clamp(4.0 * no_v * no_l, min=1e-3)
    fd = albedo * mu.INV_PI
    out = fr + (1.0 - f) * fd
    if clearcoat is not None:
        cc = _last(clearcoat, n)
        ccr = torch.clamp(_last(cc_roughness, n), min=0.03)
        fc = f_schlick(vo_h, torch.full_like(vo_h, 0.04)) * cc
        d_cc = ggx_distribution(no_h, ccr)
        g_cc = g_smith_ggx_correlated(no_v, no_l, ccr)
        fr_cc = (d_cc * fc * g_cc) / torch.clamp(4.0 * no_v * no_l, min=1e-3)
        out = out * (1.0 - fc) + fr_cc
    out = out * radiance_in * no_l * visibility
    return torch.where(no_l > 0.0, out, 0.0)


def directional_light_radiance(color, intensity):
    return 100.0 * intensity * color


def punctual_light(light_type, transform, color, intensity, rng, spot_angles,
                   world_pos):
    """Point/spot incoming radiance + direction toward the light (the
    spec-correct windowed spot falloff; see the JAX module). Scalar light
    parameters broadcast over the (..., 3) world positions.
    Returns (l (..., 3), radiance_in (..., 3))."""
    light_pos = transform[..., 3, :3]
    lvec = light_pos - world_pos
    dist_sq = mu.dot3(lvec, lvec, keepdim=True)
    dist = torch.sqrt(dist_sq)
    l = lvec / torch.clamp(dist, min=1e-8)
    bounded = torch.clamp(
        torch.clamp(1.0 - mu.ipow(dist / torch.clamp(rng, min=1e-8), 4),
                    max=1.0), min=0.0) / torch.clamp(dist_sq, min=1e-4)
    unbounded = 1.0 / torch.clamp(dist_sq, min=1e-4)
    radial = torch.where(rng > 0.0, bounded, unbounded)
    spot_dir = lights_mod.light_direction_toward(transform)
    cd = mu.dot3(spot_dir, l, keepdim=True)
    cos_outer = torch.cos(spot_angles[..., 1:2])
    cos_inner = torch.cos(spot_angles[..., 0:1])
    scale = 1.0 / torch.clamp(cos_inner - cos_outer, min=1e-3)
    ang = torch.clamp(cd * scale - cos_outer * scale, 0.0, 1.0)
    ang = ang * ang
    angular = torch.where(light_type == lights_mod.LIGHT_SPOT,
                          torch.where(cd > cos_outer, ang, 0.0), 1.0)
    radiance = 10000.0 * intensity * color * radial * angular
    return l, radiance


def sun_term(hdr, gb, n, v, sun_dir, sun_color_intensity, *,
             visibility=None, shadow_map=None, sun_vp=None,
             resolution: int = 0, dither=None, checker_parity=None,
             row0: int = 0, extras=None):
    """hdr plus the sun's direct term where gb.mask is set -> a new
    (H, W, 3) tensor. The sun's radiance is 100 x intensity x colour
    (sun_color_intensity (4,): rgb, intensity), its BRDF brdf_response's
    with the transmission, clearcoat and clearcoat roughness of extras
    (H, W, 3) where given, its visibility one of: the sun map's tap
    (shadow_map with sun_vp, resolution, dither, checker_parity and row0:
    shadow.sun_visibility of gb.world_pos, the bias's n.l from n and
    sun_dir), a given (H, W) visibility (the RT frame's), or 1.

    CUDA tensors launch K15 (csrc/shading.cu) once, which reads every
    plane in place (contiguous, base_color and mrao 16-byte aligned) and
    with a map taps it itself at the pixels where the visibility counts;
    nothing else runs on the card. CPU tensors take the twin,
    sun_term_plain."""
    if shadow_map is not None and visibility is not None:
        raise ValueError("sun_term: a shadow map or a visibility, not both")
    if not hdr.is_cuda:
        return sun_term_plain(
            hdr, gb, n, v, sun_dir, sun_color_intensity,
            visibility=visibility, shadow_map=shadow_map, sun_vp=sun_vp,
            resolution=resolution, dither=dither,
            checker_parity=checker_parity, row0=row0, extras=extras)
    dev = hdr.device
    h, w = hdr.shape[:2]
    f32, hw3 = torch.float32, (h, w, 3)
    # each tensor K15 reads (None: not given), in one pass
    for name, t, shape, dtype in (
            ("hdr", hdr, hw3, f32),
            ("base_color", gb.base_color, (h, w, 4), f32),
            ("mrao", gb.mrao, (h, w, 4), f32), ("n", n, hw3, f32),
            ("v", v, hw3, f32), ("mask", gb.mask, (h, w), torch.bool),
            ("sun_dir", sun_dir, (3,), f32),
            ("sun_color_intensity", sun_color_intensity, (4,), f32),
            ("visibility", visibility, (h, w), f32),
            ("extras", extras, hw3, f32)):
        if t is not None and (t.dtype != dtype or t.device != dev
                              or not t.is_contiguous() or t.shape != shape):
            raise ValueError(f"{name}: need a contiguous {dtype} {shape} "
                             f"tensor on {dev}")
    if gb.base_color.data_ptr() % 16 or gb.mrao.data_ptr() % 16:
        raise ValueError("base_color, mrao: need 16-byte aligned pixels")
    role, wp, tap = "none", None, (1, 1.0, 0, 0, 0, -1)
    if visibility is not None:
        role = "given"
    elif shadow_map is not None:
        role, wp = "map", gb.world_pos
        shadow_mod.check_map_inputs(dev, h, w, wp, shadow_map, sun_vp,
                                    resolution, checker_parity)
        tap = shadow_mod.map_args(resolution, dither, checker_parity)
    out = torch.empty((h, w, 3), dtype=torch.float32, device=dev)
    if not h * w:
        return out
    K15(ptr(hdr), ptr(gb.base_color), ptr(gb.mrao), ptr(n), ptr(v),
        ptr(gb.mask), ptr(visibility), ptr(extras), ptr(sun_dir),
        ptr(sun_color_intensity), ptr(out), w, h, ptr(wp), ptr(shadow_map),
        ptr(sun_vp), *tap, int(row0),
        name=role + ("+extras" if extras is not None else ""))
    return out


def sun_term_plain(hdr, gb, n, v, sun_dir, sun_color_intensity, *,
                   visibility=None, shadow_map=None, sun_vp=None,
                   resolution: int = 0, dither=None, checker_parity=None,
                   row0: int = 0, extras=None):
    """sun_term's twin in torch (its arguments and result): the frame's
    composition of the JAX package's renderer/frame.py:535-570, with the
    map's tap by shadow.sun_visibility_plain, so it launches no kernel on
    the card either."""
    if shadow_map is not None and visibility is not None:
        raise ValueError("sun_term: a shadow map or a visibility, not both")
    radiance_in = directional_light_radiance(sun_color_intensity[:3],
                                             sun_color_intensity[3])
    sun_vis = 1.0
    if shadow_map is not None:
        ndl = torch.sum(n * sun_dir, -1)
        sun_vis = shadow_mod.sun_visibility_plain(
            gb.world_pos, ndl, shadow_map, sun_vp, resolution,
            dither=dither, checker_parity=checker_parity,
            row0=row0)[..., None]
    elif visibility is not None:
        sun_vis = visibility[..., None]
    has_x = extras is not None
    sun = brdf_response(
        gb.base_color[..., :3], gb.mrao[..., 0], gb.mrao[..., 1], n, v,
        sun_dir, radiance_in, visibility=sun_vis,
        transmission=extras[..., 0] if has_x else None,
        clearcoat=extras[..., 1] if has_x else None,
        cc_roughness=extras[..., 2] if has_x else None)
    return hdr + torch.where(gb.mask[..., None], sun, 0.0)
