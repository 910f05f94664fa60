"""PBR BRDF + analytic light evaluation over pixel tensors (port of
incarnation_tpu/kernels/shading.py), including the reference's scale
factors: directional x100, punctual x10000."""

from __future__ import annotations

import torch

from ..core import mathutils as mu
from ..scene import lights as lights_mod

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
