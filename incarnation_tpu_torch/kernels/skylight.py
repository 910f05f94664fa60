"""Sky / image-based lighting pass + environment background (port of
incarnation_tpu/kernels/skylight.py, exact path: trilinear probe fetch).

diffuse = SH9 cosine-convolved irradiance x5, specular = GGX-prefiltered
envmap by roughness x env-BRDF, both x SkyBrightness and AO-blended."""

from __future__ import annotations

import torch

from ..core import mathutils as mu
from . import ibl, shading
from . import sky as sky_mod


def sky_lighting(gb, n, v, probe: ibl.EnvironmentProbe, env_brdf,
                 sky_brightness, hbao=None, bent_normals=None,
                 diffuse_ibl: bool = True, specular_ibl: bool = True,
                 lighting_only: bool = False, extras=None,
                 analytic_env_brdf: bool = False):
    """Additive sky radiance for covered pixels (ref: sky-lighting.hlsl).
    hbao: (H, W) AO that scales the result; bent_normals: (H, W, 3) normals
    for the diffuse SH lookup. extras: gb.extras when the scene has
    transmission/clearcoat factors."""
    base = (torch.full_like(gb.base_color[..., :3], 0.5) if lighting_only
            else gb.base_color[..., :3])
    metallic = gb.mrao[..., 0:1]
    roughness = gb.mrao[..., 1]
    ao = gb.mrao[..., 2:3]
    ao_blend = gb.mrao[..., 3:4]
    radiance = torch.zeros_like(base)

    if diffuse_ibl:
        albedo = (1.0 - metallic) * base
        if extras is not None:
            albedo = albedo * (1.0 - extras[..., 0:1])
        sampling_n = bent_normals if bent_normals is not None else n
        sh_diffuse = (albedo * mu.INV_PI
                      * ibl.sh_irradiance(sampling_n, probe.sh) * 5.0)
        radiance = radiance + sky_brightness * (
            sh_diffuse * (1 - ao_blend) + ao * sh_diffuse * ao_blend)

    def env_brdf_at(no_v, rough):
        if analytic_env_brdf:
            # evaluated at 1 - roughness: the reference samples its LUT at
            # the inverted row (see the JAX module)
            return ibl.env_brdf_approx(no_v, 1.0 - rough)
        return ibl.sample_env_brdf(env_brdf, no_v, rough)

    if specular_ibl:
        no_v = torch.clamp(torch.sum(n * v, -1), min=0.01)
        f0 = metallic * base + (1.0 - metallic) * 0.04
        r = mu.normalize(2.0 * torch.sum(v * n, -1, keepdim=True) * n - v)
        mips = probe.prefiltered.num_levels
        pre = ibl.sample_cube(probe.prefiltered, r, lod=roughness * (mips - 1))
        ab = env_brdf_at(no_v, roughness)
        spec = pre * (f0 * ab[..., 0:1] + ab[..., 1:2])
        if extras is not None:
            cc = extras[..., 1:2]
            ccr = torch.clamp(extras[..., 2], min=0.03)
            fc = shading.f_schlick(no_v[..., None],
                                   torch.full_like(cc, 0.04)) * cc
            pre_cc = ibl.sample_cube(probe.prefiltered, r,
                                     lod=ccr * (mips - 1))
            ab_cc = env_brdf_at(no_v, ccr)
            spec_cc = pre_cc * (0.04 * ab_cc[..., 0:1] + ab_cc[..., 1:2])
            spec = spec * (1.0 - fc) + spec_cc * fc
            radiance = radiance * (1.0 - fc)
        radiance = radiance + sky_brightness * (
            spec * (1 - ao_blend) + ao * spec * ao_blend)
    if hbao is not None:
        radiance = radiance * hbao[..., None]
    return torch.where(gb.mask[..., None], radiance, 0.0)


def environment_background(mask, eye, inv_view_proj, width, height,
                           probe=None, sun_dir=None, turbidity: float = 2.0,
                           sky_brightness=25000.0, dynamic_sky: bool = True):
    """Background radiance for uncovered pixels: 1000 x Preetham
    (dynamic sky) or sky_brightness x envmap."""
    from .resolve import world_from_depth
    wp = world_from_depth(
        torch.full((height, width), 1e-4, dtype=torch.float32,
                   device=mask.device), inv_view_proj, width, height)
    d = mu.normalize(wp - eye)
    if dynamic_sky:
        rad = 1000.0 * sky_mod.sky_radiance(sun_dir, d, turbidity)
    else:
        rad = sky_brightness * ibl.sample_cube(probe.envmap, d)
    return torch.where(mask[..., None], 0.0, rad)
