"""Progressive wavefront path tracer (port of
incarnation_tpu/kernels/pathtrace.py; ref: shaders/raytracing/
pathtracing.hlsl, raytracing/common.hlsli, render-jobs/path-tracing.inl).

One ray array per bounce is traced against the scene BVH (kernels/bvh.py,
K4 on the card), shaded and respawned, for at most MAX_BOUNCES bounces:
thin-lens camera rays, CMJ sample sequences per (pixel, sample set),
emissive x20000 with scattering damped by emission, NEE (every light when
there are at most 4, else one picked per ray), a cosine-sampled sky term
with the reference's world-axis quirk, a 50/50 cosine / GGX bounce, the
environment on a miss, and progressive accumulation. Textures are sampled
at mip 0 with one jittered texel per hit.

Every CMJ draw advances the sample-set counter in the JAX package's order,
so each draw of a pixel is the same number in both packages.

Three divergences from the JAX package, each recorded in ROADMAP.md Queue
3 with its test (tests/test_torch_pathtrace_alpha.py, and
test_torch_pathtrace.py for the last):
- a ray that passes a transparent cutout continues the same ray over
  [t + RAY_OFFSET, tmax] (the reference's IgnoreHit), so its t is measured
  from the ray's own origin; the JAX package re-traces from the
  continuation point and reports t from there;
- every transparent hit is re-traced: the JAX package drops the
  transparent hits beyond a capacity of a quarter of the batch (a TPU-only
  approximation), which then count as misses;
- the sky sample's BRDF clamps NoV to [0, 1], as the direct light's does;
  the JAX term leaves it unclamped and turns negative (or into a firefly)
  where the shading normal faces away from the eye.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import mathutils as mu
from ..scene import lights as lights_mod
from ..scene import textures as tex_mod
from . import bvh as bvh_mod
from . import ibl, sampling, shading
from . import sky as sky_mod

RAY_OFFSET = 1e-3   # ref: raytracing/common.hlsli k_rayOffset
MAX_BOUNCES = 4     # ref: pathtracing.hlsl:29 MAX_RECURSION_DEPTH
ALPHA_PEELS = 2     # masked-geometry continuations per trace
_M32 = 0xFFFFFFFF


def _alpha_at_hit(scene, tri, u, v, noise):
    """Opacity test at BVH hits for MASK/BLEND prims: True = accept
    (ref: pathtracing.hlsl:270-302). BLEND prims take a stochastic
    threshold, which the progressive accumulation resolves to blending."""
    safe = torch.clamp(tri, min=0).long()
    tv = scene.tri_vtx[safe].long()
    uvs = scene.uvs
    uv = (uvs[tv[..., 0]]
          + u[..., None] * (uvs[tv[..., 1]] - uvs[tv[..., 0]])
          + v[..., None] * (uvs[tv[..., 2]] - uvs[tv[..., 0]]))
    prim = torch.clamp(scene.tri_prim[safe], min=0).long()
    mode = scene.prim_alpha_mode[prim]
    mat_id = scene.prim_material[prim]
    a_tex = tex_mod.sample_stack_alpha(scene.mat_stack, mat_id, uv)
    fac = scene.mat_params[torch.clamp(mat_id, min=0).long()]
    alpha = fac[..., 6] * a_tex
    thresh = torch.where(mode >= 2, torch.clamp(noise, min=1e-3),
                         fac[..., 11])
    return (mode == 0) | (alpha >= thresh)


class AlphaFilter:
    """The opacity test of _alpha_at_hit as an alpha_of filter for
    bvh.trace / occluded (the reference's any-hit alpha shader,
    pathtracing.hlsl:270-302): callable as alpha_of(tri, u, v), which
    evaluates _alpha_at_hit (the twin's path), and readable by K4's alpha
    role, which evaluates the same test inside the walk on the card.
    noise: the BLEND threshold noise, an (R,) tensor with one value per
    ray of the trace, or a float for every ray."""

    def __init__(self, scene, noise):
        self.scene = scene
        self.noise = torch.as_tensor(noise, dtype=torch.float32,
                                     device=scene.tri_prim.device)

    def __call__(self, tri, u, v):
        noise = (self.noise.expand(tri.shape) if self.noise.dim() == 0
                 else self.noise)
        return _alpha_at_hit(self.scene, tri, u, v, noise)

    def subset(self, idx):
        """The filter over the rays idx of the trace (the twin's batch
        of rays still walking)."""
        if self.noise.dim() == 0:
            return self
        return AlphaFilter(self.scene, self.noise[idx])


def _peel_noise(seed, peel, tri, noise_u):
    """BLEND threshold noise of alpha peel `peel`: the caller's CMJ value
    per ray under a golden-ratio rotation per peel, else a uint32 hash of
    (seed, peel, tri) (the raster frame's RT sun shadows)."""
    if noise_u is not None:
        x = noise_u + float(np.float32(peel) * np.float32(0.6180339887498949))
        return x - torch.floor(x)
    seed = (seed.to(torch.int64) if torch.is_tensor(seed)
            else torch.tensor(int(seed), device=tri.device)) & _M32
    a = (seed + (peel * 747796405 & _M32)) & _M32
    h = sampling._mul32(a, 2891336453) \
        ^ sampling._mul32(tri.to(torch.int64) & _M32, 277803737)
    return ((h >> 8) & 0xFFFF).to(torch.float32) / 65536.0


def _trace_alpha(scene, bvh, o, d, tmin, tmax, seed, any_hit=False,
                 noise_u=None, peels=ALPHA_PEELS, role=None):
    """bvh.trace with alpha-masked continuation: a hit on a MASK/BLEND prim
    that fails the opacity test continues the same ray past it, up to
    `peels` times; a hit that still fails counts as a miss. One host sync
    per peel (which rays to continue). role names the first trace in K4's
    per-role count, role + "_peel" the continuations."""
    res = bvh_mod.trace(bvh, o, d, tmin=tmin, tmax=tmax, any_hit=any_hit,
                        role=role)
    if not scene.meta.has_masked:
        return res
    for peel in range(peels):
        tri = res["tri"]
        noise = _peel_noise(seed, peel, tri, noise_u)
        accept = _alpha_at_hit(scene, tri, res["u"], res["v"], noise)
        idx = torch.nonzero((tri >= 0) & ~accept).squeeze(1)
        if idx.numel() == 0:
            continue
        sub = bvh_mod.trace(bvh, o[idx], d[idx],
                            tmin=res["t"][idx] + RAY_OFFSET, tmax=tmax,
                            any_hit=any_hit, role=f"{role}_peel")
        res = {k: (res[k].index_put((idx,), sub[k]) if res[k].dim()
                   else res[k] + sub[k]) for k in res}
    tri = res["tri"]
    noise = _peel_noise(seed, peels, tri, noise_u)
    bad = (tri >= 0) & ~_alpha_at_hit(scene, tri, res["u"], res["v"], noise)
    res["tri"] = torch.where(bad, -1, tri)
    res["t"] = torch.where(bad, float("inf"), res["t"])
    return res


def _hit_attributes(scene, world_n_v, world_t_v, tri, u, v):
    """Interpolated uv and world TBN at ray hits (ref: pathtracing.hlsl
    chsMain vertex fetch)."""
    safe = torch.clamp(tri, min=0).long()
    tv = scene.tri_vtx[safe].long()
    i0, i1, i2 = tv[..., 0], tv[..., 1], tv[..., 2]
    uu = u[..., None]
    vv = v[..., None]

    def lerp(a):
        return a[i0] + uu * (a[i1] - a[i0]) + vv * (a[i2] - a[i0])

    n = mu.normalize(lerp(world_n_v))
    t = mu.normalize(lerp(world_t_v))
    b = torch.cross(n, t, dim=-1) * scene.tangents[i0][..., 3:4]
    uv = lerp(scene.uvs)
    mat_id = scene.prim_material[torch.clamp(scene.tri_prim[safe],
                                             min=0).long()]
    return uv, n, t, b, mat_id


def _eval_material(scene, mat_id, uv, jitter=None):
    """Material at hit points, mip 0 (ref: TEX_SAMPLE SampleLevel 0);
    jitter: (..., 2) uniforms for the one-texel stochastic fetch."""
    chans = tex_mod.sample_material_stack(scene.mat_stack, mat_id, uv,
                                          lod=None, jitter=jitter)
    tx = tex_mod.decode_stack_channels(chans)
    fac = scene.mat_params[torch.clamp(mat_id, min=0).long()]
    return dict(
        base_color=fac[..., 3:6] * tx["base_rgb"],
        emissive=fac[..., 0:3] * tx["emissive_rgb"],
        metallic=fac[..., 7] * tx["metallic"],
        roughness=fac[..., 8] * tx["roughness"],
        normal_xy=tx["normal_xy"] * fac[..., 10:11],
    )


def _tangent_mul(v3, t, b, n):
    """mul(v, float3x3(T, B, N)), row-vector semantics."""
    return v3[..., 0:1] * t + v3[..., 1:2] * b + v3[..., 2:3] * n


def _direct_light_sample(light_i, lights, wp):
    """The visibility-independent part of GetDirectRadiance for one light
    (an int) or one light per ray (a tensor): (l, radiance_in) at wp
    (ref: lighting/common.hlsli:8-145)."""
    lt = lights.type[light_i]
    xform = lights.transform[light_i]
    inten = lights.intensity[light_i]
    color = lights.color[light_i]
    rng = lights.range[light_i]
    is_dir = lt == lights_mod.LIGHT_DIRECTIONAL
    if is_dir.dim():                  # one light per ray
        is_dir, lt, inten, rng = (is_dir[..., None], lt[..., None],
                                  inten[..., None], rng[..., None])
    l_dir = lights_mod.light_direction_toward(xform).expand(wp.shape)
    l_pn, rad_pn = shading.punctual_light(
        lt, xform, color, inten, rng, lights.spot_angles[light_i], wp)
    rad_dir = shading.directional_light_radiance(color, inten)
    l = torch.where(is_dir, l_dir, l_pn)
    radiance_in = torch.where(is_dir, rad_dir.expand(wp.shape), rad_pn)
    return l, radiance_in


def _sky_sample_term(probe, sky_brightness, u2, base, metallic, roughness,
                     n, v, sky_rot3=None):
    """GetSkyRadiance with the reference's cosine-sample quirk (ref:
    pathtracing.hlsl:246-251), without its visibility factor: returns
    (sample_dir in BVH space, term). The hemisphere sample is drawn in
    world axes and fetched from the envmap in world space."""
    sample_w = sampling.cosine_sample_hemisphere(u2)
    radiance_in = sky_brightness * ibl.sample_cube(probe.envmap, sample_w)
    sample_dir = sample_w if sky_rot3 is None else sample_w @ sky_rot3.T
    no_l = torch.clamp(torch.sum(n * sample_dir, -1, keepdim=True), 0.0, 1.0)
    m = metallic[..., None]
    f0 = m * base + (1 - m) * 0.04
    albedo = (1 - m) * base
    h = mu.normalize(sample_dir + v)
    # NoV clamped to [0, 1], as the direct light's BRDF clamps it in both
    # packages (shading.brdf_response). A divergence: the JAX term leaves
    # it unclamped (pathtrace.py:247) and turns negative, or into a
    # firefly, where the shading normal faces away from the eye. The clamp
    # stays: the JAX term cites lighting/common.hlsli:147-202, whose direct
    # BRDF in the same file (:118-139) clamps NoV, and no estimator of a
    # non-negative integral returns a negative sample (ROADMAP Queue 3).
    no_v = torch.clamp(torch.sum(n * v, -1, keepdim=True), 0.0, 1.0)
    no_h = torch.clamp(torch.sum(n * h, -1, keepdim=True), min=1e-4)
    vo_h = torch.clamp(torch.sum(v * h, -1, keepdim=True), min=1e-4)
    r = roughness[..., None]
    d = shading.ggx_distribution(no_h, r)
    f = shading.f_schlick(vo_h, f0)
    g = shading.g_smith_direct(no_v, no_l, r)
    fr = (d * f * g) / torch.clamp(4.0 * no_v * no_l, min=1e-3)
    fd = albedo * mu.INV_PI
    out = (fr + (1.0 - f) * fd) * radiance_in * no_l
    out = torch.where(no_l > 0.0, out, 0.0)
    pdf = sampling.cosine_hemisphere_pdf(sample_w[..., 2:3])
    return sample_dir, out / torch.where(torch.abs(pdf) > 1e-8, pdf, 1.0)


def _indirect_ray(u2, n, t, b, v, base, metallic, roughness):
    """50/50 cosine / GGX bounce (ref: common.hlsli:56-131) ->
    (l, attenuation)."""
    ux, uy = u2[..., 0], u2[..., 1]
    use_cosine = (ux < 0.5)[..., None]
    u_cos = torch.stack([2.0 * ux, uy], -1)
    u_ggx = torch.stack([2.0 * (ux - 0.5), uy], -1)
    l_cos = _tangent_mul(sampling.cosine_sample_hemisphere(u_cos), t, b, n)
    h_ggx = _tangent_mul(ibl.sample_ggx(u_ggx, roughness), t, b, n)
    l_ggx = mu.normalize(
        2.0 * torch.sum(v * h_ggx, -1, keepdim=True) * h_ggx - v)
    l = mu.normalize(torch.where(use_cosine, l_cos, l_ggx))
    h = torch.where(use_cosine, mu.normalize(l + v), h_ggx)

    no_l = torch.clamp(torch.sum(n * l, -1), min=1e-3)
    no_v = torch.clamp(torch.sum(n * v, -1), min=1e-3)
    no_h = torch.clamp(torch.sum(n * h, -1), min=1e-3)
    vo_h = torch.clamp(torch.sum(v * h, -1), min=1e-3)
    ggx_pdf = (shading.ggx_distribution(no_h, roughness) * no_h
               / (4.0 * vo_h))
    pdf = 0.5 * sampling.cosine_hemisphere_pdf(no_l) + 0.5 * ggx_pdf

    m = metallic[..., None]
    f0 = m * base + (1 - m) * 0.04
    albedo = (1 - m) * base
    d = shading.ggx_distribution(no_h, roughness)[..., None]
    f = shading.f_schlick(vo_h[..., None], f0)
    g = shading.g_smith_direct(no_v, no_l, roughness)[..., None]
    fr = (d * f * g) / torch.clamp(4.0 * no_v * no_l, min=1e-3)[..., None]
    brdf = fr + (1.0 - f) * albedo * mu.INV_PI
    atten = brdf * no_l[..., None] / torch.clamp(pdf, min=1e-8)[..., None]
    return l, atten


def trace_sample(scene, bvh, world_n_v, world_t_v, fc, probe,
                 sample_index, width: int, height: int,
                 sqrt_sample_count: int = 16, dynamic_sky: bool = True,
                 turbidity: float = 2.0, viewmode: int = 0,
                 sky_rot3=None, sun_dir_world=None, return_rays=False,
                 pixel_base: int = 0, full_height: int = None):
    """Progressive sample(s) for every pixel -> (H, W, 3) radiance.

    sample_index: an int (or 0-dim tensor), or a (S,) sequence traced as
    one S*H*W-ray wavefront -> (S, H, W, 3), each sample identical to its
    scalar call. pixel_base / full_height: this call covers `height` rows
    of a `full_height`-row frame from linear pixel `pixel_base`; pixel ids,
    CMJ patterns and camera NDC use full-frame coordinates.

    return_rays: also return the counted rays (alive rays entering each
    closest-hit and shadow trace; parked rays and alpha continuations
    excluded), a 0-dim f32 tensor.

    viewmode 2/3/4/5 return roughness / metallic / base colour / emissive
    at the primary hit.

    Scene rotation: the caller (renderer.frame.render_pathtrace) hands the
    camera, sun and lights in the BVH's unrotated space, with sky_rot3
    (BVH -> world) for environment fetches and sun_dir_world for the
    analytic sky."""
    dev = scene.tri_prim.device
    wh = width * height
    if full_height is None:
        full_height = height
    scalar_index = not (isinstance(sample_index, (list, tuple))
                        or (torch.is_tensor(sample_index)
                            and sample_index.dim() > 0))
    sidx_v = torch.as_tensor(sample_index, dtype=torch.int64,
                             device=dev).reshape(-1) & _M32
    s = sidx_v.shape[0]
    r = wh * s
    pixel = (torch.arange(wh, dtype=torch.int64, device=dev).repeat(s)
             + pixel_base) & _M32
    px = (pixel % width).to(torch.float32)
    py = (pixel // width).to(torch.float32)
    num_pixels = width * full_height

    set_counter = [0]

    def sample_point(sidx):
        pattern = ((set_counter[0] * num_pixels & _M32) + pixel) & _M32
        set_counter[0] = (set_counter[0] + 1) & _M32
        return sampling.cmj_sample2d(sidx, pattern, sqrt_sample_count)

    sidx = sidx_v.repeat_interleave(wh)
    n_rays = torch.zeros((), dtype=torch.float32, device=dev)
    subpix = sample_point(sidx)
    aperture_u = sample_point(sidx)

    # thin-lens camera ray (ref: GenerateCameraRay)
    xy = torch.stack([px, py], -1) + subpix + 0.5
    screen = torch.stack(
        [2.0 * xy[..., 0] / torch.full_like(px, width) - 1.0,
         -(2.0 * xy[..., 1] / torch.full_like(py, full_height) - 1.0)], -1)
    ndc = torch.cat([screen, torch.full((r, 1), 1e-4, device=dev),
                     torch.ones((r, 1), device=dev)], -1)
    world = ndc @ fc.inv_view_proj
    world = world[..., :3] / world[..., 3:]
    primary = mu.normalize(world - fc.eye)
    focal = fc.eye + fc.focal_length * primary
    disk = sampling.concentric_sample_disk(aperture_u)
    origin = (fc.eye + fc.aperture * disk[..., 0:1] * fc.camera_right
              + fc.aperture * disk[..., 1:2] * fc.camera_up)
    direction = mu.normalize(focal - origin)

    radiance = torch.zeros((r, 3), device=dev)
    beta = torch.ones((r, 3), device=dev)
    alive = torch.ones(r, dtype=torch.bool, device=dev)
    sun_w = fc.sun_dir if sun_dir_world is None else sun_dir_world
    masked = scene.meta.has_masked
    shadow_seed = [0]

    def shadow_batch(wp, dirs, alive):
        """One any-hit trace for all of a bounce's shadow rays (K lists of
        (R, 3)); dead pixels' rays park at 1e29. -> K occlusion masks."""
        nonlocal n_rays
        k = len(dirs)
        shadow_seed[0] += 1
        n_rays = n_rays + k * torch.sum(alive.to(torch.float32))
        wp_p = torch.where(alive[..., None], wp, 1e29)
        o_all = torch.cat([wp_p] * k, 0)
        d_all = torch.cat(dirs, 0)
        noise = (torch.cat([sample_point(sidx)[..., 0] for _ in range(k)], 0)
                 if masked else None)
        seed = (sidx.repeat(k) * 131 + shadow_seed[0]) & _M32
        # one peel: a shadow ray needs one opaque-enough hit (as the JAX
        # package, pathtrace.py:401-408)
        occ = _trace_alpha(scene, bvh, o_all, d_all, 0.1, 1000.0, seed,
                           any_hit=True, noise_u=noise, peels=1,
                           role="pt_shadow")["tri"] >= 0
        return [occ[i * r:(i + 1) * r] for i in range(k)]

    for bounce in range(MAX_BOUNCES):
        if bounce > 0:
            # dead rays park at 1e29: they miss the root and stop at once
            origin = torch.where(alive[..., None], origin, 1e29)
        n_rays = n_rays + (float(r) if bounce == 0
                           else torch.sum(alive.to(torch.float32)))
        noise_u = sample_point(sidx)[..., 0] if masked else None
        hit = _trace_alpha(scene, bvh, origin, direction, RAY_OFFSET, 1e4,
                           (sidx * 17 + bounce) & _M32, noise_u=noise_u,
                           role="pt_primary" if bounce == 0 else "pt_bounce")
        tri = hit["tri"]
        missed = (tri < 0) & alive

        # miss: environment radiance, fetched in world space
        d_w = direction if sky_rot3 is None else direction @ sky_rot3
        if dynamic_sky:
            env = 1000.0 * sky_mod.sky_radiance(sun_w, d_w, turbidity)
        elif probe is not None:
            env = fc.sky_brightness * ibl.sample_cube(probe.envmap, d_w)
        else:
            env = torch.zeros_like(beta)
        radiance = radiance + torch.where(missed[..., None], beta * env, 0.0)

        alive = alive & (tri >= 0)
        wp = origin + hit["t"][..., None] * direction
        wp = torch.where(alive[..., None], wp, 0.0)

        uv, n, t, b, mat_id = _hit_attributes(scene, world_n_v, world_t_v,
                                              tri, hit["u"], hit["v"])
        m = _eval_material(scene, mat_id, uv, jitter=sample_point(sidx))

        if bounce == 0 and viewmode in (2, 3, 4, 5):
            # debug view modes stop at the primary hit
            # (ref: pathtracing.hlsl:187-196)
            chan = {2: m["roughness"][..., None].expand(-1, 3),
                    3: m["metallic"][..., None].expand(-1, 3),
                    4: m["base_color"],
                    5: m["emissive"]}[viewmode]
            img = torch.where(alive[..., None], chan, 0.0)
            img = (img.reshape(height, width, 3) if scalar_index
                   else img.reshape(s, height, width, 3))
            return (img, n_rays) if return_rays else img

        # emission and scattering damping (ref: pathtracing.hlsl:210-212)
        radiance = radiance + torch.where(
            alive[..., None], beta * m["emissive"] * 20000.0, 0.0)
        beta = beta * torch.where(
            alive[..., None], torch.clamp(1.0 - m["emissive"], 0.0, 1.0),
            1.0)

        # normal mapping
        nxy = m["normal_xy"]
        nz = torch.sqrt(torch.clamp(1.0 - torch.sum(nxy * nxy, -1),
                                    min=1e-6))
        n = mu.normalize(_tangent_mul(torch.cat([nxy, nz[..., None]], -1),
                                      t, b, n))
        v = -direction

        # NEE (ref: pathtracing.hlsl:231-243): every light of a small set,
        # else one light per ray weighted by the count; all of a bounce's
        # shadow rays (NEE and sky) in one any-hit trace
        nl = scene.meta.num_lights
        shadow_dirs = []
        appliers = []

        def add_nee(li, gate, weight=1.0):
            l, rad_in = _direct_light_sample(li, scene.lights, wp)
            shadow_dirs.append(l)

            def apply(occ, l=l, rad_in=rad_in, gate=gate, weight=weight):
                contrib = shading.brdf_response(
                    m["base_color"], m["metallic"], m["roughness"], n, v, l,
                    rad_in, visibility=(~occ)[..., None].to(torch.float32))
                return torch.where(gate[..., None], beta * contrib * weight,
                                   0.0)
            appliers.append(apply)

        cnt = scene.lights.count
        if 0 < nl <= 4:
            for li in range(nl):
                add_nee(li, alive & (li < cnt))
        elif nl > 4:
            u_l = sample_point(sidx)[..., 0]
            li = torch.clamp((u_l * float(cnt)).to(torch.int64),
                             max=max(cnt - 1, 0))
            add_nee(li, alive & (cnt > 0), weight=float(cnt))

        if probe is not None:
            sky_dir, sky_term = _sky_sample_term(
                probe, fc.sky_brightness, sample_point(sidx),
                m["base_color"], m["metallic"], m["roughness"], n, v,
                sky_rot3=sky_rot3)
            shadow_dirs.append(sky_dir)

            def apply_sky(occ, sky_term=sky_term):
                term = sky_term * (~occ)[..., None].to(torch.float32)
                return torch.where(alive[..., None], beta * term, 0.0)
            appliers.append(apply_sky)

        if shadow_dirs:
            occs = shadow_batch(wp, shadow_dirs, alive)
            for occ, apply in zip(occs, appliers):
                radiance = radiance + apply(occ)

        if bounce + 1 < MAX_BOUNCES:
            l, atten = _indirect_ray(sample_point(sidx), n, t, b, v,
                                     m["base_color"], m["metallic"],
                                     m["roughness"])
            beta = beta * torch.where(alive[..., None], atten, 1.0)
            origin = wp
            direction = l
            alive = alive & (torch.amax(beta, -1) > 1e-3)

    img = (radiance.reshape(height, width, 3) if scalar_index
           else radiance.reshape(s, height, width, 3))
    return (img, n_rays) if return_rays else img


def integrate(history, current, sample_index):
    """Progressive accumulation (ref: pathtrace-integrate.hlsl:16-31):
    history' = ((n - 1) history + current) / n with n = sample_index + 1.
    A batch (S, H, W, 3) of consecutive samples from sample_index
    collapses to ((n - 1) history + sum) / (n - 1 + S)."""
    n0 = float(sample_index)
    if current.dim() == 4:
        return (history * n0 + current.sum(0)) / (n0 + current.shape[0])
    return (history * n0 + current) / (n0 + 1.0)
