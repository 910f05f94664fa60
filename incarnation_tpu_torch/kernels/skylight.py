"""Sky / image-based lighting pass + environment background (port of
incarnation_tpu/kernels/skylight.py).

diffuse = SH9 cosine-convolved irradiance x5, specular = GGX-prefiltered
envmap by roughness x env-BRDF, both x SkyBrightness and AO-blended. The
exact probe fetch is trilinear. While TAA accumulates the frame may ask
for the stochastic one (dither, the frame index): one dithered mip, with
uv_dither one jittered texel of a packed probe's RGBE table, with extras
one lobe a pixel (the clearcoat lobe with probability fc), and with
checker_parity the checkerboard half-rate probe fetch (kernels/
checker.py). Every noise is resolve.frame_noise of the pixel's
whole-frame position (row0: a band's first row).

sky_lighting is K8 (csrc/skylight.cu) on CUDA tensors; on CPU tensors it
runs its plain twin, sky_lighting_plain, the torch code the kernel was
written from. environment_background's dynamic sky is K12 (csrc/
skylight.cu) on CUDA tensors, its add to the frame's HDR in the same
launch, and environment_background_plain on CPU ones."""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..core import mathutils as mu
from . import ibl, shading
from . import sky as sky_mod
from . import checker
from .build import Kernel, ptr
from .resolve import frame_noise

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# base_color, mrao, mask, n, v, bent normals, hbao, extras (NULL: none),
# sh, cube flat, cube rows, cube levels (host: bases then sizes), levels,
# packed cube, env-BRDF LUT, its size, Chebyshev table (host), sky
# brightness, flags, out, width, height, then the cube's RGBE table (NULL:
# none), the frame index, the checker parity and row0
K8 = Kernel("skylight", "k8_sky_lighting",
            [_P] * 10 + [_I, _P, _I, _I, _P, _I, _P, _F, _I, _P, _I, _I,
                         _P, _I, _I, _I])
# mask, eye, inv_view_proj, sun_dir, turbidity (a double), width, height,
# hdr (NULL: the background alone), out
K12 = Kernel("skylight", "k12_sky_background",
             [_P] * 4 + [ctypes.c_double, _I, _I, _P, _P])
# K8's flags (csrc/skylight.cu)
_DIFFUSE, _SPECULAR, _LIGHTING_ONLY, _ANALYTIC, _LUT_PACKED = 1, 2, 4, 8, 16
_DITHER, _JITTER, _CHECKER = 32, 64, 128
MAX_CUBE_LEVELS = 16
# K8's checkerboard kernel (csrc/skylight.cu k8_sky_checker_kernel): a
# row's span of K8C_PAIRS x-pairs, its fetching pixels and its halo in
# one warp
K8C_PAIRS = 31
K8C_SPAN = 2 * K8C_PAIRS
# frame_noise's channels, as the JAX package's sky_lighting seeds them
N_PROBE_LOD, N_PROBE_JX, N_PROBE_JY, N_LOBE = (2246822519, 3323198485,
                                              2654435769, 2357136044)


@functools.lru_cache(maxsize=None)
def _cheb_table():
    """ibl_fit_coeffs' CHEB_A then CHEB_B as 512 host floats, each the
    float32 the twin's coefficients round to. K8 and the twin take every
    coefficient (the JAX function skips those below 1e-9, and there are
    none)."""
    from . import ibl_fit_coeffs as fc
    table = np.asarray([fc.CHEB_A, fc.CHEB_B], np.float64)
    if table.shape != (2, 16, 16) or (np.abs(table) < 1e-9).any():
        raise ValueError("K8 evaluates two 16x16 tables of non-zero "
                         "Chebyshev coefficients")
    return (ctypes.c_float * 512)(*table.astype(np.float32).ravel())


@functools.lru_cache(maxsize=64)
def _cube_levels(bases: tuple, size: int, num_levels: int):
    """A cube's level bases then sizes as host ints (K8 takes them by
    value, one table per probe)."""
    if not 1 <= num_levels <= MAX_CUBE_LEVELS or len(bases) != num_levels:
        raise ValueError(f"K8 takes 1 to {MAX_CUBE_LEVELS} cube levels, got "
                         f"{num_levels} ({len(bases)} bases)")
    vals = list(bases) + [size >> l for l in range(num_levels)]
    return (ctypes.c_int * len(vals))(*vals)


def checker_fetch_lanes(mask, parity: int, row0: int = 0) -> int:
    """Lanes of one launch of K8's checkerboard kernel that fetch the
    probe, halos included. In an image row whose fetching parity is q,
    lane k of the span at x0 (a multiple of K8C_SPAN) takes the pixel
    x0 + 2 k - q, k <= K8C_PAIRS (csrc/skylight.cu
    k8_sky_checker_kernel); it fetches where that pixel lies in the image
    and it or a horizontal neighbour is covered."""
    m = mask.detach().to("cpu", torch.bool).numpy()
    h, w = m.shape
    near = m.copy()
    near[:, 1:] |= m[:, :-1]
    near[:, :-1] |= m[:, 1:]
    x0 = np.arange(0, w, K8C_SPAN)[:, None]
    total = 0
    for q in (0, 1):
        xs = (x0 + 2 * np.arange(K8C_PAIRS + 1) - q).ravel()
        xs = xs[(xs >= 0) & (xs < w)]
        rows = near[((np.arange(row0, row0 + h) + parity) & 1) == q]
        total += int(rows[:, xs].sum())
    return total


def _check(name, t, shape, dtype, dev, align=4):
    if t.dtype != dtype or t.device != dev or not t.is_contiguous() \
            or tuple(t.shape) != tuple(shape) or t.data_ptr() % align:
        raise ValueError(f"{name}: K8 needs a contiguous {dtype} tensor of "
                         f"shape {tuple(shape)} on {dev}, {align}-byte "
                         f"aligned; got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device} at {t.data_ptr() % 16} mod 16")


def sky_lighting(gb, n, v, probe: ibl.EnvironmentProbe, env_brdf,
                 sky_brightness, hbao=None, bent_normals=None,
                 diffuse_ibl: bool = True, specular_ibl: bool = True,
                 lighting_only: bool = False, extras=None,
                 analytic_env_brdf: bool = False, dither=None,
                 uv_dither: bool = False, checker_parity=None,
                 row0: int = 0):
    """Additive sky radiance for covered pixels (ref: sky-lighting.hlsl).
    hbao: (H, W) AO that scales the result; bent_normals: (H, W, 3) normals
    for the diffuse SH lookup. extras: gb.extras when the scene has
    transmission/clearcoat factors. env_brdf: the (S*S, 8) packed or (S, S,
    2) LUT, read unless analytic_env_brdf. dither, uv_dither,
    checker_parity, row0: the stochastic probe fetch (see the module). K8
    on CUDA tensors, the twin on CPU ones."""
    if not gb.mask.is_cuda:
        return sky_lighting_plain(
            gb, n, v, probe, env_brdf, sky_brightness, hbao, bent_normals,
            diffuse_ibl, specular_ibl, lighting_only, extras,
            analytic_env_brdf, dither, uv_dither, checker_parity, row0)
    dev = gb.mask.device
    h, w = gb.mask.shape
    f32 = torch.float32
    _check("mask", gb.mask, (h, w), torch.bool, dev, 1)
    _check("base_color", gb.base_color, (h, w, 4), f32, dev, 16)
    _check("mrao", gb.mrao, (h, w, 4), f32, dev, 16)
    _check("n", n, (h, w, 3), f32, dev)
    _check("v", v, (h, w, 3), f32, dev)
    for name, t, shape in (("bent_normals", bent_normals, (h, w, 3)),
                           ("hbao", hbao, (h, w)),
                           ("extras", extras, (h, w, 3))):
        if t is not None:
            _check(name, t, shape, f32, dev)
    _check("probe.sh", probe.sh, (9, 3), f32, dev)
    cube = probe.prefiltered
    _check("probe.prefiltered.flat", cube.flat, (cube.flat.shape[0], 3),
           f32, dev)
    levels = _cube_levels(tuple(int(b) for b in cube.bases), int(cube.size),
                          int(cube.num_levels))
    if row0 < 0:
        raise ValueError("sky_lighting: need row0 >= 0")
    flags = ((_DIFFUSE if diffuse_ibl else 0)
             | (_SPECULAR if specular_ibl else 0)
             | (_LIGHTING_ONLY if lighting_only else 0)
             | (_ANALYTIC if analytic_env_brdf else 0))
    rgbe = None
    if dither is not None:
        flags |= _DITHER
        if uv_dither and cube.packed:
            flags |= _JITTER
            rgbe = cube.rgbe_table()
            _check("probe.prefiltered.rgbe", rgbe, (cube.flat.shape[0],),
                   torch.int32, dev)
        if checker_parity is not None:
            if w % 2:
                raise ValueError("the checkerboard needs an even width")
            flags |= _CHECKER
    lut, lut_size = None, 0
    if specular_ibl and not analytic_env_brdf:
        lut = env_brdf
        if lut.dim() == 2:
            lut_size = int(round(np.sqrt(lut.shape[0])))
            _check("env_brdf", lut, (lut_size * lut_size, 8), f32, dev, 16)
            flags |= _LUT_PACKED
        else:
            lut_size = lut.shape[0]
            _check("env_brdf", lut, (lut_size, lut_size, 2), f32, dev, 8)
    out = torch.empty((h, w, 3), dtype=f32, device=dev)
    K8(ptr(gb.base_color), ptr(gb.mrao), ptr(gb.mask), ptr(n), ptr(v),
       ptr(bent_normals), ptr(hbao), ptr(extras), ptr(probe.sh),
       ptr(cube.flat), cube.flat.shape[0], levels, cube.num_levels,
       int(cube.packed), ptr(lut), lut_size,
       _cheb_table() if analytic_env_brdf else None, float(sky_brightness),
       flags, ptr(out), w, h, ptr(rgbe), int(dither or 0),
       int(checker_parity or 0) & 1, int(row0), name=_role_name(flags))
    return out


def _role_name(flags: int) -> str:
    """A K8 launch's role, the name its launches count under."""
    if not flags & _DITHER:
        return "exact"
    return ("jitter" if flags & _JITTER else "dither") \
        + ("_checker" if flags & _CHECKER else "")


def sky_lighting_plain(gb, n, v, probe: ibl.EnvironmentProbe, env_brdf,
                       sky_brightness, hbao=None, bent_normals=None,
                       diffuse_ibl: bool = True, specular_ibl: bool = True,
                       lighting_only: bool = False, extras=None,
                       analytic_env_brdf: bool = False, dither=None,
                       uv_dither: bool = False, checker_parity=None,
                       row0: int = 0):
    """K8's twin: sky_lighting in torch operations."""
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

    def noise(mult):
        return frame_noise(roughness.shape, dither, mult, roughness.device,
                           row0)

    def probe_fetch(r_, lod_, jitter_):
        """The prefiltered cube at lod_: trilinear, or with dither one
        dithered mip (and jitter_'s texel), checkerboarded where asked."""
        cube = probe.prefiltered
        if dither is None:
            return ibl.sample_cube(cube, r_, lod=lod_)
        if checker_parity is None:
            return ibl.sample_cube(cube, r_, lod=lod_, single_mip=True,
                                   jitter=jitter_)
        cp = int(checker_parity) & 1

        def half(a):
            return None if a is None else checker.compact(cp, a, row0)
        return checker.expand(cp, ibl.sample_cube(
            cube, half(r_), lod=half(lod_), single_mip=True,
            jitter=half(jitter_)), row0)

    if specular_ibl:
        no_v = torch.clamp(mu.dot3(n, v), min=0.01)
        f0 = metallic * base + (1.0 - metallic) * 0.04
        r = mu.normalize(2.0 * mu.dot3(v, n, keepdim=True) * n - v)
        mips = probe.prefiltered.num_levels
        jitter = None
        if dither is not None and uv_dither:
            jitter = torch.stack([noise(N_PROBE_JX), noise(N_PROBE_JY)], -1)
    if specular_ibl and extras is not None and dither is not None:
        # one lobe a pixel and frame: the clearcoat lobe with probability
        # fc (its weight), the base lobe otherwise -- the single-sample
        # estimator of the two-lobe mix, which the TAA accumulation
        # averages (skylight.py:86-119)
        cc = extras[..., 1:2]
        ccr = torch.clamp(extras[..., 2], min=0.03)
        fc = shading.f_schlick(no_v[..., None],
                               torch.full_like(cc, 0.04)) * cc
        pick_cc = noise(N_LOBE)[..., None] < fc
        lod_pick = torch.where(pick_cc[..., 0], ccr * (mips - 1),
                               roughness * (mips - 1))
        pre = probe_fetch(r, lod_pick + noise(N_PROBE_LOD), jitter)
        ab_b = env_brdf_at(no_v, roughness)
        ab_c = env_brdf_at(no_v, ccr)
        k_b = f0 * ab_b[..., 0:1] + ab_b[..., 1:2]
        k_c = 0.04 * ab_c[..., 0:1] + ab_c[..., 1:2]
        spec = pre * torch.where(pick_cc, k_c, k_b)
        radiance = radiance * (1.0 - fc)
        radiance = radiance + sky_brightness * (
            spec * (1 - ao_blend) + ao * spec * ao_blend)
    elif specular_ibl:
        lod = roughness * (mips - 1)
        if dither is not None:
            lod = lod + noise(N_PROBE_LOD)
        pre = probe_fetch(r, lod, jitter)
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
                           sky_brightness=25000.0, dynamic_sky: bool = True,
                           hdr=None):
    """Background radiance for uncovered pixels: 1000 x Preetham
    (dynamic sky) or sky_brightness x envmap, 0 where covered; given hdr
    (H, W, 3), hdr + that background in a new tensor (hdr is not
    modified). The dynamic sky on CUDA tensors is one K12 launch (csrc/
    skylight.cu), its add to hdr included; on CPU tensors, and the envmap
    role on every device, the twin environment_background_plain."""
    if not (dynamic_sky and mask.is_cuda):
        return environment_background_plain(
            mask, eye, inv_view_proj, width, height, probe, sun_dir,
            turbidity, sky_brightness, dynamic_sky, hdr=hdr)
    dev = mask.device
    for name, t, shape, dt in (("mask", mask, (height, width), torch.bool),
                               ("eye", eye, (3,), torch.float32),
                               ("inv_view_proj", inv_view_proj, (4, 4),
                                torch.float32),
                               ("sun_dir", sun_dir, (3,), torch.float32),
                               *((("hdr", hdr, (height, width, 3),
                                   torch.float32),) if hdr is not None
                                 else ())):
        if t is None or t.dtype != dt or t.device != dev \
                or not t.is_contiguous() or tuple(t.shape) != shape:
            raise ValueError(f"{name}: need a contiguous {shape} {dt} "
                             f"tensor on {dev}")
    out = torch.empty((height, width, 3), dtype=torch.float32, device=dev)
    K12(ptr(mask), ptr(eye), ptr(inv_view_proj), ptr(sun_dir),
        float(turbidity), width, height, ptr(hdr), ptr(out),
        name="background" if hdr is None else "accumulate")
    return out


def environment_background_plain(mask, eye, inv_view_proj, width, height,
                                 probe=None, sun_dir=None,
                                 turbidity: float = 2.0,
                                 sky_brightness=25000.0,
                                 dynamic_sky: bool = True, hdr=None):
    """K12's plain twin, and the envmap role: each pixel centre's view ray
    at reverse-Z depth 1e-4 (resolve.world_from_depth's arithmetic, its
    4x4 product summed left to right by mathutils.rows_mat), then the sky
    along it, 0 where covered; given hdr, hdr plus that (the frame's add,
    JAX's renderer/frame.py:397)."""
    xs, ys = mu.pixel_centers(height, width, mask.device)
    depth = torch.full((height, width), 1e-4, dtype=torch.float32,
                       device=mask.device)
    ndc = torch.stack([2.0 * xs / width - 1.0, -2.0 * ys / height + 1.0,
                       depth, torch.ones_like(depth)], dim=-1)
    wp = mu.rows_mat(ndc, inv_view_proj)
    wp = wp[..., :3] / torch.where(torch.abs(wp[..., 3:]) > 1e-20,
                                   wp[..., 3:], 1.0)
    d = mu.normalize(wp - eye)
    if dynamic_sky:
        rad = 1000.0 * sky_mod.sky_radiance(sun_dir, d, turbidity)
    else:
        rad = sky_brightness * ibl.sample_cube(probe.envmap, d)
    background = torch.where(mask[..., None], 0.0, rad)
    return background if hdr is None else hdr + background
