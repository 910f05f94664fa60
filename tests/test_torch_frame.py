"""Port parity for the whole raster frame: render_frame on make_rich_scene
(opaque floor, alpha-masked quad, decal, point and spot light) at 256x128,
three TAA frames with a moving, jittered camera, in both packages with the
same probe carried across, once with the sun shadow map off and once with
it on (256 x 256 texels). The JAX frame runs its Pallas kernels in
interpret mode; the port runs its plain twins on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incarnation_tpu.config import Config as JConfig
from incarnation_tpu.core import mathutils as jmu
from incarnation_tpu.core.view import View as JView
from incarnation_tpu.kernels import ibl as jibl
from incarnation_tpu.kernels import sky as jsky
from incarnation_tpu.kernels.raster import RasterParams as JParams
from incarnation_tpu.renderer import frame as jframe
from incarnation_tpu.scene.testing import make_rich_scene
from incarnation_tpu_torch.config import Config as TConfig
from incarnation_tpu_torch.core import mathutils as tmu
from incarnation_tpu_torch.core.view import View as TView
from incarnation_tpu_torch.kernels import ibl as tibl
from incarnation_tpu_torch.kernels import shadow as tshadow
from incarnation_tpu_torch.kernels.raster import RasterParams as TParams
from incarnation_tpu_torch.renderer import frame as tframe
from incarnation_tpu_torch.scene import loader as tloader

torch.set_num_threads(1)

W, H = 256, 128
FRAMES = 3
# the stochastic estimators off in the JAX Config too; the sun shadow map
# off here, on in SHADOW_CFG
CFG = dict(stochastic_mip=False, stochastic_bilinear=False,
           checkerboard_gathers=False, peel_chunk_capacity=0,
           decal_chunk_capacity=0, masked_depth_peels=4,
           sun_shadow_mode="off")
SHADOW_CFG = dict(CFG, sun_shadow_mode="map", shadow_map_resolution=256)
SHADOW_BOUNDS = ([0.0, 0.75, 8.0], 13.0)    # encloses make_rich_scene
# make_rich_scene's vertex normals all face -z: a sun in front of them, so
# that the sun term (and with it the shadow map) shows in the image
SHADOW_SUN = np.asarray([0.2, 0.8, -0.55]) / np.linalg.norm([0.2, 0.8, -0.55])
RASTER = dict(width=W, height=H, pair_capacity=4096, bin_max_span=8,
              big_tri_capacity=64)


def _probe_pair(sun):
    """The JAX probe and the same probe carried to the port."""
    jp = jibl.build_probe(jsky.sky_latlong(jnp.asarray(sun), 2.0, 32, 16),
                          envmap_size=16, num_samples=64)
    arrays = {"sh": np.asarray(jp.sh),
              "envmap.packed": True, "prefiltered.packed": True}
    for c in ("envmap", "prefiltered"):
        for a in ("flat", "size", "num_levels", "bases"):
            arrays[f"{c}.{a}"] = np.asarray(getattr(getattr(jp, c), a))
    return jp, tibl.probe_from_arrays(arrays, "cpu")


def _render_frames(cfg, shadow_bounds=None, sun=None, port_only=False):
    """FRAMES TAA frames of make_rich_scene in both packages -> [(jax
    out, port out)]; one JAX compile (the config is a static argument).
    port_only renders frame 0 alone and skips JAX (its out is None)."""
    jscene = make_rich_scene()
    tscene = tloader.scene_from_arrays(*tloader.scene_arrays(jscene), "cpu")
    jcfg, tcfg = JConfig(**cfg), TConfig(**cfg)
    jparams, tparams = JParams(chunk=32, **RASTER), TParams(**RASTER)
    sun = np.asarray(jscene.sun_dir if sun is None else sun, np.float32)
    jprobe, tprobe = _probe_pair(sun)
    jbrdf = jibl.pack_env_brdf(jibl.env_brdf_lut(16))
    tbrdf = torch.tensor(np.asarray(jbrdf))
    jitter = np.asarray(jmu.halton_jitter_table(16))
    jhist, thist = jnp.zeros((H, W, 3)), torch.zeros((H, W, 3))
    prev, out = None, []
    for i in range(1 if port_only else FRAMES):
        eye, target = [0.05 * i, 1.0, 3.5], [0.05 * i, -1.5, 6.0]
        kw = dict(sun_dir=sun, sun_color_intensity=[1.0, 1.0, 1.0, 100.0],
                  jitter=jitter[i % 16] * 2.0 / np.array([W, H]),
                  prev_view_proj=prev, history_valid=i > 0, frame_index=i,
                  shadow_bounds=shadow_bounds)
        jfc = jframe.FrameConstants.make(
            JView.from_lookat(eye, target, aspect=W / H), jcfg, **kw)
        tfc = tframe.FrameConstants.make(
            TView.from_lookat(eye, target, aspect=W / H), tcfg,
            device="cpu", **kw)
        j = None if port_only else jframe.render_frame_jit(
            jscene, jfc, jcfg, jparams, jprobe, jbrdf, jhist)
        t = tframe.render_frame(tscene, tfc, config=tcfg, params=tparams,
                                probe=tprobe, env_brdf=tbrdf, history=thist)
        prev = np.asarray(jfc.view_proj)
        jhist = None if port_only else j["accumulation"]
        thist = t["accumulation"]
        out.append((j, t, _u16_flips(tscene, tfc, tcfg, t)))
    return out


def _u16_flips(tscene, tfc, tcfg, t):
    """(H, W) bool: the pixels whose sun visibility changes when the port's
    f32 shadow map is rounded to u16, as the JAX package stores it. On
    these (a caster meeting its receiver, the depth compare within a u16
    step of its threshold) the two packages may shade differently."""
    if tcfg.sun_shadow_mode != "map":
        return torch.zeros(t["tri"].shape, dtype=torch.bool)
    res = tcfg.shadow_map_resolution
    depth, _ = tshadow.render_sun_shadow_map(
        tscene, tfc.scene_rotation, tfc.sun_view_proj,
        tshadow.shadow_params(res, tcfg))
    gb = t["gbuffer"]
    ndl = torch.sum(tmu.oct_decode(gb.normals) * tfc.sun_dir, -1)
    vis = [tshadow.sun_visibility(gb.world_pos, ndl, d, tfc.sun_view_proj,
                                  res)
           for d in (depth, torch.round(depth * 65535.0) / 65535.0)]
    return gb.mask & (vis[0] != vis[1])


@pytest.fixture(scope="module")
def frames():
    return _render_frames(CFG)


@pytest.fixture(scope="module")
def shadowed_frames():
    return (_render_frames(SHADOW_CFG, SHADOW_BOUNDS, SHADOW_SUN),
            _render_frames(dict(SHADOW_CFG, sun_shadow_mode="off"),
                           sun=SHADOW_SUN, port_only=True))


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return np.inf if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)


@pytest.mark.parametrize("i", range(FRAMES))
def test_frame_matches_jax(frames, i):
    """Per frame: the stats equal; tri exactly outside equal-depth ties
    (< 0.1% of pixels); depth to 1e-6 relative; hdr and the TAA
    accumulation to 2e-2 of each pixel's value + 1e-3 of the frame's peak
    (the analytic env-BRDF polynomial's f32 conditioning,
    test_torch_lighting.py::test_env_brdf_matches_jax, dominates); the
    u8 colour to >= 50 dB PSNR."""
    _assert_frame(*frames[i][:2])


@pytest.mark.parametrize("i", range(FRAMES))
def test_shadowed_frame_matches_jax(shadowed_frames, i):
    """The same with the sun shadow map on, at the same tolerances, plus
    shadow_bin_overflow equal (and 0). JAX's u16 map and the port's f32
    map shadow the same pixels but for the few whose depth compare is
    within a u16 step of its threshold (_u16_flips, under 0.1% of the
    frame): those are left out of the hdr and accumulation comparison and
    stay in the PSNR."""
    j, t, flips = shadowed_frames[0][i]
    assert int(t["stats"]["shadow_bin_overflow"]) \
        == int(np.asarray(j["stats"]["shadow_bin_overflow"])) == 0
    assert float(flips.float().mean()) < 1e-3
    _assert_frame(j, t, ~flips.numpy())


def test_shadow_map_darkens_the_frame(shadowed_frames):
    """Against the port's same frames with the map off: the blocker's and
    the masked quad's shadows take light out of some pixels, and nowhere
    add any."""
    shadowed = shadowed_frames[0][0][1]["hdr"]
    lit = shadowed_frames[1][0][1]["hdr"]
    # the sun term is a few percent of the sky-lit floor's radiance
    darker = ((lit - shadowed).sum(-1) > 1e-2 * lit.sum(-1)).float().mean()
    assert 0.01 < float(darker) < 0.9
    assert bool((shadowed <= lit + 1e-5 * lit.abs().max()).all())


def _assert_frame(j, t, where=None):
    for k, v in j["stats"].items():
        if k in t["stats"]:
            assert int(t["stats"][k]) == int(np.asarray(v)), k
    assert int(t["stats"]["peel_overflow"]) == 0
    jt, tt = np.asarray(j["tri"]), t["tri"].numpy()
    assert (jt != tt).mean() < 1e-3
    assert (tt >= 0).mean() > 0.5
    np.testing.assert_allclose(t["depth"].numpy(), np.asarray(j["depth"]),
                               rtol=1e-6, atol=1e-7)
    for key in ("hdr", "accumulation"):
        a, b = t[key].numpy(), np.asarray(j[key])
        assert np.isfinite(a).all()
        atol = 1e-3 * np.abs(b).max()
        if where is not None:
            a, b = a[where], b[where]
        np.testing.assert_allclose(a, b, rtol=2e-2, atol=atol, err_msg=key)
    tc, jc = t["color"].numpy(), np.asarray(j["color"])
    assert tc.shape == jc.shape == (H, W, 3) and tc.dtype == np.uint8
    assert _psnr(tc, jc) >= 50.0
