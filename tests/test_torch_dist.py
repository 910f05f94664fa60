"""Band and SPP sharding over a list of torch devices: the band matrices
against the JAX package's; the port's sharded frame against the port's own
single frame and against JAX's single, unsharded render_frame on the same
scene, probe and constants (one JAX compile: the frame and the TAA frames
share a Config); the sharded path tracer against the port's single one
(which test_torch_pathtrace.py holds to JAX). All on ["cpu", "cpu"] (every
band and halo copy runs)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incarnation_tpu.config import Config as JConfig
from incarnation_tpu.core.view import View as JView
from incarnation_tpu.dist import sharding as jsharding
from incarnation_tpu.kernels import ibl as jibl
from incarnation_tpu.kernels.raster import RasterParams as JParams
from incarnation_tpu.renderer import frame as jframe
from incarnation_tpu.scene.testing import make_rich_scene
from incarnation_tpu_torch.config import Config, EnvSkyMode
from incarnation_tpu_torch.core.view import View
from incarnation_tpu_torch.dist import sharding
from incarnation_tpu_torch.kernels import bvh as tbvh
from incarnation_tpu_torch.core import mathutils as tmu
from incarnation_tpu_torch.kernels import ibl, raster
from incarnation_tpu_torch.kernels import shadow as tshadow
from incarnation_tpu_torch.renderer import frame
from incarnation_tpu_torch.scene import loader as tloader

torch.set_num_threads(1)

W, H = 128, 64
DEVICES = ["cpu", "cpu"]
# the tolerances tests/test_dist.py holds the JAX band frame to: u8 colour
# within 1 (the band matrix reassociates the projection), the TAA
# accumulation within 1e-2 relative + 2e-2
COLOR_ATOL = 1
ACC_RTOL, ACC_ATOL = 1e-2, 2e-2
# the frame's settings in both packages: the TPU-only approximations off,
# as tests/test_torch_frame.py runs JAX's frame
CFG = dict(env_sky_mode=EnvSkyMode.ENVIRONMENT_MAP, sun_shadow_mode="map",
           shadow_map_resolution=128, raster_tile_h=8, masked_depth_peels=2,
           stochastic_mip=False, stochastic_bilinear=False,
           checkerboard_gathers=False, peel_chunk_capacity=0,
           decal_chunk_capacity=0)
RASTER = dict(width=W, height=H, tile_h=8, tile_w=128, pair_capacity=2048,
              bin_max_span=8, big_tri_capacity=64)
CONSTANTS = dict(sun_dir=[0, 1.0, -0.2], sun_color_intensity=[1, 1, 1, 100],
                 shadow_bounds=([0.0, 0.0, 8.0], 14.0))


def test_band_projection_matches_jax():
    for n in (1, 2, 4):
        for i in range(n):
            np.testing.assert_array_equal(
                sharding.band_projection(n, i),
                np.asarray(jsharding.band_projection(n, jnp.asarray(i))))


@pytest.fixture(scope="module")
def rich():
    """make_rich_scene, a flat grey probe and the env BRDF, built by JAX
    and carried to the port, so both packages render the same inputs."""
    js = make_rich_scene()
    scene = tloader.scene_from_arrays(*tloader.scene_arrays(js), "cpu")
    jprobe = jibl.build_probe(jnp.full((8, 16, 3), 0.5), envmap_size=8,
                              num_samples=16)
    arrays = {"sh": np.asarray(jprobe.sh),
              "envmap.packed": True, "prefiltered.packed": True}
    for c in ("envmap", "prefiltered"):
        for a in ("flat", "size", "num_levels", "bases"):
            arrays[f"{c}.{a}"] = np.asarray(getattr(getattr(jprobe, c), a))
    probe = ibl.probe_from_arrays(arrays, "cpu")
    jbrdf = jibl.pack_env_brdf(jibl.env_brdf_lut(16))
    brdf = torch.tensor(np.asarray(jbrdf))
    cfg = Config(**CFG)
    params = raster.RasterParams(**RASTER)
    jax_side = (js, jprobe, jbrdf, JConfig(**CFG), JParams(chunk=32, **RASTER))
    return scene, probe, brdf, cfg, params, jax_side


def _constants(cfg, view, **kw):
    return frame.FrameConstants.make(view, cfg, device="cpu", **CONSTANTS,
                                     **kw)


def _jax_frame(jax_side, eye, target, history=None, prev=None, **kw):
    """JAX's single, unsharded render_frame of the same scene and
    constants."""
    js, jprobe, jbrdf, jcfg, jparams = jax_side
    jfc = jframe.FrameConstants.make(
        JView.from_lookat(eye, target, aspect=W / H), jcfg,
        prev_view_proj=None if prev is None else np.asarray(prev),
        **CONSTANTS, **kw)
    hist = jnp.zeros((H, W, 3)) if history is None else history
    return jframe.render_frame_jit(js, jfc, jcfg, jparams, jprobe, jbrdf,
                                   hist)


def _assert_matches_jax(band, single, j, cfg, fc, scene):
    """The port's band frame against JAX's single frame, at
    tests/test_torch_frame.py's tolerances: the overflow counters equal
    (the other stats count per band and are summed), tri outside
    equal-depth ties (under 0.1% of the pixels), depth to 1e-6 relative,
    hdr and accumulation to 2e-2 of each pixel + 1e-3 of the frame's peak
    (left out: the pixels whose sun visibility flips when the port's f32
    shadow map is rounded to JAX's u16), the u8 colour to >= 50 dB."""
    for k, v in j["stats"].items():
        if k.endswith("overflow") and k in band["stats"]:
            assert int(band["stats"][k]) == int(np.asarray(v)), k
    jt, bt = np.asarray(j["tri"]), band["tri"].numpy()
    assert (jt != bt).mean() < 1e-3
    np.testing.assert_allclose(band["depth"].numpy(), np.asarray(j["depth"]),
                               rtol=1e-6, atol=1e-7)
    res = cfg.shadow_map_resolution
    depth, _ = tshadow.render_sun_shadow_map(
        scene, fc.scene_rotation, fc.sun_view_proj,
        tshadow.shadow_params(res, cfg))
    gb = single["gbuffer"]
    ndl = torch.sum(tmu.oct_decode(gb.normals) * fc.sun_dir, -1)
    vis = [tshadow.sun_visibility(gb.world_pos, ndl, dm, fc.sun_view_proj,
                                  res)
           for dm in (depth, torch.round(depth * 65535.0) / 65535.0)]
    keep = ~(gb.mask & (vis[0] != vis[1])).numpy()
    assert keep.mean() > 0.999
    for key in ("hdr", "accumulation"):
        a, b = band[key].numpy(), np.asarray(j[key])
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a[keep], b[keep], rtol=2e-2,
                                   atol=1e-3 * np.abs(b).max(), err_msg=key)
    mse = np.mean((band["color"].numpy().astype(np.float64)
                   - np.asarray(j["color"]).astype(np.float64)) ** 2)
    assert mse == 0 or 10.0 * np.log10(255.0 ** 2 / mse) >= 50.0


def test_band_sharded_frame_matches_single(rich):
    """The whole frame (textures, masked peels, decals, clustered lights,
    probe IBL, the sun shadow map) in 2 bands: tri identical, colour and
    depth as tests/test_dist.py holds JAX's; stats summed over the bands."""
    scene, probe, brdf, cfg, params, jax_side = rich
    eye, target = [0.0, 1.0, -2.0], [0.0, 0.0, 7.0]
    fc = _constants(cfg, View.from_lookat(eye, target, aspect=W / H))
    kw = dict(config=cfg, params=params, probe=probe, env_brdf=brdf)
    single = frame.render_frame(scene, fc, **kw)
    band = sharding.render_frame_sharded(scene, fc, devices=DEVICES, **kw)
    assert int(single["stats"]["culled_lights"]) > 0
    assert (single["tri"] >= 0).float().mean() > 0.3
    assert torch.equal(band["tri"], single["tri"])
    torch.testing.assert_close(band["depth"], single["depth"], rtol=0,
                               atol=1e-6)
    assert int((band["color"].int() - single["color"].int()).abs().max()) \
        <= COLOR_ATOL
    assert set(band["stats"]) == set(single["stats"])
    assert int(band["stats"]["peel_overflow"]) == 0
    _assert_matches_jax(band, single, _jax_frame(jax_side, eye, target),
                        cfg, fc, scene)
    with pytest.raises(ValueError, match="whole"):
        sharding.render_frame_sharded(scene, fc, devices=["cpu"] * 3, **kw)


@pytest.mark.parametrize("eye1", [[0.0, 1.0, -2.0], [0.0, 1.6, -2.0]],
                         ids=["static", "moving"])
def test_band_sharded_taa_matches_single(rich, eye1):
    """A second TAA frame through the halos: a static camera (the static
    shift path) and a vertical dolly whose reprojection crosses the band
    seam (the fetch, with history halo rows from the other band): the
    accumulation, seam rows included, matches the single frame's; the
    moving camera's band frames also match JAX's single frames."""
    scene, probe, brdf, cfg, params, jax_side = rich
    cfg = cfg.replace(enable_taa=True)
    target = [0.0, 0.0, 7.0]
    v0 = View.from_lookat([0.0, 1.0, -2.0], target, aspect=W / H)
    v1 = View.from_lookat(eye1, target, aspect=W / H)
    fc0 = _constants(cfg, v0, history_valid=False)
    fc1 = _constants(cfg, v1, prev_view_proj=v0.view_proj(),
                     history_valid=True, frame_index=1)
    kw = dict(config=cfg, params=params, probe=probe, env_brdf=brdf)
    h0 = torch.zeros((H, W, 3))
    s0 = frame.render_frame(scene, fc0, history=h0, **kw)
    s1 = frame.render_frame(scene, fc1, history=s0["accumulation"], **kw)
    b0 = sharding.render_frame_sharded(scene, fc0, devices=DEVICES,
                                       history=h0, **kw)
    b1 = sharding.render_frame_sharded(scene, fc1, devices=DEVICES,
                                       history=b0["accumulation"], **kw)
    torch.testing.assert_close(b1["accumulation"], s1["accumulation"],
                               rtol=ACC_RTOL, atol=ACC_ATOL)
    # the history differs from the current frame: TAA did something
    assert float((s1["accumulation"] - s1["hdr"]).abs().max()) > 1e-3
    if eye1 == [0.0, 1.0, -2.0]:
        return
    j0 = _jax_frame(jax_side, [0.0, 1.0, -2.0], target)
    j1 = _jax_frame(jax_side, eye1, target, history=j0["accumulation"],
                    prev=v0.view_proj(), history_valid=True, frame_index=1)
    _assert_matches_jax(b0, s0, j0, cfg, fc0, scene)
    _assert_matches_jax(b1, s1, j1, cfg, fc1, scene)


@pytest.fixture(scope="module")
def pt_scene():
    """tests/test_dist.py's emissive two-triangle wall, as the port's."""
    from incarnation_tpu.scene.testing import make_scene
    from incarnation_tpu_torch.scene import loader
    pts = np.array([[-6, -4, 5], [6, -4, 5], [6, 4, 5], [-6, 4, 5]],
                   np.float32)
    js = make_scene(pts, [[0, 1, 2], [0, 2, 3]])
    mp = np.array(js.mat_params)
    mp[:, 0:3] = 0.001   # emissive so rays carry signal
    js = dataclasses.replace(js, mat_params=jnp.asarray(mp))
    scene = loader.scene_from_arrays(*loader.scene_arrays(js), "cpu")
    bvh = tbvh.build_scene_bvh(scene, use_cache=False, device="cpu")
    cfg = Config(env_sky_mode=EnvSkyMode.ENVIRONMENT_MAP,
                 max_sample_count=16)
    fc = frame.FrameConstants.make(View.default(aspect=16 / 8), cfg,
                                   device="cpu")
    return scene, bvh, cfg, fc


def test_band_pathtrace_bit_exact(pt_scene):
    """Band-sharded path tracing equals render_pathtrace bit for bit, a
    single sample and a batch of two; the counted rays add up."""
    scene, bvh, cfg, fc = pt_scene
    w, h = 16, 8
    hist = torch.zeros((h, w, 3))
    for idx in (0, [1, 2]):
        single = frame.render_pathtrace(scene, bvh, fc, hist, idx,
                                        config=cfg, width=w, height=h)
        band = sharding.pathtrace_band_sharded(
            scene, bvh, fc, hist, idx, config=cfg, width=w, height=h,
            devices=DEVICES)
        assert torch.equal(band["history"], single["history"])
        assert float(band["rays"]) == float(single["rays"]) > 0
        hist = single["history"]


def test_spp_sharded_matches_batch_mean(pt_scene):
    """Samples base, base + 1 traced on the two devices join the history
    by the batch-mean rule: the same as integrating the batch."""
    from incarnation_tpu_torch.kernels import pathtrace
    scene, bvh, cfg, fc = pt_scene
    w, h = 16, 8
    hist = frame.render_pathtrace(scene, bvh, fc, torch.zeros((h, w, 3)), 0,
                                  config=cfg, width=w, height=h)["history"]
    got = sharding.pathtrace_spp_sharded(scene, bvh, fc, hist, 1,
                                         config=cfg, width=w, height=h,
                                         devices=DEVICES)
    scene_b, fc_b, wn, wt = frame.pathtrace_inputs(scene, fc)
    cur = pathtrace.trace_sample(
        scene_b, bvh, wn, wt, fc_b, None, [1, 2], w, h, sqrt_sample_count=4,
        dynamic_sky=False, sky_rot3=fc.scene_rotation[:3, :3],
        sun_dir_world=fc.sun_dir)
    want = pathtrace.integrate(hist, cur, 1)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert float(want.max()) > 0


def test_per_device_copies():
    """per_device: one copy per distinct device, or the caller's list."""
    t = torch.ones(3)
    a, b = sharding.per_device(t, [torch.device("cpu")] * 2)
    assert a is b
    assert sharding.per_device([t, t], ["cpu", "cpu"]) == [t, t]
    with pytest.raises(ValueError):
        sharding.per_device([t], ["cpu", "cpu"])
