"""The raster frame with the JAX package's default Config: the stochastic
estimators (dithered mips and jittered texels of the material stack, the
alpha test and the probe, the anisotropic tap, the clearcoat lobe, the
jittered shadow tap, the checkerboard half-rate fetches) in a short TAA
sequence against JAX's frames, and the port's own quality gate under
camera motion (JAX tests/test_stochastic_motion.py): the estimators on
against off."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incarnation_tpu.config import Config as JConfig
from incarnation_tpu.core import mathutils as jmu
from incarnation_tpu.core.view import View as JView
from incarnation_tpu.kernels import ibl as jibl
from incarnation_tpu.kernels.raster import RasterParams as JParams
from incarnation_tpu.renderer import frame as jframe
from incarnation_tpu.scene.testing import make_rich_scene
from incarnation_tpu_torch.config import Config as TConfig, EnvSkyMode
from incarnation_tpu_torch.core import mathutils as tmu
from incarnation_tpu_torch.core.view import View as TView
from incarnation_tpu_torch.kernels import ibl as tibl
from incarnation_tpu_torch.kernels.raster import RasterParams as TParams
from incarnation_tpu_torch.renderer import frame as tframe
from incarnation_tpu_torch.scene import loader as tloader
from test_torch_frame import SHADOW_BOUNDS, SHADOW_SUN, _probe_pair, _psnr

torch.set_num_threads(1)

W, H = 64, 32
FRAMES = 4
# JAX's Config() but a smaller shadow map (the CPU test's time) and 4 peels
CFG = dict(sun_shadow_mode="map", shadow_map_resolution=128,
           masked_depth_peels=4)
RASTER = dict(width=W, height=H, pair_capacity=2048, bin_max_span=8,
              big_tri_capacity=64)
# the sequence's colour against JAX's, per frame: the discrete choices
# (texel, mip, lobe, shadow texel) are the same float decisions in both
# packages but where XLA fuses a multiply-add the port rounds twice, and
# the port's f32 shadow map against JAX's u16 one flips a few depth
# compares: a bounded share of pixels may differ
MIN_PSNR = 35.0              # dB, u8 colour
MAX_DIFFERING = 0.02         # share of pixels more than 8 levels apart


@pytest.fixture(scope="module")
def sequence():
    """FRAMES TAA frames of make_rich_scene with the default estimators in
    both packages, a moving and jittered camera, JAX's probe carried
    across -> [(jax out, port out, the port's frame with the estimators
    off on the same constants and history)]."""
    jscene = make_rich_scene()
    tscene = tloader.scene_from_arrays(*tloader.scene_arrays(jscene), "cpu")
    jcfg, tcfg = JConfig(**CFG), TConfig(**CFG)
    assert jcfg.stochastic_mip and tcfg.checkerboard_gathers
    jparams, tparams = JParams(chunk=32, **RASTER), TParams(**RASTER)
    jprobe, tprobe = _probe_pair(SHADOW_SUN)
    jbrdf = jibl.pack_env_brdf(jibl.env_brdf_lut(16))
    tbrdf = torch.tensor(np.asarray(jbrdf))
    jitter = np.asarray(jmu.halton_jitter_table(16))
    jhist, thist = jnp.zeros((H, W, 3)), torch.zeros((H, W, 3))
    prev, out = None, []
    for i in range(FRAMES):
        eye, target = [0.05 * i, 1.0, 3.5], [0.05 * i, -1.5, 6.0]
        kw = dict(sun_dir=SHADOW_SUN,
                  sun_color_intensity=[1.0, 1.0, 1.0, 100.0],
                  jitter=jitter[i % 16] * 2.0 / np.array([W, H]),
                  prev_view_proj=prev, history_valid=i > 0, frame_index=i,
                  shadow_bounds=SHADOW_BOUNDS)
        jfc = jframe.FrameConstants.make(
            JView.from_lookat(eye, target, aspect=W / H), jcfg, **kw)
        tfc = tframe.FrameConstants.make(
            TView.from_lookat(eye, target, aspect=W / H), tcfg,
            device="cpu", **kw)
        j = jframe.render_frame_jit(jscene, jfc, jcfg, jparams, jprobe,
                                    jbrdf, jhist)
        t = tframe.render_frame(tscene, tfc, config=tcfg, params=tparams,
                                probe=tprobe, env_brdf=tbrdf, history=thist)
        exact = tframe.render_frame(
            tscene, tfc, config=tcfg.replace(stochastic_mip=False),
            params=tparams, probe=tprobe, env_brdf=tbrdf, history=thist)
        prev = np.asarray(jfc.view_proj)
        jhist, thist = j["accumulation"], t["accumulation"]
        out.append((j, t, exact))
    return out


@pytest.mark.parametrize("i", range(FRAMES))
def test_default_config_sequence_matches_jax(sequence, i):
    """Per frame: the overflow stats equal (peel_chunk_overflow and
    decal_overflow among them, 0 here); tri outside equal-depth ties
    (< 0.1%); depth to 1e-6 relative; the u8 colour to MIN_PSNR with at
    most MAX_DIFFERING of the pixels more than 8 levels apart (measured:
    75.6-78.2 dB, none)."""
    j, t, _ = sequence[i]
    for k, v in j["stats"].items():
        if k.endswith("overflow"):
            assert int(t["stats"][k]) == int(np.asarray(v)), k
    assert int(t["stats"]["peel_chunk_overflow"]) == 0
    jt, tt = np.asarray(j["tri"]), t["tri"].numpy()
    assert (jt != tt).mean() < 1e-3 and (tt >= 0).mean() > 0.5
    np.testing.assert_allclose(t["depth"].numpy(), np.asarray(j["depth"]),
                               rtol=1e-6, atol=1e-7)
    tc, jc = t["color"].numpy(), np.asarray(j["color"])
    assert np.isfinite(t["accumulation"].numpy()).all()
    assert _psnr(tc, jc) >= MIN_PSNR
    far = (np.abs(tc.astype(int) - jc.astype(int)) > 8).any(-1)
    assert far.mean() <= MAX_DIFFERING


def test_estimators_change_the_frame(sequence):
    """The estimators run on every frame of the sequence (each has a
    history, zeros on frame 0, as bench.py gives it): each frame's hdr
    differs from the port's exact frame (stochastic_mip off) on the same
    constants and history."""
    for _, t, exact in sequence:
        assert not torch.equal(t["hdr"], exact["hdr"])


N_MOTION = 12
MW, MH = 128, 64


def _motion_sequence(scene, cfg, probe, brdf, params):
    """N_MOTION frames of a slow orbit (about 1.2 degrees a frame) with
    Halton jitter -> the last frame."""
    jit = tmu.halton_jitter_table(16)
    history, prev, out = torch.zeros((MH, MW, 3)), None, None
    for i in range(N_MOTION):
        a = 0.4 + 0.02 * i
        view = TView.from_lookat(
            [10.0 * np.sin(a), 5.0, 8.0 - 10.0 * np.cos(a)],
            [0.0, 0.0, 8.0], aspect=MW / MH)
        fc = tframe.FrameConstants.make(
            view, cfg, sun_dir=[0.0, 1.0, -0.2],
            sun_color_intensity=[1, 1, 1, 100.0],
            jitter=jit[i % 16] * 2.0 / np.array([MW, MH]),
            prev_view_proj=prev, history_valid=i > 0, frame_index=i,
            shadow_bounds=([0.0, 0.0, 8.0], 14.0), device="cpu")
        out = tframe.render_frame(scene, fc, config=cfg, params=params,
                                  probe=probe, env_brdf=brdf,
                                  history=history)
        history = out["accumulation"]
        prev = fc.view_proj.numpy()
    return out


def test_joint_stochastic_psnr_under_motion():
    """The JAX package's joint gate on the port: every estimator on
    (isotropic mips in both configs, whose expectation is the exact
    path's trilinear) against the exact pipeline on the same orbit, 12
    frames: the last frames' colours within 30 dB (JAX measured 57.9 dB
    on its gate), and not identical."""
    scene = tloader.scene_from_arrays(
        *tloader.scene_arrays(make_rich_scene()), "cpu")
    base = dict(env_sky_mode=EnvSkyMode.ENVIRONMENT_MAP,
                sun_shadow_mode="map", shadow_map_resolution=128,
                raster_tile_h=8, max_anisotropy=1)
    stoch = TConfig(**base)
    exact = TConfig(**base, stochastic_mip=False, stochastic_bilinear=False,
                    checkerboard_gathers=False)
    probe = tibl.build_probe(torch.full((8, 16, 3), 0.5), envmap_size=8,
                             num_samples=16)
    brdf = tibl.pack_env_brdf(tibl.env_brdf_lut(16, device="cpu"))
    params = TParams(width=MW, height=MH, tile_h=8, tile_w=128,
                     pair_capacity=1024, bin_max_span=8, big_tri_capacity=16)
    a = _motion_sequence(scene, stoch, probe, brdf, params)["color"]
    b = _motion_sequence(scene, exact, probe, brdf, params)["color"]
    psnr = _psnr(a.numpy(), b.numpy())
    assert 30.0 < psnr < np.inf, psnr
