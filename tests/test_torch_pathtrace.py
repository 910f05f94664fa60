"""Port parity for the path tracer: render_pathtrace (trace_sample +
integrate + tonemap) at 32x16 in both packages on the same scene, BVH,
probe and camera. The JAX sample runs jitted on the CPU (its BVH trace a
jnp while-loop); the port runs K4's twin. Two JAX compiles: one batched
sample (S=2) of an emissive room with two point lights under the dynamic
sky and a scene rotation, one sample of the room with six lights (the
one-light pick) under a sky probe (the sky sample, the envmap miss). The
scenes have no alpha-masked prims, so no ray peels and every draw of a
pixel is the same in both packages. The sky sample's NoV clamp, the
port's divergence from JAX, is tested on its own."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incarnation_tpu.config import Config as JConfig
from incarnation_tpu.config import EnvSkyMode as JSky
from incarnation_tpu.core.view import View as JView
from incarnation_tpu.kernels import bvh as jbvh
from incarnation_tpu.kernels import ibl as jibl
from incarnation_tpu.kernels import sky as jsky
from incarnation_tpu.renderer import frame as jframe
from incarnation_tpu.scene import lights as jlights
from incarnation_tpu.scene.testing import make_scene
from incarnation_tpu_torch.config import Config as TConfig
from incarnation_tpu_torch.core.view import View as TView
from incarnation_tpu_torch.kernels import bvh as tbvh
from incarnation_tpu_torch.kernels import ibl as tibl
from incarnation_tpu_torch.kernels import pathtrace as tpt
from incarnation_tpu_torch.renderer import frame as tframe
from incarnation_tpu_torch.scene import loader as tloader

torch.set_num_threads(1)

W, H = 32, 16
# a pixel agrees when every channel is within RTOL of JAX's (+ ATOL): the
# same draws and the same arithmetic, rounded by different libraries
# (XLA's fused multiply-adds, its cos / sin / pow), amplified by bounces
RTOL, ATOL = 1e-4, 1e-4
MIN_PIXELS = 0.99
ROT = 0.4


def room(n_lights, emissive):
    """A room seen from the origin: back wall (z = 9), floor (y = -3),
    left wall (x = -5), a tilted panel; point lights inside."""
    quads = [([-8, -3, 9], [8, -3, 9], [8, 6, 9], [-8, 6, 9], [0, 0, -1]),
             ([-8, -3, 1], [-8, -3, 9], [8, -3, 9], [8, -3, 1], [0, 1, 0]),
             ([-5, -3, 1], [-5, 6, 1], [-5, 6, 9], [-5, -3, 9], [1, 0, 0]),
             ([1, -2, 5], [3, -2, 6], [3, 1, 6], [1, 1, 5], [-0.45, 0, -0.9])]
    pts, nrm, tris = [], [], []
    for q in quads:
        b = len(pts)
        pts += q[:4]
        nrm += [q[4]] * 4
        tris += [[b, b + 1, b + 2], [b, b + 2, b + 3]]
    nrm = np.asarray(nrm, np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    defs, xfs = [], []
    for i in range(n_lights):
        t = np.eye(4, dtype=np.float32)
        t[3, :3] = [-3.0 + 1.3 * i, 1.5 - 0.4 * i, 3.5 + 0.5 * i]
        defs.append(dict(type="point", color=[1.0, 0.9 - 0.1 * i, 0.8],
                         intensity=20.0 + 5 * i))
        xfs.append(t)
    scene = make_scene(np.asarray(pts, np.float32), tris, normals=nrm,
                       lights=jlights.build_light_table(defs, xfs))
    mp = np.array(scene.mat_params)
    mp[:, 8] = 0.6                        # roughness factor
    if emissive:
        mp[:, 0:3] = [0.0004, 0.0002, 0.0001]
    scene = dataclasses.replace(scene, mat_params=jnp.asarray(mp))
    return scene, tloader.scene_from_arrays(*tloader.scene_arrays(scene),
                                            "cpu")


def probe_pair():
    """A small sky probe in JAX and the same probe carried to the port."""
    sun = np.asarray([0.3, 0.8, 0.5], np.float32)
    jp = jibl.build_probe(jsky.sky_latlong(jnp.asarray(sun / np.linalg.norm(
        sun)), 2.0, 32, 16), envmap_size=16, num_samples=64)
    arrays = {"sh": np.asarray(jp.sh), "envmap.packed": True,
              "prefiltered.packed": True}
    for c in ("envmap", "prefiltered"):
        for a in ("flat", "size", "num_levels", "bases"):
            arrays[f"{c}.{a}"] = np.asarray(getattr(getattr(jp, c), a))
    return jp, tibl.probe_from_arrays(arrays, "cpu")


def _rotation(angle):
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, 0, -s, 0], [0, 1, 0, 0], [s, 0, c, 0],
                     [0, 0, 0, 1]], np.float32)


def _render_both(n_lights, emissive, cfg_kw, sample_index, rotation=None,
                 probe=False):
    js, ts = room(n_lights, emissive)
    jb = jbvh.build_scene_bvh(js, use_cache=False)
    tb = tbvh.build_scene_bvh(ts, use_cache=False, device="cpu")
    jcfg, tcfg = JConfig(**cfg_kw), TConfig(**cfg_kw)
    view = dict(position=[0.5, 0.5, -1.0], target=[0.0, -0.5, 8.0])
    jv = JView.from_lookat(view["position"], view["target"], aspect=W / H)
    tv = TView.from_lookat(view["position"], view["target"], aspect=W / H)
    fkw = dict(sun_dir=np.asarray([0.3, 0.8, 0.5], np.float32) / np.linalg
               .norm([0.3, 0.8, 0.5]), scene_rotation=rotation)
    jfc = jframe.FrameConstants.make(jv, jcfg, **fkw)
    tfc = tframe.FrameConstants.make(tv, tcfg, device="cpu", **fkw)
    jp, tp = probe_pair() if probe else (None, None)
    hist = np.full((H, W, 3), 0.25, np.float32)
    jo = jframe.render_pathtrace_jit(
        js, jb, jfc, jnp.asarray(hist),
        jnp.asarray(sample_index, jnp.uint32), jcfg, W, H, probe=jp)
    to = tframe.render_pathtrace(ts, tb, tfc, torch.tensor(hist),
                                 sample_index, config=tcfg, width=W,
                                 height=H, probe=tp)
    return jo, to, (ts, tb, tfc, tp, tcfg)


def _assert_close(jo, to):
    j, t = np.asarray(jo["history"]), to["history"].numpy()
    # finite and >= 0 (JAX's sky-sample term can turn negative:
    # test_sky_sample_term_clamps_nov)
    assert np.isfinite(t).all() and (t >= 0).all()
    ok = np.isclose(t, j, rtol=RTOL, atol=ATOL).all(-1).mean()
    assert ok >= MIN_PIXELS, ok
    assert float(to["rays"]) == float(jo["rays"])
    agree = (to["color"].numpy() == np.asarray(jo["color"])).all(-1).mean()
    assert agree >= MIN_PIXELS


@pytest.fixture(scope="module")
def batch_rotated():
    """Two samples as one batch (sample indices 4, 5) of the emissive room
    with two point lights, dynamic sky, the scene rotated by ROT."""
    cfg = dict(env_sky_mode=JSky.DYNAMIC_SKY, max_sample_count=16)
    return _render_both(2, True, cfg, [4, 5], rotation=_rotation(ROT))


@pytest.fixture(scope="module")
def probe_many_lights():
    """One sample (index 3) of the room with six lights under a probe."""
    cfg = dict(env_sky_mode=JSky.ENVIRONMENT_MAP, max_sample_count=256)
    return _render_both(6, False, cfg, 3, probe=True)


def test_batch_emissive_rotated_matches_jax(batch_rotated):
    jo, to, _ = batch_rotated
    _assert_close(jo, to)
    t = to["history"].numpy()
    assert t.mean() > 0.3 and (t > 1.0).any()      # lit and emissive


def test_probe_and_light_pick_match_jax(probe_many_lights):
    jo, to, _ = probe_many_lights
    _assert_close(jo, to)


def test_batch_equals_scalar_samples(batch_rotated):
    """A vector sample_index traces one S*H*W wavefront whose samples equal
    the scalar calls (port only: the CMJ patterns depend on the pixel and
    the draw, the index rides per ray)."""
    _, _, (ts, tb, tfc, _, cfg) = batch_rotated
    scene_b, fc_b, wn, wt = tframe.pathtrace_inputs(ts, tfc)
    kw = dict(sqrt_sample_count=4, sky_rot3=tfc.scene_rotation[:3, :3],
              sun_dir_world=tfc.sun_dir)
    both = tpt.trace_sample(scene_b, tb, wn, wt, fc_b, None, [4, 5], W, H,
                            **kw)
    for i, s in enumerate((4, 5)):
        one = tpt.trace_sample(scene_b, tb, wn, wt, fc_b, None, s, W, H,
                               **kw)
        torch.testing.assert_close(both[i], one, rtol=0, atol=0)


def test_band_rows_match_jax(batch_rotated):
    """pixel_base / full_height: a call that traces rows [5, 13) of the
    16-row frame (full-frame pixel ids, CMJ patterns and camera NDC)
    equals those rows of the whole-frame trace bit for bit, and its
    accumulated history matches JAX's whole frame there (the JAX package
    holds its band calls bit-identical to the whole frame,
    tests/test_dist.py::test_band_sharded_pathtrace_bit_exact)."""
    jo, _, (ts, tb, tfc, _, cfg) = batch_rotated
    r0, hb = 5, 8
    scene_b, fc_b, wn, wt = tframe.pathtrace_inputs(ts, tfc)
    kw = dict(sqrt_sample_count=4, dynamic_sky=True,
              turbidity=cfg.turbidity, sky_rot3=tfc.scene_rotation[:3, :3],
              sun_dir_world=tfc.sun_dir)
    full = tpt.trace_sample(scene_b, tb, wn, wt, fc_b, None, [4, 5], W, H,
                            **kw)
    band = tpt.trace_sample(scene_b, tb, wn, wt, fc_b, None, [4, 5], W, hb,
                            pixel_base=r0 * W, full_height=H, **kw)
    torch.testing.assert_close(band, full[:, r0:r0 + hb], rtol=0, atol=0)
    hist = tpt.integrate(torch.full((hb, W, 3), 0.25), band, 4).numpy()
    j = np.asarray(jo["history"])[r0:r0 + hb]
    ok = np.isclose(hist, j, rtol=RTOL, atol=ATOL).all(-1).mean()
    assert ok >= MIN_PIXELS, ok


def test_integrate_matches_jax():
    from incarnation_tpu.kernels import pathtrace as jpt
    rng = np.random.default_rng(0)
    h = rng.uniform(0, 2, (4, 6, 3)).astype(np.float32)
    c = rng.uniform(0, 2, (3, 4, 6, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tpt.integrate(torch.tensor(h), torch.tensor(c[0]), 5).numpy(),
        np.asarray(jpt.integrate(jnp.asarray(h), jnp.asarray(c[0]),
                                 jnp.asarray(5.0))), rtol=1e-6)
    np.testing.assert_allclose(
        tpt.integrate(torch.tensor(h), torch.tensor(c), 5).numpy(),
        np.asarray(jpt.integrate(jnp.asarray(h), jnp.asarray(c),
                                 jnp.asarray(5.0))), rtol=1e-6)


def test_sky_sample_term_clamps_nov():
    """Divergence (ROADMAP Queue 3, decided: keep the clamp): the sky
    sample's BRDF clamps NoV to [0, 1], as the direct light's BRDF of the
    same reference file (lighting/common.hlsli:118-139) does in both
    packages (shading.brdf_response). Where the normal faces the eye the
    term equals JAX's; where it faces away, JAX's unclamped NoV makes the
    term negative or a firefly, and the port's stays >= 0. Both sides are
    pinned at one input: JAX's term there is about -1.1e5 per channel, the
    port's a small positive radiance."""
    from incarnation_tpu.kernels import pathtrace as jpt
    jp, tp = probe_pair()
    rng = np.random.default_rng(9)
    n_pts = 4000

    def unit(x):
        return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(
            np.float32)

    args = [rng.uniform(0, 1, (n_pts, 2)).astype(np.float32),
            rng.uniform(0, 1, (n_pts, 3)).astype(np.float32),
            rng.uniform(0, 1, n_pts).astype(np.float32),
            rng.uniform(0.05, 1, n_pts).astype(np.float32),
            unit(rng.normal(size=(n_pts, 3))),
            unit(rng.normal(size=(n_pts, 3)))]
    jd, jt = jpt._sky_sample_term(jp, 2.0, *map(jnp.asarray, args))
    td, tt = tpt._sky_sample_term(tp, 2.0, *map(torch.tensor, args))
    jt, tt = np.asarray(jt), tt.numpy()
    # the cosine sample's z = sqrt(1 - r^2) turns an ulp of cos / sin into
    # up to 1e-5 near the rim (test_torch_sampling.py)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5)
    facing = np.sum(args[4] * args[5], -1) >= 0
    np.testing.assert_allclose(tt[facing], jt[facing], rtol=1e-4, atol=1e-5)
    assert (tt >= 0).all()
    assert (jt[~facing] < 0).any()
    # one input with the normal facing away (n . v = -0.7266): JAX's term
    # and the port's, as measured on the CPU build of both packages
    i = 3824
    assert not facing[i]
    np.testing.assert_allclose(jt[i], [-107339.39, -123800.195, -122742.73],
                               rtol=1e-3)
    np.testing.assert_allclose(tt[i], [0.15076, 0.49635, 0.26009],
                               rtol=1e-3)
