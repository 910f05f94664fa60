"""Port parity for what the raster frame traces through the scene BVH: RT
sun visibility (one any-hit sun ray per covered pixel, alpha-tested through
the cutout) and HBAO (ambient occlusion and bent normals), on the gbuffer
of make_rich_scene (floor, cutout screen, floating blocker, decal) at
48x24. The port renders the gbuffer; both packages trace from it, JAX
through its jnp BVH walk, the port through K4's twin. A binary horizon
search may flip at grazing edges, so 99.5% of the covered pixels must
agree. Then render_frame with scene_bvh: RT shadows darken the frame, and
the HBAO terms reach the sky lighting and the bent-normal view."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incarnation_tpu.config import Config as JConfig
from incarnation_tpu.core.view import View as JView
from incarnation_tpu.kernels import bvh as jbvh
from incarnation_tpu.kernels import hbao as jhbao
from incarnation_tpu.kernels import pathtrace as jpt
from incarnation_tpu.kernels.resolve import GBuffer as JGBuffer
from incarnation_tpu.renderer import frame as jframe
from incarnation_tpu.scene.testing import make_rich_scene
from incarnation_tpu_torch.config import Config as TConfig
from incarnation_tpu_torch.config import ViewMode
from incarnation_tpu_torch.core import mathutils as tmu
from incarnation_tpu_torch.core.view import View as TView
from incarnation_tpu_torch.kernels import bvh as tbvh
from incarnation_tpu_torch.kernels import hbao as thbao
from incarnation_tpu_torch.kernels import ibl as tibl
from incarnation_tpu_torch.kernels.raster import RasterParams as TParams
from incarnation_tpu_torch.renderer import frame as tframe
from incarnation_tpu_torch.scene import loader as tloader

torch.set_num_threads(1)

W, H = 48, 24
MIN_SHARE = 0.995
# make_rich_scene's normals face -z: a sun on that side lights them, and
# the cutout screen and the blocker shade the floor behind them
SUN = np.asarray([0.3, 0.7, -0.55], np.float32) / np.linalg.norm(
    [0.3, 0.7, -0.55])
EYE, TARGET = [1.0, 2.5, -2.0], [0.0, -1.0, 7.0]
FRAME_INDEX = 5
CFG = dict(masked_depth_peels=4, enable_taa=False, sun_shadow_mode="rt",
           enable_hbao=True, use_bent_normals=True)


@pytest.fixture(scope="module")
def setup():
    js = make_rich_scene()
    ts = tloader.scene_from_arrays(*tloader.scene_arrays(js), "cpu")
    jb = jbvh.build_scene_bvh(js, use_cache=False)
    tb = tbvh.build_scene_bvh(ts, use_cache=False, device="cpu")
    tcfg = TConfig(**CFG)
    fkw = dict(sun_dir=SUN, sun_color_intensity=[1.0, 1.0, 1.0, 100.0],
               frame_index=FRAME_INDEX)
    tfc = tframe.FrameConstants.make(
        TView.from_lookat(EYE, TARGET, aspect=W / H), tcfg, device="cpu",
        **fkw)
    jfc = jframe.FrameConstants.make(
        JView.from_lookat(EYE, TARGET, aspect=W / H), JConfig(**CFG), **fkw)
    params = TParams(width=W, height=H, pair_capacity=4096, bin_max_span=8,
                     big_tri_capacity=64)
    out = tframe.render_frame(ts, tfc, config=tcfg, params=params,
                              scene_bvh=tb)
    gb = out["gbuffer"]
    jgb = JGBuffer(*(jnp.asarray(getattr(gb, f).numpy())
                     for f in JGBuffer._fields))
    return dict(js=js, ts=ts, jb=jb, tb=tb, tfc=tfc, jfc=jfc, gb=gb,
                jgb=jgb, out=out, params=params, tcfg=tcfg)


def test_rt_sun_visibility_matches_jax(setup):
    s = setup
    gb = s["gb"]
    mask = gb.mask.numpy()
    assert mask.mean() > 0.5
    t = tframe.rt_sun_visibility(s["ts"], s["tb"], gb, s["tfc"]).numpy()
    origins = jnp.asarray(gb.world_pos.numpy().reshape(-1, 3))
    dirs = jnp.broadcast_to(jnp.asarray(SUN), origins.shape)
    occ = jpt._trace_alpha(s["js"], s["jb"], origins, dirs, 0.1, 1000.0,
                           jnp.uint32(FRAME_INDEX), any_hit=True)["tri"] >= 0
    j = 1.0 - np.asarray(occ).reshape(H, W).astype(np.float32)
    assert (t[mask] == j[mask]).mean() >= MIN_SHARE
    assert 0.0 < (t[mask] == 0).mean() < 1.0         # some shadow, not all
    assert (t[~mask] == 1.0).all()


def test_hbao_matches_jax(setup):
    s = setup
    ao_j, bent_j = jax.jit(jhbao.hbao, static_argnums=(4, 5))(
        s["jb"], s["jgb"], jnp.zeros((H, W)), s["jfc"], W, H)
    ao_t, bent_t = thbao.hbao(s["tb"], s["gb"], None, s["tfc"], W, H)
    mask = s["gb"].mask.numpy()
    ok = (np.isclose(ao_t.numpy(), np.asarray(ao_j), rtol=0, atol=1e-4)
          & np.isclose(bent_t.numpy(), np.asarray(bent_j), rtol=0,
                       atol=1e-4).all(-1))
    assert ok[mask].mean() >= MIN_SHARE
    ao = ao_t.numpy()
    assert (ao >= 0).all() and (ao <= 1).all() and (ao[~mask] == 1).all()
    assert 0.0 < ao[mask].mean() < 1.0 and (ao[mask] < 0.999).any()
    n = tmu.oct_decode(bent_t)
    torch.testing.assert_close(torch.linalg.vector_norm(n, dim=-1),
                               torch.ones(H, W), rtol=0, atol=1e-5)


def test_frame_with_scene_bvh(setup):
    """RT shadows darken the frame against no shadows; "auto" with a BVH is
    "rt"; HBAO scales the sky lighting; the bent-normal view shows the
    bent normals; the frame is finite."""
    s = setup
    ts, tb, tfc, params = s["ts"], s["tb"], s["tfc"], s["params"]
    out = s["out"]

    def render(**kw):
        return tframe.render_frame(ts, tfc, config=s["tcfg"].replace(**kw),
                                   params=params, scene_bvh=tb)

    assert torch.isfinite(out["hdr"]).all()
    off = render(sun_shadow_mode="off")
    assert float(out["hdr"].mean()) < float(off["hdr"].mean())
    torch.testing.assert_close(render(sun_shadow_mode="auto")["hdr"],
                               out["hdr"], rtol=0, atol=0)

    # a constant-radiance probe
    probe = tibl.build_probe(torch.ones(8, 16, 3), envmap_size=8,
                             num_samples=16)
    lut = tibl.pack_env_brdf(tibl.env_brdf_lut(16, 64, device="cpu"))
    sky = dict(sun_shadow_mode="off")
    with_ao = tframe.render_frame(ts, tfc, config=s["tcfg"].replace(**sky),
                                  params=params, scene_bvh=tb, probe=probe,
                                  env_brdf=lut)
    no_ao = tframe.render_frame(
        ts, tfc, config=s["tcfg"].replace(enable_hbao=False, **sky),
        params=params, scene_bvh=tb, probe=probe, env_brdf=lut)
    assert float(with_ao["hdr"].mean()) < float(no_ao["hdr"].mean())

    bent = render(viewmode=ViewMode.BENT_NORMALS)["color"]
    plain = tframe.render_frame(
        ts, tfc, config=s["tcfg"].replace(viewmode=ViewMode.BENT_NORMALS),
        params=params)["color"]
    assert (bent != plain).any()

