"""Port parity for the 14 view modes, pick and highlight, on make_rich_scene
at 128x64 with a sky probe. The JAX package compiles the frame once (NORMAL)
and once more for LIGHTING_ONLY, whose sky lighting differs; the other modes
are its _apply_viewmode on the NORMAL frame's buffers, as render_frame calls
it. The port renders a whole frame per mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incarnation_tpu.config import Config as JConfig
from incarnation_tpu.config import ViewMode
from incarnation_tpu.core import mathutils as jmu
from incarnation_tpu.core.view import View as JView
from incarnation_tpu.kernels import ibl as jibl
from incarnation_tpu.kernels import post as jpost
from incarnation_tpu.kernels import sky as jsky
from incarnation_tpu.kernels.raster import RasterParams as JParams
from incarnation_tpu.renderer import frame as jframe
from incarnation_tpu.scene.testing import make_rich_scene
from incarnation_tpu_torch.config import Config as TConfig
from incarnation_tpu_torch.config import ViewMode as TViewMode
from incarnation_tpu_torch.core.view import View as TView
from incarnation_tpu_torch.kernels import ibl as tibl
from incarnation_tpu_torch.kernels.raster import RasterParams as TParams
from incarnation_tpu_torch.renderer import frame as tframe
from incarnation_tpu_torch.scene import loader as tloader

torch.set_num_threads(1)

W, H = 128, 64
CFG = dict(stochastic_mip=False, stochastic_bilinear=False,
           checkerboard_gathers=False, peel_chunk_capacity=0,
           decal_chunk_capacity=0, masked_depth_peels=2,
           sun_shadow_mode="off", enable_taa=False, sky_brightness=3000.0)
RASTER = dict(width=W, height=H, pair_capacity=4096, bin_max_span=8,
              big_tri_capacity=64)
MODES = {name: v for name, v in vars(ViewMode).items()
         if isinstance(v, int) and not name.startswith("_")}
EYE, TARGET = [0.0, 1.0, 2.0], [0.0, 0.5, 7.0]
SUN = np.asarray([0.2, 0.8, -0.55]) / np.linalg.norm([0.2, 0.8, -0.55])


class _World:
    pass


@pytest.fixture(scope="module")
def world():
    w = _World()
    w.jscene = make_rich_scene()
    w.tscene = tloader.scene_from_arrays(*tloader.scene_arrays(w.jscene),
                                         "cpu")
    w.jprobe = jibl.build_probe(
        jsky.sky_latlong(jnp.asarray(SUN, jnp.float32), 2.0, 32, 16),
        envmap_size=16, num_samples=64)
    arrays = {"sh": np.asarray(w.jprobe.sh),
              "envmap.packed": True, "prefiltered.packed": True}
    for c in ("envmap", "prefiltered"):
        for a in ("flat", "size", "num_levels", "bases"):
            arrays[f"{c}.{a}"] = np.asarray(getattr(getattr(w.jprobe, c), a))
    w.tprobe = tibl.probe_from_arrays(arrays, "cpu")
    w.jbrdf = jibl.pack_env_brdf(jibl.env_brdf_lut(16))
    w.tbrdf = torch.tensor(np.asarray(w.jbrdf))
    w.kw = dict(sun_dir=SUN, sun_color_intensity=[1.0, 1.0, 1.0, 100.0])
    w.jout = {}
    return w


def _jax_frame(w, vm):
    """The JAX frame compiled for view mode vm (cached)."""
    if vm not in w.jout:
        cfg = JConfig(viewmode=vm, **CFG)
        fc = jframe.FrameConstants.make(
            JView.from_lookat(EYE, TARGET, aspect=W / H), cfg, **w.kw)
        w.jout[vm] = (cfg, fc, jframe.render_frame_jit(
            w.jscene, fc, cfg, JParams(chunk=32, **RASTER), w.jprobe,
            w.jbrdf))
    return w.jout[vm]


def _jax_color(w, vm):
    if vm == ViewMode.LIGHTING_ONLY:
        return np.asarray(_jax_frame(w, vm)[2]["color"])
    cfg, fc, out = _jax_frame(w, ViewMode.NORMAL)
    gb = out["gbuffer"]
    n = jmu.oct_decode(gb.normals)
    v = jmu.normalize(fc.eye - gb.world_pos)
    color = jframe._apply_viewmode(
        cfg.replace(viewmode=vm), w.jscene, gb, n, out["depth"], out["tri"],
        out["accumulation"], fc, v=v, probe=w.jprobe)
    return np.asarray(jpost.to_uint8(color))


def _port_frame(w, vm):
    cfg = TConfig(viewmode=vm, **CFG)
    fc = tframe.FrameConstants.make(
        TView.from_lookat(EYE, TARGET, aspect=W / H), cfg, device="cpu",
        **w.kw)
    return tframe.render_frame(w.tscene, fc, config=cfg,
                               params=TParams(**RASTER), probe=w.tprobe,
                               env_brdf=w.tbrdf)


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return np.inf if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)


def test_viewmode_tables_match():
    assert {n: v for n, v in vars(TViewMode).items()
            if isinstance(v, int) and not n.startswith("_")} == MODES
    assert len(MODES) == 14


@pytest.mark.parametrize("name", sorted(MODES, key=MODES.get))
def test_viewmode_matches_jax(world, name):
    """u8 colour >= 45 dB against JAX for every mode; the id modes (object
    and triangle ids hashed to colours) exactly, outside the pixels where
    an equal-depth tie picks another triangle (< 0.1%)."""
    vm = MODES[name]
    t = _port_frame(world, vm)
    tc, jc = t["color"].numpy(), _jax_color(world, vm)
    assert tc.shape == jc.shape == (H, W, 3) and tc.dtype == np.uint8
    assert _psnr(tc, jc) >= 45.0
    covered = t["tri"].numpy() >= 0
    if name in ("OBJECT_IDS", "TRIANGLE_IDS"):
        same = t["tri"].numpy() == np.asarray(
            _jax_frame(world, ViewMode.NORMAL)[2]["tri"])
        assert same.mean() > 0.999
        np.testing.assert_array_equal(tc[same], jc[same])
        assert tc[covered].sum(-1).min() > 0       # not black on geometry
        assert len(np.unique(tc[covered], axis=0)) >= 2
    if name not in ("EMISSIVE", "METALLIC"):
        assert tc[covered].any()


def test_lighting_only_differs_from_normal(world):
    a = _port_frame(world, ViewMode.NORMAL)["color"]
    b = _port_frame(world, ViewMode.LIGHTING_ONLY)["color"]
    assert not torch.equal(a, b)


def test_pick_matches_jax(world):
    """8 seeded pixels (4 of them drawn from the covered ones): the same
    (primitive, local triangle, meshlet) in both packages."""
    jt = np.asarray(_jax_frame(world, ViewMode.NORMAL)[2]["tri"])
    tt = _port_frame(world, ViewMode.NORMAL)["tri"]
    rng = np.random.default_rng(5)
    ys, xs = np.nonzero(jt >= 0)
    sel = rng.choice(len(ys), 4, replace=False)
    pixels = [(int(xs[i]), int(ys[i])) for i in sel] + [
        (int(rng.integers(W)), int(rng.integers(H))) for _ in range(4)]
    hits = 0
    for x, y in pixels:
        got = tframe.pick(world.tscene, tt, x, y)
        assert got == jframe.pick(world.jscene, jt, x, y)
        hits += got[0] >= 0
    assert hits >= 4
    sky = np.argwhere(jt < 0)[0]
    assert tframe.pick(world.tscene, tt, int(sky[1]), int(sky[0])) \
        == (-1, -1, -1)


def test_highlight_matches_jax(world):
    """The same u8 image and triangle map through both highlights: equal
    bytes; only the picked primitive's pixels change."""
    _, _, jout = _jax_frame(world, ViewMode.NORMAL)
    color, tri = np.asarray(jout["color"]), np.asarray(jout["tri"])
    seen = 0
    for prim in range(4):       # prim 3 is the decal: never in the tri map
        j = np.asarray(jframe.highlight(jout["color"], jout["tri"],
                                        world.jscene, prim))
        t = tframe.highlight(torch.tensor(color), torch.tensor(tri),
                             world.tscene, prim).numpy()
        np.testing.assert_array_equal(t, j)
        changed = (t != color).any(-1)
        owner = np.asarray(world.jscene.tri_prim)[np.maximum(tri, 0)]
        assert changed.any() == ((tri >= 0) & (owner == prim)).any()
        assert not changed[(tri < 0) | (owner != prim)].any()
        seen += bool(changed.any())
    assert seen >= 2
