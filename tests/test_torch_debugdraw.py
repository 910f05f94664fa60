"""Port parity for the debug draws (renderer/debugdraw.py): the line
splatter, the device append buffer, the rows the light culling and the
frustum cull append, and the frame wiring, against the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incarnation_tpu.config import Config as JConfig
from incarnation_tpu.core.view import View as JView
from incarnation_tpu.kernels import clustered as jclustered
from incarnation_tpu.kernels.raster import RasterParams as JParams
from incarnation_tpu.renderer import debugdraw as jdd
from incarnation_tpu.renderer import frame as jframe
from incarnation_tpu.scene.testing import make_rich_scene
from incarnation_tpu_torch.config import Config as TConfig
from incarnation_tpu_torch.core.view import View as TView
from incarnation_tpu_torch.kernels import clustered as tclustered
from incarnation_tpu_torch.kernels.raster import RasterParams as TParams
from incarnation_tpu_torch.renderer import debugdraw as tdd
from incarnation_tpu_torch.renderer import frame as tframe
from incarnation_tpu_torch.scene import loader as tloader

torch.set_num_threads(1)

W, H = 128, 64
CFG = dict(stochastic_mip=False, stochastic_bilinear=False,
           checkerboard_gathers=False, peel_chunk_capacity=0,
           decal_chunk_capacity=0, masked_depth_peels=1,
           sun_shadow_mode="off", enable_taa=False, env_sky_mode=0,
           show_light_bounds=True, show_object_bounds=True)
RASTER = dict(width=W, height=H, pair_capacity=4096, bin_max_span=8,
              big_tri_capacity=64)
EYE, TARGET = [0.0, 1.0, 2.0], [0.0, 0.5, 7.0]


def test_shape_builders_match_jax():
    """Host numpy, copied: bit-equal."""
    np.testing.assert_array_equal(tdd.box_edges([-1, 0, 2], [3, 1, 4]),
                                  jdd.box_edges([-1, 0, 2], [3, 1, 4]))
    np.testing.assert_array_equal(tdd.sphere_edges([1, 2, 3], 2.5, 12),
                                  jdd.sphere_edges([1, 2, 3], 2.5, 12))
    xf = np.eye(4, dtype=np.float32)
    xf[3, :3] = [1, 2, 3]
    xf[0, 0] = 2.0
    for shape in range(tdd.DebugShape.COUNT):
        np.testing.assert_array_equal(tdd.primitive_edges(shape, xf),
                                      jdd.primitive_edges(shape, xf))
    with pytest.raises(ValueError):
        tdd.primitive_edges(99)
    assert (tdd.DDRAW_CAP, tdd.DDRAW_SPHERE, tdd.DDRAW_BOX) \
        == (jdd.DDRAW_CAP, jdd.DDRAW_SPHERE, jdd.DDRAW_BOX)


def test_bounds_segments_match_jax():
    jscene = make_rich_scene()
    tscene = tloader.scene_from_arrays(*tloader.scene_arrays(jscene), "cpu")
    for a, b in zip(tdd.scene_bounds_segments(tscene),
                    jdd.scene_bounds_segments(jscene)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tdd.light_bounds_segments(tscene),
                    jdd.light_bounds_segments(jscene)):
        np.testing.assert_array_equal(a, b)


def _segments(seed, n=40):
    """Seeded segments around a camera at the origin looking down +z:
    most in view, some behind the eye, one far off screen, one
    non-finite; one colour for all (two colours on one pixel have no
    specified winner in either package)."""
    rng = np.random.default_rng(seed)
    seg = rng.uniform([-6, -3, 1.5], [6, 3, 14], (n, 2, 3)).astype(np.float32)
    seg[:4, 0, 2] = -3.0                   # cross the eye plane
    seg[4] = [[1e30, 0, 5], [-1e30, 0, 5]]
    seg[5] = [[np.nan, 0, 5], [0, np.inf, 5]]
    return seg, np.tile(np.asarray([[0.2, 0.9, 0.4]], np.float32), (n, 1))


@pytest.mark.parametrize("seed", [0, 1])
def test_draw_lines_matches_jax(seed):
    """The same drawn-pixel set and, with one colour, the same image; the
    depth test hides what lies behind the depth buffer's near half."""
    seg, cols = _segments(seed)
    rng = np.random.default_rng(seed + 10)
    color = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    depth = np.where(rng.random((H, W)) < 0.5, 0.0, 0.5).astype(np.float32)
    vp = TView.from_lookat([0, 0, 0], [0, 0, 5], aspect=W / H).view_proj()
    mask = np.arange(seg.shape[0]) % 5 != 2
    for m in (None, mask):
        j = np.asarray(jdd.draw_lines(
            jnp.asarray(color), jnp.asarray(depth), seg, cols,
            jnp.asarray(vp), samples_per_segment=64,
            seg_mask=None if m is None else jnp.asarray(m)))
        t = tdd.draw_lines(
            torch.tensor(color), torch.tensor(depth), seg, cols,
            torch.tensor(vp), samples_per_segment=64,
            seg_mask=None if m is None else torch.tensor(m)).numpy()
        drawn_j = (j != color).any(-1)
        drawn_t = (t != color).any(-1)
        np.testing.assert_array_equal(drawn_t, drawn_j)
        np.testing.assert_array_equal(t, j)
        assert 20 < drawn_t.sum() < H * W // 2
        assert not drawn_t[depth > 0.4].all()


def test_ddraw_append_matches_jax():
    """Three appends into a 16-row buffer, the last running past capacity:
    buffers equal, the count saturating at 16."""
    rng = np.random.default_rng(2)
    jbuf, jcount = jdd.ddraw_new(16)
    tbuf, tcount = tdd.ddraw_new(16, device="cpu")
    for m, p_on in ((7, 0.6), (9, 0.5), (20, 0.9)):
        rows = rng.normal(size=(m, 10)).astype(np.float32)
        mask = rng.random(m) < p_on
        jbuf, jcount = jdd.ddraw_append(jbuf, jcount, jnp.asarray(rows),
                                        jnp.asarray(mask))
        tbuf, tcount = tdd.ddraw_append(tbuf, tcount, torch.tensor(rows),
                                        torch.tensor(mask))
        np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
        assert int(tcount) == int(jcount)
    assert int(tcount) == 16 and tcount.dtype == torch.int32
    assert np.abs(tbuf.numpy()).sum(-1).min() > 0      # every row written


@pytest.fixture(scope="module")
def scenes():
    jscene = make_rich_scene()
    return jscene, tloader.scene_from_arrays(*tloader.scene_arrays(jscene),
                                             "cpu")


def test_bounds_rows_match_jax(scenes):
    """light_bounds_rows from each package's own cluster mask (the (C, W32)
    bit layout is the same: the masks are equal) and object_bounds_rows
    under a scene rotation and a seeded visibility mask."""
    jscene, tscene = scenes
    jcfg, tcfg = JConfig(**CFG), TConfig(**CFG)
    view = TView.from_lookat(EYE, TARGET, aspect=W / H)
    vp = view.view_proj()
    proj, inv = view.projection_transform(), np.linalg.inv(vp)
    jmask, _ = jclustered.build_light_clusters(
        jscene.lights, jcfg, jnp.asarray(proj), jnp.asarray(inv), 1.0)
    tmask, _ = tclustered.build_light_clusters(
        tscene.lights, tcfg, torch.tensor(proj),
        torch.tensor(inv.astype(np.float32)), 1.0)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    jr, jm = jdd.light_bounds_rows(jscene.lights, jmask)
    tr, tm = tdd.light_bounds_rows(tscene.lights, tmask)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=1e-6)
    assert tm.any()

    rot = np.eye(4, dtype=np.float32)
    c, s = np.cos(0.3), np.sin(0.3)
    rot[0, 0], rot[0, 2], rot[2, 0], rot[2, 2] = c, -s, s, c
    vis = np.asarray([True, False, True, True])
    jr, jm = jdd.object_bounds_rows(jscene, jnp.asarray(rot),
                                    jnp.asarray(vis))
    tr, tm = tdd.object_bounds_rows(tscene, torch.tensor(rot),
                                    torch.tensor(vis))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-6,
                               atol=1e-6)
    assert int(tm.sum()) == 3


def test_ddraw_render_matches_jax():
    """A buffer of spheres and boxes expanded and splatted in both
    packages: the same drawn pixels (one colour)."""
    rng = np.random.default_rng(4)
    buf = np.zeros((8, 10), np.float32)
    buf[:, 0] = [0, 1, 0, 1, 0, 0, 1, 0]
    buf[:, 1:4] = rng.uniform([-4, -2, 4], [4, 2, 12], (8, 3))
    buf[:, 4:7] = rng.uniform(0.3, 1.5, (8, 3))
    buf[:, 7:10] = [1.0, 0.8, 0.1]
    color = np.zeros((H, W, 3), np.uint8)
    depth = np.zeros((H, W), np.float32)
    vp = TView.from_lookat([0, 0, 0], [0, 0, 5], aspect=W / H).view_proj()
    j = np.asarray(jdd.ddraw_render(jnp.asarray(color), jnp.asarray(depth),
                                    jnp.asarray(buf), jnp.int32(5),
                                    jnp.asarray(vp)))
    t = tdd.ddraw_render(torch.tensor(color), torch.tensor(depth),
                         torch.tensor(buf), torch.tensor(5, dtype=torch.int32),
                         torch.tensor(vp)).numpy()
    np.testing.assert_array_equal(t, j)
    assert 50 < (t.any(-1)).sum() < H * W // 2


def test_frame_debug_draws_match_jax(scenes):
    """render_frame with show_light_bounds and show_object_bounds: the same
    debug_draws count (lights that survived cluster culling + primitives
    that survived the frustum cull), and the wireframes land on the same
    pixels wherever one colour can land."""
    jscene, tscene = scenes
    jcfg, tcfg = JConfig(**CFG), TConfig(**CFG)
    kw = dict(sun_color_intensity=[1.0, 1.0, 1.0, 100.0])
    jfc = jframe.FrameConstants.make(
        JView.from_lookat(EYE, TARGET, aspect=W / H), jcfg, **kw)
    tfc = tframe.FrameConstants.make(
        TView.from_lookat(EYE, TARGET, aspect=W / H), tcfg, device="cpu",
        **kw)
    j = jframe.render_frame_jit(jscene, jfc, jcfg, JParams(chunk=32, **RASTER))
    t = tframe.render_frame(tscene, tfc, config=tcfg,
                            params=TParams(**RASTER))
    assert int(t["stats"]["debug_draws"]) \
        == int(np.asarray(j["stats"]["debug_draws"])) > 0
    plain = tframe.render_frame(
        tscene, tfc, params=TParams(**RASTER),
        config=tcfg.replace(show_light_bounds=False,
                            show_object_bounds=False))
    assert "debug_draws" not in plain["stats"]
    tc, jc = t["color"].numpy(), np.asarray(j["color"])
    wires = (tc != plain["color"].numpy()).any(-1)
    assert 20 < wires.sum() < H * W // 2
    # the two wire colours, as u8
    green = (np.asarray([0.25, 0.9, 0.25]) * 255).astype(np.uint8)
    amber = (np.asarray([1.0, 0.8, 0.1]) * 255).astype(np.uint8)
    for c in (green, amber):
        is_t, is_j = (tc == c).all(-1), (jc == c).all(-1)
        either = is_t | is_j
        # a pixel both colours reach may keep either; elsewhere equal
        both_t = ((tc == green).all(-1) | (tc == amber).all(-1))
        both_j = ((jc == green).all(-1) | (jc == amber).all(-1))
        np.testing.assert_array_equal(both_t, both_j)
        assert (is_t != is_j)[either].mean() < 0.2
