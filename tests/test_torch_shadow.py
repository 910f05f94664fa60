"""Port parity for the sun shadow map: sun_view_proj, K1's depth-only role
(through its plain twin on the CPU), sun_visibility and the frame wiring,
against the JAX package (Pallas in interpret mode).

The JAX map is quantised to u16 (two texels per i32 word); the port keeps
float32. The tests unpack the JAX map with numpy and hold the port's depth
to half a quantisation step."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incarnation_tpu.config import Config as JConfig
from incarnation_tpu.kernels import shadow as jshadow
from incarnation_tpu.scene import testing as jtesting
from incarnation_tpu_torch.config import Config as TConfig
from incarnation_tpu_torch.core.view import View as TView
from incarnation_tpu_torch.kernels import raster as traster
from incarnation_tpu_torch.kernels import shadow as tshadow
from incarnation_tpu_torch.renderer import frame as tframe
from incarnation_tpu_torch.scene import loader as tloader
from incarnation_tpu_torch.scene import testing as ttesting

torch.set_num_threads(1)

S = 256
STEP = 1.0 / 65535.0
CFG = dict(raster_tile_h=16, stochastic_mip=False, stochastic_bilinear=False,
           checkerboard_gathers=False, peel_chunk_capacity=0,
           decal_chunk_capacity=0)


def _floor_blocker(make_scene, **kw):
    """A big floor quad at y=0 with a small blocker quad hovering at y=2
    (the scene of tests/test_shadow.py)."""
    positions, tris = [], []
    for y, e in ((0.0, 10.0), (2.0, 1.0)):
        b = len(positions)
        positions += [[-e, y, -e], [e, y, -e], [e, y, e], [-e, y, e]]
        tris += [[b, b + 2, b + 1], [b, b + 3, b + 2]]
    normals = np.tile([0.0, 1.0, 0.0], (len(positions), 1))
    return make_scene(np.asarray(positions, np.float32),
                      np.asarray(tris, np.int32),
                      normals=normals.astype(np.float32),
                      double_sided=True, **kw)


def _unpack_u16(packed, s):
    w = np.asarray(packed).astype(np.uint32)
    q = np.stack([w & 0xFFFF, w >> 16], axis=-1).reshape(s, s)
    return q.astype(np.float32) * np.float32(STEP)


SCENES = {
    "rich": (jtesting.make_rich_scene, [0.3, 1.0, 0.2], [0.0, 0.0, 8.0],
             14.0),
    "floor_blocker": (lambda: _floor_blocker(jtesting.make_scene),
                      [0.0, 1.0, 0.0], [0.0, 1.0, 0.0], 12.0),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def maps(request):
    """(jax unpacked u16 depth, jax stats, port f32 depth, port stats,
    packed jax map, sun_vp) for one scene at S = 256."""
    make, sun, center, radius = SCENES[request.param]
    jscene = make()
    tscene = tloader.scene_from_arrays(*tloader.scene_arrays(jscene), "cpu")
    sun_vp = jshadow.sun_view_proj(sun, center, radius)
    jp = jshadow.shadow_params(S, JConfig(**CFG))
    tp = tshadow.shadow_params(S, TConfig(**CFG))
    jpacked, jstats = jshadow.render_sun_shadow_map(
        jscene, jnp.eye(4), jnp.asarray(sun_vp), jp)
    tdepth, tstats = tshadow.render_sun_shadow_map(
        tscene, torch.eye(4), torch.tensor(sun_vp), tp)
    return (_unpack_u16(jpacked, S), jstats, tdepth.numpy(), tstats,
            jpacked, sun_vp)


@pytest.mark.parametrize("sun", [[0.3, 0.8, 0.2], [0.02, 1.0, 0.01],
                                 [-1.0, 0.1, 0.5]])
def test_sun_view_proj_matches_jax(sun):
    """Host numpy, the same operations: 1e-6. The second direction lies
    within 0.95 of vertical and takes the other up hint."""
    a = tshadow.sun_view_proj(sun, [1.0, 2.0, 3.0], 5.0)
    b = jshadow.sun_view_proj(sun, [1.0, 2.0, 3.0], 5.0)
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    assert a.dtype == np.float32


def test_shadow_params_match_jax():
    """Every field as JAX's but the pair capacity: the port's map casts
    back faces too, so its default capacity is larger."""
    jp = jshadow.shadow_params(S, JConfig(**CFG))
    tp = tshadow.shadow_params(S, TConfig(**CFG))
    for k in ("width", "height", "tile_h", "tile_w", "bin_max_span",
              "big_tri_capacity", "depth_only"):
        assert getattr(tp, k) == getattr(jp, k), k
    assert tp.pair_capacity == TConfig().shadow_pair_capacity \
        > jp.pair_capacity
    assert tshadow.shadow_params(S, TConfig(
        **CFG, shadow_pair_capacity=1234)).pair_capacity == 1234


def _wall_over_floor():
    """A single-sided floor quad at y = 0 facing up, and a single-sided
    wall standing on it in the plane z = 0 (x in [-3, 3], y in [0, 4])
    whose front face looks along +z, away from a sun at -z (front faces
    wind clockwise as seen from their side, as in D3D). The sun view sees
    the wall's back face."""
    positions = [[-10, 0, -10], [10, 0, -10], [10, 0, 10], [-10, 0, 10],
                 [-3, 0, 0], [3, 0, 0], [3, 4, 0], [-3, 4, 0]]
    tris = [[0, 1, 2], [0, 2, 3], [4, 6, 5], [4, 7, 6]]
    normals = [[0, 1, 0]] * 4 + [[0, 0, 1]] * 4
    return ttesting.make_scene(
        np.asarray(positions, np.float32), np.asarray(tris, np.int32),
        normals=np.asarray(normals, np.float32), double_sided=False,
        tri_prim=[0, 0, 1, 1], num_prims=2, prim_tri_offset=[0, 2],
        device="cpu")


def test_single_sided_wall_facing_away_shadows_the_floor():
    """A divergence from JAX: the port's map casts every face. A wall
    facing away from the sun shadows the floor behind it both in the map
    and through RT (K4's twin, which culls back faces from the
    receiver's side: the shadow ray meets the wall's front face), and the
    sun side of the floor stays lit in both. With back faces culled, as
    JAX culls them, the map lets the light through."""
    from incarnation_tpu_torch.kernels import bvh as tbvh
    scene = _wall_over_floor()
    sun = np.asarray([0.0, 1.0, -1.0], np.float32) / np.sqrt(2.0)
    sun_vp = torch.tensor(tshadow.sun_view_proj(sun, [0, 1, 0], 12.0))
    params = tshadow.shadow_params(S, TConfig(**CFG))
    depth, stats = tshadow.render_sun_shadow_map(scene, torch.eye(4),
                                                 sun_vp, params)
    assert int(stats["bin_overflow"]) == 0
    # behind the wall (its shadow reaches z = 4 at the floor) and in front
    wp = torch.tensor([[[0.0, 0.0, 2.0], [0.0, 0.0, -2.0]]])
    vis = tshadow.sun_visibility(wp, torch.ones((1, 2)), depth, sun_vp, S)
    assert vis.tolist() == [[0.0, 1.0]]
    bvh = tbvh.build_scene_bvh(scene, use_cache=False, device="cpu")
    occ = tbvh.occluded(bvh, wp[0], torch.tensor(sun).expand(2, 3))
    assert occ.tolist() == [True, False]
    culled = traster.prepare_geometry(
        scene, torch.eye(4), sun_vp, torch.ones(2, dtype=torch.bool),
        params, emit_attributes=False)
    _, jax_like, _ = traster.raster_depth(culled, params)
    vis = tshadow.sun_visibility(wp, torch.ones((1, 2)), jax_like, sun_vp,
                                 S)
    assert vis.tolist() == [[1.0, 1.0]]


def test_raster_depth_matches_jax(maps):
    """Stats equal; the port's f32 depth within half a u16 step (+ 1e-6
    of f32 rounding) of JAX's quantised map at every texel, covered or
    not. Equal-depth ties pick different triangles in the two packages,
    which the depth does not see. The far plane of the sun projection
    sits at 2.1 x the radius, beyond the bounding sphere, so no fragment
    lands on z == 0, where JAX's race (z > 0) and the port's (z >= 0)
    would differ: the smallest covered depth is well above 0."""
    jd, jstats, td, tstats, _, _ = maps
    for k in ("bin_overflow", "big_overflow"):
        assert int(tstats[k]) == int(np.asarray(jstats[k])) == 0, k
    np.testing.assert_allclose(td, jd, rtol=0, atol=0.5 * STEP + 1e-6)
    covered = td > 0
    assert 0.05 < covered.mean() < 1.0
    assert td[covered].min() > 0.01


def test_sun_visibility_matches_jax(maps):
    """Random world points through both sun_visibility functions, each on
    its own package's map. The answers may differ only where the depth
    compare is within one u16 step of its threshold, and on fewer than
    0.5% of the points."""
    _, _, td, _, jpacked, sun_vp = maps
    rng = np.random.default_rng(7)
    wp = rng.uniform([-12, -3, -4], [12, 6, 20], (64, 96, 3)) \
        .astype(np.float32)
    wp[0, 0] = [1e30, 0, 0]          # far outside the map
    ndl = rng.uniform(-0.2, 1.0, (64, 96)).astype(np.float32)
    jv = np.asarray(jshadow.sun_visibility(
        jnp.asarray(wp), jnp.asarray(ndl), jpacked, jnp.asarray(sun_vp), S))
    tv = tshadow.sun_visibility(torch.tensor(wp), torch.tensor(ndl),
                                torch.tensor(td), torch.tensor(sun_vp),
                                S).numpy()
    assert tv.shape == jv.shape and set(np.unique(tv)) <= {0.0, 1.0}
    assert 0.02 < (tv == 0).mean() < 0.98
    differ = tv != jv
    assert differ.mean() < 5e-3
    s = np.concatenate([wp, np.ones_like(wp[..., :1])], -1).astype(
        np.float64) @ sun_vp.astype(np.float64)
    xi = np.clip(((s[..., 0] * 0.5 + 0.5) * S), 0, S - 1).astype(np.int64)
    yi = np.clip(((0.5 - s[..., 1] * 0.5) * S), 0, S - 1).astype(np.int64)
    bias = (1.5 + 2.0 * (1.0 - np.clip(ndl, 0.0, 1.0))) * (2.0 / S)
    margin = np.abs(td[yi, xi] - (s[..., 2] + bias))
    assert (margin[differ] <= STEP + 1e-6).all()


def test_shadow_map_blocker_shadows_floor():
    """tests/test_shadow.py::test_shadow_map_blocker_shadows_floor on the
    port."""
    scene = _floor_blocker(ttesting.make_scene, device="cpu")
    sun_vp = torch.tensor(tshadow.sun_view_proj([0.0, 1.0, 0.0], [0, 1, 0],
                                                12.0))
    depth, stats = tshadow.render_sun_shadow_map(
        scene, torch.eye(4), sun_vp, tshadow.shadow_params(S, TConfig(**CFG)))
    assert int(stats["bin_overflow"]) == 0
    assert depth.shape == (S, S) and depth.dtype == torch.float32
    wp = torch.tensor([[[0.0, 0.0, 0.0], [5.0, 0.0, 0.0]]])
    vis = tshadow.sun_visibility(wp, torch.ones((1, 2)), depth, sun_vp, S)
    assert vis[0, 0] == 0.0, "point under blocker must be shadowed"
    assert vis[0, 1] == 1.0, "open point must be lit"


def test_frame_with_shadow_map_darkens_under_blocker():
    """tests/test_shadow.py::test_frame_with_shadow_map_darkens_under_blocker
    on the port."""
    scene = _floor_blocker(ttesting.make_scene, device="cpu")
    w, h = 256, 128
    cfg = TConfig(sun_shadow_mode="map", shadow_map_resolution=S,
                  enable_taa=False, env_sky_mode=1, **CFG)
    view = TView.from_lookat([0.0, 8.0, -9.0], [0.0, 0.0, 0.0], aspect=w / h)
    params = traster.RasterParams(width=w, height=h, tile_h=16,
                                  pair_capacity=1 << 12, big_tri_capacity=128)
    fc = tframe.FrameConstants.make(
        view, cfg, sun_dir=[0.0, 1.0, 0.0],
        sun_color_intensity=[1.0, 1.0, 1.0, 100.0],
        shadow_bounds=([0.0, 1.0, 0.0], 12.0), device="cpu")
    out = tframe.render_frame(scene, fc, config=cfg, params=params)
    assert int(out["stats"]["shadow_bin_overflow"]) == 0
    hdr, tri = out["hdr"].numpy(), out["tri"].numpy()
    vp = fc.view_proj.numpy()

    def px_of(world):
        c = np.append(np.asarray(world, np.float32), 1.0) @ vp
        return (int((0.5 - c[1] / c[3] * 0.5) * h),
                int((c[0] / c[3] * 0.5 + 0.5) * w))

    yx_shadow, yx_lit = px_of([0.0, 0.0, -0.9]), px_of([6.0, 0.0, -0.9])
    assert tri[yx_shadow] >= 0 and tri[yx_lit] >= 0
    assert hdr[yx_shadow].sum() < 0.5 * hdr[yx_lit].sum()
    out2 = tframe.render_frame(scene, fc,
                               config=cfg.replace(sun_shadow_mode="off"),
                               params=params)
    hdr2 = out2["hdr"].numpy()
    assert "shadow_bin_overflow" not in out2["stats"]
    assert hdr2[yx_shadow].sum() > 0.6 * hdr2[yx_lit].sum()


def test_frame_make_requires_bounds_for_map_mode():
    view = TView.from_lookat([0, 1, -3], [0, 0, 0])
    with pytest.raises(ValueError):
        tframe.FrameConstants.make(view, TConfig(sun_shadow_mode="map"),
                                   device="cpu")
    fc = tframe.FrameConstants.make(view, TConfig(), device="cpu")
    np.testing.assert_array_equal(fc.sun_view_proj.numpy(), np.eye(4))


def test_depth_only_refuses_mask_table():
    """The depth-only role has no UV planes to test an amask row with."""
    scene = _floor_blocker(ttesting.make_scene, device="cpu")
    p = tshadow.shadow_params(64, TConfig(**CFG))
    sun_vp = torch.tensor(tshadow.sun_view_proj([0.0, 1.0, 0.0], [0, 1, 0],
                                                12.0))
    prep = traster.prepare_geometry(
        scene, torch.eye(4), sun_vp, torch.ones(1, dtype=torch.bool), p,
        emit_attributes=False)
    assert prep.attr is None
    bins, = traster.bin_triangles_layered(prep, p)
    assert bins.attr is None
    table = torch.zeros((1, traster.AMASK_LANES), dtype=torch.int32)
    for fn in (traster.rasterize_tiles, traster.rasterize_tiles_plain):
        with pytest.raises(ValueError, match="depth_only"):
            fn(bins, p, mask_table=table)
    tri, depth, interp = traster.rasterize_tiles(bins, p)
    assert interp is None and (tri >= 0).any()
    with pytest.raises(ValueError, match="depth_only"):
        traster.raster_depth(prep, p._replace(depth_only=False))
