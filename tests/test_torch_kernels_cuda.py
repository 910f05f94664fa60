"""K1, K2, K3 and K4 against their plain PyTorch twins on a CUDA card, at small
shapes from a seed. Marked `cuda`: they skip on a host without a card and
run on the card with

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q --noconftest

This file imports nothing of JAX, so it runs where only the port is
installed. chip_smoke.py holds the same kernels to their twins at the
atrium frame's shapes."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from incarnation_tpu_torch.config import Config
from incarnation_tpu_torch.kernels import bvh, clustered, raster, resolve, taa
from incarnation_tpu_torch.scene import lights as lights_mod

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _soup(dev, n=400, seed=0):
    """A scene-shaped namespace of n random triangles in front of the
    camera (small to screen-filling, some crossing the near plane), every
    fourth primitive alpha-masked with material 1."""
    r = np.random.default_rng(seed)
    c = np.stack([r.uniform(-6, 6, n), r.uniform(-3, 3, n),
                  r.uniform(2, 20, n)], -1)
    size = r.choice([0.2, 1.0, 4.0, 12.0], n, p=[0.5, 0.3, 0.15, 0.05])
    pts = (c[:, None] + r.normal(size=(n, 3, 3)) * size[:, None, None])
    pts[: n // 20, 0, 2] = -15.0
    corner = np.zeros((n, 3, 12), np.float32)
    corner[..., 0:3] = pts
    corner[..., 3:6] = r.normal(size=(n, 3, 3))
    corner[..., 6:9] = r.normal(size=(n, 3, 3))
    corner[..., 9] = 1.0
    corner[..., 10:12] = r.uniform(-1, 2, (n, 3, 2))
    n_prims = 8
    tri_prim = np.sort(r.integers(0, n_prims, n)).astype(np.int32)
    t = lambda x, dt=torch.int32: torch.tensor(np.asarray(x), dtype=dt,
                                               device=dev)
    return SimpleNamespace(
        mesh_transforms=t(np.eye(4)[None], torch.float32),
        tri_mesh=t(np.zeros(n)), tri_prim=t(tri_prim),
        tri_corner=t(corner.reshape(n, 36).T.copy(), torch.float32),
        prim_double_sided=t(np.arange(n_prims) % 2),
        prim_material=t((np.arange(n_prims) % 4 == 0).astype(np.int32)))


def _bins(dev, width=320, height=72, seed=0):
    from incarnation_tpu_torch.core.view import View
    scene = _soup(dev, seed=seed)
    params = raster.RasterParams(width=width, height=height, tile_h=16,
                                 tile_w=128, pair_capacity=1 << 14,
                                 bin_max_span=2, big_tri_capacity=64,
                                 bin_mid_span=4, mid_tri_capacity=32)
    vp = View.from_lookat([0.5, 0.5, -12.0], [0.0, 0.0, 6.0],
                          aspect=width / height).view_proj()
    prep = raster.prepare_geometry(
        scene, torch.eye(4, device=dev),
        torch.tensor(vp, dtype=torch.float32, device=dev),
        torch.ones(8, dtype=torch.bool, device=dev), params)
    layer = (scene.prim_material[scene.tri_prim.long()] > 0).to(torch.int32)
    return raster.bin_triangles_layered(prep, params, layer=layer,
                                        n_layers=2), params


def _assert_k1(got, ref):
    """The twin's edge tests round as the kernel's (nvcc --fmad=false), so
    tri and depth agree exactly; interp to 1e-6 of each channel's peak."""
    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=0)
    torch.testing.assert_close(got[1], ref[1], rtol=0, atol=0)
    for c in range(raster.INTERP_CHANNELS):
        peak = float(ref[2][c].abs().max()) + 1e-6
        torch.testing.assert_close(got[2][c], ref[2][c], rtol=0,
                                   atol=1e-6 * peak)


def test_k1_opaque_and_peels(dev):
    bins, p = _bins(dev)
    ref = raster.rasterize_tiles_plain(bins[0], p)
    _assert_k1(raster.rasterize_tiles(bins[0], p), ref)
    assert (ref[0] >= 0).float().mean() > 0.3
    zl = torch.full((p.height, p.width), 2.0, device=dev)
    for _ in range(3):
        got = raster.rasterize_tiles(bins[0], p, z_limit=zl)
        _assert_k1(got, raster.rasterize_tiles_plain(bins[0], p, z_limit=zl))
        zl = torch.where(got[0] >= 0, got[1], 0.0)


def test_k1_depth_only(dev):
    """The depth-only role (the sun shadow map's), without attribute rows:
    tri and depth equal to its twin's and to the full role's, no interp;
    also as a z_limit peel."""
    bins, p = _bins(dev, seed=3)
    full = raster.rasterize_tiles(bins[0], p)
    dp = p._replace(depth_only=True)
    bare = raster.Bins(**{**vars(bins[0]), "attr": None})
    before = raster.K1.launches
    got = raster.rasterize_tiles(bare, dp, name="raster_shadow_depth")
    assert raster.K1.launches == before + 1
    assert raster.K1.by_name["raster_shadow_depth"] >= 1
    ref = raster.rasterize_tiles_plain(bare, dp)
    assert got[2] is None and ref[2] is None
    for a, b, c in zip(got[:2], ref[:2], full[:2]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        torch.testing.assert_close(a, c, rtol=0, atol=0)
    assert (got[0] >= 0).float().mean() > 0.3
    zl = torch.where(got[0] >= 0, got[1], 0.0)
    peel = raster.rasterize_tiles(bare, dp, z_limit=zl)
    ref = raster.rasterize_tiles_plain(bare, dp, z_limit=zl)
    torch.testing.assert_close(peel[0], ref[0], rtol=0, atol=0)
    torch.testing.assert_close(peel[1], ref[1], rtol=0, atol=0)
    table = torch.zeros((1, raster.AMASK_LANES), dtype=torch.int32,
                        device=dev)
    with pytest.raises(ValueError, match="depth_only"):
        raster.rasterize_tiles(bare, dp, mask_table=table)


def test_k1_masked(dev):
    """The masked role with a random amask table (wrap, clamp and mirror
    addressing)."""
    bins, p = _bins(dev, seed=1)
    r = np.random.default_rng(2)
    table = r.integers(-2**31, 2**31, (2, raster.AMASK_LANES),
                       dtype=np.int64)
    table[:, 32] = [1, 2]
    table[:, 33] = 0
    table = torch.tensor(table, dtype=torch.int32, device=dev)
    zl = torch.full((p.height, p.width), 2.0, device=dev)
    _assert_k1(raster.rasterize_tiles(bins[1], p, z_limit=zl,
                                      mask_table=table),
               raster.rasterize_tiles_plain(bins[1], p, z_limit=zl,
                                            mask_table=table))


def test_k2_matches_dense_twin(dev):
    w, h = 256, 96
    cfg = Config()
    r = np.random.default_rng(3)
    defs, xforms = [], []
    for i in range(40):
        xf = np.eye(4, dtype=np.float32)
        xf[:3, :3] = np.linalg.qr(r.normal(size=(3, 3)))[0]
        xf[3, :3] = r.uniform(-6, 6, 3) + [0, 0, 8]
        d = {"type": ["point", "spot"][i % 2],
             "intensity": float(r.uniform(5, 50)),
             "color": r.uniform(0.2, 1, 3).tolist()}
        if i % 3:
            d["range"] = float(r.uniform(2, 8))
        if i % 2:
            d["spot"] = {"innerConeAngle": 0.3, "outerConeAngle": 0.8}
        defs.append(d)
        xforms.append(xf)
    lights = lights_mod.light_table(lights_mod.light_arrays(defs, xforms),
                                    dev)
    from incarnation_tpu_torch.core.view import View
    view = View.from_lookat([0.5, 0.5, -2.0], [0.0, 0.0, 8.0], aspect=w / h)
    vp = view.view_proj()
    f = lambda x: torch.tensor(np.asarray(x, np.float32), device=dev)
    mask, _ = clustered.build_light_clusters(
        lights, cfg, f(view.projection_transform()), f(np.linalg.inv(vp)),
        1.0)

    def unit(shape):
        v = r.normal(size=shape)
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    nrm = unit((h, w, 3))
    view_v = nrm + 0.9 * unit((h, w, 3))
    view_v /= np.linalg.norm(view_v, axis=-1, keepdims=True)
    gb = resolve.GBuffer(
        base_color=f(r.uniform(0, 1, (h, w, 4))),
        normals=f(np.zeros((h, w, 2))), mrao=f(r.uniform(0.05, 1, (h, w, 4))),
        emissive=f(np.zeros((h, w, 3))),
        mask=torch.tensor(r.random((h, w)) > 0.1, device=dev),
        world_pos=f(r.uniform(-5, 5, (h, w, 3)) + [0, 0, 8]),
        uv=f(np.zeros((h, w, 2))), extras=f(np.zeros((h, w, 3))))
    depth = f(r.uniform(0.005, 1.0, (h, w)))
    args = (gb, f(nrm), f(view_v), depth, lights, mask, cfg, 1.0, w, h)
    got = clustered.clustered_lighting(*args)
    ref = clustered.clustered_lighting_plain(*args)
    # sums in the same light order; the BRDF's 3-term dot products may
    # round differently from torch's reductions by an ulp
    torch.testing.assert_close(got, ref, rtol=1e-4,
                               atol=1e-5 * float(ref.abs().max()))
    assert float(ref.abs().max()) > 0


def test_k3_matches_twin(dev):
    w, h = 200, 72
    r = np.random.default_rng(4)
    hist = torch.tensor(r.random((h, w, 3)), dtype=torch.float32, device=dev)
    depth = torch.tensor(r.uniform(0.05, 0.9, (h, w)), dtype=torch.float32,
                         device=dev)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[1, 1] = 1.01, 0.99
    m[2, 0], m[3, 0], m[3, 1] = 0.05, 0.3, -0.2    # far outside at the edges
    m = torch.tensor(m, device=dev)
    # the same f32 operations in the same order (K3 built --fmad=false)
    torch.testing.assert_close(taa.history_fetch(hist, depth, m, w, h),
                               taa.history_fetch_plain(hist, depth, m, w, h),
                               rtol=0, atol=1e-6)


def _long_list_bins(dev, bins, tile, n_pairs, seed):
    """bins with tile `tile`'s list replaced by n_pairs triangle ids (its
    own pairs, then random valid triangles and repeats), enough to split
    it into several K1 work items."""
    r = np.random.default_rng(seed)
    own = bins.pair_tri[bins.starts[tile]:bins.starts[tile]
                        + bins.counts[tile]].cpu().numpy()
    ids = np.concatenate([own, r.integers(0, bins.setup.shape[0],
                                          n_pairs - own.size)])
    r.shuffle(ids)
    pair_tri = torch.cat([bins.pair_tri[:-1],
                          torch.tensor(ids, dtype=torch.int32, device=dev),
                          bins.pair_tri[-1:]])
    starts, counts = bins.starts.clone(), bins.counts.clone()
    starts[tile] = bins.pair_tri.shape[0] - 1
    counts[tile] = n_pairs
    return raster.Bins(**{**vars(bins), "pair_tri": pair_tri,
                          "starts": starts, "counts": counts})


def test_k1_split_long_lists(dev):
    """One tile with thousands of pairs is cut into several work items
    (raced across blocks, reduced by the last): the full role, a z_limit
    peel and the depth-only role all equal their twins."""
    bins, p = _bins(dev, seed=5)
    crafted = _long_list_bins(dev, bins[0], 2, 5000, seed=6)
    items, largest = raster.k1_work_items(crafted, p)
    assert items >= p.num_tiles + 5000 // raster.K1_ITEM_PAIRS
    ref = raster.rasterize_tiles_plain(crafted, p)
    _assert_k1(raster.rasterize_tiles(crafted, p), ref)
    assert (ref[0] >= 0).float().mean() > 0.3
    zl = torch.where(ref[0] >= 0, ref[1], 0.0)
    _assert_k1(raster.rasterize_tiles(crafted, p, z_limit=zl),
               raster.rasterize_tiles_plain(crafted, p, z_limit=zl))
    dp = p._replace(depth_only=True)
    bare = raster.Bins(**{**vars(crafted), "attr": None})
    got = raster.rasterize_tiles(bare, dp, name="raster_shadow_depth")
    want = raster.rasterize_tiles_plain(bare, dp)
    for a, b in zip(got[:2], want[:2]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_k1_leaves_its_counters_zero(dev):
    """K1 keeps its work and arrival counters from call to call, and each
    call leaves them zero: a split list launched twice in a row gives the
    same outputs both times, and the counters read zero after."""
    bins, p = _bins(dev, seed=5)
    crafted = _long_list_bins(dev, bins[0], 2, 3000, seed=8)
    first = raster.rasterize_tiles(crafted, p)
    second = raster.rasterize_tiles(crafted, p)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    _assert_k1(second, raster.rasterize_tiles_plain(crafted, p))
    counters = raster._k1_counters(crafted.setup.device, p.num_tiles)
    assert int(counters.abs().sum()) == 0


def test_k1_equal_depth_ties_across_work_items(dev):
    """Screen-filling triangles at one depth, their pairs shuffled over a
    list of several work items: every pixel goes to the largest id, as in
    the twin, and a second tile whose list repeats ids agrees too."""
    w, h = 256, 16
    p = raster.RasterParams(width=w, height=h, pair_capacity=1 << 14)
    n_tri = 1500
    r = np.random.default_rng(7)
    setup = np.zeros((n_tri, raster.SETUP_ROWS), np.float32)
    setup[:, 2] = setup[:, 5] = setup[:, 8] = 1.0     # every edge >= 0
    setup[:, 11] = 0.5                                # z = 0.5 everywhere
    setup[: n_tri // 2, 11] = 0.25                    # half lie behind
    attr = r.normal(size=(n_tri, raster.ATTR_ROWS)).astype(np.float32)
    attr[:, 6:9] = [0.0, 0.0, 1.0]
    lists = [r.permutation(n_tri), r.integers(0, n_tri - 1, 2 * n_tri)]
    counts = [l.size for l in lists]
    flat = np.concatenate(lists + [[0]]).astype(np.int32)
    t = lambda x, dt=torch.int32: torch.tensor(np.asarray(x), dtype=dt,
                                               device=dev)
    bins = raster.Bins(
        pair_tri=t(flat), starts=t(np.cumsum(counts) - counts),
        counts=t(counts), big_tri=t(np.zeros(4)), big_count=t([0]),
        overflow=t(0), big_overflow=t(0), setup=t(setup, torch.float32),
        attr=t(attr, torch.float32))
    got = raster.rasterize_tiles(bins, p)
    _assert_k1(got, raster.rasterize_tiles_plain(bins, p))
    assert bool((got[0][:, :128] == n_tri - 1).all())
    assert bool((got[0][:, 128:] == int(lists[1].max())).all())
    assert bool((got[1] == 0.5).all())


def test_k2_lights_mostly_out_of_reach(dev):
    """Short ranges and narrow spot cones: most (pixel, cluster light)
    pairs add exactly zero and are skipped; K2 still equals its twin."""
    w, h = 256, 96
    cfg = Config()
    r = np.random.default_rng(8)
    defs, xforms = [], []
    for i in range(48):
        xf = np.eye(4, dtype=np.float32)
        xf[:3, :3] = np.linalg.qr(r.normal(size=(3, 3)))[0]
        xf[3, :3] = r.uniform(-6, 6, 3) + [0, 0, 8]
        d = {"type": ["point", "spot"][i % 2], "range": float(
            r.uniform(0.5, 2.0)), "intensity": float(r.uniform(5, 50)),
             "color": r.uniform(0.2, 1, 3).tolist()}
        if i % 2:
            d["spot"] = {"innerConeAngle": 0.05, "outerConeAngle": 0.15}
        defs.append(d)
        xforms.append(xf)
    lights = lights_mod.light_table(lights_mod.light_arrays(defs, xforms),
                                    dev)
    from incarnation_tpu_torch.core.view import View
    view = View.from_lookat([0.5, 0.5, -2.0], [0.0, 0.0, 8.0], aspect=w / h)
    f = lambda x: torch.tensor(np.asarray(x, np.float32), device=dev)
    mask, _ = clustered.build_light_clusters(
        lights, cfg, f(view.projection_transform()),
        f(np.linalg.inv(view.view_proj())), 1.0)
    nrm = np.random.default_rng(9).normal(size=(h, w, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    gb = resolve.GBuffer(
        base_color=f(r.uniform(0, 1, (h, w, 4))),
        normals=f(np.zeros((h, w, 2))), mrao=f(r.uniform(0.05, 1, (h, w, 4))),
        emissive=f(np.zeros((h, w, 3))),
        mask=torch.tensor(r.random((h, w)) > 0.1, device=dev),
        world_pos=f(r.uniform(-5, 5, (h, w, 3)) + [0, 0, 8]),
        uv=f(np.zeros((h, w, 2))), extras=f(np.zeros((h, w, 3))))
    depth = f(r.uniform(0.005, 1.0, (h, w)))
    view_v = nrm + 0.9 * r.normal(size=(h, w, 3))
    view_v /= np.linalg.norm(view_v, axis=-1, keepdims=True)
    args = (gb, f(nrm), f(view_v), depth, lights, mask, cfg, 1.0, w, h)
    got = clustered.clustered_lighting(*args)
    ref = clustered.clustered_lighting_plain(*args)
    torch.testing.assert_close(got, ref, rtol=1e-4,
                               atol=1e-5 * float(ref.abs().max()))
    cid = clustered.pixel_cluster_id(depth, cfg, 1.0, w, h).long()
    on_pairs = skipped = 0
    for i in range(len(defs)):
        on = (((mask[cid, i // 32] >> (i % 32)) & 1) > 0) & gb.mask
        tests = clustered.zero_light_tests(lights, i, gb.world_pos, f(nrm))
        on_pairs += int(on.sum())
        skipped += int((on & (tests[0] | tests[1] | tests[2])).sum())
    assert on_pairs > 0 and skipped > 0.5 * on_pairs
    assert float(ref.abs().max()) > 0


def _k4_bvh(dev, n=1500, seed=0, double_sided_every=2):
    """The wide BVH of a random triangle soup (every other triangle
    single-sided), on the card."""
    r = np.random.default_rng(seed)
    tris = (r.uniform(-10, 10, (n, 1, 3))
            + r.uniform(-0.8, 0.8, (n, 3, 3))).astype(np.float32)
    geo, leaf_tri = bvh.build_wide(tris)
    for s in range(bvh.LEAF_K):
        ok = leaf_tri[:, s] >= 0
        lane = 11 if s == 0 else bvh._DS1_OFF + s - 1
        geo[ok, lane] = (leaf_tri[ok, s] % double_sided_every == 0)
    return tris, bvh.bvh_from_arrays(geo, dev)


def _k4_rays(dev, n=20000, seed=1):
    """Random rays, some along the axes (the inv_d guard: exact zeros and
    negative zeros in the direction), some parked at 1e29."""
    r = np.random.default_rng(seed)
    o = r.uniform(-12, 12, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    axes = np.eye(3, dtype=np.float32)[np.arange(300) % 3]
    d[:300] = axes * np.where(np.arange(300) % 2, -1.0, 1.0)[:, None]
    d[300:400] = np.float32([-0.0, 0.0, 1.0])
    o[400:600] = 1e29
    return torch.tensor(o, device=dev), torch.tensor(d, device=dev)


def _assert_k4(got, ref):
    for k in ("tri", "t", "u", "v"):
        assert torch.equal(got[k], ref[k]), k
    assert int(got["trunc"]) == int(ref["trunc"])


@pytest.mark.parametrize("any_hit", [False, True])
def test_k4_matches_twin(dev, any_hit):
    """Closest and any hit, scalar and per-ray tmin, single- and
    double-sided triangles: tri, t, u, v identical to the twin."""
    _, b = _k4_bvh(dev)
    o, d = _k4_rays(dev)
    bvh.K4.reset()
    got = bvh.trace(b, o, d, tmin=0.05, tmax=25.0, any_hit=any_hit)
    assert bvh.K4.launches == 1
    _assert_k4(got, bvh.trace_plain(b, o, d, 0.05, 25.0, any_hit))
    assert (got["tri"] >= 0).float().mean() > 0.05
    assert (got["tri"][400:600] < 0).all()           # parked rays miss
    tmin = torch.rand(o.shape[0], device=dev) * 3.0
    _assert_k4(bvh.trace(b, o, d, tmin=tmin, tmax=25.0, any_hit=any_hit),
               bvh.trace_plain(b, o, d, tmin, 25.0, any_hit))


def test_k4_tie_slots_within_a_leaf(dev):
    """Four coplanar copies of one triangle share a leaf: every ray's hit
    ties across the slots, and the strict t < t_best keeps slot a's
    triangle, as the twin does."""
    tri = np.float32([[[-1, -1, 5], [1, -1, 5], [0, 1, 5]]])
    tris = np.repeat(tri, 4, 0)
    geo, _ = bvh.build_wide(tris)
    geo[:, 11] = 1.0
    geo[:, bvh._DS1_OFF:bvh._DS1_OFF + 3] = 1.0
    b = bvh.bvh_from_arrays(geo, dev)
    n = 1000
    r = np.random.default_rng(3)
    o = np.zeros((n, 3), np.float32)
    o[:, 0] = r.uniform(-0.2, 0.2, n)       # inside the triangle
    o[:, 1] = r.uniform(-0.5, 0.5, n)
    d = np.tile(np.float32([0, 0, 1]), (n, 1))
    o, d = torch.tensor(o, device=dev), torch.tensor(d, device=dev)
    got = bvh.trace(b, o, d)
    _assert_k4(got, bvh.trace_plain(b, o, d))
    assert (got["tri"] == int(geo[0, 10])).all()


def test_k4_budget_counts_trunc_and_leaves_counters_zero(dev):
    """A step budget shorter than the walks stops rays with their best hit
    and counts them in trunc, as the twin does; back-to-back launches
    leave K4's counters zero (no memset between calls)."""
    _, b = _k4_bvh(dev)
    o, d = _k4_rays(dev)
    ref = bvh.trace_plain(b, o, d, return_steps=True, max_steps=6)
    got = bvh.trace_k4(b, o, d, return_steps=True, max_steps=6)
    _assert_k4(got, ref)
    assert torch.equal(got["steps"], ref["steps"])
    assert int(got["trunc"]) > 0
    for _ in range(3):
        bvh.trace_k4(b, o, d, max_steps=6)
        full = bvh.trace_k4(b, o, d, return_steps=True)
    torch.cuda.synchronize()
    assert int(full["trunc"]) == 0
    assert torch.count_nonzero(bvh._k4_counters(dev)) == 0
    assert torch.equal(full["steps"],
                       bvh.trace_plain(b, o, d, return_steps=True)["steps"])


@pytest.mark.parametrize("split", [False, True], ids=["merged", "split"])
@pytest.mark.parametrize("any_hit", [False, True])
def test_k4_binary_matches_twin(dev, any_hit, split, monkeypatch):
    """K4's binary roles (the merged table, and rows + links split as
    above _MERGE_LIMIT nodes): tri, t, u, v and steps identical to the
    binary twin, per-ray tmin included."""
    if split:
        monkeypatch.setattr(bvh, "_MERGE_LIMIT", 0)
    tris, _ = _k4_bvh(dev)
    rows, links, _ = bvh.build_lbvh(tris)
    rows[:, 11] = 1.0
    rows[:, bvh._DS1_OFF:bvh._DS1_OFF + 3] = 1.0
    b = bvh._finish_bvh(rows, links, dev)
    assert b.merged == (not split)
    o, d = _k4_rays(dev)
    bvh.K4.reset()
    got = bvh.trace(b, o, d, tmin=0.05, tmax=25.0, any_hit=any_hit)
    assert bvh.K4.launches == 1
    _assert_k4(got, bvh.trace_plain(b, o, d, 0.05, 25.0, any_hit))
    tmin = torch.rand(o.shape[0], device=dev) * 3.0
    g2 = bvh.trace_k4(b, o, d, tmin, 25.0, any_hit, return_steps=True)
    r2 = bvh.trace_plain(b, o, d, tmin, 25.0, any_hit, return_steps=True)
    _assert_k4(g2, r2)
    assert torch.equal(g2["steps"], r2["steps"])
    assert (got["tri"] >= 0).float().mean() > 0.05


def test_k4_split_links_pass_2_24(dev):
    """A split table of 3M nodes whose walk ends at its last two rows, so
    that octants 5-7 follow int32 links past 2^24 (which f32 would round
    to the wrong node): K4 identical to the twin, every octant's ray
    reaching the last row's triangle."""
    n = 3 << 20
    rows = torch.zeros((n, bvh.ROW_LANES), device=dev)
    links = torch.zeros((8 * n, 2), dtype=torch.int32, device=dev)
    rows[0, 0:3], rows[0, 3:6] = -100.0, 100.0
    tris = np.float32([[[50, 50, 50], [51, 50, 50], [50, 51, 50]],
                       [[-10, -10, 0], [10, -10, 0], [0, 10, 0]]])
    rows[n - 2:] = torch.tensor(bvh._leaf_rows_for(
        tris, np.array([[0, -1, -1, -1], [1, -1, -1, -1]])), device=dev)
    rows[n - 2:, 11] = 1.0
    for okt in range(8):
        off = okt * n
        links[off] = torch.tensor([off + n - 2, -1])
        links[off + n - 2] = torch.tensor([-1, off + n - 1])
        links[off + n - 1] = -1
    b = bvh.SceneBVH(rows=rows, links=links, wide=False)
    signs = torch.tensor([[1.0 - 2 * ((k >> a) & 1) for a in range(3)]
                          for k in range(8)], device=dev)
    d = signs * torch.tensor([0.36, 0.48, 0.8], device=dev)
    o = (-4.0 * d).contiguous()
    got = bvh.trace_k4(b, o, d, return_steps=True)
    ref = bvh.trace_plain(b, o, d, return_steps=True)
    _assert_k4(got, ref)
    assert torch.equal(got["steps"], ref["steps"])
    assert got["tri"].tolist() == [1] * 8


def _alpha_scene(dev):
    """The port's testing scene with its MASK quad and a BLEND quad, rays
    toward both from in front, and one noise value per ray."""
    from incarnation_tpu_torch.scene import testing
    scene = testing.make_rich_scene(device=dev, blend_quad=True)
    r = np.random.default_rng(5)
    n = 20000
    o = np.stack([r.uniform(-5, 5, n), r.uniform(-1.5, 4.5, n),
                  r.uniform(-1, 2, n)], 1).astype(np.float32)
    d = np.stack([r.normal(0, 0.3, n), r.normal(0, 0.3, n),
                  np.ones(n)], 1).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (scene, torch.tensor(o, device=dev), torch.tensor(d, device=dev),
            torch.tensor(r.uniform(0, 1, n).astype(np.float32), device=dev))


@pytest.mark.parametrize("wide", [True, False], ids=["wide", "binary"])
@pytest.mark.parametrize("any_hit", [False, True])
def test_k4_alpha_matches_twin(dev, any_hit, wide):
    """K4's alpha role with a pathtrace.AlphaFilter (MASK cutoff, BLEND
    noise per ray): identical to the twin calling the same filter, and the
    filter changes hits; any other callable on CUDA tensors raises."""
    from incarnation_tpu_torch.kernels import pathtrace
    scene, o, d, noise = _alpha_scene(dev)
    b = bvh.build_scene_bvh(scene, use_cache=False, wide=wide, device=dev)
    flt = pathtrace.AlphaFilter(scene, noise)
    got = bvh.trace(b, o, d, any_hit=any_hit, alpha_of=flt)
    ref = bvh.trace_plain(b, o, d, any_hit=any_hit, alpha_of=flt)
    _assert_k4(got, ref)
    bare = bvh.trace(b, o, d, any_hit=any_hit)
    assert int((bare["tri"] != got["tri"]).sum()) > 100
    with pytest.raises(TypeError, match="AlphaFilter"):
        bvh.trace(b, o, d, alpha_of=lambda tri, u, v: tri >= 0)


def test_k3_halo_rows_match_twin(dev):
    """K3 on a band's history with y_off halo rows above and below (the
    band-sharded frame): identical to the twin, and the halo rows are read
    (the fetch differs from a fetch clamped at the band's edge)."""
    h, w, y = 64, 256, 16
    r = np.random.default_rng(9)
    hist = torch.tensor(r.uniform(0, 4, (h + 2 * y, w, 3)).astype(
        np.float32), device=dev)
    depth = torch.tensor(r.uniform(0.05, 1.0, (h, w)).astype(np.float32),
                         device=dev)
    m = torch.eye(4, device=dev)
    m[3, 1] = 0.2                    # a vertical shift of 0.1 h rows
    m[3, 0] = -0.03
    got = taa.history_fetch(hist, depth, m, w, h, y)
    ref = taa.history_fetch_plain(hist, depth, m, w, h, y)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    inner = taa.history_fetch(hist[y:h + y].contiguous(), depth, m, w, h)
    assert not torch.equal(got, inner)
