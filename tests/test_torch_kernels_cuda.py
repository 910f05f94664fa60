"""K1-K15 against their plain PyTorch twins on a CUDA card, at small
shapes from a seed. Marked `cuda`: they skip on a host without a card and
run on the card with

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q --noconftest

This file imports nothing of JAX, so it runs where only the port is
installed. chip_smoke.py holds the same kernels to their twins at the
atrium frame's shapes."""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from incarnation_tpu_torch.config import Config
from incarnation_tpu_torch.kernels import (bvh, clustered, cull, raster,
                                           resolve, shading, shadow, skylight,
                                           taa)
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


def material_inputs(seed=0, h=24, w=40, extras=True, wild_mats=False):
    """numpy inputs of one resolve: a stack of three block-encoded
    materials (textures.make_material_stack: 8x8 with 4 mips, mirror; 4x4
    with 3, wrap; 1x1, clamp; the third without extras blocks, or no
    extras table at all with extras=False), their mat_params (MASK, BLEND
    and OPAQUE), and an h x w layer: tri with empty pixels, depth, the 16
    interp channels (uv past [0, 1], footprints from far below mip 0 to
    past the last mip; wild_mats adds material ids outside the table) and
    inv_view_proj. -> dict(stack, mat_params, tri, depth, interp,
    inv_view_proj)."""
    from incarnation_tpu_torch.core.view import View
    from incarnation_tpu_torch.scene import textures as tex
    r = np.random.default_rng(seed)
    rows = r.integers(0, 2 ** 32, (85 + 21 + 1, 4), dtype=np.uint64)
    legacy = np.asarray([[0, 8, 4, tex.ADDRESS_MIRROR],
                         [85, 4, 3, tex.ADDRESS_WRAP],
                         [106, 1, 1, tex.ADDRESS_CLAMP]], np.int32)
    stack = tex.make_material_stack(rows.astype(np.uint32), legacy)
    stack["meta"][2, 4] = -1
    if not extras:
        stack["extra"] = np.zeros((1, 6), np.int32)
        stack["meta"][:, 4] = -1
    params = r.uniform(0.0, 1.0, (3, 16)).astype(np.float32)
    params[:, 10] = [0.5, 1.0, 1.5]
    params[:, 11] = 0.5
    params[:, 12] = [1.0, 2.0, 0.0]
    interp = np.zeros((16, h, w), np.float32)
    interp[0:2] = r.uniform(-1.5, 2.5, (2, h, w))
    interp[2:8] = r.normal(size=(6, h, w))
    interp[8] = r.choice([-1.0, 1.0], (h, w))
    interp[9] = r.integers(0, 3, (h, w))
    if wild_mats:
        interp[9, ::5, ::3] = r.choice([-2.0, 3.0, 7.0], interp[9, ::5,
                                                               ::3].shape)
    interp[10:14] = (10.0 ** r.uniform(-3.5, 0.0, (4, h, w))
                     * r.choice([-1.0, 1.0], (4, h, w)))
    tri = np.where(r.random((h, w)) < 0.2, -1,
                   r.integers(0, 1000, (h, w))).astype(np.int32)
    vp = View.from_lookat([0.5, 1.0, -3.0], [0.0, 0.0, 5.0],
                          aspect=w / h).view_proj()
    return dict(stack=stack, mat_params=params, tri=tri,
                depth=r.uniform(0.02, 1.0, (h, w)).astype(np.float32),
                interp=interp,
                inv_view_proj=np.linalg.inv(vp).astype(np.float32))


def decal_inputs(seed=0, h=128, w=256, n_chunks=96, row0=0, fail=0.25):
    """numpy inputs of one decal step: material_inputs' channels as the
    decal layer (d_interp, d_depth, inv_view_proj, and its stack and
    materials), its triangles on n_chunks 128-pixel chunks chosen at
    random from row row0 on (those above empty; a chosen chunk about 60%
    covered, at least one pixel), the scene's depth (about `fail` of the
    pixels behind the decal by more than 1e-5, a tenth level with it, the
    rest in front: the decal's GREATER_EQUAL test fails, passes at its
    edge, passes), a random GBuffer's base_color, normals and mrao, and a
    unit mapped normal n3 -> dict(stack, mat_params, d_tri, d_depth,
    d_interp, inv_view_proj, depth, base_color, normals, mrao, n3)."""
    inp = material_inputs(seed=seed, h=h, w=w)
    r = np.random.default_rng(seed + 1)
    n = -(-h * w // 128)             # the last chunk may be ragged
    first = (row0 * w + 127) // 128
    chunk_on = np.zeros(n, bool)
    chunk_on[first + r.choice(n - first, n_chunks, replace=False)] = True
    on = (r.random((h, w)) < 0.6) & np.repeat(chunk_on, 128)[:h * w] \
        .reshape(h, w)
    on.reshape(-1)[np.minimum(np.flatnonzero(chunk_on) * 128
                              + r.integers(0, 128, n_chunks),
                              h * w - 1)] = True
    d_depth = inp["depth"]
    u = r.random((h, w))
    depth = np.where(u < fail, d_depth + r.uniform(2e-5, 0.05, (h, w)),
                     np.where(u < fail + 0.1, d_depth,
                              d_depth - r.uniform(0.0, 0.05, (h, w))))
    n3 = r.normal(size=(h, w, 3))
    n3 /= np.linalg.norm(n3, axis=-1, keepdims=True)
    f32 = lambda x: np.asarray(x, np.float32)
    return dict(stack=inp["stack"], mat_params=inp["mat_params"],
                d_tri=np.where(on, r.integers(0, 1000, (h, w)),
                               -1).astype(np.int32),
                d_depth=d_depth, d_interp=inp["interp"],
                inv_view_proj=inp["inv_view_proj"], depth=f32(depth),
                base_color=f32(r.random((h, w, 4))),
                normals=f32(r.random((h, w, 2))),
                mrao=f32(r.random((h, w, 4))), n3=f32(n3))

EDGE_CASES = ("mixed", "empty", "magnified", "last_level", "tails",
              "address", "alternating")


def edge_inputs(case, h, w, seed=0):
    """numpy inputs of one resolve (material_inputs' keys) on a stack of
    four block-encoded materials -- 16x16 with 5 mips, wrap, extras; 8x8
    with 4, mirror, no extras; 16x16 with 5, clamp, extras; 4x4 with 3,
    wrap, no extras -- and an h x w layer, every pixel covered but in
    `case`:
    mixed: random materials, uv in [-1.5, 2.5], footprints from far
      below mip 0 to past the last mip;
    empty: no pixel covered;
    magnified: every LOD below 0 (level 0 alone, the second skipped);
    last_level: every LOD past the last mip (clamped to it);
    tails: LODs between the first mip smaller than a 4x4 block and the
      last;
    address: level 0, uv on texel centres, edges and just inside them,
      around and past the texture's edges, in every address mode;
    alternating: a material with extras blocks and one without on
      alternate pixels of a row."""
    from incarnation_tpu_torch.core.view import View
    from incarnation_tpu_torch.scene import textures as tex
    r = np.random.default_rng(seed)
    sizes = np.asarray([16, 8, 16, 4])
    levels = np.asarray([5, 4, 5, 3])
    modes = [tex.ADDRESS_WRAP, tex.ADDRESS_MIRROR, tex.ADDRESS_CLAMP,
             tex.ADDRESS_WRAP]
    texels = [sum(max(s >> k, 1) ** 2 for k in range(n))
              for s, n in zip(sizes, levels)]
    legacy = np.asarray([[sum(texels[:m]), sizes[m], levels[m], modes[m]]
                         for m in range(4)], np.int32)
    rows = r.integers(0, 2 ** 32, (sum(texels), 4), dtype=np.uint64)
    stack = tex.make_material_stack(rows.astype(np.uint32), legacy)
    stack["meta"][[1, 3], 4] = -1
    params = r.uniform(0.0, 1.0, (4, 16)).astype(np.float32)
    params[:, 10] = [0.5, 1.0, 1.5, 0.75]
    params[:, 11] = 0.5
    params[:, 12] = [1.0, 2.0, 0.0, 1.0]
    interp = np.zeros((16, h, w), np.float32)
    interp[2:8] = r.normal(size=(6, h, w))
    interp[8] = r.choice([-1.0, 1.0], (h, w))
    mat = r.integers(0, 4, (h, w))
    if case == "alternating":
        mat = np.broadcast_to(np.arange(w) % 2, (h, w))
    size = sizes[mat].astype(np.float32)
    lod = r.uniform(-3.0, levels[mat] + 1.0)
    uv = r.uniform(-1.5, 2.5, (2, h, w))
    if case == "magnified":
        lod = r.uniform(-12.0, -0.5, (h, w))
    elif case == "last_level":
        lod = levels[mat] - 1 + r.uniform(0.0, 4.0, (h, w))
    elif case == "tails":
        first_tail = np.log2(size) - 1          # the first mip under 4x4
        lod = r.uniform(first_tail, levels[mat] - 1)
    elif case == "address":
        lod = r.uniform(-6.0, -1.0, (h, w))
        n = r.choice([-1, 0, 1], (2, h, w)) * size \
            + r.choice([-1, 0, -2], (2, h, w)) * (r.random((2, h, w)) < 0.5)
        uv = (n + r.choice([0.0, 0.25, 0.5, 0.999, 1.0], (2, h, w))) / size
    interp[0:2] = uv
    interp[9] = mat
    # derivatives of lengths 2^lod / size (rho = 2^lod), the largest a
    # random one of the four, the others at most half of it
    d = (2.0 ** lod / size) * r.choice([-1.0, 1.0], (4, h, w))
    d = d * np.where(np.arange(4)[:, None, None]
                     == r.integers(0, 4, (h, w)), 1.0,
                     r.uniform(0.0, 0.5, (4, h, w)))
    interp[10:14] = d
    tri = (np.full((h, w), -1, np.int32) if case == "empty"
           else r.integers(0, 1000, (h, w)).astype(np.int32))
    vp = View.from_lookat([0.5, 1.0, -3.0], [0.0, 0.0, 5.0],
                          aspect=w / h).view_proj()
    return dict(stack=stack, mat_params=params, tri=tri,
                depth=r.uniform(0.02, 1.0, (h, w)).astype(np.float32),
                interp=interp,
                inv_view_proj=np.linalg.inv(vp).astype(np.float32))


def material_scene(inputs, dev):
    """The port's view of material_inputs: (scene namespace with mat_stack
    and mat_params, tri, depth, interp, inv_view_proj) on dev."""
    from incarnation_tpu_torch.scene import textures as tex
    f = lambda x: torch.tensor(x, device=dev)
    scene = SimpleNamespace(mat_stack=tex.material_stack(inputs["stack"], dev),
                            mat_params=f(inputs["mat_params"]))
    return (scene, f(inputs["tri"]), f(inputs["depth"]), f(inputs["interp"]),
            f(inputs["inv_view_proj"]))


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


def _alpha_scene(dev, n=20000):
    """The port's testing scene with its MASK quad and a BLEND quad, n rays
    toward both from in front, and one noise value per ray."""
    from incarnation_tpu_torch.scene import testing
    scene = testing.make_rich_scene(device=dev, blend_quad=True)
    r = np.random.default_rng(5)
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


# more rays than the persistent grid's lanes at once (132 SMs x at most
# 16 blocks x 128 threads), so warps take rays from the counter many
# times; neither a multiple of 32 nor of any grid of 128-thread blocks
K4_MANY_RAYS = 300_007


def _k4_role(dev, layout, alpha, monkeypatch):
    """(bvh, rays(n, seed) -> (o, d, noise or None), filt(noise) -> a
    pathtrace.AlphaFilter or None) of one K4 role: the soup's BVH, or the
    testing scene's with an alpha filter, in the layout asked."""
    from incarnation_tpu_torch.kernels import pathtrace
    if layout == "split":
        monkeypatch.setattr(bvh, "_MERGE_LIMIT", 0)
    if alpha:
        scene, _, _, _ = _alpha_scene(dev, 8)
        b = bvh.build_scene_bvh(scene, use_cache=False,
                                wide=layout == "wide", device=dev)

        def rays(n, seed):
            _, o, d, noise = _alpha_scene(dev, n)
            perm = torch.tensor(np.random.default_rng(seed).permutation(n),
                                device=dev)
            return o[perm].contiguous(), d[perm].contiguous(), noise[perm]
    else:
        tris, b = _k4_bvh(dev)
        if layout != "wide":
            rows, links, _ = bvh.build_lbvh(tris)
            rows[:, 11] = 1.0
            rows[:, bvh._DS1_OFF:bvh._DS1_OFF + 3] = 1.0
            b = bvh._finish_bvh(rows, links, dev)

        def rays(n, seed):
            o, d = _k4_rays(dev, max(n, 600), seed)
            pick = torch.tensor(np.random.default_rng(seed).permutation(
                o.shape[0])[:n], device=dev)
            return o[pick].contiguous(), d[pick].contiguous(), None
    assert b.layout == {"wide": 0, "merged": 1, "split": 2}[layout]
    return b, rays, (lambda noise: None if noise is None
                     else pathtrace.AlphaFilter(scene, noise))


@pytest.mark.parametrize("alpha", [False, True], ids=["bare", "alpha"])
@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("layout", ["wide", "merged", "split"])
def test_k4_persistent_warps_every_role(dev, layout, any_hit, alpha,
                                        monkeypatch):
    """Every compiled role of K4 (layout x any hit x alpha filter):
    identical to the twin (tri, t, u, v, steps) on fewer rays than one
    warp (a thread a ray), on K4_MANY_RAYS (persistent warps), on as many
    rays mixing walks of very different lengths (a third, parked far away,
    end after one row: lanes are refilled), and on two launches in a row on
    one stream (persistent, then a thread a ray); K4's counters are zero
    after each launch."""
    b, rays, filt = _k4_role(dev, layout, alpha, monkeypatch)

    def check(got, o, d, noise):
        torch.cuda.synchronize()
        assert torch.count_nonzero(bvh._k4_counters(dev)) == 0
        ref = bvh.trace_plain(b, o, d, 0.05, 25.0, any_hit,
                              return_steps=True, alpha_of=filt(noise))
        _assert_k4(got, ref)
        assert torch.equal(got["steps"], ref["steps"])
        return ref

    def launch(o, d, noise):
        return bvh.trace_k4(b, o, d, 0.05, 25.0, any_hit, return_steps=True,
                            alpha_of=filt(noise))

    few = rays(7, 11)
    check(launch(*few), *few)
    many = rays(K4_MANY_RAYS, 12)
    ref = check(launch(*many), *many)
    assert (ref["tri"] >= 0).any()
    o, d, noise = rays(K4_MANY_RAYS, 13)
    park = torch.tensor(np.random.default_rng(14).random(K4_MANY_RAYS)
                        < 1 / 3, device=dev)
    o = torch.where(park[:, None], torch.full_like(o, 1e29), o)
    ref = check(launch(o, d, noise), o, d, noise)
    assert int(ref["steps"][park].max()) == 1
    assert float(ref["steps"][~park].double().mean()) > 2
    second = rays(12_345, 15)
    a = launch(o, d, noise)
    c = launch(*second)
    check(a, o, d, noise)
    check(c, *second)


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


def _close_to_twin(got, ref, what, rtol=1e-5, atol_frac=1e-5):
    """chip_smoke.py's _close: |got - ref| <= rtol |ref| + atol_frac x the
    median nonzero |ref|."""
    mag = ref.abs()
    nonzero = mag[mag > 0]
    atol = atol_frac * float(nonzero.median()) if nonzero.numel() else 0.0
    bad = int(((got - ref).abs() > rtol * mag + atol).sum())
    assert bad == 0, f"{what}: {bad} of {ref.numel()} elements"


@pytest.mark.parametrize("extras", [True, False], ids=["extras", "no_extras"])
@pytest.mark.parametrize("normal3", [False, True], ids=["gbuffer", "normal3"])
def test_k5_matches_twin(dev, extras, normal3):
    """K5 against resolve_gbuffer_plain on the card: the mask and uv
    exactly, every float plane to K5's 1e-5 (torch.cross and the 4x4
    product round in their own order), zeros off the mask; with an extras
    table and without one, with and without the mapped normal; material
    ids outside the table clamp as the twin's gathers do."""
    scene, tri, depth, interp, ivp = material_scene(
        material_inputs(seed=11, h=72, w=200, extras=extras,
                        wild_mats=True), dev)
    h, w = tri.shape
    n0 = resolve.K5.launches
    got = resolve.resolve_gbuffer(tri, depth, scene, interp, ivp, w, h,
                                  return_normal3=normal3)
    ref = resolve.resolve_gbuffer_plain(tri, depth, scene, interp, ivp, w, h,
                                        return_normal3=normal3)
    assert resolve.K5.launches == n0 + 1
    if normal3:
        (got, g3), (ref, r3) = got, ref
        _close_to_twin(g3, r3, "normal3")
    assert torch.equal(got.mask, ref.mask) and torch.equal(got.uv, ref.uv)
    for f in ("base_color", "normals", "mrao", "emissive", "world_pos",
              "extras"):
        _close_to_twin(getattr(got, f), getattr(ref, f), f)
        assert not bool(getattr(got, f)[~got.mask].any()), f
    if extras:
        assert float(got.emissive.abs().max()) > 0
    with pytest.raises(ValueError, match="interp"):
        resolve.resolve_gbuffer(tri, depth, scene, interp[:, :, :-1], ivp,
                                w, h)


@pytest.mark.parametrize("shape", [(1, 1), (23, 37), (9, 33), (544, 1920)],
                         ids=lambda s: f"{s[1]}x{s[0]}")
@pytest.mark.parametrize("case", EDGE_CASES)
def test_k5_edge_cases_match_twin(dev, case, shape):
    """K5 against its twin, as test_k5_matches_twin holds it, with the
    mapped normal, on edge_inputs' layers at widths and heights that are
    not multiples of K5's 32x8 tile (1x1, 37x23, 33x9 and a 1920x544
    band): an empty layer (every plane zero, uv copied), LODs all below
    0 or past the last mip (the second level skipped), mip tails smaller
    than a block, every address mode at the texture's edges, and
    materials with and without extras blocks on alternate pixels of a
    warp."""
    h, w = shape
    scene, tri, depth, interp, ivp = material_scene(
        edge_inputs(case, h, w, seed=13), dev)
    got, g3 = resolve.resolve_gbuffer(tri, depth, scene, interp, ivp, w, h,
                                      return_normal3=True)
    ref, r3 = resolve.resolve_gbuffer_plain(tri, depth, scene, interp, ivp,
                                            w, h, return_normal3=True)
    assert torch.equal(got.mask, ref.mask) and torch.equal(got.uv, ref.uv)
    assert torch.equal(got.uv, torch.stack([interp[0], interp[1]], -1))
    _close_to_twin(g3, r3, "normal3")
    for f in ("base_color", "normals", "mrao", "emissive", "world_pos",
              "extras"):
        _close_to_twin(getattr(got, f), getattr(ref, f), f)
        assert not bool(getattr(got, f)[~got.mask].any()), f
    assert not bool(g3[~got.mask].any())
    assert bool(got.mask.any()) == (case != "empty")


def test_k5_refuses_misaligned_tables(dev):
    """resolve_gbuffer raises instead of launching K5 where the extras
    table is not 8-byte aligned: K5 loads its 24-byte rows as 8-byte
    words."""
    import dataclasses
    scene, tri, depth, interp, ivp = material_scene(
        material_inputs(seed=3, h=8, w=40), dev)
    ex = scene.mat_stack.extra
    shifted = torch.empty(ex.numel() + 1, dtype=ex.dtype,
                          device=dev)[1:].view(ex.shape)
    shifted.copy_(ex)
    assert shifted.data_ptr() % 8 == 4
    scene.mat_stack = dataclasses.replace(scene.mat_stack, extra=shifted)
    n0 = resolve.K5.launches
    with pytest.raises(ValueError, match="mat_stack.extra"):
        resolve.resolve_gbuffer(tri, depth, scene, interp, ivp, 40, 8)
    assert resolve.K5.launches == n0


@pytest.mark.parametrize("row0", [0, 37])
def test_k6_matches_twin(dev, row0):
    """K6 against masked_alpha_plain on the card: the twin's operations in
    its order (sqrt and log2 the same library functions), so alpha and
    the threshold equal bit for bit and every pass/fail decision agrees,
    for MASK and BLEND materials, in a band starting at row0."""
    scene, tri, _, interp, _ = material_scene(
        material_inputs(seed=12, h=72, w=200, wild_mats=True), dev)
    n0 = resolve.K6.launches
    alpha, thresh = resolve.masked_alpha(scene, tri, interp, row0)
    ra, rt = resolve.masked_alpha_plain(scene, tri, interp, row0)
    assert resolve.K6.launches == n0 + 1
    assert torch.equal(alpha, ra) and torch.equal(thresh, rt)
    passed = alpha >= thresh
    assert 0.05 < float(passed.float().mean()) < 0.95
    blend = scene.mat_params[interp[9].long().clamp(0, 2), 12] >= 2.0
    assert bool(blend.any()) and bool((~blend).any())


# the stochastic roles of K5 and K6 (kernels/resolve.py R_*): the frame
# index, the anisotropy limit, and for K5 the checker parity and a chunk
# capacity (2 of a layer's chunks: an overflow)
STOCH_ROLES = {
    "dither": dict(mip_dither=3),
    "jitter": dict(mip_dither=4, uv_dither=True),
    "jitter_iso": dict(mip_dither=5, uv_dither=True, max_aniso=1.0),
    "checker0": dict(mip_dither=6, uv_dither=True, checker_parity=0),
    "checker1": dict(mip_dither=7, uv_dither=True, checker_parity=1),
    "exact_chunks": dict(coverage_capacity=2),
    "jitter_chunks": dict(mip_dither=8, uv_dither=True, coverage_capacity=2),
}


@pytest.mark.parametrize("row0", [0, 37])
@pytest.mark.parametrize("shape", [(64, 200), (24, 37), (16, 64)],
                         ids=lambda s: f"{s[1]}x{s[0]}")
@pytest.mark.parametrize("role", sorted(STOCH_ROLES))
def test_k5_stochastic_roles_match_twin(dev, role, shape, row0):
    """Each stochastic role of K5 against resolve_gbuffer_plain on the
    card, as test_k5_matches_twin holds the exact one: the mask and the uv
    (moved along the major axis) identical, every float plane to 1e-5,
    zeros off the mask; the checkerboard for either parity, its fetching
    neighbours across K5's 32-pixel warps (a 200-pixel row), at an odd
    width (37: the checkerboard falls back to every pixel's fetch, as
    JAX's condition does) and with chunk capacities that overflow (the
    200 x 64 and 64 x 16 layers hold whole chunks). Each launch counts
    under its role's name."""
    h, w = shape
    kw = dict(STOCH_ROLES[role], row0=row0)
    if "coverage_capacity" in kw and (h * w) % resolve.CHUNK_PX:
        pytest.skip("a chunk capacity needs whole 128-pixel chunks")
    scene, tri, depth, interp, ivp = material_scene(
        material_inputs(seed=21, h=h, w=w, wild_mats=True), dev)
    before = dict(resolve.K5.by_name)
    got, g3 = resolve.resolve_gbuffer(tri, depth, scene, interp, ivp, w, h,
                                      return_normal3=True, **kw)
    ref, r3 = resolve.resolve_gbuffer_plain(tri, depth, scene, interp, ivp,
                                            w, h, return_normal3=True, **kw)
    name = resolve.role_name(resolve._role(
        kw.get("mip_dither"), kw.get("uv_dither", False),
        resolve._checker_on(kw.get("checker_parity"), kw.get("uv_dither"), w,
                            kw.get("coverage_capacity"))),
        "coverage_capacity" in kw)
    assert resolve.K5.by_name.get(name, 0) == before.get(name, 0) + 1
    assert ("checker" in name) == ("checker" in role and w % 2 == 0)
    assert torch.equal(got.mask, ref.mask) and torch.equal(got.uv, ref.uv)
    _close_to_twin(g3, r3, "normal3")
    for f in ("base_color", "normals", "mrao", "emissive", "world_pos",
              "extras"):
        _close_to_twin(getattr(got, f), getattr(ref, f), f)
        assert not bool(getattr(got, f)[~got.mask].any()), f


@pytest.mark.parametrize("row0", [0, 37])
@pytest.mark.parametrize("role", ["dither", "jitter", "jitter_iso",
                                  "exact_chunks", "jitter_chunks"])
def test_k6_stochastic_roles_match_twin(dev, role, row0):
    """Each stochastic role of K6 against masked_alpha_plain: alpha and the
    threshold (the BLEND noise seeded by the frame) bit for bit, in a band
    starting at row0; a dropped chunk reads alpha 1.0."""
    kw = dict(STOCH_ROLES[role])
    scene, tri, _, interp, _ = material_scene(
        material_inputs(seed=22, h=64, w=200, wild_mats=True), dev)
    before = resolve.K6.launches
    alpha, thresh = resolve.masked_alpha(scene, tri, interp, row0, **kw)
    ra, rt = resolve.masked_alpha_plain(scene, tri, interp, row0, **kw)
    assert resolve.K6.launches == before + 1
    assert torch.equal(alpha, ra) and torch.equal(thresh, rt)
    assert 0.05 < float((alpha >= thresh).float().mean()) < 0.95
    exact_t = resolve.masked_alpha_plain(scene, tri, interp, row0)[1]
    assert not torch.equal(thresh, exact_t) or "mip_dither" not in kw


# K5's checkerboard role at even widths that are not multiples of a warp's
# span (62 pixels) or of 32 or 64, from 2 up
CHECKER_WIDTHS = (2, 6, 30, 34, 60, 62, 66, 94, 98, 126, 130)


@pytest.mark.parametrize("row0", [0, 37])
@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("w", CHECKER_WIDTHS)
def test_k5_checker_widths_match_twin(dev, w, parity, row0):
    """K5's checkerboard role against resolve_gbuffer_plain, as
    test_k5_stochastic_roles_match_twin holds it, at even widths from 2 to
    130 for either parity, on a random layer and on one whose only
    covered pixels stand alone at the ends of K5's 62-pixel spans (x = 0,
    61, 62, 63, 123, 124, 125, w - 1): each filling pixel there takes its
    neighbours' texels across a span's end, edge-clamped at the row's."""
    h = 9
    kw = dict(mip_dither=6 + parity, uv_dither=True, checker_parity=parity,
              row0=row0)
    for sparse in (False, True):
        inp = material_inputs(seed=w + 100 * parity + sparse, h=h, w=w,
                              wild_mats=True)
        if sparse:
            tri = np.full((h, w), -1, np.int32)
            tri[:, sorted({x % w for x in (0, 61, 62, 63, 123, 124, 125,
                                           w - 1)})] = 5
            inp["tri"] = tri
        scene, tri, depth, interp, ivp = material_scene(inp, dev)
        before = resolve.K5.by_name.get("jitter_checker", 0)
        got, g3 = resolve.resolve_gbuffer(tri, depth, scene, interp, ivp, w,
                                          h, return_normal3=True, **kw)
        ref, r3 = resolve.resolve_gbuffer_plain(tri, depth, scene, interp,
                                                ivp, w, h,
                                                return_normal3=True, **kw)
        assert resolve.K5.by_name["jitter_checker"] == before + 1
        assert torch.equal(got.mask, ref.mask) and torch.equal(got.uv,
                                                                ref.uv)
        _close_to_twin(g3, r3, "normal3")
        for f in ("base_color", "normals", "mrao", "emissive", "world_pos",
                  "extras"):
            _close_to_twin(getattr(got, f), getattr(ref, f), f)
            assert not bool(getattr(got, f)[~got.mask].any()), f


@pytest.fixture
def peel_twin(monkeypatch):
    """masked_peel_plain with its alpha test in torch (masked_alpha_plain),
    not through K6's masked_alpha role."""
    monkeypatch.setattr(resolve, "masked_alpha", resolve.masked_alpha_plain)
    return resolve.masked_peel_plain


def peel_inputs(dev, h, w, seed=0, hit_chunks=None, hit=0.6, acc=0.4,
                chunk_over=3):
    """One masked peel's step on dev, from a seed: (scene, m_tri, m_depth,
    m_interp, state). material_inputs' tables and channels; m_tri covers a
    pixel with probability `hit`, in hit_chunks chunks of 128 pixels
    chosen at random (every chunk where None); the accumulators hold a
    triangle on an `acc` share of the pixels, random depths and channels,
    a running chunk overflow of chunk_over and a stale overflow of 7."""
    r = np.random.default_rng(seed)
    inp = material_inputs(seed=seed, h=h, w=w, wild_mats=True)
    on = r.random((h, w)) < hit
    if hit_chunks is not None:
        n = (h * w) // 128
        pick = np.zeros(n, bool)
        pick[r.choice(n, hit_chunks, replace=False)] = True
        on &= np.repeat(pick, 128).reshape(h, w)
        # each picked chunk holds a hit
        first = np.flatnonzero(pick) * 128 + r.integers(0, 128, hit_chunks)
        on.reshape(-1)[first] = True
    tri = np.where(on, r.integers(0, 1000, (h, w)), -1).astype(np.int32)
    acc_tri = np.where(r.random((h, w)) < acc, r.integers(0, 1000, (h, w)),
                       -1).astype(np.int32)
    scene, _, depth, interp, _ = material_scene(inp, dev)
    t = lambda x, dt=torch.float32: torch.tensor(x, dtype=dt, device=dev)
    state = resolve.PeelState(
        tri=t(acc_tri, torch.int32),
        depth=t(r.random((h, w))), interp=t(r.random((16, h, w))),
        z_limit=t(r.random((h, w))),
        chunk_overflow=t(chunk_over, torch.int64),
        overflow=t(7, torch.int64))
    return scene, t(tri, torch.int32), depth, interp, state


def _peel_clone(state):
    return resolve.PeelState(*(getattr(state, f.name).clone()
                               for f in dataclasses.fields(state)))


def _assert_peel(got, ref, what):
    """Every field of two PeelStates identical."""
    for f in dataclasses.fields(ref):
        g, r = getattr(got, f.name), getattr(ref, f.name)
        assert g.dtype == r.dtype and g.shape == r.shape, (what, f.name)
        assert torch.equal(g, r), (
            f"{what}: {f.name} differs on {int((g != r).sum())} elements")


def assert_peel_in_place(dev):
    """masked_peel on dev writes its results into the PeelState it is
    given and returns that state: each field keeps its storage, a field
    taken before the call (the z_limit the peel's K1 launch was given)
    holds the new values, and those equal peel_plain's, the peel loop's
    torch code, which leaves its own argument as it was. A capacity of 4
    of 6 chunks with a hit, a running chunk overflow of 0 and a stale
    overflow of 7: both counts change."""
    scene, m_tri, m_depth, m_interp, state = peel_inputs(
        dev, 16, 64, seed=3, hit_chunks=6, chunk_over=0)
    kw = dict(mip_dither=2, uv_dither=True, coverage_capacity=4)
    arg, orig = _peel_clone(state), _peel_clone(state)
    want = resolve.peel_plain(scene, m_tri, m_depth, m_interp, arg, **kw)
    _assert_peel(arg, orig, "peel_plain's argument")
    z_limit = state.z_limit
    ptrs = [getattr(state, f.name).data_ptr()
            for f in dataclasses.fields(state)]
    got = resolve.masked_peel(scene, m_tri, m_depth, m_interp, state, **kw)
    assert got is state
    assert [getattr(state, f.name).data_ptr()
            for f in dataclasses.fields(state)] == ptrs
    _assert_peel(state, want, "the state after the step")
    assert torch.equal(z_limit, want.z_limit)
    assert int(state.chunk_overflow) == 2 and int(state.overflow) != 7


def test_k6_peel_step_updates_state_in_place(dev):
    """K6's peel step keeps the contract its twin keeps on the CPU
    (tests/test_torch_masked_peel.py): assert_peel_in_place on the card."""
    assert_peel_in_place(dev)


def _k6_scratch_zero(dev):
    """K6's peel-step scratch of the current stream is all zero."""
    dev = torch.device(dev.type, torch.cuda.current_device())
    buf = resolve._K6_SCRATCH[(dev.index,
                               torch.cuda.current_stream(dev).cuda_stream)]
    return not bool(buf.any())


# the frame's peel ladder from Config's peel_chunk_capacity (6144): 6144,
# 4096, 1920, 960, 512
LADDER = (6144, 4096, 1920, 960, 512)


@pytest.mark.parametrize("delta", [-1, 0, 1])
@pytest.mark.parametrize("cap", LADDER)
def test_k6_peel_step_around_each_capacity(dev, peel_twin, cap, delta):
    """K6's peel step at 1920x1088 (2,040 blocks of 8 chunks, many more
    than the card holds at once, ranked by the look-back) against its
    twin, with the chunks holding a hit one fewer than, as many as and
    one more than each capacity of the frame's ladder, jittered texels in
    a band starting at row 37: every accumulator, the z_limit and both
    counts identical (one more than the capacity: a chunk overflow of 1);
    the launch counted under its role, the scratch left zero."""
    h, w = 1088, 1920
    scene, m_tri, m_depth, m_interp, state = peel_inputs(
        dev, h, w, seed=cap + delta, hit_chunks=cap + delta, chunk_over=0)
    kw = dict(row0=37, mip_dither=5, uv_dither=True, coverage_capacity=cap)
    ref = peel_twin(scene, m_tri, m_depth, m_interp, _peel_clone(state), **kw)
    before = resolve.K6.by_name.get("step_jitter+chunks", 0)
    got = resolve.masked_peel(scene, m_tri, m_depth, m_interp, state, **kw)
    assert got is state
    assert resolve.K6.by_name["step_jitter+chunks"] == before + 1
    _assert_peel(got, ref, f"capacity {cap}, {cap + delta} chunks")
    assert int(got.chunk_overflow) == max(delta, 0)
    assert _k6_scratch_zero(dev)


K6_STEP_ROLES = {"exact": {}, "dither": dict(mip_dither=3),
                 "jitter": dict(mip_dither=4, uv_dither=True),
                 "jitter_iso": dict(mip_dither=5, uv_dither=True,
                                    max_aniso=1.0)}


@pytest.mark.parametrize("chunks", [False, True], ids=["", "chunks"])
@pytest.mark.parametrize("row0", [0, 37])
@pytest.mark.parametrize("shape", [(37, 53), (1, 1), (64, 200), (33, 128)],
                         ids=lambda s: f"{s[1]}x{s[0]}")
@pytest.mark.parametrize("role", sorted(K6_STEP_ROLES))
def test_k6_peel_step_roles_and_sizes(dev, peel_twin, role, shape, row0,
                                      chunks):
    """K6's peel step in every role against its twin at sizes that are and
    are not whole 128-pixel chunks (37x53 and 1x1: the ragged last chunk,
    no capacity), with a capacity of 3 chunks where the layer has whole
    ones (an overflow past the running max of 3), in a band starting at
    row0; identical state, the scratch zero."""
    h, w = shape
    if chunks and (h * w) % resolve.CHUNK_PX:
        pytest.skip("a chunk capacity needs whole 128-pixel chunks")
    scene, m_tri, m_depth, m_interp, state = peel_inputs(dev, h, w,
                                                         seed=h + w)
    kw = dict(K6_STEP_ROLES[role], row0=row0,
              coverage_capacity=3 if chunks else None)
    ref = peel_twin(scene, m_tri, m_depth, m_interp, _peel_clone(state), **kw)
    got = resolve.masked_peel(scene, m_tri, m_depth, m_interp, state, **kw)
    _assert_peel(got, ref, f"{role} {w}x{h}")
    assert _k6_scratch_zero(dev)


def test_k6_peel_steps_in_a_row_make_no_host_sync(dev, peel_twin):
    """Eight peels of the frame's ladder in a row on one state, as the
    frame runs them (the layers' coverage falling, the state carried),
    under torch.cuda.set_sync_debug_mode("error"): no launch waits for the
    host; then a 64x200 layer and a 1920x1088 one again on the same
    scratch. Each step equals the twin's on the twin's state."""
    h, w = 1088, 1920
    layers = [peel_inputs(dev, h, w, seed=40 + k, hit=0.6 / 2 ** k)
              for k in range(8)]
    scene, state = layers[0][0], layers[0][4]
    ref = _peel_clone(state)
    for k, (_, m_tri, m_depth, m_interp, _) in enumerate(layers):
        cap = LADDER[min(k, len(LADDER) - 1)]
        kw = dict(mip_dither=6, uv_dither=True, coverage_capacity=cap)
        ref = peel_twin(scene, m_tri, m_depth, m_interp, ref, **kw)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            state = resolve.masked_peel(scene, m_tri, m_depth, m_interp,
                                        state, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        _assert_peel(state, ref, f"peel {k}")
    for shape in ((64, 200), (1088, 1920)):
        scene, m_tri, m_depth, m_interp, st = peel_inputs(dev, *shape,
                                                          seed=9)
        kw = dict(coverage_capacity=2)
        ref = peel_twin(scene, m_tri, m_depth, m_interp, _peel_clone(st),
                        **kw)
        _assert_peel(resolve.masked_peel(scene, m_tri, m_depth, m_interp,
                                         st, **kw), ref, f"{shape}")
        assert _k6_scratch_zero(dev)


def test_k6_peel_step_refuses_and_never_falls_back(dev):
    """masked_peel raises instead of launching where an input is not what
    K6 takes (a CPU state, the wrong shape, a capacity on a ragged
    layer), and counts no launch."""
    scene, m_tri, m_depth, m_interp, state = peel_inputs(dev, 37, 53)
    n0 = resolve.K6.launches
    cpu = resolve.PeelState(*(getattr(state, f.name).cpu()
                              for f in dataclasses.fields(state)))
    with pytest.raises(ValueError, match="state.tri"):
        resolve.masked_peel(scene, m_tri, m_depth, m_interp, cpu)
    with pytest.raises(ValueError, match="m_interp"):
        resolve.masked_peel(scene, m_tri, m_depth, m_interp[:9], state)
    with pytest.raises(ValueError, match="chunk capacity"):
        resolve.masked_peel(scene, m_tri, m_depth, m_interp, state,
                            coverage_capacity=2)
    assert resolve.K6.launches == n0


def decal_case(dev, h, w, seed=0, n_chunks=None, row0=0):
    """decal_inputs on dev -> (scene namespace, dict of the step's tensor
    arguments: d_tri, d_depth, d_interp, depth, inv_view_proj, and the
    GBuffer planes and n3 it updates)."""
    from incarnation_tpu_torch.scene import textures as tex
    n = -(-h * w // 128)
    first = (row0 * w + 127) // 128
    want = (n + 1) // 2 if n_chunks is None else n_chunks
    inp = decal_inputs(seed=seed, h=h, w=w, row0=row0,
                       n_chunks=max(min(want, n - first), 0))
    f = lambda x: torch.tensor(x, device=dev)
    scene = SimpleNamespace(mat_stack=tex.material_stack(inp["stack"], dev),
                            mat_params=f(inp["mat_params"]))
    return scene, {k: f(inp[k]) for k in (
        "d_tri", "d_depth", "d_interp", "depth", "inv_view_proj",
        "base_color", "normals", "mrao", "n3")}


def decal_call(step, scene, t, n3=True, **kw):
    """step (decal_step or decal_step_plain) on copies of the GBuffer
    planes and n3 in t -> (overflow, base_color, normals, mrao, n3)."""
    h, w = t["d_tri"].shape
    gb = resolve.GBuffer(base_color=t["base_color"].clone(),
                         normals=t["normals"].clone(), mrao=t["mrao"].clone(),
                         emissive=None, mask=None, world_pos=None, uv=None,
                         extras=None)
    out3 = t["n3"].clone() if n3 else None
    over = step(scene, t["d_tri"], t["d_depth"], t["d_interp"], t["depth"],
                gb, out3, t["inv_view_proj"], w, h, **kw)
    return over, gb.base_color, gb.normals, gb.mrao, out3


def _assert_decal(got, ref, what):
    """Two decal steps' overflow and planes identical bit for bit."""
    assert got[0].dtype == torch.int64 and got[0].shape == ()
    assert int(got[0]) == int(ref[0]), (what, int(got[0]), int(ref[0]))
    for name, g, r in zip(("base_color", "normals", "mrao", "n3"), got[1:],
                          ref[1:]):
        assert _bits_equal(g, r), (
            f"{what}: {name} differs on "
            f"{int((g != r).sum()) if g is not None else 0} elements")


DECAL_ROLES = {"exact": {}, "dither": dict(mip_dither=3),
               "jitter": dict(mip_dither=4, uv_dither=True),
               "jitter_iso": dict(mip_dither=5, uv_dither=True,
                                  max_aniso=1.0)}


@pytest.mark.parametrize("n3", [True, False], ids=["n3", "no_n3"])
@pytest.mark.parametrize("cap", [None, -1, 0, 1], ids=[
    "no_cap", "cap_below", "cap_at", "cap_above"])
@pytest.mark.parametrize("row0", [0, 37])
@pytest.mark.parametrize("shape", [(64, 256), (37, 53), (1, 1), (33, 128)],
                         ids=lambda s: f"{s[1]}x{s[0]}")
@pytest.mark.parametrize("role", sorted(DECAL_ROLES))
def test_k5_decal_step_matches_twin(dev, role, shape, row0, cap, n3):
    """K5's decal step against decal_step_plain in every role, bit for
    bit (the overflow, base colour, normals, mrao and n3), at sizes that
    are and are not whole 128-pixel chunks, in a band starting at row0,
    without a chunk capacity and with one just below, at and above the
    layer's chunks with a decal pixel (one below: an overflow of 1); some
    decal pixels fail the depth test and some sit at its edge. Each
    launch counts under decal_<role>; the scratch is left zero."""
    h, w = shape
    if cap is not None and (h * w) % 128:
        pytest.skip("a chunk capacity needs whole 128-pixel chunks")
    scene, t = decal_case(dev, h, w, seed=h + w + row0)
    have = int((t["d_tri"].reshape(-1, 128) >= 0).any(1).sum()) \
        if cap is not None else 0
    kw = dict(DECAL_ROLES[role], row0=row0,
              coverage_capacity=None if cap is None else max(have + cap, 0))
    ref = decal_call(resolve.decal_step_plain, scene, t, n3, **kw)
    name = "decal_" + resolve.role_name(resolve._role(
        kw.get("mip_dither"), kw.get("uv_dither", False)), cap is not None)
    before = resolve.K5.by_name.get(name, 0)
    got = decal_call(resolve.decal_step, scene, t, n3, **kw)
    assert resolve.K5.by_name[name] == before + 1
    _assert_decal(got, ref, f"{role} {w}x{h} row0 {row0} cap {cap}")
    if cap is not None:
        assert int(got[0]) == (1 if cap == -1 and have else 0)
    assert _k6_scratch_zero(dev)


@pytest.mark.parametrize("delta", [-1, 0, 1])
@pytest.mark.parametrize("role", ["exact", "jitter"])
def test_k5_decal_step_full_frame(dev, role, delta):
    """The decal step at 1920x1088 (2,040 blocks, ranked by the
    look-back) against its twin, bit for bit, under the frame's decal
    capacity (Config.decal_chunk_capacity, 1,024) with the layer's chunks
    holding a decal pixel one fewer than, as many as and one more than it
    (an overflow of 1), and without a capacity."""
    h, w, cap = 1088, 1920, 1024
    scene, t = decal_case(dev, h, w, seed=50 + delta, n_chunks=cap + delta)
    for kw in (dict(DECAL_ROLES[role], coverage_capacity=cap),
               dict(DECAL_ROLES[role])):
        ref = decal_call(resolve.decal_step_plain, scene, t, **kw)
        got = decal_call(resolve.decal_step, scene, t, **kw)
        _assert_decal(got, ref, f"{role} {cap + delta} chunks {kw}")
        if "coverage_capacity" in kw:
            assert int(got[0]) == max(delta, 0)
        assert _k6_scratch_zero(dev)


def test_k5_decal_steps_in_place_without_host_sync(dev):
    """Decal steps back to back under set_sync_debug_mode("error") (the
    frame's jittered role with its capacity, the exact role, a 64x256
    layer on the same scratch, a 1920x1088 one again): each writes into
    the planes and n3 it is given (their storage kept; the overflow a 0-dim
    int64 on the card), equals the twin bit for bit, waits for nothing and
    leaves the scratch zero; a K6 peel step after them finds its scratch
    zero."""
    cases = [(1088, 1920, dict(mip_dither=6, uv_dither=True,
                               coverage_capacity=1024)),
             (1088, 1920, {}), (64, 256, dict(coverage_capacity=3)),
             (1088, 1920, dict(mip_dither=7, uv_dither=True,
                               coverage_capacity=512))]
    for k, (h, w, kw) in enumerate(cases):
        scene, t = decal_case(dev, h, w, seed=60 + k)
        ref = decal_call(resolve.decal_step_plain, scene, t, **kw)
        gb = resolve.GBuffer(base_color=t["base_color"],
                             normals=t["normals"], mrao=t["mrao"],
                             emissive=None, mask=None, world_pos=None,
                             uv=None, extras=None)
        ptrs = [x.data_ptr() for x in (gb.base_color, gb.normals, gb.mrao,
                                       t["n3"])]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            over = resolve.decal_step(
                scene, t["d_tri"], t["d_depth"], t["d_interp"], t["depth"],
                gb, t["n3"], t["inv_view_proj"], w, h, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert [x.data_ptr() for x in (gb.base_color, gb.normals, gb.mrao,
                                       t["n3"])] == ptrs
        assert over.is_cuda and over.shape == ()
        _assert_decal((over, gb.base_color, gb.normals, gb.mrao, t["n3"]),
                      ref, f"step {k}")
        assert _k6_scratch_zero(dev)
    scene, m_tri, m_depth, m_interp, state = peel_inputs(
        dev, 16, 64, seed=3, hit_chunks=6, chunk_over=0)
    resolve.masked_peel(scene, m_tri, m_depth, m_interp, state,
                        coverage_capacity=4)
    assert int(state.chunk_overflow) == 2 and _k6_scratch_zero(dev)


def test_k5_decal_step_refuses_and_never_falls_back(dev):
    """decal_step raises instead of launching on what K5's decal step does
    not take (a wrong type, shape or device, a strided plane, a capacity
    on a layer of ragged chunks, a negative row0); nothing launches."""
    n0 = resolve.K5.launches

    def call(shape=(16, 64), cap=None, row0=0, **over):
        scene, t = decal_case(dev, *shape, seed=1)
        x = dict(t, **over)
        gb = resolve.GBuffer(base_color=x["base_color"],
                             normals=x["normals"], mrao=x["mrao"],
                             emissive=None, mask=None, world_pos=None,
                             uv=None, extras=None)
        h, w = shape
        return resolve.decal_step(
            scene, x["d_tri"], x["d_depth"], x["d_interp"], x["depth"], gb,
            x["n3"], x["inv_view_proj"], w, h, coverage_capacity=cap,
            row0=row0)
    with pytest.raises(ValueError, match="d_tri"):
        call(d_tri=torch.zeros(16, 64, dtype=torch.int64, device=dev))
    with pytest.raises(ValueError, match="depth"):
        call(depth=torch.zeros(16, 64))
    with pytest.raises(ValueError, match="base_color"):
        call(base_color=torch.zeros(16, 64, 3, device=dev))
    with pytest.raises(ValueError, match="normals"):
        call(normals=torch.zeros(16, 64, 4, device=dev)[..., :2])
    with pytest.raises(ValueError, match="n3"):
        call(n3=torch.zeros(16, 64, 3, dtype=torch.float64, device=dev))
    with pytest.raises(ValueError, match="row0"):
        call(row0=-1)
    with pytest.raises(ValueError, match="chunk capacity"):
        call(shape=(3, 5), cap=1)
    assert resolve.K5.launches == n0


# ---------------------------------------------------------------------------
# K8: sky lighting
# ---------------------------------------------------------------------------

K8_TOL = 1e-5   # of the twin's peak radiance, as chip_smoke.py holds K8

# sky_lighting options of each case: the IBL lobes, lighting_only, and
# which of HBAO, bent normals and extras are given
SKY_OPTIONS = {
    "all_inputs": dict(hbao=True, bent=True, extras=True),
    "no_extras": dict(),
    "hbao_bent": dict(hbao=True, bent=True),
    "diffuse_only": dict(specular_ibl=False, hbao=True, extras=True),
    "specular_only": dict(diffuse_ibl=False, bent=True, extras=True),
    "lighting_only": dict(lighting_only=True, extras=True),
    "no_lobe": dict(diffuse_ibl=False, specular_ibl=False, hbao=True),
}


def sky_inputs(seed=0, h=24, w=40, covered=0.85):
    """numpy inputs of one sky lighting pass on an h x w layer: a GBuffer
    (base colour, mrao, extras, mask), unit normals n and bent normals, view
    vectors v and an AO map. Roughness is exactly 1 (the last mip level)
    on the first column and 0 on the second; on every third row v is
    grazing or behind the surface, so NoV takes the 0.01 clamp; uncovered
    pixels hold NaN in every input but the two that pick a cube level
    (roughness and the clearcoat roughness: the twin indexes the level
    table with them, and a NaN index is an error), and K8 must write
    zeros there."""
    r = np.random.default_rng(seed)

    def unit(shape):
        x = r.normal(size=shape)
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    n = unit((h, w, 3))
    v = n + unit((h, w, 3)) * 0.9
    v[::3] = unit((len(range(0, h, 3)), w, 3)) - 1.2 * n[::3]
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    mrao = r.uniform(0.0, 1.0, (h, w, 4))
    mrao[:, 0, 1] = 1.0
    mrao[:, 1 % w, 1] = 0.0
    f = dict(base_color=r.uniform(0, 1, (h, w, 4)), mrao=mrao,
             extras=r.uniform(0, 1, (h, w, 3)), n=n, v=v,
             bent=unit((h, w, 3)), hbao=r.uniform(0, 1, (h, w)))
    f = {k: x.astype(np.float32) for k, x in f.items()}
    mask = r.random((h, w)) < covered
    keep = {"mrao": 1, "extras": 2}
    for k, x in f.items():
        lvl = x[..., keep[k]].copy() if k in keep else None
        x[~mask] = np.nan
        if lvl is not None:
            x[..., keep[k]] = lvl
    f["mask"] = mask
    return f


def sky_probe(dev):
    """A small probe (16^2 cube, an 8^2 prefiltered chain of 4 levels,
    packed addressing) from a Preetham sky, and the env-BRDF LUT of 16^2,
    raw and packed."""
    from incarnation_tpu_torch.kernels import ibl, sky
    sun = torch.tensor([0.4, 0.6, 0.69], device=dev)
    probe = ibl.build_probe(sky.sky_latlong(sun / sun.norm(), 2.0, 32, 16),
                            envmap_size=16, num_samples=64)
    lut = ibl.env_brdf_lut(16, 64, device=dev)
    return probe, lut, ibl.pack_env_brdf(lut)


def sky_call(inputs, dev, probe, lut, opts, analytic):
    """sky_lighting's arguments on dev for sky_inputs' arrays and the
    options of a SKY_OPTIONS case -> (args, kwargs)."""
    t = {k: torch.tensor(x, device=dev) for k, x in inputs.items()}
    gb = resolve.GBuffer(base_color=t["base_color"], normals=None,
                         mrao=t["mrao"], emissive=None, mask=t["mask"],
                         world_pos=None, uv=None, extras=t["extras"])
    o = dict(opts)
    kw = dict(hbao=t["hbao"] if o.pop("hbao", False) else None,
              bent_normals=t["bent"] if o.pop("bent", False) else None,
              extras=t["extras"] if o.pop("extras", False) else None,
              analytic_env_brdf=analytic, **o)
    return (gb, t["n"], t["v"], probe, lut, 25000.0), kw


def _k8_close(got, ref, mask, what):
    """K8 within K8_TOL of the twin's peak radiance over covered pixels,
    exact zeros on the others."""
    assert not bool(got[~mask].any()) and not bool(ref[~mask].any()), what
    if bool(mask.any()):
        peak = float(ref[mask].abs().max())
        err = float((got - ref)[mask].abs().max())
        assert err <= K8_TOL * peak, f"{what}: {err:.3e} of peak {peak:.3e}"


@pytest.mark.parametrize("cube_packed", [True, False],
                         ids=["packed_cube", "raw_cube"])
@pytest.mark.parametrize("env", ["analytic", "lut_packed", "lut_raw"])
@pytest.mark.parametrize("opts", sorted(SKY_OPTIONS))
def test_k8_matches_twin(dev, opts, env, cube_packed):
    """K8 against sky_lighting_plain on the card over the option grid: both
    IBL lobes on or off, lighting_only, HBAO, bent normals and extras given
    or not, the analytic env BRDF or the LUT in either layout, the
    prefiltered cube with packed or clamped neighbours; roughness at the
    last mip level, NoV at its 0.01 clamp, NaN in uncovered pixels. K8
    equals the twin exactly (max abs error 0), the analytic env BRDF
    included: both fuse the same multiply-adds of the fit and of the SH
    irradiance."""
    import dataclasses
    probe, lut, packed = sky_probe(dev)
    probe = dataclasses.replace(probe, prefiltered=dataclasses.replace(
        probe.prefiltered, packed=cube_packed))
    args, kw = sky_call(sky_inputs(seed=21, h=40, w=72), dev, probe,
                        packed if env == "lut_packed" else lut,
                        SKY_OPTIONS[opts], env == "analytic")
    n0 = skylight.K8.launches
    got = skylight.sky_lighting(*args, **kw)
    ref = skylight.sky_lighting_plain(*args, **kw)
    assert skylight.K8.launches == n0 + 1
    mask = args[0].mask
    _k8_close(got, ref, mask, opts)
    assert float((got - ref).abs().max()) == 0.0, (opts, env)
    lobes = kw.get("diffuse_ibl", True) or kw.get("specular_ibl", True)
    assert bool((got[mask] != 0).any()) == lobes


@pytest.mark.parametrize("shape", [(1, 1), (9, 33), (1088, 1920)],
                         ids=lambda s: f"{s[1]}x{s[0]}")
@pytest.mark.parametrize("covered", [0.0, 0.85], ids=["empty", "covered"])
def test_k8_sizes_and_empty_mask(dev, shape, covered):
    """K8 against its twin on layers that are not a multiple of its block,
    the bench frame's 1920x1088 among them, and with no pixel covered
    (every output zero though every input is NaN)."""
    h, w = shape
    probe, _, packed = sky_probe(dev)
    args, kw = sky_call(sky_inputs(seed=22, h=h, w=w, covered=covered), dev,
                        probe, packed, SKY_OPTIONS["all_inputs"], True)
    got = skylight.sky_lighting(*args, **kw)
    _k8_close(got, skylight.sky_lighting_plain(*args, **kw), args[0].mask,
              f"{w}x{h}")
    if covered == 0.0:
        assert not bool(got.any())


def stochastic_sky_inputs(seed, h, w):
    """sky_inputs' layer with every input finite (under the checkerboard
    an uncovered pixel's probe fetch may be its covered neighbour's, as
    in the frame, whose uncovered pixels hold zeros)."""
    f = sky_inputs(seed=seed, h=h, w=w)
    r = np.random.default_rng(seed + 100)
    for k in ("base_color", "mrao", "extras", "n", "v", "bent", "hbao"):
        bad = ~np.isfinite(f[k])
        f[k][bad] = r.uniform(0.1, 0.9, int(bad.sum())).astype(np.float32)
    for k in ("n", "v", "bent"):
        f[k] /= np.linalg.norm(f[k], axis=-1, keepdims=True)
    return f


@pytest.mark.parametrize("shape", [(24, 40), (13, 22), (9, 31)],
                         ids=lambda s: f"{s[1]}x{s[0]}")
@pytest.mark.parametrize("checker", [None, 0, 1])
@pytest.mark.parametrize("case", ["dither", "jitter", "lobe", "lobe_hbao"])
@pytest.mark.parametrize("env", ["analytic", "lut_packed"])
def test_k8_stochastic_roles_match_twin(dev, case, checker, env, shape):
    """Each stochastic role of K8 against sky_lighting_plain: one dithered
    mip (bilinear, or with uv_dither one texel of the RGBE table), the
    stochastic clearcoat lobe (extras) and the checkerboard probe fetch
    for either parity, on layers narrower than one of its 62-pixel spans
    (wider ones: test_k8_checker_spans_match_twin): within K8_TOL of the
    twin's peak, zeros off the mask. An odd width takes no checkerboard
    (the frame asks for none there)."""
    h, w = shape
    if checker is not None and w % 2:
        pytest.skip("the checkerboard needs an even width")
    probe, _, packed = sky_probe(dev)
    opts = dict(extras=case.startswith("lobe"), hbao=case == "lobe_hbao",
                bent=case == "lobe_hbao")
    args, kw = sky_call(stochastic_sky_inputs(31, h, w), dev, probe, packed,
                        opts, env == "analytic")
    kw.update(dither=9, uv_dither=case != "dither", checker_parity=checker,
              row0=5)
    before = skylight.K8.launches
    got = skylight.sky_lighting(*args, **kw)
    assert skylight.K8.launches == before + 1
    _k8_close(got, skylight.sky_lighting_plain(*args, **kw), args[0].mask,
              case)
    exact = skylight.sky_lighting_plain(*args, **dict(
        kw, dither=None, checker_parity=None))
    assert not torch.equal(exact, got)


def _k8_checker_case(dev, inputs, case, env, parity, row0):
    """One checkerboard launch of K8 on sky_inputs-style arrays against
    its twin: within K8_TOL of the twin's peak, zeros off the mask, one K8
    launch under its role."""
    probe, _, packed = sky_probe(dev)
    opts = dict(extras=case.startswith("lobe"), hbao=case == "lobe_hbao",
                bent=case == "lobe_hbao")
    args, kw = sky_call(inputs, dev, probe, packed, opts, env == "analytic")
    kw.update(dither=11, uv_dither=case != "dither", checker_parity=parity,
              row0=row0)
    before = skylight.K8.launches
    role = ("dither" if case == "dither" else "jitter") + "_checker"
    n_role = skylight.K8.by_name.get(role, 0)
    got = skylight.sky_lighting(*args, **kw)
    assert skylight.K8.launches == before + 1
    assert skylight.K8.by_name[role] == n_role + 1
    _k8_close(got, skylight.sky_lighting_plain(*args, **kw), args[0].mask,
              f"{case} {env} parity {parity} row0 {row0}")
    return got


@pytest.mark.parametrize("shape", [(5, 64), (6, 124), (11, 130), (3, 248)],
                         ids=lambda s: f"{s[1]}x{s[0]}")
@pytest.mark.parametrize("parity,row0", [(0, 4), (1, 4), (0, 7), (1, 7)])
@pytest.mark.parametrize("case", ["dither", "jitter", "lobe", "lobe_hbao"])
@pytest.mark.parametrize("env", ["analytic", "lut_packed"])
def test_k8_checker_spans_match_twin(dev, case, env, parity, row0, shape):
    """K8's checkerboard kernel on widths that cross its 62-pixel spans and
    end ragged (the last span's halo lane at x = width, outside the row),
    both parities, row0 even and odd, the bilinear and RGBE fetches, the
    lobe and HBAO cases, the analytic and packed-LUT env BRDF: within
    K8_TOL of the twin, zeros off the mask, one launch."""
    h, w = shape
    _k8_checker_case(dev, stochastic_sky_inputs(41, h, w), case, env,
                     parity, row0)


@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("case", ["jitter", "lobe"])
def test_k8_checker_isolated_pixels_at_span_ends(dev, case, parity):
    """Single covered pixels at and beside K8's span ends, both parities:
    a row's pattern covers one of x0 - 2 .. x0 + 1 at every span start x0
    (so a span's halo pixel is covered while its fetching neighbour is
    not, a filling pixel's neighbour in the next span is fetched as a halo
    only, and the other way round), plus the image's first and last
    columns. Each against the twin within K8_TOL, zeros elsewhere."""
    h, w = 12, 3 * skylight.K8C_SPAN + 6
    inputs = stochastic_sky_inputs(43, h, w)
    mask = np.zeros((h, w), bool)
    for y in range(h):
        off = (-2, -1, 0, 1)[y % 4]
        for x0 in range(skylight.K8C_SPAN, w, skylight.K8C_SPAN):
            mask[y, x0 + off] = True
        mask[y, 0 if y % 2 else w - 1] = True
    inputs["mask"] = mask
    got = _k8_checker_case(dev, inputs, case, "lut_packed", parity, 6)
    assert bool((got[torch.tensor(mask, device=dev)] != 0).all())


@pytest.mark.parametrize("opts", ["diffuse_only", "specular_only", "no_lobe",
                                  "lighting_only", "all_inputs"])
@pytest.mark.parametrize("parity", [0, 1])
def test_k8_checker_lobes_match_twin(dev, opts, parity):
    """K8's checkerboard kernel with either IBL lobe off (no fetch round
    without the specular one), lighting_only, and every optional input,
    on a width with a ragged last span: within K8_TOL of the twin, zeros
    off the mask, one launch."""
    probe, _, packed = sky_probe(dev)
    args, kw = sky_call(stochastic_sky_inputs(45, 7, 130), dev, probe, packed,
                        SKY_OPTIONS[opts], True)
    kw.update(dither=3, uv_dither=True, checker_parity=parity, row0=3)
    before = skylight.K8.launches
    got = skylight.sky_lighting(*args, **kw)
    assert skylight.K8.launches == before + 1
    _k8_close(got, skylight.sky_lighting_plain(*args, **kw), args[0].mask,
              opts)


def test_k8_refuses_and_never_falls_back(dev):
    """sky_lighting raises instead of launching K8, and never runs the
    twin, on a float64 input, a base colour that is not 16-byte aligned
    (K8 loads it as 16-byte rows) and a packed LUT that is not."""
    import dataclasses
    probe, _, packed = sky_probe(dev)
    args, kw = sky_call(sky_inputs(seed=23), dev, probe, packed,
                        SKY_OPTIONS["all_inputs"], False)
    gb = args[0]
    n0 = skylight.K8.launches
    with pytest.raises(ValueError, match="n:"):
        skylight.sky_lighting(gb, args[1].double(), *args[2:], **kw)
    bc = gb.base_color
    shifted = torch.empty(bc.numel() + 1, device=dev)[1:].view(bc.shape)
    shifted.copy_(bc)
    with pytest.raises(ValueError, match="base_color"):
        skylight.sky_lighting(dataclasses.replace(gb, base_color=shifted),
                              *args[1:], **kw)
    lut = torch.empty(packed.numel() + 1, device=dev)[1:].view(packed.shape)
    lut.copy_(packed)
    with pytest.raises(ValueError, match="env_brdf"):
        skylight.sky_lighting(*args[:4], lut, *args[5:], **kw)
    assert skylight.K8.launches == n0


# ---------------------------------------------------------------------------
# K9: triangle setup
# ---------------------------------------------------------------------------

def setup_scene(dev, n=900, seed=0, n_mesh=3, sorted_meshes=False):
    """A scene-shaped namespace for triangle setup: n random triangles over
    n_mesh mesh instances (identity, a rotation with a translation, a
    non-uniform scale, then random rotations, scales and translations), in
    random order or sorted by mesh, seen from setup_view(); 12
    primitives, every third double-sided, of three materials; 24
    meshlets; a tenth of the
    triangles padding (tri_prim and tri_meshlet -1), a tenth with a corner
    behind the eye (crossing the near plane), a tenth with a corner within
    1e-3 of w = eps on either side, a fortieth collapsed to a point
    (det = 0) and a fortieth with a corner repeated or a hair from
    another, and about half back-facing. -> (scene, prim_visible,
    meshlet_visible, tri_visible)."""
    r = np.random.default_rng(seed)
    c = np.stack([r.uniform(-6, 6, n), r.uniform(-3, 3, n),
                  r.uniform(2, 20, n)], -1)
    size = r.choice([0.05, 0.3, 1.0, 6.0], n, p=[0.3, 0.4, 0.2, 0.1])
    pts = c[:, None] + r.normal(size=(n, 3, 3)) * size[:, None, None]
    k = n // 10
    pts[:k, 0, 2] = -15.0
    pts[k:2 * k, 0, 2] = -12.0 + 1e-3 + r.uniform(-1e-3, 1e-3, k)
    d = n // 40
    pts[2 * k:2 * k + d, 1:] = pts[2 * k:2 * k + d, :1]
    pts[2 * k + d:2 * k + 2 * d, 1] = pts[2 * k + d:2 * k + 2 * d, 0] \
        + r.choice([0.0, 1e-7], (d, 1))
    corner = np.zeros((n, 3, 12), np.float32)
    corner[..., 0:3] = pts
    corner[..., 3:6] = r.normal(size=(n, 3, 3))
    corner[..., 6:9] = r.normal(size=(n, 3, 3))
    corner[..., 9] = r.choice([-1.0, 1.0], (n, 3))
    corner[..., 10:12] = r.uniform(-1, 2, (n, 3, 2))
    rot = np.eye(4, dtype=np.float32)
    rot[:3, :3] = np.linalg.qr(r.normal(size=(3, 3)))[0] * 0.1 \
        + np.eye(3) * 0.9
    rot[3, :3] = [0.5, -0.25, 1.0]
    scale = np.diag([1.5, 0.5, 1.0, 1.0]).astype(np.float32)
    n_prims, n_meshlets = 12, 24
    tri_prim = r.integers(0, n_prims, n)
    tri_meshlet = r.integers(0, n_meshlets, n)
    pad = r.random(n) < 0.1
    tri_prim[pad] = -1
    tri_meshlet[pad] = -1
    t = lambda x, dt=torch.int32: torch.tensor(np.asarray(x), dtype=dt,
                                               device=dev)
    scene = SimpleNamespace(
        mesh_transforms=None,
        tri_mesh=t(np.sort(r.integers(0, n_mesh, n)) if sorted_meshes
                   else r.integers(0, n_mesh, n)), tri_prim=t(tri_prim),
        tri_corner=t(corner.reshape(n, 36).T.copy(), torch.float32),
        prim_double_sided=t(np.arange(n_prims) % 3 == 0),
        prim_material=t(np.arange(n_prims) % 3),
        tri_meshlet=t(tri_meshlet),
        meshlet_prim=t(r.integers(-1, n_prims, n_meshlets)))
    out = (scene, t(r.random(n_prims) < 0.85, torch.bool),
           t(r.random(n_meshlets) < 0.85, torch.bool),
           t(r.random(n) < 0.9, torch.bool))
    xf = [np.eye(4), rot, scale]
    for _ in range(n_mesh - 3):
        m = np.eye(4)
        m[:3, :3] = np.linalg.qr(r.normal(size=(3, 3)))[0] \
            * r.uniform(0.5, 2.0, 3)[:, None]
        m[3, :3] = r.uniform(-1, 1, 3)
        xf.append(m)
    scene.mesh_transforms = t(np.stack(xf[:n_mesh]), torch.float32)
    return out


def setup_view(dev, width, height):
    """(scene rotation, view_proj) on dev: the eye at z = -12 looking +z."""
    from incarnation_tpu_torch.core.view import View
    vp = View.from_lookat([0.5, 0.5, -12.0], [0.0, 0.0, 6.0],
                          aspect=width / height).view_proj()
    rot = np.eye(4, dtype=np.float32)
    rot[:3, :3] = [[0.96, 0.0, -0.28], [0.0, 1.0, 0.0], [0.28, 0.0, 0.96]]
    return (torch.tensor(rot, device=dev),
            torch.tensor(vp, dtype=torch.float32, device=dev))


def setup_cases(scene, rot, vp, width, height):
    """How many of setup_scene's triangles reach each case, in float64:
    crossing w = eps, |det| <= 1e-12, back faces of single- and of
    double-sided primitives (neither crossing nor degenerate)."""
    m = (scene.mesh_transforms.double() @ rot.double() @ vp.double()).cpu()
    m = m.numpy()[scene.tri_mesh.cpu().numpy()]
    ct = scene.tri_corner.double().cpu().numpy()
    p = []
    for k in range(3):
        pos = np.concatenate([ct[12 * k:12 * k + 3].T,
                              np.ones((ct.shape[1], 1))], 1)
        clip = np.einsum("ti,tij->tj", pos, m)
        p.append(np.stack([(0.5 * clip[:, 0] + 0.5 * clip[:, 3]) * width,
                           (-0.5 * clip[:, 1] + 0.5 * clip[:, 3]) * height,
                           clip[:, 3]], -1))
    det = np.einsum("ti,ti->t", p[0], np.cross(p[1], p[2]))
    w = np.stack([q[:, 2] for q in p])
    crossing = (w.min(0) <= 1e-3) & (w.max(0) > 1e-3)
    prim = scene.tri_prim.cpu().numpy()
    ds = scene.prim_double_sided.cpu().numpy()[np.clip(prim, 0, None)] > 0
    back = (det > 1e-12) & (prim >= 0) & ~crossing
    return dict(crossing=int(crossing.sum()),
                degenerate=int((np.abs(det) <= 1e-12).sum()),
                back_single=int((back & ~ds).sum()),
                back_double=int((back & ds).sum()))


def _bits_equal(a, b):
    """Equal bit for bit (NaN payloads included), or both None."""
    if a is None or b is None:
        return a is None and b is None
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("tri_vis", [False, True], ids=["", "tri_visible"])
@pytest.mark.parametrize("meshlets", [False, True], ids=["", "meshlets"])
@pytest.mark.parametrize("double", [False, True], ids=["", "all_double"])
@pytest.mark.parametrize("attrs", [True, False],
                         ids=["attributes", "depth_only"])
def test_k9_matches_twin_bit_for_bit(dev, attrs, double, meshlets, tri_vis):
    """K9 against prepare_geometry_plain on the card: setup, ids, valid,
    bbox and attr equal bit for bit, with and without attribute planes,
    all_double_sided, meshlet culling and tri_visible, on triangles that
    cross w = eps, degenerate ones and single- and double-sided back
    faces."""
    scene, prim_vis, ml_vis, tri_visible = setup_scene(dev, seed=31)
    params = raster.RasterParams(width=320, height=72)
    rot, vp = setup_view(dev, 320, 72)
    kw = dict(tri_visible=tri_visible if tri_vis else None,
              meshlet_visible=ml_vis if meshlets else None,
              emit_attributes=attrs, all_double_sided=double)
    n0 = raster.K9.launches
    got = raster.prepare_geometry(scene, rot, vp, prim_vis, params, **kw)
    ref = raster.prepare_geometry_plain(scene, rot, vp, prim_vis, params,
                                        **kw)
    assert raster.K9.launches == n0 + 1
    for f in ref._fields:
        assert _bits_equal(getattr(got, f), getattr(ref, f)), f
    assert 0 < int(ref.valid.sum()) < ref.valid.numel()
    cases = setup_cases(scene, rot, vp, 320, 72)
    assert min(cases.values()) > 0, cases


@pytest.mark.parametrize("order", ["random", "sorted"])
@pytest.mark.parametrize("attrs", [True, False],
                         ids=["attributes", "depth_only"])
def test_k9_many_meshes_per_block(dev, attrs, order):
    """K9 bit for bit against its twin with 20 meshes, a block's
    triangles spread over many of them (random order) or over one or two
    (sorted, as the atrium stores them), including a ragged last
    block."""
    scene, prim_vis, ml_vis, _ = setup_scene(
        dev, n=1000, seed=33, n_mesh=20, sorted_meshes=order == "sorted")
    params = raster.RasterParams(width=320, height=72)
    rot, vp = setup_view(dev, 320, 72)
    kw = dict(meshlet_visible=ml_vis, emit_attributes=attrs)
    got = raster.prepare_geometry(scene, rot, vp, prim_vis, params, **kw)
    ref = raster.prepare_geometry_plain(scene, rot, vp, prim_vis, params,
                                        **kw)
    for f in ref._fields:
        assert _bits_equal(getattr(got, f), getattr(ref, f)), f
    assert 0 < int(ref.valid.sum()) < ref.valid.numel()


def test_k9_refuses_and_never_falls_back(dev):
    """prepare_geometry raises instead of launching K9, and never runs the
    twin, on an int64 table, a corner table that is not contiguous, and
    mesh transforms or matrices of the wrong dtype, shape, device or
    alignment (K9 loads their rows as 16-byte words)."""
    scene, prim_vis, _, _ = setup_scene(dev, n=64, seed=32)
    params = raster.RasterParams(width=64, height=32)
    rot, vp = setup_view(dev, 64, 32)
    n0 = raster.K9.launches
    scene.tri_prim = scene.tri_prim.long()
    with pytest.raises(ValueError, match="tri_prim"):
        raster.prepare_geometry(scene, rot, vp, prim_vis, params)
    scene.tri_prim = scene.tri_prim.int()
    corner = scene.tri_corner
    scene.tri_corner = corner.T.contiguous().T
    with pytest.raises(ValueError, match="tri_corner"):
        raster.prepare_geometry(scene, rot, vp, prim_vis, params)
    scene.tri_corner = corner
    xf = scene.mesh_transforms
    shifted = torch.empty(xf.numel() + 1, device=dev)[1:].view(xf.shape)
    shifted.copy_(xf)
    for bad in (xf.double(), xf.reshape(-1, 16), xf.cpu(), shifted):
        scene.mesh_transforms = bad
        with pytest.raises(ValueError, match="mesh_transforms"):
            raster.prepare_geometry(scene, rot, vp, prim_vis, params)
    scene.mesh_transforms = xf
    with pytest.raises(ValueError, match="view_proj"):
        raster.prepare_geometry(scene, rot, vp.double(), prim_vis, params)
    with pytest.raises(ValueError, match="scene_rotation"):
        raster.prepare_geometry(scene, rot[:3], vp, prim_vis, params)
    assert raster.K9.launches == n0
    raster.prepare_geometry(scene, rot, vp, prim_vis, params)
    assert raster.K9.launches == n0 + 1


# ---------------------------------------------------------------------------
# K10: layered binning
# ---------------------------------------------------------------------------

def bin_inputs(dev, t, params, n_layers=1, seed=0, frac_valid=0.7,
               spans=(1, 2, 4, 8, 40, 200, 2000)):
    """PreparedGeometry-shaped inputs for binning: t triangles with random
    inclusive pixel bboxes inside the frame (widths and heights up to
    about twice and once a random choice of `spans` pixels, so small, mid
    and big tiers all occur), a random `frac_valid` of them valid, and
    random layers in [0, n_layers) (None with one layer)."""
    r = np.random.default_rng(seed)
    w, h = params.width, params.height
    x0, y0 = r.integers(0, w, t), r.integers(0, h, t)
    s = r.choice(spans, t)
    x1 = np.minimum(x0 + (2 * s * r.random(t)).astype(int), w - 1)
    y1 = np.minimum(y0 + (s * r.random(t)).astype(int), h - 1)
    bbox = torch.tensor(np.stack([x0, y0, x1, y1], -1).astype(np.int32),
                        device=dev)
    prep = raster.PreparedGeometry(
        setup=torch.zeros((t, raster.SETUP_ROWS), device=dev),
        ids=torch.arange(t, dtype=torch.int32, device=dev),
        valid=torch.tensor(r.random(t) < frac_valid, device=dev),
        bbox=bbox, attr=None)
    layer = (torch.tensor(r.integers(0, n_layers, t).astype(np.int32),
                          device=dev) if n_layers > 1 else None)
    return prep, layer


_BIN = dict(width=640, height=256, tile_h=16, tile_w=128,
            pair_capacity=1 << 14, bin_max_span=2, big_tri_capacity=512,
            bin_mid_span=8, mid_tri_capacity=256)


def _k10_vs_twin(prep, params, layer, n_layers):
    """K10 against bin_triangles_layered_plain, every output of every
    layer equal; -> the twin's bins."""
    n0 = raster.K10.by_name.get("k10_scatter", 0)
    got = raster.bin_triangles_layered(prep, params, layer=layer,
                                       n_layers=n_layers)
    assert raster.K10.by_name["k10_scatter"] == n0 + 1
    ref = raster.bin_triangles_layered_plain(prep, params, layer=layer,
                                             n_layers=n_layers)
    for l in range(n_layers):
        for f in ("pair_tri", "starts", "counts", "big_tri", "big_count",
                  "overflow", "big_overflow"):
            g, r = getattr(got[l], f), getattr(ref[l], f)
            assert g.dtype == r.dtype and g.shape == r.shape, (l, f)
            assert torch.equal(g, r), (l, f, int((g != r).sum()))
    return ref


def _kept(bins):
    return sum(int(b.counts.sum()) + int(b.big_count[0])
               + int(b.big_overflow) for b in bins)


@pytest.mark.parametrize("case,kw,t,n_layers,frac_valid", [
    ("no_overflow", dict(), 900, 1, 0.7),
    ("cut_inside_a_bucket", dict(pair_capacity=300), 900, 1, 0.7),
    ("big_overflow", dict(big_tri_capacity=3), 900, 3, 0.7),
    ("mids_beyond_capacity", dict(mid_tri_capacity=5), 5000, 2, 0.7),
    ("mid_tier_off", dict(bin_mid_span=2), 900, 1, 0.7),
    ("no_valid_triangle", dict(), 700, 1, 0.0),
    ("four_layers", dict(), 3000, 4, 0.7),
    ("tiles_not_powers_of_two", dict(tile_w=96, tile_h=12), 3000, 2, 0.7),
    ("many_blocks", dict(width=1920, height=1088, pair_capacity=1 << 18,
                         bin_max_span=8, bin_mid_span=64,
                         mid_tri_capacity=1024, big_tri_capacity=8192),
     120_000, 3, 0.6),
])
def test_k10_matches_twin(dev, case, kw, t, n_layers, frac_valid):
    """K10 equals its twin array for array: pair_tri (kept pairs in
    (bucket, triangle) order, then zeros), starts, counts, the big lists
    and both overflow counters, on 1, 2, 3 and 4 layers; a cut at
    pair_capacity inside a tile's bucket; big lists past their capacity;
    mids past mid_tri_capacity (the first in triangle order fit); the mid
    tier off; no valid triangle; tiles whose sizes are not powers of two
    (a division, not a shift); and 120,000 triangles over 59 rows, whose
    order across rows and walking warps the counting sort must keep."""
    params = raster.RasterParams(**{**_BIN, **kw})
    prep, layer = bin_inputs(
        dev, t, params, n_layers, seed=40, frac_valid=frac_valid,
        spans=(1, 2, 4, 8, 16, 100) if case == "many_blocks"
        else (1, 2, 4, 8, 40, 200, 2000))
    ref = _k10_vs_twin(prep, params, layer, n_layers)
    over = int(ref[0].overflow)
    big_over = sum(int(b.big_overflow) for b in ref)
    kept = _kept(ref)
    if case == "cut_inside_a_bucket":
        assert over > 0 and kept == params.pair_capacity
        assert any(((b.starts < kept) & (b.starts + b.counts == kept)).any()
                   for b in ref)
    elif case in ("big_overflow", "mids_beyond_capacity"):
        assert big_over > 0 and over == 0
    elif case == "no_valid_triangle":
        assert kept == 0 and not ref[0].pair_tri.any()
    else:
        assert over == 0 and big_over == 0 and kept > 0


def test_k10_walking_warps_by_bucket_count(dev):
    """Many buckets cut the scatter's walking warps (16 to 7 at 5,121
    buckets, 1 at 24,577): K10 still equals its twin."""
    for kw in (dict(width=1280, height=1024, tile_h=16, tile_w=16),
               dict(width=2048, height=1536, tile_h=16, tile_w=8)):
        params = raster.RasterParams(**{**_BIN, **kw,
                                        "pair_capacity": 1 << 16,
                                        "bin_max_span": 16,
                                        "bin_mid_span": 64})
        prep, layer = bin_inputs(dev, 20_000, params, 1, seed=41,
                                 spans=(1, 2, 8, 30, 100))
        _k10_vs_twin(prep, params, layer, 1)


def test_k10_pairs_crowded_in_few_triangles(dev):
    """A block whose pairs crowd into a few triangles (a run of 300 mids
    of up to 64 tiles and a full-screen big triangle among triangles of a
    tile or two, as the atrium's camera pass crowds its mids): one walking
    warp takes most of the block's pairs, and K10 still equals its
    twin."""
    params = raster.RasterParams(**{**_BIN, "width": 1920, "height": 1088,
                                    "bin_max_span": 2, "bin_mid_span": 64,
                                    "mid_tri_capacity": 4096})
    prep, layer = bin_inputs(dev, 6000, params, 2, seed=44, frac_valid=0.9,
                             spans=(1, 2, 8))
    bbox = prep.bbox.clone()
    crowd = torch.arange(2100, 2400, device=dev)
    bbox[crowd, 2] = torch.clamp(bbox[crowd, 0] + 900, max=1919)
    bbox[crowd, 3] = torch.clamp(bbox[crowd, 1] + 60, max=1087)
    bbox[5000, :] = torch.tensor([0, 0, 1919, 1087], device=dev)
    _k10_vs_twin(prep._replace(bbox=bbox), params, layer, 2)


def test_k10_binning_makes_no_host_sync(dev):
    """One binning of an atrium-sized pass (290,816 triangles, 3 layers,
    1920x1088 in 16x128 tiles, 2^18 pairs) under
    torch.cuda.set_sync_debug_mode("error"): no call of it waits for the
    card."""
    params = raster.RasterParams(width=1920, height=1088,
                                 pair_capacity=1 << 18, bin_max_span=8)
    prep, layer = bin_inputs(dev, 290_816, params, 3, seed=42,
                             frac_valid=0.4, spans=(1, 2, 4, 8, 16, 64))
    raster.bin_triangles_layered(prep, params, layer=layer, n_layers=3)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        bins = raster.bin_triangles_layered(prep, params, layer=layer,
                                            n_layers=3)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(bins[0].overflow) == 0 and _kept(bins) > 100_000


def test_k10_refuses_and_never_falls_back(dev):
    """bin_triangles_layered raises instead of launching K10, and never runs
    the twin, on an int64 or CPU bbox, a misaligned or non-contiguous one,
    an int64 layer, a valid mask of the wrong shape, and more buckets than
    the scatter's shared memory holds."""
    params = raster.RasterParams(**_BIN)
    prep, layer = bin_inputs(dev, 500, params, 2, seed=43)
    n0 = raster.K10.launches
    bbox = prep.bbox
    shifted = torch.empty(bbox.numel() + 1, dtype=torch.int32,
                          device=dev)[1:].view(bbox.shape)
    shifted.copy_(bbox)
    for bad, match in ((bbox.long(), "bbox"), (bbox.T.contiguous().T, "bbox"),
                       (shifted, "bbox")):
        with pytest.raises(ValueError, match=match):
            raster.bin_triangles_layered(prep._replace(bbox=bad), params,
                                         layer=layer, n_layers=2)
    with pytest.raises(ValueError, match="valid"):
        raster.bin_triangles_layered(prep._replace(valid=prep.valid[1:]),
                                     params, layer=layer, n_layers=2)
    with pytest.raises(ValueError, match="layer"):
        raster.bin_triangles_layered(prep, params, layer=layer.long(),
                                     n_layers=2)
    with pytest.raises(ValueError, match="valid"):
        raster.bin_triangles_layered(prep._replace(valid=prep.valid.cpu()),
                                     params, layer=layer, n_layers=2)
    huge = raster.RasterParams(**{**_BIN, "width": 4096, "height": 4096,
                                  "tile_w": 8, "tile_h": 8})
    with pytest.raises(ValueError, match="buckets"):
        raster.bin_triangles_layered(prep, huge, layer=layer, n_layers=2)
    assert raster.K10.launches == n0
    # a CPU bbox takes the twin: K10 does not launch
    cpu = raster.PreparedGeometry(*(None if x is None else x.cpu()
                                    for x in prep))
    raster.bin_triangles_layered(cpu, params, layer=layer.cpu(), n_layers=2)
    assert raster.K10.launches == n0
    raster.bin_triangles_layered(prep, params, layer=layer, n_layers=2)
    assert raster.K10.launches == n0 + 3


@pytest.mark.parametrize("mid_tier", [True, False], ids=["mids", "no_mids"])
def test_k10_three_launches_a_binning(dev, mid_tier):
    """A binning is at most three K10 launches, one of each step (counting,
    column scan, scatter), with the mid tier on or off."""
    params = raster.RasterParams(**{**_BIN, **({} if mid_tier
                                               else {"bin_mid_span": 2})})
    prep, layer = bin_inputs(dev, 3000, params, 2, seed=45)
    before = dict(raster.K10.by_name)
    _k10_vs_twin(prep, params, layer, 2)
    steps = {k: v - before.get(k, 0) for k, v in raster.K10.by_name.items()
             if v != before.get(k, 0)}
    assert steps == {"k10_count": 1, "k10_scan": 1, "k10_scatter": 1}


def _k10_lookback_case(dev, case):
    """(prep, params, layer, n_layers) of a look-back case: mids in every
    row, the mid capacity cut in the middle of them."""
    if case == "four_million_triangles":
        params = raster.RasterParams(width=1920, height=1088,
                                     pair_capacity=1 << 24, bin_max_span=8,
                                     bin_mid_span=64,
                                     mid_tri_capacity=200_000,
                                     big_tri_capacity=8192)
        prep, layer = bin_inputs(dev, 4_194_304 + 777, params, 3, seed=46,
                                 frac_valid=0.5, spans=(1, 2, 4, 40, 200))
        return prep, params, layer, 3
    wide = case == "wide"
    params = raster.RasterParams(**{**_BIN, "width": 1920 if wide else 640,
                                    "height": 1088 if wide else 256,
                                    "pair_capacity": 1 << 20,
                                    "bin_max_span": 2, "bin_mid_span": 64,
                                    "mid_tri_capacity": 15_000 if wide
                                    else 900})
    prep, layer = bin_inputs(dev, 150_000 if wide else 9000, params,
                             3 if wide else 1, seed=47 if wide else 48,
                             spans=(1, 2, 40, 200))
    return prep, params, layer, 3 if wide else 1


@pytest.mark.parametrize("case", ["four_million_triangles",
                                  "back_to_back_shapes"])
def test_k10_lookback_rows_and_state(dev, case):
    """The mid fit's look-back and K10's state between binnings. 4,195,081
    triangles make 2,049 rows, more blocks than the card holds at once, so
    rows wait only on rows of earlier tickets. Back to back, with no
    synchronisation between them, a wide binning (74 rows, three layers),
    a narrow one of another shape (5 rows, one layer) and the wide one
    again: each must equal its twin, so none reads another's look-back
    words or counters. The mid capacity cuts the mids in the middle of the
    rows in every case."""
    if case == "four_million_triangles":
        runs = [_k10_lookback_case(dev, case)]
    else:
        wide = _k10_lookback_case(dev, "wide")
        runs = [wide, _k10_lookback_case(dev, "narrow"), wide]
    got = [raster.bin_triangles_layered(prep, params, layer=layer,
                                        n_layers=nl)
           for prep, params, layer, nl in runs]
    for bins, (prep, params, layer, nl) in zip(got, runs):
        ref = raster.bin_triangles_layered_plain(prep, params, layer=layer,
                                                 n_layers=nl)
        for l in range(nl):
            for f in ("pair_tri", "starts", "counts", "big_tri", "big_count",
                      "overflow", "big_overflow"):
                g, r = getattr(bins[l], f), getattr(ref[l], f)
                assert g.dtype == r.dtype and g.shape == r.shape, (l, f)
                assert torch.equal(g, r), (case, l, f, int((g != r).sum()))
        assert sum(int(b.big_overflow) for b in ref) > 0
        assert int(ref[0].overflow) == 0


def light_grid_inputs(n_lights=66, seed=0, width=1920, height=1088, pad=5):
    """numpy inputs of one light-cluster grid: n_lights lights from a seed
    spread over the cluster depths (points and spots, every fifth with
    range 0, which reads MAX_LIGHT_RANGE, every seventh directional, a few
    far outside the frustum), then `pad` rows past `count` that are point
    lights inside it (only index < count leaves them out), and the camera's
    proj and inv_view_proj at width:height -> dict(arrays
    (lights.light_arrays' columns), proj, inv_view_proj)."""
    from incarnation_tpu_torch.core.view import View
    r = np.random.default_rng(seed)
    defs, xforms = [], []
    for i in range(n_lights):
        xf = np.eye(4, dtype=np.float32)
        xf[:3, :3] = np.linalg.qr(r.normal(size=(3, 3)))[0]
        z = float(np.exp(r.uniform(np.log(1.5), np.log(180.0))))
        spread = 1.5 * z if i % 11 else 6.0 * z
        xf[3, :3] = [r.uniform(-spread, spread),
                     r.uniform(-0.6 * spread, 0.6 * spread), z]
        kind = "directional" if i % 7 == 6 else ["point", "spot"][i % 2]
        d = {"type": kind, "intensity": float(r.uniform(5, 50))}
        if i % 5:
            d["range"] = float(r.uniform(0.3, 0.25 * z + 2.0))
        defs.append(d)
        xforms.append(xf)
    arrays = lights_mod.light_arrays(defs, xforms, pad_to=n_lights + pad)
    arrays["type"][n_lights:] = lights_mod.LIGHT_POINT
    arrays["range"][n_lights:] = 3.0
    arrays["transform"][n_lights:, 3, :3] = [0.0, 0.0, 12.0]
    view = View.from_lookat([0.5, 0.5, -2.0], [0.0, 0.0, 8.0],
                            aspect=width / height)
    return dict(arrays=arrays,
                proj=np.asarray(view.projection_transform(), np.float32),
                inv_view_proj=np.linalg.inv(view.view_proj())
                .astype(np.float32))


def background_inputs(sun_y, seed=0, width=64, height=40, covered=0.75):
    """numpy inputs of one sky background: a mask covering about `covered`
    of the frame (a random blob and noise), a camera looking slightly up
    and the sun at height sun_y (<= 0: below the horizon, where acos's
    clamp holds theta_s at pi / 2) -> dict(mask, eye, inv_view_proj,
    sun_dir)."""
    from incarnation_tpu_torch.core.view import View
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width]
    blob = (yy / height) > 0.45 + 0.2 * np.sin(xx / width * 6.0)
    mask = blob | (r.random((height, width)) < covered - blob.mean())
    view = View.from_lookat([0.0, 1.0, -4.0], [0.3, 1.6, 3.0],
                            aspect=width / height)
    sun = np.float32([0.4, sun_y, 0.6])
    sun /= np.linalg.norm(sun)
    return dict(mask=mask, eye=np.asarray(view.position, np.float32),
                inv_view_proj=np.linalg.inv(view.view_proj())
                .astype(np.float32), sun_dir=sun.astype(np.float32))


def _k11_case(dev, n_lights, dims, seed=0):
    inp = light_grid_inputs(n_lights, seed)
    cfg = Config(light_cluster_dim_x=dims[0], light_cluster_dim_y=dims[1],
                 light_cluster_dim_z=dims[2])
    f = lambda x: torch.tensor(np.asarray(x), device=dev)
    return (lights_mod.light_table(inp["arrays"], dev), cfg, f(inp["proj"]),
            f(inp["inv_view_proj"]), 1.0)


@pytest.mark.parametrize("dims", [(16, 9, 24), (5, 3, 7)],
                         ids=["16x9x24", "5x3x7"])
@pytest.mark.parametrize("n_lights", [1, 31, 32, 33, 66])
def test_k11_matches_twin_bit_for_bit(dev, n_lights, dims):
    """Every word and the culled count equal the twin's, one launch a grid,
    with lights past a word's end, padding rows past count, range-0 and
    directional rows."""
    args = _k11_case(dev, n_lights, dims, seed=n_lights)
    n0 = clustered.K11.launches
    words, culled = clustered.build_light_clusters(*args)
    assert clustered.K11.launches == n0 + 1
    ref_words, ref_culled = clustered.build_light_clusters_plain(*args)
    assert words.dtype == torch.int32 and culled.dtype == torch.int64
    assert words.shape == ref_words.shape
    assert torch.equal(words, ref_words), int((words != ref_words).sum())
    assert int(culled) == int(ref_culled)
    if n_lights >= 31:
        assert 0 < int((ref_words != 0).sum()) < ref_words.numel()


def test_k11_back_to_back_and_no_host_sync(dev):
    """Two grids of different shapes and a third like the first, launched
    back to back with no synchronisation between them and under
    set_sync_debug_mode("error"): each equals its twin (the count's
    scratch is zero between launches), and K11 neither copies from host
    memory nor waits for the card."""
    runs = [_k11_case(dev, 66, (16, 9, 24), 1),
            _k11_case(dev, 33, (5, 3, 7), 2),
            _k11_case(dev, 66, (16, 9, 24), 3)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [clustered.build_light_clusters(*a) for a in runs]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for (words, culled), a in zip(got, runs):
        ref_words, ref_culled = clustered.build_light_clusters_plain(*a)
        assert torch.equal(words, ref_words)
        assert int(culled) == int(ref_culled)
    assert all(int(x) == 0 for x in clustered._k11_scratch(dev))


def test_k11_refuses_and_never_falls_back(dev):
    lights, cfg, proj, ivp, near = _k11_case(dev, 33, (16, 9, 24))
    n0 = clustered.K11.launches
    with pytest.raises(ValueError, match="proj"):
        clustered.build_light_clusters(lights, cfg, proj.double(), ivp, near)
    with pytest.raises(ValueError, match="inv_view_proj"):
        clustered.build_light_clusters(lights, cfg, proj, ivp.t(), near)
    with pytest.raises(ValueError, match="lights.transform"):
        clustered.build_light_clusters(dataclasses.replace(
            lights, transform=lights.transform.cpu()), cfg, proj, ivp, near)
    assert clustered.K11.launches == n0


def _k12_args(dev, inp, width, height, turbidity=2.0):
    f = lambda x: torch.tensor(np.asarray(x), device=dev)
    return (f(inp["mask"]), f(inp["eye"]), f(inp["inv_view_proj"]), width,
            height), dict(sun_dir=f(inp["sun_dir"]), turbidity=turbidity,
                          dynamic_sky=True)


@pytest.mark.parametrize("sun_y", [0.9, 0.08, -0.3])
@pytest.mark.parametrize("shape", [(1088, 1920), (97, 333), (1, 1)],
                         ids=["1920x1088", "333x97", "1x1"])
def test_k12_matches_twin_bit_for_bit(dev, shape, sun_y):
    """Every pixel equals the twin's bit for bit: +0.0 where covered, the
    sky elsewhere, with the sun high, low and below the horizon."""
    h, w = shape
    a, kw = _k12_args(dev, background_inputs(sun_y, seed=h, width=w,
                                             height=h), w, h)
    n0 = skylight.K12.launches
    got = skylight.environment_background(*a, **kw)
    assert skylight.K12.launches == n0 + 1
    ref = skylight.environment_background_plain(*a, **kw)
    assert got.shape == ref.shape == (h, w, 3)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32)), \
        float((got - ref).abs().max())
    if h > 1:
        assert bool(torch.isfinite(ref).all()) and float(ref.max()) > 0


def test_k12_turbidity_and_no_host_sync(dev):
    """Other turbidities (the Perez coefficients and the zenith formed in
    the kernel from the double), back to back under
    set_sync_debug_mode("error"): K12 equals its twin and makes no copy
    from host memory and no synchronize."""
    cases = [_k12_args(dev, background_inputs(0.5, seed=s, width=200,
                                              height=120), 200, 120, t)
             for s, t in ((1, 2.0), (2, 3.7), (3, 9.0))]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [skylight.environment_background(*a, **kw) for a, kw in cases]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for g, (a, kw) in zip(got, cases):
        ref = skylight.environment_background_plain(*a, **kw)
        assert torch.equal(g.view(torch.int32), ref.view(torch.int32))


def test_k12_refuses_and_never_falls_back(dev):
    a, kw = _k12_args(dev, background_inputs(0.5), 64, 40)
    mask, eye, ivp, w, h = a
    n0 = skylight.K12.launches
    with pytest.raises(ValueError, match="mask"):
        skylight.environment_background(mask.to(torch.uint8), eye, ivp, w,
                                        h, **kw)
    with pytest.raises(ValueError, match="sun_dir"):
        skylight.environment_background(mask, eye, ivp, w, h,
                                        **dict(kw, sun_dir=None))
    with pytest.raises(ValueError, match="mask"):
        skylight.environment_background(mask, eye, ivp, w + 1, h, **kw)
    with pytest.raises(ValueError, match="hdr"):
        skylight.environment_background(mask, eye, ivp, w, h, **kw,
                                        hdr=torch.zeros((h, w, 4),
                                                        device=dev))
    with pytest.raises(ValueError, match="hdr"):
        skylight.environment_background(
            mask, eye, ivp, w, h, **kw,
            hdr=torch.zeros((w, h, 3), device=dev).transpose(0, 1))
    assert skylight.K12.launches == n0


def _unproject(vp, ndc):
    """World points (f64) of NDC points (..., 3) under a row-vector
    view-projection."""
    h = np.concatenate([ndc, np.ones_like(ndc[..., :1])], -1) \
        @ np.linalg.inv(vp.astype(np.float64))
    return h[..., :3] / h[..., 3:]


# the NDC coordinate (axis, value) on each frustum plane of
# cull.frustum_planes: left, right, bottom, top, z = 0, z = w
_PLANE_NDC = ((0, -1.0), (0, 1.0), (1, -1.0), (1, 1.0), (2, 0.0), (2, 1.0))


def cull_inputs(n, seed=0, view="camera", graze=1e-2):
    """numpy inputs of one frustum cull: n spheres of three meshes (each a
    rotated, unevenly scaled, translated transform; mesh 2 hidden), a
    rotated scene_rotation and either the camera's infinite reverse-Z
    view-projection ("camera": its z = 0 plane is at infinity, a zero
    normal that the 1e-12 floor meets) or the sun's orthographic one
    ("sun": six finite planes). Sphere centres spread in NDC over about
    twice the frustum; every 13th radius is 0; every 17th mesh id is
    negative (it wraps); the first spheres graze the planes, one inside
    and one outside each finite plane by `graze` of their radius ->
    dict(bsphere, mesh, mesh_transforms, mesh_visible, scene_rotation,
    view_proj, graze (n,) int: 1 inside, -1 outside, 0 no graze)."""
    from incarnation_tpu_torch.core.view import View
    from incarnation_tpu_torch.kernels.shadow import sun_view_proj
    r = np.random.default_rng(seed)
    xf = np.tile(np.eye(4), (3, 1, 1))
    for k in range(3):
        q = np.linalg.qr(r.normal(size=(3, 3)))[0]
        xf[k, :3, :3] = q * r.uniform(0.5, 2.0, 3)[:, None]
        xf[k, 3, :3] = r.uniform(-2.0, 2.0, 3)
    xf = xf.astype(np.float32)
    rot = np.eye(4)
    rot[:3, :3] = np.linalg.qr(r.normal(size=(3, 3)))[0]
    rot = rot.astype(np.float32)
    if view == "camera":
        vp = View.from_lookat([0.5, 1.0, -6.0], [0.0, 0.0, 6.0],
                              aspect=1920 / 1088).view_proj()
        zlo, zhi, finite = 0.04, 1.2, (0, 1, 2, 3, 5)
    else:
        vp = sun_view_proj([0.3, 0.8, -0.5], [0.0, 0.0, 4.0], 12.0)
        zlo, zhi, finite = -0.3, 1.3, (0, 1, 2, 3, 4, 5)
    vp = np.asarray(vp, np.float32)
    mesh = r.integers(0, 3, n)
    radius = r.uniform(0.2, 2.0, n)
    radius[::13] = 0.0
    ndc = np.stack([r.uniform(-2.0, 2.0, n), r.uniform(-2.0, 2.0, n),
                    r.uniform(zlo, zhi, n)], -1)
    center = _unproject(vp, ndc)
    # normalised planes (f64), their normals pointing inside
    m = vp.astype(np.float64)
    planes = np.stack([m[:, 3] + m[:, 0], m[:, 3] - m[:, 0],
                       m[:, 3] + m[:, 1], m[:, 3] - m[:, 1], m[:, 2],
                       m[:, 3] - m[:, 2]])
    planes /= np.maximum(np.linalg.norm(planes[:, :3], axis=-1),
                         1e-12)[:, None]
    graze_of = np.zeros(n, np.int64)
    for g in range(min(n, 2 * len(finite))):
        q = finite[g // 2]
        axis, value = _PLANE_NDC[q]
        p = np.concatenate([r.uniform(-0.8, 0.8, 2), r.uniform(0.2, 0.8, 1)])
        p[axis] = value
        side = 1 if g % 2 == 0 else -1
        center[g] = _unproject(vp, p) + planes[q, :3] * (
            -radius[g] + side * graze * max(radius[g], 0.2))
        mesh[g] = g % 2                          # visible meshes
        graze_of[g] = side
    world = xf.astype(np.float64) @ rot.astype(np.float64)
    obj = np.empty((n, 3))
    for k in range(3):
        sel = mesh == k
        h = np.concatenate([center[sel], np.ones((sel.sum(), 1))], -1)
        obj[sel] = (h @ np.linalg.inv(world[k]))[:, :3]
    scale = np.linalg.norm(world[:, :3, :3], axis=-1).max(-1)
    bsphere = np.concatenate([obj, (radius / scale[mesh])[:, None]], -1)
    mesh[16::17] -= 3
    return dict(bsphere=bsphere.astype(np.float32),
                mesh=mesh.astype(np.int32), mesh_transforms=xf,
                mesh_visible=np.int32([1, 1, 0]), scene_rotation=rot,
                view_proj=vp, graze=graze_of)


def _k13_args(dev, inp):
    f = lambda k: torch.tensor(inp[k], device=dev)
    return tuple(f(k) for k in ("bsphere", "mesh", "mesh_transforms",
                                "mesh_visible", "scene_rotation",
                                "view_proj"))


@pytest.mark.parametrize("view", ["camera", "sun"])
@pytest.mark.parametrize("n", [0, 1, 3434, 100_000])
def test_k13_matches_twin_bit_for_bit(dev, n, view):
    """Every mask bit and the culled count equal the twin's, one launch a
    list: the empty list (count 0), one sphere, the atrium's meshlet count
    and 100k spheres (97 rounds of the block), with grazing spheres, zero
    radii, wrapped mesh ids and a hidden mesh."""
    args = _k13_args(dev, cull_inputs(n, seed=n + 1, view=view))
    n0 = cull.K13.launches
    inside, culled = cull.cull_primitives(*args)
    assert cull.K13.launches == n0 + 1
    ref_inside, ref_culled = cull.cull_primitives_plain(*args)
    assert inside.dtype == torch.bool and culled.dtype == torch.int64
    assert inside.shape == ref_inside.shape == (n,) and culled.shape == ()
    assert torch.equal(inside, ref_inside), \
        int((inside != ref_inside).sum())
    assert int(culled) == int(ref_culled)
    if n >= 3434:
        assert 0 < int(ref_culled) < n


def test_k13_back_to_back_and_no_host_sync(dev):
    """Three lists of different lengths launched back to back under
    set_sync_debug_mode("error"): each equals its twin, and K13 neither
    copies from host memory nor waits for the card."""
    runs = [_k13_args(dev, cull_inputs(n, seed=s, view=v))
            for n, s, v in ((64, 1, "camera"), (3434, 2, "sun"),
                            (0, 3, "camera"), (5000, 4, "camera"))]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [cull.cull_primitives(*a) for a in runs]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for (inside, culled), a in zip(got, runs):
        ref_inside, ref_culled = cull.cull_primitives_plain(*a)
        assert torch.equal(inside, ref_inside)
        assert int(culled) == int(ref_culled)


def test_k13_refuses_and_never_falls_back(dev):
    bs, mesh, xf, vis, rot, vp = _k13_args(dev, cull_inputs(64))
    n0 = cull.K13.launches
    with pytest.raises(ValueError, match="bsphere"):
        cull.cull_primitives(bs.double(), mesh, xf, vis, rot, vp)
    with pytest.raises(ValueError, match="mesh"):
        cull.cull_primitives(bs, mesh.long(), xf, vis, rot, vp)
    with pytest.raises(ValueError, match="view_proj"):
        cull.cull_primitives(bs, mesh, xf, vis, rot, vp.t())
    with pytest.raises(ValueError, match="scene_rotation"):
        cull.cull_primitives(bs, mesh, xf, vis, rot.cpu(), vp)
    with pytest.raises(ValueError, match="mesh_visible"):
        cull.cull_primitives(bs, mesh, xf, vis[:2], rot, vp)
    shifted = torch.empty(bs.numel() + 1, device=dev)[1:].view(-1, 4)
    shifted.copy_(bs)
    with pytest.raises(ValueError, match="aligned"):
        cull.cull_primitives(shifted, mesh, xf, vis, rot, vp)
    assert cull.K13.launches == n0


def _k13_lists(dev, sizes, view, seed=0):
    """cull_inputs lists of the given sizes over the first list's mesh
    table and view -> (lists [(bsphere, mesh)], mesh_transforms,
    mesh_visible, scene_rotation, view_proj)."""
    inps = [cull_inputs(n, seed=seed + k, view=view)
            for k, n in enumerate(sizes)]
    shared = _k13_args(dev, inps[0])[2:]
    return ([_k13_args(dev, x)[:2] for x in inps], *shared)


def _k13_scratch_zero(dev):
    key = (torch.cuda.current_device(),
           torch.cuda.current_stream(dev).cuda_stream)
    buf = cull._K13_SCRATCH.get(key)
    return buf is None or not bool(buf.any())


@pytest.mark.parametrize("view", ["camera", "sun"])
@pytest.mark.parametrize("sizes", [(64, 3434), (0, 3434), (3434, 0), (0, 0),
                                   (1, 1), (100_000, 64), (64, 100_000)],
                         ids=lambda s: f"{s[0]}+{s[1]}")
def test_k13_two_lists_match_twin_bit_for_bit(dev, sizes, view):
    """The frame's two lists in one launch: every mask bit and each
    list's culled count equal the twin's (cull_primitives_plain a list);
    empty lists, one sphere, the atrium's 64 primitives and 3,434
    meshlets, and 100k spheres (782 blocks, more than the card holds at
    once). The ticket's scratch is left zero."""
    lists, *rest = _k13_lists(dev, sizes, view, seed=sum(sizes) % 97)
    n0 = cull.K13.launches
    got = cull.cull_lists(lists, *rest)
    assert cull.K13.launches == n0 + 1
    ref = cull.cull_lists_plain(lists, *rest)
    for (inside, culled), (ri, rc), n in zip(got, ref, sizes):
        assert inside.dtype == torch.bool and culled.dtype == torch.int64
        assert inside.shape == (n,) and culled.shape == ()
        assert torch.equal(inside, ri), int((inside != ri).sum())
        assert int(culled) == int(rc)
        if n >= 3434:
            assert 0 < int(rc) < n
    assert _k13_scratch_zero(dev)


def test_k13_clamps_mesh_ids_outside_the_table(dev):
    """A mesh id outside [-M, M) is clamped into the table after a
    negative one wraps (JAX's gather), which the twin, whose indexing
    raises, is given already mapped."""
    lists, xf, vis, rot, vp = _k13_lists(dev, (64, 3434), "camera", seed=5)
    m = xf.shape[0]
    wild = []
    for bs, mesh in lists:
        mesh = mesh.clone()
        mesh[::5] = torch.tensor([-2 * m - 1, -m - 1, m, 3 * m, 1 << 30],
                                 dtype=torch.int32,
                                 device=dev).repeat(mesh[::5].numel())[
            :mesh[::5].numel()]
        wild.append((bs, mesh))
    mapped = [(bs, torch.where(mesh < 0, mesh + m, mesh).clamp(0, m - 1)
               .to(torch.int32)) for bs, mesh in wild]
    got = cull.cull_lists(wild, xf, vis, rot, vp)
    ref = cull.cull_lists_plain(mapped, xf, vis, rot, vp)
    for (inside, culled), (ri, rc) in zip(got, ref):
        assert torch.equal(inside, ri) and int(culled) == int(rc)


def test_k13_lists_back_to_back_and_no_host_sync(dev):
    """Two-list culls of different lengths back to back under
    set_sync_debug_mode("error"), then cull_primitives (a list of one,
    the same kernel): each equals its twin, nothing waits for the host,
    each is one launch, and the ticket's scratch is left zero."""
    runs = [_k13_lists(dev, s, v, seed=k) for k, (s, v) in enumerate((
        ((64, 3434), "camera"), ((3434, 5000), "sun"), ((0, 64), "camera"),
        ((64, 3434), "sun")))]
    torch.cuda.synchronize()
    n0 = cull.K13.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [cull.cull_lists(*r) for r in runs]
        single = cull.cull_primitives(*runs[0][0][0], *runs[0][1:])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for g, r in zip(got, runs):
        for (inside, culled), (ri, rc) in zip(g, cull.cull_lists_plain(*r)):
            assert torch.equal(inside, ri) and int(culled) == int(rc)
    ri, rc = cull.cull_primitives_plain(*runs[0][0][0], *runs[0][1:])
    assert torch.equal(single[0], ri) and int(single[1]) == int(rc)
    assert cull.K13.launches == n0 + len(runs) + 1
    assert _k13_scratch_zero(dev)


def test_k13_lists_refuse_and_never_fall_back(dev):
    """cull_lists raises instead of launching on no list or more than
    K13_MAX_LISTS, and on a list K13 does not take."""
    lists, *rest = _k13_lists(dev, (64, 64), "camera")
    n0 = cull.K13.launches
    with pytest.raises(ValueError, match="lists"):
        cull.cull_lists([], *rest)
    with pytest.raises(ValueError, match="lists"):
        cull.cull_lists(lists * 2, *rest)
    with pytest.raises(ValueError, match="mesh"):
        cull.cull_lists([lists[0], (lists[1][0], lists[1][1].long())], *rest)
    with pytest.raises(ValueError, match="bsphere"):
        cull.cull_lists([lists[0], (lists[1][0][:, :3], lists[1][1])],
                        *rest)
    assert cull.K13.launches == n0

def sun_tap_inputs(h, w, seed=0, side=64):
    """numpy inputs of one sun-map tap: an (H, W) frame of world points
    spread over a little more than the sun's orthographic box (some
    outside it; one far outside, one NaN), n.l in [-0.2, 1] (one NaN), a
    random (side, side) f32 depth map and the sun's view-projection ->
    dict(world_pos, n_dot_l, depth, sun_vp)."""
    r = np.random.default_rng(seed)
    vp = np.asarray(shadow.sun_view_proj([0.3, 0.8, -0.5], [0.0, 0.0, 0.0],
                                         4.0), np.float32)
    ndc = np.stack([r.uniform(-1.1, 1.1, (h, w)), r.uniform(-1.1, 1.1, (h, w)),
                    r.uniform(0.0, 1.0, (h, w))], -1)
    wp = _unproject(vp, ndc).astype(np.float32)
    ndl = r.uniform(-0.2, 1.0, (h, w)).astype(np.float32)
    wp[0, 0] = [1e30, 0.0, 0.0]
    if h * w > 2:
        wp[h // 2, w // 2] = np.nan
        ndl[h - 1, w - 1] = np.nan
    depth = r.uniform(0.0, 1.0, (side, side)).astype(np.float32)
    return dict(world_pos=wp, n_dot_l=ndl, depth=depth, sun_vp=vp)


# K14's roles: (dither, checker_parity)
K14_ROLES = {"exact": (None, None), "dither": (9, None),
             "dither_checker0": (9, 0), "dither_checker1": (10, 1),
             "checker0": (None, 0)}


def _k14_args(dev, inp, side):
    """(world_pos, depth, sun_vp, side, normal, sun_dir) on the card: K14's
    "+nl" form, its normals random units (seeded by the frame's size) with
    one NaN, the sun's direction sun_tap_inputs' map's."""
    f = lambda k: torch.tensor(inp[k], device=dev)
    h, w = inp["n_dot_l"].shape
    nrm = _unit_np(np.random.default_rng(h * 7 + w), (h, w, 3)).astype(
        np.float32)
    if h * w > 2:
        nrm[h // 3, w // 3, 1] = np.nan
    sun = np.float32([0.3, 0.8, -0.5])
    sun /= np.linalg.norm(sun)
    t = lambda x: torch.tensor(x, device=dev)
    return f("world_pos"), f("depth"), f("sun_vp"), side, t(nrm), t(sun)


def _k14_call(fn, args, **kw):
    """sun_visibility or its twin on _k14_args' tensors, n.l from the
    normals."""
    wp, depth, vp, side, nrm, sun = args
    return fn(wp, None, depth, vp, side, normal=nrm, sun_dir=sun, **kw)


@pytest.mark.parametrize("shape,role", [
    ((1088, 1920), r) for r in K14_ROLES] + [
    ((540, 959), "exact"), ((540, 959), "dither"),
    ((33, 70), "dither_checker1"), ((1, 2), "dither_checker0"),
    ((3, 66), "checker0")])
def test_k14_matches_twin_bit_for_bit(dev, shape, role):
    """Every value of K14's "+nl" roles equals the twin's bit for bit, one
    launch a call, in each role: 1920x1088 on a 1024 map, the viewer's
    odd 959 width, a width of 35 pairs (a warp and 3 more), one pair, rows
    of 33 pairs."""
    h, w = shape
    side = 1024 if w >= 959 else 64
    args = _k14_args(dev, sun_tap_inputs(h, w, seed=h, side=side), side)
    dither, parity = K14_ROLES[role]
    name = shadow.role_name(dither, parity, True)
    n0 = shadow.K14.by_name.get(name, 0)
    got = _k14_call(shadow.sun_visibility, args, dither=dither,
                    checker_parity=parity)
    assert shadow.K14.by_name.get(name, 0) == n0 + 1
    ref = _k14_call(shadow.sun_visibility_plain, args, dither=dither,
                    checker_parity=parity)
    assert got.dtype == torch.float32 and got.shape == ref.shape == (h, w)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32)), \
        int((got != ref).sum())
    if h * w > 1000:
        assert 0.05 < float((ref == 0).float().mean()) < 0.95


@pytest.mark.parametrize("role", ["dither_checker0", "dither_checker1",
                                  "dither"])
def test_k14_band_rows_match_whole(dev, role):
    """A band of rows 544-1087 (row0 544) and one of rows 7-30 (row0 7,
    odd: the checkerboard's rows swap lanes) equal the same rows of the
    whole-frame launch and the twin's band ("+nl" roles)."""
    inp = sun_tap_inputs(1088, 1920, seed=5, side=1024)
    wp, depth, vp, side, nrm, sun = _k14_args(dev, inp, 1024)
    dither, parity = K14_ROLES[role]
    kw = dict(dither=dither, checker_parity=parity)
    whole = _k14_call(shadow.sun_visibility, (wp, depth, vp, side, nrm, sun),
                      **kw)
    for r0, r1 in ((544, 1088), (7, 31)):
        band = (wp[r0:r1].contiguous(), depth, vp, side,
                nrm[r0:r1].contiguous(), sun)
        got = _k14_call(shadow.sun_visibility, band, row0=r0, **kw)
        ref = _k14_call(shadow.sun_visibility_plain, band, row0=r0, **kw)
        assert torch.equal(got, whole[r0:r1])
        assert torch.equal(got, ref)


def test_k14_back_to_back_and_no_host_sync(dev):
    """Every "+nl" role back to back under set_sync_debug_mode("error"):
    each launch equals its twin, with no copy from host memory and no
    synchronize."""
    args = _k14_args(dev, sun_tap_inputs(200, 320, seed=3, side=256), 256)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = {role: _k14_call(shadow.sun_visibility, args, dither=d,
                               checker_parity=c, row0=4)
               for role, (d, c) in K14_ROLES.items()}
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for role, (d, c) in K14_ROLES.items():
        ref = _k14_call(shadow.sun_visibility_plain, args, dither=d,
                        checker_parity=c, row0=4)
        assert torch.equal(got[role], ref), role


def test_k14_refuses_and_never_falls_back(dev):
    """Bad tensors raise before any launch, and so does a given n_dot_l:
    on the card K14 takes only the "+nl" form."""
    wp, depth, vp, side, nrm, sun = _k14_args(
        dev, sun_tap_inputs(16, 31, seed=1), 64)
    ndl = torch.sum(nrm * sun, -1)
    n0 = shadow.K14.launches

    def call(wp=wp, depth=depth, vp=vp, side=side, nrm=nrm, sun=sun, **kw):
        return shadow.sun_visibility(wp, None, depth, vp, side, normal=nrm,
                                     sun_dir=sun, **kw)
    with pytest.raises(ValueError, match="even width"):
        call(dither=3, checker_parity=0)
    with pytest.raises(ValueError, match="world_pos"):
        call(wp=wp.permute(1, 0, 2).contiguous().permute(1, 0, 2))
    with pytest.raises(ValueError, match="normal"):
        call(nrm=nrm.double())
    with pytest.raises(ValueError, match="shadow_depth"):
        call(side=32)
    with pytest.raises(ValueError, match="sun_vp"):
        call(vp=vp.cpu())
    with pytest.raises(ValueError, match=r"\+nl"):
        shadow.sun_visibility(wp, ndl, depth, vp, side)
    with pytest.raises(ValueError, match=r"\+nl"):
        shadow.sun_visibility(wp, ndl, depth, vp, side, normal=nrm,
                              sun_dir=sun)
    assert shadow.K14.launches == n0


def _unit_np(r, shape):
    v = r.normal(size=shape)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def sun_term_inputs(h, w, seed=0, side=64, extras=False, nan=True):
    """numpy inputs of one sun term (shading.sun_term): an HDR plane
    (uncovered pixels among them -0.0), a gbuffer's base_color and mrao
    (H, W, 4), unit normals leaning toward the sun and view vectors in
    their hemisphere (NoV >= ~0.1, as the JAX comparison of the BRDF
    wants), a 90% mask, world points spread over the sun's orthographic
    box at NDC depths 0-0.8, a (side, side) map of 8x8 blocks at depth 0
    or 1 (a tap's compare is then never near its threshold, whatever the
    packing), a given visibility of 0, 0.5 or 1, the sun's direction and
    colour-intensity and, with extras, transmission, clearcoat and
    clearcoat roughness in [0, 1]; with nan, one NaN in each of n, v,
    base colour, the visibility and an uncovered pixel's HDR ->
    dict(hdr, base_color, mrao, n, v, mask, world_pos, shadow_map, sun_vp,
    visibility, sun_dir, sun_color_intensity, extras)."""
    r = np.random.default_rng(seed)
    sun = np.float32([0.3, 0.8, -0.5])
    sun = sun / np.linalg.norm(sun)
    vp = np.asarray(shadow.sun_view_proj(sun, [0.0, 0.0, 0.0], 4.0),
                    np.float32)
    ndc = np.stack([r.uniform(-1.1, 1.1, (h, w)), r.uniform(-1.1, 1.1, (h, w)),
                    r.uniform(0.0, 0.8, (h, w))], -1)
    n = _unit_np(r, (h, w, 3)) + 0.6 * sun
    n = n / np.linalg.norm(n, axis=-1, keepdims=True)
    v = n + 0.9 * _unit_np(r, (h, w, 3))
    v = v / np.linalg.norm(v, axis=-1, keepdims=True)
    mask = r.random((h, w)) > 0.1
    hdr = r.uniform(0.0, 2.0, (h, w, 3))
    hdr[~mask] *= r.choice([-0.0, 1.0], (int((~mask).sum()), 1))
    blocks = (r.random((max(side // 8, 1),) * 2) > 0.5).astype(np.float32)
    smap = np.kron(blocks, np.ones((8, 8), np.float32))[:side, :side]
    f = lambda x: np.ascontiguousarray(x, np.float32)
    out = dict(hdr=f(hdr), base_color=f(r.uniform(0, 1, (h, w, 4))),
               mrao=f(r.uniform(0.05, 1, (h, w, 4))), n=f(n), v=f(v),
               mask=mask, world_pos=f(_unproject(vp, ndc)),
               shadow_map=f(smap), sun_vp=vp,
               visibility=f(r.choice([0.0, 0.5, 1.0], (h, w))),
               sun_dir=f(sun), sun_color_intensity=np.float32(
                   [1.0, 0.9, 0.8, 3.0]),
               extras=f(r.uniform(0, 1, (h, w, 3))) if extras else None)
    if nan and h * w >= 8:
        ys, xs = np.nonzero(mask)
        for k, name, ch in ((1, "n", 0), (2, "v", 1), (3, "base_color", 2),
                            (4, "visibility", None)):
            idx = (ys[k * len(ys) // 6], xs[k * len(xs) // 6])
            out[name][idx + ((ch,) if ch is not None else ())] = np.nan
        uy, ux = np.nonzero(~mask)
        if len(uy):
            out["hdr"][uy[0], ux[0], 0] = np.nan
    return out


# sun_term's roles: (visibility source, dither, checker_parity)
K15_ROLES = {"map_exact": ("map", None, None),
             "map_dither": ("map", 9, None),
             "map_dither_checker": ("map", 10, 0),
             "map_checker1": ("map", None, 1),
             "given": ("given", None, None), "none": (None, None, None)}


def sun_term_call(inp, role, device, row0=0):
    """(positional, keyword) arguments of shading.sun_term for `role` on
    sun_term_inputs' arrays."""
    src, dither, parity = K15_ROLES[role]
    t = lambda x: None if x is None else torch.tensor(x, device=device)
    gb = resolve.GBuffer(
        base_color=t(inp["base_color"]), normals=None, mrao=t(inp["mrao"]),
        emissive=None, mask=t(inp["mask"]), world_pos=t(inp["world_pos"]),
        uv=None, extras=t(inp["extras"]))
    kw = dict(extras=gb.extras, row0=row0)
    if src == "map":
        kw.update(shadow_map=t(inp["shadow_map"]), sun_vp=t(inp["sun_vp"]),
                  resolution=inp["shadow_map"].shape[0], dither=dither,
                  checker_parity=parity)
    elif src == "given":
        kw["visibility"] = t(inp["visibility"])
    return (t(inp["hdr"]), gb, t(inp["n"]), t(inp["v"]), t(inp["sun_dir"]),
            t(inp["sun_color_intensity"])), kw


def _same_or_nan(got, ref):
    """Equal bit for bit where ref is a number, NaN where ref is NaN (a
    NaN's payload is the instruction's, not the function's)."""
    nan = torch.isnan(ref)
    return got.shape == ref.shape and got.dtype == ref.dtype \
        and torch.equal(torch.isnan(got), nan) \
        and torch.equal(torch.where(nan, 0.0, got).view(torch.int32),
                        torch.where(nan, 0.0, ref).view(torch.int32))


def _k15_cases():
    cases = []
    for role in K15_ROLES:
        for shape in ((1088, 1920), (540, 959), (33, 70), (1, 2)):
            if K15_ROLES[role][2] is not None and shape[1] % 2:
                continue
            for extras in (False, True):
                cases.append((role, shape, extras))
    return cases


@pytest.mark.parametrize("role,shape,extras", _k15_cases())
def test_k15_matches_twin_bit_for_bit(dev, role, shape, extras):
    """sun_term (one K15 launch, with the map tapping it itself) equals
    sun_term_plain bit for bit, NaN where it is NaN, in every role: the
    map's exact, dithered and checkerboard taps (both parities), a given
    visibility, none; with and without extras;
    1920x1088, the viewer's odd 959 width, 35 pairs, one pair. One K15
    launch a call, counted under its role."""
    h, w = shape
    inp = sun_term_inputs(h, w, seed=h + w, side=1024 if w >= 959 else 64,
                          extras=extras)
    a, kw = sun_term_call(inp, role, dev)
    name = {"map": "map", "given": "given", None: "none"}[
        K15_ROLES[role][0]] + ("+extras" if extras else "")
    n0 = shading.K15.by_name.get(name, 0)
    got = shading.sun_term(*a, **kw)
    assert shading.K15.by_name.get(name, 0) == n0 + 1
    ref = shading.sun_term_plain(*a, **kw)
    assert got.dtype == torch.float32 and got.shape == (h, w, 3)
    assert _same_or_nan(got, ref), int((got != ref).sum())
    if h * w > 1000:
        lit = (ref - a[0]).abs().sum(-1) > 0
        assert 0.2 < float(lit.float().mean()) < 0.95
    if h * w >= 8:
        assert bool(torch.isnan(ref).any())          # the NaNs got through


def test_k15_band_rows_and_no_host_sync(dev):
    """A band of rows 544-1087 (row0 544) of the map's checkerboard role
    equals the same rows of the whole frame, and every role runs back to
    back under set_sync_debug_mode("error") (no copy from host memory, no
    synchronize): K15 alone, no K14 launch, nothing else on the card."""
    inp = sun_term_inputs(1088, 1920, seed=3, side=1024)
    a, kw = sun_term_call(inp, "map_dither_checker", dev)
    whole = shading.sun_term(*a, **kw)
    band = {k: (v[544:] if isinstance(v, np.ndarray) and v.ndim >= 2
                and v.shape[0] == 1088 else v) for k, v in inp.items()}
    ab, kwb = sun_term_call(band, "map_dither_checker", dev, row0=544)
    assert _same_or_nan(shading.sun_term(*ab, **kwb), whole[544:])
    calls = [sun_term_call(inp, role, dev) for role in K15_ROLES]
    torch.cuda.synchronize()
    n14, n15 = shadow.K14.launches, shading.K15.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [shading.sun_term(*a, **kw) for a, kw in calls]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert shading.K15.launches == n15 + len(K15_ROLES)
    assert shadow.K14.launches == n14
    for g, (a, kw) in zip(got, calls):
        assert _same_or_nan(g, shading.sun_term_plain(*a, **kw))


def test_k15_refuses_and_never_falls_back(dev):
    inp = sun_term_inputs(16, 32, seed=1)
    a, kw = sun_term_call(inp, "given", dev)
    n0 = shading.K15.launches
    hdr, gb, n, v, sun, ci = a
    with pytest.raises(ValueError, match="hdr"):
        shading.sun_term(hdr.double(), *a[1:], **kw)
    with pytest.raises(ValueError, match="n:"):
        shading.sun_term(hdr, gb, n.permute(1, 0, 2).contiguous()
                         .permute(1, 0, 2), v, sun, ci, **kw)
    with pytest.raises(ValueError, match="mask"):
        shading.sun_term(hdr, dataclasses.replace(gb, mask=gb.mask.float()),
                         n, v, sun, ci, **kw)
    with pytest.raises(ValueError, match="base_color"):
        shifted = torch.empty(gb.base_color.numel() + 1,
                              device=dev)[1:].view(gb.base_color.shape)
        shifted.copy_(gb.base_color)
        shading.sun_term(hdr, dataclasses.replace(gb, base_color=shifted),
                         n, v, sun, ci, **kw)
    with pytest.raises(ValueError, match="sun_color_intensity"):
        shading.sun_term(hdr, gb, n, v, sun, ci.cpu(), **kw)
    with pytest.raises(ValueError, match="not both"):
        shading.sun_term(*a, **kw, shadow_map=torch.tensor(
            inp["shadow_map"], device=dev))
    assert shading.K15.launches == n0


def lit_share_inputs(h, w, share, seed=0, side=64):
    """sun_term_inputs with normals that face the sun at about `share` of
    the pixels (n = sun + 0.5 u normalized, n.l >= 0.5) and face away
    elsewhere (-sun + 0.5 u), view vectors in each normal's hemisphere, no
    NaN: the share of covered pixels the map role taps."""
    inp = sun_term_inputs(h, w, seed=seed, side=side, nan=False)
    r = np.random.default_rng(seed + 1)
    sun = inp["sun_dir"]
    sign = np.where(r.random((h, w, 1)) < share, 1.0, -1.0)
    n = sign * sun + 0.5 * _unit_np(r, (h, w, 3))
    n = n / np.linalg.norm(n, axis=-1, keepdims=True)
    v = n + 0.9 * _unit_np(r, (h, w, 3))
    v = v / np.linalg.norm(v, axis=-1, keepdims=True)
    inp["n"] = np.ascontiguousarray(n, np.float32)
    inp["v"] = np.ascontiguousarray(v, np.float32)
    return inp


def _lit_cases():
    cases = []
    for share in (0.02, 0.5, 1.0):
        for role in ("map_exact", "map_dither", "map_dither_checker",
                     "map_checker1"):
            shapes = [(1088, 1920), (33, 70), (5, 128), (4, 2)]
            if "checker" not in role:
                shapes += [(540, 959), (7, 33)]
            cases += [(share, role, s) for s in shapes]
    return cases


@pytest.mark.parametrize("share,role,shape", _lit_cases())
def test_k15_map_role_lit_shares_match_twin(dev, share, role, shape):
    """The map role taps only where the sun lights a covered pixel, and the
    result still equals sun_term_plain bit for bit: about 2%, 50% and 100%
    of the pixels lit; 1920x1088, 35 pairs (a row's end past a warp's),
    64 pairs (two warps' edges), one pair, the odd 959 and 33 widths
    without the checkerboard; whole frames (row0 0) and a band's rows from
    row0 544 and 7. One K15 launch a call, none of K14."""
    h, w = shape
    inp = lit_share_inputs(h, w, share, seed=h * 3 + w,
                           side=1024 if w >= 959 else 64)
    for row0 in (0, 544, 7):
        a, kw = sun_term_call(inp, role, dev, row0=row0)
        n14, n15 = shadow.K14.launches, shading.K15.by_name.get("map", 0)
        got = shading.sun_term(*a, **kw)
        assert shading.K15.by_name.get("map", 0) == n15 + 1
        assert shadow.K14.launches == n14
        ref = shading.sun_term_plain(*a, **kw)
        assert _same_or_nan(got, ref), int((got != ref).sum())
    if h * w > 1000:
        lit = a[1].mask & ((a[2] * a[4]).sum(-1) > 0)
        assert abs(float(lit.float().mean()) - 0.9 * share) < 0.02


def test_k12_accumulate_matches_twin_bit_for_bit(dev):
    """The accumulate role (hdr given) equals hdr + the twin's background
    bit for bit, NaN for NaN: -0.0, NaN and inf planted in hdr at covered
    and uncovered pixels (a covered -0.0 comes back +0.0); hdr is left as
    it was; one K12 launch a call, at 1920x1088, 333x97 and 1x1."""
    for (h, w), sun_y in (((1088, 1920), 0.5), ((97, 333), 0.08),
                          ((1, 1), -0.3)):
        a, kw = _k12_args(dev, background_inputs(sun_y, seed=w, width=w,
                                                 height=h), w, h)
        mask = a[0]
        r = np.random.default_rng(h)
        hdr = torch.tensor(r.uniform(0.0, 3.0, (h, w, 3)), dtype=torch.float32,
                           device=dev)
        for k, val in enumerate((-0.0, float("nan"), float("inf"),
                                 -float("inf"), -0.0)):
            ys, xs = torch.nonzero(mask if k % 2 == 0 else ~mask,
                                   as_tuple=True)
            if len(ys):
                j = (k * 7919) % len(ys)
                hdr[ys[j], xs[j], k % 3] = val
        before = hdr.clone()
        n0 = skylight.K12.launches
        got = skylight.environment_background(*a, **kw, hdr=hdr)
        assert skylight.K12.launches == n0 + 1
        ref = skylight.environment_background_plain(*a, **kw, hdr=hdr)
        assert _same_or_nan(got, ref)
        assert torch.equal(hdr.view(torch.int32), before.view(torch.int32))
        assert got.data_ptr() != hdr.data_ptr()
        covered_zero = mask[..., None] & (before == 0)
        assert not bool(torch.signbit(got[covered_zero]).any())
        if h > 1:
            assert bool(torch.isnan(got).any()) and bool(
                torch.isinf(got).any())


def ndl_threshold_inputs(h=64, w=128, side=256, seed=0):
    """World points on distinct texel centres of a (side, side) sun map
    (exact taps, so each pixel reads its own texel), at NDC depths
    0.001-0.01 (where sz + bias keeps most of the bias's bits), random unit
    normals and the sun's direction -> dict(world_pos,
    normal, sun_dir, sun_vp); the map is set on the card to each pixel's
    own sz + bias."""
    r = np.random.default_rng(seed)
    sun = np.float32([0.3, 0.8, -0.5])
    sun = sun / np.linalg.norm(sun)
    vp = np.asarray(shadow.sun_view_proj(sun, [0.0, 0.0, 0.0], 4.0),
                    np.float32)
    texel = r.choice(side * side, h * w, replace=False)
    u, v = texel % side, texel // side
    ndc = np.stack([(u + 0.5) / side * 2.0 - 1.0,
                    1.0 - (v + 0.5) / side * 2.0,
                    r.uniform(0.001, 0.01, h * w)], -1).reshape(h, w, 3)
    return dict(world_pos=_unproject(vp, ndc).astype(np.float32),
                normal=_unit_np(r, (h, w, 3)).astype(np.float32),
                sun_dir=sun.astype(np.float32), sun_vp=vp)


@pytest.mark.parametrize("shape,role", [
    ((1088, 1920), r) for r in K14_ROLES] + [
    ((540, 959), "dither"), ((33, 70), "dither_checker1"),
    ((1, 2), "dither_checker0")])
def test_k14_normal_role_matches_twin_bit_for_bit(dev, shape, role):
    """K14's "+nl" roles (n.l formed from the normal and sun_dir in the
    launch) equal sun_visibility_plain given torch.sum(normal * sun_dir,
    -1), bit for bit, in every role, with a NaN normal."""
    h, w = shape
    side = 1024 if w >= 959 else 64
    wp, depth, vp, _, _, _ = _k14_args(
        dev, sun_tap_inputs(h, w, seed=h + 2, side=side), side)
    r = np.random.default_rng(h)
    nrm = torch.tensor(_unit_np(r, (h, w, 3)), dtype=torch.float32,
                       device=dev)
    if h * w > 2:
        nrm[h // 3, w // 3, 1] = float("nan")
    sun = torch.tensor([0.3, 0.8, -0.5], device=dev)
    sun = sun / torch.linalg.vector_norm(sun)
    dither, parity = K14_ROLES[role]
    name = shadow.role_name(dither, parity, True)
    n0 = shadow.K14.by_name.get(name, 0)
    got = shadow.sun_visibility(wp, None, depth, vp, side, dither=dither,
                                checker_parity=parity, normal=nrm,
                                sun_dir=sun)
    assert shadow.K14.by_name.get(name, 0) == n0 + 1
    ref = shadow.sun_visibility_plain(wp, torch.sum(nrm * sun, -1), depth,
                                      vp, side, dither=dither,
                                      checker_parity=parity)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32)), \
        int((got != ref).sum())


def test_k14_normal_role_sums_as_torch(dev):
    """n.l decides the bias, and the bias a discrete test: a map whose
    texel under each pixel holds exactly sz + bias of torch's n.l on the
    card leaves every pixel lit in the twin and in K14's "+nl" role, while
    n.l summed left to right, (x + y) + z, would shadow some of them."""
    inp = ndl_threshold_inputs()
    f = lambda k: torch.tensor(inp[k], device=dev)
    wp, nrm, sun, vp = f("world_pos"), f("normal"), f("sun_dir"), f("sun_vp")
    side = 256
    ndl = torch.sum(nrm * sun, -1)
    sz, inside, lin = shadow.sun_map_tap(wp, vp, side)
    scale = 2.0 / side

    def edge(nl):
        return sz + (1.5 + 2.0 * (1.0 - torch.clamp(nl, 0.0, 1.0))) * scale
    assert bool(inside.all()) and int(torch.unique(lin).numel()) == lin.numel()
    depth = torch.zeros(side * side, device=dev)
    depth[lin.reshape(-1)] = edge(ndl).reshape(-1)
    depth = depth.view(side, side)
    ref = shadow.sun_visibility_plain(wp, ndl, depth, vp, side)
    got = shadow.sun_visibility(wp, None, depth, vp, side, normal=nrm,
                                sun_dir=sun)
    assert bool((ref == 1.0).all()) and torch.equal(got, ref)
    p = nrm * sun
    left = (p[..., 0] + p[..., 1]) + p[..., 2]
    assert int((edge(left) < edge(ndl)).sum()) > 0


def taa_inputs(h, w, seed=0, role="reproject", y_off=0, nan=True):
    """numpy inputs of one TAA resolve (taa.taa_resolve) in a K3 fetch
    role: reproject (a moving camera), shift (a jitter-only change: a pure
    NDC translation, taa.static_shift) or given (a moving camera and the
    stochastic history fetch, dither FRAME); the current HDR, the history
    with y_off halo rows above and below, depth, m_np = inv_view_proj @
    prev_view_proj (f32), the two matrices and, with y_off, the HDR rows
    above and below (hdr_halo); with nan, a NaN in the HDR and one in the
    history -> dict(current_hdr, history, depth, m_np, inv_view_proj,
    prev_view_proj, hdr_halo, dither)."""
    from incarnation_tpu_torch.core.view import View
    r = np.random.default_rng(seed)
    aspect = w / max(h, 1)
    if role == "shift":
        view = View.from_lookat([0.0, 2.0, -8.0], [0.0, 0.0, 0.0],
                                aspect=aspect)
        px = 2.0 / np.array([w, max(h, 1)])
        prev = np.asarray(view.view_proj(np.array([0.3, -0.2]) * px),
                          np.float32)
        cur = np.asarray(view.view_proj(np.array([-0.4, 0.1]) * px),
                         np.float32)
    else:
        prev = np.asarray(View.from_lookat(
            [0.0, 2.0, -8.0], [0.0, 0.0, 0.0], aspect=aspect).view_proj(),
            np.float32)
        cur = np.asarray(View.from_lookat(
            [0.1, 2.0, -7.9], [0.05, 0.0, 0.0], aspect=aspect).view_proj(),
            np.float32)
    ivp = np.linalg.inv(cur).astype(np.float32)
    m_np = ivp @ prev
    assert (taa.static_shift(m_np, w, h) is not None) == (role == "shift")
    hdr = r.uniform(0.0, 4.0, (h, w, 3)).astype(np.float32)
    hist = r.uniform(0.0, 4.0, (h + 2 * y_off, w, 3)).astype(np.float32)
    if nan and h * w >= 4:
        hdr[h // 2, w // 2, 1] = np.nan
        hist[y_off + h // 3, w // 3, 0] = np.nan
    halo = None
    if y_off:
        halo = tuple(r.uniform(0.0, 4.0, (1, w, 3)).astype(np.float32)
                     for _ in range(2))
    return dict(current_hdr=hdr, history=hist,
                depth=r.uniform(0.05, 0.9, (h, w)).astype(np.float32),
                m_np=m_np, inv_view_proj=ivp, prev_view_proj=prev,
                hdr_halo=halo, dither=7 if role == "given" else None)


def taa_call(inp, device, row0=0):
    """taa.taa_resolve's keyword arguments on taa_inputs' arrays."""
    t = lambda x: torch.tensor(x, device=device)
    h, w = inp["depth"].shape
    return dict(current_hdr=t(inp["current_hdr"]), history=t(inp["history"]),
                depth=t(inp["depth"]), m_np=inp["m_np"], history_valid=True,
                width=w, height=h,
                hdr_halo=(None if inp["hdr_halo"] is None
                          else tuple(t(x) for x in inp["hdr_halo"])),
                dither=inp["dither"], inv_view_proj=t(inp["inv_view_proj"]),
                prev_view_proj=t(inp["prev_view_proj"]), row0=row0)


@pytest.mark.parametrize("y_off", [0, 16], ids=["whole", "band_halo"])
@pytest.mark.parametrize("role", ["reproject", "shift", "given"])
@pytest.mark.parametrize("shape", [(1088, 1920), (540, 959), (37, 53),
                                   (1, 1)], ids=str)
def test_k3_resolve_matches_twin_bit_for_bit(dev, shape, role, y_off):
    """K3's resolve equals taa_resolve_plain bit for bit, NaN where it is
    NaN (torch.minimum and maximum pass a NaN through the clamp), in each
    fetch role, on a whole frame and on a band with 16 history halo rows
    each way and the HDR rows above and below: one K3 launch a call,
    counted under its role."""
    h, w = shape
    kw = taa_call(taa_inputs(h, w, seed=h + w, role=role, y_off=y_off), dev)
    n0 = taa.K3.by_name.get(role, 0)
    got = taa.taa_resolve(**kw)
    assert taa.K3.by_name.get(role, 0) == n0 + 1
    ref = taa.taa_resolve_plain(**kw)
    assert _same_or_nan(got, ref), int((got != ref).sum())
    if h * w >= 4:
        assert bool(torch.isnan(ref).any())
    if h * w > 1000:
        assert float((ref - kw["current_hdr"]).abs().nan_to_num().max()) \
            > 0.1                                # the history blended in


def test_k3_resolve_band_halo_is_read(dev):
    """A band's resolve reads its halo rows: the HDR rows above and below
    change the first and last rows' clamp, and the history's halo the
    reprojected fetch near the band's edges."""
    inp = taa_inputs(64, 256, seed=5, y_off=16, nan=False)
    kw = taa_call(inp, dev)
    got = taa.taa_resolve(**kw)
    edge = dict(kw, hdr_halo=(kw["current_hdr"][:1].contiguous(),
                              kw["current_hdr"][-1:].contiguous()))
    clamped = taa.taa_resolve(**edge)
    assert not torch.equal(got[0], clamped[0])
    assert not torch.equal(got[-1], clamped[-1])
    assert torch.equal(got[1:-1], clamped[1:-1])
    inner = dict(kw, history=kw["history"][16:-16].contiguous())
    assert not torch.equal(got, taa.taa_resolve(**inner))


def test_k3_resolve_no_host_sync_and_refuses(dev):
    """Every role back to back under set_sync_debug_mode("error"): m and
    the shift go by value, so no copy from host memory and no synchronize;
    each equals its twin. Wrong inputs raise and launch nothing."""
    calls = [taa_call(taa_inputs(72, 200, seed=s, role=role, y_off=y),
                      dev) for s, (role, y) in enumerate(
        (("reproject", 0), ("shift", 8), ("given", 0), ("reproject", 8)))]
    torch.cuda.synchronize()
    n0 = taa.K3.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [taa.taa_resolve(**kw) for kw in calls
               if kw["dither"] is None]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert taa.K3.launches == n0 + 3
    for g, kw in zip(got, [kw for kw in calls if kw["dither"] is None]):
        assert _same_or_nan(g, taa.taa_resolve_plain(**kw))
    kw = calls[0]
    n0 = taa.K3.launches
    with pytest.raises(ValueError, match="current_hdr"):
        taa.taa_resolve(**dict(kw, current_hdr=kw["current_hdr"].double()))
    with pytest.raises(ValueError, match="history"):
        taa.taa_resolve(**dict(kw, history=kw["history"][:-1]))
    with pytest.raises(ValueError, match="depth"):
        taa.taa_resolve(**dict(kw, depth=kw["depth"].t().contiguous().t()))
    with pytest.raises(ValueError, match="hdr_halo"):
        taa.taa_resolve(**dict(kw, hdr_halo=(kw["current_hdr"][:1],
                                             kw["current_hdr"][:2])))
    assert taa.K3.launches == n0
