"""K1's sub-tile rejection and work-item plan, on the CPU.

raster.subtile_may_cover is csrc/raster.cu's conservative (pair, 32x8
sub-tile) test in the same f32 arithmetic. It must never reject a pair
whose triangle covers a pixel centre of the sub-tile under the exact test
(3 edges >= 0, 0 <= z <= 1, z < z_limit), which alone decides coverage in
the kernel. Held here on the bins of the port's scene/testing.py scene and
of seeded random triangle soups with near-plane crossers and slivers."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from incarnation_tpu_torch.core.view import View
from incarnation_tpu_torch.kernels import raster
from incarnation_tpu_torch.scene import testing

torch.set_num_threads(1)

W, H = 256, 96


def _params(**kw):
    base = dict(width=W, height=H, pair_capacity=1 << 14, bin_max_span=8,
                big_tri_capacity=64)
    base.update(kw)
    return raster.RasterParams(**base)


def _bins(scene, params, eye, target):
    vp = View.from_lookat(eye, target, aspect=W / H).view_proj()
    n_prims = scene.prim_material.shape[0]
    prep = raster.prepare_geometry(
        scene, torch.eye(4), torch.tensor(vp, dtype=torch.float32),
        torch.ones(n_prims, dtype=torch.bool), params)
    return raster.bin_triangles_layered(prep, params)[0]


def _soup(seed, n=300):
    """n random triangles in front of the camera, small to screen-filling;
    a twentieth cross the near plane and a fifth are slivers (one corner a
    hair from another)."""
    r = np.random.default_rng(seed)
    c = np.stack([r.uniform(-6, 6, n), r.uniform(-3, 3, n),
                  r.uniform(2, 20, n)], -1)
    size = r.choice([0.05, 0.3, 1.0, 6.0], n, p=[0.3, 0.4, 0.2, 0.1])
    pts = c[:, None] + r.normal(size=(n, 3, 3)) * size[:, None, None]
    pts[: n // 20, 0, 2] = -15.0
    sliver = r.random(n) < 0.2
    pts[sliver, 2] = pts[sliver, 1] + r.normal(size=(sliver.sum(), 3)) * 1e-3
    corner = np.zeros((n, 3, 12), np.float32)
    corner[..., 0:3] = pts
    corner[..., 9] = 1.0
    t = lambda x, dt=torch.int32: torch.tensor(np.asarray(x), dtype=dt)
    return SimpleNamespace(
        mesh_transforms=t(np.eye(4)[None], torch.float32),
        tri_mesh=t(np.zeros(n)), tri_prim=t(np.zeros(n)),
        tri_corner=t(corner.reshape(n, 36).T.copy(), torch.float32),
        prim_double_sided=t([1]), prim_material=t([0]))


def _check_conservative(bins, p, z_limit=None):
    """Asserts no covered (pair, sub-tile) is rejected; returns the share
    of (pair, sub-tile) elements the test rejects."""
    sw, sh = raster.SUBTILE_W, raster.SUBTILE_H
    nsx, nsy = -(-p.tile_w // sw), -(-p.tile_h // sh)
    pix = torch.arange(p.tile_h * p.tile_w)
    sub = (pix // p.tile_w // sh) * nsx + (pix % p.tile_w) // sw
    sx = (torch.arange(nsy * nsx) % nsx).to(torch.int64)
    sy = (torch.arange(nsy * nsx) // nsx).to(torch.int64)
    zl_tiles = raster._tile_limits(z_limit, p)
    zl_sub = None
    if zl_tiles is not None:
        zl_sub = torch.zeros(p.num_tiles, nsy * nsx).scatter_reduce(
            1, sub.expand(p.num_tiles, -1), zl_tiles, reduce="amax")
    rejected = total = 0
    for tt, tr, colf, rowf, z, cov in raster._pair_chunks(bins, p, zl_tiles):
        if zl_tiles is not None:
            cov &= z < zl_tiles[tt]
        covered = torch.zeros(tt.shape[0], nsy * nsx).scatter_reduce(
            1, sub.expand(tt.shape[0], -1), cov.float(), reduce="amax") > 0
        x0 = ((tt % p.tiles_x)[:, None] * p.tile_w + sx[None] * sw) \
            .to(torch.float32) + 0.5
        y0 = ((tt // p.tiles_x)[:, None] * p.tile_h + sy[None] * sh) \
            .to(torch.float32) + 0.5
        may = raster.subtile_may_cover(
            bins.setup[tr][:, None, :], x0, y0,
            None if zl_sub is None else zl_sub[tt])
        assert not bool((covered & ~may).any())
        rejected += int((~may).sum())
        total += may.numel()
    assert total > 0
    return rejected / total


def test_subtile_test_is_conservative_on_the_testing_scene():
    scene = testing.make_rich_scene(device="cpu", blend_quad=True)
    p = _params()
    bins = _bins(scene, p, [0.0, 1.0, 1.0], [0.0, 0.0, 7.0])
    share = _check_conservative(bins, p)
    tri, depth, _ = raster.rasterize_tiles_plain(bins, p)
    assert (tri >= 0).float().mean() > 0.3
    # the next peel: a strict limit at each pixel's nearest depth
    _check_conservative(bins, p, torch.where(tri >= 0, depth, 0.0))
    assert share > 0.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_subtile_test_is_conservative_on_triangle_soup(seed):
    p = _params()
    bins = _bins(_soup(seed), p, [0.5, 0.5, -12.0], [0.0, 0.0, 6.0])
    share = _check_conservative(bins, p)
    zl = torch.tensor(np.random.default_rng(seed).uniform(
        0.0, 0.2, (H, W)), dtype=torch.float32)
    zl[:, : W // 3] = 0.0           # dead columns, as a peel leaves them
    _check_conservative(bins, p, zl)
    # small triangles and slivers: most (pair, sub-tile) tests reject
    assert share > 0.5


def test_subtile_test_keeps_nan_and_rejects_by_each_plane():
    """NaN rows are kept (the exact test decides); a box beyond any one
    edge, in front of the near plane (z > 1), behind the eye (z < 0) or
    behind a z limit is rejected."""
    x0 = torch.tensor(32.5)
    y0 = torch.tensor(16.5)
    inside = [1, 0, 0, 0, 1, 0, -1, -1, 100, 0, 0, 0.5]
    rows = torch.tensor([
        inside,
        [float("nan")] + inside[1:],
        [-1, 0, 20] + inside[3:],             # x <= 20: left of the box
        inside[:9] + [0, 0, 1.5],              # z = 1.5 > 1
        inside[:9] + [0, 0, -0.5],             # z < 0
        inside[:9] + [0, 0, 0.5 + 1e-9],      # z ~ 0.5, on the limit
    ], dtype=torch.float32)
    may = raster.subtile_may_cover(rows, x0, y0)
    assert may.tolist() == [True, True, False, False, False, True]
    assert raster.subtile_may_cover(rows[5:], x0, y0,
                                    torch.tensor(0.25)).tolist() == [False]


def test_work_items_follow_the_list_lengths():
    """One item per tile up to K1_ITEM_PAIRS pairs, then one more per
    K1_ITEM_PAIRS; the count never exceeds the shape-only bound the
    wrapper allocates for."""
    p = _params()
    item = raster.K1_ITEM_PAIRS
    counts = torch.zeros(p.num_tiles, dtype=torch.int32)
    counts[3] = 5 * item + 1
    counts[4] = item
    n = int(counts.sum())
    bins = raster.Bins(
        pair_tri=torch.zeros(n + 1, dtype=torch.int32),
        starts=(torch.cumsum(counts, 0) - counts).to(torch.int32),
        counts=counts, big_tri=torch.zeros(8, dtype=torch.int32),
        big_count=torch.tensor([2], dtype=torch.int32),
        overflow=torch.tensor(0), big_overflow=torch.tensor(0),
        setup=torch.zeros((1, 12)), attr=None)
    items, largest = raster.k1_work_items(bins, p)
    assert items == p.num_tiles + 5 + 1
    assert largest == item
    assert items <= raster.k1_max_items(bins, p)


def test_schedule_constants_match_the_kernel_source():
    """The wrapper sizes K1's key slots and sub-tile checks from its own
    copies of raster.cu's schedule constants; the C entries refuse a call
    whose item size or slot size differs, and here the copies are held to
    the source's #defines."""
    import pathlib
    import re
    src = (pathlib.Path(raster.__file__).resolve().parents[1] / "csrc"
           / "raster.cu").read_text()
    defs = {k: int(v) for k, v in
            re.findall(r"^#define (K1_\w+) (\d+)", src, flags=re.M)}
    assert defs["K1_ITEM"] == raster.K1_ITEM_PAIRS
    assert defs["K1_THREADS"] * defs["K1_PPL"] == raster.K1_TILE_PX
    assert defs["K1_WARPS"] == raster.K1_WARPS
    assert (defs["K1_SUB_W"], defs["K1_SUB_H"]) == (raster.SUBTILE_W,
                                                    raster.SUBTILE_H)
