"""Port parity for the raster front end and K1's plain twin: triangle
setup, layered binning (the pair stream element for element, tile lists
and overflow counts) and rasterize_tiles in
its opaque, z_limit and masked roles, against the JAX package (its Pallas
K1 in interpret mode)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incarnation_tpu.core.view import View as JView
from incarnation_tpu.kernels import raster as jr
from incarnation_tpu.kernels import resolve as jresolve
from incarnation_tpu.scene import textures as jtex
from incarnation_tpu.scene.testing import make_scene
from incarnation_tpu.scene import materials as jmaterials
from incarnation_tpu_torch.kernels import raster as tr
from incarnation_tpu_torch.kernels import resolve as tresolve
from incarnation_tpu_torch.scene import loader as tloader

torch.set_num_threads(1)

W, H = 256, 64
EYE4 = np.eye(4, dtype=np.float32)


def _params(**kw):
    base = dict(width=W, height=H, tile_h=16, tile_w=128, pair_capacity=512,
                bin_max_span=2, big_tri_capacity=16, bin_mid_span=4,
                mid_tri_capacity=8)
    base.update(kw)
    return (jr.RasterParams(chunk=8, **base), tr.RasterParams(**base))


def _soup(seed, n=60, n_prims=4):
    """Random triangles in front of the camera: small, mid-tier and
    full-screen sizes, a few crossing the near plane, a few fully behind
    the eye, mixed windings, several primitives."""
    rng = np.random.default_rng(seed)
    c = np.stack([rng.uniform(-6, 6, n), rng.uniform(-3, 3, n),
                  rng.uniform(2, 20, n)], -1)
    size = rng.choice([0.3, 1.0, 3.0, 12.0], n, p=[0.4, 0.3, 0.2, 0.1])
    pts = c[:, None, :] + rng.normal(size=(n, 3, 3)) * size[:, None, None]
    pts[: n // 10, 0, 2] = -20.0                 # crosses the near plane
    pts[n // 10: n // 10 + 2, :, 2] = -30.0      # fully behind the eye
    pos = pts.reshape(-1, 3).astype(np.float32)
    tris = np.arange(3 * n, dtype=np.int32).reshape(n, 3)
    tri_prim = rng.integers(0, n_prims, n).astype(np.int32)
    order = np.argsort(tri_prim, kind="stable")
    tris, tri_prim = tris[order], tri_prim[order]
    offs = np.searchsorted(tri_prim, np.arange(n_prims)).astype(np.int32)
    normals = rng.normal(size=(3 * n, 3)).astype(np.float32)
    uvs = rng.uniform(-1, 2, (3 * n, 2)).astype(np.float32)
    scene = make_scene(pos, tris, normals=normals, uvs=uvs,
                       tri_prim=tri_prim, num_prims=n_prims,
                       prim_tri_offset=offs)
    ds = (np.arange(n_prims) % 2).astype(np.int32)
    return dataclasses.replace(scene, prim_double_sided=jnp.asarray(ds))


def _view(tp):
    return JView.from_lookat([0.5, 0.5, -12.0], [0.0, 0.0, 6.0],
                             aspect=tp.width / tp.height).view_proj()


def _to_torch(jscene):
    return tloader.scene_from_arrays(*tloader.scene_arrays(jscene), "cpu")


def _prep_both(jscene, jp, tp, meshlet_visible=None, prim_visible=None):
    vp = _view(tp)
    npr = jscene.prim_mesh.shape[0]
    pv = np.ones(npr, bool) if prim_visible is None else prim_visible
    jprep = jr.prepare_geometry(
        jscene, jnp.asarray(EYE4), jnp.asarray(vp), jnp.asarray(pv), jp,
        meshlet_visible=(None if meshlet_visible is None
                         else jnp.asarray(meshlet_visible)))
    tprep = tr.prepare_geometry(
        _to_torch(jscene), torch.as_tensor(EYE4), torch.as_tensor(vp),
        torch.as_tensor(pv), tp,
        meshlet_visible=(None if meshlet_visible is None
                         else torch.as_tensor(meshlet_visible)))
    return jprep, tprep


@pytest.mark.parametrize("seed", [0, 1])
def test_prepare_geometry_matches_jax(seed):
    """valid and bbox exactly; setup and attribute planes to 1e-5 of each
    row's magnitude (the same f32 formulas; XLA may fuse differently)."""
    jscene = _soup(seed)
    jp, tp = _params()
    mv = np.random.default_rng(seed).random(4) > 0.2
    jprep, tprep = _prep_both(jscene, jp, tp, meshlet_visible=mv)
    np.testing.assert_array_equal(tprep.valid.numpy(),
                                  np.asarray(jprep.valid))
    np.testing.assert_array_equal(tprep.bbox.numpy(), np.asarray(jprep.bbox))
    for t_arr, j_arr in ((tprep.setup.numpy(), np.asarray(jprep.setup_t).T),
                         (tprep.attr.numpy(), np.asarray(jprep.attr_flat))):
        scale = np.abs(j_arr).max(axis=1, keepdims=True) + 1e-30
        np.testing.assert_allclose(t_arr / scale, j_arr / scale, rtol=0,
                                   atol=1e-5)
    assert 0 < tprep.valid.sum() < tprep.valid.numel()


@pytest.mark.parametrize("case", [
    dict(),                                             # no overflow
    dict(pair_capacity=64),                             # pair overflow
    dict(big_tri_capacity=2, mid_tri_capacity=1),       # big overflow
    dict(bin_mid_span=2),                               # mid tier off
])
def test_binning_sets_and_counts_match_jax(case):
    """The twin's pair stream equals JAX's element for element: the
    triangle ids of the kept pairs in (bucket, triangle) order against the
    id lane of JAX's pair rows, so the cut at pair_capacity keeps the same
    pairs, and zeros after them up to pair_tri's fixed pair_capacity + 1;
    per layer starts, counts, the big list, big_count, overflow and
    big_overflow exactly."""
    jscene = _soup(2, n=90)
    jp, tp = _params(**case)
    jprep, tprep = _prep_both(jscene, jp, tp)
    n_layers = 3
    layer = (np.arange(jprep.ids.shape[0]) % n_layers).astype(np.int32)
    jb = jr.bin_triangles_layered(jprep.setup_t, jprep.ids, jprep.valid,
                                  jprep.bbox, jp, jprep.attr_flat,
                                  layer=jnp.asarray(layer),
                                  n_layers=n_layers)
    tb = tr.bin_triangles_layered(tprep, tp, layer=torch.as_tensor(layer),
                                  n_layers=n_layers)
    # JAX's stream holds its kept pairs, then filler (the unused candidate
    # slots' ids, then zeros); the buckets partition the kept pairs
    cap = tp.pair_capacity
    kept = sum(int(np.asarray(j.counts).sum()) + int(j.big_count[0])
               + int(j.big_overflow) for j in jb)
    assert 0 < kept <= cap
    pair_tri = tb[0].pair_tri.numpy()
    assert pair_tri.shape == (cap + 1,) and not pair_tri[kept:].any()
    j_ids = np.asarray(jb[0].setup).reshape(-1, 16)[:kept, 12]
    np.testing.assert_array_equal(pair_tri[:kept], j_ids.astype(np.int32))
    for l in range(n_layers):
        t, j = tb[l], jb[l]
        assert t.pair_tri is tb[0].pair_tri
        np.testing.assert_array_equal(t.starts.numpy(), np.asarray(j.starts))
        np.testing.assert_array_equal(t.counts.numpy(), np.asarray(j.counts))
        assert t.big_count.tolist() == np.asarray(j.big_count).tolist()
        np.testing.assert_array_equal(
            t.big_tri.numpy(), np.asarray(j.big_ids)[:, 0].astype(np.int32))
        assert int(t.overflow) == int(j.overflow)
        assert int(t.big_overflow) == int(j.big_overflow)
    if "pair_capacity" in case:
        assert int(tb[0].overflow) > 0
        # the cut falls inside a tile's bucket, which keeps its lowest ids
        assert any(((b.starts < cap) & (b.starts + b.counts == cap)).any()
                   for b in tb)
    if "big_tri_capacity" in case:
        assert sum(int(b.big_overflow) for b in tb) > 0


def _assert_raster_equal(t_out, j_out):
    """tri exactly away from equal-depth pixels (the kernels break depth
    ties differently); depth to 1e-6 relative + 1e-6 absolute (the depth
    plane's coefficients leave prepare_geometry a few ulps apart, XLA
    fusing the setup math, and evaluating the plane cancels large terms);
    interp to 1e-4 of each channel's magnitude (the same plane
    evaluation, f32)."""
    ttri, tdep, tint = (x.numpy() for x in t_out)
    jtri, jdep, jint = (np.asarray(x) for x in j_out)
    np.testing.assert_allclose(tdep, jdep, rtol=1e-6, atol=1e-6)
    diff = ttri != jtri
    assert diff.mean() < 0.01
    same = ~diff
    for c in range(tint.shape[0]):
        scale = np.abs(jint[c][same]).max() + 1e-6
        np.testing.assert_allclose(tint[c][same] / scale,
                                   jint[c][same] / scale, rtol=0, atol=1e-4,
                                   err_msg=f"channel {c}")
    return ttri


def test_rasterize_opaque_and_zlimit_peels_match_jax():
    """K1's twin in the opaque role, then three z_limit peels chained as
    the depth-peel ladder chains them, against JAX's interpret-mode K1."""
    jscene = _soup(3, n=70)
    jp, tp = _params()
    jprep, tprep = _prep_both(jscene, jp, tp)
    jb = jr.bin_triangles(jprep.setup_t, jprep.ids, jprep.valid, jprep.bbox,
                          jp, jprep.attr_flat)
    tb = tr.bin_triangles_layered(tprep, tp)[0]
    ttri = _assert_raster_equal(tr.rasterize_tiles(tb, tp),
                                jr.rasterize_tiles(jb, jp))
    assert (ttri >= 0).mean() > 0.3
    jz = jnp.full((H, W), 2.0, jnp.float32)
    tz = torch.full((H, W), 2.0)
    for _ in range(3):
        j_out = jr.rasterize_tiles(jb, jp, z_limit=jz)
        t_out = tr.rasterize_tiles(tb, tp, z_limit=tz)
        _assert_raster_equal(t_out, j_out)
        jz = jnp.where(j_out[0] >= 0, j_out[1], 0.0)
        tz = torch.where(t_out[0] >= 0, t_out[1], 0.0)


def _block_alpha_stack(size=16, block=4):
    """Material 0: neutral 1x1; material 1: white with alpha 0/1 in
    block x block texel squares (size x size, one mip, clamp): the squares
    are wide enough for the amask bitplane to hold certainly-transparent
    cells (a 1-texel checkerboard has none under bilinear filtering)."""
    ys, xs = np.mgrid[0:size, 0:size]
    a = ((((xs // block) + (ys // block)) % 2) * 255).astype(np.uint32)
    w0 = np.uint32(0x00FFFFFF) | (a << np.uint32(24))
    rows1 = np.stack([w0, np.full_like(w0, 0xFFFF8080),
                      np.full_like(w0, 0xFFFFFFFF),
                      np.full_like(w0, 0x00FFFFFF)], -1).reshape(-1, 4)
    flat = np.concatenate([jtex._NEUTRAL_TEXEL[None], rows1]) \
        .astype(np.uint32)
    meta = np.asarray([[0, 1, 1, jtex.ADDRESS_WRAP],
                       [1, size, 1, jtex.ADDRESS_CLAMP]], np.int32)
    stack = jtex.make_material_stack(flat, meta)
    amask = np.asarray(stack.amask).copy()
    amask[1] = jtex._amask_words([a.astype(np.float32) / 255.0], 1, 0.5,
                                 1.0, jtex.ADDRESS_CLAMP)
    return dataclasses.replace(stack, amask=jnp.asarray(amask))


def _masked_scene():
    """Five overlapping alpha-tested quads at increasing depth, alternating
    the neutral material (alpha 1) and the checkerboard-alpha material, in
    front of an opaque wall: tiles mix materials (the first masked quad,
    whose pairs lead each tile's list, is neutral), and pixels stack
    several certainly-transparent fragments."""
    quads = [([-9, -4, 12], [18, 0, 0], [0, 8, 0])]   # opaque wall
    for k in range(5):
        quads.append(([-6 + 0.7 * k, -3 + 0.3 * k, 3 + 1.5 * k],
                      [7, 0.5, 0], [0, 4, 0.3]))
    pos, uv, tris = [], [], []
    for (o, du, dv) in quads:
        b = len(pos)
        o, du, dv = (np.asarray(x, np.float32) for x in (o, du, dv))
        pos += [o, o + du, o + du + dv, o + dv]
        uv += [[0, 0], [2, 0], [2, 2], [0, 2]]
        tris += [[b, b + 2, b + 1], [b, b + 3, b + 2]]
    n = len(quads)

    class _G:
        materials = [{"alphaMode": "MASK", "alphaCutoff": 0.5},
                     {"alphaMode": "MASK", "alphaCutoff": 0.5}]

    mats = jmaterials.build_material_table(_G)
    return make_scene(
        pos, tris, double_sided=True, materials=mats,
        uvs=np.asarray(uv, np.float32),
        tri_prim=np.repeat(np.arange(n), 2).astype(np.int32), num_prims=n,
        prim_tri_offset=(2 * np.arange(n)).astype(np.int32),
        prim_alpha_mode=[0] + [1] * (n - 1),
        prim_material=[0] + [(k + 1) % 2 for k in range(1, n)],
        mat_stack=_block_alpha_stack())


def test_masked_peel_ladder_matches_jax():
    """The masked role (in-race amask rejection) inside the full peel
    ladder of render_frame. JAX tests each tile's PRIMARY material's
    bitplane; the port tests each fragment's own material, which rejects
    more certainly-transparent fragments. Both rejections are
    conservative, so the ladder's survivors must be the same: tri, depth
    and interp of the merged frame equal JAX's (tolerances as above), with
    no peel overflow on either side."""
    jscene = _masked_scene()
    tscene = _to_torch(jscene)
    jp, tp = _params(height=32, pair_capacity=1024, bin_max_span=8,
                     bin_mid_span=16)
    jprep, tprep = _prep_both(jscene, jp, tp)
    layer = (np.asarray(jscene.prim_alpha_mode)[
        np.asarray(jscene.tri_prim)] > 0).astype(np.int32)
    jb = jr.bin_triangles_layered(jprep.setup_t, jprep.ids, jprep.valid,
                                  jprep.bbox, jp, jprep.attr_flat,
                                  layer=jnp.asarray(layer), n_layers=2,
                                  emit_amask=True)
    tb = tr.bin_triangles_layered(tprep, tp, layer=torch.as_tensor(layer),
                                  n_layers=2)

    def ladder(rast, alpha_fn, where, full, bins, mask_table, peels):
        tri, depth, interp = rast(bins[0], None, None)
        acc_t = full(tri.shape, -1)
        acc_d = full(depth.shape, 0.0)
        acc_i = full(interp.shape, 0.0)
        zlim = full(depth.shape, 2.0)
        cont = None
        for _ in range(peels):
            m_t, m_d, m_i = rast(bins[1], zlim, mask_table)
            alpha, thresh = alpha_fn(m_t, m_i)
            hit = m_t >= 0
            passed = hit & (alpha >= thresh)
            newly = passed & (acc_t < 0)
            acc_t = where(newly, m_t, acc_t)
            acc_d = where(newly, m_d, acc_d)
            acc_i = where(newly[None], m_i, acc_i)
            cont = hit & ~passed & (acc_t < 0)
            zlim = where(cont, m_d, 0.0)
        win = (acc_t >= 0) & (acc_d > depth)
        return (where(win, acc_t, tri), where(win, acc_d, depth),
                where(win[None], acc_i, interp), int(cont.sum()))

    # jitted: the interpret-mode kernel and the alpha fetch then compile
    # once instead of dispatching op by op on every peel
    j_rast = jax.jit(lambda b, z, m: jr.rasterize_tiles(
        b, jp, z_limit=z, mask_table=m))
    j_alpha = jax.jit(lambda t, i: jresolve.masked_alpha(jscene, t, i))
    j_out = ladder(
        j_rast, j_alpha,
        jnp.where, lambda s, v: jnp.full(s, v, jnp.float32 if isinstance(
            v, float) else jnp.int32), jb, jscene.mat_stack.amask, 6)
    t_out = ladder(
        lambda b, z, m: tr.rasterize_tiles(b, tp, z_limit=z, mask_table=m),
        lambda t, i: tresolve.masked_alpha(tscene, t, i),
        torch.where, lambda s, v: torch.full(s, v, dtype=torch.float32
                                             if isinstance(v, float)
                                             else torch.int32),
        tb, tscene.mat_stack.amask, 6)
    assert j_out[3] == 0 and t_out[3] == 0
    ttri = _assert_raster_equal(t_out[:3], j_out[:3])
    prim = np.asarray(jscene.tri_prim)[np.maximum(ttri, 0)]
    assert len(set(prim[ttri >= 0].tolist())) >= 4


def test_masked_role_rejects_only_transparent_cells():
    """One masked pass: every fragment the port's in-race rejection drops
    is certainly transparent, so each pixel the port leaves empty or
    deeper than JAX's winner has a JAX winner that fails the alpha test."""
    jscene = _masked_scene()
    tscene = _to_torch(jscene)
    jp, tp = _params(height=32, pair_capacity=1024, bin_max_span=8,
                     bin_mid_span=16)
    jprep, tprep = _prep_both(jscene, jp, tp)
    layer = (np.asarray(jscene.prim_alpha_mode)[
        np.asarray(jscene.tri_prim)] > 0).astype(np.int32)
    jb = jr.bin_triangles_layered(jprep.setup_t, jprep.ids, jprep.valid,
                                  jprep.bbox, jp, jprep.attr_flat,
                                  layer=jnp.asarray(layer), n_layers=2,
                                  emit_amask=True)[1]
    tb = tr.bin_triangles_layered(tprep, tp, layer=torch.as_tensor(layer),
                                  n_layers=2)[1]
    jt, jd, ji = jr.rasterize_tiles(jb, jp, mask_table=jscene.mat_stack.amask)
    tt, td, _ = tr.rasterize_tiles(tb, tp, mask_table=tscene.mat_stack.amask)
    alpha, thresh = jresolve.masked_alpha(jscene, jt, ji)
    passes = np.asarray((jt >= 0) & (alpha >= thresh))
    moved = ~np.isclose(td.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-6)
    assert moved.any()
    assert not (moved & passes).any()
    assert (tt.numpy() != np.asarray(jt))[~moved].mean() < 0.01
