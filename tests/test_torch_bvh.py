"""Port parity for the scene BVH: the wide SAH build (rows equal JAX's
exactly) and traversal (K4's twin against the JAX trace / occluded on
random triangle soups and rays: closest hit, any hit, tmin / tmax, backface
culling). The JAX trace runs its jnp while-loop on the CPU; the port runs
its plain twin."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incarnation_tpu.kernels import bvh as jbvh
from incarnation_tpu.scene.testing import make_rich_scene
from incarnation_tpu_torch.kernels import bvh as tbvh
from incarnation_tpu_torch.scene import loader as tloader

torch.set_num_threads(1)

# tri must agree on every ray whose JAX hit lies this far inside its
# triangle (u, v, 1 - u - v), and on this share of all rays; elsewhere a
# hit on a shared edge may go to either neighbour after one rounding
EDGE = 1e-4
MIN_TRI_SHARE = 0.999
RTOL = 1e-5      # t, u, v where tri agrees: the same f32 arithmetic, the
#                  multiply-adds XLA fuses emulated through f64 (bvh._fma)


def _soup(rng, n, extent=10.0, size=0.8):
    base = rng.uniform(-extent, extent, (n, 1, 3))
    return (base + rng.uniform(-size, size, (n, 3, 3))).astype(np.float32)


def _rows_with_ds(tris, double_sided):
    geo, leaf_tri = jbvh.build_wide(tris)
    for s in range(jbvh.LEAF_K):
        ok = leaf_tri[:, s] >= 0
        lane = 11 if s == 0 else jbvh._DS1_OFF + s - 1
        geo[ok, lane] = 1.0 if double_sided else 0.0
    return geo


def _rays(rng, n, extent=12.0):
    o = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    # a few axis-aligned directions exercise the inv_d guard
    d[:16] = np.eye(3, dtype=np.float32)[np.arange(16) % 3] \
        * np.where(np.arange(16) % 2, -1.0, 1.0)[:, None]
    return o, d


def _check(jr, tr):
    jt, tt = np.asarray(jr["tri"]), tr["tri"].numpy()
    ju, jv = np.asarray(jr["u"]), np.asarray(jr["v"])
    inside = (jt >= 0) & (ju >= EDGE) & (jv >= EDGE) & (1 - ju - jv >= EDGE)
    assert (tt[inside] == jt[inside]).all()
    assert (tt == jt).mean() >= MIN_TRI_SHARE
    assert int(jr["trunc"]) == 0 and int(tr["trunc"]) == 0
    same = (tt == jt) & (jt >= 0)
    for k in ("t", "u", "v"):
        np.testing.assert_allclose(tr[k].numpy()[same],
                                   np.asarray(jr[k])[same], rtol=RTOL,
                                   atol=1e-7)
    assert np.isinf(tr["t"].numpy()[tt < 0]).all()
    assert (jt >= 0).mean() > 0.02


def test_build_wide_matches_jax():
    rng = np.random.default_rng(0)
    for n in (3, 5, 700):
        tris = _soup(rng, n)
        jg, jl = jbvh.build_wide(tris)
        tg, tl = tbvh.build_wide(tris)
        np.testing.assert_array_equal(tg, jg)
        np.testing.assert_array_equal(tl, jl)


def test_build_scene_bvh_matches_jax():
    """The testing scene's world triangles, double-sided flags and all;
    apply_mesh_visibility hides the same leaf slots."""
    js = make_rich_scene()
    ts = tloader.scene_from_arrays(*tloader.scene_arrays(js), "cpu")
    jb = jbvh.build_scene_bvh(js, use_cache=False)
    tb = tbvh.build_scene_bvh(ts, use_cache=False, device="cpu")
    np.testing.assert_array_equal(tb.rows.numpy(), np.asarray(jb.rows))
    vis = np.ones(ts.mesh_visible.shape[0], np.int32)
    vis[0] = 0
    jh = jbvh.apply_mesh_visibility(jb, js, vis)
    th = tbvh.apply_mesh_visibility(tb, ts, vis)
    np.testing.assert_array_equal(th.rows.numpy(), np.asarray(jh.rows))
    assert tbvh.apply_mesh_visibility(tb, ts, np.ones_like(vis)) is tb


@pytest.mark.parametrize("any_hit,double_sided,tmin,tmax", [
    (False, True, 0.0, 1e30), (False, False, 0.01, 30.0),
    (True, True, 0.5, 12.0), (True, False, 0.0, 1e30)])
def test_trace_matches_jax(any_hit, double_sided, tmin, tmax):
    rng = np.random.default_rng(1 + int(any_hit) + 2 * int(double_sided))
    geo = _rows_with_ds(_soup(rng, 900), double_sided)
    jb = jbvh.SceneBVH(rows=jnp.asarray(geo), links=jnp.zeros((1, 2)),
                       wide=True)
    tb = tbvh.bvh_from_arrays(geo, "cpu")
    o, d = _rays(rng, 3000)
    jr = jbvh.trace(jb, jnp.asarray(o), jnp.asarray(d), tmin=tmin,
                    tmax=tmax, any_hit=any_hit)
    tr = tbvh.trace(tb, torch.tensor(o), torch.tensor(d), tmin=tmin,
                    tmax=tmax, any_hit=any_hit)
    _check(jr, tr)
    if any_hit:
        occ = tbvh.occluded(tb, torch.tensor(o), torch.tensor(d), tmin=tmin,
                            tmax=tmax)
        np.testing.assert_array_equal(occ.numpy(), tr["tri"].numpy() >= 0)


def test_per_ray_tmin_continues_the_ray():
    """A tensor tmin starts each ray at o + d tmin and keeps t measured
    from o: the same hits as moving the origin, t shifted by tmin."""
    rng = np.random.default_rng(5)
    tb = tbvh.bvh_from_arrays(_rows_with_ds(_soup(rng, 400), True), "cpu")
    o, d = _rays(rng, 1000)
    tmin = torch.tensor(rng.uniform(0.0, 3.0, 1000).astype(np.float32))
    a = tbvh.trace(tb, torch.tensor(o), torch.tensor(d), tmin=tmin,
                   tmax=40.0)
    o2 = tbvh._fma(torch.tensor(d), tmin[:, None], torch.tensor(o))
    b = tbvh.trace(tb, o2, torch.tensor(d), tmin=0.0, tmax=40.0)
    hit = b["tri"] >= 0
    assert hit.float().mean() > 0.02
    far = (b["t"] <= 40.0 - 3.0) | ~hit      # inside both intervals
    np.testing.assert_array_equal(a["tri"][far].numpy(),
                                  b["tri"][far].numpy())
    both = far & hit
    torch.testing.assert_close(a["t"][both], b["t"][both] + tmin[both],
                               rtol=1e-6, atol=0)


def test_step_budget_counts_trunc():
    """A ray that has visited max_steps rows stops with its best hit so
    far and counts in trunc; steps per ray are the rows visited."""
    rng = np.random.default_rng(6)
    tb = tbvh.bvh_from_arrays(_rows_with_ds(_soup(rng, 900), True), "cpu")
    o, d = _rays(rng, 500)
    full = tbvh.trace_plain(tb, torch.tensor(o), torch.tensor(d),
                            return_steps=True)
    assert int(full["trunc"]) == 0
    cap = 4
    short = tbvh.trace_plain(tb, torch.tensor(o), torch.tensor(d),
                             max_steps=cap, return_steps=True)
    assert int(short["trunc"]) == int((full["steps"] > cap).sum()) > 0
    assert int(short["steps"].max()) == cap
    done = full["steps"] <= cap
    np.testing.assert_array_equal(short["tri"][done].numpy(),
                                  full["tri"][done].numpy())


def test_walk_counts_filled_slots():
    """The walk's work diagnostics (K4's operation bound in chip_smoke.py)
    count only filled slots: each leaf slot with a triangle (with any hit,
    up to the accepted one) and each internal child with an id."""
    # three triangles across the z axis at z = 2, 4, 6 in one leaf row;
    # the first is small, so a ray at x = 2 passes it and the second
    tris = np.array([[[-0.5, -0.5, 2], [0.5, -0.5, 2], [0, 0.5, 2]],
                     [[-1, -1, 4], [1, -1, 4], [0, 1, 4]],
                     [[-3, -3, 6], [3, -3, 6], [0, 3, 6]]], np.float32)
    tb = tbvh.bvh_from_arrays(_rows_with_ds(tris, True), "cpu")
    o = torch.tensor([[0.0, 0.0, 0.0], [2.0, -1.0, 0.0]])
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
    closest = tbvh.trace_plain(tb, o, d, return_steps=True)
    anyhit = tbvh.trace_plain(tb, o, d, any_hit=True, return_steps=True)
    assert closest["tri"].tolist() == [0, 2]
    assert closest["steps"].tolist() == anyhit["steps"].tolist() == [1, 1]
    assert closest["tri_tests"].tolist() == [3, 3]
    assert anyhit["tri_tests"].tolist() == [1, 3]
    assert closest["box_tests"].tolist() == [0, 0]

    rng = np.random.default_rng(10)
    rows = _rows_with_ds(_soup(rng, 900), True)
    tb = tbvh.bvh_from_arrays(rows, "cpu")
    o, d = _rays(rng, 500)
    internal_filled = (rows[:, tbvh._W_CHILD:tbvh._W_CHILD + 8] >= 0)[
        rows[:, tbvh._W_FLAG] < 0.5]
    assert internal_filled.mean() < 1.0          # the soup leaves gaps
    for any_hit in (False, True):
        w = tbvh.trace_plain(tb, torch.tensor(o), torch.tensor(d),
                             any_hit=any_hit, return_steps=True)
        leaf, internal = w["leaf_steps"], w["steps"] - w["leaf_steps"]
        assert (w["tri_tests"] <= tbvh.LEAF_K * leaf).all()
        assert (w["tri_tests"] >= leaf).all()
        assert (w["box_tests"] <= tbvh.WIDE_ARITY * internal).all()
        assert (w["box_tests"] >= internal).all()
        assert int(w["box_tests"].sum()) < \
            tbvh.WIDE_ARITY * int(internal.sum())


def test_unported_options_raise():
    """The JAX wide build takes the sah topology only (bvh.py:534-538), and
    so does the port's; bvh_from_arrays refuses rows of no layout."""
    rng = np.random.default_rng(7)
    tris = _soup(rng, 10)
    with pytest.raises(NotImplementedError):
        jbvh.build_wide(tris, method="morton")
    with pytest.raises(NotImplementedError):
        tbvh.build_wide(tris, method="morton")
    with pytest.raises(ValueError):
        tbvh.bvh_from_arrays(np.zeros((4, 48), np.float32), "cpu")
    with pytest.raises(ValueError):
        tbvh.bvh_from_arrays(np.zeros((4, 64), np.float32), "cpu")


# ---------------------------------------------------------------------------
# The binary layout (build_lbvh, _finish_bvh, _step) and alpha_of filters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["sah", "morton"])
def test_build_lbvh_matches_jax(method):
    """rows, per-octant links and leaf slots equal JAX's exactly, from the
    single-leaf case to a soup of 700 triangles."""
    rng = np.random.default_rng(11)
    for n in (3, 9, 700):
        tris = _soup(rng, n)
        for got, want in zip(tbvh.build_lbvh(tris, method),
                             jbvh.build_lbvh(tris, method)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("merge_limit", [jbvh._MERGE_LIMIT, 0])
def test_binary_scene_bvh_matches_jax(monkeypatch, merge_limit):
    """build_scene_bvh(wide=False) on the testing scene, merged and (with
    the merge limit patched to 0 in both packages) split: the same tables,
    and apply_mesh_visibility hides the same leaf slots."""
    monkeypatch.setattr(jbvh, "_MERGE_LIMIT", merge_limit)
    monkeypatch.setattr(tbvh, "_MERGE_LIMIT", merge_limit)
    js = make_rich_scene()
    ts = tloader.scene_from_arrays(*tloader.scene_arrays(js), "cpu")
    jb = jbvh.build_scene_bvh(js, use_cache=False, wide=False)
    tb = tbvh.build_scene_bvh(ts, use_cache=False, wide=False, device="cpu")
    assert (tb.merged, tb.wide) == (jb.merged, jb.wide) == \
        (merge_limit > 0, False)
    np.testing.assert_array_equal(tb.rows.numpy(), np.asarray(jb.rows))
    if not tb.merged:
        np.testing.assert_array_equal(tb.links.numpy(),
                                      np.asarray(jb.links))
    vis = np.ones(ts.mesh_visible.shape[0], np.int32)
    vis[0] = 0
    jh = jbvh.apply_mesh_visibility(jb, js, vis)
    th = tbvh.apply_mesh_visibility(tb, ts, vis)
    np.testing.assert_array_equal(th.rows.numpy(), np.asarray(jh.rows))
    assert (th.rows != tb.rows).any()


@pytest.mark.parametrize("any_hit,split", [(False, False), (True, True)])
def test_binary_trace_matches_jax(monkeypatch, any_hit, split):
    """The binary twin (_step over the merged table, or the split rows and
    links) holds JAX's trace to test_trace_matches_jax's tolerances, and
    finds the wide twin's hits."""
    if split:
        monkeypatch.setattr(jbvh, "_MERGE_LIMIT", 0)
        monkeypatch.setattr(tbvh, "_MERGE_LIMIT", 0)
    rng = np.random.default_rng(12 + int(any_hit))
    tris = _soup(rng, 900)
    rows, links, leaf = jbvh.build_lbvh(tris)
    for s in range(jbvh.LEAF_K):
        ok = leaf[:, s] >= 0
        rows[ok, 11 if s == 0 else jbvh._DS1_OFF + s - 1] = float(any_hit)
    jb = jbvh._finish_bvh(rows, links)
    tb = tbvh._finish_bvh(rows, links, "cpu")
    assert tb.merged == (not split)
    o, d = _rays(rng, 3000)
    tmin, tmax = (0.5, 12.0) if any_hit else (0.01, 30.0)
    jr = jbvh.trace(jb, jnp.asarray(o), jnp.asarray(d), tmin=tmin,
                    tmax=tmax, any_hit=any_hit)
    tr = tbvh.trace(tb, torch.tensor(o), torch.tensor(d), tmin=tmin,
                    tmax=tmax, any_hit=any_hit)
    _check(jr, tr)
    if not any_hit:
        geo = _rows_with_ds(tris, False)
        wr = tbvh.trace(tbvh.bvh_from_arrays(geo, "cpu"), torch.tensor(o),
                        torch.tensor(d), tmin=tmin, tmax=tmax)
        np.testing.assert_array_equal(wr["t"].numpy(), tr["t"].numpy())


def test_binary_walk_counts():
    """The binary walk's diagnostics: one box per internal row visited,
    the visited rows of the merged table, the split layout's visited link
    rows, and a step budget that counts trunc."""
    rng = np.random.default_rng(13)
    rows, links, _ = tbvh.build_lbvh(_soup(rng, 400))
    o, d = _rays(rng, 300)
    o, d = torch.tensor(o), torch.tensor(d)
    for tb in (tbvh.bvh_from_arrays(rows, "cpu", links),
               tbvh._finish_bvh(rows, links, "cpu")):
        w = tbvh.trace_plain(tb, o, d, return_steps=True)
        assert int(w["trunc"]) == 0
        np.testing.assert_array_equal(w["box_tests"].numpy(),
                                      (w["steps"] - w["leaf_steps"]).numpy())
        assert int(w["visited"].sum()) > 0
        assert ("visited_links" in w) == (not tb.merged)
        short = tbvh.trace_plain(tb, o, d, max_steps=3)
        assert int(short["trunc"]) == int((w["steps"] > 3).sum()) > 0


def _far_split_table(n):
    """A split binary table of n nodes whose walk ends at its last two
    rows, so that each octant's last links come near 8n: the root (row 0)
    boxes everything and leads to leaf n - 2 (a triangle no ray meets),
    whose miss link leads to leaf n - 1 (a double-sided triangle in the
    plane z = 0 around the origin). np.zeros maps its pages lazily: only
    the rows and links written take memory."""
    rows = np.zeros((n, tbvh.ROW_LANES), np.float32)
    links = np.zeros((8 * n, 2), np.int32)
    rows[0, 0:3], rows[0, 3:6] = -100.0, 100.0
    tris = np.float32([[[50, 50, 50], [51, 50, 50], [50, 51, 50]],
                       [[-10, -10, 0], [10, -10, 0], [0, 10, 0]]])
    rows[n - 2:] = tbvh._leaf_rows_for(tris, np.array([[0, -1, -1, -1],
                                                       [1, -1, -1, -1]]))
    rows[n - 2:, 11] = 1.0
    for okt in range(8):
        off = okt * n
        links[off] = (off + n - 2, -1)
        links[off + n - 2] = (-1, off + n - 1)
        links[off + n - 1] = (-1, -1)
    return rows, links


def _octant_rays():
    """One ray per direction octant through the origin, from 4 away."""
    signs = np.array([[1.0 - 2 * ((k >> a) & 1) for a in range(3)]
                      for k in range(8)], np.float32)
    d = signs * np.float32([0.36, 0.48, 0.8])
    return -4.0 * d, d


def test_split_links_pass_2_24():
    """Above _MERGE_LIMIT nodes the split table's last links pass 2^24,
    past which f32 holds no odd integer (links of octants 5-7 at 3M nodes
    would round to the wrong node): the build and bvh_from_arrays keep the
    links int32, and the twin walks every octant to the table's last row
    and its triangle at t = 4 (rtol 1e-6)."""
    rng = np.random.default_rng(15)
    assert tbvh.build_lbvh(_soup(rng, 40))[1].dtype == np.int32
    assert tbvh.bvh_from_arrays(np.zeros((2, 48), np.float32), "cpu",
                                np.zeros((16, 2), np.float32)
                                ).links.dtype == torch.int32
    with pytest.raises(ValueError, match="whole"):
        tbvh.bvh_from_arrays(np.zeros((2, 48), np.float32), "cpu",
                             np.full((16, 2), 0.5, np.float32))
    n = 3 << 20
    rows, links = _far_split_table(n)
    assert n > tbvh._MERGE_LIMIT and links.max() > 1 << 24
    assert (links.max(1).astype(np.float32) != links.max(1)).any()
    tb = tbvh.SceneBVH(rows=torch.from_numpy(rows),
                       links=torch.from_numpy(links), wide=False)
    o, d = _octant_rays()
    out = tbvh.trace(tb, torch.tensor(o), torch.tensor(d))
    assert out["tri"].tolist() == [1] * 8 and int(out["trunc"]) == 0
    torch.testing.assert_close(out["t"], torch.full((8,), 4.0), rtol=1e-6,
                               atol=0)


# rays whose alpha at the masked quad lies this close to the threshold may
# be decided differently from JAX (XLA's CPU build fuses the UV and
# bilinear multiply-adds); the test counts and excludes them
ALPHA_EPS = 1e-5


@pytest.fixture(scope="module")
def masked_scene():
    """make_rich_scene in both packages with the port's binary BVH, and
    2000 rays from in front of its MASK quad (z = 6) toward it."""
    js = make_rich_scene()
    ts = tloader.scene_from_arrays(*tloader.scene_arrays(js), "cpu")
    tb = tbvh.build_scene_bvh(ts, use_cache=False, wide=False, device="cpu")
    rng = np.random.default_rng(14)
    n = 2000
    o = np.stack([rng.uniform(-3.5, 3.5, n), rng.uniform(-1.5, 4.5, n),
                  rng.uniform(0.5, 2.0, n)], 1).astype(np.float32)
    d = np.stack([rng.normal(0, 0.1, n), rng.normal(0, 0.1, n),
                  np.ones(n)], 1).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    noise = rng.uniform(0.0, 1.0, n).astype(np.float32)
    return js, ts, tb, o, d, noise


def _near_threshold(ts, tb, o, d, noise):
    """Rays whose first hit on a masked triangle has its alpha within
    ALPHA_EPS of its threshold (the port's arithmetic)."""
    from incarnation_tpu_torch.scene import textures as ttex
    mode = ts.prim_alpha_mode[ts.tri_prim.clamp(min=0).long()]
    only_masked = tbvh.trace(
        tb, torch.tensor(o), torch.tensor(d),
        alpha_of=lambda tri, u, v: mode[tri.clamp(min=0).long()] == 1)
    tri, u, v = only_masked["tri"], only_masked["u"], only_masked["v"]
    safe = tri.clamp(min=0).long()
    tv = ts.tri_vtx[safe].long()
    uv = (ts.uvs[tv[:, 0]] + u[:, None] * (ts.uvs[tv[:, 1]] - ts.uvs[tv[:, 0]])
          + v[:, None] * (ts.uvs[tv[:, 2]] - ts.uvs[tv[:, 0]]))
    mat = ts.prim_material[ts.tri_prim[safe].clamp(min=0).long()]
    fac = ts.mat_params[mat.clamp(min=0).long()]
    alpha = fac[:, 6] * ttex.sample_stack_alpha(ts.mat_stack, mat, uv)
    return ((tri >= 0) & ((alpha - fac[:, 11]).abs() < ALPHA_EPS)).numpy()


@pytest.mark.parametrize("any_hit", [False, True])
def test_alpha_filter_matches_jax(masked_scene, any_hit):
    """trace(alpha_of=pathtrace.AlphaFilter(scene, noise)) on the binary
    twin against JAX's trace(alpha_of=_alpha_at_hit) on its binary BVH:
    the same tri on every ray but those within ALPHA_EPS of the threshold
    (counted: under 1% of the rays), t, u, v to RTOL; the filter passes
    some masked hits and rejects others."""
    from incarnation_tpu.kernels import pathtrace as jpt
    from incarnation_tpu_torch.kernels import pathtrace as tpt
    js, ts, tb, o, d, noise = masked_scene
    jb = jbvh.build_scene_bvh(js, use_cache=False, wide=False)
    jnoise = jnp.asarray(noise)
    jr = jbvh.trace(jb, jnp.asarray(o), jnp.asarray(d), any_hit=any_hit,
                    alpha_of=lambda tri, u, v: jpt._alpha_at_hit(
                        js, tri, u, v, jnoise))
    flt = tpt.AlphaFilter(ts, torch.tensor(noise))
    tr = tbvh.trace(tb, torch.tensor(o), torch.tensor(d), any_hit=any_hit,
                    alpha_of=flt)
    bare = tbvh.trace(tb, torch.tensor(o), torch.tensor(d), any_hit=any_hit)
    near = _near_threshold(ts, tb, o, d, noise)
    jt, tt = np.asarray(jr["tri"]), tr["tri"].numpy()
    assert near.mean() < 0.01
    assert (tt[~near] == jt[~near]).all()
    same = (tt == jt) & (jt >= 0)
    for k in ("t", "u", "v"):
        np.testing.assert_allclose(tr[k].numpy()[same],
                                   np.asarray(jr[k])[same], rtol=RTOL,
                                   atol=1e-7)
    masked = (ts.prim_alpha_mode[ts.tri_prim[bare["tri"].clamp(min=0).long()]
                                 .long()] == 1).numpy() \
        & (bare["tri"].numpy() >= 0)
    passed = masked & (tt == bare["tri"].numpy())
    assert 0.05 < passed.sum() / masked.sum() < 0.95
    # the same filter on the wide twin finds the same hits, and a plain
    # callable of the same test (the quad is MASK: no noise) takes the
    # twin on CPU tensors
    wb = tbvh.build_scene_bvh(ts, use_cache=False, device="cpu")
    wr = tbvh.trace(wb, torch.tensor(o), torch.tensor(d), any_hit=any_hit,
                    alpha_of=flt)
    np.testing.assert_array_equal(wr["tri"].numpy(), tt)
    lam = tbvh.trace(tb, torch.tensor(o), torch.tensor(d), any_hit=any_hit,
                     alpha_of=lambda tri, u, v: tpt._alpha_at_hit(
                         ts, tri, u, v, torch.zeros(tri.shape)))
    np.testing.assert_array_equal(lam["tri"].numpy(), tt)


def test_cpu_tensors_take_the_twin():
    """CPU rays run the twin and count no K4 launch."""
    tbvh.K4.reset()
    rng = np.random.default_rng(8)
    tb = tbvh.bvh_from_arrays(_rows_with_ds(_soup(rng, 50), True), "cpu")
    o, d = _rays(rng, 64)
    out = tbvh.trace(tb, torch.tensor(o), torch.tensor(d), role="x")
    assert out["tri"].dtype == torch.int32 and out["t"].shape == (64,)
    assert tbvh.K4.launches == 0 and tbvh.K4.by_name == {}
