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
    rng = np.random.default_rng(7)
    tris = _soup(rng, 10)
    with pytest.raises(NotImplementedError):
        tbvh.build_wide(tris, method="morton")
    js = make_rich_scene()
    ts = tloader.scene_from_arrays(*tloader.scene_arrays(js), "cpu")
    with pytest.raises(NotImplementedError):
        tbvh.build_scene_bvh(ts, use_cache=False, wide=False, device="cpu")
    tb = tbvh.bvh_from_arrays(_rows_with_ds(tris, True), "cpu")
    with pytest.raises(NotImplementedError):
        tbvh.trace(tb, torch.zeros(1, 3), torch.ones(1, 3),
                   alpha_of=lambda tri, u, v: tri >= 0)
    with pytest.raises(ValueError):
        tbvh.bvh_from_arrays(np.zeros((4, 48), np.float32), "cpu")


def test_cpu_tensors_take_the_twin():
    """CPU rays run the twin and count no K4 launch."""
    tbvh.K4.reset()
    rng = np.random.default_rng(8)
    tb = tbvh.bvh_from_arrays(_rows_with_ds(_soup(rng, 50), True), "cpu")
    o, d = _rays(rng, 64)
    out = tbvh.trace(tb, torch.tensor(o), torch.tensor(d), role="x")
    assert out["tri"].dtype == torch.int32 and out["t"].shape == (64,)
    assert tbvh.K4.launches == 0 and tbvh.K4.by_name == {}
