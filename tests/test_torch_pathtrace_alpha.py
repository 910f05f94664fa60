"""The path tracer's alpha-masked continuation against the JAX package, on
two quads: a MASK quad at z = 4 with a 4x4 checkerboard alpha in front of
an opaque quad at z = 8, rays from z = 0 along +z.

- Where the rays peel, tri, u and v agree with JAX everywhere, and t on
  every ray that did not peel.
- Divergence 1 (ROADMAP Queue 3): JAX's _trace_alpha re-traces from the
  continuation point and reports t from there, 3.999 for a hit at
  distance 8; the port continues the same ray and reports 8.0, so its hit
  point lies on the back quad.
- Divergence 2 (ROADMAP Queue 3): JAX re-traces at most a quarter of the
  batch (a TPU-only capacity) and the transparent rays beyond it end as
  misses; the port re-traces every transparent hit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incarnation_tpu.kernels import bvh as jbvh
from incarnation_tpu.kernels import pathtrace as jpt
from incarnation_tpu.scene.testing import (checkerboard_alpha_stack,
                                           make_scene)
from incarnation_tpu_torch.kernels import bvh as tbvh
from incarnation_tpu_torch.kernels import pathtrace as tpt
from incarnation_tpu_torch.scene import loader as tloader

torch.set_num_threads(1)

FRONT_Z, BACK_Z = 4.0, 8.0


def _quad(z, s=4.0):
    return np.array([[-s, -s, z], [s, -s, z], [s, s, z], [-s, s, z]],
                    np.float32)


@pytest.fixture(scope="module")
def scenes():
    """tests/test_alpha.py's _masked_front_opaque_back in both packages."""
    pts = np.concatenate([_quad(FRONT_Z), _quad(BACK_Z, s=6.0)])
    uvs = np.concatenate([
        np.array([[0, 1], [1, 1], [1, 0], [0, 0]], np.float32),
        np.zeros((4, 2), np.float32)])
    js = make_scene(pts, [[0, 1, 2], [0, 2, 3], [4, 5, 6], [4, 6, 7]],
                    uvs=uvs, double_sided=True, tri_prim=[0, 0, 1, 1],
                    num_prims=2, prim_tri_offset=[0, 2],
                    prim_alpha_mode=[1, 0], prim_material=[0, 0],
                    mat_stack=checkerboard_alpha_stack(4))
    ts = tloader.scene_from_arrays(*tloader.scene_arrays(js), "cpu")
    return (js, jbvh.build_scene_bvh(js, use_cache=False), ts,
            tbvh.build_scene_bvh(ts, use_cache=False, device="cpu"))


def _rays(n, extent, seed):
    rng = np.random.default_rng(seed)
    o = np.zeros((n, 3), np.float32)
    o[:, :2] = rng.uniform(-extent, extent, (n, 2))
    d = np.tile(np.float32([0.0, 0.0, 1.0]), (n, 1))
    return o, d


def _both(scenes, o, d):
    js, jb, ts, tb = scenes
    noise = np.zeros(o.shape[0], np.float32)
    j = jpt._trace_alpha(js, jb, jnp.asarray(o), jnp.asarray(d),
                         jpt.RAY_OFFSET, 1e4, jnp.uint32(0),
                         noise_u=jnp.asarray(noise))
    t = tpt._trace_alpha(ts, tb, torch.tensor(o), torch.tensor(d),
                         tpt.RAY_OFFSET, 1e4, 0, noise_u=torch.tensor(noise))
    return ({k: np.asarray(v) for k, v in j.items()},
            {k: v.numpy() for k, v in t.items()})


def _peeled(o):
    """Rays that meet a transparent cell of the front quad's checkerboard
    (alpha 0 where (x + y) is even over its 4x4 cells)."""
    inside = (np.abs(o[:, 0]) < 4.0) & (np.abs(o[:, 1]) < 4.0)
    cx = np.floor((o[:, 0] + 4.0) / 2.0)
    cy = np.floor((4.0 - o[:, 1]) / 2.0)
    return inside & ((cx + cy) % 2 == 0)


def test_masked_trace_matches_jax_where_it_can(scenes):
    """Few enough rays peel (under a quarter) that JAX re-traces them all:
    tri, u, v agree on every ray, t on every ray that did not peel."""
    o, d = _rays(2000, 9.0, 0)
    peel = _peeled(o)
    assert 0.05 < peel.mean() < 0.2
    j, t = _both(scenes, o, d)
    np.testing.assert_array_equal(t["tri"], j["tri"])
    np.testing.assert_allclose(t["u"], j["u"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t["v"], j["v"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t["t"][~peel], j["t"][~peel], rtol=1e-6)
    assert (t["tri"][peel] >= 2).all()           # the back quad, tris 2, 3


def test_peeled_t_from_the_ray_origin(scenes):
    """Divergence 1: a ray through a transparent cell hits the back quad
    at distance 8; JAX reports 3.999 (8 - 4 - RAY_OFFSET, from its
    continuation point), the port 8.0, and the port's hit point lies on
    the back quad."""
    o, d = _rays(2000, 9.0, 1)
    peel = _peeled(o)
    j, t = _both(scenes, o, d)
    assert peel.sum() > 100
    assert (j["tri"][peel] >= 2).all() and (t["tri"][peel] >= 2).all()
    np.testing.assert_allclose(j["t"][peel], BACK_Z - FRONT_Z
                               - jpt.RAY_OFFSET, rtol=0, atol=1e-4)
    np.testing.assert_allclose(t["t"][peel], BACK_Z, rtol=0, atol=1e-4)
    hit_z = o[peel, 2] + t["t"][peel] * d[peel, 2]
    np.testing.assert_allclose(hit_z, BACK_Z, rtol=0, atol=1e-4)


def test_every_transparent_hit_is_retraced(scenes):
    """Divergence 2: 800 of 1024 rays meet a transparent cell, more than
    JAX's two peels re-trace at a capacity of a quarter of the batch
    (2 x 256); JAX's overflow ends as misses, the port finds the back quad
    behind every transparent cell."""
    o, d = _rays(8192, 3.9, 2)
    peel = _peeled(o)
    pick = np.concatenate([np.flatnonzero(peel)[:800],
                           np.flatnonzero(~peel)[:224]])
    o, d, peel = o[pick], d[pick], peel[pick]
    j, t = _both(scenes, o, d)
    assert (t["tri"][peel] >= 2).all()
    assert (t["tri"][~peel] < 2).all() and (t["tri"][~peel] >= 0).all()
    lost = peel & (j["tri"] < 0)
    assert lost.sum() == 800 - 2 * (1024 >> 2)
