"""masked_peel, K6's peel step on the CPU (its twin), against the JAX
package's peel loop (incarnation_tpu/renderer/frame.py:255-271: masked_alpha,
chunk_overflow and the accumulate), peel by peel, on the same seeded
layers: 3 peels of tests/test_torch_kernels_cuda.py material_inputs at
128x256 (256 chunks of 128 pixels, about half of them empty, coverage
falling from peel to peel), over a block-encoded material stack with MASK
and BLEND materials. The chunk capacity follows the frame's ladder from a
first capacity of CAP chunks, below, at and above the first peel's chunks
with a hit (the layers hold CAP + 9, CAP and CAP - 7 of them), so that
every case runs the same capacities and JAX compiles each eager operation
at their shapes once. The
accumulated triangles, the continuing pixels and both overflow counts must
be JAX's exactly; so are the depths and interp channels the accumulate
copies and the z_limit, since every pass/fail decision is JAX's (alpha
within 1e-6, as test_torch_resolve.py's test_masked_alpha_matches_jax
holds it, and the threshold bit for bit). JAX's functions run eagerly,
rounding each operation apart as the port does."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incarnation_tpu.kernels import resolve as jresolve
from incarnation_tpu.scene import textures as jtex
from incarnation_tpu.scene.testing import make_rich_scene
from incarnation_tpu_torch.kernels import resolve as tresolve
from incarnation_tpu_torch.scene import loader as tloader
from test_torch_kernels_cuda import assert_peel_in_place, material_inputs

torch.set_num_threads(1)

H, W = 128, 256
PEELS = 3
FRAME = 5
CAP = 128   # the first peel's chunk capacity, half the layer's chunks


@pytest.fixture(scope="module")
def mats():
    """(JAX scene, port scene) on material_inputs' stack and materials."""
    inp = material_inputs(seed=5, h=8, w=16)
    js = dataclasses.replace(
        make_rich_scene(), mat_stack=jtex.MaterialTextureStack(**{
            k: jnp.asarray(v) for k, v in inp["stack"].items()}),
        mat_params=jnp.asarray(inp["mat_params"]))
    ts = tloader.scene_from_arrays(*tloader.scene_arrays(js), "cpu")
    return js, ts


def peel_layers(seed, n_chunks=CAP, h=H, w=W):
    """PEELS (tri, depth, interp) numpy layers: material_inputs' random
    channels, n_chunks 128-pixel chunks chosen at random and the others
    empty, each pixel of the chosen ones covered with a probability that
    falls 2x a peel, and each of them with a hit in the first peel; the
    triangle ids distinct per peel."""
    r = np.random.default_rng(seed)
    n = (h * w) // 128
    chunk_on = np.zeros(n, bool)
    chunk_on[r.choice(n, n_chunks, replace=False)] = True
    first = np.flatnonzero(chunk_on) * 128 + r.integers(0, 128, n_chunks)
    layers = []
    for k in range(PEELS):
        inp = material_inputs(seed=seed * 10 + k, h=h, w=w)
        on = (r.random((h, w)) < 0.8 / 2 ** k) & np.repeat(
            chunk_on, 128).reshape(h, w)
        if k == 0:
            on.reshape(-1)[first] = True
        tri = np.where(on, r.integers(0, 1000, (h, w)) + 1000 * k, -1)
        layers.append((tri.astype(np.int32), inp["depth"], inp["interp"]))
    return layers


def ladder(cap, layer):
    """renderer/frame.py's peel capacity of a peel (JAX frame.py:252-254)."""
    return (cap if layer == 0 else (2 * cap) // 3 if layer == 1
            else max((5 * cap) >> (layer + 2), 512))


def jax_accumulate(layer, acc, alpha, thresh):
    """The accumulate of one peel of JAX's render_frame (frame.py:263-271)
    given its alpha test: -> (acc_tri, acc_depth, acc_interp, cont,
    z_limit)."""
    tri, depth, interp = (jnp.asarray(x) for x in layer)
    acc_tri, acc_depth, acc_interp = acc
    hit = tri >= 0
    passed = hit & (alpha >= thresh)
    newly = passed & (acc_tri < 0)
    acc_tri = jnp.where(newly, tri, acc_tri)
    acc_depth = jnp.where(newly, depth, acc_depth)
    acc_interp = jnp.where(newly[None], interp, acc_interp)
    cont = hit & ~passed & (acc_tri < 0)
    return (acc_tri, acc_depth, acc_interp, cont,
            jnp.where(cont, depth, 0.0))


STOCH = {"exact": {}, "jitter": dict(mip_dither=FRAME, uv_dither=True),
         "dither": dict(mip_dither=FRAME)}
# (role, first capacity: None, or CAP where the first peel's chunks with a
# hit are CAP minus this many, row0)
CASES = [("exact", None, 0), ("jitter", -9, 0), ("jitter", 0, 0),
         ("jitter", 7, 0), ("dither", None, 0), ("jitter", None, 48),
         ("exact", None, 48)]


@pytest.mark.parametrize("role,extra,row0", CASES,
                         ids=[f"{r}-cap{e}-row0_{z}" for r, e, z in CASES])
def test_masked_peel_matches_jax(mats, role, extra, row0):
    """Peel by peel, the port's accumulators, continuing pixels, z_limit
    and overflow counts against JAX's: its masked_alpha (the port's alpha
    and threshold checked against it first), chunk_overflow and the
    accumulate. With row0 > 0 the port peels the band of rows row0.. of
    the layers, its noise hashed from whole-frame rows, and JAX's
    reference is its whole layers' peel restricted to those rows."""
    js, ts = mats
    stoch = STOCH[role]
    layers = peel_layers(seed=100 + 10 * len(role) + (extra or 0) + row0,
                         n_chunks=CAP - (extra or 0))
    first_hits = int((layers[0][0].reshape(-1, 128) >= 0).any(1).sum())
    assert first_hits == CAP - (extra or 0)
    cap0 = None if extra is None else CAP
    band = [(t[row0:], d[row0:], i[:, row0:]) for t, d, i in layers]
    h = H - row0
    acc = (jnp.full((h, W), -1, jnp.int32), jnp.zeros((h, W), jnp.float32),
           jnp.zeros((16, h, W), jnp.float32))

    def z(x):
        return torch.as_tensor(np.array(x))
    state = tresolve.peel_state(*(z(x) for x in band[0]))
    chunk_over, overs = 0, []
    for k in range(PEELS):
        cap = None if cap0 is None else ladder(cap0, k)
        tri, _, interp = layers[k]
        ja, jt = jresolve.masked_alpha(js, jnp.asarray(tri),
                                       jnp.asarray(interp),
                                       coverage_capacity=cap, **stoch)
        ja, jt = np.asarray(ja)[row0:], np.asarray(jt)[row0:]
        ta, tt = tresolve.masked_alpha(ts, *(z(band[k][j]) for j in (0, 2)),
                                       row0, coverage_capacity=cap, **stoch)
        np.testing.assert_allclose(ta.numpy(), ja, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(tt.numpy(), jt)
        hit = band[k][0] >= 0
        np.testing.assert_array_equal((ta >= tt).numpy()[hit],
                                      (ja >= jt)[hit])
        over = (int(jresolve.chunk_overflow(jnp.asarray(tri) >= 0, cap))
                if cap is not None else 0)
        *acc, cont, zlim = jax_accumulate(band[k], acc, jnp.asarray(ja),
                                          jnp.asarray(jt))
        state = tresolve.masked_peel(ts, *(z(x) for x in band[k]), state,
                                     row0, coverage_capacity=cap, **stoch)
        chunk_over = max(chunk_over, over)
        for got, want in ((state.tri, acc[0]), (state.depth, acc[1]),
                          (state.interp, acc[2]), (state.z_limit, zlim)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert int(state.overflow) == int(np.asarray(cont).sum())
        assert int(state.chunk_overflow) == chunk_over
        overs.append(over)
    # every peel hits, and some fragments fail and continue
    assert int((state.tri >= 0).sum()) > 0 and int(state.overflow) > 0
    if cap0 is not None:
        assert overs[0] == max(-extra, 0)


def test_masked_peel_updates_state_in_place():
    """On CPU tensors masked_peel, through its twin, keeps K6's contract
    (tests/test_torch_kernels_cuda.py test_k6_peel_step_updates_state_in_
    place): it writes its results into the state it is given and returns
    that state."""
    assert_peel_in_place(torch.device("cpu"))
