"""resolve_gbuffer and masked_alpha, the twins of K5 and K6 on the CPU,
against the JAX package's exact paths (kernels/resolve.py:242-376 and
:107-181), on one random layer (tests/test_torch_kernels_cuda.py
material_inputs) over two material sets: make_rich_scene's and a
block-encoded stack with mip chains, every address mode and a material
without extras blocks; and resolve_gbuffer on the edge layers K5 is held
to its twin on (edge_inputs). The JAX functions are jitted (one compile
each per material set and shape)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incarnation_tpu.kernels import resolve as jresolve
from incarnation_tpu.scene import textures as jtex
from incarnation_tpu.scene.testing import make_rich_scene
from incarnation_tpu_torch.kernels import resolve as tresolve
from incarnation_tpu_torch.scene import loader as tloader
from test_torch_kernels_cuda import (EDGE_CASES, edge_inputs,
                                     material_inputs, material_scene)

torch.set_num_threads(1)

H, W = 24, 40
EDGE_H, EDGE_W = 23, 37     # not multiples of K5's 32x8 tile
# the same f32 operations in both packages but for the library functions
# each calls (pow, log2, sqrt, the 4x4 product): a few ulps of each value
RTOL = 1e-5
GB_FIELDS = ("base_color", "normals", "mrao", "emissive", "world_pos", "uv",
             "extras")


@pytest.fixture(scope="module", params=["rich", "mips"])
def both(request):
    """(JAX scene, port scene, the layer's numpy inputs) for one material
    set; the layer's material ids lie in the set."""
    js = make_rich_scene()
    inputs = material_inputs(seed=5, h=H, w=W)
    if request.param == "mips":
        js = dataclasses.replace(
            js, mat_stack=jtex.MaterialTextureStack(**{
                k: jnp.asarray(v) for k, v in inputs["stack"].items()}),
            mat_params=jnp.asarray(inputs["mat_params"]))
    nm = js.mat_params.shape[0]
    inputs["interp"][9] = np.mod(inputs["interp"][9], nm)
    ts = tloader.scene_from_arrays(*tloader.scene_arrays(js), "cpu")
    return js, ts, inputs


def _assert_close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=1e-6 * max(np.abs(want).max(), 1.0),
                               err_msg=what)


def test_resolve_gbuffer_matches_jax(both):
    """Every GBuffer plane and the unencoded mapped normal to RTOL
    relative + 1e-6 of the plane's peak, the mask exactly, zeros off
    it."""
    js, ts, inp = both
    j = jax.jit(lambda t, d, i, m: jresolve.resolve_gbuffer(
        t, d, js, i, m, W, H, return_normal3=True))(
        *(jnp.asarray(inp[k]) for k in ("tri", "depth", "interp",
                                         "inv_view_proj")))
    _, tri, depth, interp, ivp = material_scene(inp, "cpu")
    t = tresolve.resolve_gbuffer(tri, depth, ts, interp, ivp, W, H,
                                 return_normal3=True)
    np.testing.assert_array_equal(t[0].mask.numpy(), np.asarray(j[0].mask))
    assert 0.5 < float(t[0].mask.float().mean()) < 1.0
    for f in GB_FIELDS:
        _assert_close(getattr(t[0], f).numpy(), np.asarray(getattr(j[0], f)),
                      f)
    _assert_close(t[1].numpy(), np.asarray(j[1]), "normal3")
    off = ~t[0].mask.numpy()
    assert not t[0].base_color.numpy()[off].any()
    assert float(t[0].normals.numpy()[~off].std()) > 0.1


def test_masked_alpha_matches_jax(both):
    """Alpha to 1e-6 and the same pass/fail decision (alpha >= thresh) on
    every pixel but those within 1e-6 of their threshold; the BLEND
    threshold of a band (row0 > 0) hashes whole-frame rows, so it equals
    the single layer's rows further down."""
    js, ts, inp = both
    _, tri, _, interp, _ = material_scene(inp, "cpu")
    ja, jt = jax.jit(lambda t, i: jresolve.masked_alpha(js, t, i))(
        jnp.asarray(inp["tri"]), jnp.asarray(inp["interp"]))
    ta, tt = tresolve.masked_alpha(ts, tri, interp)
    ja, jt = np.asarray(ja), np.asarray(jt)
    np.testing.assert_allclose(ta.numpy(), ja, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tt.numpy(), jt)
    near = np.abs(ja - jt) <= 1e-6
    assert near.mean() < 0.01
    np.testing.assert_array_equal((ta >= tt).numpy()[~near],
                                  (ja >= jt)[~near])
    assert 0.05 < (ja >= jt).mean() < 0.95
    _, tb = tresolve.masked_alpha(ts, tri[8:], interp[:, 8:], row0=8)
    np.testing.assert_array_equal(tb.numpy(), tt[8:].numpy())


@pytest.fixture(scope="module")
def edge_jax():
    """(port scene, jitted JAX resolve_gbuffer with the mapped normal) on
    edge_inputs' material stack, which every case shares."""
    inp = edge_inputs("mixed", EDGE_H, EDGE_W)
    js = dataclasses.replace(
        make_rich_scene(), mat_stack=jtex.MaterialTextureStack(**{
            k: jnp.asarray(v) for k, v in inp["stack"].items()}),
        mat_params=jnp.asarray(inp["mat_params"]))
    ts = tloader.scene_from_arrays(*tloader.scene_arrays(js), "cpu")
    return ts, jax.jit(lambda t, d, i, m: jresolve.resolve_gbuffer(
        t, d, js, i, m, EDGE_W, EDGE_H, return_normal3=True))


@pytest.mark.parametrize("case", EDGE_CASES)
def test_resolve_edge_cases_match_jax(edge_jax, case):
    """The twin K5 is held to equals JAX's exact path on the layers that
    K5's tiles, block reuse and skipped level make hard: as
    test_resolve_gbuffer_matches_jax, every plane and the mapped normal,
    the mask exactly, zeros off it, uv everywhere."""
    ts, jfn = edge_jax
    inp = edge_inputs(case, EDGE_H, EDGE_W)
    np.testing.assert_array_equal(ts.mat_stack.flat.numpy(),
                                  inp["stack"]["flat"])
    j = jfn(*(jnp.asarray(inp[k]) for k in ("tri", "depth", "interp",
                                             "inv_view_proj")))
    _, tri, depth, interp, ivp = material_scene(inp, "cpu")
    t = tresolve.resolve_gbuffer(tri, depth, ts, interp, ivp, EDGE_W,
                                 EDGE_H, return_normal3=True)
    np.testing.assert_array_equal(t[0].mask.numpy(), np.asarray(j[0].mask))
    assert bool(t[0].mask.any()) == (case != "empty")
    for f in GB_FIELDS:
        _assert_close(getattr(t[0], f).numpy(), np.asarray(getattr(j[0], f)),
                      f)
    # XLA on the CPU contracts the bilinear sums into fused multiply-adds,
    # so the stack channels differ by a few ulps; the mapped normal's
    # combination of the (not orthogonal) random TBN frame, then its
    # normalisation, carries that to about 5e-6 of its unit length here
    np.testing.assert_allclose(t[1].numpy(), np.asarray(j[1]), rtol=RTOL,
                               atol=1e-5, err_msg="normal3")
    off = ~t[0].mask.numpy()
    for f in GB_FIELDS:
        if f != "uv":
            assert not getattr(t[0], f).numpy()[off].any(), f
    np.testing.assert_array_equal(t[0].uv.numpy(),
                                  np.moveaxis(inp["interp"][0:2], 0, -1))
