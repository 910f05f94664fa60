"""decal_step, K5's decal step on the CPU (its twin, decal_step_plain),
against the JAX package's decal pass (incarnation_tpu/renderer/frame.py:
325-359: resolve_gbuffer of the decal layer under its chunk capacity,
chunk_overflow and the composite into the GBuffer, restated here in
jnp), on the same seeded layers: tests/test_torch_kernels_cuda.py
material_inputs' channels at 128x256 (256 chunks of 128 pixels), a decal
layer over a chosen number of chunks, a scene depth that some decal pixels
fail, and a random GBuffer and mapped normal to composite into. The decal
overflow and the set of pixels whose normals and mrao the decal replaces
must be JAX's exactly; the base colour, normals, mrao and n3 within
test_torch_resolve.py's tolerance (the same f32 operations but for the
library functions each package calls). JAX's functions run eagerly,
rounding each operation apart as the port does."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incarnation_tpu.core import mathutils as jmu
from incarnation_tpu.kernels import resolve as jresolve
from incarnation_tpu.scene import textures as jtex
from incarnation_tpu.scene.testing import make_rich_scene
from incarnation_tpu_torch.kernels import resolve as tresolve
from incarnation_tpu_torch.scene import loader as tloader
from test_torch_kernels_cuda import decal_inputs, material_inputs

torch.set_num_threads(1)

H, W = 128, 256
FRAME = 5
CAP = 96      # the chunk capacity of the cases that take one
RTOL = 1e-5   # test_torch_resolve.py's


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


def jax_decal_pass(js, inp, cap, n3, **stoch):
    """JAX's decal pass (frame.py:325-359) on the whole layer -> (overflow,
    base_color, normals, mrao, n3 or None, opaque)."""
    d_tri, d_depth, d_interp, depth = (jnp.asarray(inp[k]) for k in (
        "d_tri", "d_depth", "d_interp", "depth"))
    d_gb = jresolve.resolve_gbuffer(d_tri, d_depth, js, d_interp,
                                    jnp.asarray(inp["inv_view_proj"]), W, H,
                                    coverage_capacity=cap, **stoch)
    over = (jresolve.chunk_overflow(d_tri >= 0, cap) if cap is not None
            else jnp.zeros((), jnp.int32))
    gb_base, gb_n, gb_mrao = (jnp.asarray(inp[k]) for k in (
        "base_color", "normals", "mrao"))
    covers = d_gb.mask & (d_depth >= depth - 1e-5)
    a = jnp.where(covers, d_gb.base_color[..., 3], 0.0)[..., None]
    opaque = a > 0.5
    base = jnp.concatenate([gb_base[..., :3] * (1 - a)
                            + d_gb.base_color[..., :3] * a,
                            gb_base[..., 3:]], -1)
    normals = jnp.where(opaque, d_gb.normals, gb_n)
    mrao = jnp.where(opaque, d_gb.mrao, gb_mrao)
    out3 = (jnp.where(opaque, jmu.oct_decode(d_gb.normals),
                      jnp.asarray(inp["n3"])) if n3 else None)
    return (int(over), *(np.asarray(x) for x in (base, normals, mrao)),
            None if out3 is None else np.asarray(out3),
            np.asarray(opaque[..., 0]))


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=1e-6 * max(np.abs(want).max(), 1.0),
                               err_msg=what)


STOCH = {"exact": {}, "jitter": dict(mip_dither=FRAME, uv_dither=True),
         "dither": dict(mip_dither=FRAME)}
# (role, the layer's chunks with a decal pixel minus CAP, or None: no
# capacity, the mapped normal given, row0)
CASES = [("exact", None, True, 0), ("jitter", 9, False, 0),
         ("jitter", 0, True, 0), ("jitter", -7, True, 0),
         ("dither", None, False, 0), ("jitter", None, True, 64),
         ("exact", 5, True, 64)]


@pytest.mark.parametrize("role,extra,n3,row0", CASES, ids=[
    f"{r}-cap{e}-{'n3' if n else 'no_n3'}-row0_{z}"
    for r, e, n, z in CASES])
def test_decal_step_matches_jax(mats, role, extra, n3, row0):
    """The port's decal step on the band of rows row0.. (its noise hashed
    from whole-frame rows) against JAX's decal pass on the whole layer,
    restricted to those rows; the decal layer is empty above row0 (so its
    chunk ranks are the whole layer's), and CAP + extra of its chunks hold
    a decal pixel. Every case has decal pixels that fail the depth test,
    opaque and translucent decal pixels, and, under a capacity that
    overflows, dropped chunks."""
    js, ts = mats
    stoch = STOCH[role]
    cap = None if extra is None else CAP
    inp = decal_inputs(seed=200 + 7 * len(role) + (extra or 0) + row0,
                       h=H, w=W, n_chunks=CAP + (extra or 0), row0=row0)
    over, base, normals, mrao, out3, opaque = jax_decal_pass(
        js, inp, cap, n3, **stoch)
    rows = slice(row0, None)

    def band(k):
        # a copy: the step updates the GBuffer and n3 in place
        x = inp[k]
        return torch.tensor(x[:, rows] if k == "d_interp" else x[rows])
    gb = tresolve.GBuffer(
        base_color=band("base_color"), normals=band("normals"),
        mrao=band("mrao"), emissive=None, mask=None, world_pos=None, uv=None,
        extras=None)
    t3 = band("n3") if n3 else None
    got = tresolve.decal_step(
        ts, band("d_tri"), band("d_depth"), band("d_interp"), band("depth"),
        gb, t3, torch.as_tensor(inp["inv_view_proj"]), W, H - row0,
        coverage_capacity=cap, row0=row0, **stoch)
    assert got.dtype == torch.int64 and got.shape == ()
    assert int(got) == over == (max(extra, 0) if cap is not None else 0)
    t_opaque = ((gb.normals.numpy() != inp["normals"][rows]).any(-1)
                | (gb.mrao.numpy() != inp["mrao"][rows]).any(-1))
    np.testing.assert_array_equal(t_opaque, opaque[rows])
    _close(gb.base_color.numpy(), base[rows], "base_color")
    _close(gb.normals.numpy(), normals[rows], "normals")
    _close(gb.mrao.numpy(), mrao[rows], "mrao")
    if n3:
        _close(t3.numpy(), out3[rows], "n3")
    # the layer's pixels: some fail the depth test, some decals are opaque
    # and some translucent, and what the decal does not cover is as it was
    cov = inp["d_tri"][rows] >= 0
    failed = cov & (inp["d_depth"][rows] < inp["depth"][rows] - 1e-5)
    assert failed.any() and (cov & ~failed).any()
    assert 0 < t_opaque.sum() < (cov & ~failed).sum()
    untouched = ~cov | failed
    assert np.array_equal(gb.base_color.numpy()[untouched],
                          inp["base_color"][rows][untouched])
