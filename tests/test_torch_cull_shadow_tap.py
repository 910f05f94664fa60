"""The frustum cull and the sun shadow-map tap against the JAX package on
the CPU: K13's twin (cull.cull_primitives on CPU tensors, and cull_lists
for the frame's two lists against two JAX calls) mask bit for mask bit
and count for count, K14's twin (shadow.sun_visibility on CPU tensors)
in each of its roles at the JAX comparison's rule, on the inputs the card
tests give K13 and K14 (tests/test_torch_kernels_cuda.py cull_inputs,
sun_tap_inputs). No atrium and no JAX frame: eager JAX functions at small
sizes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incarnation_tpu.kernels import cull as jcull
from incarnation_tpu.kernels import shadow as jshadow
from incarnation_tpu_torch.kernels import checker as tchecker
from incarnation_tpu_torch.kernels import cull as tcull
from incarnation_tpu_torch.kernels import shadow as tshadow
from test_torch_kernels_cuda import K14_ROLES, cull_inputs, sun_tap_inputs

torch.set_num_threads(1)

STEP = 1.0 / 65535.0       # the JAX map's u16 quantisation step
SIDE = 64
H = 24

_CULL_KEYS = ("bsphere", "mesh", "mesh_transforms", "mesh_visible",
              "scene_rotation", "view_proj")


@pytest.mark.parametrize("view", ["camera", "sun"])
@pytest.mark.parametrize("n", [64, 3434])
def test_cull_twin_matches_jax_exactly(n, view):
    """The atrium's primitive and meshlet counts under a rotated
    scene_rotation, the camera's infinite reverse-Z frustum and the sun's
    finite box: every mask bit and the culled count equal JAX's. A sphere
    grazes each finite plane from inside and from outside by 1% of its
    radius; zero radii, wrapped mesh ids and a hidden mesh are among
    them."""
    inp = cull_inputs(n, seed=n + 1, view=view)
    ji, jc = jcull.cull_primitives(*(jnp.asarray(inp[k]) for k in _CULL_KEYS))
    ti, tc = tcull.cull_primitives(*(torch.as_tensor(inp[k])
                                     for k in _CULL_KEYS))
    assert ti.dtype == torch.bool and tc.dtype == torch.int64
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert int(tc) == int(jc)
    t, g = ti.numpy(), inp["graze"]
    assert t[g == 1].all() and not t[g == -1].any()
    assert (g == -1).sum() == (5 if view == "camera" else 6)
    mesh = inp["mesh"] % 3
    assert not t[mesh == 2].any() and (inp["mesh"] < 0).any()
    assert (inp["bsphere"][:, 3] == 0).any()
    assert 0 < int(tc) < n


@pytest.mark.parametrize("view", ["camera", "sun"])
def test_cull_lists_matches_two_jax_culls_exactly(view):
    """The frame's two lists in one cull_lists call (the atrium's 64
    primitives and 3,434 meshlets, over one mesh table), and a list of one
    (the frame without meshlets): each mask bit and each culled count equal
    a JAX cull_primitives call on that list."""
    prims = cull_inputs(64, seed=11, view=view)
    mesh = cull_inputs(3434, seed=12, view=view)
    shared = {k: prims[k] for k in _CULL_KEYS[2:]}
    # the meshlets' spheres put into the primitives' mesh table
    lists = [prims, dict(mesh, **shared)]
    got = tcull.cull_lists(
        [(torch.as_tensor(x["bsphere"]), torch.as_tensor(x["mesh"]))
         for x in lists],
        *(torch.as_tensor(shared[k]) for k in _CULL_KEYS[2:]))
    assert len(got) == 2
    for (ti, tc), x in zip(got, lists):
        ji, jc = jcull.cull_primitives(*(jnp.asarray(x[k])
                                         for k in _CULL_KEYS))
        assert ti.dtype == torch.bool and tc.dtype == torch.int64
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        assert int(tc) == int(jc) and 0 < int(tc) < x["mesh"].shape[0]
    (one, count), = tcull.cull_lists(
        [(torch.as_tensor(prims["bsphere"]), torch.as_tensor(prims["mesh"]))],
        *(torch.as_tensor(shared[k]) for k in _CULL_KEYS[2:]))
    assert torch.equal(one, got[0][0]) and int(count) == int(got[0][1])


def _tap_inputs(w, seed=0):
    return sun_tap_inputs(H, w, seed=seed, side=SIDE)


def _port(inp, role, row0=0, rows=slice(None)):
    dither, parity = K14_ROLES[role]
    return tshadow.sun_visibility(
        torch.as_tensor(inp["world_pos"][rows]),
        torch.as_tensor(inp["n_dot_l"][rows]), torch.as_tensor(inp["depth"]),
        torch.as_tensor(inp["sun_vp"]), SIDE, dither=dither,
        checker_parity=parity, row0=row0).numpy()


def _near_threshold(inp, role):
    """(H, W) bool: pixels whose value takes a tap whose depth compare is
    within one u16 step of its threshold (the port's tap; with the
    checkerboard, a filled pixel takes its two neighbours' taps)."""
    dither, parity = K14_ROLES[role]
    wp, ndl = torch.as_tensor(inp["world_pos"]), torch.as_tensor(
        inp["n_dot_l"])
    if parity is not None:
        wp, ndl = tchecker.compact(parity, wp), tchecker.compact(parity, ndl)
    sz, _, lin = tshadow.sun_map_tap(wp, torch.as_tensor(inp["sun_vp"]),
                                     SIDE, dither)
    bias = (1.5 + 2.0 * (1.0 - torch.clamp(ndl, 0.0, 1.0))) * (2.0 / SIDE)
    d = torch.as_tensor(inp["depth"]).reshape(-1)[lin]
    near = ((d - (sz + bias)).abs() <= STEP + 1e-6).float()
    if parity is not None:
        near = tchecker.expand(parity, near)
    return near.numpy() > 0


@pytest.mark.parametrize("w", [40, 39], ids=["even", "odd"])
@pytest.mark.parametrize("role", list(K14_ROLES))
def test_sun_tap_twin_matches_jax(role, w):
    """Each role of K14's twin against JAX's sun_visibility on its packed
    u16 map of the same depths, at an even and an odd width (the
    checkerboard raises at the odd one, in both packages): the answers may
    differ only where a tap's depth compare is within one u16 step of its
    threshold, and on under 0.5% of the pixels."""
    inp = _tap_inputs(w, seed=w)
    dither, parity = K14_ROLES[role]
    if parity is not None and w % 2:
        with pytest.raises(ValueError, match="even width"):
            _port(inp, role)
        return
    j = np.asarray(jshadow.sun_visibility(
        jnp.asarray(inp["world_pos"]), jnp.asarray(inp["n_dot_l"]),
        jshadow.pack_depth_u16(jnp.asarray(inp["depth"])),
        jnp.asarray(inp["sun_vp"]), SIDE, dither=dither,
        checker_parity=parity))
    t = _port(inp, role)
    assert t.shape == j.shape == (H, w) and t.dtype == np.float32
    assert 0.05 < (t == 0).mean() < 0.95
    if parity is not None:
        assert ((t > 0) & (t < 1)).any()          # tents of a lit and a dark
    differ = t != j
    assert differ.mean() < 5e-3
    assert not (differ & ~_near_threshold(inp, role)).any()


@pytest.mark.parametrize("role", ["dither_checker0", "dither_checker1",
                                  "dither", "checker0"])
def test_sun_tap_band_rows_match_whole(role):
    """A band's rows (row0 7, odd, and 12) equal the same rows of the
    whole-frame call: the checkerboard's lanes and the noise take
    whole-frame rows."""
    inp = _tap_inputs(40, seed=3)
    whole = _port(inp, role)
    for r0, r1 in ((7, 19), (12, H)):
        band = _port(inp, role, row0=r0, rows=slice(r0, r1))
        np.testing.assert_array_equal(band, whole[r0:r1])
