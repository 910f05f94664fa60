"""The sun's direct term and the TAA resolve against the JAX package on the
CPU: K15's twin (shading.sun_term_plain) against JAX's composition of the
sun term (renderer/frame.py:536-570: shading.directional_light_radiance,
shadow.sun_visibility, shading.brdf_response, the masked add) in each
visibility role, and K3's resolve role's twin (taa.taa_resolve_plain) on
the two bands of a band-sharded frame, with their halo rows, against JAX's
taa_resolve of the whole frame; and the packing of m by value that K3's
resolve takes. The inputs are the card tests'
(tests/test_torch_kernels_cuda.py sun_term_inputs, taa_inputs). No JAX
frame: eager JAX functions at 48x32 and 64x48."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incarnation_tpu.kernels import resolve as jresolve
from incarnation_tpu.kernels import shading as jsh
from incarnation_tpu.kernels import shadow as jshadow
from incarnation_tpu.kernels import taa as jtaa
from incarnation_tpu_torch.dist import sharding
from incarnation_tpu_torch.kernels import shading as tsh
from incarnation_tpu_torch.kernels import taa as ttaa
from test_torch_kernels_cuda import (K15_ROLES, sun_term_call,
                                     sun_term_inputs, taa_inputs)

torch.set_num_threads(1)

H, W = 32, 48
SIDE = 64

# JAX's map tap and TAA resolve jitted, as its frame runs them: one compile
# each instead of one per eager operator (the inputs keep every discrete
# choice, a tap's compare or a texel's floor, away from its edge)
_jax_tap = jax.jit(jshadow.sun_visibility,
                   static_argnames=("resolution", "dither", "checker_parity"))
_jax_taa = jax.jit(jtaa.taa_resolve,
                   static_argnames=("width", "height", "dither"))


def _jax_sun_term(inp, role):
    """JAX's frame.py:536-570 on the same arrays: the radiance, the map's
    tap on its packed u16 map (n.l as jnp.sum(n * sun_dir)), a given
    visibility or 1, brdf_response with the extras (eager: every product
    rounded on its own, as torch rounds it), hdr plus the masked term."""
    src, dither, parity = K15_ROLES[role]
    j = {k: (None if v is None else jnp.asarray(v)) for k, v in inp.items()}
    radiance_in = jsh.directional_light_radiance(
        j["sun_color_intensity"][:3], j["sun_color_intensity"][3])
    sun_vis = 1.0
    if src == "map":
        ndl = jnp.sum(j["n"] * j["sun_dir"], -1)
        sun_vis = _jax_tap(
            j["world_pos"], ndl, jshadow.pack_depth_u16(j["shadow_map"]),
            j["sun_vp"], resolution=SIDE, dither=dither,
            checker_parity=parity)[..., None]
    elif src == "given":
        sun_vis = j["visibility"][..., None]
    x = j["extras"]
    sun = jsh.brdf_response(
        j["base_color"][..., :3], j["mrao"][..., 0], j["mrao"][..., 1],
        j["n"], j["v"], j["sun_dir"], radiance_in, visibility=sun_vis,
        transmission=None if x is None else x[..., 0],
        clearcoat=None if x is None else x[..., 1],
        cc_roughness=None if x is None else x[..., 2])
    return np.asarray(j["hdr"] + jnp.where(j["mask"][..., None], sun, 0.0))


@pytest.mark.parametrize("extras", [False, True], ids=["", "extras"])
@pytest.mark.parametrize("role", ["map_exact", "map_dither_checker",
                                  "given", "none"])
def test_sun_term_plain_matches_jax(role, extras):
    """sun_term_plain (and sun_term on CPU tensors) against JAX's sun term
    at 48x32 with NaNs among the inputs: the elementwise f32 formulas of
    both packages, 1e-5 relative and 1e-7 absolute (the tolerance of
    test_torch_lighting.py's test_brdf_and_punctual_light_match_jax). The
    map's blocks sit at depth 0 or 1, so no tap's compare is near its
    threshold and the visibilities agree exactly despite JAX's u16
    packing."""
    inp = sun_term_inputs(H, W, seed=11, side=SIDE, extras=extras)
    a, kw = sun_term_call(inp, role, "cpu")
    t = tsh.sun_term_plain(*a, **kw).numpy()
    np.testing.assert_array_equal(tsh.sun_term(*a, **kw).numpy(), t)
    j = _jax_sun_term(inp, role)
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-7)
    assert np.isnan(t).any()
    lit = np.abs(t - inp["hdr"]).sum(-1) > 0
    assert 0.2 < lit.mean() < 0.95


def _bands(inp, n=2):
    """taa_resolve_plain's arguments for each of n bands of the frame, as
    dist/sharding.py render_frame_sharded gives them: the band's rows, the
    history with the rest of the image's rows (or the edge row repeated)
    as halo rows above and below, the HDR rows next to the band, the band
    matrices (inv(J) @ inv_view_proj, prev_view_proj @ J) and the first
    row."""
    h, w = inp["depth"].shape
    hb = h // n
    t = lambda x: torch.as_tensor(np.ascontiguousarray(x))
    hist = [t(inp["history"][i * hb:(i + 1) * hb]) for i in range(n)]
    hdr = [t(inp["current_hdr"][i * hb:(i + 1) * hb]) for i in range(n)]
    out = []
    for i in range(n):
        j = sharding.band_projection(n, i)
        j_inv = np.eye(4, dtype=np.float32)
        j_inv[1, 1] = np.float32(1.0 / n)
        j_inv[3, 1] = -j[3, 1] / np.float32(n)
        ivp = j_inv @ inp["inv_view_proj"]
        pvp = inp["prev_view_proj"] @ j
        above, below = sharding._rows_halo(hist, i, h - hb, "cpu")
        out.append(dict(
            current_hdr=hdr[i], history=torch.cat([above, hist[i], below]),
            depth=t(inp["depth"][i * hb:(i + 1) * hb]), m_np=ivp @ pvp,
            history_valid=True, width=w, height=hb,
            hdr_halo=sharding._rows_halo(hdr, i, 1, "cpu"),
            dither=inp["dither"], inv_view_proj=t(ivp),
            prev_view_proj=t(pvp), row0=i * hb))
    return out


@pytest.mark.parametrize("role", ["given", "reproject"])
def test_taa_resolve_plain_band_halo_matches_jax(role):
    """The two bands of a 64x48 frame, each resolved by taa_resolve_plain
    with its history halo rows and its neighbour's HDR row above and below
    (the HDR's edge row past the image), stitched, against JAX's
    taa_resolve of the whole frame: the stochastic history fetch ("given",
    K3's prev_color role) and the reprojected bilinear one, 2e-3 absolute
    on HDR of magnitude ~4 (test_torch_taa.py's bound on the resolve). The
    rows next to the seam take the other band's rows through the halos;
    clamped at the band's edge instead they differ."""
    inp = taa_inputs(48, 64, seed=21, role=role, nan=False)
    j = np.asarray(_jax_taa(
        jnp.asarray(inp["current_hdr"]), jnp.asarray(inp["history"]),
        jnp.asarray(inp["depth"]), jnp.asarray(inp["inv_view_proj"]),
        jnp.asarray(inp["prev_view_proj"]), True, width=64, height=48,
        dither=inp["dither"]))
    bands = _bands(inp)
    t = np.concatenate([ttaa.taa_resolve_plain(**b).numpy() for b in bands])
    np.testing.assert_allclose(t, j, rtol=0, atol=2e-3)
    assert np.abs(t - inp["current_hdr"]).max() > 0.1
    b = bands[0]
    edge = dict(b, hdr_halo=(b["current_hdr"][:1], b["current_hdr"][-1:]))
    assert not np.allclose(ttaa.taa_resolve_plain(**edge).numpy()[-1],
                           j[23], rtol=0, atol=2e-3)


def test_k3_params_carry_m_and_the_shift_by_value():
    """K3's resolve takes m as the float32 bits of the host's m_np (what
    the twin's torch.as_tensor(m_np, float32) holds, from an f32 or an f64
    product), and the static shift as bilinear_const_shift forms it: its
    floors, its fractions and their complements as torch rounds
    1 - t."""
    r = np.random.default_rng(0)
    for m_np in (r.normal(size=(4, 4)).astype(np.float32),
                 r.normal(size=(4, 4)), r.normal(size=(4, 4)).T):
        p = ttaa.k3_params(m_np)
        bits = np.frombuffer(bytes(p.m), np.uint32)
        want = torch.as_tensor(m_np, dtype=torch.float32).reshape(-1)
        np.testing.assert_array_equal(bits, want.numpy().view(np.uint32))
        assert p.role == ttaa.K3_REPROJECT
    p = ttaa.k3_params(np.eye(4), (1.3, -2.7))
    assert (p.ix, p.iy, p.role) == (1, -3, ttaa.K3_SHIFT)
    assert (p.tx, p.ty) == ttaa.shift_parts(1.3, -2.7)[2:]
    one = torch.ones(1)
    assert p.rx == float(one * (1 - p.tx)) and \
        p.ry == float(one * (1 - p.ty))
    assert ttaa.k3_params(np.eye(4), given=True).role == ttaa.K3_GIVEN
