"""The rules K15's map role and K12's accumulate role rest on, on the CPU.

K15 taps the sun map inside its launch only where the tap can change the
sun term: at a covered pixel with n.l > 0 and, under the checkerboard, at
the fetching pixel of a pair whose own pixels, or whose neighbour's
filling pixel, need it (csrc/shading.cu). test (a) holds the twin
(shading.sun_term_plain) to that rule: world positions that no lit pixel
needs are replaced by NaN and far points, and the term stays the same bit
for bit. K12 writes hdr + background (csrc/skylight.cu); test (b) holds
skylight.environment_background(..., hdr=h) on the CPU to h plus the JAX
package's background. No JAX frame is compiled: the JAX calls are the
background and a small envmap cube's build."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incarnation_tpu.kernels import ibl as jibl
from incarnation_tpu.kernels import sky as jsky
from incarnation_tpu.kernels import skylight as jsl
from incarnation_tpu_torch.kernels import build
from incarnation_tpu_torch.kernels import ibl as tibl
from incarnation_tpu_torch.kernels import shading as tsh
from incarnation_tpu_torch.kernels import skylight as tsl
from test_torch_kernels_cuda import (background_inputs, sun_term_call,
                                     sun_term_inputs)

torch.set_num_threads(1)

H, W = 16, 24


def needed_taps(mask, n, sun, parity, row0):
    """(H, W) bool: the pixels whose world position K15's map role taps.
    A lit pixel (covered, n.l > 0, the twin's dot3 and clamp) needs its
    own tap without the checkerboard. Under it, in pair i of a row, the
    fetching pixel is lane (row0 + y + parity) & 1, and a lit filling
    pixel takes the fill of tap_i and tap_j (j = i + 1 where lane 0
    fetches, i - 1 where lane 1 does, tap_i alone past the row's ends):
    pair i's fetching pixel is tapped when pair i holds a lit pixel or the
    pair whose fill reads it has a lit filling pixel."""
    no_l = np.clip((n[..., 0] * sun[0] + n[..., 1] * sun[1])
                   + n[..., 2] * sun[2], 0.0, 1.0)
    lit = mask & (no_l > 0.0)
    if parity is None:
        return lit
    h, w = lit.shape
    need = np.zeros_like(lit)
    for y in range(h):
        rp = (row0 + y + parity) & 1
        lit_f, lit_n = lit[y, rp::2], lit[y, 1 - rp::2]
        reader = np.zeros_like(lit_n)
        if rp == 0:
            reader[1:] = lit_n[:-1]
        else:
            reader[:-1] = lit_n[1:]
        need[y, rp::2] = lit_f | lit_n | reader
    return need


def _inputs(seed, extras):
    """sun_term_inputs at 16x24 with NaNs, about half the normals turned
    away from the sun (more pixels unlit)."""
    inp = sun_term_inputs(H, W, seed=seed, extras=extras)
    flip = np.random.default_rng(seed + 5).random((H, W)) < 0.5
    inp["n"][flip] *= -1.0
    return inp


@pytest.mark.parametrize("checker", [False, True],
                         ids=["exact_dither", "checker"])
def test_unneeded_taps_do_not_change_the_sun_term(checker):
    """sun_term_plain with a map: every role (exact and dither; checker
    and dither_checker at both parities), whole frames and a band's odd
    row0, with and without extras. Replacing world_pos at every pixel the
    rule does not tap by NaN and far points leaves the term the same bit
    for bit; replacing the tapped ones as well changes it."""
    roles = ({"map_checker0": (None, 0), "map_checker1": (None, 1),
              "map_dither_checker0": (10, 0), "map_dither_checker1": (9, 1)}
             if checker else {"map_exact": (None, None),
                              "map_dither": (9, None)})
    r = np.random.default_rng(7)
    for k, (role, (dither, parity)) in enumerate(roles.items()):
        for extras in (False, True):
            for row0 in (0, 7):
                inp = _inputs(k * 4 + extras * 2 + row0, extras)
                base = "map_dither_checker" if checker else "map_exact"
                a, kw = sun_term_call(inp, base, "cpu", row0=row0)
                kw.update(dither=dither, checker_parity=parity)
                ref = tsh.sun_term_plain(*a, **kw)
                need = needed_taps(inp["mask"], inp["n"], inp["sun_dir"],
                                   parity, row0)
                assert 0 < need.sum() < need.size
                junk = np.where(r.random((H, W, 1)) < 0.5, np.nan,
                                r.choice([1e30, -1e30, 3e4], (H, W, 3)))
                for which, where in (("unneeded", ~need),
                                     ("every", np.ones_like(need))):
                    wp = np.where(where[..., None], junk, inp["world_pos"])
                    a2, kw2 = sun_term_call(dict(inp, world_pos=np.float32(
                        wp)), base, "cpu", row0=row0)
                    kw2.update(dither=dither, checker_parity=parity)
                    got = tsh.sun_term_plain(*a2, **kw2)
                    same = torch.equal(got.view(torch.int32),
                                       ref.view(torch.int32))
                    assert same == (which == "unneeded"), (role, which)


@pytest.fixture(scope="module")
def envmap_probes():
    """The sky's envmap cube in the JAX package (latlong_to_cubemap, quad
    packed as build_probe packs it) and the port's copy of it: all the
    background's envmap role reads of a probe."""
    from types import SimpleNamespace
    sun = np.float32([0.4, 0.6, 0.69])
    sun /= np.linalg.norm(sun)
    # jitted: one compile each instead of one per eager operator
    ll = jax.jit(jsky.sky_latlong, static_argnums=(1, 2, 3))(
        jnp.asarray(sun), 2.0, 32, 16)
    cube = jax.jit(jibl.latlong_to_cubemap, static_argnums=(1,))(
        ll, 8).with_packed()
    tcube = tibl.CubeMips(
        flat=torch.tensor(np.asarray(cube.flat)), size=int(cube.size),
        num_levels=int(cube.num_levels),
        bases=tuple(int(b) for b in cube.bases), packed=True)
    return SimpleNamespace(envmap=cube), SimpleNamespace(envmap=tcube)


@pytest.mark.parametrize("dynamic", [True, False], ids=["dynamic", "envmap"])
def test_background_into_hdr_matches_jax(dynamic, envmap_probes):
    """environment_background(..., hdr=h) on the CPU equals h + JAX's
    environment_background at test_sky_background_matches_jax's tolerance
    (1e-5 relative, 1e-4 absolute), for the dynamic sky and the envmap
    role; h is left as it was; a -0.0 at a covered pixel comes back
    +0.0."""
    w, h = 64, 40
    inp = background_inputs(0.5, seed=4, width=w, height=h)
    mask = inp["mask"]
    hdr = np.random.default_rng(2).uniform(0.0, 2.0, (h, w, 3)).astype(
        np.float32)
    ys, xs = np.nonzero(mask)
    hdr[ys[:5], xs[:5], 1] = -0.0
    jp, tp = envmap_probes
    # JAX's background jitted (one compile), the probe a constant of it
    j = np.asarray(jax.jit(lambda m, e, ivp, s: jsl.environment_background(
        m, e, ivp, w, h, probe=jp, sun_dir=s, sky_brightness=2.0,
        dynamic_sky=dynamic))(*(jnp.asarray(inp[k]) for k in (
            "mask", "eye", "inv_view_proj", "sun_dir"))))
    th = torch.as_tensor(hdr.copy())
    t = tsl.environment_background(
        *(torch.as_tensor(inp[k]) for k in ("mask", "eye", "inv_view_proj")),
        w, h, probe=tp, sun_dir=torch.as_tensor(inp["sun_dir"]),
        sky_brightness=2.0, dynamic_sky=dynamic, hdr=th).numpy()
    np.testing.assert_allclose(t, hdr + j, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(th.numpy().view(np.int32),
                                  hdr.view(np.int32))
    assert not np.signbit(t[ys[:5], xs[:5], 1]).any()
    assert (t[~mask] > hdr[~mask]).all() and (t[mask] == hdr[mask]).all()


def test_build_hash_covers_included_headers(tmp_path, monkeypatch):
    """A library's name hashes its source and every csrc header it
    includes: editing csrc/k14_tap.cuh renames (so rebuilds) the shadow
    and shading libraries, and no other."""
    src = tmp_path / "csrc"
    src.mkdir()
    for path in build.CSRC.iterdir():
        (src / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(build, "CSRC", src)
    for name in ("shadow", "shading"):
        assert [p.name for p in build.sources(name)] == [f"{name}.cu",
                                                         "k14_tap.cuh"]
    before = {n: build._target(n).name for n in build.SOURCES}
    with open(src / "k14_tap.cuh", "a") as f:
        f.write("// edited\n")
    after = {n: build._target(n).name for n in build.SOURCES}
    assert {n for n in build.SOURCES if before[n] != after[n]} == {
        "shadow", "shading"}
