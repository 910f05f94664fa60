"""The stochastic estimators of the raster frame, the port's twins on the
CPU against the JAX package's functions (run eagerly: one f32 operation
at a time, as the twins run, so every texel, mip and lobe choice is the
same float decision in both): the per-pixel noise, the RGBE probe table,
the jittered stack and alpha fetches at any mip, masked_alpha and
resolve_gbuffer with the dithered mip, the jittered texel, the
anisotropic tap, the checkerboard and the chunk capacity, sky_lighting's
dithered RGBE probe fetch and stochastic clearcoat lobe, the jittered
shadow tap and the stochastic TAA history fetch. Frame-level tests are in
test_torch_stochastic_frame.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incarnation_tpu.core.view import View as JView
from incarnation_tpu.kernels import ibl as jibl
from incarnation_tpu.kernels import resolve as jresolve
from incarnation_tpu.kernels import shadow as jshadow
from incarnation_tpu.kernels import sky as jsky
from incarnation_tpu.kernels import skylight as jsl
from incarnation_tpu.kernels import taa as jtaa
from incarnation_tpu.scene import textures as jtex
from incarnation_tpu.scene.testing import make_rich_scene
from incarnation_tpu_torch.kernels import ibl as tibl
from incarnation_tpu_torch.kernels import resolve as tresolve
from incarnation_tpu_torch.kernels import shadow as tshadow
from incarnation_tpu_torch.kernels import skylight as tsl
from incarnation_tpu_torch.kernels import taa as ttaa
from incarnation_tpu_torch.scene import loader as tloader
from incarnation_tpu_torch.scene import textures as ttex
from test_torch_kernels_cuda import material_inputs, material_scene

torch.set_num_threads(1)

H, W = 24, 40
CH, CW = 32, 40          # 10 whole 128-pixel chunks, for the capacities
FRAME = 5                 # the frame index that seeds the noise
# the same f32 operations in both packages but for the library functions
# each calls (pow, log2, sqrt, the 4x4 product): a few ulps of each value
RTOL = 1e-5
GB_FIELDS = ("base_color", "normals", "mrao", "emissive", "world_pos", "uv",
             "extras")


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(got, want, what, rtol=RTOL):
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=1e-6 * max(np.abs(want).max(), 1.0),
                               err_msg=what)


@pytest.mark.parametrize("frame, mult", [
    (0, 2654435761), (1, 741103597), (5, 1181783497), (7, 3267000013),
    (123457, 2246822519), (2 ** 20 + 3, 3323198485)])
def test_frame_noise_matches_jax(frame, mult):
    """frame_noise equals _frame_noise (and shadow.py's _noise) bit for
    bit, frame_index * mult wrapped to 32 bits; a band from row0 hashes
    the whole frame's rows."""
    got = tresolve.frame_noise((H, W), frame, mult, "cpu").numpy()
    want = np.asarray(jresolve._frame_noise((H, W), frame, mult))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(jshadow._noise((H, W), frame, mult)))
    assert 0.0 <= got.min() and got.max() < 1.0 and got.std() > 0.2
    np.testing.assert_array_equal(
        tresolve.frame_noise((H - 7, W), frame, mult, "cpu", row0=7).numpy(),
        got[7:])


@pytest.fixture(scope="module")
def probes():
    """JAX's build_probe (with its RGBE table) and the same probe carried
    to the port."""
    sun = np.float32([0.4, 0.6, 0.69])
    sun /= np.linalg.norm(sun)
    jp = jibl.build_probe(jsky.sky_latlong(jnp.asarray(sun), 2.0, 32, 16),
                          envmap_size=16, num_samples=64)
    tp = tibl.probe_from_arrays(
        {"sh": np.asarray(jp.sh),
         **{f"{c}.{a}": np.asarray(getattr(getattr(jp, c), a))
            for c in ("envmap", "prefiltered")
            for a in ("flat", "size", "num_levels", "bases")},
         "envmap.packed": True, "prefiltered.packed": True}, "cpu")
    return jp, tp


def _rgbe_both(x):
    """(port words, JAX words) of x; the port decodes each word exactly
    (mantissa x 2^(e - 136), numpy's ldexp) and within 2e-6 of JAX's
    decode, whose exp2 of an integer is a few ulps off the power of two
    on XLA's CPU build (223 of the 256 exponents), and which flushes
    subnormal results to zero (atol: the least normal float)."""
    got = tibl.rgbe_encode(_t(x)).numpy().view(np.uint32)
    want = np.asarray(jibl.rgbe_encode(jnp.asarray(x)))
    dec = tibl.rgbe_decode(_t(got.view(np.int32))).numpy()
    mant = np.stack([(got >> s) & 0xFF for s in (0, 8, 16)], -1)
    exact = np.ldexp(mant.astype(np.float64),
                     ((got >> 24) & 0xFF).astype(int)[..., None] - 136)
    np.testing.assert_array_equal(dec, exact.astype(np.float32))
    np.testing.assert_allclose(
        dec, np.asarray(jibl.rgbe_decode(jnp.asarray(got))), rtol=2e-6,
        atol=np.finfo(np.float32).tiny)
    return got, want


def test_rgbe_matches_jax(probes):
    """rgbe_encode equals JAX's bit for bit on random colours over 2^-40
    to 2^40 (some channels 0), on zeros and sub-1e-32 maxima and on both
    probes' cube tables; rgbe_decode is exact (_rgbe_both). At powers of
    two and their float neighbours the exponent floor(log(m) / log(2)) +
    1 depends on an ulp of each library's logf (JAX's lands below the
    integer at many powers of two, and the port follows it there): all
    but 8 of those 180 words equal JAX's, and every decoded colour is
    within 1/128 of JAX's largest channel."""
    r = np.random.default_rng(1)
    rgb = (2.0 ** r.uniform(-40, 40, (4000, 3))).astype(np.float32)
    rgb[:200] *= r.random((200, 3)) < 0.5
    rgb[-3:] = [[0, 0, 0], [1e-33, 0, 0], [3e-35, 1e-36, 0]]
    jp, tp = probes
    for x in [rgb] + [np.asarray(getattr(jp, c).flat)
                      for c in ("envmap", "prefiltered")]:
        got, want = _rgbe_both(x)
        np.testing.assert_array_equal(got, want)
    p2 = (2.0 ** np.arange(-30, 30)).astype(np.float32)
    edges = np.concatenate([p2, np.nextafter(p2, 0), np.nextafter(p2, 1e9)])
    x = np.stack([edges, 0.3 * edges, 0.7 * edges], -1)
    got, want = _rgbe_both(x)
    assert (got != want).sum() <= 8
    dg, dw = (np.asarray(jibl.rgbe_decode(jnp.asarray(w)))
              for w in (got, want))
    assert (np.abs(dg - dw).max(-1) <= dw.max(-1) / 128).all()
    np.testing.assert_array_equal(
        tp.prefiltered.rgbe_table().numpy().view(np.uint32),
        np.asarray(jp.prefiltered.rgbe))


@pytest.fixture(scope="module")
def mats():
    """(JAX scene, port scene) on material_inputs' block-encoded stack
    (mip chains, every address mode, a material without extras)."""
    inp = material_inputs(seed=5, h=H, w=W)
    js = dataclasses.replace(
        make_rich_scene(), mat_stack=jtex.MaterialTextureStack(**{
            k: jnp.asarray(v) for k, v in inp["stack"].items()}),
        mat_params=jnp.asarray(inp["mat_params"]))
    ts = tloader.scene_from_arrays(*tloader.scene_arrays(js), "cpu")
    return js, ts


def test_jittered_stack_fetches_match_jax(mats):
    """sample_material_stack and sample_stack_alpha with a jitter at mips
    0 to past the last: the same texel as JAX's (its decode equal bit for
    bit) wherever floor(u s - 0.5 + j) is the same float decision, which
    it is on every pixel here (the same f32 operations)."""
    js, ts = mats
    r = np.random.default_rng(2)
    mat = r.integers(0, 3, (H, W)).astype(np.int32)
    uv = r.uniform(-1.5, 2.5, (H, W, 2)).astype(np.float32)
    lod = r.integers(0, 6, (H, W)).astype(np.float32)
    jit = r.random((H, W, 2)).astype(np.float32)
    args = [(mat, uv), dict(lod=lod, jitter=jit)]
    want = np.asarray(jtex.sample_material_stack(
        js.mat_stack, *map(jnp.asarray, args[0]),
        **{k: jnp.asarray(v) for k, v in args[1].items()}))
    got = ttex.sample_material_stack(
        ts.mat_stack, *map(_t, args[0]),
        **{k: _t(v) for k, v in args[1].items()}).numpy()
    np.testing.assert_array_equal(got, want)
    want = np.asarray(jtex.sample_stack_alpha(
        js.mat_stack, *map(jnp.asarray, args[0]),
        **{k: jnp.asarray(v) for k, v in args[1].items()}))
    got = ttex.sample_stack_alpha(ts.mat_stack, *map(_t, args[0]),
                                  **{k: _t(v) for k, v in args[1].items()})
    np.testing.assert_array_equal(got.numpy(), want)
    # the jitter moves the texel: the fetch differs from the unjittered one
    assert (got != ttex.sample_stack_alpha(ts.mat_stack, _t(mat), _t(uv),
                                           lod=_t(lod),
                                           jitter=_t(0 * jit))).any()


def _layer(seed, h, w):
    inp = material_inputs(seed=seed, h=h, w=w)
    _, tri, depth, interp, ivp = material_scene(inp, "cpu")
    return inp, tri, depth, interp, ivp


STOCH = {"dither": dict(mip_dither=FRAME),
         "jitter": dict(mip_dither=FRAME, uv_dither=True),
         "jitter_iso": dict(mip_dither=FRAME, uv_dither=True, max_aniso=1.0),
         "dither_iso": dict(mip_dither=FRAME, max_aniso=1.0)}


@pytest.mark.parametrize("case", sorted(STOCH))
def test_masked_alpha_stochastic_matches_jax(mats, case):
    """The dithered mip (capped at half an amask cell), the anisotropic
    step (clamped to half a cell's uv), the jittered alpha texel and the
    BLEND threshold seeded by the frame: alpha to 1e-6, the threshold
    bit for bit, the pass/fail decisions equal but within 1e-6 of the
    threshold."""
    js, ts = mats
    inp, tri, _, interp, _ = _layer(6, H, W)
    ja, jt = jresolve.masked_alpha(js, jnp.asarray(inp["tri"]),
                                   jnp.asarray(inp["interp"]), **STOCH[case])
    ta, tt = tresolve.masked_alpha(ts, tri, interp, **STOCH[case])
    ja, jt = np.asarray(ja), np.asarray(jt)
    np.testing.assert_allclose(ta.numpy(), ja, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tt.numpy(), jt)
    near = np.abs(ja - jt) <= 1e-6
    np.testing.assert_array_equal((ta >= tt).numpy()[~near],
                                  (ja >= jt)[~near])
    if case != "dither_iso":
        # (the isotropic dithered mip alone changes nothing here: every
        # material is small enough that the half-cell cap holds it at 0)
        exact, _ = tresolve.masked_alpha(ts, tri, interp)
        assert (exact != ta).any()


@pytest.mark.parametrize("checker", [None, 0, 1])
@pytest.mark.parametrize("case", ["jitter", "dither", "jitter_iso"])
def test_resolve_gbuffer_stochastic_matches_jax(mats, case, checker):
    """resolve_gbuffer's stochastic roles, with the checkerboard half-rate
    fetch for either parity (the checkerboard needs the jittered texel:
    JAX ignores it otherwise) on a layer whose uncovered pixels hold
    random interpolants (a covered pixel's fetching neighbour may be
    one): every plane to RTOL relative + 1e-6 of its peak, the mask
    exactly, zeros off it, uv (moved along the major axis) everywhere."""
    js, ts = mats
    inp, tri, depth, interp, ivp = _layer(7, H, W)
    kw = dict(STOCH[case], checker_parity=checker)
    j = jresolve.resolve_gbuffer(
        *(jnp.asarray(inp[k]) for k in ("tri", "depth")), js,
        jnp.asarray(inp["interp"]), jnp.asarray(inp["inv_view_proj"]), W, H,
        return_normal3=True, **kw)
    t = tresolve.resolve_gbuffer(tri, depth, ts, interp, ivp, W, H,
                                 return_normal3=True, **kw)
    np.testing.assert_array_equal(t[0].mask.numpy(), np.asarray(j[0].mask))
    for f in GB_FIELDS:
        _close(getattr(t[0], f).numpy(), np.asarray(getattr(j[0], f)), f)
    _close(t[1].numpy(), np.asarray(j[1]), "normal3")
    if checker is not None and case != "dither":
        plain = tresolve.resolve_gbuffer(tri, depth, ts, interp, ivp, W, H,
                                         **STOCH[case])
        assert not torch.equal(plain.base_color, t[0].base_color)


def test_chunk_capacity_matches_jax(mats):
    """A chunk capacity small enough to overflow (3 of 10 chunks, every
    one covered): chunk_keep keeps the first 3 covered chunks in flat
    order, chunk_overflow counts the rest as JAX's does; masked_alpha
    reads alpha 1.0 on the dropped chunks and resolve_gbuffer zero
    channels, each pixel as JAX's (alpha 1e-6, planes RTOL), exact and
    stochastic."""
    js, ts = mats
    inp, tri, depth, interp, ivp = _layer(8, CH, CW)
    inp["tri"].reshape(-1)[:128] = -1     # chunk 0 holds no covered pixel
    tri = _t(inp["tri"])
    cap = 3
    keep = tresolve.chunk_keep(tri >= 0, cap)
    assert keep.tolist() == [False, True, True, True] + [False] * 6
    active = jnp.asarray(inp["tri"]) >= 0
    assert int(tresolve.chunk_overflow(tri >= 0, cap)) == int(
        jresolve.chunk_overflow(active, cap)) == 6
    for kw in (dict(), STOCH["jitter"]):
        ja, _ = jresolve.masked_alpha(js, active * 0 + jnp.asarray(inp["tri"]),
                                      jnp.asarray(inp["interp"]),
                                      coverage_capacity=cap, **kw)
        ta, _ = tresolve.masked_alpha(ts, tri, interp, coverage_capacity=cap,
                                      **kw)
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0,
                                   atol=1e-6)
        dropped = ~tresolve._keep_pixels(keep, tri.shape)
        fac6 = ts.mat_params[interp[9].long(), 6]
        assert torch.equal(ta[dropped], fac6[dropped])
        j = jresolve.resolve_gbuffer(
            *(jnp.asarray(inp[k]) for k in ("tri", "depth")), js,
            jnp.asarray(inp["interp"]), jnp.asarray(inp["inv_view_proj"]),
            CW, CH, coverage_capacity=cap, **kw)
        t = tresolve.resolve_gbuffer(tri, depth, ts, interp, ivp, CW, CH,
                                     coverage_capacity=cap, **kw)
        for f in GB_FIELDS:
            _close(getattr(t, f).numpy(), np.asarray(getattr(j, f)), f)
        cov = (tri >= 0) & dropped
        assert cov.any() and not t.base_color[cov].any()


def _sky_inputs(seed, h=H, w=W):
    """A sky-lighting layer whose every input is finite (under the
    checkerboard an uncovered pixel's probe fetch may be its covered
    neighbour's): GBuffer, n, v, roughness at exactly 0 and 1 on two
    columns, clearcoat on half the pixels."""
    r = np.random.default_rng(seed)

    def unit(shape):
        x = r.normal(size=shape)
        return x / np.linalg.norm(x, axis=-1, keepdims=True)
    n = unit((h, w, 3))
    v = n + unit((h, w, 3)) * 0.9
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    mrao = r.uniform(0.0, 1.0, (h, w, 4))
    mrao[:, 0, 1], mrao[:, 1, 1] = 1.0, 0.0
    extras = r.uniform(0, 1, (h, w, 3))
    extras[::2, :, 1] = 0.0
    f = dict(base_color=r.uniform(0, 1, (h, w, 4)), mrao=mrao,
             extras=extras, n=n, v=v)
    f = {k: x.astype(np.float32) for k, x in f.items()}
    f["mask"] = r.random((h, w)) < 0.8
    return f


def _sky_call(mod, f, probe, lut, arr, **kw):
    gb = mod.GBuffer(base_color=arr(f["base_color"]), normals=None,
                     mrao=arr(f["mrao"]), emissive=None,
                     mask=arr(f["mask"]), world_pos=None, uv=None,
                     extras=arr(f["extras"]))
    return gb, arr(f["n"]), arr(f["v"]), probe, arr(lut), 2000.0


@pytest.mark.parametrize("checker", [None, 0, 1])
@pytest.mark.parametrize("case", ["jitter", "dither", "lobe", "lobe_analytic"])
def test_sky_lighting_stochastic_matches_jax(probes, case, checker):
    """sky_lighting's dithered probe fetch (one mip, with uv_dither one
    jittered texel of the RGBE table), the stochastic clearcoat lobe
    (extras: the coat lobe with probability fc) and the checkerboard
    probe fetch for either parity: with the LUT 1e-5 relative, with the
    analytic env-BRDF 2e-2 (its f32 conditioning,
    test_torch_lighting.py::test_env_brdf_matches_jax); uncovered pixels
    0."""
    jp, tp = probes
    f = _sky_inputs(11)
    lut = np.asarray(jibl.pack_env_brdf(jibl.env_brdf_lut(16, 64)))
    lobe = case.startswith("lobe")
    kw = dict(dither=FRAME, uv_dither=case != "dither",
              checker_parity=checker,
              analytic_env_brdf=case == "lobe_analytic")
    jargs = _sky_call(jresolve, f, jp, lut, jnp.asarray)
    targs = _sky_call(tresolve, f, tp, lut, _t)
    j = np.asarray(jsl.sky_lighting(
        *jargs, extras=jargs[0].extras if lobe else None, **kw))
    t = tsl.sky_lighting(*targs, extras=targs[0].extras if lobe else None,
                         **kw).numpy()
    assert np.abs(t).max() > 0 and not t[~f["mask"]].any()
    np.testing.assert_allclose(t, j, rtol=2e-2 if "analytic" in case
                               else 1e-5, atol=1e-3)
    exact = tsl.sky_lighting(*targs, extras=targs[0].extras if lobe
                             else None).numpy()
    assert not np.array_equal(exact, t)


@pytest.mark.parametrize("checker", [None, 0, 1])
def test_sun_visibility_stochastic_matches_jax(checker):
    """The jittered PCF tap (a 2-texel box) on a map whose depths are u16
    steps (so the port's f32 map holds JAX's unpacked values exactly),
    checkerboarded for either parity: the same visibility on every
    pixel."""
    r = np.random.default_rng(12)
    res = 64
    q = r.integers(0, 65536, (res, res)).astype(np.float32)
    depth = q * np.float32(1.0 / 65535.0)
    vp = tshadow.sun_view_proj([0.3, 0.8, -0.5], [0.0, 0.0, 0.0], 4.0)
    wp = r.uniform(-2, 2, (H, W, 3)).astype(np.float32)
    ndl = r.uniform(-1, 1, (H, W)).astype(np.float32)
    j = np.asarray(jshadow.sun_visibility(
        jnp.asarray(wp), jnp.asarray(ndl),
        jshadow.pack_depth_u16(jnp.asarray(depth)), jnp.asarray(vp), res,
        dither=FRAME, checker_parity=checker))
    t = tshadow.sun_visibility(_t(wp), _t(ndl), _t(depth), _t(vp), res,
                               dither=FRAME, checker_parity=checker).numpy()
    np.testing.assert_array_equal(t, j)
    assert 0.05 < (t == 0).mean() < 0.95
    if checker is not None:
        assert ((t > 0) & (t < 1)).any()      # tents of a lit and a dark


def test_taa_stochastic_history_matches_jax():
    """taa_resolve with dither: the reprojection through world space and
    one jittered history texel (JAX's jnp path), then the clamp and the
    blend: to 1e-5 relative."""
    r = np.random.default_rng(13)
    v0 = JView.from_lookat([0, 1, -4], [0.2, 0.1, 3], aspect=W / H)
    v1 = JView.from_lookat([0.15, 1.05, -4], [0.2, 0.1, 3], aspect=W / H)
    ivp = np.linalg.inv(v1.view_proj()).astype(np.float32)
    pvp = np.asarray(v0.view_proj(), np.float32)
    hdr = r.uniform(0, 4, (H, W, 3)).astype(np.float32)
    hist = r.uniform(0, 4, (H, W, 3)).astype(np.float32)
    depth = r.uniform(0.02, 1.0, (H, W)).astype(np.float32)
    j = np.asarray(jtaa.taa_resolve(
        jnp.asarray(hdr), jnp.asarray(hist), jnp.asarray(depth),
        jnp.asarray(ivp), jnp.asarray(pvp), True, W, H, dither=FRAME))
    t = ttaa.taa_resolve(_t(hdr), _t(hist), _t(depth), ivp @ pvp, True, W,
                         H, dither=FRAME, inv_view_proj=_t(ivp),
                         prev_view_proj=_t(pvp)).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)
    bilinear = ttaa.taa_resolve(_t(hdr), _t(hist), _t(depth), ivp @ pvp,
                                True, W, H).numpy()
    assert not np.allclose(bilinear, t)
