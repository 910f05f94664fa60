"""Port parity for lighting: the light-cluster grid, clustered shading (K2's
plain twin against the JAX Pallas kernel and the JAX dense loop), the
BRDF, the Preetham sky, the IBL probe chain, sky lighting, culling and
the tonemap."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incarnation_tpu.config import Config as JConfig
from incarnation_tpu.core.view import View as JView
from incarnation_tpu.kernels import clustered as jcl
from incarnation_tpu.kernels import cull as jcull
from incarnation_tpu.kernels import ibl as jibl
from incarnation_tpu.kernels import post as jpost
from incarnation_tpu.kernels import resolve as jresolve
from incarnation_tpu.kernels import shading as jsh
from incarnation_tpu.kernels import sky as jsky
from incarnation_tpu.kernels import skylight as jsl
from incarnation_tpu.scene import lights as jlights
from incarnation_tpu_torch.config import Config as TConfig
from incarnation_tpu_torch.kernels import clustered as tcl
from incarnation_tpu_torch.kernels import cull as tcull
from incarnation_tpu_torch.kernels import ibl as tibl
from incarnation_tpu_torch.kernels import post as tpost
from incarnation_tpu_torch.kernels import resolve as tresolve
from incarnation_tpu_torch.kernels import shading as tsh
from incarnation_tpu_torch.kernels import sky as tsky
from incarnation_tpu_torch.kernels import skylight as tsl
from incarnation_tpu_torch.scene import lights as tlights

torch.set_num_threads(1)

W, H = 256, 64


def _t(x):
    return torch.as_tensor(np.array(x))


def _unit(r, shape):
    v = r.normal(size=shape).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _lights(seed=3, n=9):
    r = np.random.default_rng(seed)
    defs, xforms = [], []
    for i in range(n):
        t = np.eye(4, dtype=np.float32)
        t[:3, :3] = np.linalg.qr(r.normal(size=(3, 3)))[0]
        t[3, :3] = r.uniform(-6, 6, 3) + [0, 0, 8]
        kind = ["point", "spot", "point"][i % 3]
        d = {"type": kind, "intensity": float(r.uniform(5, 50)),
             "color": r.uniform(0.2, 1.0, 3).tolist()}
        if i % 2:
            d["range"] = float(r.uniform(2.0, 8.0))
        if kind == "spot":
            d["spot"] = {"innerConeAngle": 0.3, "outerConeAngle": 0.8}
        defs.append(d)
        xforms.append(t)
    defs.append({"type": "directional", "intensity": 3.0})
    xforms.append(np.eye(4, dtype=np.float32))
    return (jlights.build_light_table(defs, xforms),
            tlights.light_table(tlights.light_arrays(defs, xforms), "cpu"))


def _gbuffers(seed, h=H, w=W, extras=False):
    r = np.random.default_rng(seed)
    f = dict(
        base_color=r.uniform(0, 1, (h, w, 4)),
        normals=r.uniform(-1, 1, (h, w, 2)),
        mrao=r.uniform(0.05, 1, (h, w, 4)),
        emissive=r.uniform(0, 2, (h, w, 3)),
        world_pos=r.uniform(-5, 5, (h, w, 3)) + [0, 0, 8],
        uv=r.uniform(0, 1, (h, w, 2)),
        extras=(r.uniform(0, 1, (h, w, 3)) if extras
                else np.zeros((h, w, 3))))
    f = {k: v.astype(np.float32) for k, v in f.items()}
    mask = r.random((h, w)) > 0.1
    jgb = jresolve.GBuffer(mask=jnp.asarray(mask),
                           **{k: jnp.asarray(v) for k, v in f.items()})
    tgb = tresolve.GBuffer(mask=torch.as_tensor(mask),
                           **{k: torch.as_tensor(v) for k, v in f.items()})
    n = _unit(r, (h, w, 3))
    # view vectors in the normal's hemisphere, NoV >= ~0.1: at grazing NoV
    # the BRDF's clamped denominators turn a 1-ulp difference into a
    # percent, in either package
    v = n + _unit(r, (h, w, 3)) * 0.9
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    depth = r.uniform(0.02, 1.0, (h, w)).astype(np.float32)
    return jgb, tgb, n, v, depth


def _cluster_inputs(jcfg, tcfg, w=W, h=H):
    view = JView.from_lookat([0.5, 0.5, -2.0], [0.0, 0.0, 8.0],
                             aspect=w / h)
    vp = view.view_proj()
    proj = view.projection_transform()
    ivp = np.linalg.inv(vp).astype(np.float32)
    jl, tl = _lights()
    jm, jc = jcl.build_light_clusters(jl, jcfg, jnp.asarray(proj),
                                      jnp.asarray(ivp), 1.0)
    tm, tc = tcl.build_light_clusters(tl, tcfg, _t(proj), _t(ivp), 1.0)
    return jl, tl, jm, jc, tm, tc


@pytest.mark.parametrize("dims", [(16, 9, 24), (2, 2, 24), (4, 3, 8)])
def test_build_light_clusters_exact(dims):
    """Cluster masks and the culled count equal JAX's bit for bit."""
    kw = dict(light_cluster_dim_x=dims[0], light_cluster_dim_y=dims[1],
              light_cluster_dim_z=dims[2])
    _, _, jm, jc, tm, tc = _cluster_inputs(JConfig(**kw), TConfig(**kw))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert int(tc) == int(jc)
    assert 0 < (tm.numpy() != 0).sum() < tm.numel()


def test_pixel_cluster_id_exact():
    cfg_j, cfg_t = JConfig(), TConfig()
    d = np.random.default_rng(0).uniform(1e-4, 1.0, (H, W)) \
        .astype(np.float32)
    d[0, :4] = [1.0, 1e-7, 1.0 / 200.0, 1.0 / 199.9]
    np.testing.assert_array_equal(
        tcl.pixel_cluster_id(_t(d), cfg_t, 1.0, W, H).numpy(),
        np.asarray(jcl.pixel_cluster_id(jnp.asarray(d), cfg_j, 1.0, W, H)))


def test_clustered_lighting_matches_jax_pallas():
    """K2's twin against JAX's Pallas K2 in interpret mode. A 2x2 cluster
    grid at 256x64 keeps every 32x128 block within 2x2 cells, which the
    TPU kernel's cell selector needs (_pallas_cells_ok). rtol 1e-4 +
    atol 1e-3: the JAX package's own bound between its kernel and its
    dense loop (sums of up to 9 lights in another order)."""
    kw = dict(light_cluster_dim_x=2, light_cluster_dim_y=2)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    assert jcl._pallas_cells_ok(W, H, 2, 2)
    jl, tl, jm, _, tm, _ = _cluster_inputs(jcfg, tcfg)
    jgb, tgb, n, v, depth = _gbuffers(4)
    j = np.asarray(jax.jit(lambda gb, n_, v_, d: jcl.clustered_lighting(
        gb, n_, v_, d, jl, jm, jcfg, 1.0, W, H))(
            jgb, jnp.asarray(n), jnp.asarray(v), jnp.asarray(depth)))
    t = tcl.clustered_lighting(tgb, _t(n), _t(v), _t(depth), tl, tm, tcfg,
                               1.0, W, H).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-3)
    assert (np.abs(j) > 1e-3).mean() > 0.1


def test_clustered_lighting_matches_jax_dense():
    """At the default 16x9x24 grid JAX takes its dense loop, the same
    arithmetic as the twin in the same light order. XLA fuses the loop body
    and rounds the dot products differently, so: 1e-4 relative, where a
    low-roughness GGX highlight amplifies a 1-ulp NoH difference to ~2e-5,
    and 1e-2 absolute (1e-4 of the typical pixel, ~1e2), where a light at
    grazing NoL ~ 5e-6 carries that product's 1-ulp error at 2e-2 of its
    ~0.3 contribution."""
    jcfg, tcfg = JConfig(), TConfig()
    assert not jcl._pallas_cells_ok(W, H, 16, 9)
    jl, tl, jm, _, tm, _ = _cluster_inputs(jcfg, tcfg)
    jgb, tgb, n, v, depth = _gbuffers(5)
    j = np.asarray(jcl.clustered_lighting(jgb, jnp.asarray(n), jnp.asarray(v),
                                          jnp.asarray(depth), jl, jm, jcfg,
                                          1.0, W, H))
    t = tcl.clustered_lighting(tgb, _t(n), _t(v), _t(depth), tl, tm, tcfg,
                               1.0, W, H).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-2)
    rows = tcl.light_rows(tl).numpy()
    np.testing.assert_allclose(rows, np.asarray(jcl._pack_light_rows(jl)),
                               rtol=0, atol=1e-7)


@pytest.mark.parametrize("extras", [False, True])
def test_brdf_and_punctual_light_match_jax(extras):
    """Elementwise f32 formulas in both packages: 1e-5 relative."""
    jgb, tgb, n, v, _ = _gbuffers(6, 32, 32, extras=extras)
    l = _unit(np.random.default_rng(7), (32, 32, 3))
    rad = np.float32([2.0, 1.0, 0.5])
    xkw_j = xkw_t = {}
    if extras:
        xkw_j = dict(transmission=jgb.extras[..., 0],
                     clearcoat=jgb.extras[..., 1],
                     cc_roughness=jgb.extras[..., 2])
        xkw_t = dict(transmission=tgb.extras[..., 0],
                     clearcoat=tgb.extras[..., 1],
                     cc_roughness=tgb.extras[..., 2])
    j = np.asarray(jsh.brdf_response(
        jgb.base_color[..., :3], jgb.mrao[..., 0], jgb.mrao[..., 1],
        jnp.asarray(n), jnp.asarray(v), jnp.asarray(l), jnp.asarray(rad),
        **xkw_j))
    t = tsh.brdf_response(tgb.base_color[..., :3], tgb.mrao[..., 0],
                          tgb.mrao[..., 1], _t(n), _t(v), _t(l), _t(rad),
                          **xkw_t).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-7)
    jl, tl = _lights()
    for i in range(3):
        ja = jsh.punctual_light(jl.type[i], jl.transform[i], jl.color[i],
                                jl.intensity[i], jl.range[i],
                                jl.spot_angles[i], jgb.world_pos)
        ta = tsh.punctual_light(tl.type[i], tl.transform[i], tl.color[i],
                                tl.intensity[i], tl.range[i],
                                tl.spot_angles[i], tgb.world_pos)
        for a, b in zip(ja, ta):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                       atol=1e-6)


def test_sky_matches_jax():
    """Preetham sky: radiance and the lat-long texture, 1e-5 relative."""
    sun = np.float32([0.3, 0.8, 0.52])
    sun /= np.linalg.norm(sun)
    d = _unit(np.random.default_rng(8), (500, 3))
    np.testing.assert_allclose(
        tsky.sky_radiance(_t(sun), _t(d), 2.0).numpy(),
        np.asarray(jsky.sky_radiance(jnp.asarray(sun), jnp.asarray(d), 2.0)),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tsky.sky_latlong(_t(sun), 3.0, 32, 16).numpy(),
        np.asarray(jsky.sky_latlong(jnp.asarray(sun), 3.0, 32, 16)),
        rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def probes():
    """One JAX probe (envmap_size 16) and the port's own build from the same
    lat-long, plus the JAX probe carried across with probe_from_arrays."""
    sun = np.float32([0.4, 0.6, 0.69])
    sun /= np.linalg.norm(sun)
    ll = np.asarray(jsky.sky_latlong(jnp.asarray(sun), 2.0, 32, 16))
    jp = jibl.build_probe(jnp.asarray(ll), envmap_size=16, num_samples=64)
    tp = tibl.build_probe(_t(ll), envmap_size=16, num_samples=64)
    carried = tibl.probe_from_arrays(
        {"sh": np.asarray(jp.sh),
         **{f"{c}.{a}": np.asarray(getattr(getattr(jp, c), a))
            for c in ("envmap", "prefiltered")
            for a in ("flat", "size", "num_levels", "bases")},
         "envmap.packed": True, "prefiltered.packed": True}, "cpu")
    return jp, tp, carried


def test_build_probe_matches_jax(probes):
    """Cube, GGX prefilter and SH of the port's own build: 1e-4 relative
    (the prefilter sums its samples in batches, JAX one by one)."""
    jp, tp, _ = probes
    for c in ("envmap", "prefiltered"):
        a, b = getattr(jp, c), getattr(tp, c)
        assert (b.size, b.num_levels, b.bases) == (a.size, a.num_levels,
                                                    tuple(a.bases))
        np.testing.assert_allclose(b.flat.numpy(), np.asarray(a.flat),
                                   rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tp.sh.numpy(), np.asarray(jp.sh), rtol=1e-4,
                               atol=1e-6)


def test_probe_samplers_match_jax(probes):
    """sample_cube (trilinear, any direction incl. face seams) and
    sh_irradiance on the carried probe: 1e-6 absolute, the same
    arithmetic on the same table."""
    jp, _, tp = probes
    r = np.random.default_rng(9)
    d = _unit(r, (40, 40, 3))
    d[0, :6] = [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1],
                [0.57735, 0.57735, -0.57735]]
    lod = r.uniform(-0.5, 4.5, (40, 40)).astype(np.float32)
    for cube in ("envmap", "prefiltered"):
        np.testing.assert_allclose(
            tibl.sample_cube(getattr(tp, cube), _t(d), lod=_t(lod)).numpy(),
            np.asarray(jibl.sample_cube(getattr(jp, cube), jnp.asarray(d),
                                        lod=jnp.asarray(lod))),
            rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        tibl.sh_irradiance(_t(d), tp.sh).numpy(),
        np.asarray(jibl.sh_irradiance(jnp.asarray(d), jp.sh)),
        rtol=1e-6, atol=1e-6)


def test_env_brdf_matches_jax():
    """The analytic env-BRDF evaluates the same degree-16 Chebyshev tensor
    in the same f32 order, with the same multiply-adds fused: the JAX
    function as the JAX package runs it, jitted (XLA's CPU build fuses the
    recurrence steps and the tensor sums' products into multiply-adds;
    eager dispatch rounds each operation apart and lands up to 0.28
    away). That evaluation is ill-conditioned: the JAX
    package's own f32 result is up to 0.03 from its float64 evaluation for
    NoV >= 0.1 (and 15 near NoV = 0), and a 1-ulp difference in pow(NoV,
    1/4) between the two libraries moves A or B by up to 0.01 (1% where
    the 1/NoV factor makes them large). So: most values bit-equal, all
    within 1% + 0.02, which is below the reference's own f32 error. The
    LUT path: the integration on the same Hammersley set, 1e-4."""
    r = np.random.default_rng(10)
    nv = r.uniform(0, 1, (64, 64)).astype(np.float32)
    ro = r.uniform(0, 1, (64, 64)).astype(np.float32)
    t = tibl.env_brdf_approx(_t(nv), _t(ro)).numpy()
    j = np.asarray(jax.jit(jibl.env_brdf_approx)(jnp.asarray(nv),
                                                 jnp.asarray(ro)))
    np.testing.assert_allclose(t, j, rtol=1e-2, atol=0.02)
    assert (t == j).mean() > 0.9
    jlut = np.asarray(jibl.env_brdf_lut(16, 64))
    tlut = tibl.env_brdf_lut(16, 64, device="cpu")
    np.testing.assert_allclose(tlut.numpy(), jlut, rtol=1e-4, atol=1e-6)
    packed = tibl.pack_env_brdf(tlut)
    np.testing.assert_allclose(packed.numpy(),
                               np.asarray(jibl.pack_env_brdf(jlut)),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(
        tibl.sample_env_brdf(packed, _t(nv), _t(ro)).numpy(),
        np.asarray(jibl.sample_env_brdf(jibl.pack_env_brdf(jlut),
                                        jnp.asarray(nv), jnp.asarray(ro))),
        rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("analytic", [False, True])
def test_sky_lighting_and_background_match_jax(probes, analytic):
    """Sky IBL on random surfaces with the carried probe, extras
    (transmission, clearcoat) included: with the LUT, 1e-5 relative; with
    the analytic env-BRDF, 2e-2 relative, the polynomial's f32
    conditioning (test_env_brdf_matches_jax)."""
    jp, _, tp = probes
    jgb, tgb, n, v, _ = _gbuffers(11, 24, 40, extras=True)
    lut = jibl.pack_env_brdf(jibl.env_brdf_lut(16, 64))
    j = np.asarray(jsl.sky_lighting(jgb, jnp.asarray(n), jnp.asarray(v), jp,
                                    lut, 2000.0, extras=jgb.extras,
                                    analytic_env_brdf=analytic))
    t = tsl.sky_lighting(tgb, _t(n), _t(v), tp, _t(lut), 2000.0,
                         extras=tgb.extras,
                         analytic_env_brdf=analytic).numpy()
    np.testing.assert_allclose(t, j, rtol=2e-2 if analytic else 1e-5,
                               atol=1e-3)
    view = JView.from_lookat([0, 1, -4], [0.3, 0.2, 3], aspect=40 / 24)
    ivp = np.linalg.inv(view.view_proj()).astype(np.float32)
    eye = np.asarray(view.position, np.float32)
    sun = np.float32([0.4, 0.6, 0.69])
    sun /= np.linalg.norm(sun)
    for dyn in (True, False):
        j = np.asarray(jsl.environment_background(
            jgb.mask, jnp.asarray(eye), jnp.asarray(ivp), 40, 24, probe=jp,
            sun_dir=jnp.asarray(sun), dynamic_sky=dyn))
        t = tsl.environment_background(
            tgb.mask, _t(eye), _t(ivp), 40, 24, probe=tp, sun_dir=_t(sun),
            dynamic_sky=dyn).numpy()
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-4)


# sky_lighting options the extras case above does not reach: HBAO with
# bent normals, lighting_only, one IBL lobe off, no extras
SKY_CASES = {
    "hbao_bent_normals": dict(hbao=True, bent=True, extras=True),
    "lighting_only": dict(lighting_only=True, extras=True),
    "diffuse_off": dict(diffuse_ibl=False, extras=True),
    "specular_off": dict(specular_ibl=False, extras=True),
    "no_extras": dict(),
}


@pytest.mark.parametrize("analytic", [False, True])
@pytest.mark.parametrize("case", sorted(SKY_CASES))
def test_sky_lighting_options_match_jax(probes, case, analytic):
    """sky_lighting's twin against JAX on the options of SKY_CASES, at the
    tolerances of test_sky_lighting_and_background_match_jax (the LUT
    1e-5, the analytic env-BRDF 2e-2 relative)."""
    jp, _, tp = probes
    jgb, tgb, n, v, _ = _gbuffers(13, 24, 40, extras=True)
    r = np.random.default_rng(14)
    ao = r.uniform(0, 1, (24, 40)).astype(np.float32)
    bent = _unit(r, (24, 40, 3))
    o = dict(SKY_CASES[case])
    use_hbao, use_bent = o.pop("hbao", False), o.pop("bent", False)
    use_extras = o.pop("extras", False)
    lut = jibl.pack_env_brdf(jibl.env_brdf_lut(16, 64))
    j = np.asarray(jsl.sky_lighting(
        jgb, jnp.asarray(n), jnp.asarray(v), jp, lut, 2000.0,
        hbao=jnp.asarray(ao) if use_hbao else None,
        bent_normals=jnp.asarray(bent) if use_bent else None,
        extras=jgb.extras if use_extras else None,
        analytic_env_brdf=analytic, **o))
    t = tsl.sky_lighting(
        tgb, _t(n), _t(v), tp, _t(lut), 2000.0,
        hbao=_t(ao) if use_hbao else None,
        bent_normals=_t(bent) if use_bent else None,
        extras=tgb.extras if use_extras else None,
        analytic_env_brdf=analytic, **o).numpy()
    assert np.abs(t).max() > 0
    np.testing.assert_allclose(t, j, rtol=2e-2 if analytic else 1e-5,
                               atol=1e-3)


def test_cull_and_tonemap_match_jax():
    r = np.random.default_rng(12)
    bs = np.concatenate([r.uniform(-20, 20, (200, 3)),
                         r.uniform(0.1, 3, (200, 1))], 1).astype(np.float32)
    mesh = r.integers(0, 3, 200).astype(np.int32)
    xf = np.stack([np.eye(4, dtype=np.float32) * s for s in (1, 2, 0.5)])
    xf[:, 3, 3] = 1
    vis = np.int32([1, 1, 0])
    rot = np.eye(4, dtype=np.float32)
    vp = JView.from_lookat([0, 0, -10], [0, 0, 5], aspect=2).view_proj()
    ji, jc = jcull.cull_primitives(*map(jnp.asarray, (bs, mesh, xf, vis, rot,
                                                      vp)))
    ti, tc = tcull.cull_primitives(*map(_t, (bs, mesh, xf, vis, rot, vp)))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert int(tc) == int(jc)
    hdr = r.uniform(0, 3e4, (16, 16, 3)).astype(np.float32)
    hdr[0, 0] = np.nan
    for nan_check in (False, True):
        j = np.asarray(jpost.tonemap(jnp.asarray(hdr), 13.0, nan_check))
        t = tpost.tonemap(_t(hdr), 13.0, nan_check).numpy()
        np.testing.assert_allclose(t[1:], j[1:], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(tpost.to_uint8(_t(j)).numpy(),
                                      np.asarray(jpost.to_uint8(
                                          jnp.asarray(j))))
