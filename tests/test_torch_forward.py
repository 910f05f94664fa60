"""Port parity for the forward path of the raster frame: forward_lighting
shading from the exact mapped normal, and the BLEND layers peeled by K1's
z_limit role ("raster_blend"), shaded per layer and composited front to
back. The JAX frame runs Pallas in interpret mode; the port runs its plain
twins on the CPU. Scenes are built once with the JAX package's builders and
carried across as numpy arrays."""

import numpy as np
import pytest
import torch

from incarnation_tpu.config import Config as JConfig
from incarnation_tpu.core.view import View as JView
from incarnation_tpu.kernels.raster import RasterParams as JParams
from incarnation_tpu.renderer import frame as jframe
from incarnation_tpu.scene import lights as jlights
from incarnation_tpu.scene import materials as jmaterials
from incarnation_tpu.scene.testing import make_scene
from incarnation_tpu_torch.config import Config as TConfig
from incarnation_tpu_torch.core.view import View as TView
from incarnation_tpu_torch.kernels import raster as traster
from incarnation_tpu_torch.renderer import frame as tframe
from incarnation_tpu_torch.scene import loader as tloader

torch.set_num_threads(1)

W, H = 128, 64
RASTER = dict(width=W, height=H, tile_h=16, tile_w=128, pair_capacity=256,
              bin_max_span=4, big_tri_capacity=16)
# no sky; the stochastic estimators off in the JAX Config too
CFG = dict(env_sky_mode=0, forward_lighting=True, stochastic_mip=False,
           stochastic_bilinear=False, checkerboard_gathers=False,
           peel_chunk_capacity=0, decal_chunk_capacity=0)
SUN = [0.0, 0.0, -1.0]


def _materials(defs):
    class _G:
        materials = defs
    return jmaterials.build_material_table(_G)


def _opaque_scene():
    """A rough grey wall at z = 8 behind a tilted metallic quad, lit by the
    sun and one point light."""
    rng = np.random.default_rng(3)
    pts = np.array([
        [-12, -9, 8], [12, -9, 8], [12, 9, 8], [-12, 9, 8],
        [-3, -2, 4], [3, -2, 6], [3, 2, 6], [-3, 2, 4]], np.float32)
    normals = np.tile([0.0, 0.0, -1.0], (8, 1)).astype(np.float32)
    normals[4:] = np.asarray([-0.316, 0.0, -0.949], np.float32)
    normals += rng.normal(scale=0.05, size=normals.shape).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    mats = _materials([
        {"pbrMetallicRoughness": {"baseColorFactor": [0.5, 0.5, 0.5, 1.0],
                                  "metallicFactor": 0.0,
                                  "roughnessFactor": 0.9}},
        {"pbrMetallicRoughness": {"baseColorFactor": [0.9, 0.6, 0.2, 1.0],
                                  "metallicFactor": 1.0,
                                  "roughnessFactor": 0.4}}])
    lights = jlights.build_light_table(
        [{"type": "point", "color": [0.3, 0.6, 1.0], "intensity": 40.0,
          "range": 12.0}],
        [np.asarray([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0],
                     [1, 1, 3, 1]], np.float32)])
    return make_scene(pts, [[0, 1, 2], [0, 2, 3], [4, 5, 6], [4, 6, 7]],
                      normals=normals, materials=mats, lights=lights,
                      tri_prim=[0, 0, 1, 1], num_prims=2,
                      prim_tri_offset=[0, 2], prim_material=[0, 1])


def _two_quad_blend_scene(front_alpha):
    """Opaque green quad at z=8 behind a BLEND red quad at z=5 (the scene
    of tests/test_frame.py::test_forward_blend_compositing)."""
    mats = _materials([
        {"pbrMetallicRoughness": {
            "baseColorFactor": [0.0, 1.0, 0.0, 1.0],
            "metallicFactor": 0.0, "roughnessFactor": 1.0}},
        {"pbrMetallicRoughness": {
            "baseColorFactor": [1.0, 0.0, 0.0, front_alpha],
            "metallicFactor": 0.0, "roughnessFactor": 1.0},
         "alphaMode": "BLEND"}])
    pts = np.array([
        [-12, -9, 8], [12, -9, 8], [12, 9, 8], [-12, 9, 8],   # back (green)
        [-3, -2, 5], [3, -2, 5], [3, 2, 5], [-3, 2, 5],       # front (red)
    ], np.float32)
    return make_scene(pts, [[0, 1, 2], [0, 2, 3], [4, 5, 6], [4, 6, 7]],
                      materials=mats, tri_prim=[0, 0, 1, 1], num_prims=2,
                      prim_tri_offset=[0, 2], prim_material=[0, 1],
                      prim_alpha_mode=[0, 2])


def _render_both(jscene, **cfg_kw):
    cfg = dict(CFG, **cfg_kw)
    jcfg, tcfg = JConfig(**cfg), TConfig(**cfg)
    tscene = tloader.scene_from_arrays(*tloader.scene_arrays(jscene), "cpu")
    kw = dict(sun_dir=SUN, sun_color_intensity=(1.0, 1.0, 1.0, 100.0))
    if cfg.get("sun_shadow_mode") == "map":
        kw["shadow_bounds"] = ([0.0, 0.0, 6.0], 17.0)
    jfc = jframe.FrameConstants.make(JView.default(aspect=W / H), jcfg, **kw)
    tfc = tframe.FrameConstants.make(TView.default(aspect=W / H), tcfg,
                                     device="cpu", **kw)
    j = jframe.render_frame_jit(jscene, jfc, jcfg, JParams(chunk=8, **RASTER))
    traster.K1.reset()
    t = tframe.render_frame(tscene, tfc, config=tcfg,
                            params=traster.RasterParams(**RASTER))
    assert traster.K1.launches == 0      # CPU tensors take the twin
    return j, t


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return np.inf if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)


def _assert_close(j, t):
    """hdr to 2e-2 of each value + 1e-3 of the frame's peak (f32 BRDF
    arithmetic in another order), u8 colour >= 50 dB, tri equal (no
    equal-depth ties in these scenes)."""
    np.testing.assert_array_equal(t["tri"].numpy(), np.asarray(j["tri"]))
    a, b = t["hdr"].numpy(), np.asarray(j["hdr"])
    assert np.isfinite(a).all() and np.abs(b).max() > 0
    np.testing.assert_allclose(a, b, rtol=2e-2, atol=1e-3 * np.abs(b).max())
    assert _psnr(t["color"].numpy(), np.asarray(j["color"])) >= 50.0


@pytest.mark.parametrize("shadow", ["off", "map"])
def test_forward_opaque_matches_jax(shadow):
    """Forward shading of an opaque scene (sun + point light), without and
    with the sun shadow map (the tilted quad shadows the wall)."""
    j, t = _render_both(_opaque_scene(), sun_shadow_mode=shadow,
                        shadow_map_resolution=128)
    _assert_close(j, t)
    assert (t["tri"] >= 0).float().mean() > 0.5


def test_forward_differs_from_deferred_only_by_the_normal_round_trip():
    """The port's forward frame against its deferred frame on the opaque
    scene: > 45 dB, as tests/test_frame.py holds the JAX package."""
    scene = tloader.scene_from_arrays(
        *tloader.scene_arrays(_opaque_scene()), "cpu")
    outs = []
    for fwd in (False, True):
        cfg = TConfig(**dict(CFG, forward_lighting=fwd))
        fc = tframe.FrameConstants.make(
            TView.default(aspect=W / H), cfg, sun_dir=SUN,
            sun_color_intensity=(1.0, 1.0, 1.0, 100.0), device="cpu")
        outs.append(tframe.render_frame(
            scene, fc, config=cfg, params=traster.RasterParams(**RASTER)))
    assert _psnr(outs[0]["color"].numpy(), outs[1]["color"].numpy()) > 45.0
    assert not torch.equal(outs[0]["hdr"], outs[1]["hdr"])


@pytest.mark.parametrize("alpha", [0.5, 1.0])
def test_forward_blend_compositing_matches_jax(alpha):
    """A BLEND red quad over an opaque green one, in both packages: the
    frames agree, and the port composites as
    tests/test_frame.py::test_forward_blend_compositing expects (alpha 0.5
    mixes both surfaces equally; alpha 1 hides the green one but for the
    white dielectric specular lobe)."""
    j, t = _render_both(_two_quad_blend_scene(alpha))
    _assert_close(j, t)
    px = t["hdr"].numpy()[H // 2, W // 2]
    if alpha == 0.5:
        assert px[0] > 0 and px[1] > 0
        np.testing.assert_allclose(px[0], px[1], rtol=0.05)
    else:
        assert px[0] > 0 and px[1] < 0.05 * px[0]


def test_blend_layers_launch_one_peel_per_configured_layer(monkeypatch):
    """With forward lighting the BLEND prims get their own layer of the one
    binning and masked_depth_peels "raster_blend" launches of the z_limit
    role, without a mask table; without it they stay in the screen-door
    masked peel."""
    calls = []
    plain = traster.rasterize_tiles

    def spy(bins, params, z_limit=None, mask_table=None, name="fine_raster"):
        calls.append((name, z_limit is not None, mask_table is not None))
        return plain(bins, params, z_limit=z_limit, mask_table=mask_table,
                     name=name)

    monkeypatch.setattr(traster, "rasterize_tiles", spy)
    scene = tloader.scene_from_arrays(
        *tloader.scene_arrays(_two_quad_blend_scene(0.5)), "cpu")
    for fwd, want in ((True, 3), (False, 0)):
        calls.clear()
        cfg = TConfig(**dict(CFG, forward_lighting=fwd, masked_depth_peels=3))
        fc = tframe.FrameConstants.make(
            TView.default(aspect=W / H), cfg, sun_dir=SUN,
            sun_color_intensity=(1.0, 1.0, 1.0, 100.0), device="cpu")
        tframe.render_frame(scene, fc, config=cfg,
                            params=traster.RasterParams(**RASTER))
        blend = [c for c in calls if c[0] == "raster_blend"]
        assert len(blend) == want
        assert all(zl and not mt for _, zl, mt in blend)
        assert sum(c[0] == "raster_peel" for c in calls) == 3
