"""The PyTorch port stands alone: no JAX, no reference package, no silent
CPU fallback, and no TPU-only approximation behind a flag."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from incarnation_tpu_torch import config as tconfig
from incarnation_tpu_torch.core.view import View
from incarnation_tpu_torch.device import resolve_device
from incarnation_tpu_torch.dist import sharding
from incarnation_tpu_torch.kernels import bvh, clustered, raster, taa
from incarnation_tpu_torch.renderer import frame as tframe
from incarnation_tpu_torch.scene import testing as ttesting

torch.set_num_threads(1)


def test_port_imports_no_jax():
    """A fresh interpreter that imports the whole frame path (and the
    package's every module) holds no jax and no incarnation_tpu module,
    and no PIL or OpenCV (the card's machine has neither)."""
    code = (
        "import importlib, pkgutil, sys\n"
        f"sys.path.insert(0, {str(tconfig.__file__.rsplit('/', 2)[0])!r})\n"
        "import incarnation_tpu_torch as p\n"
        "import incarnation_tpu_torch.renderer.frame\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'jaxlib' or m.startswith('incarnation_tpu.')\n"
        "       or m == 'incarnation_tpu'\n"
        "       or m.split('.')[0] in ('PIL', 'cv2')]\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-I", "-c", code],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_default_device_raises_without_cuda():
    """device=None means the CUDA card; on a host without one every entry
    point raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tframe.FrameConstants.make(View.default(), tconfig.Config())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bvh.bvh_from_arrays(np.zeros((1, bvh.WIDE_LANES), np.float32),
                            None)
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("flag,value", [
    ("stochastic_mip", True), ("stochastic_bilinear", True),
    ("checkerboard_gathers", True), ("stochastic_taa", True),
    ("peel_chunk_capacity", 6144), ("decal_chunk_capacity", 1024)])
def test_tpu_only_flags_raise(flag, value):
    with pytest.raises(NotImplementedError, match=flag):
        tconfig.Config(**{flag: value})


def test_tpu_only_flags_default_off():
    cfg = tconfig.Config()
    assert not any(getattr(cfg, f) for f in tconfig.TPU_ONLY_FLAGS)


@pytest.fixture(scope="module")
def tiny():
    """make_rich_scene with its BVH, all on the CPU, for 16x8 frames."""
    scene = ttesting.make_rich_scene(device="cpu", blend_quad=True)
    return scene, bvh.build_scene_bvh(scene, use_cache=False, device="cpu")


def _render_tiny(tiny, kw):
    """One 16x8 frame of make_rich_scene with Config(**kw); a scene_bvh
    key stands for the scene's BVH, and a band_axis key renders the frame
    in 2 bands of 4 rows (dist.sharding over ["cpu", "cpu"]), which must
    equal the single frame."""
    scene, scene_bvh = tiny
    args = {}
    if "scene_bvh" in kw:
        args["scene_bvh"] = scene_bvh
    cfg = tconfig.Config(masked_depth_peels=2, enable_taa=False,
                         **{k: v for k, v in kw.items()
                            if k not in ("scene_bvh", "band_axis")})
    fc = tframe.FrameConstants.make(
        View.from_lookat([1.0, 2.5, -2.0], [0.0, -1.0, 7.0], aspect=2.0),
        cfg, shadow_bounds=([0.0, 1.0, 6.0], 12.0), device="cpu")
    params = raster.RasterParams(width=16, height=8, pair_capacity=1024,
                                 bin_max_span=8, big_tri_capacity=64,
                                 tile_h=4 if "band_axis" in kw else 16)
    out = tframe.render_frame(scene, fc, config=cfg, params=params, **args)
    if "band_axis" in kw:
        band = sharding.render_frame_sharded(scene, fc, config=cfg,
                                             params=params,
                                             devices=["cpu", "cpu"], **args)
        assert torch.equal(band["tri"], out["tri"])
        assert int((band["color"].int() - out["color"].int()).abs().max()) \
            <= 1
    assert torch.isfinite(out["hdr"]).all()
    assert out["color"].shape == (8, 16, 3)
    return out


@pytest.mark.parametrize("kw", [
    dict(sun_shadow_mode="rt", scene_bvh=True),
    dict(enable_hbao=True, scene_bvh=True),
    dict(scene_bvh=True), dict(band_axis="x"),
    dict(sun_shadow_mode="rt", forward_lighting=True, scene_bvh=True),
    dict(enable_hbao=True, use_bent_normals=True, scene_bvh=True,
         viewmode=tconfig.ViewMode.BENT_NORMALS)])
def test_later_slices_raise(tiny, kw):
    """Every branch of render_frame that a later slice was to port is
    ported and renders a finite frame: what needs a BVH (RT sun shadows,
    HBAO, a scene_bvh; slice 4) and band sharding (slice 5, the band_axis
    case), whose 2-band frame equals the single frame."""
    _render_tiny(tiny, kw)


@pytest.mark.parametrize("kw", [
    dict(sun_shadow_mode="map"), dict(forward_lighting=True),
    dict(show_light_bounds=True, show_object_bounds=True),
    dict(viewmode=tconfig.ViewMode.BASE_COLOR),
    dict(viewmode=tconfig.ViewMode.LIGHT_CLUSTER_SLICES)])
def test_raster_frame_options_are_supported(tiny, kw):
    """Everything of the raster frame that needs no BVH is ported: each
    option renders a finite frame without one."""
    _render_tiny(tiny, kw)


def test_band_axis_raises():
    """render_frame takes no mesh axis: a band-sharded frame is
    dist.sharding.render_frame_sharded over a list of devices."""
    with pytest.raises(TypeError, match="band_axis"):
        tframe.render_frame(None, None, config=tconfig.Config(),
                            params=raster.RasterParams(128, 16),
                            band_axis="x")


def test_cpu_tensors_take_the_twins():
    """On CPU tensors the wrappers run the plain twins and count no kernel
    launch."""
    for k in (raster.K1, clustered.K2, taa.K3, bvh.K4):
        k.launches = 0
    h, w = 16, 8
    hist = torch.rand(h, w, 3)
    depth = torch.full((h, w), 0.5)
    out = taa.history_fetch(hist, depth, torch.eye(4), w, h)
    torch.testing.assert_close(out, hist, rtol=0, atol=1e-6)
    assert raster.K1.launches == clustered.K2.launches == taa.K3.launches \
        == bvh.K4.launches == 0
