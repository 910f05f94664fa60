"""The port's utils (image IO, profiling), compare, CLI and web viewer
against the JAX package's, on the CPU at small sizes."""

import json
import pathlib
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from incarnation_tpu.utils import imageio as jio
from incarnation_tpu_torch.app import cli as tcli
from incarnation_tpu_torch.app import compare as tcompare
from incarnation_tpu_torch.app import viewer as tviewer
from incarnation_tpu_torch.config import Config
from incarnation_tpu_torch.scene import png as tpng
from incarnation_tpu_torch.scene.loader import SceneHost
from incarnation_tpu_torch.scene.testing import make_rich_scene
from incarnation_tpu_torch.utils import imageio as tio
from incarnation_tpu_torch.utils import profiling
from test_torch_scene import _write_gltf

torch.set_num_threads(1)

MIN_PSNR = 50.0     # dB, u8 colour: the port's frame against JAX's
TEST_ENV_HDR = pathlib.Path(__file__).parent / "data" / "test_env.hdr"


def test_load_hdr_matches_opencv():
    """The port's Radiance reader equals the JAX package's (OpenCV) on the
    repository's run-length-encoded test environment, to the bit; a flat
    (unencoded) file written from it reads back the same."""
    got = tio.load_hdr(TEST_ENV_HDR)
    want = jio.load_hdr(TEST_ENV_HDR)
    assert got.shape == (128, 256, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_flat_hdr_scanlines(tmp_path):
    """Flat scanlines (width < 8 forbids run-length encoding): RGBE bytes
    decode to mantissa x 2^(e - 136), 0 where e is 0."""
    rgbe = np.array([[[128, 64, 32, 129], [0, 0, 0, 0], [255, 1, 2, 140]]],
                    np.uint8)
    path = tmp_path / "flat.hdr"
    path.write_bytes(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 1 +X 3\n"
                     + rgbe.tobytes())
    got = tio.load_hdr(path)
    want = rgbe[..., :3].astype(np.float32) * np.where(
        rgbe[..., 3:] > 0, np.ldexp(1.0, rgbe[..., 3:].astype(int) - 136),
        0.0).astype(np.float32)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jio.load_hdr(path))


def test_png_round_trip_and_psnr(tmp_path):
    """save_png writes what JAX's (PIL) writes, pixel for pixel, for u8 and
    float input; compare reads both; psnr equals JAX's."""
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (24, 40, 3), dtype=np.uint8)
    flt = rng.uniform(-0.2, 1.2, (24, 40, 3)).astype(np.float32)
    for i, x in enumerate((img, flt)):
        tio.save_png(tmp_path / f"t{i}.png", x)
        jio.save_png(tmp_path / f"j{i}.png", x)
        np.testing.assert_array_equal(tio.load_png(tmp_path / f"t{i}.png"),
                                      tio.load_png(tmp_path / f"j{i}.png"))
        assert tcompare.compare(tmp_path / f"t{i}.png",
                                tmp_path / f"j{i}.png") == float("inf")
    a = img.astype(np.float32) / 255.0
    b = np.clip(a + rng.normal(0, 0.01, a.shape), 0, 1)
    assert tio.psnr(a, b) == jio.psnr(a, b)
    rgba = rng.integers(0, 256, (5, 7, 4), dtype=np.uint8)
    np.testing.assert_array_equal(tpng.decode_png(tpng.encode_png(rgba)),
                                  rgba)


def test_profiling_trace_names_scoped_region(tmp_path):
    with profiling.trace(tmp_path / "tr"):
        with profiling.scoped("visibility_pass"):
            torch.ones(64).cumsum(0)
    trace = json.loads((tmp_path / "tr" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "visibility_pass" in names
    sec, out = profiling.time_fn(lambda: torch.ones(8) * 2, iters=3)
    assert sec > 0 and out.shape == (8,)


@pytest.fixture(scope="module")
def gltf(tmp_path_factory):
    return _write_gltf(tmp_path_factory.mktemp("cli"))


def test_cli_matches_jax(gltf, tmp_path):
    """Both CLIs render the same glTF (textured MASK quad, decal, spot
    light) at 64x32 on the CPU with the sun and the shadow map, looking
    at the quad: the port's PNG holds JAX's to MIN_PSNR and is the image
    its CLI returns."""
    from incarnation_tpu.app import cli as jcli
    argv = ["--model", str(gltf), "--width", "64", "--height", "32",
            "--texture-max-dim", "64", "--sun", "2", "--no-sky",
            "--lookat", "1", "0.5", "-4.6", "1", "0.5", "-2.5", "--cpu"]
    jcli.main(argv + ["--out", str(tmp_path / "j.png")])
    res = tcli.main(argv + ["--out", str(tmp_path / "t.png")])
    t = tio.load_png(tmp_path / "t.png")
    assert t.shape == (32, 64, 3) and t.max() > 0
    assert tcompare.compare(tmp_path / "t.png",
                            tmp_path / "j.png") >= MIN_PSNR
    np.testing.assert_array_equal(t, res["color"].numpy())
    assert res["stats"]["peel_overflow"] == 0
    assert res["coverage"] > 0.2


def test_cli_pathtrace_resume_is_bit_identical(gltf, tmp_path):
    """--pathtrace with --pt-checkpoint after 1 of 2 samples, then
    --resume: the checkpoint and the PNG equal an uninterrupted 2-sample
    run's bit for bit."""
    base = ["--model", str(gltf), "--width", "32", "--height", "16",
            "--texture-max-dim", "64", "--no-sky", "--sun", "2",
            "--lookat", "1", "0.5", "-4.6", "1", "0.5", "-2.5",
            "--pathtrace", "--cpu"]
    full = tcli.main(base + ["--spp", "2", "--out", str(tmp_path / "f.png"),
                             "--pt-checkpoint", str(tmp_path / "f.npz")])
    ck = str(tmp_path / "r.npz")
    tcli.main(base + ["--spp", "1", "--out", str(tmp_path / "r1.png"),
                      "--pt-checkpoint", ck])
    resumed = tcli.main(base + ["--spp", "2", "--out",
                                str(tmp_path / "r.png"),
                                "--pt-checkpoint", ck, "--resume"])
    assert torch.equal(resumed["history"], full["history"])
    assert float(full["history"].max()) > 0
    np.testing.assert_array_equal(tio.load_png(tmp_path / "r.png"),
                                  tio.load_png(tmp_path / "f.png"))
    assert int(np.load(ck)["next_sample"]) == 2


# ---------------------------------------------------------------------------
# The web viewer, headless (cases as tests/test_viewer.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def running_viewer():
    host = SceneHost(scene=make_rich_scene(device="cpu"), cameras=[],
                     bounds_center=np.zeros(3, np.float32),
                     bounds_extent=np.asarray([8, 6, 8], np.float32),
                     directional_light_index=-1, name="rich")
    cfg = Config(enable_taa=True, sun_shadow_mode="map",
                 masked_depth_peels=1, envmap_resolution=16)
    server, state = tviewer.serve(host, cfg, width=128, height=64, port=0,
                                  block=False)
    t = threading.Thread(target=tviewer.render_loop,
                         args=(host, cfg, state, 128, 64),
                         kwargs=dict(device="cpu"), daemon=True)
    t.start()
    yield server.server_address[1], state, t
    state.quit = True
    t.join(timeout=60)
    server.shutdown()


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        return r.read(), dict(r.headers)


def _post(port, path, obj):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(obj).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.read()


def _wait_state(port, ok, seconds=120):
    deadline = time.time() + seconds
    while time.time() < deadline:
        st = json.loads(_get(port, "/state")[0])
        assert not st["error"], st["error"]
        if ok(st):
            return st
        time.sleep(0.2)
    raise AssertionError(f"viewer state never matched: {st}")


def test_viewer_page_frame_inputs_and_quit(running_viewer):
    """The page, a PNG frame of the right size, an orbit input that
    advances and changes the frame, an exposure set, a light edit, the
    preview tiles, and /quit, which ends the render loop."""
    port, state, thread = running_viewer
    page, _ = _get(port, "/")
    assert b"incarnation_tpu" in page and b"/frame.png" in page
    _wait_state(port, lambda st: st["seq"] >= 1)
    frame0, hdrs = _get(port, "/frame.png?seq=0")
    assert hdrs["Content-Type"] == "image/png"
    assert tpng.png_size(frame0) == (128, 64)
    seq0 = int(hdrs["X-Seq"])
    _post(port, "/input", {"cmd": "orbit", "dx": 60, "dy": 10})
    _post(port, "/input", {"cmd": "set", "key": "exposure", "value": 11.0})
    st = _wait_state(port, lambda st: st["seq"] > seq0
                     and st["panel"].get("exposure") == 11.0)
    frame1, _ = _get(port, f"/frame.png?seq={st['seq'] - 1}")
    assert not np.array_equal(tpng.decode_png(frame1),
                              tpng.decode_png(frame0))
    assert st["panel"]["fps"] > 0 and len(st["panel"]["lights"]) == 2
    _post(port, "/input", {"cmd": "light", "index": 0, "intensity": 77.0})
    _wait_state(port, lambda st: st["panel"]["lights"][0]["intensity"]
                == 77.0)
    st = _wait_state(port, lambda st: st["previews_seq"] >= 1)
    for name in ("env", "irr"):
        tile, hdrs = _get(port, f"/preview/{name}.png")
        assert hdrs["Content-Type"] == "image/png"
        assert tpng.png_size(tile) == (192, 96)
    _post(port, "/quit", {})
    thread.join(timeout=60)
    assert not thread.is_alive()
