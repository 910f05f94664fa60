#!/usr/bin/env python3
"""Smoke run of the PyTorch port (incarnation_tpu_torch) on one CUDA card.

    python3 chip_smoke.py             # what the port's chip check runs
    python3 chip_smoke.py --profile   # + a torch.profiler table of a frame

It builds the hand-written CUDA kernels from incarnation_tpu_torch/csrc,
builds the procedural atrium (289k triangles, 41 materials, 66 lights,
masked foliage, decals) onto the card and renders 8 TAA frames at 1920x1088
through render_frame, the port's raster frame in the bench configuration:
opaque raster, 8 masked depth peels, decals, resolve, the 1024 x 1024 sun
shadow map (K1's depth-only role), sky IBL, shadowed sun, clustered lights,
TAA and tonemap. The camera is the atrium's glTF camera with Halton jitter
and a small orbit every frame. It checks that the shadow map darkens the
frame.

Then it captures each kernel's inputs from one more frame, runs each kernel
and its plain PyTorch twin on those inputs on the card, compares them, times
both on the card's clock (device_ms), prints each kernel's bound (the work
its inputs need) and work diagnostics, and renders that frame again with
every kernel swapped for its twin and compares the images.

A second, small path (512x256, the port's scene/testing.py scene with a
BLEND quad) renders one forward-lighting frame with blend layers and both
debug draws, holds one blend-layer launch of K1 to its twin, renders one
frame per view mode and checks pick and highlight.

Then the BVH paths on the atrium: (a) the scene BVH built on the host;
(b) the path tracer (render_pathtrace) at the JAX bench's 640x360, one
warm-up sample and 8 timed ones, counted rays per second, K4 launches per
sample by role; (c) K4 against its twin on one sample's primary, bounce
and shadow traces (identical hits), timed, with its bound and steps per
ray; (d) one sample with K4 swapped for its twin (identical radiance);
(e) one 1920x1088 render_frame with RT sun shadows and HBAO through the
same BVH (RT shadows darken the frame, AO in [0, 1], unit bent normals,
the share of covered pixels where RT and shadow-map visibility agree).

Then the rest of the port: (g) the atrium's binary BVH (merged table) and
K4's binary role on the captured primary, bounce and shadow rays, against
its twin and against the wide layout's hits; (h) tools/pt_step_bench.py's
six traces at 640x360, K4's alpha role (pathtrace.AlphaFilter) against its
twin; (i) the CLI in-process on the atrium's glTF: 8 raster frames at
1920x1088 (the PNG equals render_frame on what the CLI built), an RT
shadow + HBAO frame, and a 4-sample path trace at 640x360 checkpointed
after 2 and resumed (equal to the uninterrupted run); (j) the web viewer
serving the atrium at 960x540 (the frame after an orbit input differs);
(k) band sharding over two devices (two cards if the machine shows them,
else cuda:0 twice): a 1920x1088 frame and a second TAA frame against the
single frame, a band-sharded path-traced sample (identical) and an
SPP-sharded round (the batch-mean rule within 1e-6).

It prints one JSON line of kernel figures; the last line is
{"ok": true, "device": {...}}. Any failed phase raises, and the script
exits non-zero without printing that line. It needs CUDA and the
repository around it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
ATRIUM_DIR = ROOT / ".content_cache" / "torch" / "atrium"

W, H = 1920, 1088
FRAMES = 8
PEELS = 8
ORBIT_RAD = 0.001          # camera yaw about a point ahead, per frame
SMALL_W, SMALL_H = 512, 256  # the forward / view-mode / debug-draw path
SMALL_PEELS = 4

# H100 SXM peaks (NVIDIA data sheet): HBM rate and float32 outside the
# tensor cores. Every kernel here is f32 CUDA-core work.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# float operations per unit of work, counted from the kernel sources
# (add, sub, mul, div, sqrt, min and max count one each; compares none):
# K1: 4 planes (3 edges + depth) x (2 mul + 2 add) per (pair, pixel) that
# the pair's triangle covers -- the tests no sub-tile rejection can avoid
K1_OPS_PER_PAIR_PIXEL = 16
# K2, per (covered pixel, light of its cluster), in the order csrc/
# clustered.cu spends them: distance 9; range falloff 6 (ranged lights);
# direction 4; spot window 11 (spot lights); NoL 7; the rest of the
# radiance and the BRDF 96. A light skipped as zero stops after the test
# that skips it.
K2_OPS_DIST, K2_OPS_RANGE, K2_OPS_DIR = 9, 6, 4
K2_OPS_SPOT, K2_OPS_NOL, K2_OPS_BRDF = 11, 7, 96
K3_OPS_PER_PIXEL = 45          # 3x4 reprojection, divide, 3-channel bilerp
# K4, counted from csrc/bvh.cu (a fused multiply-add counts two), for the
# slots these inputs fill (K4 also tests the empty ones, which need no
# work): a triangle test 46 per filled leaf slot the ray must test (two
# cross products at 9, four dot products at 5, the reciprocal 1, o - v0 3,
# three scalings by the reciprocal 3, u + v 1; with any hit, up to the
# accepted slot); a box test 24 per filled child slot of an internal row
# (per axis 2 subtractions, 2 multiplications, a min and a max, and the
# two running bounds) and 1 per internal row for its limit. A ray reads 24
# bytes (origin, direction) and writes 16 (t, tri, u, v).
K4_OPS_TRI = 46
K4_OPS_BOX = 24
K4_OPS_INTERNAL = 1
K4_RAY_BYTES = 24 + 16
PT_W, PT_H = 640, 360      # the JAX bench's path-tracing size (bench.py:156)
VIEW_W, VIEW_H = 960, 540  # the web viewer's frame
BAND_TRI_SHARE = 1e-3      # band_phase: see there
K2_RTOL = 1e-5             # K2 against its twin: see compare_kernels
PT_SAMPLES = 8             # timed samples, after one warm-up
# K4 launches per path-traced sample, by role (kernels/pathtrace.py): one
# primary trace, a closest-hit trace for each of the 3 further bounces,
# one any-hit shadow batch per bounce; up to 2 alpha continuations of each
# closest-hit trace and 1 of each shadow batch
PT_LAUNCHES = {"pt_primary": (1, 1), "pt_bounce": (3, 3),
               "pt_shadow": (4, 4), "pt_primary_peel": (0, 2),
               "pt_bounce_peel": (0, 6), "pt_shadow_peel": (0, 4)}
# cycles a spin kernel runs per second at the H100 SXM's highest SM clock
# (1.98 GHz): at a lower clock the spin lasts longer, never shorter
SPIN_CYCLES_PER_S = 2.0e9


def _log(msg):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def device_ms(fn, reps: int) -> float:
    """Mean ms per fn() call on the card's clock: CUDA events around reps
    back-to-back calls, queued behind a spin kernel that holds the stream
    for three times the host's time to launch them, so the card runs them
    back to back and a small launch is not timed by the host that launches
    it. The time between the events is every kernel's, memset's and copy's,
    and the gaps between them. A call that synchronises inside (a plain
    twin reading a count) waits for the card there, and then its time
    includes the host's. A warm-up call first, then one batch whose time
    on the host sets the spin's; L2 is not flushed."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(SPIN_CYCLES_PER_S * (3.0 * host_s + 2e-3)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bench_view(host, width, height):
    """The scene's first glTF camera (the atrium ships one), else a default
    look-at, as the JAX bench frames it."""
    from incarnation_tpu_torch.core.view import View
    if host.cameras:
        c = host.cameras[0]
        return View(position=np.asarray(c["position"], np.float32),
                    right=np.asarray(c["right"], np.float32),
                    up=np.asarray(c["up"], np.float32),
                    look=np.asarray(c["look"], np.float32),
                    aspect=width / height)
    return View.from_lookat([0.0, 4.0, -14.0], [0.0, 0.0, 0.0],
                            aspect=width / height)


def orbit(view0, angle: float, radius: float = 6.0):
    """view0 yawed by `angle` about a vertical axis `radius` ahead of it."""
    import dataclasses
    v = dataclasses.replace(view0)
    pivot = view0.position + radius * view0.look
    v.rotate(yaw=angle)
    v.position = (pivot - radius * v.look).astype(np.float32)
    return v


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile one frame with torch.profiler")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs the port on a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from incarnation_tpu_torch.core import mathutils as mu
    from incarnation_tpu_torch.kernels import (build, bvh, clustered, raster,
                                               shadow, taa)

    # 1. the card
    dev = torch.device("cuda")
    card = card_line()
    _log(f"card: {card}")
    kind = torch.cuda.get_device_name(0)

    # 2. kernels, one nvcc per source, all started together
    secs, logs = build.timed_build(verbose=True)
    _log(f"kernels built in {secs:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                _log(f"  {name}: {line.strip()}")

    # 3-5. the atrium and the bench configuration
    path = atrium_path(dev)
    scene, run, make_fc = path.scene, path.run, path.make_fc
    cfg = path.cfg

    # two warm-up frames, the second with a history, load every kernel
    # library and torch's own lazily loaded code before anything is timed
    fc0 = make_fc(0, None)
    warm = run(fc0, torch.zeros((H, W, 3), device=dev))
    run(make_fc(1, fc0.view_proj.cpu().numpy()), warm["accumulation"])
    torch.cuda.synchronize()

    kernels = (raster.K1, clustered.K2, taa.K3, bvh.K4)
    for k in kernels:
        k.reset()
    history = torch.zeros((H, W, 3), device=dev)
    prev_vp, frame_ms, outs, per_frame = None, [], [], []
    outs_history = []
    for i in range(FRAMES):
        before = [k.launches for k in kernels]
        fc = make_fc(i, prev_vp)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = run(fc, history)
        end.record()
        torch.cuda.synchronize()
        frame_ms.append(start.elapsed_time(end))
        outs.append(out["stats"])
        outs_history.append(history)
        history = out["accumulation"]
        prev_vp = fc.view_proj.cpu().numpy()
        per_frame.append([k.launches - n for k, n in zip(kernels, before)])
    launches = {k.fn: k.launches for k in kernels}
    if launches.pop("k4_trace"):
        raise RuntimeError("the raster frame launched K4")
    k1_by_layer = dict(raster.K1.by_name)
    _log(f"launches on the main path: {launches}, K1 by layer {k1_by_layer}")
    _log("frame ms: " + ", ".join(f"{t:.2f}" for t in frame_ms))

    for i, st in enumerate(outs):
        for key in ("bin_overflow", "big_overflow", "peel_overflow",
                    "shadow_bin_overflow"):
            if int(st[key]) != 0:
                raise RuntimeError(f"frame {i}: {key} = {int(st[key])}")
    last = outs[-1]
    _log("stats of the last frame: "
         + json.dumps({k: int(v) for k, v in last.items()}))
    hdr = out["hdr"]
    if tuple(hdr.shape) != (H, W, 3) or not bool(torch.isfinite(hdr).all()):
        raise RuntimeError("hdr is not a finite (H, W, 3) image")
    if tuple(out["color"].shape) != (H, W, 3) \
            or out["color"].dtype != torch.uint8:
        raise RuntimeError("color is not an (H, W, 3) uint8 image")
    covered = float((out["tri"] >= 0).float().mean())
    _log(f"covered pixels {covered:.4f}; mean colour "
         f"{out['color'].float().mean().item():.2f}")
    if covered < 0.5:
        raise RuntimeError("the atrium frame is mostly empty")
    # per frame: K1 for the opaque layer, each peel, the decals and the
    # shadow map, K2 once, K3 on every frame with a history (all but
    # frame 0), K4 never (no BVH on this path)
    want = [[3 + PEELS, 1, int(i > 0), 0] for i in range(FRAMES)]
    if per_frame != want:
        raise RuntimeError(f"launches per frame (K1, K2, K3, K4) "
                           f"{per_frame} != {want}")
    if k1_by_layer != {"raster_opaque": FRAMES, "raster_decal": FRAMES,
                       "raster_peel": FRAMES * PEELS,
                       "raster_shadow_depth": FRAMES}:
        raise RuntimeError(f"K1 layers {k1_by_layer}")

    # 5b. the shadow map does something: some, not all, covered pixels of
    # the last frame are in shadow, and the frame is darker than the same
    # frame without the map
    gb = out["gbuffer"]
    smap, _ = shadow.render_sun_shadow_map(
        scene, fc.scene_rotation, fc.sun_view_proj,
        shadow.shadow_params(cfg.shadow_map_resolution, cfg))
    vis = shadow.sun_visibility(
        gb.world_pos, torch.sum(mu.oct_decode(gb.normals) * fc.sun_dir, -1),
        smap, fc.sun_view_proj, cfg.shadow_map_resolution)
    shadowed = float((vis[gb.mask] == 0).float().mean())
    unshadowed = run(fc, outs_history[-1],
                     cfg.replace(sun_shadow_mode="off"))["hdr"]
    mean_on, mean_off = float(hdr.mean()), float(unshadowed.mean())
    _log(f"sun shadow map: {shadowed:.4f} of the covered pixels in shadow; "
         f"mean hdr {mean_on:.2f} with the map, {mean_off:.2f} without")
    if not 0.0 < shadowed < 1.0:
        raise RuntimeError("the shadow map shadows none or all of the frame")
    if not mean_on < mean_off:
        raise RuntimeError("the shadow map does not darken the frame")

    # 6. each kernel against its twin on one frame's real inputs
    fc = make_fc(FRAMES, prev_vp)
    calls = capture_frame(run, fc, history, raster, clustered, taa)
    rows = compare_kernels(calls, raster, clustered, taa, launches,
                           k1_by_layer)
    check_twin_frame(run, fc, history, raster, clustered, taa)
    if args.profile:
        profile_frame(run, fc, history)

    # 7. the small path: forward lighting with blend layers and the debug
    # draws, every view mode, pick and highlight
    rows.insert(4, small_path(dev, raster, clustered, taa))

    # 8. the BVH paths: the path tracer, then RT shadows and HBAO
    bvh_rows, pt = bvh_paths(dev, path, args.profile)
    rows += bvh_rows

    # 9. the rest of the port: the binary BVH and the alpha role of K4,
    # the CLI, the web viewer and band sharding
    rows += binary_phase(dev, path, pt)
    rows += alpha_phase(dev, path, pt)
    cli_phase(dev, path)
    viewer_phase(dev, path)
    rows += band_phase(dev, path, pt)
    # a bound counts the least work the inputs need: no kernel beats it
    shares = {r["name"]: r["bound_ms"] / r["ms"] for r in rows}
    _log("bound share (bound ms / ms): " + json.dumps(
        {k: round(v, 4) for k, v in shares.items()}))
    over = {k: v for k, v in shares.items() if v > 1.0}
    if over:
        raise RuntimeError(f"kernels faster than their bound: {over}")
    _log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
         " GiB")
    _log(json.dumps({"kernels": rows}))
    _log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def atrium_path(dev):
    """The main path's set-up: the atrium built on the host and moved to the
    card, the sky probe and env BRDF, and the bench configuration's frame.
    -> namespace(host, scene, cfg, params, run(fc, history[, config]),
    make_fc(i, prev_view_proj))."""
    import types
    import torch
    from incarnation_tpu_torch.config import Config
    from incarnation_tpu_torch.core import mathutils as mu
    from incarnation_tpu_torch.kernels import ibl, raster, sky
    from incarnation_tpu_torch.renderer import frame
    from incarnation_tpu_torch.scene import cache, stress
    cfg = Config(sun_shadow_mode="map", masked_depth_peels=PEELS)
    t0 = time.perf_counter()
    path = stress.build_atrium(ATRIUM_DIR)
    host = cache.load_scene_cached(path, texture_max_dim=cfg.texture_max_dim,
                                   device=dev)
    torch.cuda.synchronize()
    scene = host.scene
    meta = scene.meta
    _log(f"scene: {meta.num_triangles} triangles, {meta.num_lights} lights, "
         f"{scene.mat_params.shape[0]} materials, "
         f"{scene.nbytes() / 2**20:.1f} MiB on the card, host build + load "
         f"{time.perf_counter() - t0:.1f} s")
    if not (meta.has_masked and meta.has_decals and meta.num_lights > 0):
        raise RuntimeError("the atrium lost its masked, decal or light layer")

    # sky probe and env BRDF, as the JAX bench builds them
    t0 = time.perf_counter()
    sun = scene.sun_dir.cpu().numpy()
    probe = cache.load_probe_cached(
        lambda: ibl.build_probe(
            sky.sky_latlong(scene.sun_dir, cfg.turbidity, 256, 128),
            envmap_size=cfg.envmap_resolution),
        key=f"sky:{sun.round(4).tolist()}:{cfg.turbidity}:"
            f"{cfg.envmap_resolution}", device=dev)
    env_brdf = ibl.pack_env_brdf(ibl.env_brdf_lut(128, device=dev))
    torch.cuda.synchronize()
    _log(f"probe + env BRDF built in {time.perf_counter() - t0:.1f} s")

    # the bench configuration, sun shadow map on
    params = raster.RasterParams(width=W, height=H, pair_capacity=1 << 18,
                                 bin_max_span=8)
    view0 = bench_view(host, W, H)
    jitters = mu.halton_jitter_table(16)
    shadow_bounds = (host.bounds_center,
                     float(np.linalg.norm(host.bounds_extent)) + 1e-3)

    def make_fc(i, prev_vp):
        return frame.FrameConstants.make(
            orbit(view0, ORBIT_RAD * i), cfg, sun_dir=sun,
            sun_color_intensity=[1.0, 1.0, 1.0, 100.0],
            jitter=jitters[i % 16] * 2.0 / np.array([W, H]),
            prev_view_proj=prev_vp, history_valid=i > 0, frame_index=i,
            shadow_bounds=shadow_bounds, device=dev)

    def run(fc, history, config=cfg, scene_bvh=None):
        return frame.render_frame(scene, fc, config=config, params=params,
                                  probe=probe, env_brdf=env_brdf,
                                  history=history, scene_bvh=scene_bvh)

    return types.SimpleNamespace(host=host, scene=scene, cfg=cfg,
                                 params=params, run=run, make_fc=make_fc,
                                 probe=probe, env_brdf=env_brdf, sun=sun,
                                 shadow_bounds=shadow_bounds)


def capture_frame(run, fc, history, raster, clustered, taa):
    """Run one frame with each kernel wrapper wrapped to record its
    arguments; returns [(kind, args, kwargs)] in launch order."""
    import torch
    calls = []
    with _capturing(calls, raster, clustered, taa):
        run(fc, history)
    torch.cuda.synchronize()
    return calls


@contextlib.contextmanager
def _capturing(calls, raster, clustered, taa, limit=None):
    """For the duration of the block, each K1, K2 and K3 wrapper call
    appends (kind, args, kwargs) to calls, at most `limit` per kind."""
    def keep(kind):
        def after(out, *a, **kw):
            if limit is None or sum(c[0] == kind for c in calls) < limit:
                calls.append((kind, a, kw))
        return after
    with contextlib.ExitStack() as stack:
        for mod, name, kind in ((raster, "rasterize_tiles", "k1"),
                                (clustered, "clustered_lighting", "k2"),
                                (taa, "history_fetch", "k3")):
            stack.enter_context(_hooked(mod, name, keep(kind)))
        yield calls


def _k1_bound(bins, params, z_limit, mask_table):
    """(bound ms, 'bytes' | 'operations') of one K1 launch on these bins:
    the pair lists, setup and attribute rows of the triangles they name and
    the z limits read once, 72 B/px of outputs written once (the depth-only
    role: no attribute rows, 8 B/px); 16 operations per (pair, tile pixel)
    that the pair's triangle covers (raster.covered_pair_pixels: the exact
    edge and depth test, z_limit and amask tests set aside, over the tiles
    that run -- a peel skips tiles whose limits are all 0)."""
    import torch
    from incarnation_tpu_torch.kernels import raster
    p = params
    counts = bins.counts.long()
    nt = p.num_tiles
    nbig = int(bins.big_count[0])
    live = torch.ones(nt, dtype=torch.bool, device=counts.device)
    if z_limit is not None:
        live = raster._tile_limits(z_limit, p).amax(dim=1) > 0.0
    counts = torch.where(live, counts, 0)
    n_live = int(live.sum())
    tiles = torch.repeat_interleave(torch.arange(nt, device=counts.device),
                                    counts)
    first = torch.cumsum(counts, 0) - counts
    pos = bins.starts.long()[tiles] + torch.arange(
        tiles.shape[0], device=counts.device) - first[tiles]
    used = torch.cat([bins.pair_tri.long()[pos],
                      bins.big_tri.long()[:nbig if n_live else 0]])
    n_tris = int(torch.unique(used).numel())
    rows, chans = ((raster.SETUP_ROWS, 0) if p.depth_only else
                   (raster.SETUP_ROWS + raster.ATTR_ROWS,
                    raster.INTERP_CHANNELS))
    nbytes = (4 * (int(counts.sum()) + nbig) + 8 * nt + 4 * n_tris * rows
              + p.width * p.height * (4 + 4 + 4 * chans))
    if z_limit is not None:
        nbytes += 4 * p.width * p.height
    if mask_table is not None:
        nbytes += mask_table.numel() * 4
    ops = K1_OPS_PER_PAIR_PIXEL * raster.covered_pair_pixels(bins, p, z_limit)
    return _bound(nbytes, ops)


def _bound(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def compare_kernels(calls, raster, clustered, taa, launches, k1_by_layer):
    """Each captured call: kernel vs twin on the card (error, both times,
    the bound); returns the JSON rows."""
    import torch
    rows = []
    k1_calls = [c for c in calls if c[0] == "k1"]
    layers = {}
    for kind, a, kw in k1_calls:
        layers.setdefault(kw.get("name", "fine_raster"), []).append((a, kw))
    want = ["raster_decal", "raster_opaque", "raster_peel",
            "raster_shadow_depth"]
    if sorted(layers) != want:
        raise RuntimeError(f"captured K1 layers {sorted(layers)}")
    (sa, _), = layers["raster_shadow_depth"]
    _log(f"sun shadow pass: {int(sa[0].counts.sum())} tile pairs of a "
         f"capacity of {sa[1].pair_capacity}")
    for layer in ("raster_opaque", "raster_peel", "raster_decal",
                  "raster_shadow_depth"):
        rows.append(k1_row(raster, layer, layers[layer], k1_by_layer[layer]))

    (_, a, kw), = [c for c in calls if c[0] == "k2"]
    got = clustered.clustered_lighting(*a, **kw)
    ref = clustered.clustered_lighting_plain(*a, **kw)
    # the same light sums and dot products in the same order
    # (mathutils.dot3); K2 takes D x G / (4 NoV NoL) in one division where
    # the twin divides three times, a few ulps after the ulp-sensitive NoH
    err, rel = _close("K2", got, ref, rtol=K2_RTOL, atol_frac=1e-5,
                      where=a[0].mask)
    _log(f"K2: max abs err {err:.3e}, max relative err {rel:.3e} "
         f"(peak {float(ref.abs().max()):.3e})")
    k2_ops, k2_diag = _k2_work(*a, **kw)
    _log("K2 work: " + json.dumps(k2_diag))
    rows.append(dict(
        name="k2_clustered", route="cuda",
        source="incarnation_tpu_torch/csrc/clustered.cu",
        replaces="incarnation_tpu/kernels/clustered.py:526",
        launches=launches["k2_clustered"], max_abs_err=err, max_rel_err=rel,
        ms=device_ms(lambda: clustered.clustered_lighting(*a, **kw), 20),
        plain_ms=device_ms(lambda: clustered.clustered_lighting_plain(
            *a, **kw), 3),
        **dict(zip(("bound_ms", "bound_by"), _k2_bound(k2_ops, *a, **kw))),
        library_ms=None))

    (_, a, kw), = [c for c in calls if c[0] == "k3"]
    rows.append(k3_row(taa, a, "k3_taa_fetch", launches["k3_taa_fetch"]))
    return rows


def k3_row(taa, a, name, n_launches):
    """K3 against its twin on one captured launch (history, depth, m, w, h
    and, for a band, its y_off halo rows), both timed, with its bound and
    grid_sample's time on the same fetch -> the JSON row."""
    import torch
    history, depth, m, w, h, *rest = a
    y_off = rest[0] if rest else 0
    got = taa.history_fetch(*a)
    ref = taa.history_fetch_plain(*a)
    # the same f32 operations in the same order (K3 built --fmad=false)
    err, rel = _close(name, got, ref, rtol=1e-6, atol_frac=1e-7)
    _log(f"{name}: {w}x{h}, {y_off} halo rows each way; max abs err "
         f"{err:.3e}, max relative err {rel:.3e} (peak "
         f"{float(ref.abs().max()):.3e})")
    uv = taa.reproject_uv(depth, m, w, h)
    # the halo rows extend the image grid_sample clamps at its border
    gy = (uv[..., 1] * h + y_off) / (h + 2 * y_off)
    grid = (2.0 * torch.stack([uv[..., 0], gy], -1) - 1.0)[None]
    img = history.permute(2, 0, 1)[None].contiguous()

    def library():
        return torch.nn.functional.grid_sample(
            img, grid, mode="bilinear", padding_mode="border",
            align_corners=False)

    lib_err = float((library()[0].permute(1, 2, 0) - ref).abs().max())
    _log(f"{name} library yardstick (grid_sample on the reprojected grid): "
         f"max abs diff from the twin {lib_err:.3e}")
    return dict(
        name=name, route="cuda",
        source="incarnation_tpu_torch/csrc/taa.cu",
        replaces="incarnation_tpu/kernels/taa.py:195",
        launches=n_launches, max_abs_err=err, max_rel_err=rel,
        ms=device_ms(lambda: taa.history_fetch(*a), 50),
        plain_ms=device_ms(lambda: taa.history_fetch_plain(*a), 10),
        **dict(zip(("bound_ms", "bound_by"), _bound(
            w * h * (12 + 4 + 12) + 64, K3_OPS_PER_PIXEL * w * h))),
        library_ms=device_ms(library, 50))


def k1_row(raster, layer, launches_captured, n_launches):
    """Kernel-vs-twin on the captured K1 launches of one raster layer
    (error, both times and the bound, each the mean over the launches)
    -> the layer's JSON row."""
    errs, ms, plain_ms, bounds, bound_by = [], [], [], [], set()
    for a, kw in launches_captured:
        bins, p = a
        zl, mt = kw.get("z_limit"), kw.get("mask_table")
        got = raster.rasterize_tiles(bins, p, z_limit=zl, mask_table=mt)
        ref = raster.rasterize_tiles_plain(bins, p, z_limit=zl,
                                           mask_table=mt)
        errs.append(_k1_error(got, ref))
        ms.append(device_ms(lambda: raster.rasterize_tiles(
            bins, p, z_limit=zl, mask_table=mt), 10))
        plain_ms.append(device_ms(lambda: raster.rasterize_tiles_plain(
            bins, p, z_limit=zl, mask_table=mt), 2))
        b, by = _k1_bound(bins, p, zl, mt)
        bounds.append(b)
        bound_by.add(by)
    bins, p = launches_captured[0][0]
    items, largest = raster.k1_work_items(bins, p)
    _log(f"K1 {layer}: per launch ms " + ", ".join(f"{t:.4f}" for t in ms)
         + "; bound ms " + ", ".join(f"{t:.4f}" for t in bounds)
         + "; tri mismatch share "
         + ", ".join(f"{e[2]:.2e}" for e in errs)
         + f"; {int(bins.counts.sum())} pairs in {p.num_tiles} tiles of "
         f"{p.tile_h}x{p.tile_w}, at most {int(bins.counts.max())} in one, "
         f"+ {int(bins.big_count[0])} big triangles in every tile; "
         f"{items} work items of at most {raster.K1_ITEM_PAIRS} pairs, the "
         f"largest {largest} (first launch)")
    return dict(
        name=f"k1_raster[{layer}]", route="cuda",
        source="incarnation_tpu_torch/csrc/raster.cu",
        replaces="incarnation_tpu/kernels/raster.py:1077",
        launches=n_launches,
        max_abs_err=max(e[0] for e in errs),
        max_rel_err=max(e[1] for e in errs),
        ms=float(np.mean(ms)), plain_ms=float(np.mean(plain_ms)),
        bound_ms=float(np.mean(bounds)),
        bound_by="operations" if "operations" in bound_by else "bytes",
        library_ms=None)


def small_renderer(dev):
    """The small path's scene (the port's scene/testing.py scene with a
    BLEND quad) and render(**Config overrides) of one 512x256 frame.
    -> (scene, render)."""
    from incarnation_tpu_torch.config import Config
    from incarnation_tpu_torch.core.view import View
    from incarnation_tpu_torch.kernels import raster
    from incarnation_tpu_torch.renderer import frame
    from incarnation_tpu_torch.scene import testing
    w, h = SMALL_W, SMALL_H
    scene = testing.make_rich_scene(device=dev, blend_quad=True)
    if not scene.meta.has_blend:
        raise RuntimeError("the small scene lost its BLEND quad")
    params = raster.RasterParams(width=w, height=h, pair_capacity=4096,
                                 bin_max_span=8, big_tri_capacity=64)
    base = dict(masked_depth_peels=SMALL_PEELS, sun_shadow_mode="map",
                shadow_map_resolution=256, enable_taa=False)
    sun = np.asarray([0.2, 0.8, -0.55], np.float32)
    view = View.from_lookat([0.0, 1.0, 1.0], [0.0, 0.0, 7.0], aspect=w / h)

    def render(**kw):
        cfg = Config(**dict(base, **kw))
        fc = frame.FrameConstants.make(
            view, cfg, sun_dir=sun / np.linalg.norm(sun),
            sun_color_intensity=[1.0, 1.0, 1.0, 100.0],
            shadow_bounds=([0.0, 0.75, 8.0], 13.0), device=dev)
        return frame.render_frame(scene, fc, config=cfg, params=params)

    return scene, render


def small_path(dev, raster, clustered, taa):
    """The forward / view-mode / debug-draw path on the port's own test
    scene with a BLEND quad, 512x256, every launch on the card. Returns the
    k1_raster[raster_blend] row (its launches are this path's)."""
    import torch
    from incarnation_tpu_torch.config import ViewMode
    from incarnation_tpu_torch.renderer import frame
    w, h = SMALL_W, SMALL_H
    scene, render = small_renderer(dev)

    def check_color(out, what):
        c = out["color"]
        if tuple(c.shape) != (h, w, 3) or c.dtype != torch.uint8:
            raise RuntimeError(f"{what}: colour is not an (H, W, 3) uint8")
        for key in ("hdr", "accumulation"):
            if not bool(torch.isfinite(out[key]).all()):
                raise RuntimeError(f"{what}: {key} is not finite")

    # forward lighting with blend layers and both debug draws
    fwd = dict(forward_lighting=True, show_light_bounds=True,
               show_object_bounds=True)
    render(**fwd)                               # warm-up
    kernels = (raster.K1, clustered.K2, taa.K3)
    for k in kernels:
        k.reset()
    calls = capture_frame(lambda fc, history: render(**fwd), None, None,
                          raster, clustered, taa)
    by_name, k2_launches = dict(raster.K1.by_name), clustered.K2.launches
    out = render(**fwd)
    check_color(out, "forward frame")
    stats = {k: int(v) for k, v in out["stats"].items()}
    _log(f"small path, forward frame: K1 by layer {by_name}, K2 "
         f"{k2_launches} launches; stats {json.dumps(stats)}")
    if by_name.get("raster_blend") != SMALL_PEELS:
        raise RuntimeError(f"raster_blend launches {by_name}")
    # K2 shades the opaque surface and each blend layer
    if by_name.get("raster_shadow_depth") != 1 \
            or k2_launches != 1 + SMALL_PEELS:
        raise RuntimeError(f"small path launches {by_name}")
    if stats["debug_draws"] <= 0:
        raise RuntimeError("no debug draw was appended")
    for key in ("bin_overflow", "big_overflow", "peel_overflow",
                "shadow_bin_overflow"):
        if stats[key] != 0:
            raise RuntimeError(f"small path: {key} = {stats[key]}")
    no_wires = render(forward_lighting=True)
    wires = int((out["color"] != no_wires["color"]).any(-1).sum())
    blend = int(((out["hdr"] - render(forward_lighting=False)["hdr"]).abs()
                 .sum(-1) > 0).sum())
    _log(f"small path: {wires} wireframe pixels, {blend} pixels differ "
         "between the forward (blend layers) and the deferred frame")
    if wires == 0 or blend == 0:
        raise RuntimeError("the debug draws or the blend layers drew nothing")
    blends = [(a, kw) for kind, a, kw in calls
              if kind == "k1" and kw.get("name") == "raster_blend"]
    if len(blends) != SMALL_PEELS or blends[0][1].get("mask_table") \
            is not None or blends[0][1].get("z_limit") is None:
        raise RuntimeError("the blend layers are not z_limit peels")
    row = k1_row(raster, "raster_blend", blends, by_name["raster_blend"])

    # one frame per view mode
    modes = {n: v for n, v in vars(ViewMode).items()
             if isinstance(v, int) and not n.startswith("_")}
    if len(modes) != 14:
        raise RuntimeError(f"{len(modes)} view modes")
    means = {}
    for name, vm in sorted(modes.items(), key=lambda kv: kv[1]):
        o = render(viewmode=vm)
        check_color(o, f"view mode {name}")
        means[name] = round(float(o["color"].float().mean()), 2)
        if name == "OBJECT_IDS":
            covered = o["tri"] >= 0
            if not bool(o["color"][covered].sum(-1).min() > 0):
                raise RuntimeError("OBJECT_IDS is black on geometry")
            ids = o
    _log(f"small path, mean u8 colour per view mode: {json.dumps(means)}")

    # pick at a covered pixel, highlight of that primitive
    ys, xs = torch.nonzero(ids["tri"] >= 0, as_tuple=True)
    mid = ys.numel() // 2
    x, y = int(xs[mid]), int(ys[mid])
    prim, local, meshlet = frame.pick(scene, ids["tri"], x, y)
    if prim < 0 or local < 0 or meshlet < 0:
        raise RuntimeError(f"pick({x}, {y}) found nothing on a covered pixel")
    if frame.pick(scene, torch.full_like(ids["tri"], -1), x, y) \
            != (-1, -1, -1):
        raise RuntimeError("pick on an empty map found something")
    lit = frame.highlight(ids["color"], ids["tri"], scene, prim)
    changed = (lit != ids["color"]).any(-1)
    owner = scene.tri_prim[ids["tri"].clamp(min=0).long()]
    own = (ids["tri"] >= 0) & (owner == prim)
    _log(f"small path: pick({x}, {y}) = prim {prim}, triangle {local}, "
         f"meshlet {meshlet}; highlight changed {int(changed.sum())} of its "
         f"{int(own.sum())} pixels")
    if not bool(changed.any()) or bool((changed & ~own).any()):
        raise RuntimeError("highlight changed other pixels than the picked "
                           "primitive's")
    torch.cuda.synchronize()
    return row


def bvh_paths(dev, path, profile: bool):
    """Phases (a)-(e) on the atrium: the scene BVH, the path tracer at
    PT_W x PT_H, K4 against its twin, a sample with the twin, and the RT
    shadow + HBAO frame at W x H. Returns (K4's JSON rows, one per role;
    namespace(sbvh, calls: the captured K4 launches of one sample by role,
    fc: the path tracer's constants, history: its accumulation))."""
    import types
    import torch
    from incarnation_tpu_torch.kernels import bvh, hbao, pathtrace, shadow
    from incarnation_tpu_torch.renderer import frame
    from incarnation_tpu_torch.core import mathutils as mu

    # (a) the scene BVH, built on the host and moved to the card
    t0 = time.perf_counter()
    sbvh = bvh.build_scene_bvh(path.scene, device=dev)
    torch.cuda.synchronize()
    rows_np = sbvh.rows[:, bvh._W_FLAG].cpu()
    n_leaf = int((rows_np > 0.5).sum())
    _log(f"(a) atrium BVH: {sbvh.rows.shape[0]} rows ({n_leaf} leaves, "
         f"{sbvh.rows.shape[0] - n_leaf} 8-wide internal), "
         f"{sbvh.nbytes() / 2**20:.2f} MiB on the card, built on the host "
         f"in {time.perf_counter() - t0:.1f} s")

    # (b) the path tracer, as the JAX bench runs it (bench.py:145-190)
    cfg = path.cfg
    fc = fc_pt = frame.FrameConstants.make(
        bench_view(path.host, PT_W, PT_H), cfg, sun_dir=path.sun,
        sun_color_intensity=[1.0, 1.0, 1.0, 100.0],
        shadow_bounds=path.shadow_bounds, device=dev)

    def sample(i, history):
        return frame.render_pathtrace(path.scene, sbvh, fc, history, i,
                                      config=cfg, width=PT_W, height=PT_H,
                                      probe=path.probe)

    truncs = []
    with _hooked(bvh, "trace", lambda out, *a, **kw: truncs.append(
            out["trunc"])):
        history = sample(0, torch.zeros((PT_H, PT_W, 3), device=dev))[
            "history"]
        torch.cuda.synchronize()
        bvh.K4.reset()
        rays, per_sample = [], []
        t0 = time.perf_counter()
        for i in range(1, 1 + PT_SAMPLES):
            before = dict(bvh.K4.by_name)
            out = sample(i, history)
            history = out["history"]
            rays.append(out["rays"])
            per_sample.append({k: bvh.K4.by_name.get(k, 0) - before.get(k, 0)
                               for k in bvh.K4.by_name})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    pt_launches = dict(bvh.K4.by_name)
    n_rays = float(torch.stack(rays).sum())
    _log(f"(b) path tracer {PT_W}x{PT_H}: {PT_SAMPLES} samples in "
         f"{wall * 1e3:.1f} ms ({wall / PT_SAMPLES * 1e3:.1f} ms per "
         f"sample), counted rays per sample "
         + ", ".join(f"{float(r):.0f}" for r in rays)
         + f"; {n_rays / wall / 1e6:.4f} Mray/s")
    _log(f"(b) K4 launches per sample by role: {json.dumps(per_sample)}")
    for i, got in enumerate(per_sample):
        for role, (lo, hi) in PT_LAUNCHES.items():
            if not lo <= got.get(role, 0) <= hi:
                raise RuntimeError(f"sample {i}: {got.get(role, 0)} K4 "
                                   f"launches as {role}, not in [{lo}, {hi}]")
        if set(got) - set(PT_LAUNCHES):
            raise RuntimeError(f"sample {i}: K4 roles {sorted(got)}")
    bad = [int(t) for t in truncs if int(t) != 0]
    _log(f"(b) trunc over the {len(truncs)} traces: {sum(bad)}")
    if bad:
        raise RuntimeError(f"{len(bad)} traces stopped rays at the step "
                           f"budget: {bad}")
    color = out["color"]
    neg = int((history < 0).any(-1).sum())
    _log(f"(b) history: min {float(history.min()):.4g}, max "
         f"{float(history.max()):.4g}, mean {float(history.mean()):.4g}, "
         f"{neg} pixels with a negative channel; mean u8 colour "
         f"{float(color.float().mean()):.2f}")
    if not bool(torch.isfinite(history).all()) or neg:
        raise RuntimeError("the path-traced history is not finite and >= 0")
    if float(color.float().mean()) < 2.0:
        raise RuntimeError("the path-traced image is black")

    # (c) K4 against its twin on one sample's launches
    pt_history = history
    calls = {}

    def keep(out, bvh_, o, d, tmin=0.0, tmax=1e30, any_hit=False,
             role=None, alpha_of=None, **kw):
        calls.setdefault(role, (bvh_, o, d, tmin, tmax, any_hit, alpha_of))
    with _hooked(bvh, "trace_k4", keep):
        sample(PT_SAMPLES + 1, history)
    rows = [k4_row(bvh, calls[role], role, pt_launches.get(role, 0))
            for role in ("pt_primary", "pt_bounce", "pt_shadow",
                         "pt_primary_peel") if role in calls]

    # (d) one sample with K4 swapped for its twin
    got = sample(PT_SAMPLES + 1, history)["history"]
    with _swapped(bvh, "trace_k4", _k4_twin(bvh)):
        ref = sample(PT_SAMPLES + 1, history)["history"]
    torch.cuda.synchronize()
    diff = float((got - ref).abs().max())
    _log(f"(d) a sample with K4 against the same sample with its twin: "
         f"identical {bool(torch.equal(got, ref))}, max abs diff {diff:.3e}")
    if not torch.equal(got, ref):
        raise RuntimeError("the sample with K4 differs from the twin's")
    if profile:
        profile_pt(sample, history, bvh, pathtrace)

    # (e) the raster frame with RT sun shadows and HBAO, W x H
    rt_cfg = cfg.replace(sun_shadow_mode="rt", enable_hbao=True,
                         use_bent_normals=True)
    fc = path.make_fc(0, None)
    hist0 = torch.zeros((H, W, 3), device=dev)
    path.run(fc, hist0, rt_cfg, sbvh)                    # warm-up
    for k in (bvh.K4,):
        k.reset()
    rt_calls = {}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with _hooked(bvh, "trace_k4", lambda out, bvh_, o, d, tmin=0.0,
                 tmax=1e30, any_hit=False, role=None, alpha_of=None, **kw:
                 rt_calls.setdefault(role, (bvh_, o, d, tmin, tmax,
                                            any_hit, alpha_of))):
        start.record()
        out = path.run(fc, hist0, rt_cfg, sbvh)
        end.record()
        torch.cuda.synchronize()
    rt_launches = dict(bvh.K4.by_name)
    _log(f"(e) RT shadow + HBAO frame {W}x{H}: {start.elapsed_time(end):.2f}"
         f" ms, K4 launches by role {json.dumps(rt_launches)}")
    if rt_launches.get("rt_sun") != 1 or not 1 <= rt_launches.get(
            "hbao", 0) <= 2 * hbao.NUM_SLICES * hbao.MAX_TRACES_PER_SLICE:
        raise RuntimeError(f"RT frame K4 launches {rt_launches}")
    for key in ("bin_overflow", "big_overflow", "peel_overflow"):
        if int(out["stats"][key]) != 0:
            raise RuntimeError(f"RT frame: {key} = {int(out['stats'][key])}")
    hdr = out["hdr"]
    off = path.run(fc, hist0, rt_cfg.replace(sun_shadow_mode="off"),
                   sbvh)["hdr"]
    gb = out["gbuffer"]
    ao, bent = hbao.hbao(sbvh, gb, out["depth"], fc, W, H)
    m = gb.mask
    ao_mean = float(ao[m].mean())
    bent_len = torch.linalg.vector_norm(mu.oct_decode(bent)[m], dim=-1)
    vis_rt = frame.rt_sun_visibility(path.scene, sbvh, gb, fc)
    smap, _ = shadow.render_sun_shadow_map(
        path.scene, fc.scene_rotation, fc.sun_view_proj,
        shadow.shadow_params(cfg.shadow_map_resolution, cfg))
    vis_map = shadow.sun_visibility(
        gb.world_pos, torch.sum(mu.oct_decode(gb.normals) * fc.sun_dir, -1),
        smap, fc.sun_view_proj, cfg.shadow_map_resolution)
    agree = float(((vis_rt[m] > 0.5) == (vis_map[m] > 0.5)).float().mean())
    _log(f"(e) mean hdr {float(hdr.mean()):.2f} with RT shadows, "
         f"{float(off.mean()):.2f} without; RT shadow share "
         f"{float((vis_rt[m] < 0.5).float().mean()):.4f}, map shadow share "
         f"{float((vis_map[m] < 0.5).float().mean()):.4f}, RT and map agree "
         f"on {agree:.4f} of the covered pixels; AO mean {ao_mean:.4f} "
         f"(min {float(ao.min()):.4f}, max {float(ao.max()):.4f}); bent "
         f"normal length {float(bent_len.min()):.6f}-"
         f"{float(bent_len.max()):.6f}")
    if not bool(torch.isfinite(hdr).all()):
        raise RuntimeError("the RT frame is not finite")
    if not float(hdr.mean()) < float(off.mean()):
        raise RuntimeError("RT shadows do not darken the frame")
    if not (float(ao.min()) >= 0.0 and float(ao.max()) <= 1.0
            and 0.0 < ao_mean < 1.0):
        raise RuntimeError("AO outside [0, 1] or its mean not inside it")
    if float((bent_len - 1.0).abs().max()) > 1e-4:
        raise RuntimeError("the bent normals are not unit length")
    rows += [k4_row(bvh, rt_calls[role], role, rt_launches.get(role, 0))
             for role in ("hbao", "rt_sun")]
    return rows, types.SimpleNamespace(sbvh=sbvh, calls=calls, fc=fc_pt,
                                       history=pt_history)


def binary_phase(dev, path, pt):
    """(g) The atrium's binary BVH (wide=False: the merged table), K4's
    binary role on the captured primary, bounce and shadow rays of (c)
    through bvh.trace, against its twin, and its closest hits against the
    wide layout's. Returns the role's JSON rows."""
    import torch
    from incarnation_tpu_torch.kernels import bvh
    t0 = time.perf_counter()
    bb = bvh.build_scene_bvh(path.scene, wide=False, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n_leaf = int((bb.rows[:bb.nodes, 12] > 0.5).sum())
    _log(f"(g) atrium binary BVH ({'merged' if bb.merged else 'split'}): "
         f"{bb.nodes} nodes ({n_leaf} leaves), {bb.rows.shape[0]} rows, "
         f"{bb.nbytes() / 2**20:.2f} MiB on the card, built on the host in "
         f"{secs:.1f} s")
    roles = {"pt_primary": "binary_primary", "pt_bounce": "binary_bounce",
             "pt_shadow": "binary_shadow"}
    bvh.K4.reset()
    outs = {}
    for src, role in roles.items():
        _, o, d, tmin, tmax, any_hit, _ = pt.calls[src]
        outs[role] = bvh.trace(bb, o, d, tmin=tmin, tmax=tmax,
                               any_hit=any_hit, role=role)
    launches = dict(bvh.K4.by_name)
    _log(f"(g) K4 launches by role: {json.dumps(launches)}")
    if launches != {role: 1 for role in roles.values()}:
        raise RuntimeError(f"binary K4 launches {launches}")
    rows = []
    for src, role in roles.items():
        wb, o, d, tmin, tmax, any_hit, _ = pt.calls[src]
        got = outs[role]
        wide = bvh.trace_k4(wb, o, d, tmin, tmax, any_hit,
                            return_steps=True)
        if any_hit:
            differ = (got["tri"] >= 0) != (wide["tri"] >= 0)
            what = "occlusion"
        else:
            # the same nearest depth; where it ties the layouts may keep
            # different triangles
            differ = (got["tri"] != wide["tri"]) & (got["t"] != wide["t"])
            what = "closest hit"
        ties = int(((got["tri"] != wide["tri"]) & ~differ).sum())
        if int(differ.sum()):
            raise RuntimeError(f"(g) {role}: {what} differs from the wide "
                               f"layout's on {int(differ.sum())} rays")
        row = k4_row(bvh, (bb, o, d, tmin, tmax, any_hit, None), role,
                     launches[role])
        _log(f"(g) {role}: {what} as the wide layout's ({ties} rays keep "
             f"another triangle at a tied depth); steps per ray "
             f"{row['steps_mean']:.2f} binary, "
             f"{float(wide['steps'].double().mean()):.2f} wide")
        rows.append(row)
    return rows


# tools/pt_step_bench.py's cases (:47-56): label, any_hit, filter
ALPHA_CASES = (("closest_primary", False, False),
               ("closest_primary", False, True),
               ("closest_incoherent", False, False),
               ("closest_incoherent", False, True),
               ("anyhit", True, False), ("anyhit", True, True))


def alpha_phase(dev, path, pt):
    """(h) tools/pt_step_bench.py's six traces through bvh.trace on the
    wide BVH, each without and with the path tracer's opacity test
    (pathtrace.AlphaFilter, noise 0, as the bench's alpha_of): closest and
    any hit of PT_W x PT_H rays from the eye (0, 4, -14) in seeded
    directions, and closest hits of incoherent rays. The bench's
    incoherent cases trace the eye rays under another traversal profile;
    the port has one walk, so its incoherent rays are the path tracer's
    own bounce rays from (c). The filtered traces (K4's alpha role)
    against the twin. Returns their rows."""
    import torch
    from incarnation_tpu_torch.kernels import bvh, pathtrace
    r = PT_W * PT_H
    rng = np.random.default_rng(0)
    dirs = rng.standard_normal((r, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    d = torch.tensor(dirs, device=dev)
    o = torch.tensor(np.float32([0.0, 4.0, -14.0]), device=dev).expand(
        r, 3).contiguous()
    _, bo, bd, btmin, btmax, _, _ = pt.calls["pt_bounce"]
    rays = {"closest_primary": (o, d, 0.0, 1e30),
            "closest_incoherent": (bo, bd, btmin, btmax),
            "anyhit": (o, d, 0.0, 1e30)}
    filters = {k: pathtrace.AlphaFilter(path.scene, torch.zeros(
        v[0].shape[0], device=dev)) for k, v in rays.items()}
    bvh.K4.reset()
    outs = []
    for label, any_hit, filtered in ALPHA_CASES:
        role = f"alpha_{label}" if filtered else f"bare_{label}"
        ro, rd, tmin, tmax = rays[label]
        outs.append(bvh.trace(pt.sbvh, ro, rd, tmin=tmin, tmax=tmax,
                              any_hit=any_hit,
                              alpha_of=filters[label] if filtered else None,
                              role=role))
    launches = dict(bvh.K4.by_name)
    _log(f"(h) K4 launches by role: {json.dumps(launches)}")
    rows = []
    for (label, any_hit, filtered), out in zip(ALPHA_CASES, outs):
        role = f"alpha_{label}" if filtered else f"bare_{label}"
        ro, rd, tmin, tmax = rays[label]
        flt = filters[label] if filtered else None
        if int(out["trunc"]):
            raise RuntimeError(f"(h) {role}: trunc {int(out['trunc'])}")
        ms = device_ms(lambda: bvh.trace_k4(pt.sbvh, ro, rd, tmin, tmax,
                                            any_hit, alpha_of=flt), 5)
        _log(f"(h) {role}: {int((out['tri'] >= 0).sum())} accepted hits of "
             f"{ro.shape[0]} rays, {ms:.4f} ms")
        if filtered:
            rows.append(k4_row(bvh, (pt.sbvh, ro, rd, tmin, tmax, any_hit,
                                     flt), role, launches[role]))
    return rows


def _png_check(png_path, w, h):
    """The PNG decodes at (h, w) and is not black -> its pixels."""
    from incarnation_tpu_torch.utils import imageio
    img = imageio.load_png(png_path)
    if img.shape != (h, w, 3) or float(img.mean()) < 2.0:
        raise RuntimeError(f"{png_path}: shape {img.shape}, mean "
                           f"{float(img.mean()):.2f}")
    return img


def cli_phase(dev, path):
    """(i) The CLI in-process (cli.main) on the atrium's glTF: a raster
    run of 8 TAA frames at W x H, equal to render_frame on the Config,
    View and constants the CLI built; an RT shadow + HBAO frame; a
    path-traced run of 4 samples at PT_W x PT_H checkpointed after 2 and
    resumed, equal to an uninterrupted run. Every PNG decodes and is not
    black."""
    import torch
    from incarnation_tpu_torch.app import cli
    from incarnation_tpu_torch.kernels import bvh, clustered, raster, taa
    from incarnation_tpu_torch.renderer import frame
    from incarnation_tpu_torch.scene import stress
    out_dir = ROOT / "build" / "smoke_cli"
    out_dir.mkdir(parents=True, exist_ok=True)
    model = str(stress.build_atrium(ATRIUM_DIR))
    base = ["--model", model, "--sun", "100"]
    kernels = (raster.K1, clustered.K2, taa.K3, bvh.K4)
    for k in kernels:
        k.reset()
    calls = []
    with _capturing(calls, raster, clustered, taa, limit=8):
        res = cli.main(base + ["--width", str(W), "--height", str(H),
                               "--frames", str(FRAMES), "--out",
                               str(out_dir / "raster.png")])
    counts = [k.launches for k in kernels]
    _log(f"(i) CLI raster {W}x{H}: frame ms " + ", ".join(
        f"{t:.2f}" for t in res["frame_ms"]) + f"; launches K1-K4 {counts}")
    # the CLI's camera is static (jitter only): TAA takes the constant
    # shift and K3 does not run
    if 0 in counts[:2]:
        raise RuntimeError(f"(i) the CLI's frames skipped a kernel: "
                           f"{counts}")
    check_twins("(i) CLI raster", calls, raster, clustered, taa,
                need=("k1", "k2"))
    img = _png_check(out_dir / "raster.png", W, H)
    ref = frame.render_frame(res["scene"], res["fc"], config=res["config"],
                             params=res["params"], probe=res["probe"],
                             env_brdf=res["env_brdf"],
                             history=res["history"])["color"]
    same = bool(np.array_equal(img, ref.cpu().numpy()))
    _log(f"(i) CLI PNG equals render_frame on the CLI's Config, View and "
         f"last frame's constants and history: {same}")
    if not same:
        raise RuntimeError("(i) the CLI's PNG differs from render_frame's")

    for k in kernels:
        k.reset()
    res = cli.main(base + ["--width", str(W), "--height", str(H),
                           "--shadows", "rt", "--hbao", "--out",
                           str(out_dir / "rt.png")])
    _log(f"(i) CLI --shadows rt --hbao: {res['frame_ms'][0]:.1f} ms with "
         f"the BVH build; K4 launches {dict(bvh.K4.by_name)}")
    if not bvh.K4.by_name.get("rt_sun") or not bvh.K4.by_name.get("hbao"):
        raise RuntimeError("(i) the RT frame did not trace")
    _png_check(out_dir / "rt.png", W, H)

    pt = base + ["--width", str(PT_W), "--height", str(PT_H), "--pathtrace"]
    ck = out_dir / "pt.npz"
    ck.unlink(missing_ok=True)
    bvh.K4.reset()
    full = cli.main(pt + ["--spp", "4", "--out", str(out_dir / "pt4.png")])
    _log(f"(i) CLI --pathtrace --spp 4: K4 launches "
         f"{dict(bvh.K4.by_name)}; counted rays per sample "
         + ", ".join(f"{x:.0f}" for x in full["rays"]))
    cli.main(pt + ["--spp", "2", "--pt-checkpoint", str(ck), "--out",
                   str(out_dir / "pt2.png")])
    resumed = cli.main(pt + ["--spp", "4", "--pt-checkpoint", str(ck),
                             "--resume", "--out",
                             str(out_dir / "pt_resumed.png")])
    same = bool(torch.equal(resumed["history"], full["history"]))
    _log(f"(i) CLI path trace resumed after 2 of 4 samples equals the "
         f"uninterrupted run: {same}")
    if not same:
        raise RuntimeError("(i) the resumed path trace differs")
    a = _png_check(out_dir / "pt4.png", PT_W, PT_H)
    if not np.array_equal(a, _png_check(out_dir / "pt_resumed.png", PT_W,
                                        PT_H)):
        raise RuntimeError("(i) the resumed PNG differs")


def viewer_phase(dev, path):
    """(j) The web viewer serving the atrium at VIEW_W x VIEW_H on a free
    port: the
    page, two frames, an orbit input after which the next frame differs,
    then /quit, which ends the render loop."""
    import threading
    import urllib.request
    from incarnation_tpu_torch.app import viewer
    from incarnation_tpu_torch.kernels import clustered, raster, taa
    from incarnation_tpu_torch.scene import png
    w, h = VIEW_W, VIEW_H
    for k in (raster.K1, clustered.K2):
        k.reset()
    calls = []
    with _capturing(calls, raster, clustered, taa, limit=8):
        server, state = viewer.serve(path.host, path.cfg, w, h, port=0,
                                     block=False)
        loop = threading.Thread(target=viewer.render_loop,
                                args=(path.host, path.cfg, state, w, h),
                                daemon=True)
        loop.start()
        port = server.server_address[1]

        def get(p):
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{p}",
                                        timeout=120) as r:
                return r.read(), dict(r.headers)

        def post(p, obj):
            req = urllib.request.Request(f"http://127.0.0.1:{port}{p}",
                                         data=json.dumps(obj).encode(),
                                         method="POST")
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.read()

        try:
            page, _ = get("/")
            f1, h1 = get("/frame.png?seq=0")
            f2, h2 = get(f"/frame.png?seq={h1['X-Seq']}")
            if state.error:
                raise RuntimeError(f"(j) viewer: {state.error}")
            if png.png_size(f1) != (w, h) \
                    or h1["Content-Type"] != "image/png":
                raise RuntimeError("(j) the frame is not a PNG of the size")
            seq = int(h2["X-Seq"])
            post("/input", {"cmd": "orbit", "dx": 80, "dy": 0})
            t0 = time.perf_counter()
            f3, h3 = get(f"/frame.png?seq={seq}")
            while int(h3["X-Seq"]) <= seq + 1 \
                    and time.perf_counter() - t0 < 60:
                f3, h3 = get(f"/frame.png?seq={h3['X-Seq']}")
            st = json.loads(get("/state")[0])
            moved = not np.array_equal(png.decode_png(f3),
                                       png.decode_png(f2))
            _log(f"(j) viewer {w}x{h}: page {len(page)} B, frames "
                 f"{h1['X-Seq']}, {h2['X-Seq']}, {h3['X-Seq']}; "
                 f"{st['panel']['fps']} fps; the frame after the orbit "
                 f"input differs: {moved}; launches K1 "
                 f"{raster.K1.launches}, K2 {clustered.K2.launches}")
            if b"incarnation_tpu" not in page or not moved:
                raise RuntimeError("(j) the viewer's frame did not advance")
        finally:
            post("/quit", {})
            loop.join(timeout=120)
            server.shutdown()
            server.server_close()
    if loop.is_alive() or state.error:
        raise RuntimeError(f"(j) the render loop did not end cleanly: "
                           f"{state.error}")
    check_twins("(j) viewer", calls, raster, clustered, taa,
                need=("k1", "k2"))


def band_phase(dev, path, pt):
    """(k) Band sharding over two devices (two cards when the machine shows
    them, else cuda:0 twice): a W x H frame equal to the single frame, a
    second TAA frame through the halos, a band-sharded path-traced sample
    bit-identical to the single one and an SPP-sharded round by the
    batch-mean rule."""
    import torch
    from incarnation_tpu_torch.dist import sharding
    from incarnation_tpu_torch.kernels import clustered, pathtrace, raster
    from incarnation_tpu_torch.kernels import taa
    from incarnation_tpu_torch.renderer import frame
    n_cards = torch.cuda.device_count()
    devices = ["cuda:0", "cuda:1"] if n_cards > 1 else ["cuda:0", "cuda:0"]
    _log(f"(k) band sharding on {devices} ({n_cards} cards visible)")
    kw = dict(config=path.cfg, params=path.params, probe=path.probe,
              env_brdf=path.env_brdf)
    hist0 = torch.zeros((H, W, 3), device=dev)
    fc0 = path.make_fc(0, None)
    fc1 = path.make_fc(1, fc0.view_proj.cpu().numpy())
    s0 = path.run(fc0, hist0)
    s1 = path.run(fc1, s0["accumulation"])
    sharding.render_frame_sharded(path.scene, fc0, devices=devices,
                                  history=hist0, **kw)      # warm-up
    for k in (raster.K1, clustered.K2, taa.K3):
        k.reset()
    # the second frame's launches are captured, to hold each against its
    # twin at the band's shapes (K3 with its halo rows) once counted
    calls = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    b0 = sharding.render_frame_sharded(path.scene, fc0, devices=devices,
                                       history=hist0, **kw)
    with _capturing(calls, raster, clustered, taa):
        b1 = sharding.render_frame_sharded(
            path.scene, fc1, devices=devices, history=b0["accumulation"],
            **kw)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / 2
    counts = [raster.K1.launches, clustered.K2.launches, taa.K3.launches]
    # A band renders through view_proj @ J, which rounds apart from the
    # single frame's view_proj at the last bit: a pixel centre on a
    # triangle edge, or two surfaces at one depth, may go the other way.
    # So tri may differ on at most BAND_TRI_SHARE of the pixels, and the
    # u8 colour must hold 50 dB.
    for i, (b, s) in enumerate(((b0, s0), (b1, s1))):
        share = float((b["tri"] != s["tri"]).float().mean())
        mse = float(((b["color"].double() - s["color"].double()) ** 2)
                    .mean())
        psnr = float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)
        acc = float((b["accumulation"] - s["accumulation"]).abs().max())
        _log(f"(k) band frame {i}: tri differs from the single frame's on "
             f"{share:.2e} of the pixels, u8 colour PSNR {psnr:.2f} dB, "
             f"accumulation max abs diff {acc:.3e}")
        if share > BAND_TRI_SHARE or psnr < 50.0:
            raise RuntimeError(f"(k) band frame {i} differs from the single")
    _log(f"(k) band frames: {ms:.2f} ms each (host clock, 2 frames), "
         f"launches K1, K2, K3 {counts}")
    if 0 in counts:
        raise RuntimeError(f"(k) the band frames skipped a kernel: {counts}")
    halo = check_twins("(k) band frame", calls, raster, clustered, taa,
                       need=("k1", "k2", "k3"))
    if len(halo) < 2 or any(len(a) < 6 or a[5] <= 0 for a in halo):
        raise RuntimeError("(k) a band's K3 launch had no halo rows")
    rows = [k3_row(taa, halo[0], "k3_taa_fetch[band_halo]", counts[2])]

    hist = pt.history
    single = frame.render_pathtrace(path.scene, pt.sbvh, pt.fc, hist, 20,
                                    config=path.cfg, width=PT_W,
                                    height=PT_H, probe=path.probe)
    band = sharding.pathtrace_band_sharded(
        path.scene, pt.sbvh, pt.fc, hist, 20, config=path.cfg, width=PT_W,
        height=PT_H, devices=devices, probe=path.probe)
    same = bool(torch.equal(band["history"], single["history"]))
    _log(f"(k) band-sharded path-traced sample {PT_W}x{PT_H}: identical "
         f"{same}, counted rays {float(band['rays']):.0f} "
         f"(single {float(single['rays']):.0f})")
    if not same or float(band["rays"]) != float(single["rays"]):
        raise RuntimeError("(k) the band-sharded sample differs")
    spp = sharding.pathtrace_spp_sharded(
        path.scene, pt.sbvh, pt.fc, hist, 21, config=path.cfg, width=PT_W,
        height=PT_H, devices=devices, probe=path.probe)
    scene_b, fc_b, wn, wt = frame.pathtrace_inputs(path.scene, pt.fc)
    cur = pathtrace.trace_sample(
        scene_b, pt.sbvh, wn, wt, fc_b, path.probe, [21, 22], PT_W, PT_H,
        sqrt_sample_count=int(np.sqrt(path.cfg.max_sample_count)),
        turbidity=path.cfg.turbidity, sky_rot3=pt.fc.scene_rotation[:3, :3],
        sun_dir_world=pt.fc.sun_dir)
    want = pathtrace.integrate(hist, cur, 21)
    err = float(((spp - want).abs() / (want.abs() + 1e-6)).max())
    _log(f"(k) SPP-sharded round (samples 21, 22): max relative diff "
         f"{err:.3e} from the batch-mean rule")
    if err > 1e-6:
        raise RuntimeError("(k) the SPP-sharded round misses the rule")
    return rows


def check_twins(what, calls, raster, clustered, taa, need):
    """Each captured K1, K2 and K3 launch against its twin, at
    compare_kernels' tolerances (K1 via _k1_error, K2 K2_RTOL, K3 1e-6
    relative), at the shapes the path gave it; raises if a kind in `need` was
    not captured. Returns the K3 launches' arguments."""
    kinds = {k: [c for c in calls if c[0] == k] for k in ("k1", "k2", "k3")}
    if not all(kinds[k] for k in need):
        raise RuntimeError(f"{what}: captured launches per kernel "
                           f"{ {k: len(v) for k, v in kinds.items()} }")
    worst = (0.0, 0.0, 0.0)
    for _, a, kw in kinds["k1"]:
        bins, p = a
        zl, mt = kw.get("z_limit"), kw.get("mask_table")
        e = _k1_error(raster.rasterize_tiles(bins, p, z_limit=zl,
                                             mask_table=mt),
                      raster.rasterize_tiles_plain(bins, p, z_limit=zl,
                                                   mask_table=mt))
        worst = tuple(max(x, y) for x, y in zip(worst, e))
    shapes = sorted({(c[1][1].width, c[1][1].height, c[1][1].pair_capacity)
                     for c in kinds["k1"]})
    _log(f"{what}: K1 x{len(kinds['k1'])} at (width, height, pair "
         f"capacity) {shapes} against the twin: max abs err {worst[0]:.3e}, "
         f"max relative err {worst[1]:.3e}, tri mismatch share "
         f"{worst[2]:.2e}")
    for i, (_, a, kw) in enumerate(kinds["k2"]):
        err, rel = _close(f"{what} K2",
                          clustered.clustered_lighting(*a, **kw),
                          clustered.clustered_lighting_plain(*a, **kw),
                          rtol=K2_RTOL, atol_frac=1e-5, where=a[0].mask)
        _log(f"{what}: K2 {i} ({a[8]}x{a[9]}) against the twin: max abs "
             f"err {err:.3e}, max relative err {rel:.3e}")
    for i, (_, a, kw) in enumerate(kinds["k3"]):
        err, rel = _close(f"{what} K3", taa.history_fetch(*a),
                          taa.history_fetch_plain(*a), rtol=1e-6,
                          atol_frac=1e-7)
        _log(f"{what}: K3 {i} ({a[3]}x{a[4]}, "
             f"{a[5] if len(a) > 5 else 0} halo rows each way) against the "
             f"twin: max abs err {err:.3e}, max relative err {rel:.3e}")
    return [a for _, a, _ in kinds["k3"]]


def k4_row(bvh, call, role, n_launches):
    """K4 against its twin on one captured launch (identical tri, t, u, v,
    steps and trunc, or it raises), both timed, the bound from the twin's
    walk -> the role's JSON row. A launch with an alpha filter is bounded
    by its walk alone: the opacity tests' fetches and operations are not
    counted, so its bound is looser than the others'."""
    import torch
    b, o, d, tmin, tmax, any_hit, alpha_of = call
    got = bvh.trace_k4(b, o, d, tmin, tmax, any_hit, return_steps=True,
                       alpha_of=alpha_of)
    ref = bvh.trace_plain(b, o, d, tmin, tmax, any_hit, return_steps=True,
                          alpha_of=alpha_of)
    for k in ("tri", "t", "u", "v", "steps"):
        if not torch.equal(got[k], ref[k]):
            n = int((got[k] != ref[k]).sum())
            raise RuntimeError(f"K4 {role}: {k} differs from its twin on "
                               f"{n} of {got[k].numel()} rays")
    if int(got["trunc"]) != int(ref["trunc"]) or int(got["trunc"]):
        raise RuntimeError(f"K4 {role}: trunc {int(got['trunc'])}, twin "
                           f"{int(ref['trunc'])}")
    r = o.shape[0]
    steps = ref["steps"].double()
    leaf = ref["leaf_steps"].double()
    n_rows = int(ref["visited"].sum())
    lanes = bvh.WIDE_LANES if b.wide else bvh.ROW_LANES
    nbytes = r * (K4_RAY_BYTES + (4 if torch.is_tensor(tmin) else 0)
                  + (4 if alpha_of is not None else 0)) \
        + n_rows * lanes * 4 \
        + 8 * int(ref["visited_links"].sum() if "visited_links" in ref
                  else 0)
    ops = float(ref["tri_tests"].double().sum()) * K4_OPS_TRI \
        + float(ref["box_tests"].double().sum()) * K4_OPS_BOX \
        + float((steps - leaf).sum()) * K4_OPS_INTERNAL
    bound_ms, bound_by = _bound(nbytes, ops)
    hits = float((got["tri"] >= 0).float().mean())
    ms = device_ms(lambda: bvh.trace_k4(b, o, d, tmin, tmax, any_hit,
                                        alpha_of=alpha_of), 5)
    plain_ms = device_ms(lambda: bvh.trace_plain(
        b, o, d, tmin, tmax, any_hit, alpha_of=alpha_of), 1)
    _log(f"K4 {role}: {r} rays ({'any' if any_hit else 'closest'} hit, "
         f"{'alpha filter, ' if alpha_of is not None else ''}"
         f"{'wide' if b.wide else 'binary'} layout, "
         f"{hits:.4f} hit), steps per ray mean {float(steps.mean()):.2f} "
         f"max {int(steps.max())} (leaf {float(leaf.mean()):.2f}), "
         f"filled slots tested per ray: "
         f"{float(ref['tri_tests'].double().mean()):.2f} triangles, "
         f"{float(ref['box_tests'].double().mean()):.2f} boxes, "
         f"{n_rows} distinct rows; {ms:.4f} ms, twin {plain_ms:.2f} ms, "
         f"bound {bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.2f} MB, "
         f"{ops / 1e9:.3f} GFLOP); identical to the twin")
    return dict(
        name=f"k4_trace[{role}]", route="cuda",
        source="incarnation_tpu_torch/csrc/bvh.cu",
        replaces="incarnation_tpu/kernels/bvh.py:1108",
        launches=n_launches, max_abs_err=0.0, max_rel_err=0.0, ms=ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None, steps_mean=float(steps.mean()),
        steps_max=int(steps.max()), trunc=int(got["trunc"]))


def _k4_twin(bvh):
    def twin(b, o, d, tmin=0.0, tmax=1e30, any_hit=False,
             max_steps=bvh.MAX_STEPS, return_steps=False, role=None,
             alpha_of=None):
        return bvh.trace_plain(b, o, d, tmin, tmax, any_hit, max_steps,
                               return_steps, alpha_of)
    return twin


@contextlib.contextmanager
def _swapped(mod, name, fn):
    """mod.name replaced by fn for the duration of the block."""
    saved = getattr(mod, name)
    setattr(mod, name, fn)
    try:
        yield
    finally:
        setattr(mod, name, saved)


def _hooked(mod, name, after):
    """mod.name calls after(result, *args, **kwargs) on each call, for the
    duration of the block."""
    fn = getattr(mod, name)

    def hooked(*a, **kw):
        out = fn(*a, **kw)
        after(out, *a, **kw)
        return out
    return _swapped(mod, name, hooked)


def profile_pt(sample, history, bvh, pathtrace):
    """ms of one path-traced sample by phase (a synchronize around each):
    traversal by K4 role, the alpha tests of the peels, the material fetch
    (hit attributes + textures), and the rest (shading, sampling, host);
    then a torch.profiler table of one sample."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    spent = {}

    def timed(key_of, fn):
        def wrapped(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            key = key_of(*a, **kw)
            spent[key] = spent.get(key, 0.0) + time.perf_counter() - t0
            return out
        return wrapped

    with _swapped(bvh, "trace_k4", timed(
            lambda *a, role=None, **kw: f"traversal[{role}]",
            bvh.trace_k4)), \
            _swapped(pathtrace, "_alpha_at_hit", timed(
                lambda *a, **kw: "alpha tests", pathtrace._alpha_at_hit)), \
            _swapped(pathtrace, "_eval_material", timed(
                lambda *a, **kw: "material fetch",
                pathtrace._eval_material)), \
            _swapped(pathtrace, "_hit_attributes", timed(
                lambda *a, **kw: "hit attributes",
                pathtrace._hit_attributes)):
        sample(1, history)
        spent.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sample(1, history)
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
    ms = {k: v * 1e3 for k, v in spent.items()}
    ms["shading, sampling, host"] = total - sum(ms.values())
    _log(f"PT sample by phase, {total:.2f} ms with a synchronize around "
         "each phase: " + json.dumps(
             {k: round(v, 3) for k, v in sorted(ms.items(),
                                                key=lambda kv: -kv[1])}))
    sample(1, history)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sample(1, history)
        torch.cuda.synchronize()
    _log(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25))


def _close(what, got, ref, rtol, atol_frac, where=None):
    """Holds got to ref per element: |got - ref| <= rtol |ref| + atol, with
    atol = atol_frac x the median nonzero |ref| (over the pixels `where`
    selects, if given); raises otherwise. Returns (max abs error, max of
    |got - ref| / (|ref| + atol))."""
    if where is not None:
        got, ref = got[where], ref[where]
    mag = ref.abs()
    nonzero = mag[mag > 0]
    atol = atol_frac * float(nonzero.median()) if nonzero.numel() else 0.0
    diff = (got - ref).abs()
    if diff.numel() == 0:
        return 0.0, 0.0
    bad = int((diff > rtol * mag + atol).sum())
    max_abs = float(diff.max())
    max_rel = float((diff / (mag + atol).clamp(min=1e-30)).max())
    if bad:
        raise RuntimeError(
            f"{what} disagrees with its twin on {bad} of {diff.numel()} "
            f"elements: |err| > {rtol} |ref| + {atol:.3e} (max abs err "
            f"{max_abs:.3e}, max relative err {max_rel:.3e})")
    return max_abs, max_rel


def _k1_error(got, ref):
    """(max abs error, max relative error, tri mismatch share) of one K1
    launch against its twin; raises past the tolerance. tri may differ on
    at most 1e-4 of the pixels (the twin's edge tests round as the
    kernel's, so 0 is expected); where tri agrees, depth and every interp
    channel must agree per pixel to 1e-6 (depth) and 1e-5 (interp) of the
    twin's value: the same plane equations in the same order."""
    tri_k, dep_k, int_k = got
    tri_r, dep_r, int_r = ref
    same = tri_k == tri_r
    share = 1.0 - float(same.float().mean())
    if share > 1e-4:
        raise RuntimeError(f"K1 tri differs from its twin on {share:.2e} "
                           "of the pixels")
    err, rel = _close("K1 depth", dep_k, dep_r, rtol=1e-6, atol_frac=1e-7,
                      where=same)
    if (int_k is None) != (int_r is None):
        raise RuntimeError("K1 and its twin disagree on writing interp")
    for c in range(0 if int_k is None else int_k.shape[0]):
        e, r = _close(f"K1 interp channel {c}", int_k[c], int_r[c],
                      rtol=1e-5, atol_frac=1e-6, where=same)
        err, rel = max(err, e), max(rel, r)
    return err, rel, share


def _k2_work(gb, n, v, depth, lights, cluster_mask, config, near, width,
             height):
    """Operations K2's inputs need and the diagnostics of its work, from
    the exact-zero tests of every (covered pixel, light of its cluster)
    pair (clustered.zero_light_tests, the twin's arithmetic): a skipped
    light is charged up to the test that skips it, a contributing one the
    whole evaluation (see K2_OPS_*). -> (ops, diagnostics)."""
    import torch
    from incarnation_tpu_torch.kernels import clustered
    from incarnation_tpu_torch.scene import lights as lights_mod
    cid = clustered.pixel_cluster_id(depth, config, near, width, height)
    words = cluster_mask[cid.long()]
    in_cluster = torch.zeros(depth.shape, dtype=torch.int64,
                             device=depth.device)
    contrib = torch.zeros_like(in_cluster)
    ops = 0
    why = dict(beyond_range=0, outside_cone=0, behind_surface=0)
    for i in range(lights.type.shape[0]):
        on = (((words[..., i // 32] >> (i % 32)) & 1) > 0) & gb.mask
        beyond, outside, behind = clustered.zero_light_tests(
            lights, i, gb.world_pos, n)
        ranged = bool(lights.range[i] > 0.0)
        spot = bool(lights.type[i] == lights_mod.LIGHT_SPOT)
        n_on = int(on.sum())
        n_beyond = int((on & beyond).sum())
        n_outside = int((on & outside).sum())
        n_behind = int((on & behind).sum())
        lit = on & ~beyond & ~outside & ~behind
        in_cluster += on
        contrib += lit
        why["beyond_range"] += n_beyond
        why["outside_cone"] += n_outside
        why["behind_surface"] += n_behind
        dist = K2_OPS_DIST + K2_OPS_RANGE * ranged
        cone = dist + K2_OPS_DIR + K2_OPS_SPOT * spot
        ops += (dist * n_on + (cone - dist) * (n_on - n_beyond)
                + K2_OPS_NOL * (n_on - n_beyond - n_outside)
                + K2_OPS_BRDF * int(lit.sum()))

    def warp_sum_max(count, bw, bh):
        """Sum over warps of bw x bh pixels of the largest lane count."""
        hp, wp = -(-height // bh) * bh, -(-width // bw) * bw
        pad = torch.zeros((hp, wp), dtype=count.dtype, device=count.device)
        pad[:height, :width] = count
        return int(pad.reshape(hp // bh, bh, wp // bw, bw)
                   .amax(dim=(1, 3)).sum())

    pairs = int(in_cluster.sum())
    diag = dict(
        cluster_light_pairs=pairs, contributing=int(contrib.sum()),
        skipped_share=(pairs - int(contrib.sum())) / max(pairs, 1),
        skipped_by=why,
        warp_sum_of_mean_lane=pairs / 32,
        warp_sum_of_max_lane_32x1=warp_sum_max(in_cluster, 32, 1),
        warp_sum_of_max_lane_8x4=warp_sum_max(in_cluster, 8, 4),
        warp_sum_of_max_contributing_32x1=warp_sum_max(contrib, 32, 1),
        warp_sum_of_max_contributing_8x4=warp_sum_max(contrib, 8, 4),
        ops=ops)
    return ops, diag


def _k2_bound(ops, gb, n, v, depth, lights, cluster_mask, config, near,
              width, height):
    """Bytes: the gbuffer planes K2 reads (base colour and mrao as 4-float
    rows, normal, view, world position, mask, depth) and its output, once;
    operations: those _k2_work counts."""
    px = width * height
    nbytes = px * (16 + 16 + 12 + 12 + 12 + 1 + 4 + 12) \
        + cluster_mask.numel() * 4 + lights.type.shape[0] * 64
    return _bound(nbytes, ops)


def check_twin_frame(run, fc, history, raster, clustered, taa):
    """The same frame with every kernel swapped for its plain twin: the
    images must agree (tri on all but 1e-4 of the pixels, u8 colour
    >= 50 dB PSNR)."""
    import torch
    got = run(fc, history)
    def raster_plain(bins, params, z_limit=None, mask_table=None,
                     name=None):
        return raster.rasterize_tiles_plain(bins, params, z_limit,
                                            mask_table)

    with _swapped(raster, "rasterize_tiles", raster_plain), \
            _swapped(clustered, "clustered_lighting",
                     clustered.clustered_lighting_plain), \
            _swapped(taa, "history_fetch", taa.history_fetch_plain):
        ref = run(fc, history)
    torch.cuda.synchronize()
    share = float((got["tri"] != ref["tri"]).float().mean())
    mse = float(((got["color"].double() - ref["color"].double()) ** 2)
                .mean())
    psnr = float("inf") if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)
    hdr_err = float((got["hdr"] - ref["hdr"]).abs().max())
    _log(f"frame with kernels vs frame with twins: tri mismatch share "
         f"{share:.2e}, u8 PSNR {psnr:.2f} dB, hdr max abs diff {hdr_err:.3e}")
    if share > 1e-4 or psnr < 50.0:
        raise RuntimeError("the kernels' frame disagrees with the twins'")


# (module, function) pairs render_frame calls, timed by phase_breakdown
_PHASES = (("cull", "cull_primitives"), ("raster", "prepare_geometry"),
           ("raster", "bin_triangles_layered"), ("raster", "rasterize_tiles"),
           ("shadow", "render_sun_shadow_map"), ("shadow", "sun_visibility"),
           ("resolve", "masked_alpha"), ("resolve", "resolve_gbuffer"),
           ("clustered", "build_light_clusters"),
           ("clustered", "clustered_lighting"), ("skylight", "sky_lighting"),
           ("shading", "brdf_response"),
           ("skylight", "environment_background"), ("taa", "taa_resolve"),
           ("post", "tonemap"), ("post", "to_uint8"))


def phase_breakdown(run, fc, history, reps: int = 3):
    """ms of each render_frame phase: every call of the functions in
    _PHASES is wrapped in synchronize + host clock; the rest of the frame
    is the glue between them. A phase called inside another (the shadow
    map's own triangle setup, binning and K1 launch) counts to the outer
    one. Mean over reps frames."""
    import importlib
    import torch
    spent = {}
    saved = {}
    depth = [0]
    for mod_name, fn_name in _PHASES:
        mod = importlib.import_module(f"incarnation_tpu_torch.kernels."
                                      f"{mod_name}")
        fn = getattr(mod, fn_name)
        saved[(mod, fn_name)] = fn
        key = f"{mod_name}.{fn_name}"

        def timed(*a, _fn=fn, _key=key, **kw):
            if depth[0]:
                return _fn(*a, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            depth[0] += 1
            try:
                out = _fn(*a, **kw)
            finally:
                depth[0] -= 1
            torch.cuda.synchronize()
            spent[_key] = spent.get(_key, 0.0) + time.perf_counter() - t0
            return out
        setattr(mod, fn_name, timed)
    try:
        run(fc, history)
        spent.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            run(fc, history)
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) / reps * 1e3
    finally:
        for (mod, fn_name), fn in saved.items():
            setattr(mod, fn_name, fn)
    ms = {k: v / reps * 1e3 for k, v in spent.items()}
    ms["glue"] = total - sum(ms.values())
    _log(f"phase breakdown of one frame, {total:.2f} ms with a synchronize "
         "around each phase: " + json.dumps(
             {k: round(v, 3) for k, v in sorted(ms.items(),
                                                key=lambda kv: -kv[1])}))
    return ms


def profile_frame(run, fc, history):
    """phase_breakdown, then torch.profiler over one frame: CUDA time by
    kernel, top 40, printed."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    phase_breakdown(run, fc, history)
    run(fc, history)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(fc, history)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=40)
    _log(table)


if __name__ == "__main__":
    sys.exit(main())
