"""Command-line renderer: load a glTF scene, render frames to PNG (port of
incarnation_tpu/app/cli.py).

The batch-mode replacement for the reference's interactive Win32 loop
(ref: source/demo-exe/main.cpp): all FConfig toggles are flags, the camera
comes from the scene's glTF camera 0 (like FView::Reset,
ref: src/demo.cpp:172-197) or --lookat overrides. It renders on the CUDA
card; --cpu runs the same frame on the host (the kernels' plain twins).

Usage:
  python -m incarnation_tpu_torch.app.cli \
      --model scene.gltf \
      --out frame.png --width 1280 --height 720 --sun 1
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

import numpy as np
import torch

from ..config import Config, EnvSkyMode
from ..core import mathutils as mu
from ..core.view import View
from ..device import resolve_device
from ..kernels.raster import RasterParams
from ..renderer import frame as frame_mod
from ..scene.cache import load_probe_cached, load_scene_cached
from ..utils import imageio as io_mod


def build_view(host, width, height, cfg: Config, lookat=None) -> View:
    aspect = width / height
    if lookat is not None:
        eye, target = lookat
        return View.from_lookat(eye, target, aspect=aspect, fov=cfg.fov,
                                near=cfg.camera_near_plane)
    if host.cameras:
        c = host.cameras[0]
        v = View(position=np.asarray(c["position"], np.float32),
                 right=np.asarray(c["right"], np.float32),
                 up=np.asarray(c["up"], np.float32),
                 look=np.asarray(c["look"], np.float32), fov=c["yfov"],
                 aspect=aspect, near=cfg.camera_near_plane)
        v.orthonormalize()
        return v
    return View.default(aspect=aspect, fov=cfg.fov,
                        near=cfg.camera_near_plane)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", required=True)
    ap.add_argument("--out", default="frame.png")
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--viewmode", type=int, default=0)
    ap.add_argument("--exposure", type=float, default=13.0)
    ap.add_argument("--sun", type=float, default=0.0,
                    help="directional sun intensity (0 = scene lights only)")
    ap.add_argument("--sun-dir", type=float, nargs=3, default=None)
    ap.add_argument("--lookat", type=float, nargs=6, default=None,
                    metavar=("EX", "EY", "EZ", "TX", "TY", "TZ"))
    ap.add_argument("--texture-max-dim", type=int, default=2048)
    ap.add_argument("--pair-capacity", type=int, default=1 << 20)
    ap.add_argument("--frames", type=int, default=1,
                    help="render N frames (timing: the first builds the "
                         "kernels)")
    ap.add_argument("--no-sky", action="store_true",
                    help="disable sky lighting + background")
    ap.add_argument("--pathtrace", action="store_true",
                    help="progressive path tracing instead of raster")
    ap.add_argument("--spp", type=int, default=16,
                    help="path-tracing samples per pixel to accumulate")
    ap.add_argument("--pt-checkpoint", type=str, default=None,
                    help="save the path-trace accumulation + sample "
                         "counter to this .npz after the run")
    ap.add_argument("--resume", action="store_true",
                    help="resume accumulation from --pt-checkpoint if it "
                         "exists (bit-identical to an uninterrupted run)")
    ap.add_argument("--shadows", nargs="?", const="rt", default="map",
                    choices=["off", "map", "rt"],
                    help="sun shadows: 'map' (default; rasterized shadow "
                         "map), 'rt' (exact BVH shadow rays like the "
                         "reference's DXR ray), 'off'")
    ap.add_argument("--shadow-res", type=int, default=1024)
    ap.add_argument("--forward", action="store_true",
                    help="forward lighting path (exact normals; BLEND "
                         "geometry alpha-composited — ref ui.cpp:346)")
    ap.add_argument("--hbao", action="store_true",
                    help="ray-traced HBAO + bent normals")
    ap.add_argument("--hdri", default=None,
                    help=".hdr environment (replaces the dynamic sky, like "
                         "FConfig::HDRIFilename)")
    ap.add_argument("--show-object-bounds", action="store_true")
    ap.add_argument("--show-light-bounds", action="store_true")
    ap.add_argument("--rotate-scene", type=float, default=None,
                    metavar="DEG", help="rotate the scene about world y "
                    "(the reference's RMB scene-rotation)")
    ap.add_argument("--tod", type=float, default=None, metavar="HOURS",
                    help="time-of-day sun position (decimal hours; uses "
                         "FConfig ToD julian date + latitude defaults)")
    ap.add_argument("--pick", type=int, nargs=2, default=None,
                    metavar=("X", "Y"),
                    help="print ids under pixel and highlight the primitive")
    ap.add_argument("--cpu", action="store_true",
                    help="render on the host CPU (the kernels' plain twins; "
                         "debugging / hosts without a CUDA card)")
    return ap.parse_args(argv)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _progress(stage, frac):
    # load-progress reporting (ref: inc/scene.h:131-142); \r keeps it one
    # line like the reference's progress bar
    print(f"\r[load] {stage} {frac * 100:5.1f}%", end="", file=sys.stderr,
          flush=True)
    if frac >= 1.0:
        print(file=sys.stderr)


def build_probe(cfg: Config, sun_dir, device, hdri=None):
    """Environment probe + env-BRDF LUT: the HDRI's (ref:
    FTextureCache::CacheHDRI, src/demo.cpp:292-434) or the dynamic sky's
    for sun_dir, through the probe cache."""
    from ..kernels import ibl, sky
    if hdri:
        hp = pathlib.Path(hdri)
        key = (f"hdri:{hp.resolve()}:{hp.stat().st_mtime_ns}:"
               f"{cfg.envmap_resolution}")
        probe = load_probe_cached(
            lambda: ibl.build_probe(
                torch.tensor(io_mod.load_hdr(hp), device=device),
                envmap_size=cfg.envmap_resolution), key, device=device)
    else:
        sd = np.asarray(sun_dir, np.float32)
        key = (f"sky:{sd.round(4).tolist()}:{cfg.turbidity}:"
               f"{cfg.envmap_resolution}")
        probe = load_probe_cached(
            lambda: ibl.build_probe(
                sky.sky_latlong(torch.tensor(sd, device=device),
                                cfg.turbidity, 256, 128),
                envmap_size=cfg.envmap_resolution), key, device=device)
    env_brdf = ibl.pack_env_brdf(ibl.env_brdf_lut(128, device=device))
    _sync(device)
    return probe, env_brdf


def main(argv=None) -> dict:
    """Renders as the flags ask and writes --out. Returns what an
    in-process caller may check: dict(config, view, params, fc, color
    (the written image as a tensor); for a raster run frame_ms, stats,
    coverage, and what the last frame was rendered from: scene, probe,
    env_brdf, scene_bvh and history (its input history); for a
    path-traced one the accumulated history and the counted rays per
    sample)."""
    args = parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    cfg = Config(viewmode=args.viewmode, exposure=args.exposure,
                 enable_sky_lighting=not args.no_sky,
                 enable_hbao=args.hbao, use_bent_normals=args.hbao,
                 forward_lighting=args.forward,
                 sun_shadow_mode=args.shadows,
                 shadow_map_resolution=args.shadow_res,
                 show_object_bounds=args.show_object_bounds,
                 show_light_bounds=args.show_light_bounds)
    if args.no_sky or args.hdri:
        cfg = cfg.replace(env_sky_mode=EnvSkyMode.ENVIRONMENT_MAP)
    t0 = time.time()
    host = load_scene_cached(args.model, texture_max_dim=args.texture_max_dim,
                             progress=_progress, device=device)
    scene = host.scene
    print(f"[scene] {host.name}: {scene.meta.num_triangles} tris, "
          f"{scene.meta.num_primitives} prims, "
          f"load {time.time() - t0:.1f}s")

    view = build_view(host, args.width, args.height, cfg,
                      lookat=(args.lookat[:3], args.lookat[3:])
                      if args.lookat else None)
    params = RasterParams(width=args.width, height=args.height,
                          pair_capacity=args.pair_capacity)

    sun_ci = None
    sun_dir = scene.sun_dir.cpu().numpy()
    if args.tod is not None:
        from ..scene.lights import sun_direction_tod
        sun_dir = sun_direction_tod(args.tod, cfg.tod_julian_date,
                                    cfg.tod_latitude)
        print(f"[sun] time-of-day {args.tod}h -> {sun_dir.round(3)}")
    if args.sun > 0:
        sun_ci = [1.0, 1.0, 1.0, args.sun]
        if args.sun_dir is not None:
            sun_dir = np.asarray(args.sun_dir, np.float32)
            sun_dir = sun_dir / np.linalg.norm(sun_dir)
    elif host.directional_light_index >= 0:
        i = host.directional_light_index
        sun_ci = list(scene.lights.color[i].cpu().numpy()) + [
            float(scene.lights.intensity[i])]

    scene_rotation = None
    if args.rotate_scene is not None:
        a = np.radians(args.rotate_scene)
        scene_rotation = np.eye(4, dtype=np.float32)
        scene_rotation[0, 0] = scene_rotation[2, 2] = np.cos(a)
        scene_rotation[0, 2] = -np.sin(a)
        scene_rotation[2, 0] = np.sin(a)
    shadow_bounds = None
    if cfg.sun_shadow_mode == "map":
        shadow_bounds = (host.bounds_center,
                         float(np.linalg.norm(host.bounds_extent)) + 1e-3)

    def constants(**kw):
        return frame_mod.FrameConstants.make(
            view, cfg, sun_dir=sun_dir, sun_color_intensity=sun_ci,
            scene_rotation=scene_rotation, shadow_bounds=shadow_bounds,
            device=device, **kw)

    fc = constants()
    probe = env_brdf = None
    if cfg.enable_sky_lighting or args.hdri:
        t0 = time.time()
        probe, env_brdf = build_probe(cfg, fc.sun_dir.cpu().numpy(), device,
                                      hdri=args.hdri)
        print(f"[probe] environment probe + BRDF LUT: {time.time() - t0:.1f}s")

    if args.pathtrace:
        return _pathtrace(args, cfg, host, fc, probe, device,
                          dict(view=view, params=params))

    from ..kernels import bvh as bvh_mod
    scene_bvh = None
    if args.shadows == "rt" or args.hbao:
        t0 = time.time()
        scene_bvh = bvh_mod.apply_mesh_visibility(
            bvh_mod.build_scene_bvh(scene, device=device), scene,
            scene.mesh_visible)
        print(f"[bvh] LBVH for shadows/AO: {time.time() - t0:.1f}s")

    # TAA loop: subsequent frames jitter the camera by Halton(2,3) and
    # resolve against the previous accumulation (ref: renderer.cpp:126-132,
    # render-jobs/taa-resolve.inl)
    jitters = mu.halton_jitter_table(16)
    history = None
    prev_vp = None
    frame_ms = []
    t0 = time.time()
    for i in range(max(1, args.frames)):
        if cfg.enable_taa and args.frames > 1:
            j = jitters[i % 16] * 2.0 / np.array([args.width, args.height])
            fc = constants(jitter=j, prev_view_proj=prev_vp,
                           history_valid=(i > 0), frame_index=i)
            if history is None:
                history = torch.zeros((args.height, args.width, 3),
                                      device=device)

        hist_in = history

        def render():
            return frame_mod.render_frame(
                scene, fc, config=cfg, params=params, probe=probe,
                env_brdf=env_brdf, history=history, scene_bvh=scene_bvh)

        out = render()
        if i == 0 and scene.meta.has_masked:
            # Adaptive peel count (VERDICT r2 item 6): if the last masked
            # peel still alpha-failed for many pixels, raise the layer
            # count for the following frames.
            ov = int(out["stats"]["peel_overflow"])
            if ov > 256 and cfg.masked_depth_peels < 4:
                old = cfg.masked_depth_peels
                cfg = cfg.replace(masked_depth_peels=old
                                  + (2 if ov > 65536 else 1))
                print(f"[peels] {ov} px overflowed {old}-layer peeling -> "
                      f"masked_depth_peels={cfg.masked_depth_peels}")
                if args.frames == 1:
                    # single-shot render: redo frame 0 at the raised count
                    # so the written image has no truncated peels
                    out = render()
        if cfg.enable_taa and args.frames > 1:
            history = out["accumulation"]
            prev_vp = fc.view_proj.cpu().numpy()
        _sync(device)
        dt = time.time() - t0
        frame_ms.append(dt * 1e3)
        print(f"[first frame (incl. compile)] {dt:.2f}s" if i == 0
              else f"[frame] {dt * 1e3:.1f} ms")
        t0 = time.time()

    stats = {k: int(v) for k, v in out["stats"].items()}
    covered = float((out["tri"] >= 0).float().mean())
    print(f"[stats] {stats} coverage={covered:.3f}")

    color = out["color"]
    if args.pick is not None:
        x, y = args.pick
        prim, local, meshlet = frame_mod.pick(scene, out["tri"], x, y)
        print(f"[pick] ({x},{y}): primitive={prim} triangle={local} "
              f"meshlet={meshlet}")
        if prim >= 0:
            color = frame_mod.highlight(color, out["tri"], scene, prim)
    # show_object_bounds / show_light_bounds draw inside the frame through
    # the device-side append buffer (renderer/debugdraw.py)

    io_mod.save_png(args.out, color.cpu().numpy())
    print(f"[out] {args.out}")
    return dict(config=cfg, view=view, params=params, fc=fc, color=color,
                frame_ms=frame_ms, stats=stats, coverage=covered,
                scene=scene, probe=probe, env_brdf=env_brdf,
                scene_bvh=scene_bvh, history=hist_in)


def _pathtrace(args, cfg, host, fc, probe, device, info) -> dict:
    """--pathtrace: args.spp progressive samples (resumed from
    --pt-checkpoint with --resume), tonemapped to --out."""
    from ..kernels import bvh as bvh_mod
    from ..kernels import post
    scene = host.scene
    t0 = time.time()
    bvh = bvh_mod.build_scene_bvh(scene, device=device)
    # hidden meshes must not trace (ref: update-tlas.inl:24 rebuilds the
    # TLAS over the visible list every frame; visibility changes rarely
    # here, so the leaf re-emit happens on change instead)
    bvh = bvh_mod.apply_mesh_visibility(bvh, scene, scene.mesh_visible)
    print(f"[bvh] LBVH over {scene.meta.num_triangles} tris: "
          f"{time.time() - t0:.1f}s")
    # The CMJ sample grid is the Config's max_sample_count, whatever --spp
    # asks for: sample s is then the same in every run, and a run resumed
    # from a shorter run's checkpoint equals an uninterrupted one. (The
    # JAX CLI sets the grid to --spp, so its resumed runs continue on
    # another grid; ROADMAP Queue 3.)
    history = torch.zeros((args.height, args.width, 3), device=device)
    # checkpoint/resume of the accumulation array + sample counter
    # (SURVEY §5: the reference's scene-rebuild equivalent; samples are
    # keyed on their index so a resumed run is bit-identical)
    start_s = 0
    ckpath = pathlib.Path(args.pt_checkpoint) if args.pt_checkpoint \
        else None
    if ckpath is not None and args.resume and ckpath.exists():
        ck = np.load(ckpath)
        if (int(ck["width"]), int(ck["height"])) != (args.width,
                                                     args.height):
            sys.exit(f"checkpoint {ckpath} is "
                     f"{int(ck['width'])}x{int(ck['height'])}, "
                     f"not {args.width}x{args.height}")
        if int(ck["sample_grid"]) != cfg.max_sample_count:
            sys.exit(f"checkpoint {ckpath} was sampled on a "
                     f"{int(ck['sample_grid'])}-sample grid, not "
                     f"{cfg.max_sample_count}")
        history = torch.tensor(ck["history"], device=device)
        start_s = int(ck["next_sample"])
        print(f"[pt] resumed {ckpath} at sample {start_s}")
    out = None
    rays = []
    t0 = time.time()
    for s in range(start_s, args.spp):
        out = frame_mod.render_pathtrace(scene, bvh, fc, history, s,
                                         config=cfg, width=args.width,
                                         height=args.height, probe=probe)
        history = out["history"]
        rays.append(out["rays"])
        if s == start_s:
            _sync(device)
            print(f"[pt] first sample (incl. compile): "
                  f"{time.time() - t0:.1f}s")
            t0 = time.time()
    if out is None:
        # the checkpoint already holds every requested sample; colour is a
        # pure function of the accumulated history
        out = dict(color=post.to_uint8(post.tonemap(history, fc.exposure)),
                   history=history)
    _sync(device)
    if args.spp - start_s > 1:
        dt = (time.time() - t0) / (args.spp - start_s - 1)
        n = float(torch.stack(rays[1:]).mean())
        print(f"[pt] {dt * 1e3:.0f} ms/sample ({n / dt / 1e6:.2f} Mrays/s "
              f"counted)")
    if ckpath is not None:
        ckpath.parent.mkdir(parents=True, exist_ok=True)
        # a resumed checkpoint that already holds more than --spp samples
        # keeps its count (JAX's CLI saves --spp, and a later resume then
        # adds samples the history already holds a second time)
        np.savez(ckpath, history=history.cpu().numpy(),
                 next_sample=max(start_s, args.spp), width=args.width,
                 height=args.height, sample_grid=cfg.max_sample_count)
        print(f"[pt] checkpoint -> {ckpath}")
    io_mod.save_png(args.out, out["color"].cpu().numpy())
    print(f"[out] {args.out}")
    return dict(info, config=cfg, fc=fc, color=out["color"],
                history=history, rays=[float(r) for r in rays])


if __name__ == "__main__":
    main()
