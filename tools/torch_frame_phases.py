#!/usr/bin/env python3
"""The raster frame's time and its phase breakdown on one card, for this
checkout or another one.

    mkdir -p trees/parent && git archive <commit> | tar -x -C trees/parent
    python3 tools/torch_frame_phases.py [TREE] [--frames 8]
        [--phase-frames 3] [--out FILE]
    python3 tools/torch_frame_phases.py TREE_A TREE_B [--frames 8]
        [--phase-frames 3] [--out FILE]

It imports chip_smoke.py from TREE (default: this checkout), builds that
checkout's kernels, builds the atrium (chip_smoke.atrium_path: its cache
under TREE/.content_cache; link it to this checkout's to build it once),
renders two warm-up frames and then FRAMES TAA frames of the main path at
1920x1088 with the camera's orbit, each timed by CUDA events around
render_frame, then the same FRAMES frames with the stochastic estimators
off (chip_smoke.exact_config), then chip_smoke.phase_breakdown of one more
frame of the main path (a
synchronize around each phase, the mean of PHASE_FRAMES frames), and
counts what
the frame launches per masked peel beside K1's peel (this checkout's
chip_smoke.peel_launches, on that tree's modules: the eager torch
operators between one peel's K1 call and the next's) and for its decal
layer (chip_smoke.decal_launches: from K1's decal call to the sun pass).
It prints one JSON line {tree, card, frame_ms, frame_ms_exact, phases,
peel_ops, peel_op_names, decal_ops, decal_op_names, decal_kernels}.

Given two trees it compares them on one card: it runs itself once per tree
in turns, a, b, b, a, each run its own process (so each imports its own
package), then prints per tree the frame times of both of its runs and
the phases that the kernels of the last slices move (triangle setup,
raster.prepare_geometry; sky lighting, skylight.sky_lighting; the
light-cluster grid, clustered.build_light_clusters; the sky background,
skylight.environment_background; the camera
pass's binning, raster.bin_triangles_layered; the sun pass with its own
setup, binning and raster, shadow.render_sun_shadow_map; the resolve, the
peels' alpha tests and the shadow tap, which the stochastic estimators
change; the two frustum culls, cull.cull_primitives; the sun's BRDF,
shading.brdf_response, or the whole sun term with the tap inside it,
shading.sun_term; the TAA resolve, taa.taa_resolve; the decal step,
resolve.decal_step; the frustum cull of both lists, cull.cull_lists), the
frame glue, and the eager operators per peel and of the decal layer. The peels' alpha test is
resolve.masked_alpha in a tree whose frame runs the accumulate in torch,
and resolve.masked_peel (K6's peel step, the accumulate in it) in one
whose frame calls that; the first's accumulate counts to its glue, so
`peels+glue` (both phases and the glue) is the sum that compares like
with like; `sun+tap` (the tap and the sun's BRDF or its whole term) is
the same for the sun (a tree whose sun term taps the map inside K15 has
no shadow.sun_visibility phase), and `sky+glue` for the sky background
(a tree whose frame adds the background to the HDR in torch books that
add in its glue; one whose K12 writes the HDR, in the background).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import subprocess
import sys

# the phases PR-to-PR comparisons print
COMPARED = ("raster.prepare_geometry", "skylight.sky_lighting",
            "clustered.build_light_clusters",
            "skylight.environment_background",
            "raster.bin_triangles_layered", "shadow.render_sun_shadow_map",
            "resolve.resolve_gbuffer", "resolve.masked_alpha",
            "resolve.masked_peel", "shadow.sun_visibility",
            "shading.brdf_response", "shading.sun_term", "sun+tap",
            "taa.taa_resolve", "cull.cull_primitives", "cull.cull_lists",
            "resolve.decal_step", "glue", "peels+glue", "sky+glue",
            "resolve+glue", "culls")
# phases summed to compare like with like across trees: the peels with the
# glue (a tree whose frame accumulates the peels in torch), and the sun's
# tap with its BRDF (a tree whose sun term is shading.sun_term, the tap
# inside it, or brdf_response beside the tap), the sky background with
# the glue (where the frame's add of the background to the HDR runs), the
# resolve with the glue (a tree whose frame resolves the decal layer by K5
# and composites it in torch, or by K5's decal step), and the frustum
# culls (two cull_primitives calls, or one cull_lists)
SUMS = {"peels+glue": ("resolve.masked_alpha", "resolve.masked_peel",
                       "glue"),
        "sun+tap": ("shadow.sun_visibility", "shading.brdf_response",
                    "shading.sun_term"),
        "sky+glue": ("skylight.environment_background", "glue"),
        "resolve+glue": ("resolve.resolve_gbuffer", "resolve.decal_step",
                         "glue"),
        "culls": ("cull.cull_primitives", "cull.cull_lists")}


def in_turns(trees, frames: int, phase_frames: int, out) -> int:
    """Run this script on trees a, b, b, a (each a process of its own),
    then print each tree's frame times and COMPARED phases."""
    order = list(trees) + list(reversed(trees))
    runs = []
    for tree in order:
        proc = subprocess.run(
            [sys.executable, __file__, tree, "--frames", str(frames),
             "--phase-frames", str(phase_frames)]
            + (["--out", out] if out else []),
            capture_output=True, text=True, check=False)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            print(proc.stdout[-4000:], flush=True)
            print(f"torch_frame_phases: the run on {tree} failed",
                  file=sys.stderr)
            return proc.returncode
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append(line)
        print(json.dumps(line), flush=True)
    for tree in trees:
        mine = [r for r in runs if r["tree"] == str(pathlib.Path(tree)
                                                    .resolve())]
        frames_ms = [t for r in mine for t in r["frame_ms"]]
        exact_ms = sorted(t for r in mine for t in r.get("frame_ms_exact",
                                                          []))
        for r in mine:
            for name, parts in SUMS.items():
                r["phases"][name] = sum(r["phases"].get(k, 0.0)
                                        for k in parts)
        phases = {k: [round(r["phases"].get(k, 0.0), 3) for r in mine]
                  for k in COMPARED}
        print(f"{tree}: frames {min(frames_ms):.2f}-{max(frames_ms):.2f} ms "
              f"over {len(frames_ms)} (median "
              f"{sorted(frames_ms)[len(frames_ms) // 2]:.2f}), the "
              f"estimators off "
              + (f"{exact_ms[0]:.2f}-{exact_ms[-1]:.2f} (median "
                 f"{exact_ms[len(exact_ms) // 2]:.2f})" if exact_ms
                 else "not run") + "; phases ms "
              f"(runs in order) {json.dumps(phases)}; eager operators per "
              f"peel {[r['peel_ops'] for r in mine]}; of the decal layer "
              f"{[r.get('decal_ops') for r in mine]}", flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*",
                    default=[str(pathlib.Path(__file__).resolve()
                                 .parents[1])],
                    help="one tree, or two to compare in turns")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--phase-frames", type=int, default=3,
                    help="frames the phase breakdown takes the mean of")
    ap.add_argument("--out", help="also append the JSON line to this file")
    args = ap.parse_args(argv)
    if len(args.trees) > 2:
        ap.error("one tree, or two to compare")
    if len(args.trees) == 2:
        return in_turns(args.trees, args.frames, args.phase_frames,
                        args.out)
    import torch
    if not torch.cuda.is_available():
        print("torch_frame_phases: no CUDA card", file=sys.stderr)
        return 2
    tree = pathlib.Path(args.trees[0]).resolve()
    sys.path.insert(0, str(tree))
    import chip_smoke as cs
    from incarnation_tpu_torch.kernels import build
    if not str(pathlib.Path(build.__file__).resolve()).startswith(str(tree)):
        raise RuntimeError(f"imported the package from {build.__file__}, "
                           f"not from {tree}")
    build.build_all()
    dev = torch.device("cuda")
    path = cs.atrium_path(dev)
    fc0 = path.make_fc(0, None)
    hist = path.run(fc0, torch.zeros((cs.H, cs.W, 3), device=dev))[
        "accumulation"]
    prev = fc0.view_proj.cpu().numpy()
    fc = path.make_fc(1, prev)
    hist = path.run(fc, hist)["accumulation"]
    torch.cuda.synchronize()
    fc1, hist1 = fc, hist

    def frames(config):
        nonlocal fc, hist
        fc, hist, times = fc1, hist1, []
        for i in range(2, 2 + args.frames):
            prev = fc.view_proj.cpu().numpy()
            fc = path.make_fc(i, prev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            hist = path.run(fc, hist, config)["accumulation"]
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return times
    frame_ms_exact = frames(cs.exact_config(path.cfg))
    frame_ms = frames(path.cfg)
    fc_next = path.make_fc(2 + args.frames, fc.view_proj.cpu().numpy())
    phases = cs.phase_breakdown(path.run, fc_next, hist,
                                reps=args.phase_frames)
    # this checkout's launch count, on the tree's K1 wrapper and kernels
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", pathlib.Path(__file__).resolve().parents[1]
        / "chip_smoke.py")
    here = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(here)
    from incarnation_tpu_torch.kernels import raster, resolve
    per, names, _ = here.peel_launches(path.run, fc_next, hist, raster,
                                       (raster.K1, resolve.K6))
    decal_ops, decal_names, decal_kernels = here.decal_launches(
        path.run, fc_next, hist, raster, (raster.K1, resolve.K5))
    line = json.dumps(dict(tree=str(tree), card=cs.card_line(),
                           frame_ms=frame_ms,
                           frame_ms_exact=frame_ms_exact, phases=phases,
                           peel_ops=per,
                           peel_op_names=names, decal_ops=decal_ops,
                           decal_op_names=decal_names,
                           decal_kernels=decal_kernels))
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
