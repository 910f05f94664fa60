#!/usr/bin/env python3
"""The raster frame's time and its phase breakdown on one card, for this
checkout or another one.

    mkdir -p trees/parent && git archive <commit> | tar -x -C trees/parent
    python3 tools/torch_frame_phases.py [TREE] [--frames 8] [--out FILE]

It imports chip_smoke.py from TREE (default: this checkout), builds that
checkout's kernels, builds the atrium (chip_smoke.atrium_path: its cache
under TREE/.content_cache; link it to this checkout's to build it once),
renders two warm-up frames and then FRAMES TAA frames of the main path at
1920x1088 with the camera's orbit, each timed by CUDA events around
render_frame, then chip_smoke.phase_breakdown of one more frame (a
synchronize around each phase, the mean of 3 frames). It prints one JSON
line {tree, card, frame_ms, phases}. To compare two checkouts on one card,
run it in one call for each in turns (a, b, b, a): each run is its own
process, so each imports its own package.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tree", nargs="?",
                    default=str(pathlib.Path(__file__).resolve().parents[1]))
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--out", help="also append the JSON line to this file")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_frame_phases: no CUDA card", file=sys.stderr)
        return 2
    tree = pathlib.Path(args.tree).resolve()
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
    frame_ms = []
    for i in range(2, 2 + args.frames):
        prev = fc.view_proj.cpu().numpy()
        fc = path.make_fc(i, prev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        hist = path.run(fc, hist)["accumulation"]
        end.record()
        torch.cuda.synchronize()
        frame_ms.append(start.elapsed_time(end))
    phases = cs.phase_breakdown(path.run, path.make_fc(2 + args.frames,
                                                       fc.view_proj.cpu()
                                                       .numpy()), hist)
    line = json.dumps(dict(tree=str(tree), card=cs.card_line(),
                           frame_ms=frame_ms, phases=phases))
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
