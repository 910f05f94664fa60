#!/usr/bin/env python3
"""The RT shadow + HBAO frame alone on one card, K10 against its twin.

    python3 tools/torch_rt_frame_turns.py

It builds the atrium and its BVH (chip_smoke.atrium_path, as chip_smoke.py
does), renders one warm-up RT shadow + HBAO frame at 1920x1088, then 5
frames each, timed by CUDA events around render_frame (and by the host
clock): with K10; with the binning's twin (bin_triangles_layered_plain)
swapped in; with K10 again; with K10 after torch.cuda.set_sync_debug_mode
was set to "error" and back to "default" (as chip_smoke.py's no-sync phase
does); and with the twin after it. chip_smoke.py times this frame once,
after the path tracer's phases; this times it alone.
"""

import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from incarnation_tpu_torch.kernels import bvh, raster  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_rt_frame_turns: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    path = cs.atrium_path(dev)
    sbvh = bvh.build_scene_bvh(path.scene, device=dev)
    rt_cfg = path.cfg.replace(sun_shadow_mode="rt", enable_hbao=True,
                              use_bent_normals=True)
    fc = path.make_fc(0, None)
    hist0 = torch.zeros((cs.H, cs.W, 3), device=dev)

    def frames(label, n=5):
        out = []
        for _ in range(n):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s.record()
            path.run(fc, hist0, rt_cfg, sbvh)
            e.record()
            torch.cuda.synchronize()
            out.append((s.elapsed_time(e), (time.perf_counter() - t0) * 1e3))
        print(label, "event ms", [round(a, 1) for a, _ in out], "host ms",
              [round(b, 1) for _, b in out], flush=True)

    path.run(fc, hist0, rt_cfg, sbvh)
    k10 = raster.bin_triangles_layered
    frames("K10")
    raster.bin_triangles_layered = raster.bin_triangles_layered_plain
    frames("twin")
    raster.bin_triangles_layered = k10
    frames("K10")
    torch.cuda.set_sync_debug_mode("error")
    torch.cuda.set_sync_debug_mode("default")
    frames("K10 after sync debug mode")
    raster.bin_triangles_layered = raster.bin_triangles_layered_plain
    frames("twin after sync debug mode")
    raster.bin_triangles_layered = k10
    return 0


if __name__ == "__main__":
    sys.exit(main())
