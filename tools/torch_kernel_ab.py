#!/usr/bin/env python3
"""This checkout's CUDA kernels against another checkout's, on one card.

    mkdir -p trees/parent && git archive <commit> | tar -x -C trees/parent
    python3 tools/torch_kernel_ab.py trees/parent [--out FILE]

It renders one main-path frame of chip_smoke.py (the atrium at 1920x1088,
sun shadow map, 8 masked peels) and one forward frame of its small path
(512x256, 4 blend layers), captures every launch of K1, K2 and K3 with its
inputs, and times each launch with the other checkout's wrapper and with
this one's on the same inputs, by chip_smoke.device_ms, in the order
other, this, this, other, and keeps the smaller of each checkout's two
times (a stall of the host longer than the timer's spin only adds time).
K2 is timed twice: through each wrapper, and as
each C entry alone on the C-level arguments this checkout's wrapper makes
(`k2_clustered[entry]`), since the wrappers may differ in their host work.
Both must agree: K1 and K3 identical outputs, K2 each within 1e-3 of the
twin. It prints a line per kernel role and, last, one JSON object of the
mean times. The other checkout's wrappers and C entries must take the same
arguments as this one's (the kernels' contract).
"""

from __future__ import annotations

import argparse
import importlib
import json
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = "incarnation_tpu_torch"
# kind -> (kernel module, wrapper, reps per timing)
WRAPPERS = {"k1": ("raster", "rasterize_tiles", 10),
            "k2": ("clustered", "clustered_lighting", 20),
            "k3": ("taa", "history_fetch", 50)}


def _package_modules():
    return {k: v for k, v in sys.modules.items()
            if k == PKG or k.startswith(PKG + ".")}


def load_kernels(tree: pathlib.Path) -> dict:
    """The kernel modules (and build) of the package in `tree`, imported
    apart from this checkout's, whose modules stay as they were."""
    saved = _package_modules()
    for k in saved:
        del sys.modules[k]
    sys.path.insert(0, str(tree))
    try:
        mods = {n: importlib.import_module(f"{PKG}.kernels.{n}")
                for n in ("build", "raster", "clustered", "taa")}
    finally:
        sys.path.remove(str(tree))
        for k in _package_modules():
            del sys.modules[k]
        sys.modules.update(saved)
    for m in mods.values():
        if not pathlib.Path(m.__file__).resolve().is_relative_to(tree):
            raise RuntimeError(f"{m.__name__} came from {m.__file__}")
    return mods


def role(kind, kw):
    return (f"k1_raster[{kw.get('name', 'fine_raster')}]" if kind == "k1"
            else {"k2": "k2_clustered", "k3": "k3_taa_fetch"}[kind])


def agree(cs, kind, a, kw, outs, this):
    """The two checkouts' outputs of one launch agree, or raise: K1 and K3
    identical, K2 each within 1e-3 of the twin's value (the ceiling a K2
    tolerance may take; chip_smoke.py holds this checkout's to 1e-4)."""
    import torch
    (other_out, this_out) = outs
    if kind == "k2":
        ref = this["clustered"].clustered_lighting_plain(*a, **kw)
        for what, got in (("other", other_out), ("this", this_out)):
            _, rel = cs._close(f"{what} K2", got, ref, rtol=1e-3,
                               atol_frac=1e-5, where=a[0].mask)
            print(f"{what} checkout's K2: max relative error {rel:.3e} "
                  "against the twin", flush=True)
        return
    pairs = zip(other_out, this_out) if kind == "k1" \
        else [(other_out, this_out)]
    for x, y in pairs:
        if (x is None) != (y is None) or (x is not None
                                          and not torch.equal(x, y)):
            raise RuntimeError(f"{role(kind, kw)}: the checkouts' outputs "
                               "differ")


def k2_entry_call(clustered, a, kw):
    """-> (entry args, tensors they point into): the C-level arguments of
    this checkout's K2 wrapper (kernels/clustered.py clustered_lighting)
    for the wrapper arguments a, kw."""
    import torch
    from incarnation_tpu_torch.kernels.build import ptr
    gb, n, v, depth, lights, cluster_mask, config, near, width, height = a
    gx, gy, gz = clustered.cluster_grid_shape(config)
    held = dict(
        mask=gb.mask.to(torch.uint8).contiguous(),
        cmask=cluster_mask.contiguous(), rows=clustered.light_rows(lights),
        bounds=clustered._slice_bounds_on(
            float(near), config.cluster_depth_extent, gz, depth.device),
        out=torch.empty((height, width, 3), dtype=torch.float32,
                        device=depth.device))
    args = (ptr(gb.base_color), ptr(gb.mrao), ptr(n), ptr(v),
            ptr(gb.world_pos), ptr(held["mask"]), ptr(depth),
            ptr(held["cmask"]), held["cmask"].shape[1], ptr(held["rows"]),
            held["rows"].shape[0], ptr(held["bounds"]), gx, gy, gz,
            float(near), ptr(held["out"]), width, height)
    return args, held


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="the other checkout's root")
    ap.add_argument("--out", help="also write the JSON object here")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    other = load_kernels(pathlib.Path(args.other).resolve())
    from incarnation_tpu_torch.kernels import build, clustered, raster, taa
    this = dict(raster=raster, clustered=clustered, taa=taa)
    dev = torch.device("cuda")
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    for name, b in (("other", other["build"]), ("this", build)):
        secs, _ = b.timed_build()
        print(f"{name} checkout's kernels built in {secs:.1f} s", flush=True)

    # the launches of one main-path frame with a history, then the small
    # path's blend layers
    path = cs.atrium_path(dev)
    fc0 = path.make_fc(0, None)
    warm = path.run(fc0, torch.zeros((cs.H, cs.W, 3), device=dev))
    fc1 = path.make_fc(1, fc0.view_proj.cpu().numpy())
    path.run(fc1, warm["accumulation"])
    calls = [c for c in cs.capture_frame(path.run, fc1, warm["accumulation"],
                                         raster, clustered, taa)
             if c[0] in WRAPPERS]
    _, render = cs.small_renderer(dev)
    render(forward_lighting=True)
    small = cs.capture_frame(
        lambda fc, history: render(forward_lighting=True), None, None,
        raster, clustered, taa)
    calls += [c for c in small
              if c[0] == "k1" and c[2].get("name") == "raster_blend"]

    times: dict = {}
    for kind, a, kw in calls:
        mod, fn, reps = WRAPPERS[kind]
        impls = (getattr(other[mod], fn), getattr(this[mod], fn))
        agree(cs, kind, a, kw, [f(*a, **kw) for f in impls], this)
        runs = [cs.device_ms(lambda f=impls[i]: f(*a, **kw), reps)
                for i in (0, 1, 1, 0)]
        t = times.setdefault(role(kind, kw), {"other": [], "this": []})
        t["other"].append(min(runs[0], runs[3]))
        t["this"].append(min(runs[1], runs[2]))
        if kind == "k2":
            entry_args, held = k2_entry_call(clustered, a, kw)
            entries = (other["clustered"].K2, clustered.K2)
            runs = [cs.device_ms(lambda k=entries[i]: k(*entry_args), reps)
                    for i in (0, 1, 1, 0)]
            t = times.setdefault("k2_clustered[entry]",
                                 {"other": [], "this": []})
            t["other"].append(min(runs[0], runs[3]))
            t["this"].append(min(runs[1], runs[2]))

    summary = {}
    for name, t in times.items():
        o, s = float(np.mean(t["other"])), float(np.mean(t["this"]))
        summary[name] = dict(launches=len(t["this"]), other_ms=o, this_ms=s,
                             this_over_other=s / o,
                             other_per_launch=t["other"],
                             this_per_launch=t["this"])
        print(f"{name}: other {o:.4f} ms, this {s:.4f} ms per launch "
              f"({s / o:.3f}x) over {len(t['this'])} launches", flush=True)
    result = {"card": card, "other": str(args.other), "roles": summary}
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(result, indent=1))
    print(card, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
