#!/usr/bin/env python3
"""This checkout's CUDA kernels against other checkouts', on one card.

    mkdir -p trees/parent && git archive <commit> | tar -x -C trees/parent
    python3 tools/torch_kernel_ab.py trees/parent [trees/other ...]
        [--kernels k1,k2,k3,k3r,k4,k5,k5d,k5s,k6,k8,k8s,k9,k10,k11,k12,k13,
                   k15]
        [--timeline]
        [--out FILE]

K1-K3: it renders one main-path frame of chip_smoke.py (the atrium at
1920x1088, sun shadow map, 8 masked peels, the stochastic estimators off
so that every checkout runs the same exact roles) and one forward frame of its
small path (512x256, 4 blend layers), captures every launch of K1, K2 and
K3 with its inputs, and times each launch with each other checkout's
wrapper and with this one's on the same inputs, by chip_smoke.device_ms,
in the order other, this, this, other, and keeps the smaller of each
checkout's two times (a stall of the host longer than the timer's spin
only adds time). K2 is timed twice: through each wrapper, and as
each C entry alone on the C-level arguments this checkout's wrapper makes
(`k2_clustered[entry]`), since the wrappers may differ in their host work.
Both must agree: K1 and K3 identical outputs, K2 each within 1e-3 of the
twin.

K3's resolve (k3r): the main-path frame's TAA resolve (taa_resolve, the
reprojected fetch), timed the same way: each checkout's output must equal
this checkout's twin (taa_resolve_plain) bit for bit, NaN for NaN. A
checkout that predates the resolve role is timed by its torch resolve
around its K3 fetch.

K5: the same two frames' launches of the material resolve (the main
frame's opaque layer; the small frame's opaque layer with the mapped
normal and its blend layers), timed the same way. Each checkout's planes
must be within chip_smoke.K5_RTOL of its own twin (resolve_gbuffer_plain),
and the planes in which the checkouts differ are printed (a checkout
that rounds the sRGB decode's reciprocals otherwise differs from this
one by an ulp in the base colour and the emissive). It
prints K5's registers, spill and shared-memory bytes per checkout, and
the count of each SASS opcode in its kernel (cuobjdump).

K6 and K5's checkerboard (k6, k5s): one main-path frame with the
estimators on (bench.py's frame: K6's peel step with the jittered texel
under the chunk ladder, K5's checkerboard role) and one with them off
(the step's exact role), their launches captured in this checkout
(chip_smoke.capture_frame). Each peel step is timed against each other
checkout's peel as its frame runs it where it predates the step: its
K6 role (masked_alpha) and the accumulate in torch (this checkout's
peel_plain, the peel loop's code, with the other's masked_alpha), and
the two must give
identical accumulators, z_limit and counts; each call of this checkout's
step takes a fresh copy of the captured state (the step updates it in
place); a checkout that has the step is timed by its own step. Then
each other checkout's K6 role alone against this one's on
the same layer, alpha and threshold identical. The checkerboard launch
of K5 is timed as the other K5 launches, its planes held as theirs.

K8's checkerboard (k8s): the sky lighting launch of the same frame with
the estimators on (K8's `jitter_checker` role), and the same layer in
K8's other stochastic roles (sky_cases): without the checkerboard (every
covered pixel fetching its texel: the `jitter` role), with the bilinear
fetch (`dither_checker`, `dither`) and with one lobe a pixel (`+lobe`,
extras from a seed), each checkout's output held to its own twin by
chip_smoke._k8_error and timed as above. It prints each checkout's
registers and SASS opcode counts of every k8_sky_ kernel.

K8 and K9: the main-path frame's launches of sky lighting (one) and of
triangle setup (the camera pass with attribute planes and the sun's
depth-only pass), timed the same way. The checkouts may round apart (a
redesign may fuse what its parent rounded twice), so each checkout's
output is held to its own twin: K8 by chip_smoke._k8_error (its maximum
absolute error printed), K9 bit for bit (chip_smoke._k9_error). It
prints each checkout's registers and SASS opcode counts of k8_sky_kernel
and k9_setup_kernel (both roles).

K10: the main-path frame's two binnings (the camera pass's three layers
and the sun's depth-only pass), timed the same way; each checkout's
bins must equal its own twin's (bin_triangles_layered_plain) and the
other checkout's, every output of every layer. Each checkout's device
time of each K10 step is printed too (chip_smoke._k10_steps_ms). With
--timeline, each checkout whose bin.cu has the K10_TIMELINE hooks is
built once more with -DK10_TIMELINE (a tool-only library beside its
kernels; the main path never loads it), and each binning runs once
through it: per step (counting, scatter, scan), the blocks' %globaltimer
start and end and their clock64() marks, printed as the median and the
longest block, when the last block starts, and the longest block's time
between its marks (k10_timeline).

K11 and K12: the main-path frame's light-cluster grid and sky background
(build_light_clusters, environment_background with the dynamic sky and
the frame's HDR given: K12's accumulate role), timed the same way: this
checkout's K11 and K12 must equal its twins bit for bit, and each other
checkout's output this checkout's twin (K11 every word and the count;
K12 within 1e-5 relative, since a checkout whose background is eager
torch sums its 4x4 product in cuBLAS's order). A checkout that predates
them is timed by its eager torch code, and one whose
environment_background takes no HDR by its background and the frame's
eager add to the HDR (as its frame runs them).

K15's map role (k15): the sun term with the map (shading.sun_term) of
the main-path frame with the estimators on and off, and of the same frame
lit by a sun that faces at least half of its covered pixels
(chip_smoke.half_lit_view), each checkout's sun_term on the captured
inputs timed the same way (a checkout that predates the tap inside K15
launches K14 and then K15), each output equal to this checkout's twin
(sun_term_plain) bit for bit, NaN for NaN.

K5's decal step and K13 (k5d, k13): the main-path frame's decal step
with the estimators on and off, and on chip_smoke.decal_view's view (its
decal layer covering at least 10,000 pixels), each this checkout's step
(bit for bit with its twin) timed against each other checkout's K5
launch on the decal layer, and against that launch with the frame's
eager decal code around it (chip_smoke._k5d_parent, within K5_RTOL of
this checkout's twin); the frame's frustum cull, this checkout's one
cull_lists launch against each other checkout's, or its two
cull_primitives launches where it predates cull_lists, every mask and
count equal to the twin's (decal_cull_ab).

K4: it builds the atrium's wide and binary BVHs, captures every K4 launch
of one path-traced sample at 640x360 (primary, bounce, shadow and their
alpha peels) and of one RT shadow + HBAO frame at 1920x1088 (HBAO, RT sun
and its peels), the binary layout's traces of the sample's first primary,
bounce and shadow rays, and alpha-filtered traces (noise 0) of the
sample's bounce rays (closest hit) and primary rays (any hit). Each
checkout's trace_k4 must equal its own twin (trace_plain: tri, t, u, v,
steps, trunc) on every launch, since the checkouts may round differently;
then each launch is timed as above. It prints K4's registers per compiled
role in each checkout, each role's mean ms per launch, and the summed ms
of K4's launches per PT sample and per RT frame; then it renders the
sample and the frame whole (host clock, a synchronize after each) with
each other checkout's trace_k4 and this one's in turns.

It prints a line per kernel role and, last, one JSON object of the times.
The other checkouts' wrappers and C entries must take the same arguments
as this one's (the kernels' contract).
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = "incarnation_tpu_torch"
# kind -> (kernel module, wrapper, reps per timing)
WRAPPERS = {"k1": ("raster", "rasterize_tiles", 10),
            "k2": ("clustered", "clustered_lighting", 20),
            "k3": ("taa", "history_fetch", 50),
            "k3r": ("taa", "taa_resolve", 50),
            "k5": ("resolve", "resolve_gbuffer", 20),
            "k8": ("skylight", "sky_lighting", 20),
            "k9": ("raster", "prepare_geometry", 20),
            "k10": ("raster", "bin_triangles_layered", 20),
            "k11": ("clustered", "build_light_clusters", 50),
            "k12": ("skylight", "environment_background", 20)}
# K3's resolve's, K8's and K9's sources and kernel names (a part of the
# compiled entry's name), whose registers and SASS opcode counts are
# printed
SASS = {"k3r": ("taa", "k3_taa_resolve_kernel"),
        "k8": ("skylight", "k8_sky_kernel"),
        "k8s": ("skylight", "k8_sky_"),
        "k9": ("setup", "k9_setup_kernel")}
# the K5 launches of a main-path frame and of the small forward frame, in
# launch order (renderer/frame.py): their roles (the decal layers are K5's
# decal step, kind k5d, timed by decal_cull_ab)
K5_MAIN = ("opaque",)
K5_SMALL = ("small_opaque_n3",)


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
                for n in ("build", "raster", "clustered", "taa", "bvh",
                          "pathtrace", "resolve", "skylight", "shading",
                          "cull")}
    finally:
        sys.path.remove(str(tree))
        for k in _package_modules():
            del sys.modules[k]
        sys.modules.update(saved)
    for m in mods.values():
        if not pathlib.Path(m.__file__).resolve().is_relative_to(tree):
            raise RuntimeError(f"{m.__name__} came from {m.__file__}")
    return mods


def role(kind, a, kw):
    if kind == "k10":
        return ("k10_bin[sun_depth_only]" if a[1].depth_only
                else "k10_bin[camera]")
    if kind == "k9":
        return ("k9_setup[camera]" if kw.get("emit_attributes", True)
                else "k9_setup[sun_depth_only]")
    return (f"k1_raster[{kw.get('name', 'fine_raster')}]" if kind == "k1"
            else {"k2": "k2_clustered", "k3": "k3_taa_fetch",
                  "k3r": "k3_taa_resolve",
                  "k8": "k8_sky_lighting", "k11": "k11_light_grid",
                  "k12": "k12_sky_background"}[kind])


# the stochastic estimators' arguments of K5, K6 and K8 at their values
# with the estimators off, as the tool renders: dropped from the captured
# calls, so that a checkout whose wrappers predate them takes the calls
ESTIMATORS_OFF = dict(mip_dither=None, uv_dither=False, max_aniso=16.0,
                      coverage_capacity=None, checker_parity=None, row0=0,
                      dither=None)


def with_roles(calls, k5_names):
    """calls as (kind, args, kwargs, role): a K5 launch's role is
    k5_names[its index among the K5 launches], 'small_blend' past them
    (the small frame's blend layers); K6's is None. The estimators'
    arguments at their off values are dropped (ESTIMATORS_OFF)."""
    out, n = [], 0
    for kind, a, kw in calls:
        kw = {k: v for k, v in kw.items()
              if not (k in ESTIMATORS_OFF and v == ESTIMATORS_OFF[k])}
        name = "k5_resolve[{}]".format(
            k5_names[n] if n < len(k5_names) else "small_blend") \
            if kind == "k5" else role(kind, a, kw) if kind in WRAPPERS \
            else None
        n += kind == "k5"
        out.append((kind, a, kw, name))
    return out


def sass_mix(build_mod, source: str, function: str) -> dict:
    """{opcode: count} of `function`'s SASS in the built csrc/<source>.cu
    library (cuobjdump -sass), the opcode without its modifiers; {} where
    the toolkit has no cuobjdump."""
    import re
    import shutil
    import subprocess
    tool = shutil.which("cuobjdump") or str(
        pathlib.Path(build_mod._nvcc()).with_name("cuobjdump"))
    if not pathlib.Path(tool).exists():
        return {}
    text = subprocess.run([tool, "-sass", str(build_mod._target(source))],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts, inside = {}, False
    for line in text.splitlines():
        if "Function :" in line:
            inside = function in line
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                      r"([A-Z][A-Z0-9_]*)", line) if inside else None
        if m:
            counts[m.group(1)] = counts.get(m.group(1), 0) + 1
    return dict(sorted(counts.items(), key=lambda kv: -kv[1]))


def k5_agree(cs, a, kw, outs, mods, name):
    """The two checkouts' K5 planes of one launch each within
    chip_smoke.K5_RTOL of its own twin, or raise; prints each plane in
    which the checkouts differ (elements and the largest difference)."""
    import torch

    def planes(out):
        gb, n3 = out if isinstance(out, tuple) else (out, None)
        fields = ("base_color", "normals", "mrao", "emissive", "mask",
                  "world_pos", "uv", "extras")
        return dict([(f, getattr(gb, f)) for f in fields]
                    + ([] if n3 is None else [("n3", n3)]))
    ours, theirs = planes(outs[1]), planes(outs[0])
    for f, x in ours.items():
        y = theirs[f]
        if not torch.equal(x.view(torch.uint8), y.view(torch.uint8)):
            diff = (x.double() - y.double()).abs()
            print(f"{name}: the checkouts' {f} differ at "
                  f"{int((x != y).sum())} elements, by at most "
                  f"{float(diff.nan_to_num(0.0).max()):.3e}", flush=True)
    for out, m in zip(outs, mods):
        cs._k5_error(out, m["resolve"].resolve_gbuffer_plain(*a, **kw))


def agree(cs, kind, a, kw, outs, this, other, name):
    """The two checkouts' outputs of one launch agree, or raise: K1 and K3
    identical, K3's resolve each equal to this checkout's twin, K2 each within 1e-3 of the twin's value (the ceiling a K2
    tolerance may take; chip_smoke.py holds this checkout's to 1e-4); K5
    by k5_agree; K8, K9 and K10 each held to its own checkout's twin (K10
    also to the other checkout's bins); K11 and K12 this checkout's
    exactly, the other's K11 identical to this checkout's twin and its K12
    within 1e-5 relative."""
    import torch
    (other_out, this_out) = outs
    if kind == "k3r":
        ref = this["taa"].taa_resolve_plain(*a, **kw)
        for what, out in (("other", other_out), ("this", this_out)):
            cs._same_or_nan(f"{name} ({what} checkout)", out, ref)
        return
    if kind == "k11":
        ref = this["clustered"].build_light_clusters_plain(*a, **kw)
        for out in (other_out, this_out):
            cs._k11_error(out, ref)
        return
    if kind == "k12":
        ref = this["skylight"].environment_background_plain(*a, **kw)
        cs._k12_error(this_out, ref)
        _, rel = cs._close("other K12", other_out, ref, rtol=1e-5,
                           atol_frac=1e-6)
        print(f"{name}: other checkout's max relative error {rel:.3e} "
              "against this checkout's twin", flush=True)
        return
    if kind == "k5":
        k5_agree(cs, a, kw, outs, (other, this), name)
        return
    if kind == "k8":
        for what, out, m in (("other", other_out, other),
                             ("this", this_out, this)):
            err, _ = cs._k8_error(out, m["skylight"].sky_lighting_plain(
                *a, **kw), a[0].mask)
            print(f"{name}: {what} checkout's K8 max abs error {err:.3e} "
                  "against its own twin", flush=True)
        return
    if kind == "k9":
        for out, m in ((other_out, other), (this_out, this)):
            cs._k9_error(out, m["raster"].prepare_geometry_plain(*a, **kw))
        return
    if kind == "k10":
        for out, m in ((other_out, other), (this_out, this)):
            cs._k10_error(out, m["raster"].bin_triangles_layered_plain(
                *a, **kw))
        cs._k10_error(other_out, this_out)
        return
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
            raise RuntimeError(f"{name}: the checkouts' outputs differ")


# k10_timeline's rows (csrc/bin.cu K10_TIMELINE): steps (a checkout with
# fewer leaves the rest zero), blocks, slots;
# then blocks, warps, walks (the counting step's and the scatter's),
# (groups, steps, cycles)
K10_TL = (3, 4096, 8)
K10_TLW = (4096, 16, 2, 3)
K10_TL_STEPS = ("count", "scatter", "scan")
K10_TL_WALKS = ("count_pairs", "scatter_walk")


def timeline_lib(mods):
    """The checkout's bin.cu built with -DK10_TIMELINE into its build
    directory, loaded; None if its source has no timeline hooks."""
    build = mods["build"]
    src = build.CSRC / "bin.cu"
    text = src.read_bytes()
    if b"K10_TIMELINE" not in text:
        return None
    flags = [*build._FLAGS, "-DK10_TIMELINE"]
    tag = hashlib.sha1(text + " ".join(flags).encode()).hexdigest()[:12]
    target = build.BUILD_DIR / f"libbin-timeline-{tag}.so"
    if not target.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([build._nvcc(), *flags, "-o", str(target), str(src)],
                       check=True)
    lib = ctypes.CDLL(str(target))
    lib.k10_timeline.argtypes = [ctypes.c_void_p]
    lib.k10_timeline.restype = ctypes.c_int
    return lib


def _read_timeline(lib):
    """(block rows, warp rows) of the last binning; the warp rows stay zero
    where the checkout's marks have none."""
    n = int(np.prod(K10_TL))
    buf = np.zeros(n + int(np.prod(K10_TLW)), dtype=np.uint64)
    rc = lib.k10_timeline(buf.ctypes.data)
    if rc:
        raise RuntimeError(f"k10_timeline failed: cudaError {rc}")
    buf = buf.astype(np.int64)
    return buf[:n].reshape(K10_TL), buf[n:].reshape(K10_TLW)


def k10_timeline(mods, lib, a, kw) -> dict:
    """One binning through the checkout's timeline build: for each step,
    its blocks' start and end (ns, %globaltimer, from the first block's
    start), the median and longest block, and the longest block's clock64
    cycles between its marks."""
    import torch
    build, raster = mods["build"], mods["raster"]
    saved = build._LIBS.get("bin"), raster.K10._f
    build._LIBS["bin"], raster.K10._f = lib, {}
    try:
        raster.bin_triangles_layered(*a, **kw)
        torch.cuda.synchronize()
        _read_timeline(lib)
        raster.bin_triangles_layered(*a, **kw)
        torch.cuda.synchronize()
        rows, warps = _read_timeline(lib)
    finally:
        build._LIBS["bin"], raster.K10._f = saved
        if saved[0] is None:
            del build._LIBS["bin"]
    seen = [r[r[:, 0] > 0] for r in rows]
    t0 = min(int(r[:, 0].min()) for r in seen if len(r))
    out = {}
    for name, r in zip(K10_TL_STEPS, seen):
        if not len(r):
            continue
        dur = r[:, 1] - r[:, 0]
        longest = int(np.argmax(dur))
        marks = r[longest, 3:]
        marks = marks[marks > 0]
        med = int(np.argsort(dur)[len(dur) // 2])
        med_marks = r[med, 3:]
        med_marks = med_marks[med_marks > 0]
        out[name] = dict(
            blocks=len(r), sms=int(len(set(r[:, 2].tolist()))),
            first_start_us=(int(r[:, 0].min()) - t0) / 1e3,
            last_start_us=(int(r[:, 0].max()) - t0) / 1e3,
            last_end_us=(int(r[:, 1].max()) - t0) / 1e3,
            median_block_us=float(np.median(dur)) / 1e3,
            longest_block_us=int(dur[longest]) / 1e3,
            longest_block=int(np.flatnonzero(rows[K10_TL_STEPS.index(name),
                                                  :, 0] > 0)[longest]),
            longest_starts_us=(int(r[longest, 0]) - t0) / 1e3,
            longest_cycles_between_marks=np.diff(marks).tolist(),
            median_cycles_between_marks=np.diff(med_marks).tolist())
    # each warp's walks: the slowest, the median cycles a group or step,
    # and the scatter's longest block warp by warp
    for i, name in enumerate(K10_TL_WALKS):
        w = warps[:, :, i, :]
        on = w[..., 2] > 0
        if not on.any():
            continue
        blk, wp = np.unravel_index(np.argmax(np.where(on, w[..., 2], -1)),
                                   on.shape)
        units = w[..., 0] + w[..., 1]
        per = w[..., 2][on & (units > 0)] / units[on & (units > 0)]
        out[name] = dict(
            slowest=dict(block=int(blk), warp=int(wp),
                         groups=int(w[blk, wp, 0]), steps=int(w[blk, wp, 1]),
                         cycles=int(w[blk, wp, 2])),
            median_cycles_a_group_or_step=float(np.median(per))
            if per.size else None)
        if "scatter" in out and name != "count_pairs":
            blk = out["scatter"]["longest_block"]
            out[name]["longest_block_warps"] = [
                [int(x) for x in w[blk, j]] for j in range(w.shape[1])
                if w[blk, j, 2] > 0]
    return out


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


def time_pair(cs, f_other, f_this, reps):
    """(other ms, this ms): each the smaller of two device_ms runs, in the
    order other, this, this, other."""
    runs = [cs.device_ms(f, reps) for f in (f_other, f_this, f_this,
                                            f_other)]
    return min(runs[0], runs[3]), min(runs[1], runs[2])


def host_pair(cs, f_other, f_this, reps):
    """(other ms, this ms) of the wrappers' host work a call
    (chip_smoke.host_ms): each the smaller of two runs, in the order
    other, this, this, other."""
    runs = [cs.host_ms(f, reps) for f in (f_other, f_this, f_this,
                                          f_other)]
    return min(runs[0], runs[3]), min(runs[1], runs[2])


def k1_to_k5(cs, others, this, dev, times, kinds, timelines=None):
    """K1-K3, K5 and K8-K12 (those of kinds) of one main-path frame and
    the small path's blend layers (K1) and K5 launches, each launch timed
    with each other checkout's wrapper and this one's; appends to
    times[(other, role)]."""
    import torch
    raster, clustered, taa = this["raster"], this["clustered"], this["taa"]
    path = cs.atrium_path(dev)

    def run(fc, history):
        # the estimators off: the exact roles every checkout has
        return path.run(fc, history, cs.exact_config(path.cfg))
    fc0 = path.make_fc(0, None)
    warm = run(fc0, torch.zeros((cs.H, cs.W, 3), device=dev))
    fc1 = path.make_fc(1, fc0.view_proj.cpu().numpy())
    run(fc1, warm["accumulation"])
    kinds = kinds & set(WRAPPERS)
    calls = [c for c in with_roles(cs.capture_frame(
        run, fc1, warm["accumulation"], raster, clustered, taa),
        K5_MAIN) if c[0] in kinds
        and (c[0] != "k3r" or cs._k3r_calls(taa, [c[:3]]))]
    _, render = cs.small_renderer(dev)
    render(forward_lighting=True)
    small = cs.capture_frame(
        lambda fc, history: render(forward_lighting=True), None, None,
        raster, clustered, taa)
    calls += [c for c in with_roles(small, K5_SMALL) if c[0] in kinds and (
        c[0] == "k5" or c[0] == "k1" and c[2].get("name") == "raster_blend")]
    for kind, a, kw, role_name in calls:
        if kind == "k5":
            tri, _, scene, interp = a[:4]
            print(f"{role_name}: {tri.shape[1]}x{tri.shape[0]}, covered "
                  f"share {float((tri >= 0).float().mean()):.4f}, "
                  f"{json.dumps(cs.k5_footprints(this['resolve'], tri, scene, interp))}",
                  flush=True)
    for name, other in others:
        for kind, a, kw, role_name in calls:
            mod, fn, reps = WRAPPERS[kind]
            impls = (getattr(other[mod], fn), getattr(this[mod], fn))
            if kind == "k12":
                impls = (with_hdr(impls[0]), impls[1])
            agree(cs, kind, a, kw, [f(*a, **kw) for f in impls], this, other,
                  role_name)
            t_o, t_t = time_pair(cs, lambda: impls[0](*a, **kw),
                                 lambda: impls[1](*a, **kw), reps)
            t = times.setdefault((name, role_name),
                                 {"other": [], "this": []})
            t["other"].append(t_o)
            t["this"].append(t_t)
            if kind == "k10":
                for what, f in (("other", impls[0]), ("this", impls[1])):
                    steps = cs._k10_steps_ms(lambda: f(*a, **kw))
                    print(f"{role_name}: {what} checkout's device ms by "
                          f"step (profiler) " + json.dumps(
                              {k: round(v, 4) for k, v in steps.items()}),
                          flush=True)
                for what, m in (("other", other), ("this", this)):
                    lib = (timelines or {}).get(id(m))
                    if lib is not None:
                        tl = k10_timeline(m, lib, a, kw)
                        print(f"{role_name}: {what} checkout's per-block "
                              f"timeline {json.dumps(tl)}", flush=True)
            if kind == "k2":
                entry_args, held = k2_entry_call(clustered, a, kw)
                entries = (other["clustered"].K2, clustered.K2)
                t_o, t_t = time_pair(cs, lambda: entries[0](*entry_args),
                                     lambda: entries[1](*entry_args), reps)
                t = times.setdefault((name, "k2_clustered[entry]"),
                                     {"other": [], "this": []})
                t["other"].append(t_o)
                t["this"].append(t_t)


def with_hdr(fn):
    """environment_background of a checkout, taking hdr= as this
    checkout's does: its own where it has the accumulate role, else its
    background plus the eager add to the HDR, as its frame ran them."""
    import inspect
    if "hdr" in inspect.signature(fn).parameters:
        return fn

    def call(*a, hdr=None, **kw):
        out = fn(*a, **kw)
        return out if hdr is None else hdr + out
    return call


def sun_term_ab(cs, others, this, dev, times):
    """K15's map role (k15): the sun term of the main-path frame with the
    estimators on and off and of the half-lit view, each checkout's
    sun_term timed on the captured inputs in turns and held to this
    checkout's twin bit for bit; appends to times[(other, role)]."""
    import torch
    raster, clustered, taa = this["raster"], this["clustered"], this["taa"]
    shading = this["shading"]
    path = cs.atrium_path(dev)
    exact = cs.exact_config(path.cfg)

    def run(fc, history):
        return path.run(fc, history)

    def run_exact(fc, history):
        return path.run(fc, history, exact)
    hist = {}
    for what, r in (("on", run), ("off", run_exact)):
        fc0 = path.make_fc(0, None)
        warm = r(fc0, torch.zeros((cs.H, cs.W, 3), device=dev))
        hist[what] = warm["accumulation"]
    fc1 = path.make_fc(1, fc0.view_proj.cpu().numpy())
    on = cs.capture_frame(run, fc1, hist["on"], raster, clustered, taa)
    off = cs.capture_frame(run_exact, fc1, hist["off"], raster, clustered,
                           taa)
    lit_on, lit_off = cs.half_lit_view(run, run_exact, path.make_fc, on,
                                       fc1.view_proj.cpu().numpy(),
                                       hist["on"], hist["off"])
    cases = []
    for role_name, calls in (("on", on), ("off", off), ("lit_half", lit_on),
                             ("lit_half_exact", lit_off)):
        xs = [cs._bound_args(shading.sun_term_plain, a, kw)
              for kind, a, kw in calls if kind == "k15"]
        x = next(x for x in xs if x["shadow_map"] is not None)
        lit = int(cs._k15_lit(x).sum())
        print(f"k15_sun_term[{role_name}]: {int(x['gb'].mask.sum())} "
              f"covered pixels, {lit} lit", flush=True)
        cases.append((f"k15_sun_term[{role_name}]", x))
    for name, other in others:
        for role_name, x in cases:
            impls = (other["shading"].sun_term, shading.sun_term)
            ref = shading.sun_term_plain(**x)
            for what, f in (("other", impls[0]), ("this", impls[1])):
                cs._same_or_nan(f"{role_name} ({what} checkout)", f(**x),
                                ref)
            t_o, t_t = time_pair(cs, lambda: impls[0](**x),
                                 lambda: impls[1](**x), 50)
            _record(times, (name, role_name), t_o, t_t)


def decal_cull_ab(cs, others, this, dev, times, kinds):
    """K5's decal step (k5d) and K13's two lists (k13): the main-path
    frame's decal step with the estimators on and off and on the view
    whose decal layer covers at least 10,000 pixels (chip_smoke.decal_view),
    and its cull_lists launch, captured in this checkout. This
    checkout's step must equal its twin bit for bit; it is timed in turns
    against each other checkout's K5 launch on the decal layer
    (resolve_gbuffer under the capacity: `k5_decal_step[<case>]`) and
    against that launch with the frame's eager decal code around it
    (chip_smoke._k5d_parent on the other checkout's resolve module:
    `k5_decal_step[<case>]+glue`, its planes within K5_RTOL of this
    checkout's twin). This checkout's cull_lists is timed against the
    other checkout's, or its two cull_primitives launches where it has
    no cull_lists (`k13_cull`), every mask and count equal to this
    checkout's twin. Each pair is also
    timed on the host in the same turns (host_pair, the wrappers' host
    work a call: `[host]`). Appends to times[(other, role)]."""
    import torch
    raster, clustered, taa = this["raster"], this["clustered"], this["taa"]
    resolve, cull = this["resolve"], this["cull"]
    path = cs.atrium_path(dev)
    exact = cs.exact_config(path.cfg)

    def run(fc, history):
        return path.run(fc, history)

    def run_exact(fc, history):
        return path.run(fc, history, exact)
    hist = {}
    for what, r in (("on", run), ("off", run_exact)):
        fc0 = path.make_fc(0, None)
        hist[what] = r(fc0, torch.zeros((cs.H, cs.W, 3),
                                        device=dev))["accumulation"]
    prev = fc0.view_proj.cpu().numpy()
    fc1 = path.make_fc(1, prev)
    on = cs.capture_frame(run, fc1, hist["on"], raster, clustered, taa)
    off = cs.capture_frame(run_exact, fc1, hist["off"], raster, clustered,
                           taa)
    cases = [("on", on), ("off", off)]
    if "k5d" in kinds:
        view_on, view_off = cs.decal_view(path, run_exact, prev, hist["on"],
                                          hist["off"])
        cases += [("decal_view", view_on), ("decal_view_exact", view_off)]
    for name, other in others:
        for case, calls in cases if "k5d" in kinds else ():
            x, = [kw for kind, _, kw in calls if kind == "k5d"]
            cs._k5d_error(resolve, x)
            ref = cs._k5d_run(resolve.decal_step_plain, x)
            glue = cs._k5d_parent(other["resolve"], x)
            for g, r in zip(glue[1:], ref[1:]):
                if g is not None:
                    cs._close(f"k5_decal_step[{case}] (other checkout)", g,
                              r, rtol=cs.K5_RTOL, atol_frac=1e-5)
            y = cs._k5d_clone(x)
            k5 = [x[k] for k in ("d_tri", "d_depth", "scene", "d_interp",
                                 "inv_view_proj", "width", "height")]
            kw = {k: x[k] for k in ("coverage_capacity", "mip_dither",
                                    "uv_dither", "max_aniso", "row0")}
            t_o, t_t = time_pair(
                cs, lambda: other["resolve"].resolve_gbuffer(*k5, **kw),
                lambda: resolve.decal_step(**y), 20)
            _record(times, (name, f"k5_decal_step[{case}]"), t_o, t_t)
            t_o, t_t = time_pair(
                cs, lambda: cs._k5d_parent(other["resolve"], x),
                lambda: resolve.decal_step(**y), 20)
            _record(times, (name, f"k5_decal_step[{case}]+glue"), t_o, t_t)
            _record(times, (name, f"k5_decal_step[{case}]+glue[host]"),
                    *host_pair(cs, lambda: cs._k5d_parent(other["resolve"],
                                                          x),
                               lambda: resolve.decal_step(**y), 50))
        if "k13" in kinds:
            (a, kw), = [(a, kw) for kind, a, kw in on if kind == "k13"]
            x = cs._bound_args(cull.cull_lists_plain, a, kw)
            rest = [x[k] for k in ("mesh_transforms", "mesh_visible",
                                   "scene_rotation", "view_proj")]
            ref = cull.cull_lists_plain(**x)
            if hasattr(other["cull"], "cull_lists"):
                def theirs():
                    return other["cull"].cull_lists(**x)
            else:
                def theirs():
                    return [other["cull"].cull_primitives(b, m, *rest)
                            for b, m in x["lists"]]
            for got, r in zip(list(cull.cull_lists(**x)) + theirs(),
                              ref + ref):
                cs._k13_error(got, r)
            t_o, t_t = time_pair(cs, theirs, lambda: cull.cull_lists(**x),
                                 50)
            _record(times, (name, "k13_cull"), t_o, t_t)
            _record(times, (name, "k13_cull[host]"),
                    *host_pair(cs, theirs, lambda: cull.cull_lists(**x),
                               100))


def _record(times, key, t_o, t_t):
    t = times.setdefault(key, {"other": [], "this": []})
    t["other"].append(t_o)
    t["this"].append(t_t)


def peel_and_checker(cs, others, this, dev, times, kinds):
    """K6's peel steps (k6), K5's checkerboard launch (k5s) and K8's
    (k8s) of two main-path frames, the estimators on and off, each timed
    against each other checkout's (see the module's doc); appends to
    times[(other, role)]."""
    import dataclasses
    import torch
    res = this["resolve"]
    path = cs.atrium_path(dev)
    reps = 10
    for config in (path.cfg, cs.exact_config(path.cfg)):
        def run(fc, history, config=config):
            return path.run(fc, history, config)
        fc0 = path.make_fc(0, None)
        warm = run(fc0, torch.zeros((cs.H, cs.W, 3), device=dev))
        fc1 = path.make_fc(1, fc0.view_proj.cpu().numpy())
        run(fc1, warm["accumulation"])
        calls = cs.capture_frame(run, fc1, warm["accumulation"],
                                 this["raster"], this["clustered"],
                                 this["taa"])
        steps = [cs._k6_args(a, kw) for kind, a, kw in calls if kind == "k6"]
        checker = [x for x in (cs._k5_args(a, kw) for kind, a, kw in calls
                               if kind == "k5")
                   if cs._k5_role(x) == "jitter_checker"]
        sky = [case for x in (
            cs._bound_args(this["skylight"].sky_lighting_plain, a, kw)
            for kind, a, kw in calls if kind == "k8")
            if cs._k8_role(x) == "jitter_checker"
            for case in sky_cases(dict(x), dev)]
        for name, other in others:
            for x in steps if "k6" in kinds else []:
                role = cs._k6_role(x)

                if hasattr(other["resolve"], "masked_peel"):
                    # a checkout with the step: its step, on fresh copies
                    ostates = iter([cs._peel_clone(x["state"])
                                    for _ in range(2 * (2 * reps + 1) + 1)])

                    def glue(x=x, other=other, ostates=ostates):
                        return other["resolve"].masked_peel(
                            **dict(x, state=next(ostates)))
                else:
                    # one without: its K6 role and the peel loop's torch
                    # code, which leaves the state as it was
                    def glue(x=x, other=other):
                        with cs._swapped(res, "masked_alpha",
                                         other["resolve"].masked_alpha):
                            return res.peel_plain(**x)
                got, ref = cs._k6_step(res, x), glue()
                for f in dataclasses.fields(ref):
                    if not torch.equal(getattr(got, f.name),
                                       getattr(ref, f.name)):
                        raise RuntimeError(f"k6_peel[{role}]: {f.name} "
                                           "differs from the other's peel")
                states = iter([cs._peel_clone(x["state"])
                               for _ in range(2 * (2 * reps + 1))])
                _record(times, (name, f"k6_peel[{role}]"), *time_pair(
                    cs, glue, lambda x=x: res.masked_peel(
                        **dict(x, state=next(states))), reps))
                a = cs._k6_alpha_args(x)
                impls = (other["resolve"].masked_alpha, res.masked_alpha)
                outs = [f(**a) for f in impls]
                if not all(torch.equal(p, q) for p, q in zip(*outs)):
                    raise RuntimeError(f"k6_masked_alpha[{role}]: the "
                                       "checkouts' alpha tests differ")
                _record(times, (name, f"k6_masked_alpha[{role[5:]}]"),
                        *time_pair(cs, lambda: impls[0](**a),
                                   lambda: impls[1](**a), 20))
            for x in checker if "k5s" in kinds else []:
                impls = (other["resolve"].resolve_gbuffer,
                         res.resolve_gbuffer)
                k5_agree(cs, (), x, [f(**x) for f in impls], (other, this),
                         "k5_resolve[jitter_checker]")
                _record(times, (name, "k5_resolve[jitter_checker]"),
                        *time_pair(cs, lambda: impls[0](**x),
                                   lambda: impls[1](**x), 20))
                # the same layer with every covered pixel fetching its
                # jittered texel (the role without the checkerboard)
                y = dict(x, checker_parity=None)
                _record(times, (name, "k5_resolve[jitter, same layer]"),
                        *time_pair(cs, lambda: impls[0](**y),
                                   lambda: impls[1](**y), 20))
            for role, y in sky if "k8s" in kinds else []:
                impls = (other["skylight"].sky_lighting,
                         this["skylight"].sky_lighting)
                for what, f, m in (("other", impls[0], other),
                                   ("this", impls[1], this)):
                    err, _ = cs._k8_error(
                        f(**y), m["skylight"].sky_lighting_plain(**y),
                        y["gb"].mask)
                    print(f"k8_sky_lighting[{role}]: {what} checkout's "
                          f"K8 max abs error {err:.3e} against its own "
                          "twin", flush=True)
                _record(times, (name, f"k8_sky_lighting[{role}]"),
                        *time_pair(cs, lambda: impls[0](**y),
                                   lambda: impls[1](**y), 20))


def sky_cases(x, dev):
    """The k8s cases of a captured `jitter_checker` launch x of K8:
    (role, arguments) for the launch itself and the same layer in K8's
    other stochastic roles: without the checkerboard (every covered pixel
    fetching: `jitter`), the bilinear fetch of the dithered mip
    (uv_dither off: `dither_checker`, `dither`), and one lobe a pixel
    (`+lobe`: extras, transmission, clearcoat and its roughness, uniform
    in [0, 1) from seed 0)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(0)
    extras = torch.rand(x["gb"].mask.shape + (3,), generator=g, device=dev)
    flat = dict(checker_parity=None)
    bilinear = dict(uv_dither=False)
    lobe = dict(extras=extras)
    return [("jitter_checker", x),
            ("jitter, same layer", dict(x, **flat)),
            ("dither_checker, same layer", dict(x, **bilinear)),
            ("dither, same layer", dict(x, **bilinear, **flat)),
            ("jitter_checker+lobe, same layer", dict(x, **lobe)),
            ("jitter+lobe, same layer", dict(x, **lobe, **flat))]


# K4 launches captured from the binary layout and the alpha role: (group,
# role, source role of the rays, any hit, alpha filter)
K4_EXTRA = (("binary", "binary_primary", "pt_primary", False, False),
            ("binary", "binary_bounce", "pt_bounce", False, False),
            ("binary", "binary_shadow", "pt_shadow", True, False),
            ("alpha", "alpha_closest_bounce", "pt_bounce", False, True),
            ("alpha", "alpha_anyhit_primary", "pt_primary", True, True))


def k4_launches(cs, this, dev):
    """-> ([(group, role, (bvh, o, d, tmin, tmax, any_hit, scene or
    None))], {group: a function that renders it}): every K4 launch of one
    path-traced sample (group pt_sample) and of one RT shadow + HBAO frame
    (rt_frame), then the K4_EXTRA traces (scene: the alpha role's, with
    noise 0)."""
    import torch
    from incarnation_tpu_torch.renderer import frame
    bvh = this["bvh"]
    path = cs.atrium_path(dev)
    sbvh = bvh.build_scene_bvh(path.scene, device=dev)
    cfg = path.cfg
    fc = frame.FrameConstants.make(
        cs.bench_view(path.host, cs.PT_W, cs.PT_H), cfg, sun_dir=path.sun,
        sun_color_intensity=[1.0, 1.0, 1.0, 100.0],
        shadow_bounds=path.shadow_bounds, device=dev)

    def sample(i, history):
        return frame.render_pathtrace(path.scene, sbvh, fc, history, i,
                                      config=cfg, width=cs.PT_W,
                                      height=cs.PT_H, probe=path.probe)

    history = sample(0, torch.zeros((cs.PT_H, cs.PT_W, 3), device=dev))[
        "history"]
    launches = []

    def keep(group):
        def after(out, b, o, d, tmin=0.0, tmax=1e30, any_hit=False,
                  role=None, alpha_of=None, **kw):
            if alpha_of is not None:
                raise RuntimeError(f"{group}: an alpha-filtered launch")
            launches.append((group, role, (b, o, d, tmin, tmax, any_hit,
                                           None)))
        return after
    with cs._hooked(bvh, "trace_k4", keep("pt_sample")):
        sample(1, history)
    rt_cfg = cfg.replace(sun_shadow_mode="rt", enable_hbao=True,
                         use_bent_normals=True)
    hist0 = torch.zeros((cs.H, cs.W, 3), device=dev)
    fc_rt = path.make_fc(0, None)

    def rt_frame():
        path.run(fc_rt, hist0, rt_cfg, sbvh)
    with cs._hooked(bvh, "trace_k4", keep("rt_frame")):
        rt_frame()
    first = {}
    for _, r, call in launches:
        first.setdefault(r, call)
    bb = bvh.build_scene_bvh(path.scene, wide=False, device=dev)
    for group, r, src, any_hit, alpha in K4_EXTRA:
        _, o, d, tmin, tmax, _, _ = first[src]
        launches.append((group, r, (bb if group == "binary" else sbvh, o, d,
                                    tmin, tmax, any_hit,
                                    path.scene if alpha else None)))
    torch.cuda.synchronize()
    return launches, {"pt_sample": lambda: sample(1, history),
                      "rt_frame": rt_frame}


def wall_ms(fn, reps: int) -> float:
    """Mean ms of fn() over reps runs, each ended by a synchronize (the
    host's clock: a path-traced sample and a frame wait on the host)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def k4_ab(cs, others, this, dev, times):
    """K4 on the launches of k4_launches: each checkout against its own
    twin on every launch, then each launch timed with each other checkout
    and this one; appends to times[(other, role)] and returns (the
    launch-weighted totals per group, the end-to-end times)."""
    import torch
    launches, renders = k4_launches(cs, this, dev)
    trees = [("this", this)] + list(others)

    def tracer(mods, spec):
        # every checkout's bvh imports this one's pathtrace.AlphaFilter
        # (its relative import meets this package in sys.modules)
        b, o, d, tmin, tmax, any_hit, scene = spec
        flt = None if scene is None else this["pathtrace"].AlphaFilter(
            scene, torch.zeros(o.shape[0], device=dev))
        return (lambda **kw: mods["bvh"].trace_k4(
            b, o, d, tmin, tmax, any_hit, alpha_of=flt, **kw),
            lambda: mods["bvh"].trace_plain(b, o, d, tmin, tmax, any_hit,
                                            return_steps=True, alpha_of=flt))

    totals: dict = {}
    for group, r, spec in launches:
        fns = {name: tracer(mods, spec) for name, mods in trees}
        for name, (k4, twin) in fns.items():
            got, ref = k4(return_steps=True), twin()
            for k in ("tri", "t", "u", "v", "steps"):
                if not torch.equal(got[k], ref[k]):
                    raise RuntimeError(
                        f"{name} checkout's K4 {r}: {k} differs from its "
                        f"twin on {int((got[k] != ref[k]).sum())} rays")
            if int(got["trunc"]) or int(ref["trunc"]):
                raise RuntimeError(f"{name} checkout's K4 {r}: trunc")
        for name, _ in others:
            t_o, t_t = time_pair(cs, fns[name][0], fns["this"][0], 5)
            print(f"  {group} k4_trace[{r}] {spec[1].shape[0]} rays: "
                  f"{name} {t_o:.4f} ms, this {t_t:.4f} ms", flush=True)
            t = times.setdefault((name, f"k4_trace[{r}]"),
                                 {"other": [], "this": []})
            t["other"].append(t_o)
            t["this"].append(t_t)
            g = totals.setdefault((name, group), {"other": 0.0, "this": 0.0,
                                                  "launches": 0})
            g["other"] += t_o
            g["this"] += t_t
            g["launches"] += 1
    # the sample and the frame whole, with each checkout's K4 in turns
    ends = {}
    for name, mods in others:
        for group, fn in renders.items():
            def with_k4(m):
                def run():
                    with cs._swapped(this["bvh"], "trace_k4",
                                     m["bvh"].trace_k4):
                        fn()
                return run
            runs = [wall_ms(with_k4(m), 3)
                    for m in (mods, this, this, mods)]
            ends[(name, group)] = {"other": [runs[0], runs[3]],
                                   "this": [runs[1], runs[2]]}
            print(f"{group} end to end with {name}'s K4 and this one's, in "
                  f"turns: {', '.join(f'{x:.2f}' for x in runs)} ms",
                  flush=True)
    return totals, ends


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("others", nargs="+", help="the other checkouts' roots")
    ap.add_argument("--kernels", default="k1,k2,k3,k4",
                    help="comma-separated: k1, k2, k3, k5 (two frames' "
                         "launches), k3r, k8, k9, k10, k11, k12 (the main "
                         "frame's), k15 (the sun term with the map), k4, "
                         "k6, k5s and k8s (the peel steps and K5's and "
                         "K8's checkerboards of frames with the "
                         "estimators on and off), k5d and k13 (K5's "
                         "decal step and K13's two lists against the "
                         "launches they replaced)")
    ap.add_argument("--timeline", action="store_true",
                    help="with k10: each checkout's per-block timeline of "
                         "its counting and scatter steps")
    ap.add_argument("--out", help="also write the JSON object here")
    args = ap.parse_args(argv)
    kinds = set(args.kernels.split(","))

    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    others = [(str(o), load_kernels(pathlib.Path(o).resolve()))
              for o in args.others]
    from incarnation_tpu_torch.kernels import (build, bvh, clustered, cull,
                                               pathtrace, raster, resolve,
                                               shading, skylight, taa)
    this = dict(build=build, raster=raster, clustered=clustered, taa=taa,
                bvh=bvh, pathtrace=pathtrace, resolve=resolve,
                skylight=skylight, shading=shading, cull=cull)
    dev = torch.device("cuda")
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    registers, k5_registers, sass = {}, {}, {}
    for name, mods in [("this", this)] + others:
        secs, logs = mods["build"].timed_build(verbose=True)
        print(f"{name} checkout's kernels built in {secs:.1f} s", flush=True)
        if "k4" in kinds:
            res = cs.k4_resources(mods["build"], logs.get("bvh"))
            registers[name] = {
                f"any_hit={int(k[0])},layout={k[1]},alpha={int(k[2])}": v
                for k, v in sorted(res.items())}
            print(f"{name} checkout's K4 (registers, spill bytes) by role: "
                  f"{json.dumps(registers[name])}", flush=True)
        if "k5" in kinds:
            k5_registers[name] = cs.k5_resources(mods["build"],
                                                 logs.get("resolve"))
            k5_registers[name]["sass"] = sass_mix(
                mods["build"], "resolve", "k5_resolve_kernel")
            print(f"{name} checkout's K5: {json.dumps(k5_registers[name])}",
                  flush=True)
        if kinds & {"k6", "k5s"}:
            res = cs.kernel_resources(mods["build"], "resolve", "k[56]_",
                                      logs.get("resolve"))
            print(f"{name} checkout's K5 and K6 kernels (registers, spill "
                  f"and shared bytes): {json.dumps(res)}", flush=True)
        for kind in sorted(kinds & set(SASS)):
            src, fn = SASS[kind]
            try:
                res = cs.kernel_resources(mods["build"], src, fn,
                                          logs.get(src))
            except RuntimeError:        # a checkout that predates it
                print(f"{name} checkout has no {fn}", flush=True)
                continue
            for entry, r in res.items():
                r["sass"] = sass_mix(mods["build"], src, entry)
            sass.setdefault(name, {})[kind] = res
            print(f"{name} checkout's {fn}: {json.dumps(res)}", flush=True)

    timelines = {}
    if args.timeline and "k10" in kinds:
        for name, mods in [("this", this)] + others:
            timelines[id(mods)] = lib = timeline_lib(mods)
            print(f"{name} checkout's K10 timeline build: "
                  f"{'none (no hooks)' if lib is None else 'built'}",
                  flush=True)
    times: dict = {}
    if kinds & set(WRAPPERS):
        k1_to_k5(cs, others, this, dev, times, kinds, timelines)
    if kinds & {"k6", "k5s", "k8s"}:
        peel_and_checker(cs, others, this, dev, times, kinds)
    if "k15" in kinds:
        sun_term_ab(cs, others, this, dev, times)
    if kinds & {"k5d", "k13"}:
        decal_cull_ab(cs, others, this, dev, times, kinds)
    totals, ends = {}, {}
    if "k4" in kinds:
        totals, ends = k4_ab(cs, others, this, dev, times)

    summary = {}
    for (other, name), t in times.items():
        o, s = float(np.sum(t["other"])), float(np.sum(t["this"]))
        n = len(t["this"])
        summary.setdefault(other, {})[name] = dict(
            launches=n, other_ms=o / n, this_ms=s / n,
            this_over_other=s / o, other_per_launch=t["other"],
            this_per_launch=t["this"])
        print(f"{name} against {other}: other {o / n:.4f} ms, this "
              f"{s / n:.4f} ms per launch ({s / o:.3f}x) over {n} launches",
              flush=True)
    groups = {}
    for (other, group), g in totals.items():
        groups.setdefault(other, {})[group] = dict(
            g, this_over_other=g["this"] / g["other"])
        print(f"K4 per {group} against {other}: other {g['other']:.4f} ms, "
              f"this {g['this']:.4f} ms over {g['launches']} launches "
              f"({g['this'] / g['other']:.3f}x)", flush=True)
    for (other, group), e in ends.items():
        groups.setdefault(other, {}).setdefault(group, {})[
            "end_to_end_ms"] = e
    result = {"card": card, "others": args.others, "roles": summary,
              "k4_groups": groups, "k4_registers": registers,
              "k5_resources": k5_registers, "k8_k9_resources": sass}
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(result, indent=1))
    print(card, flush=True)
    print(json.dumps({k: v for k, v in result.items() if k != "roles"}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
