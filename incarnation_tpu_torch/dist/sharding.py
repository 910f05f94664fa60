"""Band and SPP sharding over a list of torch devices (port of
incarnation_tpu/dist/sharding.py).

The image is split into horizontal bands, one per entry of `devices`, and
each band runs the whole raster frame on its device: a post-projection band
matrix maps the band's NDC y-range to [-1, 1], so setup, binning, raster
and resolve see an ordinary (H/n, W) viewport. One process drives every
device, with no mesh and no torch.distributed: what the JAX package
exchanges over ICI is a copy between the bands' tensors here. The frame
runs in two phases (renderer/frame.py render_hdr and finish_frame): every
band up to its HDR, then every band's TAA, which reads halo rows copied
from its neighbours: the whole history of the other bands above and below
it (H - H/n rows each way), so a reprojection reads the history row the
single frame reads however far it moves, and one row of current HDR each
way for the 3x3 clamp (JAX taa.py:272-290, :363-371). Past the image's
top and bottom the halo repeats the edge row, as the single frame's clamp
does. (JAX's bands borrow 16 history rows, its fetch kernel's reach, and
leave the single frame past 16 rows of vertical motion at a seam.) Every
noise of a band (the BLEND screen door and the stochastic filters) and its
checkerboard parity are taken from whole-frame rows (render_hdr's
band_row; the JAX bands hash their own rows and take their parity from
them, so their stochastic pixels differ from the single frame's). A chunk
capacity holds for each band's own chunks. Outputs are assembled on
devices[0] and the stats summed.

The scene, probe and BVH are given per device: one object, copied to each
distinct device of the list, or a list with one per entry. The same device
may be listed more than once (every band and every halo copy still runs).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import EnvSkyMode
from ..device import resolve_device
from ..kernels import pathtrace
from ..renderer import frame as frame_mod

def band_projection(n_bands: int, band_index: int) -> np.ndarray:
    """Post-projection matrix mapping band `band_index`'s NDC y-range to
    [-1, 1] (row-vector convention: clip' = clip @ J). Band 0 is the top of
    the image (NDC y near +1)."""
    j = np.eye(4, dtype=np.float32)
    j[1, 1] = float(n_bands)
    j[3, 1] = np.float32(1.0 - n_bands + 2.0 * band_index)
    return j


def to_device(obj, device):
    """obj with every tensor it holds (through dataclasses, named tuples,
    lists and tuples) on `device`; tensors already there are shared."""
    if torch.is_tensor(obj):
        return obj.to(device)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: to_device(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(to_device(x, device) for x in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_device(x, device) for x in obj)
    return obj


def per_device(obj, devices) -> list:
    """One copy of obj for each entry of devices (one copy per distinct
    device), or obj itself when it is already such a list."""
    if isinstance(obj, list):
        if len(obj) != len(devices):
            raise ValueError(f"{len(obj)} per-device objects for "
                             f"{len(devices)} devices")
        return obj
    copies = {}
    for d in devices:
        if str(d) not in copies:
            copies[str(d)] = None if obj is None else to_device(obj, d)
    return [copies[str(d)] for d in devices]


def _devices(devices) -> list:
    if not devices:
        raise ValueError("need at least one device")
    return [resolve_device(d) for d in devices]


def _band_constants(fc, n_bands: int, band_index: int, device):
    """fc on `device` with the band matrix applied: view_proj @ J,
    inv(J) @ inv_view_proj and prev_view_proj @ J, and their host copies
    (JAX sharding.py:93-103)."""
    j = band_projection(n_bands, band_index)
    j_inv = np.eye(4, dtype=np.float32)
    j_inv[1, 1] = np.float32(1.0 / n_bands)
    j_inv[3, 1] = -j[3, 1] / np.float32(n_bands)
    fc = to_device(fc, device)
    jt = torch.tensor(j, device=device)
    jt_inv = torch.tensor(j_inv, device=device)
    return dataclasses.replace(
        fc, view_proj=fc.view_proj @ jt,
        inv_view_proj=jt_inv @ fc.inv_view_proj,
        prev_view_proj=fc.prev_view_proj @ jt,
        inv_view_proj_np=j_inv @ fc.inv_view_proj_np,
        prev_view_proj_np=fc.prev_view_proj_np @ j)


def _rows_halo(bands, i: int, rows: int, device):
    """(rows above band i, rows below it): the `rows` rows of the whole
    image (the bands stacked) next to band i, with the image's first or
    last row repeated past its top and bottom edge."""
    top = bands[0][:1].to(device).expand(rows, -1, -1)
    bottom = bands[-1][-1:].to(device).expand(rows, -1, -1)
    above = torch.cat([top] + [b.to(device) for b in bands[:i]], 0)
    below = torch.cat([b.to(device) for b in bands[i + 1:]] + [bottom], 0)
    return above[above.shape[0] - rows:], below[:rows]


def render_frame_sharded(scene, fc, *, config, params, devices, probe=None,
                         env_brdf=None, history=None, scene_bvh=None):
    """render_frame with the image split into len(devices) horizontal
    bands, band i rendered on devices[i]. params describes the whole image;
    each band renders height / n rows (whole tiles). history: the whole
    (H, W, 3) TAA accumulation, or None. Returns render_frame's 'color',
    'tri', 'depth', 'hdr' and 'accumulation', whole-frame on devices[0],
    and 'stats' summed over the bands."""
    devs = _devices(devices)
    n = len(devs)
    if params.height % (n * params.tile_h):
        raise ValueError(
            f"height {params.height} must divide into {n} bands of whole "
            f"{params.tile_h}-row tiles")
    band_params = params._replace(height=params.height // n)
    hb = band_params.height
    scenes, probes, brdfs, bvhs = (per_device(x, devs) for x in
                                   (scene, probe, env_brdf, scene_bvh))

    # phase 1: every band up to its HDR
    states = [frame_mod.render_hdr(
        scenes[i], _band_constants(fc, n, i, d), config=config,
        params=band_params, probe=probes[i], env_brdf=brdfs[i],
        scene_bvh=bvhs[i], band_row=i * hb,
        taa_active=config.enable_taa and history is not None)
        for i, d in enumerate(devs)]

    # phase 2: every band's TAA, with its neighbours' halo rows
    hist_bands = (None if history is None else
                  [history[i * hb:(i + 1) * hb].to(d)
                   for i, d in enumerate(devs)])
    hdr_bands = [st["hdr"] for st in states]
    outs = []
    for i, d in enumerate(devs):
        hist = halo = None
        if hist_bands is not None:
            above, below = _rows_halo(hist_bands, i, params.height - hb, d)
            hist = torch.cat([above, hist_bands[i], below], 0)
            halo = _rows_halo(hdr_bands, i, 1, d)
        outs.append(frame_mod.finish_frame(states[i], hist, halo))

    home = devs[0]
    out = {k: torch.cat([o[k].to(home) for o in outs], 0)
           for k in ("color", "tri", "depth", "hdr", "accumulation")}
    out["stats"] = {k: sum(o["stats"][k].to(home) for o in outs)
                    for k in outs[0]["stats"]}
    return out


def _sample(scene, bvh, fc, probe, sample_index, config, width, height,
            **kw):
    """trace_sample of render_pathtrace's sample on one device."""
    scene_b, fc_b, world_n_v, world_t_v = frame_mod.pathtrace_inputs(
        scene, fc)
    return pathtrace.trace_sample(
        scene_b, bvh, world_n_v, world_t_v, fc_b, probe, sample_index,
        width, height,
        sqrt_sample_count=int(np.sqrt(config.max_sample_count)),
        dynamic_sky=(config.env_sky_mode == EnvSkyMode.DYNAMIC_SKY),
        turbidity=config.turbidity, viewmode=config.viewmode,
        sky_rot3=fc.scene_rotation[:3, :3], sun_dir_world=fc.sun_dir, **kw)


def pathtrace_band_sharded(scene, bvh, fc, history, sample_index, *,
                           config, width: int, height: int, devices,
                           probe=None):
    """Progressive path tracing with band i's rows [i H/n, (i+1) H/n) of
    every sample traced on devices[i], with whole-frame pixel ids, CMJ
    patterns and NDC (trace_sample's pixel_base and full_height), so each
    sample equals render_pathtrace's bit for bit. sample_index: an int or
    a sequence (a batched wavefront). Returns dict(history (H, W, 3) on
    devices[0], rays: the counted rays of every band, summed)."""
    devs = _devices(devices)
    n = len(devs)
    if height % n:
        raise ValueError(f"height {height} must divide into {n} bands")
    hb = height // n
    scenes, bvhs, probes = (per_device(x, devs) for x in (scene, bvh, probe))
    first = int(sample_index[0] if isinstance(sample_index, (list, tuple))
                else torch.as_tensor(sample_index).reshape(-1)[0])
    bands, rays = [], []
    for i, d in enumerate(devs):
        cur, r = _sample(scenes[i], bvhs[i], to_device(fc, d), probes[i],
                         sample_index, config, width, hb, return_rays=True,
                         pixel_base=i * hb * width, full_height=height)
        hist = history[i * hb:(i + 1) * hb].to(d)
        bands.append(pathtrace.integrate(hist, cur, first).to(devs[0]))
        rays.append(r.to(devs[0]))
    return dict(history=torch.cat(bands, 0), rays=sum(rays))


def pathtrace_spp_sharded(scene, bvh, fc, history, base_sample_index: int,
                          *, config, width: int, height: int, devices,
                          probe=None):
    """Sample base + i of every pixel traced on devices[i]; the samples'
    mean joins the history by the reference's ((n - 1) h + cur) / n rule
    for len(devices) samples a round (JAX sharding.py:199-231): h' =
    (h n0 + mean n_dev) / (n0 + n_dev), n0 = base_sample_index. -> the new
    (H, W, 3) history on devices[0]."""
    devs = _devices(devices)
    n = len(devs)
    scenes, bvhs, probes = (per_device(x, devs) for x in (scene, bvh, probe))
    cur = [_sample(scenes[i], bvhs[i], to_device(fc, d), probes[i],
                   int(base_sample_index) + i, config, width,
                   height).to(devs[0])
           for i, d in enumerate(devs)]
    mean = sum(cur) / float(n)
    n0 = float(base_sample_index)
    return (history.to(devs[0]) * n0 + mean * float(n)) / (n0 + float(n))
