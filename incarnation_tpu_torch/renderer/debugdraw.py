"""Debug drawing: wireframe primitives and lines over the rendered frame
(port of incarnation_tpu/renderer/debugdraw.py).

The reference's FDebugDraw queues shape commands (cube/icosphere/sphere/
cylinder/cone/plane from content/debug/debug-primitives.gltf), expands them
to indirect draws in a compute shader, and ExecuteIndirects wireframes with
read-only GREATER_EQUAL depth (ref: src/renderer.cpp:724-1346,
shaders/debug-drawing/*). Shaders can self-append via reserved UAV slots.

Here the shape generators emit world-space line segments on the host
(numpy); segments are projected, sampled parametrically and splatted into
the colour image with a depth test against the frame's depth buffer, one
dense scatter on the device in place of indirect draws. Used by
show_object_bounds / show_light_bounds (ref: ui.cpp:584-630).
"""

from __future__ import annotations

import numpy as np
import torch


def box_edges(lo, hi):
    """AABB wireframe -> (12, 2, 3)."""
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    c = np.array([[lo[0], lo[1], lo[2]], [hi[0], lo[1], lo[2]],
                  [hi[0], hi[1], lo[2]], [lo[0], hi[1], lo[2]],
                  [lo[0], lo[1], hi[2]], [hi[0], lo[1], hi[2]],
                  [hi[0], hi[1], hi[2]], [lo[0], hi[1], hi[2]]], np.float32)
    e = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
         (0, 4), (1, 5), (2, 6), (3, 7)]
    return np.stack([c[list(p)] for p in e])


def sphere_edges(center, radius, segments: int = 24):
    """Three great circles -> (3 * segments, 2, 3)."""
    center = np.asarray(center, np.float32)
    t = np.linspace(0, 2 * np.pi, segments + 1)
    out = []
    for axes in [(0, 1), (0, 2), (1, 2)]:
        pts = np.zeros((segments + 1, 3), np.float32)
        pts[:, axes[0]] = np.cos(t)
        pts[:, axes[1]] = np.sin(t)
        pts = center + radius * pts
        out.append(np.stack([pts[:-1], pts[1:]], axis=1))
    return np.concatenate(out)


def draw_lines(color_u8, depth, segments, line_colors, view_proj,
               samples_per_segment: int = 128, seg_mask=None):
    """Splat line segments over the frame (GREATER_EQUAL read-only depth,
    matching the reference's debug-draw depth state).

    color_u8: (H, W, 3) uint8; depth: (H, W) reverse-Z; segments: (N, 2, 3);
    line_colors: (N, 3) float; seg_mask: optional (N,) bool (unset
    segments draw nothing: the device append buffer's padding). Segments
    and colours may be numpy arrays or tensors. Where samples of different
    colours land on one pixel, which one stays is unspecified.
    """
    h, w = depth.shape
    dev = depth.device
    seg = torch.as_tensor(segments, dtype=torch.float32, device=dev)
    t = torch.linspace(0.0, 1.0, samples_per_segment, device=dev)
    pts = (seg[:, None, 0] * (1 - t[None, :, None])
           + seg[:, None, 1] * t[None, :, None])      # (N, S, 3)
    pts = pts.reshape(-1, 3)
    clipc = torch.cat([pts, torch.ones_like(pts[:, :1])], -1) @ view_proj
    wclip = clipc[:, 3]
    ok = wclip > 1e-3
    if seg_mask is not None:
        ok = ok & torch.repeat_interleave(seg_mask, samples_per_segment)
    ndc = clipc[:, :3] / torch.where(ok, wclip, 1.0)[:, None]
    fx = (ndc[:, 0] * 0.5 + 0.5) * w
    fy = (-ndc[:, 1] * 0.5 + 0.5) * h
    z = ndc[:, 2]
    # Range test on the floats, cast after: a float-to-int cast of a huge
    # or non-finite value differs between devices. Truncation toward zero
    # maps (-1, 0) to pixel 0, as the reference's int cast does.
    inside = ok & (fx > -1.0) & (fx < w) & (fy > -1.0) & (fy < h)
    pxc = torch.where(inside, fx, 0.0).to(torch.int64)
    pyc = torch.where(inside, fy, 0.0).to(torch.int64)
    # read-only GREATER_EQUAL depth test with small bias
    visible = inside & (z >= depth[pyc, pxc] - 1e-4)
    cols = torch.repeat_interleave(
        torch.as_tensor(line_colors, dtype=torch.float32, device=dev),
        samples_per_segment, dim=0)
    cols_u8 = (torch.clamp(cols, 0, 1) * 255).to(torch.uint8)
    flat = color_u8.reshape(-1, 3).clone()
    idx = (pyc * w + pxc)[visible]
    flat[idx] = cols_u8[visible]
    return flat.reshape(h, w, 3)


class DebugShape:
    """Wireframe primitive shapes (ref: renderer.cpp:724-737 loads Cube/
    Icosphere/Sphere/Cylinder/Cone/Plane from debug-primitives.gltf)."""
    CUBE = 0
    ICOSPHERE = 1
    SPHERE = 2
    CYLINDER = 3
    CONE = 4
    PLANE = 5
    COUNT = 6


def _circle_pts(radius, y, segments):
    t = np.linspace(0, 2 * np.pi, segments + 1)
    return np.stack([radius * np.cos(t), np.full_like(t, y),
                     radius * np.sin(t)], axis=-1).astype(np.float32)


def _ring_segments(pts):
    return np.stack([pts[:-1], pts[1:]], axis=1)


def _icosahedron_edges():
    """Unit icosahedron wireframe -> (30, 2, 3)."""
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array([[-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
                  [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
                  [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1]],
                 np.float32)
    v /= np.linalg.norm(v[0])
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
             (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
             (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
             (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    edges = set()
    for a, b, c in faces:
        for e in [(a, b), (b, c), (c, a)]:
            edges.add((min(e), max(e)))
    return np.stack([v[list(e)] for e in sorted(edges)])


def primitive_edges(shape: int, transform=None, segments: int = 16):
    """Unit wireframe primitive -> (N, 2, 3) world-space line segments.
    Shapes match the reference's Blender-exported debug-primitives.gltf:
    unit radius / half-extent 1, y-up, centered at the origin (cylinder/
    cone span y in [-1, 1], cone apex at +y).

    transform: optional (4, 4) row-vector world transform."""
    if shape == DebugShape.CUBE:
        segs = box_edges([-1, -1, -1], [1, 1, 1])
    elif shape == DebugShape.ICOSPHERE:
        segs = _icosahedron_edges()
    elif shape == DebugShape.SPHERE:
        out = []
        for frac in np.linspace(-0.75, 0.75, 5):   # latitude rings
            y = np.sin(frac * np.pi / 2.0)
            out.append(_ring_segments(
                _circle_pts(np.sqrt(max(1 - y * y, 0.0)), y, segments)))
        t = np.linspace(0, np.pi, segments // 2 + 1)
        # pole-to-pole half-arcs at 8 azimuths = 4 full great circles
        for a in np.linspace(0, 2 * np.pi, 9)[:-1]:    # meridians
            pts = np.stack([np.sin(t) * np.cos(a), np.cos(t),
                            np.sin(t) * np.sin(a)], axis=-1)
            out.append(_ring_segments(pts.astype(np.float32)))
        segs = np.concatenate(out)
    elif shape == DebugShape.CYLINDER:
        top = _circle_pts(1.0, 1.0, segments)
        bot = _circle_pts(1.0, -1.0, segments)
        side = np.stack([bot[:-1:4], top[:-1:4]], axis=1)
        segs = np.concatenate([_ring_segments(top), _ring_segments(bot),
                               side])
    elif shape == DebugShape.CONE:
        base = _circle_pts(1.0, -1.0, segments)
        apex = np.tile(np.asarray([0, 1.0, 0], np.float32),
                       (base[:-1:4].shape[0], 1))
        side = np.stack([base[:-1:4], apex], axis=1)
        segs = np.concatenate([_ring_segments(base), side])
    elif shape == DebugShape.PLANE:
        c = np.array([[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1]],
                     np.float32)
        segs = np.stack([c, np.roll(c, -1, axis=0)], axis=1)
    else:
        raise ValueError(f"unknown debug shape {shape}")
    if transform is not None:
        t = np.asarray(transform, np.float32)
        segs = segs @ t[:3, :3] + t[3, :3]
    return segs.astype(np.float32)


class DebugDraw:
    """CPU-queued wireframe primitive commands splatted at flush — the
    rebuild of the reference's FDebugDraw command queue + indirect expand
    (ref: renderer.cpp:920-1346: DrawPrimitive appends FDebugDrawCmd,
    Flush uploads + ExecuteIndirects wireframes with read-only
    GREATER_EQUAL depth). What a device pass wants drawn goes through the
    device append buffer below (ddraw_append)."""

    MAX_COMMANDS = 256      # parity with renderer.h:54

    def __init__(self):
        self._queued = []       # (segments, colors)
        self._persistent = []

    def draw_primitive(self, shape: int, color, transform=None,
                       persistent: bool = False):
        segs = primitive_edges(shape, transform)
        cols = np.tile(np.asarray(color, np.float32)[:3], (segs.shape[0], 1))
        target = self._persistent if persistent else self._queued
        if len(self._queued) + len(self._persistent) < self.MAX_COMMANDS:
            target.append((segs, cols))

    def flush(self, color_u8, depth, view_proj):
        """Draw all queued + persistent commands over the frame and clear
        the per-frame queue (ref: renderer.cpp:1326-1341 clears counts)."""
        cmds = self._persistent + self._queued
        self._queued = []
        if not cmds:
            return color_u8
        segs = np.concatenate([s for s, _ in cmds])
        cols = np.concatenate([c for _, c in cmds])
        return draw_lines(color_u8, depth, segs, cols, view_proj)


def _np(t) -> np.ndarray:
    return t.cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def scene_bounds_segments(scene, scene_rotation=None):
    """World-space wireframe spheres for every primitive's bounds
    (show_object_bounds; ref: ui.cpp:604-630 + debug-draw shapes)."""
    xf = _np(scene.mesh_transforms)
    segs, cols = [], []
    m = scene.meta
    bs = _np(scene.prim_bsphere)[:m.num_primitives]
    pm = _np(scene.prim_mesh)[:m.num_primitives]
    for i in range(m.num_primitives):
        t = xf[pm[i]]
        c = bs[i, :3] @ t[:3, :3] + t[3, :3]
        scale = np.abs(t[:3, :3]).sum(axis=1).max()
        s = sphere_edges(c, bs[i, 3] * scale, segments=16)
        segs.append(s)
        cols.append(np.tile([1.0, 0.8, 0.1], (s.shape[0], 1)))
    return (np.concatenate(segs), np.concatenate(cols))


def light_bounds_segments(scene):
    """Green spheres at punctual lights (ref: light-culling.hlsl
    SHOW_LIGHT_BOUNDS debug path)."""
    lt = scene.lights
    n = int(lt.count)
    segs, cols = [], []
    for i in range(n):
        if int(lt.type[i]) == 0:   # directional
            continue
        pos = _np(lt.transform[i])[3, :3]
        rng = float(lt.range[i]) or 4.0
        s = sphere_edges(pos, rng, segments=16)
        segs.append(s)
        cols.append(np.tile([0.0, 1.0, 0.0], (s.shape[0], 1)))
    if not segs:
        return None, None
    return np.concatenate(segs), np.concatenate(cols)


# ---------------------------------------------------------------------------
# Device-side append buffer: debug draws appended by the frame's own passes.
# The reference reserves UAV slots + an atomic counter so any GPU pass can
# append draw commands from shader code (ref: debug-drawing/common.hlsli:
# 33-95 DrawDebugPrimitive / counter at MAX_DEBUG_DRAW_COMMANDS). Here a
# fixed-capacity (CAP, 10) f32 buffer + count is threaded through the
# frame: pass results that live on the device (the culling mask, the
# light-cluster bitmask) append rows with a cumsum scatter, and the
# expand/draw also runs on the device, with no host round trip.
# Row layout: [shape, cx, cy, cz, ex, ey, ez, r, g, b]
# ---------------------------------------------------------------------------

DDRAW_CAP = 128
DDRAW_SPHERE = 0.0
DDRAW_BOX = 1.0
_DDRAW_SEGS_PER_ROW = 48     # 3 rings x 16 (sphere); box uses 12 + padding


def ddraw_new(cap: int = DDRAW_CAP, device=None):
    """-> (buffer (cap, 10) f32 zeros, count () i32 zero) on `device`
    (None = the CUDA card)."""
    from ..device import resolve_device
    device = resolve_device(device)
    return (torch.zeros((cap, 10), dtype=torch.float32, device=device),
            torch.zeros((), dtype=torch.int32, device=device))


def ddraw_append(buf, count, rows, mask):
    """Append rows (M, 10) where mask (M,) is set, the functional
    replacement for the reference's UAV-counter atomic append. Rows beyond
    capacity drop; count saturates at capacity."""
    cap = buf.shape[0]
    mask = mask.to(torch.int32)
    pos = count + torch.cumsum(mask, 0) - 1
    keep = (mask > 0) & (pos < cap)
    buf = buf.clone()
    buf[pos[keep].long()] = rows[keep]
    total = count + mask.sum()
    return buf, torch.clamp(total, max=cap).to(torch.int32)


def _unit_sphere_segments(segments: int = 16) -> np.ndarray:
    out = []
    t = np.linspace(0, 2 * np.pi, segments + 1)
    for axes in [(0, 1), (0, 2), (1, 2)]:
        pts = np.zeros((segments + 1, 3), np.float32)
        pts[:, axes[0]] = np.cos(t)
        pts[:, axes[1]] = np.sin(t)
        out.append(np.stack([pts[:-1], pts[1:]], axis=1))
    return np.concatenate(out)                       # (3*segments, 2, 3)


def _unit_box_segments() -> np.ndarray:
    return box_edges([-1, -1, -1], [1, 1, 1])        # (12, 2, 3)


def ddraw_render(color_u8, depth, buf, count, view_proj,
                 samples_per_segment: int = 32):
    """Expand every buffer row to wireframe segments and splat them
    depth-tested: the analogue of the reference's expand CS +
    ExecuteIndirect wireframe draw (ref: renderer.cpp:920-1346)."""
    cap = buf.shape[0]
    dev = buf.device
    sph = torch.as_tensor(_unit_sphere_segments(), device=dev)  # (48, 2, 3)
    box = torch.as_tensor(np.concatenate(
        [_unit_box_segments(),
         np.zeros((_DDRAW_SEGS_PER_ROW - 12, 2, 3), np.float32)]),
        device=dev)
    box_valid = torch.arange(_DDRAW_SEGS_PER_ROW, device=dev) < 12
    row_is_box = buf[:, 0:1] == DDRAW_BOX                    # (cap, 1)
    center = buf[:, None, None, 1:4]
    ext = buf[:, None, None, 4:7]
    segs = torch.where(row_is_box[:, :, None, None],
                       box[None] * ext + center,
                       sph[None] * ext[..., 0:1] + center)   # (cap, 48, 2, 3)
    ridx = torch.arange(cap, device=dev)[:, None]
    valid = (ridx < count) & torch.where(row_is_box, box_valid[None], True)
    cols = buf[:, None, 7:10].expand(cap, _DDRAW_SEGS_PER_ROW, 3)
    return draw_lines(color_u8, depth,
                      segs.reshape(-1, 2, 3), cols.reshape(-1, 3),
                      view_proj, samples_per_segment=samples_per_segment,
                      seg_mask=valid.reshape(-1))


def light_bounds_rows(lights, mask_grid):
    """Sphere rows for every punctual light that survived cluster culling,
    appended from the light-culling pass's own output, like the
    reference's SHOW_LIGHT_BOUNDS path appends from the culling shader
    (ref: light-culling.hlsl DrawDebugSphere). mask_grid: (C, W32) i32,
    bit l % 32 of word l // 32 set where light l touches the cluster."""
    c, w32 = mask_grid.shape
    dev = mask_grid.device
    bits = (mask_grid[..., None]
            >> torch.arange(32, dtype=torch.int32, device=dev)) & 1
    lit = bits.reshape(c, w32 * 32).any(dim=0)               # (Lpad,)
    n = lights.type.shape[0]
    lit = lit[:n]
    pos = lights.transform[:, 3, :3]
    rng = torch.where(lights.range > 0.0, lights.range, 4.0)
    rows = torch.cat([
        torch.full((n, 1), DDRAW_SPHERE, device=dev), pos,
        rng[:, None], torch.zeros((n, 2), device=dev),
        torch.tensor([0.25, 0.9, 0.25], device=dev).expand(n, 3)], dim=-1)
    li = torch.arange(n, device=dev)
    mask = lit & (li < lights.count) & (lights.type != 0)
    return rows, mask


def object_bounds_rows(scene, scene_rotation, prim_visible):
    """Sphere rows for every primitive that survived frustum culling,
    appended from the cull pass's device-side mask (ref:
    batch-culling.hlsl debug path + ui.cpp:604-630)."""
    dev = prim_visible.device
    world = torch.matmul(scene.mesh_transforms, scene_rotation)
    xf = world[scene.prim_mesh.long()]
    bs = scene.prim_bsphere
    center = torch.einsum(
        "pi,pij->pj",
        torch.cat([bs[:, :3], torch.ones_like(bs[:, :1])], -1), xf)[:, :3]
    scale = torch.amax(torch.linalg.vector_norm(xf[:, :3, :3], dim=-1),
                       dim=-1)
    n = bs.shape[0]
    rows = torch.cat([
        torch.full((n, 1), DDRAW_SPHERE, device=dev), center,
        (bs[:, 3] * scale)[:, None], torch.zeros((n, 2), device=dev),
        torch.tensor([1.0, 0.8, 0.1], device=dev).expand(n, 3)], dim=-1)
    pi = torch.arange(n, device=dev)
    mask = prim_visible & (pi < scene.meta.num_primitives)
    return rows, mask
