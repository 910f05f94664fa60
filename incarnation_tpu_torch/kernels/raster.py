"""Tile-binned software rasterizer (port of incarnation_tpu/kernels/raster.py).

Pipeline:
1. prepare_geometry      — per-triangle corner transform, 2D-homogeneous
                           edge and depth planes, attribute planes, bbox:
                           K9 (csrc/setup.cu) on CUDA tensors, the twin
                           prepare_geometry_plain on CPU ones.
2. bin_triangles_layered — per-tile triangle lists for every raster layer
                           (small, mid and big tiers; the pair-capacity
                           and big-list overflows counted): K10
                           (csrc/bin.cu) on CUDA tensors, the twin
                           bin_triangles_layered_plain on CPU ones.
3. rasterize_tiles       — K1 (csrc/raster.cu) on CUDA tensors; the plain
                           PyTorch twin rasterize_tiles_plain on CPU ones.

The port keeps the JAX module's contract (coverage, depth race, attribute
channels, roles, counters), not its TPU layout: the bins hold the sorted
pair triangle ids and the kernel reads setup and attribute rows by id.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple

import torch

from ..core import mathutils as mu
from .build import Kernel, ptr, zero_scratch

SETUP_ROWS = 12
ATTR_ROWS = 29
INTERP_CHANNELS = 16
AMASK_LANES = 34
_W_EPS = 1e-3
# (pair, tile pixel) elements the plain twin evaluates per chunk of pairs
_PLAIN_CHUNK_ELEMS = 1 << 22


class RasterParams(NamedTuple):
    width: int
    height: int
    tile_h: int = 16
    tile_w: int = 128
    pair_capacity: int = 1 << 20  # total (tile, triangle) pairs per frame
    bin_max_span: int = 16
    big_tri_capacity: int = 512
    bin_mid_span: int = 64
    mid_tri_capacity: int = 1024
    depth_only: bool = False   # the shadow-map role: no attribute pass

    @property
    def tiles_x(self) -> int:
        return -(-self.width // self.tile_w)

    @property
    def tiles_y(self) -> int:
        return -(-self.height // self.tile_h)

    @property
    def num_tiles(self) -> int:
        return self.tiles_x * self.tiles_y


class PreparedGeometry(NamedTuple):
    setup: torch.Tensor     # (T, 12) f32: 3 edge forms + depth plane
    ids: torch.Tensor       # (T,) i32
    valid: torch.Tensor     # (T,) bool
    bbox: torch.Tensor      # (T, 4) i32 inclusive x0, y0, x1, y1
    attr: torch.Tensor      # (T, 29) f32 attribute planes; None when
    #                         prepare_geometry(emit_attributes=False)


@dataclasses.dataclass
class Bins:
    """One raster layer's tile lists. pair_tri, setup and attr are shared
    by every layer of a bin_triangles_layered call."""
    pair_tri: torch.Tensor    # (P + 1,) i32, P = pair_capacity: the
    #                           kept pairs' triangles sorted by (bucket,
    #                           triangle), then zeros; tile i owns
    #                           [starts[i], starts[i] + counts[i])
    starts: torch.Tensor      # (NT,) i32
    counts: torch.Tensor      # (NT,) i32
    big_tri: torch.Tensor     # (BIG,) i32 every-tile list, first big_count
    big_count: torch.Tensor   # (1,) i32
    overflow: torch.Tensor    # () i32 dropped pairs (layer 0 only)
    big_overflow: torch.Tensor  # () i32 dropped big triangles
    setup: torch.Tensor       # (T, 12) f32
    attr: torch.Tensor        # (T, 29) f32, None for a depth-only pass


# ---------------------------------------------------------------------------
# 1. Geometry front end
# ---------------------------------------------------------------------------

# tri_corner, T, tri_mesh, mesh transforms, meshes, scene rotation,
# view_proj, tri_prim, prim_visible, prim_double_sided, prim_material,
# primitives, tri_meshlet, meshlet_prim, meshlet_visible (NULL: no meshlet
# culling), meshlets, tri_visible (NULL: none), all_double_sided, width,
# height, then the outputs setup, ids, valid, bbox and attr (NULL:
# emit_attributes=False)
_P, _I = ctypes.c_void_p, ctypes.c_int
K9 = Kernel("setup", "k9_setup",
            [_P, _I, _P, _P, _I, _P, _P] + [_P] * 4 + [_I] + [_P] * 3
            + [_I, _P] + [_I] * 3 + [_P] * 5)


def _mesh_rows(scene, scene_rotation, view_proj):
    """(M, 25) f32 per mesh instance: local-to-clip (16), then the 3x3 of
    local-to-world (9), where local_to_world = T @ scene_rotation and
    local_to_clip = local_to_world @ view_proj (mathutils.rows_mat). K9
    computes the same rows inside the kernel; the twin gathers them."""
    local_to_world = mu.rows_mat(scene.mesh_transforms, scene_rotation)
    local_to_clip = mu.rows_mat(local_to_world, view_proj)
    return torch.cat([local_to_clip.reshape(-1, 16),
                      local_to_world[:, :3, :3].reshape(-1, 9)],
                     dim=-1).contiguous()


def prepare_geometry(scene, scene_rotation, view_proj, prim_visible,
                     params: RasterParams, tri_visible=None,
                     meshlet_visible=None,
                     emit_attributes: bool = True,
                     all_double_sided: bool = False) -> PreparedGeometry:
    """Fused corner transform + triangle setup + attribute planes
    (raster.py:1207-1383). emit_attributes=False builds no attribute
    planes (attr is None): the depth-only pass reads none.
    all_double_sided keeps every back face, whatever its primitive's
    doubleSided flag: the sun shadow map's casters (kernels/shadow.py), so
    a single-sided wall that faces away from the sun still casts, as it
    blocks an RT shadow ray (a divergence from JAX, which culls it).
    K9 (csrc/setup.cu) on CUDA tensors, the twin prepare_geometry_plain on
    CPU ones."""
    ctab = scene.tri_corner
    if not ctab.is_cuda:
        return prepare_geometry_plain(
            scene, scene_rotation, view_proj, prim_visible, params,
            tri_visible, meshlet_visible, emit_attributes, all_double_sided)
    dev = ctab.device
    t = ctab.shape[1]
    i32 = torch.int32
    xf = scene.mesh_transforms
    n_mesh, n_prims = xf.shape[0], prim_visible.shape[0]
    _check(ctab, torch.float32, dev, "tri_corner", (36, t))
    # the matrices' rows load as 16-byte words
    for name, x, shape in (("mesh_transforms", xf, (n_mesh, 4, 4)),
                           ("scene_rotation", scene_rotation, (4, 4)),
                           ("view_proj", view_proj, (4, 4))):
        _check(x, torch.float32, dev, name, shape)
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: K9 needs it 16-byte aligned")
    for name, x in (("tri_mesh", scene.tri_mesh),
                    ("tri_prim", scene.tri_prim)):
        _check(x, i32, dev, name, (t,))
    _check(prim_visible, torch.bool, dev, "prim_visible", (n_prims,))
    for name, x in (("prim_double_sided", scene.prim_double_sided),
                    ("prim_material", scene.prim_material)):
        _check(x, i32, dev, name, (n_prims,))
    n_meshlets = 0
    if meshlet_visible is not None:
        n_meshlets = meshlet_visible.shape[0]
        _check(meshlet_visible, torch.bool, dev, "meshlet_visible",
               (n_meshlets,))
        _check(scene.meshlet_prim, i32, dev, "meshlet_prim", (n_meshlets,))
        _check(scene.tri_meshlet, i32, dev, "tri_meshlet", (t,))
    if tri_visible is not None:
        _check(tri_visible, torch.bool, dev, "tri_visible", (t,))
    if min(n_mesh, n_prims) < 1 or (meshlet_visible is not None
                                    and n_meshlets < 1):
        raise ValueError("K9 needs at least one mesh, primitive and "
                         "meshlet row")
    setup = torch.empty((t, SETUP_ROWS), dtype=torch.float32, device=dev)
    ids = torch.empty((t,), dtype=i32, device=dev)
    valid = torch.empty((t,), dtype=torch.bool, device=dev)
    bbox = torch.empty((t, 4), dtype=i32, device=dev)
    attr = (torch.empty((t, ATTR_ROWS), dtype=torch.float32, device=dev)
            if emit_attributes else None)
    meshlets = meshlet_visible is not None
    K9(ptr(ctab), t, ptr(scene.tri_mesh), ptr(xf), n_mesh,
       ptr(scene_rotation), ptr(view_proj), ptr(scene.tri_prim),
       ptr(prim_visible), ptr(scene.prim_double_sided),
       ptr(scene.prim_material), n_prims,
       ptr(scene.tri_meshlet) if meshlets else None,
       ptr(scene.meshlet_prim) if meshlets else None, ptr(meshlet_visible),
       n_meshlets, ptr(tri_visible), int(all_double_sided), params.width,
       params.height, ptr(setup), ptr(ids), ptr(valid), ptr(bbox), ptr(attr))
    return PreparedGeometry(setup=setup, ids=ids, valid=valid, bbox=bbox,
                            attr=attr)


def prepare_geometry_plain(scene, scene_rotation, view_proj, prim_visible,
                           params: RasterParams, tri_visible=None,
                           meshlet_visible=None,
                           emit_attributes: bool = True,
                           all_double_sided: bool = False
                           ) -> PreparedGeometry:
    """K9's twin: prepare_geometry in torch operations."""
    w, h = params.width, params.height
    packed = _mesh_rows(scene, scene_rotation, view_proj)
    m = packed[scene.tri_mesh.long()].T                       # (25, T)
    ctab = scene.tri_corner                                   # (36, T)

    def corner(k):
        o = 12 * k
        px_, py_, pz_ = ctab[o], ctab[o + 1], ctab[o + 2]
        clip = [px_ * m[c] + py_ * m[4 + c] + pz_ * m[8 + c] + m[12 + c]
                for c in range(4)]
        wn = [ctab[o + 3] * m[16 + c] + ctab[o + 4] * m[19 + c]
              + ctab[o + 5] * m[22 + c] for c in range(3)]
        wt = [ctab[o + 6] * m[16 + c] + ctab[o + 7] * m[19 + c]
              + ctab[o + 8] * m[22 + c] for c in range(3)]
        return clip + [ctab[o + 10], ctab[o + 11]] + wn + wt + [ctab[o + 9]]

    r0, r1, r2 = corner(0), corner(1), corner(2)
    c0, c1, c2 = r0[:4], r1[:4], r2[:4]

    def screen_h(c):
        sx = (0.5 * c[0] + 0.5 * c[3]) * w
        sy = (-0.5 * c[1] + 0.5 * c[3]) * h
        return (sx, sy, c[3])

    p0, p1, p2 = screen_h(c0), screen_h(c1), screen_h(c2)

    def cross3(a, b):
        return (a[1] * b[2] - a[2] * b[1],
                a[2] * b[0] - a[0] * b[2],
                a[0] * b[1] - a[1] * b[0])

    e0 = cross3(p1, p2)
    e1 = cross3(p2, p0)
    e2 = cross3(p0, p1)
    det = p0[0] * e0[0] + p0[1] * e0[1] + p0[2] * e0[2]

    prim = scene.tri_prim
    if meshlet_visible is not None:
        mprim = torch.clamp(scene.meshlet_prim, min=0).long()
        ds = scene.prim_double_sided[mprim]
        vis = meshlet_visible & prim_visible[mprim]
        mat = scene.prim_material[mprim]
        row = torch.clamp(scene.tri_meshlet, min=0).long()
    else:
        ds, vis, mat = (scene.prim_double_sided, prim_visible,
                        scene.prim_material)
        row = torch.clamp(prim, min=0).long()
    double_sided = (ds[row] > 0) | all_double_sided
    tri_vis = vis[row]
    tri_mat = mat[row].to(torch.float32)
    front = det < 0.0
    wmin = torch.minimum(torch.minimum(c0[3], c1[3]), c2[3])
    wmax = torch.maximum(torch.maximum(c0[3], c1[3]), c2[3])
    crossing = (wmin <= _W_EPS) & (wmax > _W_EPS)

    valid = (prim >= 0) & tri_vis
    if tri_visible is not None:
        valid &= tri_visible
    valid &= wmax > _W_EPS
    valid &= torch.abs(det) > 1e-12
    valid &= front | double_sided | crossing

    s = torch.where(det >= 0.0, 1.0, -1.0)
    e0 = tuple(c * s for c in e0)
    e1 = tuple(c * s for c in e1)
    e2 = tuple(c * s for c in e2)
    adet = torch.abs(det)
    inv_det = torch.where(adet > 1e-12, 1.0 / adet, 0.0)
    z0, z1, z2 = c0[2] * inv_det, c1[2] * inv_det, c2[2] * inv_det
    zplane = tuple(e0[c] * z0 + e1[c] * z1 + e2[c] * z2 for c in range(3))

    # Exact bbox of the w >= eps clipped polygon (in-front vertices + the
    # crossing-edge intersections at w = eps).
    big_f = 2.0e6
    mnx = torch.full_like(p0[0], big_f)
    mxx = torch.full_like(p0[0], -big_f)
    mny = torch.full_like(p0[0], big_f)
    mxy = torch.full_like(p0[0], -big_f)

    def acc(x, y, ok):
        nonlocal mnx, mxx, mny, mxy
        mnx = torch.where(ok, torch.minimum(mnx, x), mnx)
        mxx = torch.where(ok, torch.maximum(mxx, x), mxx)
        mny = torch.where(ok, torch.minimum(mny, y), mny)
        mxy = torch.where(ok, torch.maximum(mxy, y), mxy)

    ps = (p0, p1, p2)
    for i in range(3):
        wv = ps[i][2]
        wsafe = torch.clamp(wv, min=_W_EPS)
        acc(ps[i][0] / wsafe, ps[i][1] / wsafe, wv > _W_EPS)
    for i, j in ((0, 1), (1, 2), (2, 0)):
        wa, wb = ps[i][2], ps[j][2]
        oke = (wa > _W_EPS) != (wb > _W_EPS)
        den = wa - wb
        te = (wa - _W_EPS) / torch.where(torch.abs(den) > 1e-20, den, 1.0)
        acc((ps[i][0] + te * (ps[j][0] - ps[i][0])) / _W_EPS,
            (ps[i][1] + te * (ps[j][1] - ps[i][1])) / _W_EPS, oke)

    def ifloor(x):
        return torch.floor(torch.clamp(x, -big_f, big_f)).to(torch.int32)

    mnx, mxx, mny, mxy = ifloor(mnx), ifloor(mxx), ifloor(mny), ifloor(mxy)
    valid &= (mxx >= 0) & (mnx <= w - 1) & (mxy >= 0) & (mny <= h - 1)
    bbox = torch.stack([torch.clamp(mnx, 0, w - 1), torch.clamp(mny, 0, h - 1),
                        torch.clamp(mxx, 0, w - 1), torch.clamp(mxy, 0, h - 1)],
                       dim=-1)

    t = ctab.shape[1]
    ids = torch.arange(t, dtype=torch.int32, device=ctab.device)
    setup = torch.stack(list(e0) + list(e1) + list(e2) + list(zplane),
                        dim=-1).contiguous()                  # (T, 12)

    attr = None
    if emit_attributes:
        a0, a1, a2 = r0[4:13], r1[4:13], r2[4:13]

        def plane(c):
            return [a0[c] * e0[j] + a1[c] * e1[j] + a2[c] * e2[j]
                    for j in range(3)]

        denom = [e0[j] + e1[j] + e2[j] for j in range(3)]
        rows = (plane(0) + plane(1) + denom
                + sum((plane(c) for c in range(2, 8)), [])
                + [a0[8], tri_mat])
        attr = torch.stack(rows, dim=-1).contiguous()         # (T, 29)
    return PreparedGeometry(setup=setup, ids=ids, valid=valid, bbox=bbox,
                            attr=attr)


# ---------------------------------------------------------------------------
# 2. Binning: K10 and its plain twin
# ---------------------------------------------------------------------------

# K10's three launches (csrc/bin.cu), each a C entry whose first argument
# is a host array of K10's int parameters (_k10_params): the counting step
# (each row of K10_TRIS triangles classified once, the mid fit by a
# look-back over the rows, the pair descriptors, each walker's offsets and
# the row's pairs per bucket), the table's column scan with the bucket
# scan in its last block, and the scatter of the pairs in (bucket,
# triangle) order. by_name counts each launch by its entry's name.
K10 = Kernel("bin", "k10_scatter", [_P] * 9,
             variants={"k10_count": [_P] * 8, "k10_scan": [_P] * 11})
K10_TRIS = 2048         # triangles a row (csrc/bin.cu K10_TRIS)
K10_WALKERS = 16        # a row's walkers at most (csrc/bin.cu K10_WALKERS)
# buckets K10 takes: 4 bytes a bucket beside 8-byte descriptors of
# K10_TRIS triangles in a block's 227 KB, less 2 KB for its static arrays
# (csrc/bin.cu K10_SMEM_MAX), which each step's shared memory holds with
# one walker
K10_MAX_BUCKETS = (232448 - 2048 - 8 * K10_TRIS) // 4
_K10_NPARAMS = 15
# the look-back state at the front of K10's scratch (csrc/bin.cu): int64
# words, the ticket count, the scan's finished blocks, a word a row
_K10_STATE_WORDS = 2


@functools.lru_cache(maxsize=64)
def _k10_params(p: RasterParams, t: int, n_layers: int):
    """K10's parameter array, in csrc/bin.cu's BinParams order (the count
    first), built once per shape."""
    nt = p.num_tiles
    mid_span = p.bin_mid_span if p.bin_mid_span > p.bin_max_span else 0
    vals = (_K10_NPARAMS, t, n_layers, nt, p.tiles_x, p.tiles_y, p.tile_w,
            p.tile_h, p.bin_max_span, mid_span, p.mid_tri_capacity,
            p.pair_capacity, p.big_tri_capacity, n_layers + n_layers * nt,
            max(1, -(-t // K10_TRIS)))
    return (ctypes.c_int * len(vals))(*vals)


# K10's scratch per (device, stream), int32 words: the look-back state of
# every row yet seen (zero between binnings: each leaves it zero,
# csrc/bin.cu), then a binning's work (bin_triangles_layered). Created
# zero, grown, never shrunk, the state first, so a row's words keep their
# place and stay zero; the binnings of one stream run in order, so they
# share it.
_K10_SCRATCH: dict = {}


def _k10_state_words(rows: int) -> int:
    """int32 words of the look-back state for `rows` rows, a multiple of 4
    so that the work after it starts 16-byte aligned."""
    return -(-2 * (_K10_STATE_WORDS + rows) // 4) * 4


def _k10_scratch(dev, rows: int, words: int):
    """(state, work) of K10's scratch for a binning of `rows` rows that
    needs `words` words of work."""
    stream = torch.cuda.current_stream(dev)
    key = (dev.index, stream.cuda_stream)
    buf, cap = _K10_SCRATCH.get(key, (None, 0))
    state = _k10_state_words(cap)
    if buf is None or rows > cap or buf.numel() - state < words:
        work = max(words, 0 if buf is None else buf.numel() - state)
        cap = max(cap, rows)
        state = _k10_state_words(cap)
        buf = torch.zeros(state + work, dtype=torch.int32, device=dev)
        _K10_SCRATCH[key] = (buf, cap)
    return buf[:state], buf[state:state + words]


def bin_triangles_layered(prep: PreparedGeometry, params: RasterParams,
                          layer=None, n_layers: int = 1) -> list:
    """Per-layer tile lists, the pairs ordered by (bucket, triangle)
    (raster.py:384-640).

    Buckets: 0..L-1 are each layer's big list (spans above the mid tier,
    or mids beyond the first mid_tri_capacity in triangle order), then
    L + l*NT + tile. A small or fitted mid triangle has a pair in each
    tile of its bbox, a big one a pair in its layer's big bucket. The
    stream is cut at pair_capacity: pair_tri holds the kept pairs, then
    zeros, (pair_capacity + 1,) whatever the count; `overflow` counts the
    pairs cut (layer 0), a tile's starts and counts are its bucket's
    slice of the cut stream, big_tri the first big_tri_capacity entries
    of the layer's big bucket, `big_overflow` the rest. Every shape comes
    from the params. Returns n_layers Bins.

    layer: (T,) int32 in [0, n_layers), or None (all layer 0).
    K10 (csrc/bin.cu, three launches) on CUDA tensors, with no host
    synchronisation; the twin bin_triangles_layered_plain on CPU ones."""
    bbox, valid = prep.bbox, prep.valid
    if not bbox.is_cuda:
        return bin_triangles_layered_plain(prep, params, layer, n_layers)
    p = params
    dev = bbox.device
    t = bbox.shape[0]
    nl = n_layers
    nt = p.num_tiles
    nb = nl + nl * nt
    _check(bbox, torch.int32, dev, "bbox", (t, 4))
    if bbox.data_ptr() % 16:
        raise ValueError("bbox must be 16-byte aligned (K10 loads its rows "
                         "as 16-byte words)")
    _check(valid, torch.bool, dev, "valid", (t,))
    if layer is not None:
        _check(layer, torch.int32, dev, "layer", (t,))
    if nl < 1 or min(p.tile_w, p.tile_h, p.pair_capacity) < 1 \
            or min(p.big_tri_capacity, p.mid_tri_capacity) < 0:
        raise ValueError("K10 needs a layer, tiles, a pair capacity and "
                         "capacities >= 0")
    if nb > K10_MAX_BUCKETS:
        raise ValueError(f"K10 holds at most {K10_MAX_BUCKETS} buckets, "
                         f"not {nb}")
    if max(p.bin_max_span, p.bin_mid_span) >= 1 << 16:
        raise ValueError("K10 packs a triangle's pair count and tile span "
                         "in 16 bits each")
    # every count and slot an int32: the pairs a call can emit at most
    most = t * max(p.bin_max_span, p.bin_mid_span, 1)
    if max(most, p.pair_capacity + 1, nl * p.big_tri_capacity) >= 1 << 31:
        raise ValueError("K10 counts pairs in 32 bits")
    prm = _k10_params(p, t, nl)
    rows = prm[-1]
    big = p.big_tri_capacity
    # each row's walker offsets (16 bits a bucket, two a word; first, so
    # that each row's starts 16-byte aligned), then the descriptors, the
    # table, the bucket totals and first slots, the kept pairs
    woff_words = rows * K10_WALKERS * ((nb + 1) // 2)
    sizes = [woff_words, 2 * t, rows * nb, nb, nb, 1]
    st, work = _k10_scratch(dev, rows, sum(sizes))
    woff, desc, table, total, bstart, kept = work.split(sizes)
    # overflow: layer 0's, then the zero of the other layers
    out = torch.empty(p.pair_capacity + 1 + 2 * nl * nt + nl * big
                      + 2 * nl + 2, dtype=torch.int32, device=dev)
    pair_tri, starts, counts, big_tri, big_count, big_over, overflow = \
        out.split([p.pair_capacity + 1, nl * nt, nl * nt, nl * big, nl, nl,
                   2])
    K10(prm, ptr(bbox), ptr(valid), ptr(layer), ptr(st), ptr(desc),
        ptr(table), ptr(woff), variant="k10_count", name="k10_count")
    K10(prm, ptr(st), ptr(table), ptr(total), ptr(bstart), ptr(starts),
        ptr(counts), ptr(big_count), ptr(big_over), ptr(overflow), ptr(kept),
        variant="k10_scan", name="k10_scan")
    K10(prm, ptr(desc), ptr(table), ptr(bstart), ptr(big_count), ptr(kept),
        ptr(woff), ptr(pair_tri), ptr(big_tri), name="k10_scatter")
    over = overflow.unbind()
    return [Bins(pair_tri=pair_tri, starts=s, counts=c, big_tri=bt,
                 big_count=bc, overflow=over[0] if l == 0 else over[1],
                 big_overflow=bo, setup=prep.setup, attr=prep.attr)
            for l, (s, c, bt, bc, bo) in enumerate(zip(
                starts.view(nl, nt).unbind(), counts.view(nl, nt).unbind(),
                big_tri.view(nl, big).unbind(),
                big_count.view(nl, 1).unbind(), big_over.unbind()))]


def bin_triangles_layered_plain(prep: PreparedGeometry, params: RasterParams,
                                layer=None, n_layers: int = 1) -> list:
    """K10's twin: bin_triangles_layered from ONE torch.sort of the
    (bucket, triangle) keys, with the same outputs and shapes."""
    p = params
    dev = prep.ids.device
    t = prep.ids.shape[0]
    nl = n_layers
    nt = p.num_tiles
    span_cap = p.bin_max_span
    bbox = prep.bbox
    tx0 = bbox[:, 0] // p.tile_w
    ty0 = bbox[:, 1] // p.tile_h
    span_w = bbox[:, 2] // p.tile_w - tx0 + 1
    span_h = bbox[:, 3] // p.tile_h - ty0 + 1
    span = span_w * span_h
    valid = prep.valid
    lyr = (torch.zeros(t, dtype=torch.int64, device=dev) if layer is None
           else layer.to(torch.int64))
    tri_ids = torch.arange(t, dtype=torch.int64, device=dev)

    small = valid & (span <= span_cap)
    use_mid = p.bin_mid_span > span_cap
    if use_mid:
        mid = valid & (span > span_cap) & (span <= p.bin_mid_span)
        mpos = torch.cumsum(mid.to(torch.int64), 0) - 1
        mid_fit = mid & (mpos < p.mid_tri_capacity)
        big = valid & ((span > p.bin_mid_span) | (mid & ~mid_fit))
    else:
        big = valid & (span > span_cap)

    def candidates(tris, width):
        """(bucket, tri) of every tile the triangles' bboxes cover."""
        k = torch.arange(width, dtype=torch.int32, device=dev)[None, :]
        sw = span_w[tris][:, None]
        dy = k // sw
        tile = ((ty0[tris][:, None] + dy) * p.tiles_x + tx0[tris][:, None]
                + k - dy * sw)
        ok = k < span[tris][:, None]
        bucket = nl + lyr[tris][:, None] * nt + tile.to(torch.int64)
        return bucket[ok], tris[:, None].expand(-1, width)[ok]

    parts = [candidates(tri_ids[small], span_cap)]
    if use_mid:
        parts.append(candidates(tri_ids[mid_fit], p.bin_mid_span))
    big_tris = tri_ids[big]
    parts.append((lyr[big_tris], big_tris))
    bucket = torch.cat([b for b, _ in parts])
    keys = torch.sort(bucket * t + torch.cat([x for _, x in parts])).values
    n_pairs = keys.shape[0]
    overflow = torch.tensor(max(n_pairs - p.pair_capacity, 0),
                            dtype=torch.int32, device=dev)
    keys = keys[:p.pair_capacity]
    counts_all = torch.bincount(keys // max(t, 1), minlength=nl + nl * nt)
    starts_all = torch.cumsum(counts_all, 0) - counts_all
    # the kept pairs, then zeros: (pair_capacity + 1,) whatever the count
    pair_tri = torch.zeros(p.pair_capacity + 1, dtype=torch.int32,
                           device=dev)
    pair_tri[:keys.shape[0]] = (keys % max(t, 1)).to(torch.int32)

    cap = p.big_tri_capacity
    iota = torch.arange(cap, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    out = []
    for l in range(nl):
        big_total = counts_all[l]
        big_count = torch.clamp(big_total, max=cap)
        idx = torch.clamp(starts_all[l] + iota, max=p.pair_capacity)
        big_tri = torch.where(iota < big_count, pair_tri[idx], 0)
        sl = slice(nl + l * nt, nl + (l + 1) * nt)
        out.append(Bins(
            pair_tri=pair_tri,
            starts=starts_all[sl].to(torch.int32).contiguous(),
            counts=counts_all[sl].to(torch.int32).contiguous(),
            big_tri=big_tri.to(torch.int32).contiguous(),
            big_count=big_count.reshape(1).to(torch.int32),
            overflow=overflow if l == 0 else zero,
            big_overflow=(big_total - big_count).to(torch.int32),
            setup=prep.setup, attr=prep.attr))
    return out


# ---------------------------------------------------------------------------
# 3. Fine raster: K1 and its plain twin
# ---------------------------------------------------------------------------

_K1_DEPTH = "k1_raster_depth"   # the depth-only role's entry point
K1 = Kernel("raster", "k1_raster",
            [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P,
             _I, _I, _I, _I, _I, _I, _P, _I, _P, _I, _I],
            variants={_K1_DEPTH: [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _I, _I, _I, _I, _I, _I, _P, _I, _P, _I,
                                  _I]})

# K1's schedule (csrc/raster.cu): each tile's pairs are cut into work items
# of at most K1_ITEM_PAIRS; each warp owns a SUBTILE_W x SUBTILE_H sub-tile
# (a lane per column) and a tile holds at most K1_WARPS of them; an item's
# key slot holds K1_TILE_PX keys. The C entries refuse other values.
K1_ITEM_PAIRS = 256
K1_WARPS = 8
K1_TILE_PX = 2048
SUBTILE_W, SUBTILE_H = 32, 8

# K1's work and arrival counters (csrc/raster.cu), build.zero_scratch
_K1_COUNTERS: dict = {}


def _k1_counters(dev, num_tiles: int):
    return zero_scratch(_K1_COUNTERS, dev, num_tiles + 1, torch.int32)


def k1_max_items(bins: Bins, params: RasterParams) -> int:
    """An upper bound of K1's work items, from shapes alone (no device
    read): each tile takes ceil(pairs / K1_ITEM_PAIRS) items, at least
    one, and a tile's pairs are its CSR slice plus the big list."""
    nt = params.num_tiles
    pairs = bins.pair_tri.numel() - 1 + bins.big_tri.numel() * nt
    return nt + pairs // K1_ITEM_PAIRS + 1


def k1_work_items(bins: Bins, params: RasterParams):
    """(items, largest item in pairs) of K1's plan on these bins, as its
    plan kernel counts them (one host read; for reports)."""
    total = bins.counts.long() + int(bins.big_count[0])
    items = torch.clamp(-(-total // K1_ITEM_PAIRS), min=1)
    return int(items.sum()), int(torch.clamp(total, max=K1_ITEM_PAIRS).max())


def _plane_bound(a, b, c, x0, x1, y0, y1, upper: bool):
    """raster.cu plane_bound: a*x + b*y + c at the box corner that
    maximises (upper) or minimises it, plus or minus 1e-6 of
    |a| x1 + |b| y1 + |c|, in f32 with the kernel's operation order."""
    xm = torch.where((a > 0.0) == upper, x1, x0)
    ym = torch.where((b > 0.0) == upper, y1, y0)
    m = a * xm + b * ym + c
    margin = (torch.abs(a) * x1 + torch.abs(b) * y1 + torch.abs(c)) \
        * 1e-6 + 1e-30
    return m + margin if upper else m - margin


def subtile_may_cover(setup, x0, y0, zl_max=None):
    """K1's conservative sub-tile test (raster.cu subtile_may_cover), the
    same f32 arithmetic: False only where no pixel centre of the
    SUBTILE_W x SUBTILE_H box whose first centre is (x0, y0) can pass the exact
    test (3 edges >= 0, 0 <= z <= 1, z < a limit <= zl_max). setup: (..., 12)
    rows; x0, y0, zl_max broadcast against setup[..., 0]. NaN keeps the
    pair."""
    x1 = x0 + float(SUBTILE_W - 1)
    y1 = y0 + float(SUBTILE_H - 1)
    c = [setup[..., r] for r in range(SETUP_ROWS)]
    ok = [~(_plane_bound(c[o], c[o + 1], c[o + 2], x0, x1, y0, y1, True)
            < 0.0) for o in (0, 3, 6, 9)]
    zmin = _plane_bound(c[9], c[10], c[11], x0, x1, y0, y1, False)
    ok.append(~(zmin > 1.0))
    if zl_max is not None:
        ok.append(~(zmin > zl_max))
    return functools.reduce(torch.logical_and, ok)


def rasterize_tiles(bins: Bins, params: RasterParams, z_limit=None,
                    mask_table=None, name: str = "fine_raster"):
    """-> (tri (H, W) i32, -1 = empty; depth (H, W) f32; interp
    (16, H, W) f32, or None when params.depth_only). z_limit: (H, W)
    strict per-pixel depth bound (depth peels); mask_table: (M, 34) i32
    amask rows (masked layer: fragments in a certainly-transparent UV cell
    of their material drop in the race; not with depth_only, which has no
    UV planes). name: the raster layer, counted in K1.by_name.

    CUDA tensors launch K1; CPU tensors take rasterize_tiles_plain."""
    _check_role(bins, params, mask_table)
    if not bins.setup.is_cuda:
        return rasterize_tiles_plain(bins, params, z_limit, mask_table)
    p = params
    dev = bins.setup.device
    _check(bins.pair_tri, torch.int32, dev, "pair_tri")
    _check(bins.starts, torch.int32, dev, "starts", (p.num_tiles,))
    _check(bins.counts, torch.int32, dev, "counts", (p.num_tiles,))
    _check(bins.big_tri, torch.int32, dev, "big_tri")
    _check(bins.big_count, torch.int32, dev, "big_count", (1,))
    _check(bins.setup, torch.float32, dev, "setup")
    if bins.setup.shape[1:] != (SETUP_ROWS,):
        raise ValueError("setup must be (T, 12)")
    if -(-p.tile_h // SUBTILE_H) * -(-p.tile_w // SUBTILE_W) > K1_WARPS:
        raise ValueError(f"K1 takes tiles of at most {K1_WARPS} sub-tiles "
                         f"of {SUBTILE_W}x{SUBTILE_H} pixels")
    if bins.setup.data_ptr() % 16:
        raise ValueError("setup must be 16-byte aligned (K1 stages its "
                         "rows with 16-byte asynchronous copies)")
    if z_limit is not None:
        _check(z_limit, torch.float32, dev, "z_limit", (p.height, p.width))
    tri = torch.empty((p.height, p.width), dtype=torch.int32, device=dev)
    depth = torch.empty((p.height, p.width), dtype=torch.float32, device=dev)
    # each item's keys (multi-item tiles), and the counters
    max_items = k1_max_items(bins, p)
    partial = torch.empty(max_items * K1_TILE_PX, dtype=torch.int64,
                          device=dev)
    sched = (ptr(partial), max_items, ptr(_k1_counters(dev, p.num_tiles)),
             K1_ITEM_PAIRS, K1_TILE_PX)
    if p.depth_only:
        K1(ptr(bins.pair_tri), ptr(bins.starts), ptr(bins.counts),
           ptr(bins.big_tri), ptr(bins.big_count), ptr(bins.setup),
           ptr(z_limit), ptr(tri), ptr(depth), p.width, p.height, p.tile_h,
           p.tile_w, p.tiles_x, p.num_tiles, *sched, name=name,
           variant=_K1_DEPTH)
        return tri, depth, None
    _check(bins.attr, torch.float32, dev, "attr",
           (bins.setup.shape[0], ATTR_ROWS))
    rows = 0
    if mask_table is not None:
        _check(mask_table, torch.int32, dev, "mask_table")
        if mask_table.shape[1] != AMASK_LANES:
            raise ValueError("mask_table must be (M, 34)")
        rows = mask_table.shape[0]
    interp = torch.empty((INTERP_CHANNELS, p.height, p.width),
                         dtype=torch.float32, device=dev)
    K1(ptr(bins.pair_tri), ptr(bins.starts), ptr(bins.counts),
       ptr(bins.big_tri), ptr(bins.big_count), ptr(bins.setup),
       ptr(bins.attr), ptr(z_limit), ptr(mask_table), rows, ptr(tri),
       ptr(depth), ptr(interp), p.width, p.height, p.tile_h, p.tile_w,
       p.tiles_x, p.num_tiles, *sched, name=name)
    return tri, depth, interp


def _check_role(bins: Bins, params: RasterParams, mask_table):
    if params.depth_only and mask_table is not None:
        raise ValueError("depth_only has no attribute planes for the "
                         "mask_table rejection")
    if not params.depth_only and bins.attr is None:
        raise ValueError("these bins carry no attribute planes "
                         "(emit_attributes=False): only depth_only "
                         "params can raster them")


def _check(t, dtype, device, name, shape=None):
    if t.dtype != dtype or t.device != device or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous {dtype} tensor on "
                         f"{device}, got {t.dtype} on {t.device}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")


def _mask_reject(a, colf, rowf, table):
    """(C, n) bool: the fragment's UV cell is certainly transparent in its
    own material's amask bitplane. a: (C, 29) attribute rows."""
    d = a[:, 6:7] * colf + a[:, 7:8] * rowf + a[:, 8:9]
    inv = torch.where(torch.abs(d) > 1e-20, 1.0 / d, 0.0)
    u = (a[:, 0:1] * colf + a[:, 1:2] * rowf + a[:, 2:3]) * inv
    v = (a[:, 3:4] * colf + a[:, 4:5] * rowf + a[:, 5:6]) * inv
    mat = torch.clamp(a[:, 28].to(torch.int32), 0, table.shape[0] - 1)
    row = table[mat.long()]                                  # (C, 34)
    mode = row[:, 32:33]

    def addr01(x):
        wrap = x - torch.floor(x)
        clamp = torch.clamp(x, 0.0, 1.0 - 1e-6)
        period = x - 2.0 * torch.floor(0.5 * x)
        mir = torch.where(period < 1.0, period, 2.0 - period)
        return torch.where(mode == 1, clamp,
                           torch.where(mode == 2,
                                       torch.clamp(mir, 0.0, 1.0 - 1e-6),
                                       wrap))

    cu = torch.clamp((addr01(u) * 32.0).to(torch.int32), 0, 31)
    cv = torch.clamp((addr01(v) * 32.0).to(torch.int32), 0, 31)
    cell = cv * 32 + cu
    word = torch.gather(row, 1, (cell >> 5).long())
    return ((word >> (cell & 31)) & 1) > 0


def _tile_limits(z_limit, p: RasterParams):
    """(NT, tile pixels) z limits, zero-padded beyond the frame; None
    without a z_limit."""
    if z_limit is None:
        return None
    padded = torch.zeros((p.tiles_y * p.tile_h, p.tiles_x * p.tile_w),
                         dtype=torch.float32, device=z_limit.device)
    padded[:p.height, :p.width] = z_limit
    return padded.reshape(p.tiles_y, p.tile_h, p.tiles_x, p.tile_w) \
        .permute(0, 2, 1, 3).reshape(p.num_tiles, -1)


def _pair_chunks(bins: Bins, p: RasterParams, zl_tiles=None):
    """Every (tile, triangle) pair K1 races, in chunks of whole tile grids:
    yields (tile, tri, colf, rowf, z, cov) with (C, tile pixels) pixel
    centres, depth plane and the exact edge-and-depth test (3 edges >= 0,
    0 <= z <= 1), rounded as the kernel's. A tile whose limits are all 0
    (zl_tiles) takes no pairs."""
    dev = bins.setup.device
    n = p.tile_h * p.tile_w
    counts = bins.counts.long()
    starts = bins.starts.long()
    big_count = int(bins.big_count[0])
    tiles = torch.arange(p.num_tiles, device=dev)
    pix = torch.arange(n, device=dev)
    py, px = pix // p.tile_w, pix % p.tile_w
    big_tiles = tiles
    if zl_tiles is not None:
        live = zl_tiles.amax(dim=1) > 0.0
        counts = torch.where(live, counts, 0)
        big_tiles = tiles[live]
    tile_of = torch.repeat_interleave(tiles, counts)
    first = torch.cumsum(counts, 0) - counts
    pos = starts[tile_of] + torch.arange(tile_of.shape[0], device=dev) \
        - first[tile_of]
    pair_tiles = torch.cat([tile_of,
                            big_tiles.repeat_interleave(big_count)])
    pair_tris = torch.cat([bins.pair_tri.long()[pos],
                           bins.big_tri.long()[:big_count].repeat(
                               big_tiles.shape[0])])
    step = max(1, _PLAIN_CHUNK_ELEMS // n)
    for s in range(0, pair_tiles.shape[0], step):
        tt = pair_tiles[s:s + step]
        tr = pair_tris[s:s + step]
        colf = (px[None, :] + (tt % p.tiles_x)[:, None] * p.tile_w) \
            .to(torch.float32) + 0.5
        rowf = (py[None, :] + (tt // p.tiles_x)[:, None] * p.tile_h) \
            .to(torch.float32) + 0.5
        c = bins.setup[tr]
        e0 = c[:, 0:1] * colf + c[:, 1:2] * rowf + c[:, 2:3]
        e1 = c[:, 3:4] * colf + c[:, 4:5] * rowf + c[:, 5:6]
        e2 = c[:, 6:7] * colf + c[:, 7:8] * rowf + c[:, 8:9]
        z = c[:, 9:10] * colf + c[:, 10:11] * rowf + c[:, 11:12]
        cov = (e0 >= 0.0) & (e1 >= 0.0) & (e2 >= 0.0) & (z <= 1.0) \
            & (z >= 0.0)
        yield tt, tr, colf, rowf, z, cov


def covered_pair_pixels(bins: Bins, params: RasterParams,
                        z_limit=None) -> int:
    """The (pair, tile pixel) elements whose exact edge-and-depth test
    passes, over the pairs K1 races (the z_limit and amask tests set
    aside; z_limit only drops the tiles whose limits are all 0): the
    pixel tests no sub-tile design can avoid."""
    total = 0
    for *_, cov in _pair_chunks(bins, params, _tile_limits(z_limit, params)):
        total += int(cov.sum())
    return total


def rasterize_tiles_plain(bins: Bins, params: RasterParams, z_limit=None,
                          mask_table=None):
    """Plain PyTorch twin of K1: the same function, evaluated as one
    (pair, tile pixel) grid per chunk of pairs with a 64-bit max-key
    scatter per pixel. With params.depth_only it skips pass 2 and returns
    (tri, depth, None)."""
    p = params
    _check_role(bins, p, mask_table)
    dev = bins.setup.device
    n = p.tile_h * p.tile_w
    nt = p.num_tiles
    pix = torch.arange(n, device=dev)
    zl_tiles = _tile_limits(z_limit, p)
    keys = torch.zeros(nt * n, dtype=torch.int64, device=dev)
    for tt, tr, colf, rowf, z, cov in _pair_chunks(bins, p, zl_tiles):
        if zl_tiles is not None:
            cov &= z < zl_tiles[tt]
        if mask_table is not None:
            cov &= ~_mask_reject(bins.attr[tr], colf, rowf, mask_table)
        zbits = z.contiguous().view(torch.int32).to(torch.int64) & 0x7FFFFFFF
        key = torch.where(cov, (zbits << 32) | (tr + 1)[:, None], 0)
        keys.scatter_reduce_(0, (tt[:, None] * n + pix[None, :]).reshape(-1),
                             key.reshape(-1), reduce="amax")

    keys = keys.reshape(p.tiles_y, p.tiles_x, p.tile_h, p.tile_w) \
        .permute(0, 2, 1, 3).reshape(p.tiles_y * p.tile_h, -1)
    keys = keys[:p.height, :p.width]
    has = keys != 0
    tri = torch.where(has, (keys & 0xFFFFFFFF) - 1, -1).to(torch.int32)
    depth = torch.where(has, (keys >> 32).to(torch.int32)
                        .view(torch.float32), 0.0)
    if p.depth_only:
        return tri, depth, None
    return tri, depth, _attribute_channels(tri, has, bins.attr, p)


def raster_depth(prep: PreparedGeometry, params: RasterParams,
                 layer_valid=None):
    """Depth-only raster of everything in prep (params.depth_only must be
    True), the shadow-map pass: -> (tri, depth, stats) with stats =
    {bin_overflow, big_overflow} (raster.py:1194-1204)."""
    if not params.depth_only:
        raise ValueError("raster_depth needs params.depth_only")
    if layer_valid is not None:
        prep = prep._replace(valid=prep.valid & layer_valid)
    bins, = bin_triangles_layered(prep, params, n_layers=1)
    tri, depth, _ = rasterize_tiles(bins, params, name="raster_shadow_depth")
    return tri, depth, dict(bin_overflow=bins.overflow,
                            big_overflow=bins.big_overflow)


def visibility_from_tri(tri, scene):
    """Global triangle index map -> the reference's visibility-buffer ids
    (prim << 20 | local_tri, clear 0xFFFFF000; ref:
    shaders/geo-raster/encoding.hlsli). Used by the id view modes."""
    mask = tri >= 0
    safe = torch.clamp(tri, min=0).long()
    prim = torch.clamp(scene.tri_prim[safe], min=0)
    local = safe.to(torch.int32) - scene.prim_tri_offset[prim.long()]
    vis = mu.encode_primitive_visibility(prim, local)
    return torch.where(mask, vis, mu.VIS_CLEAR_INT32)


def _attribute_channels(tri, has, attr, p: RasterParams):
    """Pass 2: evaluate the winner's attribute planes per pixel
    (raster.py:963-984). -> (16, H, W), zeros where nothing won."""
    dev = attr.device
    c = attr[torch.clamp(tri, min=0).long()]                  # (H, W, 29)
    c = c.permute(2, 0, 1)                                   # (29, H, W)
    colf = (torch.arange(p.width, device=dev).to(torch.float32)
            + 0.5)[None, :]
    rowf = (torch.arange(p.height, device=dev).to(torch.float32)
            + 0.5)[:, None]

    def lin(o):
        return c[o] * colf + c[o + 1] * rowf + c[o + 2]

    d = lin(6)
    inv_d = torch.where(torch.abs(d) > 1e-20, 1.0 / d, 0.0)
    u = lin(0) * inv_d
    v = lin(3) * inv_d
    zero = torch.zeros_like(u)
    chans = torch.stack([
        u, v,
        lin(9) * inv_d, lin(12) * inv_d, lin(15) * inv_d,
        lin(18) * inv_d, lin(21) * inv_d, lin(24) * inv_d,
        c[27], c[28],
        (c[0] - u * c[6]) * inv_d, (c[1] - u * c[7]) * inv_d,
        (c[3] - v * c[6]) * inv_d, (c[4] - v * c[7]) * inv_d,
        zero, zero])
    return torch.where(has[None], chans, 0.0)
