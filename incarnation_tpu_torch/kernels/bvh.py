"""Scene BVH: the 8-wide SAH build on the host and ray traversal on the
device (port of incarnation_tpu/kernels/bvh.py, wide layout only).

Build (numpy, at load): a top-down binned-SAH binary tree over the scene's
world-space triangles with quad leaves (4 triangles inline per leaf row),
collapsed three levels at a time into 8-wide internal rows. One (N, 80) f32
table holds every row, octant-invariant:

  internal  [8 x (lo3, hi3) child boxes @0:48, flag 0.0 @48, -, 8 local
            child row ids @50:58 (-1 = empty), -, 8 octants x (iperm
            word, miss link) @64:80]
  leaf      [v0a e1a e2a @0:9, -, tri_a @10, ds_a @11, 1.0 @12, -, -,
            slot b @15:24, slot c @24:33, slot d @33:42, tri_b..d @42:45,
            ds_b..d @45:48, flag 1.0 @48, -, ..., thread words @64:80]

An iperm word packs each storage slot's 3-bit position in the octant's
near-to-far order; the miss link is the next row of the walk when a subtree
is done (-1 ends the walk). A step reads one row: a leaf intersects its 4
triangles (Moller-Trumbore, backface-culled unless double-sided) and
follows the miss link; an internal row slab-tests its 8 children in
storage order and jumps to the hit child with the smallest position, else
follows the miss link.

Traversal is K4 (csrc/bvh.cu, one thread per ray walking the rows
stacklessly) on CUDA tensors and the plain twin (_step_wide looped over the
batch) on CPU ones; both round identically (K4 is built --fmad=false). The
JAX package's compaction ladders and step schedules exist for the TPU's
lock-step wavefront and are not ported: each ray here walks until it is
done or has spent MAX_STEPS rows (counted in `trunc`).

Not ported: the binary layout (build_lbvh, wide=False) and alpha_of=
filters inside the walk.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib

import numpy as np
import torch

from ..device import resolve_device
from .build import Kernel, ptr

ROW_LANES = 48
LEAF_K = 4                 # triangles per leaf quad
_TRI1_OFF = (15, 24, 33)   # lanes of quad slots b, c, d
_ID1_OFF = 42              # tri ids of slots b, c, d
_DS1_OFF = 45              # double-sided flags of slots b, c, d

WIDE_LANES = 80
_W_FLAG = 48               # 1.0 = quad leaf, 0.0 = 8-wide internal
_W_CHILD = 50              # 8 local child row ids (storage slot order)
_W_THREAD = 64             # 8 octants x (iperm word, miss link)
WIDE_ARITY = 8

# Rows one ray may visit before it stops with its best hit so far (counted
# in `trunc`). The JAX trace's longest walk on a big tree is its ladder
# (48 + 16 + 16 steps) plus three tails of 960 (bvh.py:1024, :1058-1073):
# 2,960 rows. No ray of the atrium's path tracer comes near it.
MAX_STEPS = 4096


# ---------------------------------------------------------------------------
# Build (numpy, at load)
# ---------------------------------------------------------------------------

def _sah_topology(tri_verts: np.ndarray, leaf_k: int, nbins: int = 16):
    """Top-down binned-SAH build, level-synchronous (every frontier node is
    processed with one set of vectorized segment ops per level). Returns
    (left, right, quad_tri): internal-node child arrays (negative =
    ~leaf_index) and (Q, leaf_k) original-triangle ids per leaf (-1 pad)."""
    t = tri_verts.shape[0]
    cent_all = tri_verts.mean(axis=1)
    tlo_all = tri_verts.min(axis=1)
    thi_all = tri_verts.max(axis=1)

    # provisional node table (root = 0); children are rewritten to dense
    # internal ids / ~leaf ids at the end
    prov_l = [-1]
    prov_r = [-1]
    prov_is_leaf = [False]
    prov_leaf = [-1]

    tids = np.arange(t, dtype=np.int64)    # original ids of frontier tris
    label = np.zeros(t, np.int64)          # frontier-local node per tri
    gid = np.array([0], np.int64)          # frontier-local -> provisional
    leaf_tris = []                         # per leaf: original tri ids

    def sa(lo, hi):
        d = np.maximum(hi - lo, 0.0)
        return (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                + d[..., 2] * d[..., 0])

    while tids.size:
        k = gid.shape[0]
        cent = cent_all[tids]
        tlo = tlo_all[tids]
        thi = thi_all[tids]
        counts = np.bincount(label, minlength=k)

        clo = np.full((k, 3), np.inf)
        chi = np.full((k, 3), -np.inf)
        np.minimum.at(clo, label, cent)
        np.maximum.at(chi, label, cent)
        ext = chi - clo
        axis = ext.argmax(axis=1)
        ax_ext = ext[np.arange(k), axis]

        cval = cent[np.arange(tids.size), axis[label]]
        rel = (cval - clo[label, axis[label]]) \
            / np.maximum(ax_ext[label], 1e-20)
        b = np.clip((rel * nbins).astype(np.int64), 0, nbins - 1)

        flat = label * nbins + b
        bc = np.bincount(flat, minlength=k * nbins).reshape(k, nbins)
        blo = np.full((k * nbins, 3), np.inf)
        bhi = np.full((k * nbins, 3), -np.inf)
        np.minimum.at(blo, flat, tlo)
        np.maximum.at(bhi, flat, thi)
        blo = blo.reshape(k, nbins, 3)
        bhi = bhi.reshape(k, nbins, 3)

        plo = np.minimum.accumulate(blo, axis=1)
        phi = np.maximum.accumulate(bhi, axis=1)
        slo = np.minimum.accumulate(blo[:, ::-1], axis=1)[:, ::-1]
        shi = np.maximum.accumulate(bhi[:, ::-1], axis=1)[:, ::-1]
        pc = np.cumsum(bc, axis=1)
        nl = pc[:, :-1]                    # split after bin s: left <= s
        nr = counts[:, None] - nl
        cost = sa(plo[:, :-1], phi[:, :-1]) * nl \
            + sa(slo[:, 1:], shi[:, 1:]) * nr
        cost = np.where((nl == 0) | (nr == 0), np.inf, cost)
        split = cost.argmin(axis=1)
        degenerate = ~np.isfinite(cost[np.arange(k), split]) \
            | (ax_ext <= 1e-12)

        make_leaf = counts <= leaf_k

        go_left = b <= split[label]
        if (degenerate & ~make_leaf).any():
            # identical/collapsed centroids: split by per-node rank parity
            order = np.argsort(label, kind="stable")
            starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
            rank = np.empty(tids.size, np.int64)
            rank[order] = np.arange(tids.size) - starts[label[order]]
            go_left = np.where(degenerate[label],
                               rank < (counts[label] + 1) // 2, go_left)

        leaf_nodes = np.flatnonzero(make_leaf)
        if leaf_nodes.size:
            lab_order = np.argsort(label, kind="stable")
            starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
            for i in leaf_nodes:
                g = gid[i]
                prov_is_leaf[g] = True
                prov_leaf[g] = len(leaf_tris)
                seg = lab_order[starts[i]:starts[i] + counts[i]]
                leaf_tris.append(tids[seg])

        split_idx = np.flatnonzero(~make_leaf)
        if split_idx.size == 0:
            break
        # create children (BFS order)
        l_gid = np.zeros(k, np.int64)
        r_gid = np.zeros(k, np.int64)
        for i in split_idx:
            g = gid[i]
            l_gid[i] = len(prov_l)
            r_gid[i] = len(prov_l) + 1
            prov_l += [-1, -1]
            prov_r += [-1, -1]
            prov_is_leaf += [False, False]
            prov_leaf += [-1, -1]
            prov_l[g] = l_gid[i]
            prov_r[g] = r_gid[i]

        keep = ~make_leaf[label]
        tids = tids[keep]
        new_prov = np.where(go_left[keep], l_gid[label[keep]],
                            r_gid[label[keep]])
        gid = np.unique(new_prov)
        remap = np.zeros(int(gid.max()) + 1, np.int64)
        remap[gid] = np.arange(gid.shape[0])
        label = remap[new_prov]

    # dense internal numbering (the provisional BFS order keeps the root at
    # 0); leaf children become ~leaf_id
    prov_l = np.asarray(prov_l)
    prov_r = np.asarray(prov_r)
    prov_is_leaf = np.asarray(prov_is_leaf)
    prov_leaf = np.asarray(prov_leaf)
    internal = ~prov_is_leaf
    int_id = np.cumsum(internal) - 1

    def map_child(c):
        return np.where(prov_is_leaf[c], ~prov_leaf[c], int_id[c])

    left = map_child(prov_l[internal])
    right = map_child(prov_r[internal])

    quad_tri = np.full((len(leaf_tris), leaf_k), -1, np.int64)
    for i, tr in enumerate(leaf_tris):
        quad_tri[i, :tr.size] = tr
    return left, right, quad_tri


def _binary_boxes(left, right, quad_lo, quad_hi):
    """Bottom-up AABBs of the binary internal nodes -> (node_lo, node_hi)."""
    n_int = left.shape[0]
    node_lo = np.full((n_int, 3), np.inf, np.float32)
    node_hi = np.full((n_int, 3), -np.inf, np.float32)
    ready = np.zeros(n_int, bool)

    def child_box(c):
        is_leaf = c < 0
        leaf_idx = np.where(is_leaf, ~c, 0)
        int_idx = np.where(is_leaf, 0, c)
        lo_ = np.where(is_leaf[:, None], quad_lo[leaf_idx],
                       node_lo[int_idx])
        hi_ = np.where(is_leaf[:, None], quad_hi[leaf_idx],
                       node_hi[int_idx])
        return lo_, hi_, is_leaf | ready[int_idx]

    for _ in range(n_int + 1):
        if ready.all():
            break
        llo, lhi, lok = child_box(left)
        rlo, rhi, rok = child_box(right)
        new = lok & rok & ~ready
        node_lo = np.where(new[:, None], np.minimum(llo, rlo), node_lo)
        node_hi = np.where(new[:, None], np.maximum(lhi, rhi), node_hi)
        ready |= new
    assert ready.all(), "binary BVH box fixpoint did not converge"
    return node_lo, node_hi


def _leaf_rows_for(tri_verts, quads):
    """(Qn, 4) original ids -> (Qn, 48) quad leaf rows."""
    rows = np.zeros((quads.shape[0], ROW_LANES), np.float32)
    for s in range(LEAF_K):
        tid = quads[:, s]
        ok = tid >= 0
        tv = tri_verts[np.maximum(tid, 0)]
        v0 = np.where(ok[:, None], tv[:, 0], 0.0)
        e1 = np.where(ok[:, None], tv[:, 1] - tv[:, 0], 0.0)
        e2 = np.where(ok[:, None], tv[:, 2] - tv[:, 0], 0.0)
        if s == 0:
            o9, oid = 0, 10
        else:
            o9, oid = _TRI1_OFF[s - 1], _ID1_OFF + s - 1
        rows[:, o9:o9 + 3] = v0
        rows[:, o9 + 3:o9 + 6] = e1
        rows[:, o9 + 6:o9 + 9] = e2
        rows[:, oid] = np.where(ok, tid, -1).astype(np.float32)
    rows[:, 12] = 1.0
    return rows


def build_wide(tri_verts: np.ndarray, method: str = "sah"):
    """8-wide threaded BVH over (T, 3, 3) world triangles: the binary SAH
    tree collapsed 3 levels at a time. Returns (rows (N, 80) f32, leaf_tri
    (N, 4) original triangle ids per leaf slot, -1 = empty)."""
    if method != "sah":
        raise NotImplementedError("the wide build takes the sah topology")
    t = tri_verts.shape[0]
    if t <= LEAF_K:
        quad = np.full((1, LEAF_K), -1, np.int64)
        quad[0, :t] = np.arange(t)
        row = np.zeros((1, WIDE_LANES), np.float32)
        row[:, :ROW_LANES] = _leaf_rows_for(tri_verts, quad)
        row[:, _W_FLAG] = 1.0
        row[:, _W_THREAD + 1:_W_THREAD + 16:2] = -1.0    # all-octant miss
        return row, quad

    left, right, quad_tri = _sah_topology(tri_verts, LEAF_K)
    q = quad_tri.shape[0]
    qs = np.where(quad_tri >= 0, quad_tri, quad_tri[:, 0:1])
    quad_lo = tri_verts[qs].min(axis=(1, 2)).astype(np.float32)
    quad_hi = tri_verts[qs].max(axis=(1, 2)).astype(np.float32)
    node_lo, node_hi = _binary_boxes(left, right, quad_lo, quad_hi)

    def expand(c, depth):
        if c < 0 or depth == 0:
            return [c]
        return expand(left[c], depth - 1) + expand(right[c], depth - 1)

    # wide nodes in BFS order: each one's children are its binary
    # descendants 3 levels down (or the leaves above them)
    wide_children = []
    queue = [0]
    while queue:
        nxt = []
        for b in queue:
            kids = expand(b, 3)
            kids += [None] * (WIDE_ARITY - len(kids))
            wide_children.append(kids)
            nxt += [k for k in kids if k is not None and k >= 0]
        queue = nxt
    n_wide = len(wide_children)
    wide_ids = {}
    order = [0]
    idx = 0
    while idx < len(order):
        wide_ids[order[idx]] = idx
        order += [k for k in wide_children[idx] if k is not None and k >= 0]
        idx += 1
    assert len(order) == n_wide

    # rows: wide internals first, then the q leaf rows
    n_rows = n_wide + q

    def row_of(c):
        return wide_ids[c] if c >= 0 else n_wide + (~c)

    ch_row = np.full((n_wide, WIDE_ARITY), -1, np.int64)
    ch_lo = np.full((n_wide, WIDE_ARITY, 3), 1e30, np.float32)
    ch_hi = np.full((n_wide, WIDE_ARITY, 3), -1e30, np.float32)
    for w in range(n_wide):
        for s, c in enumerate(wide_children[w]):
            if c is None:
                continue
            ch_row[w, s] = row_of(c)
            if c < 0:
                ch_lo[w, s] = quad_lo[~c]
                ch_hi[w, s] = quad_hi[~c]
            else:
                ch_lo[w, s] = node_lo[c]
                ch_hi[w, s] = node_hi[c]
    ch_cent = 0.5 * (ch_lo + ch_hi)
    ch_valid = ch_row >= 0

    # parent row and BFS level of every row (the level-ordered threading)
    parent_row = np.full(n_rows, -1, np.int64)
    parent_slot = np.full(n_rows, -1, np.int64)
    for w in range(n_wide):
        for s in range(WIDE_ARITY):
            if ch_valid[w, s]:
                parent_row[ch_row[w, s]] = w
                parent_slot[ch_row[w, s]] = s
    level = np.zeros(n_rows, np.int64)
    for rrow in range(1, n_rows):
        p = parent_row[rrow]
        if p >= 0:
            level[rrow] = level[p] + 1
    max_level = int(level.max()) if n_rows > 1 else 0

    leaf_tri = np.concatenate(
        [np.full((n_wide, LEAF_K), -1, np.int64), quad_tri])
    geo = np.zeros((n_rows, WIDE_LANES), np.float32)
    boxes = np.concatenate([ch_lo, ch_hi], axis=-1)      # (n_wide, 8, 6)
    geo[:n_wide, :48] = boxes.reshape(n_wide, 48)
    geo[:n_wide, _W_CHILD:_W_CHILD + 8] = np.where(
        ch_valid, ch_row, -1).astype(np.float32)
    geo[n_wide:, :ROW_LANES] = _leaf_rows_for(tri_verts, quad_tri)
    geo[n_wide:, _W_FLAG] = 1.0

    for okt in range(8):
        sign = np.array([1.0 if not (okt >> a) & 1 else -1.0
                         for a in range(3)], np.float32)
        key = np.where(ch_valid, ch_cent @ sign, np.inf)
        perm = np.argsort(key, axis=1, kind="stable")    # (n_wide, 8)
        p_row = np.take_along_axis(ch_row, perm, axis=1)
        counts = (p_row >= 0).sum(axis=1)
        inv_full = np.argsort(perm, axis=1)              # slot -> position
        iperm = np.zeros(n_wide, np.int64)
        for s in range(WIDE_ARITY):
            iperm |= inv_full[:, s].astype(np.int64) << (3 * s)
        geo[:n_wide, _W_THREAD + 2 * okt] = iperm.astype(np.float32)

        # threading, parents before children: child k's miss is the next
        # octant-ordered sibling; the last child inherits its parent's
        miss = np.full(n_rows, -1, np.int64)
        for lvl in range(1, max_level + 1):
            sel = np.flatnonzero(level == lvl)
            if sel.size == 0:
                continue
            pw = parent_row[sel]
            inv = np.argsort(perm[pw], axis=1)
            pos = inv[np.arange(sel.size), parent_slot[sel]]
            nxt_row = np.where(
                pos + 1 < counts[pw],
                p_row[pw, np.minimum(pos + 1, WIDE_ARITY - 1)],
                -2)                                       # -2 = inherit
            miss[sel] = np.where(nxt_row == -2, miss[pw], nxt_row)
        geo[:, _W_THREAD + 2 * okt + 1] = miss.astype(np.float32)
    return geo, leaf_tri


@dataclasses.dataclass
class SceneBVH:
    """The wide BVH: rows (N, 80) f32 on the device (module docstring)."""
    rows: torch.Tensor

    def nbytes(self) -> int:
        return self.rows.numel() * self.rows.element_size()


def bvh_from_arrays(rows, device) -> SceneBVH:
    """(N, 80) wide rows as numpy (a JAX-built SceneBVH's rows, say) ->
    SceneBVH on `device`."""
    rows = np.asarray(rows, np.float32)
    if rows.ndim != 2 or rows.shape[1] != WIDE_LANES:
        raise ValueError("need the wide layout's (N, 80) rows")
    return SceneBVH(rows=torch.tensor(rows, device=resolve_device(device)))


def scene_triangles(scene):
    """(T, 3, 3) world-space triangles of the scene's real triangles and
    their (T,) double-sided flags, as numpy, computed as the JAX build
    does."""
    n = scene.meta.num_triangles
    pos = scene.positions.cpu().numpy()
    xf = scene.mesh_transforms.cpu().numpy()
    vm = scene.vtx_mesh.cpu().numpy()
    world = np.einsum("vi,vij->vj",
                      np.concatenate([pos, np.ones_like(pos[:, :1])], -1),
                      xf[vm])[:, :3]
    tris = world[scene.tri_vtx.cpu().numpy()[:n]]
    prim = scene.tri_prim.cpu().numpy()[:n]
    ds = scene.prim_double_sided.cpu().numpy()[np.maximum(prim, 0)]
    return tris, ds


def build_scene_bvh(scene, method: str = "sah", use_cache: bool = True,
                    wide: bool = True, device=None) -> SceneBVH:
    """World-space wide BVH over the packed scene's real triangles, with
    each leaf slot's double-sided flag. The SAH build costs tens of seconds
    on the host at 300k triangles, so the rows are cached on disk under
    scene/cache.py's CACHE_DIR, keyed on the world geometry."""
    if not wide:
        raise NotImplementedError(
            "not ported yet: the binary BVH layout (wide=False)")
    device = resolve_device(device)
    tris, ds = scene_triangles(scene)
    cache_file = None
    if use_cache:
        from ..scene import cache as cache_mod
        h = hashlib.sha1()
        h.update(tris.tobytes())
        h.update(ds.tobytes())
        h.update(f"bvh-v5-{method}-{LEAF_K}-1".encode())
        cache_file = cache_mod.CACHE_DIR / f"bvh-{h.hexdigest()[:20]}.npz"
        if cache_file.exists():
            return bvh_from_arrays(np.load(cache_file)["rows"], device)
    geo, leaf_tri = build_wide(tris, method=method)
    for s in range(LEAF_K):
        tid = leaf_tri[:, s]
        ok = tid >= 0
        lane = 11 if s == 0 else _DS1_OFF + s - 1
        geo[ok, lane] = ds[tid[ok]].astype(np.float32)
    if cache_file is not None:
        cache_file.parent.mkdir(parents=True, exist_ok=True)
        np.savez(cache_file, rows=geo)
    return bvh_from_arrays(geo, device)


def apply_mesh_visibility(bvh: SceneBVH, scene, mesh_visible) -> SceneBVH:
    """A BVH whose leaf slots of hidden meshes hold degenerate triangles
    (no hits, no occlusion); interior boxes stay as they were. Returns
    `bvh` itself when every mesh is visible."""
    vis = np.asarray(mesh_visible.cpu() if torch.is_tensor(mesh_visible)
                     else mesh_visible).astype(bool)
    if vis.all():
        return bvh
    tri_prim = scene.tri_prim.cpu().numpy()
    prim_mesh = scene.prim_mesh.cpu().numpy()
    tri_hidden = ~vis[np.maximum(prim_mesh[np.maximum(tri_prim, 0)], 0)]
    rows = bvh.rows.cpu().numpy().copy()
    slots = [(10, 0)] + [(_ID1_OFF + s, _TRI1_OFF[s]) for s in range(3)]
    leaf = rows[:, _W_FLAG] > 0.5
    for lane, o9 in slots:
        with np.errstate(invalid="ignore"):      # internal rows' box lanes
            tid = rows[:, lane].astype(np.int64)
        hide = leaf & (tid >= 0) \
            & tri_hidden[np.clip(tid, 0, tri_hidden.shape[0] - 1)]
        rows[hide, lane] = -1.0
        rows[hide, o9:o9 + 9] = 0.0     # degenerate: det 0, never accepted
    return SceneBVH(rows=torch.tensor(rows, device=bvh.rows.device))


# ---------------------------------------------------------------------------
# Traversal: K4 and its twin
# ---------------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# rows, origins, directions, tmin per ray, tmin, tmax, any_hit, rays,
# max_steps, t, tri, u, v, steps, counters, trunc
K4 = Kernel("bvh", "k4_trace",
            [_P, _P, _P, _P, _F, _F, _I, _I, _I, _P, _P, _P, _P, _P, _P,
             _P])

# K4's trunc and arrival counters, per (device, stream): zero between
# launches, which leave them zero (csrc/bvh.cu), so a call needs no memset.
_K4_COUNTERS: dict = {}


def _k4_counters(dev):
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    buf = _K4_COUNTERS.get(key)
    if buf is None:
        buf = torch.zeros(2, dtype=torch.int32, device=dev)
        _K4_COUNTERS[key] = buf
    return buf


def _fma(a, b, c):
    """f32 a * b + c, a fused multiply-add emulated through f64: the
    product of two f32 values is exact in f64, the f64 sum rounds once and
    the cast to f32 again (double rounding: in rare ties an ulp from a
    single-rounding FMA). csrc/bvh.cu k4_fma computes the same
    expression."""
    return (a.double() * b.double() + c.double()).float()


def _cross(a, b):
    """a x b of component lists, each term one multiply-add through _fma,
    where XLA's CPU build fuses jnp.cross."""
    return [_fma(a[1], b[2], -(a[2] * b[1])),
            _fma(a[2], b[0], -(a[0] * b[2])),
            _fma(a[0], b[1], -(a[1] * b[0]))]


def _dot(a, b):
    """a . b as XLA's CPU build compiles jnp.sum(a * b, -1): a chain of
    multiply-adds through _fma from the first product."""
    return _fma(a[2], b[2], _fma(a[1], b[1], a[0] * b[0]))


def _tri_intersect(tri9, o, d, cull):
    """Moller-Trumbore on component lists: tri9 = [v0, e1, e2] as 9 (n,)
    tensors, o and d 3 each. -> (t or inf, u, v), the reference's
    arithmetic (bvh.py:822-841) term by term, as csrc/bvh.cu spells it."""
    v0, e1, e2 = tri9[0:3], tri9[3:6], tri9[6:9]
    p = _cross(d, e2)
    det = _dot(e1, p)
    big = torch.abs(det) > 1e-12
    ok = torch.where(cull, det < -1e-12, big)
    inv = 1.0 / torch.where(big, det, torch.ones_like(det))
    tv = [o[i] - v0[i] for i in range(3)]
    u = _dot(tv, p) * inv
    q = _cross(tv, e1)
    v = _dot(d, q) * inv
    t = _dot(e2, q) * inv
    ok = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
    return torch.where(ok, t, torch.full_like(t, float("inf"))), u, v


def _step_wide(rows, okt, o, d, inv_d, tmax_eff, state, any_hit: bool):
    """One traversal step of every ray in the state (JAX _step_wide,
    bvh.py:914-987): one row each; a leaf tests its 4 slots in order, an
    internal row its 8 child boxes in storage order."""
    cur, t_best, best_tri, uo, vo, alive = state
    row = rows[cur]                                      # (n, 80)
    lane = [row[:, i] for i in range(WIDE_LANES)]
    leaf = lane[_W_FLAG] > 0.5
    thread = row[:, _W_THREAD:].reshape(-1, 8, 2)
    sel = thread[torch.arange(cur.shape[0], device=cur.device), okt]
    iperm = sel[:, 0].to(torch.int64)
    miss = sel[:, 1].to(torch.int64)

    for s in range(LEAF_K):
        if s == 0:
            o9, oid, ods = 0, 10, 11
        else:
            o9, oid, ods = (_TRI1_OFF[s - 1], _ID1_OFF + s - 1,
                            _DS1_OFF + s - 1)
        t_hit, u, v = _tri_intersect(lane[o9:o9 + 9], o, d, lane[ods] < 0.5)
        tri = lane[oid].to(torch.int32)
        accept = (leaf & alive & (tri >= 0) & (t_hit < t_best)
                  & (t_hit <= tmax_eff))
        t_best = torch.where(accept, t_hit, t_best)
        best_tri = torch.where(accept, tri, best_tri)
        uo = torch.where(accept, u, uo)
        vo = torch.where(accept, v, vo)
        if any_hit:
            alive = alive & ~accept

    nxt_int = miss
    best_pos = torch.full_like(miss, WIDE_ARITY)
    limit = torch.fmin(t_best, tmax_eff)
    for k in range(WIDE_ARITY):
        tn = torch.zeros_like(t_best)
        tf = limit
        for a in range(3):
            t0 = (lane[6 * k + a] - o[a]) * inv_d[a]
            t1 = (lane[6 * k + 3 + a] - o[a]) * inv_d[a]
            tn = torch.fmax(tn, torch.fmin(t0, t1))
            tf = torch.fmin(tf, torch.fmax(t0, t1))
        cid = lane[_W_CHILD + k].to(torch.int64)
        pos = (iperm >> (3 * k)) & 7
        hit_k = (tn <= tf) & (cid >= 0) & (pos < best_pos)
        best_pos = torch.where(hit_k, pos, best_pos)
        nxt_int = torch.where(hit_k, cid, nxt_int)

    nxt = torch.where(leaf, miss, nxt_int)
    alive = alive & (nxt >= 0)
    cur = torch.where(alive, nxt, torch.zeros_like(nxt))
    return cur, t_best, best_tri, uo, vo, alive


def _ray_setup(origins, directions, tmin, tmax):
    """(o + d tmin, inv_d, tmax - tmin, octant): the reference's ray setup
    (bvh.py:1122-1138) in f32, as K4 does it."""
    tm = (tmin[:, None] if torch.is_tensor(tmin)
          else torch.tensor(np.float32(tmin), device=origins.device))
    o = _fma(directions, tm, origins)
    tiny = torch.where(directions >= 0, 1e-12, -1e-12)
    inv_d = 1.0 / torch.where(torch.abs(directions) > 1e-12, directions,
                              tiny)
    if torch.is_tensor(tmin):
        tmax_eff = torch.tensor(np.float32(tmax), device=origins.device) \
            - tmin
    else:
        tmax_eff = torch.tensor(np.float32(tmax) - np.float32(tmin),
                                device=origins.device)
    okt = ((directions[:, 0] < 0).to(torch.int64)
           + 2 * (directions[:, 1] < 0).to(torch.int64)
           + 4 * (directions[:, 2] < 0).to(torch.int64))
    return o, inv_d, tmax_eff, okt


def trace_plain(bvh: SceneBVH, origins, directions, tmin=0.0, tmax=1e30,
                any_hit: bool = False, max_steps: int = MAX_STEPS,
                return_steps: bool = False):
    """K4's twin: _step_wide over the rays still walking until none is or
    each has visited max_steps rows (every 8 steps the finished rays are
    dropped from the batch, which changes nothing of the result).
    return_steps adds the diagnostics of the walk: `steps` and
    `leaf_steps`, the rows and the leaf rows each ray visited;
    `tri_tests`, the filled leaf slots (tri >= 0) each ray had to test
    (with any_hit, up to the slot it accepted); `box_tests`, the filled
    child slots (id >= 0) of the internal rows it visited; and `visited`,
    an (N,) mask of the rows any ray visited."""
    r = origins.shape[0]
    dev = origins.device
    o, inv_d, tmax_eff, okt = _ray_setup(origins, directions, tmin, tmax)
    t_best = torch.full((r,), float("inf"), device=dev)
    best_tri = torch.full((r,), -1, dtype=torch.int32, device=dev)
    uo = torch.zeros(r, device=dev)
    vo = torch.zeros(r, device=dev)
    steps = torch.zeros(r, dtype=torch.int32, device=dev)
    leaf_steps = torch.zeros_like(steps)
    visited = torch.zeros(bvh.rows.shape[0], dtype=torch.bool, device=dev)
    tri_tests = torch.zeros_like(steps)
    box_tests = torch.zeros_like(steps)
    if return_steps:
        slot_ids, filled_tris, filled_boxes = _filled_slots(bvh.rows)
    idx = torch.arange(r, device=dev)
    cur = torch.zeros(r, dtype=torch.int64, device=dev)
    alive = torch.ones(r, dtype=torch.bool, device=dev)
    tm = tmax_eff.expand(r) if tmax_eff.dim() == 0 else tmax_eff
    n_done = 0
    while idx.numel() and n_done < max_steps:
        ob = [o[idx, a] for a in range(3)]
        db = [directions[idx, a] for a in range(3)]
        ib = [inv_d[idx, a] for a in range(3)]
        state = (cur, t_best[idx], best_tri[idx], uo[idx], vo[idx], alive)
        for _ in range(min(8, max_steps - n_done)):
            steps[idx] += state[5].to(torch.int32)
            before = state
            state = _step_wide(bvh.rows, okt[idx], ob, db, ib, tm[idx],
                               state, any_hit)
            if return_steps:
                row, on = before[0], before[5]
                visited[row[on]] = True
                leaf = on & (bvh.rows[row, _W_FLAG] > 0.5)
                leaf_steps[idx] += leaf.to(torch.int32)
                # slots tested: all filled ones, or with any_hit up to the
                # accepted slot (an alive any-hit ray has no hit yet)
                last = torch.full_like(row, LEAF_K - 1)
                if any_hit:
                    hit = leaf & (state[2] >= 0)
                    first = torch.argmax(
                        (slot_ids[row] == state[2][:, None]).to(torch.int8),
                        dim=1)
                    last = torch.where(hit, first, last)
                tri_tests[idx] += torch.where(
                    leaf, filled_tris[row, last], 0).to(torch.int32)
                box_tests[idx] += torch.where(
                    on & ~leaf, filled_boxes[row], 0).to(torch.int32)
            n_done += 1
        cur, tb, bt, ub, vb, alive = state
        t_best[idx], best_tri[idx], uo[idx], vo[idx] = tb, bt, ub, vb
        keep = torch.nonzero(alive).squeeze(1)
        idx, cur, alive = idx[keep], cur[keep], alive[keep]
    trunc = torch.tensor(idx.numel(), dtype=torch.int32, device=dev)
    out = _finish(t_best, best_tri, uo, vo, tmin, trunc)
    if return_steps:
        out.update(steps=steps, leaf_steps=leaf_steps, tri_tests=tri_tests,
                   box_tests=box_tests, visited=visited)
    return out


def _filled_slots(rows):
    """(slot_ids (N, 4) leaf slot tri ids, filled_tris (N, 4) filled leaf
    slots among slots 0..s, filled_boxes (N,) filled child slots)."""
    slot_ids = torch.stack([rows[:, 10]] + [rows[:, _ID1_OFF + s]
                                            for s in range(LEAF_K - 1)],
                           1).to(torch.int32)
    filled_tris = torch.cumsum((slot_ids >= 0).to(torch.int32), 1)
    filled_boxes = (rows[:, _W_CHILD:_W_CHILD + WIDE_ARITY] >= 0).sum(1)
    return slot_ids, filled_tris, filled_boxes


def _finish(t_best, best_tri, uo, vo, tmin, trunc):
    t = torch.where(best_tri >= 0, t_best + tmin,
                    torch.full_like(t_best, float("inf")))
    return dict(t=t, tri=best_tri, u=uo, v=vo, trunc=trunc)


def trace_k4(bvh: SceneBVH, origins, directions, tmin=0.0, tmax=1e30,
             any_hit: bool = False, max_steps: int = MAX_STEPS,
             return_steps: bool = False, role=None):
    """K4 on CUDA tensors (csrc/bvh.cu); raises on anything else."""
    dev = origins.device
    r = origins.shape[0]
    for name, t, shape in (("origins", origins, (r, 3)),
                           ("directions", directions, (r, 3)),
                           ("rows", bvh.rows, (bvh.rows.shape[0],
                                               WIDE_LANES))):
        if t.dtype != torch.float32 or t.device != dev \
                or not t.is_contiguous() or tuple(t.shape) != shape:
            raise ValueError(f"{name}: need a contiguous float32 {shape} "
                             f"tensor on {dev}")
    tmin_ray = None
    if torch.is_tensor(tmin):
        tmin_ray = tmin.to(torch.float32).contiguous()
        if tuple(tmin_ray.shape) != (r,) or tmin_ray.device != dev:
            raise ValueError(f"tmin: need a scalar or an ({r},) tensor")
        tmin_s = 0.0
    else:
        tmin_s = float(np.float32(tmin))
    t = torch.empty(r, dtype=torch.float32, device=dev)
    tri = torch.empty(r, dtype=torch.int32, device=dev)
    u = torch.empty(r, dtype=torch.float32, device=dev)
    v = torch.empty(r, dtype=torch.float32, device=dev)
    trunc = torch.zeros((), dtype=torch.int32, device=dev) if r == 0 \
        else torch.empty((), dtype=torch.int32, device=dev)
    steps = (torch.empty(r, dtype=torch.int32, device=dev) if return_steps
             else None)
    if r:
        K4(ptr(bvh.rows), ptr(origins), ptr(directions), ptr(tmin_ray),
           tmin_s, float(np.float32(tmax)), int(any_hit), r, max_steps,
           ptr(t), ptr(tri), ptr(u), ptr(v), ptr(steps),
           ptr(_k4_counters(dev)), ptr(trunc), name=role)
    out = dict(t=t, tri=tri, u=u, v=v, trunc=trunc)
    if return_steps:
        out["steps"] = steps
    return out


def trace(bvh: SceneBVH, origins, directions, tmin=0.0, tmax=1e30,
          any_hit: bool = False, alpha_of=None, profile: str = "incoherent",
          role=None):
    """Trace rays against the BVH: K4 on CUDA tensors, the twin on CPU ones.

    origins, directions: (R, 3) f32. tmin: a float or an (R,) tensor (each
    ray starts at o + d tmin and ends at tmax). Returns dict(t (R,) from
    the ray's origin, inf on a miss; tri (R,) i32, -1 on a miss; u, v;
    trunc () i32, the rays stopped by MAX_STEPS). any_hit stops at the
    first accepted hit (shadow rays). profile picks a TPU compaction
    schedule in the JAX package and has no effect here. role names the
    launch in K4's per-role count."""
    del profile
    if alpha_of is not None:
        raise NotImplementedError(
            "not ported yet: alpha_of filters inside the walk")
    origins = origins.contiguous()
    directions = directions.contiguous()
    if origins.is_cuda:
        return trace_k4(bvh, origins, directions, tmin, tmax, any_hit,
                        role=role)
    return trace_plain(bvh, origins, directions, tmin, tmax, any_hit)


def occluded(bvh: SceneBVH, origins, directions, tmin=0.1, tmax=1000.0,
             alpha_of=None, role=None):
    """Boolean shadow query (ref: lighting/common.hlsli:98-116: TMin 0.1,
    TMax 1000, backface culling)."""
    return trace(bvh, origins, directions, tmin=tmin, tmax=tmax,
                 any_hit=True, alpha_of=alpha_of, role=role)["tri"] >= 0
