"""Scene BVH: the host builds (numpy, at load) and ray traversal on the
device (port of incarnation_tpu/kernels/bvh.py).

Two layouts over the same quad leaves (4 triangles inline per leaf row):

- wide (the default): a top-down binned-SAH binary tree collapsed three
  levels at a time into 8-wide internal rows. One (N, 80) f32 table holds
  every row, octant-invariant:

    internal  [8 x (lo3, hi3) child boxes @0:48, flag 0.0 @48, -, 8 local
              child row ids @50:58 (-1 = empty), -, 8 octants x (iperm
              word, miss link) @64:80]
    leaf      [v0a e1a e2a @0:9, -, tri_a @10, ds_a @11, 1.0 @12, -, -,
              slot b @15:24, slot c @24:33, slot d @33:42, tri_b..d @42:45,
              ds_b..d @45:48, flag 1.0 @48, -, ..., thread words @64:80]

  An iperm word packs each storage slot's 3-bit position in the octant's
  near-to-far order; the miss link is the next row of the walk when a
  subtree is done (-1 ends the walk). An internal row slab-tests its 8
  children in storage order and jumps to the hit child with the smallest
  position, else follows the miss link.

- binary (wide=False): the SAH (or Morton/Karras) binary tree itself, one
  48-lane row per node (internal rows hold their own box at 0:6 and 0.0 at
  lane 12, leaf rows the quad as above), threaded per ray-direction octant:
  a (hit, miss) link pair per node and octant, the hit link being the child
  nearer along the octant. Up to _MERGE_LIMIT nodes the links ride inline
  in a MERGED (8N, 48) table of per-octant row copies (lanes 13, 14: one
  read per step); above it the table is SPLIT into (N, 48) rows and (8N, 2)
  links, int32 (the largest link, about 8N, then passes 2^24, past which
  f32 does not hold every integer). An internal row slab-tests its own box,
  pruned by the best hit so far, and follows the hit link on a hit, else
  the miss link.

A leaf row intersects its 4 triangles in slot order (Moller-Trumbore,
backface-culled unless double-sided) and follows its miss link.

Traversal is K4 (csrc/bvh.cu, one thread per ray walking the rows
stacklessly, a compile-time role per layout) on CUDA tensors and the plain
twin (_step_wide or _step looped over the batch) on CPU ones; both round
identically: K4 is built --fmad=false, and the multiply-adds that XLA's
CPU build fuses are one FFMA each in K4 and rounded once, exactly, by the
twin's _fma. The JAX package's compaction
ladders and step schedules exist for the TPU's lock-step wavefront and are
not ported: each ray here walks until it is done or has spent MAX_STEPS
rows (counted in `trunc`).

An alpha filter inside the walk (trace(alpha_of=...)) is any callable
alpha_of(tri, u, v) -> bool for the twin; K4 evaluates one kind only, the
path tracer's opacity test, given as a pathtrace.AlphaFilter.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib

import numpy as np
import torch

from ..core.mathutils import fma as _fma
from ..device import resolve_device
from .build import Kernel, ptr, zero_scratch

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


def _bit_length_u64(x: np.ndarray) -> np.ndarray:
    """Exact vectorized bit length of uint64 values."""
    bl = np.zeros(x.shape, np.int64)
    v = x.copy()
    for shift in (32, 16, 8, 4, 2, 1):
        has = (v >> np.uint64(shift)) != 0
        bl = np.where(has, bl + shift, bl)
        v = np.where(has, v >> np.uint64(shift), v)
    return bl + (v != 0)


def _common_prefix(codes64: np.ndarray, i: np.ndarray, j: np.ndarray,
                   n: int) -> np.ndarray:
    """delta(i, j) with index-augmented codes; -1 outside [0, n)."""
    valid = (j >= 0) & (j < n)
    jj = np.clip(j, 0, n - 1)
    x = codes64[i] ^ codes64[jj]
    return np.where(valid, 64 - _bit_length_u64(x), -1)


def _karras_topology(codes64: np.ndarray, t: int):
    """Karras 2012 radix tree: left/right child codes for t-1 internal
    nodes (negative = ~sorted_leaf_position)."""
    i = np.arange(t - 1, dtype=np.int64)
    d = np.sign(_common_prefix(codes64, i, i + 1, t)
                - _common_prefix(codes64, i, i - 1, t)).astype(np.int64)
    d = np.where(d == 0, 1, d)
    delta_min = _common_prefix(codes64, i, i - d, t)

    lmax = np.full(t - 1, 2, np.int64)
    while True:
        probe = _common_prefix(codes64, i, i + lmax * d, t) > delta_min
        if not probe.any():
            break
        lmax = np.where(probe, lmax * 2, lmax)
        if lmax.max() > 2 * t:
            break

    l = np.zeros(t - 1, np.int64)
    step = lmax // 2
    while step.max() > 0:
        cand = l + step
        ok = _common_prefix(codes64, i, i + cand * d, t) > delta_min
        l = np.where(ok, cand, l)
        step = step // 2
    j = i + l * d
    delta_node = _common_prefix(codes64, i, j, t)

    s = np.zeros(t - 1, np.int64)
    div = 2
    step = -(-l // div)
    while True:
        cand = s + step
        ok = _common_prefix(codes64, i, i + cand * d, t) > delta_node
        s = np.where((step > 0) & ok, cand, s)
        if (step <= 1).all():
            break
        div *= 2
        step = -(-l // div)
    gamma = i + s * d + np.minimum(d, 0)

    left_is_leaf = np.minimum(i, j) == gamma
    right_is_leaf = np.maximum(i, j) == gamma + 1
    left = np.where(left_is_leaf, ~gamma, gamma)          # ~x < 0 => leaf
    right = np.where(right_is_leaf, ~(gamma + 1), gamma + 1)
    return left, right


def build_lbvh(tri_verts: np.ndarray, method: str = "sah"):
    """Binary threaded BVH over (T, 3, 3) world triangles -> (rows (N, 48)
    f32, links (8N, 2) int32, leaf_tri (N, 4) original triangle ids per leaf
    slot, -1 = empty). Rows: internal nodes first (root 0), then the quad
    leaves; links: per octant okt the (hit, miss) pair of every node as
    GLOBAL indices okt * N + node (-1 ends the walk). The caller fills the
    double-sided lanes from leaf_tri.

    method: "sah" (binned SAH topology, fewest traversal steps) or
    "morton" (Karras radix tree over Morton-ordered quads, faster to
    build)."""
    from ..scene.meshlets import morton3
    t = tri_verts.shape[0]

    centroids = tri_verts.mean(axis=1)
    lo = centroids.min(0)
    hi = centroids.max(0)
    norm = (centroids - lo) / np.maximum(hi - lo, 1e-12)
    codes = morton3(norm)
    order = np.argsort(codes, kind="stable").astype(np.int64)

    # Morton-consecutive triangles grouped into quads (the leaf unit)
    q = -(-t // LEAF_K)
    pad = q * LEAF_K - t
    order_p = np.concatenate([order, np.full(pad, -1, np.int64)])
    quad_tri = order_p.reshape(q, LEAF_K)           # (Q, 4) orig ids, -1 pad
    qs = np.where(quad_tri >= 0, quad_tri, quad_tri[:, 0:1])
    quad_lo = tri_verts[qs].min(axis=(1, 2))
    quad_hi = tri_verts[qs].max(axis=(1, 2))

    if q == 1:
        return (_leaf_rows_for(tri_verts, quad_tri),
                np.full((8, 2), -1, np.int32), quad_tri)

    if method == "sah":
        # SAH leaves replace the Morton quads (they hold <= LEAF_K tris)
        left, right, quad_tri = _sah_topology(tri_verts, LEAF_K)
        q = quad_tri.shape[0]
        qs = np.where(quad_tri >= 0, quad_tri, quad_tri[:, 0:1])
        quad_lo = tri_verts[qs].min(axis=(1, 2))
        quad_hi = tri_verts[qs].max(axis=(1, 2))
    else:
        qcodes = codes[qs[:, 0]]
        codes64 = (qcodes.astype(np.uint64) << np.uint64(32)) \
            | np.arange(q, dtype=np.uint64)
        left, right = _karras_topology(codes64, q)
    n_int = q - 1

    # bottom-up AABBs of the internal nodes
    node_lo = np.full((n_int, 3), np.inf, np.float32)
    node_hi = np.full((n_int, 3), -np.inf, np.float32)
    ready = np.zeros(n_int, bool)

    def child_box(c):
        is_leaf = c < 0
        leaf_idx = np.where(is_leaf, ~c, 0)
        int_idx = np.where(is_leaf, 0, c)
        lo_ = np.where(is_leaf[:, None], quad_lo[leaf_idx], node_lo[int_idx])
        hi_ = np.where(is_leaf[:, None], quad_hi[leaf_idx], node_hi[int_idx])
        return lo_, hi_, is_leaf | ready[int_idx]

    for _ in range(64):
        if ready.all():
            break
        llo, lhi, lok = child_box(left)
        rlo, rhi, rok = child_box(right)
        new_ready = lok & rok & ~ready
        node_lo = np.where(new_ready[:, None], np.minimum(llo, rlo), node_lo)
        node_hi = np.where(new_ready[:, None], np.maximum(lhi, rhi), node_hi)
        ready |= new_ready

    # Threaded links over the unified table (internal node i -> row i,
    # leaf j -> row n_int + j), one set per ray-direction octant: the child
    # nearer along the octant direction is descended first, so closest-hit
    # pruning cuts the far subtrees.
    def entry(c):
        return np.where(c < 0, n_int + (~c), c).astype(np.int64)

    l_e = entry(left)
    r_e = entry(right)
    n_total = n_int + q
    llo, lhi, _ = child_box(left)
    rlo, rhi, _ = child_box(right)
    c_l = 0.5 * (llo + lhi)
    c_r = 0.5 * (rlo + rhi)

    base = np.zeros((n_total, ROW_LANES), np.float32)
    base[:n_int, 0:3] = node_lo
    base[:n_int, 3:6] = node_hi
    base[n_int:] = _leaf_rows_for(tri_verts, quad_tri)
    leaf_tri = np.concatenate([np.full((n_int, LEAF_K), -1, np.int64),
                               quad_tri])

    links = np.zeros((8 * n_total, 2), np.int32)
    idx_int = np.arange(n_int)
    for okt in range(8):
        sign = np.array([1.0 if not (okt >> a) & 1 else -1.0
                         for a in range(3)], np.float32)
        near_left = (c_l @ sign) <= (c_r @ sign)
        near = np.where(near_left, l_e, r_e)
        far = np.where(near_left, r_e, l_e)
        miss = np.full(n_total, -1, np.int64)
        miss[near] = far
        for _ in range(128):
            cur = miss.copy()
            cur[far] = cur[idx_int]
            if np.array_equal(cur, miss):
                break
            miss = cur
        off = okt * n_total
        links[off:off + n_int, 0] = near + off
        links[off:off + n_total, 1] = np.where(miss >= 0, miss + off, -1)
    return base, links, leaf_tri


# Per-octant merged tables cost 8N x 192 B; above this node count (~400 MB,
# ~2M triangles) the binary layout keeps its links in a split table.
_MERGE_LIMIT = 1 << 21


@dataclasses.dataclass
class SceneBVH:
    """The scene BVH on the device, in one of the module docstring's
    layouts: wide, rows (N, 80); binary merged, rows (8N, 48) with each
    octant's (hit, miss) links at lanes 13, 14; binary split, rows (N, 48)
    and int32 links (8N, 2)."""
    rows: torch.Tensor
    links: torch.Tensor = None
    merged: bool = False
    wide: bool = True

    @property
    def nodes(self) -> int:
        """Nodes per octant table: the row count of one octant's copy."""
        return self.rows.shape[0] // 8 if self.merged else self.rows.shape[0]

    @property
    def layout(self) -> int:
        """K4's layout code: 0 wide, 1 binary merged, 2 binary split."""
        return 0 if self.wide else (1 if self.merged else 2)

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.rows, self.links) if t is not None)


def bvh_from_arrays(rows, device, links=None) -> SceneBVH:
    """Numpy rows (a JAX-built SceneBVH's, say) -> SceneBVH on `device`:
    (N, 80) wide rows; (8N, 48) binary merged rows; or (N, 48) binary
    rows with their (8N, 2) links (split)."""
    rows = np.asarray(rows, np.float32)
    device = resolve_device(device)
    if rows.ndim != 2 or rows.shape[1] not in (WIDE_LANES, ROW_LANES):
        raise ValueError("need (N, 80) wide or (N, 48) binary rows")
    if rows.shape[1] == WIDE_LANES:
        if links is not None:
            raise ValueError("the wide layout has no link table")
        return SceneBVH(rows=torch.tensor(rows, device=device))
    if links is None:
        if rows.shape[0] % 8:
            raise ValueError("merged binary rows come in 8 octant copies")
        return SceneBVH(rows=torch.tensor(rows, device=device), merged=True,
                        wide=False)
    links = np.asarray(links)
    if links.shape != (8 * rows.shape[0], 2):
        raise ValueError(f"split links must be (8N, 2), got {links.shape}")
    if not np.array_equal(links.astype(np.int32), links):
        raise ValueError("split links must be whole int32 row indices")
    links = links.astype(np.int32)
    return SceneBVH(rows=torch.tensor(rows, device=device),
                    links=torch.tensor(links, device=device), wide=False)


def _finish_bvh(rows: np.ndarray, links: np.ndarray, device) -> SceneBVH:
    """Binary rows + links -> the merged table up to _MERGE_LIMIT nodes
    (its f32 lanes hold every link exactly: 8N <= 2^24), else the split
    one."""
    if rows.shape[0] <= _MERGE_LIMIT:
        rows8 = np.tile(rows, (8, 1))
        rows8[:, 13:15] = links
        return bvh_from_arrays(rows8, device)
    return bvh_from_arrays(rows, device, links)


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
    """World-space BVH over the packed scene's real triangles, with each
    leaf slot's double-sided flag: the 8-wide layout, or with wide=False
    the binary one (merged or split, _finish_bvh). The SAH build costs
    seconds to tens of seconds on the host at 300k triangles, so the rows
    are cached on disk under scene/cache.py's CACHE_DIR, keyed on the world
    geometry and the layout."""
    device = resolve_device(device)
    tris, ds = scene_triangles(scene)
    cache_file = None
    if use_cache:
        from ..scene import cache as cache_mod
        h = hashlib.sha1()
        h.update(tris.tobytes())
        h.update(ds.tobytes())
        h.update(f"bvh-v6-{method}-{LEAF_K}-{int(wide)}".encode())
        cache_file = cache_mod.CACHE_DIR / f"bvh-{h.hexdigest()[:20]}.npz"
        if cache_file.exists():
            z = np.load(cache_file)
            if wide:
                return bvh_from_arrays(z["rows"], device)
            return _finish_bvh(z["rows"], z["links"], device)
    if wide:
        rows, leaf_tri = build_wide(tris, method=method)
        links = None
    else:
        rows, links, leaf_tri = build_lbvh(tris, method=method)
    # per-slot double-sided flags: single-sided triangles are backface
    # culled (the reference's RAY_FLAG_CULL_BACK_FACING_TRIANGLES)
    for s in range(LEAF_K):
        tid = leaf_tri[:, s]
        ok = tid >= 0
        lane = 11 if s == 0 else _DS1_OFF + s - 1
        rows[ok, lane] = ds[tid[ok]].astype(np.float32)
    if cache_file is not None:
        cache_file.parent.mkdir(parents=True, exist_ok=True)
        if wide:
            np.savez(cache_file, rows=rows)
        else:
            np.savez(cache_file, rows=rows, links=links)
    if wide:
        return bvh_from_arrays(rows, device)
    return _finish_bvh(rows, links, device)


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
    # leaf slot lanes (id lane, geometry base) are the same in every layout
    slots = [(10, 0)] + [(_ID1_OFF + s, _TRI1_OFF[s]) for s in range(3)]
    leaf = rows[:, _W_FLAG if bvh.wide else 12] > 0.5
    for lane, o9 in slots:
        with np.errstate(invalid="ignore"):      # internal rows' box lanes
            tid = rows[:, lane].astype(np.int64)
        hide = leaf & (tid >= 0) \
            & tri_hidden[np.clip(tid, 0, tri_hidden.shape[0] - 1)]
        rows[hide, lane] = -1.0
        rows[hide, o9:o9 + 9] = 0.0     # degenerate: det 0, never accepted
    return dataclasses.replace(bvh, rows=torch.tensor(rows,
                                                      device=bvh.rows.device))


# ---------------------------------------------------------------------------
# Traversal: K4 and its twin
# ---------------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# rows, links, nodes per octant table, layout, origins, directions, tmin
# per ray, tmin, tmax, any_hit, rays, max_steps, t, tri, u, v, steps,
# counters, trunc, alpha filter table (NULL: none)
K4 = Kernel("bvh", "k4_trace",
            [_P, _P, _I, _I, _P, _P, _P, _F, _F, _I, _I, _I, _P, _P, _P, _P,
             _P, _P, _P, _P])


class _K4Alpha(ctypes.Structure):
    """K4's alpha filter table (csrc/bvh.cu struct K4Alpha): the scene and
    texture tensors the opacity test reads, and one noise value per ray."""
    _fields_ = [("tri_vtx", _P), ("uvs", _P), ("tri_prim", _P),
                ("prim_alpha_mode", _P), ("prim_material", _P),
                ("mat_params", _P), ("meta", _P), ("alpha_words", _P),
                ("noise", _P), ("mat_stride", _I), ("n_meta", _I),
                ("alpha_rows", _I), ("n_mat", _I)]

# K4's trunc, arrival and work counters (csrc/bvh.cu), build.zero_scratch
_K4_COUNTERS: dict = {}


def _k4_counters(dev):
    return zero_scratch(_K4_COUNTERS, dev, 3, torch.int32)


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


def _leaf_slots(lane, leaf, o, d, tmax_eff, state, any_hit, alpha_of):
    """The 4 inline triangles of the leaf rows in the batch, in slot order
    (bvh.py:864-885, :943-962): a slot is accepted where it is a filled
    triangle nearer than the best hit and within tmax, and, with a filter,
    where alpha_of(tri, u, v) holds."""
    cur, t_best, best_tri, uo, vo, alive = state
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
        if alpha_of is not None:
            # the filter sees the candidates' hits, and tri -1 elsewhere: an
            # internal row's lanes read as a triangle id can be any int
            accept = accept & alpha_of(torch.where(accept, tri, -1),
                                       torch.where(accept, u, 0.0),
                                       torch.where(accept, v, 0.0))
        t_best = torch.where(accept, t_hit, t_best)
        best_tri = torch.where(accept, tri, best_tri)
        uo = torch.where(accept, u, uo)
        vo = torch.where(accept, v, vo)
        if any_hit:
            alive = alive & ~accept
    return cur, t_best, best_tri, uo, vo, alive


def _step_wide(bvh, okt, o, d, inv_d, tmax_eff, state, any_hit: bool,
               alpha_of=None, diag=None):
    """One traversal step of every ray in the state over the wide layout
    (JAX _step_wide, bvh.py:914-987): one row each; a leaf tests its 4
    slots in order, an internal row its 8 child boxes in storage order.
    diag, a dict, receives `pos` (n, 8), each storage slot's position in
    the ray's octant order, and `first` (n,), the position of the child
    taken (8 where none was hit)."""
    row = bvh.rows[state[0]]                             # (n, 80)
    lane = [row[:, i] for i in range(WIDE_LANES)]
    leaf = lane[_W_FLAG] > 0.5
    thread = row[:, _W_THREAD:].reshape(-1, 8, 2)
    sel = thread[torch.arange(row.shape[0], device=row.device), okt]
    iperm = sel[:, 0].to(torch.int64)
    miss = sel[:, 1].to(torch.int64)
    cur, t_best, best_tri, uo, vo, alive = _leaf_slots(
        lane, leaf, o, d, tmax_eff, state, any_hit, alpha_of)

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
    if diag is not None:
        diag["pos"] = torch.stack([(iperm >> (3 * k)) & 7
                                   for k in range(WIDE_ARITY)], 1)
        diag["first"] = best_pos

    nxt = torch.where(leaf, miss, nxt_int)
    alive = alive & (nxt >= 0)
    cur = torch.where(alive, nxt, torch.zeros_like(nxt))
    return cur, t_best, best_tri, uo, vo, alive


def _step(bvh, okt, o, d, inv_d, tmax_eff, state, any_hit: bool,
          alpha_of=None, diag=None):
    """One traversal step over the binary layout (JAX _step,
    bvh.py:844-900). cur holds local node ids; okt_off = okt * N picks the
    ray's octant table: the merged row at cur + okt_off, or the row at cur
    and the split link at cur + okt_off. A leaf tests its 4 slots; an
    internal row slab-tests its own box, pruned by min(t_best, tmax), and
    takes the hit link on a hit, else the miss link. diag: unused (an
    internal row tests its one box)."""
    okt_off = okt * bvh.nodes
    if bvh.merged:
        row = bvh.rows[state[0] + okt_off]               # (n, 48)
        lnk = row[:, 13:15]
    else:
        row = bvh.rows[state[0]]
        lnk = bvh.links[state[0] + okt_off]              # (n, 2)
    lane = [row[:, i] for i in range(ROW_LANES)]
    leaf = lane[12] > 0.5
    cur, t_best, best_tri, uo, vo, alive = _leaf_slots(
        lane, leaf, o, d, tmax_eff, state, any_hit, alpha_of)

    tn = torch.zeros_like(t_best)
    tf = torch.fmin(t_best, tmax_eff)
    for a in range(3):
        t0 = (lane[a] - o[a]) * inv_d[a]
        t1 = (lane[3 + a] - o[a]) * inv_d[a]
        tn = torch.fmax(tn, torch.fmin(t0, t1))
        tf = torch.fmin(tf, torch.fmax(t0, t1))
    box_hit = (tn <= tf) & ~leaf
    nxt = torch.where(leaf | ~box_hit, lnk[:, 1], lnk[:, 0]).to(torch.int64)
    alive = alive & (nxt >= 0)
    cur = torch.where(alive, nxt - okt_off, torch.zeros_like(nxt))
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
                return_steps: bool = False, alpha_of=None):
    """K4's twin: the layout's step (_step_wide or _step) over the rays
    still walking until none is or each has visited max_steps rows (every
    8 steps the finished rays are dropped from the batch, which changes
    nothing of the result). alpha_of: any callable (tri, u, v) -> bool
    over the batch's rays; a filter with a subset(idx) method is first
    narrowed to the rays still walking (pathtrace.AlphaFilter's noise is
    per ray).

    return_steps adds the diagnostics of the walk: `steps` and
    `leaf_steps`, the rows and the leaf rows each ray visited; `tri_tests`,
    the filled leaf slots (tri >= 0) each ray had to test (with any_hit, up
    to the slot it accepted); `box_tests`, the filled child slots (id >= 0)
    of the internal rows it visited (one box per binary internal row);
    `box_tests_to_hit`, of those the children up to and including the
    first one hit in the ray's octant order (all filled ones where none is
    hit), the least an exact walk in that order must test; `visited`, a
    mask over the table's rows that any ray visited; `visited_slots` (rows,
    8), the leaf slots and child slots that some ray tested (slot 0 of a
    binary internal row: its box); and, for the split binary layout,
    `visited_links` over its link rows."""
    r = origins.shape[0]
    dev = origins.device
    o, inv_d, tmax_eff, okt = _ray_setup(origins, directions, tmin, tmax)
    step = _step_wide if bvh.wide else _step
    t_best = torch.full((r,), float("inf"), device=dev)
    best_tri = torch.full((r,), -1, dtype=torch.int32, device=dev)
    uo = torch.zeros(r, device=dev)
    vo = torch.zeros(r, device=dev)
    steps = torch.zeros(r, dtype=torch.int32, device=dev)
    leaf_steps = torch.zeros_like(steps)
    visited = torch.zeros(bvh.rows.shape[0], dtype=torch.bool, device=dev)
    visited_links = (None if bvh.links is None else torch.zeros(
        bvh.links.shape[0], dtype=torch.bool, device=dev))
    tri_tests = torch.zeros_like(steps)
    box_tests = torch.zeros_like(steps)
    box_tests_to_hit = torch.zeros_like(steps)
    slot_tests = torch.zeros((bvh.rows.shape[0], WIDE_ARITY),
                             dtype=torch.int32, device=dev)
    diag = {} if return_steps and bvh.wide else None
    if return_steps:
        slot_ids, filled_tris, filled_boxes, flag = _filled_slots(bvh)
        slot_k = torch.arange(WIDE_ARITY, device=dev)
    idx = torch.arange(r, device=dev)
    cur = torch.zeros(r, dtype=torch.int64, device=dev)
    alive = torch.ones(r, dtype=torch.bool, device=dev)
    tm = tmax_eff.expand(r) if tmax_eff.dim() == 0 else tmax_eff
    n_done = 0
    while idx.numel() and n_done < max_steps:
        ob = [o[idx, a] for a in range(3)]
        db = [directions[idx, a] for a in range(3)]
        ib = [inv_d[idx, a] for a in range(3)]
        ok = okt[idx]
        af = alpha_of.subset(idx) if hasattr(alpha_of, "subset") \
            else alpha_of
        state = (cur, t_best[idx], best_tri[idx], uo[idx], vo[idx], alive)
        for _ in range(min(8, max_steps - n_done)):
            steps[idx] += state[5].to(torch.int32)
            before = state
            state = step(bvh, ok, ob, db, ib, tm[idx], state, any_hit, af,
                         diag)
            if return_steps:
                on = before[5]
                # the table row each ray read (merged: its octant's copy)
                row = before[0] + (ok * bvh.nodes if bvh.merged else 0)
                visited[row[on]] = True
                if visited_links is not None:
                    visited_links[(before[0] + ok * bvh.nodes)[on]] = True
                leaf = on & (bvh.rows[row, flag] > 0.5)
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
                # the slots tested: a leaf's filled ones up to `last`; the
                # filled children of a wide row up to the first one hit in
                # octant order; a binary internal row's box
                tested = torch.zeros((row.shape[0], WIDE_ARITY),
                                     dtype=torch.bool, device=dev)
                tested[:, :LEAF_K] = (slot_ids[row] >= 0) \
                    & (slot_k[:LEAF_K] <= last[:, None])
                if bvh.wide:
                    inner = (bvh.rows[row, _W_CHILD:_W_CHILD + WIDE_ARITY]
                             >= 0) & (diag["pos"] <= diag["first"][:, None])
                else:
                    inner = slot_k[None, :] == 0
                tested = torch.where(leaf[:, None], tested,
                                     inner & (on & ~leaf)[:, None])
                box_tests_to_hit[idx] += torch.where(
                    leaf, 0, tested.sum(1)).to(torch.int32)
                slot_tests.index_add_(0, row, tested.to(torch.int32))
            n_done += 1
        cur, tb, bt, ub, vb, alive = state
        t_best[idx], best_tri[idx], uo[idx], vo[idx] = tb, bt, ub, vb
        keep = torch.nonzero(alive).squeeze(1)
        idx, cur, alive = idx[keep], cur[keep], alive[keep]
    trunc = torch.tensor(idx.numel(), dtype=torch.int32, device=dev)
    out = _finish(t_best, best_tri, uo, vo, tmin, trunc)
    if return_steps:
        out.update(steps=steps, leaf_steps=leaf_steps, tri_tests=tri_tests,
                   box_tests=box_tests, box_tests_to_hit=box_tests_to_hit,
                   visited=visited, visited_slots=slot_tests > 0)
        if visited_links is not None:
            out["visited_links"] = visited_links
    return out


def _filled_slots(bvh: SceneBVH):
    """(slot_ids (N, 4) leaf slot tri ids, filled_tris (N, 4) filled leaf
    slots among slots 0..s, filled_boxes (N,) filled child slots of an
    internal row (1 in the binary layout), the leaf flag's lane)."""
    rows = bvh.rows
    slot_ids = torch.stack([rows[:, 10]] + [rows[:, _ID1_OFF + s]
                                            for s in range(LEAF_K - 1)],
                           1).to(torch.int32)
    filled_tris = torch.cumsum((slot_ids >= 0).to(torch.int32), 1)
    if bvh.wide:
        filled_boxes = (rows[:, _W_CHILD:_W_CHILD + WIDE_ARITY] >= 0).sum(1)
        return slot_ids, filled_tris, filled_boxes, _W_FLAG
    return (slot_ids, filled_tris,
            torch.ones(rows.shape[0], dtype=torch.int64, device=rows.device),
            12)


def _finish(t_best, best_tri, uo, vo, tmin, trunc):
    t = torch.where(best_tri >= 0, t_best + tmin,
                    torch.full_like(t_best, float("inf")))
    return dict(t=t, tri=best_tri, u=uo, v=vo, trunc=trunc)


def _need(name, t, dtype, dev, shape=None):
    if t.dtype != dtype or t.device != dev or not t.is_contiguous() \
            or (shape is not None and tuple(t.shape) != tuple(shape)):
        raise ValueError(f"{name}: need a contiguous {dtype} "
                         f"{shape or ''} tensor on {dev}")


def _k4_alpha(alpha_of, r: int, dev):
    """The K4Alpha table of a pathtrace.AlphaFilter over r rays, and the
    tensors it points into (kept alive for the launch)."""
    from .pathtrace import AlphaFilter
    if not isinstance(alpha_of, AlphaFilter):
        raise TypeError(
            "alpha_of on CUDA tensors must be a pathtrace.AlphaFilter: K4 "
            "evaluates the path tracer's opacity test inside the walk and "
            f"cannot call a Python callable ({type(alpha_of).__name__})")
    sc = alpha_of.scene
    st = sc.mat_stack
    noise = alpha_of.noise.to(torch.float32).expand(r).contiguous()
    keep = (sc.tri_vtx, sc.uvs, sc.tri_prim, sc.prim_alpha_mode,
            sc.prim_material, sc.mat_params, st.meta, st.alpha, noise)
    for name, t, dtype in zip(
            ("tri_vtx", "uvs", "tri_prim", "prim_alpha_mode",
             "prim_material", "mat_params", "mat_stack.meta",
             "mat_stack.alpha", "noise"), keep,
            (torch.int32, torch.float32, torch.int32, torch.int32,
             torch.int32, torch.float32, torch.int32, torch.int32,
             torch.float32)):
        _need(name, t, dtype, dev, (r,) if name == "noise" else None)
    table = _K4Alpha(*[ptr(t) for t in keep], sc.mat_params.shape[1],
                     st.meta.shape[0], st.alpha.shape[0],
                     sc.mat_params.shape[0])
    return table, keep


def trace_k4(bvh: SceneBVH, origins, directions, tmin=0.0, tmax=1e30,
             any_hit: bool = False, max_steps: int = MAX_STEPS,
             return_steps: bool = False, role=None, alpha_of=None):
    """K4 on CUDA tensors (csrc/bvh.cu), in the BVH's layout and, with a
    pathtrace.AlphaFilter, its alpha role; raises on anything else."""
    dev = origins.device
    r = origins.shape[0]
    _need("origins", origins, torch.float32, dev, (r, 3))
    _need("directions", directions, torch.float32, dev, (r, 3))
    _need("rows", bvh.rows, torch.float32, dev,
          (bvh.rows.shape[0], WIDE_LANES if bvh.wide else ROW_LANES))
    if bvh.links is not None:
        _need("links", bvh.links, torch.int32, dev, (8 * bvh.nodes, 2))
    table = None
    if alpha_of is not None:
        # `_` holds the tensors the table points into until the launch
        table, _ = _k4_alpha(alpha_of, r, dev)
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
        K4(ptr(bvh.rows), ptr(bvh.links), bvh.nodes, bvh.layout,
           ptr(origins), ptr(directions), ptr(tmin_ray), tmin_s,
           float(np.float32(tmax)), int(any_hit), r, max_steps, ptr(t),
           ptr(tri), ptr(u), ptr(v), ptr(steps), ptr(_k4_counters(dev)),
           ptr(trunc), None if table is None else ctypes.addressof(table),
           name=role)
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
    first accepted hit (shadow rays). alpha_of(tri, u, v) -> bool: an
    acceptance filter inside the walk (the reference's any-hit alpha
    shader, pathtracing.hlsl ahsMain); on CUDA tensors it must be a
    pathtrace.AlphaFilter, anything else raises TypeError. profile picks a
    TPU compaction schedule in the JAX package and has no effect here.
    role names the launch in K4's per-role count."""
    del profile
    origins = origins.contiguous()
    directions = directions.contiguous()
    if origins.is_cuda:
        return trace_k4(bvh, origins, directions, tmin, tmax, any_hit,
                        role=role, alpha_of=alpha_of)
    return trace_plain(bvh, origins, directions, tmin, tmax, any_hit,
                       alpha_of=alpha_of)


def occluded(bvh: SceneBVH, origins, directions, tmin=0.1, tmax=1000.0,
             alpha_of=None, role=None):
    """Boolean shadow query (ref: lighting/common.hlsli:98-116: TMin 0.1,
    TMax 1000, backface culling). alpha_of: an any-hit alpha filter."""
    return trace(bvh, origins, directions, tmin=tmin, tmax=tmax,
                 any_hit=True, alpha_of=alpha_of, role=role)["tri"] >= 0
