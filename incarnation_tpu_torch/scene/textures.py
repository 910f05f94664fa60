"""Material texture stacks: host build (numpy) + device samplers (torch).

Port of incarnation_tpu/scene/textures.py for the material-stack path the
frame uses. All of a material's texture slots are interleaved into one
BC-style block-compressed table (4x4 texels in 8 u32 "core" words + 6 u32
"extras" words); see the JAX module for the word layout, which is kept
bit for bit so a stack built by either package samples identically.

Two differences from the JAX module:
- PNG decode and the resize to the stack size use scene/png.py, a numpy
  area filter (integer downscales, what cv2.INTER_AREA computes at those
  factors) and torch bilinear interpolation (upscales, what
  cv2.INTER_LINEAR computes): the port needs neither PIL nor OpenCV.
- The words are uint32 in JAX; torch's uint32 support is thin, so the
  device tables hold int32 and every right shift is followed by a mask
  (torch's >> on int32 is arithmetic).

The samplers: trilinear and 4-tap bilinear, and the stochastic
single-texel fetch of one mip (a jitter, with a dithered lod), which the
frame uses while TAA accumulates.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import mathutils as mu
from . import png

# Address modes (subset of D3D12_TEXTURE_ADDRESS_MODE the assets use)
ADDRESS_WRAP = 0
ADDRESS_CLAMP = 1
ADDRESS_MIRROR = 2

_GLTF_WRAP = {10497: ADDRESS_WRAP, 33071: ADDRESS_CLAMP, 33648: ADDRESS_MIRROR}


def _srgb_to_linear_np(c):
    c = np.clip(c, 0.0, 1.0)
    return np.where(c <= 0.04045, c / 12.92,
                    ((c + 0.055) / 1.055) ** 2.4)


def _linear_to_srgb_np(c):
    c = np.clip(c, 0.0, 1.0)
    return np.where(c <= 0.0031308, c * 12.92,
                    1.055 * c ** (1.0 / 2.4) - 0.055)



def _pow2_ceil(x: int) -> int:
    return 1 << max(0, int(np.ceil(np.log2(max(1, x)))))

_NEUTRAL_TEXEL = np.array(
    [0xFFFFFFFF, 0xFFFF8080, 0xFFFFFFFF, 0x00FFFFFF], np.uint32)

_CORE_WORDS = 8
_EXTRA_WORDS = 6

def _slot_image(gltf, tex_index, size, srgb, default):
    """Decode + linearize + resize one slot to (size, size, 4) float [0,1]."""
    if tex_index < 0:
        return np.broadcast_to(
            np.asarray(default, np.float32) / 255.0, (size, size, 4)).copy()
    tex = gltf.textures[tex_index]
    img = decode_image(gltf.image_bytes(tex.get("source", 0)))
    f = img.astype(np.float32) / 255.0
    if srgb:
        f = np.concatenate([_srgb_to_linear_np(f[..., :3]), f[..., 3:]], -1)
    return _resize_rgba_f32(f, size)


def build_material_stacks(gltf, max_dim: int = 1024,
                          min_dim: int = 4,
                          progress=None) -> dict:
    """Build the interleaved per-material texture stack from glTF materials.

    progress: optional callable(fraction) — per-material load progress
    (texture decode + mip build dominate scene load time; ref:
    inc/scene.h:131-142 progress accumulators)."""
    mats = list(gltf.materials) or [{}]
    rows = []
    erows = []
    alpha_bytes = []
    amask_rows = []
    meta = np.zeros((len(mats), 6), np.int32)
    offset = 0      # core blocks
    eoffset = 0     # extras blocks
    aoffset = 0     # alpha-mirror texels
    for mi, m in enumerate(mats):
        if progress is not None:
            progress(mi / len(mats))
        pbr = m.get("pbrMetallicRoughness", {})
        ext = m.get("extensions", {})
        tr = ext.get("KHR_materials_transmission", {}) or {}
        cc = ext.get("KHR_materials_clearcoat", {}) or {}

        def tex_id(info):
            return info["index"] if info else -1

        slots = dict(
            base=tex_id(pbr.get("baseColorTexture")),
            mr=tex_id(pbr.get("metallicRoughnessTexture")),
            normal=tex_id(m.get("normalTexture")),
            ao=tex_id(m.get("occlusionTexture")),
            emissive=tex_id(m.get("emissiveTexture")),
            transmission=tex_id(tr.get("transmissionTexture")),
            clearcoat=tex_id(cc.get("clearcoatTexture")),
        )

        # Stack resolution = largest referenced texture (capped). Size probe
        # via the PNG header, no full decode.
        size = min_dim
        for t in slots.values():
            if t >= 0:
                src = gltf.textures[t].get("source", 0)
                size = max(size, _pow2_ceil(max(
                    png.png_size(gltf.image_bytes(src)))))
        size = min(size, max_dim)

        base_f = _slot_image(gltf, slots["base"], size, True,
                             [255, 255, 255, 255])
        mr_f = _slot_image(gltf, slots["mr"], size, False,
                           [255, 255, 255, 255])
        nm_f = _slot_image(gltf, slots["normal"], size, False,
                           [128, 128, 255, 255])
        ao_f = _slot_image(gltf, slots["ao"], size, False,
                           [255, 255, 255, 255])
        em_f = _slot_image(gltf, slots["emissive"], size, True,
                           [255, 255, 255, 255])
        tr_f = _slot_image(gltf, slots["transmission"], size, False,
                           [255, 255, 255, 255])
        cc_f = _slot_image(gltf, slots["clearcoat"], size, False,
                           [255, 255, 255, 255])

        # address mode from the basecolor sampler (dominant slot)
        address = ADDRESS_WRAP
        if slots["base"] >= 0:
            address = gltf_sampler_modes(
                gltf, gltf.textures[slots["base"]])[0]

        # extras rows exist only when any of their source textures does
        has_extras = any(slots[k] >= 0
                         for k in ("emissive", "ao", "transmission",
                                   "clearcoat"))
        num_levels = int(np.log2(size)) + 1
        meta[mi] = [offset, size, num_levels, address,
                    eoffset if has_extras else -1, aoffset]

        chans = np.concatenate([
            base_f,                                    # 0-3 (linear rgb here)
            nm_f[..., 0:2], mr_f[..., 2:3], mr_f[..., 1:2],  # 4-7
            em_f[..., 0:3], ao_f[..., 0:1],            # 8-11
            tr_f[..., 0:1], cc_f[..., 0:1],            # 12-13
            np.zeros((size, size, 2), np.float32),     # 14-15 spare
        ], axis=-1)

        # von Mises-Fisher joint normal/roughness mip filtering when both
        # maps exist (ref: content-pipeline/prefilter-normal-roughness.hlsl
        # + src/scene.cpp:1157-1439): convert to r-form once at mip 0, box-
        # average r down the chain, convert back per level.
        vmf = slots["normal"] >= 0 and slots["mr"] >= 0
        cur_r = _vmf_r_form(nm_f, mr_f[..., 1]) if vmf else None

        cur = chans
        a_mips = []
        for lvl in range(num_levels):
            if vmf and lvl > 0:
                nrm, alpha = _vmf_resolve(cur_r)
                cur = cur.copy()
                cur[..., 4:6] = nrm[..., 0:2] * 0.5 + 0.5
                cur[..., 7] = alpha
            # storage space: color channels sRGB-encoded (endpoint
            # precision), everything else straight u8-scale [0, 1]
            store_core = np.concatenate(
                [_linear_to_srgb_np(cur[..., 0:3]), cur[..., 3:8]], -1)
            blk = _encode_core_blocks(store_core)
            rows.append(blk)
            offset += blk.shape[0]
            # exact (un-quantized) alpha mirror for the cutoff tests
            alpha_bytes.append(
                np.clip(cur[..., 3] * 255.0 + 0.5, 0, 255)
                .astype(np.uint32).reshape(-1))
            aoffset += alpha_bytes[-1].shape[0]
            a_mips.append(cur[..., 3].copy())
            if has_extras:
                store_ex = np.concatenate(
                    [_linear_to_srgb_np(cur[..., 8:11]), cur[..., 11:14]],
                    -1)
                eblk = _encode_extra_blocks(store_ex)
                erows.append(eblk)
                eoffset += eblk.shape[0]
            if cur.shape[0] > 1:
                cur = 0.25 * (cur[0::2, 0::2] + cur[1::2, 0::2]
                              + cur[0::2, 1::2] + cur[1::2, 1::2])
                if vmf:
                    cur_r = 0.25 * (cur_r[0::2, 0::2] + cur_r[1::2, 0::2]
                                    + cur_r[0::2, 1::2] + cur_r[1::2, 1::2])

        a_mode = {"OPAQUE": 0, "MASK": 1, "BLEND": 2}.get(
            m.get("alphaMode", "OPAQUE"), 0)
        amask_rows.append(_amask_words(
            a_mips, a_mode, m.get("alphaCutoff", 0.5),
            pbr.get("baseColorFactor", [1, 1, 1, 1])[3], address))

    flat_u32 = np.concatenate(rows, 0)
    extra_u32 = (np.concatenate(erows, 0) if erows
                 else np.zeros((1, _EXTRA_WORDS), np.uint32))
    return dict(
        flat=flat_u32.view(np.int32),
        extra=extra_u32.view(np.int32),
        meta=meta,
        alpha=_pack_alpha_bytes(np.concatenate(alpha_bytes)),
        amask=np.stack(amask_rows))


def make_material_stack(flat_u32: np.ndarray,
                        meta: np.ndarray) -> dict:
    """Construct a stack from (K, 4) uint32 texel rows + (NM, 4) meta
    (the legacy interleaved layout: w0..w3 per texel, meta columns
    [texel base, size, levels, address]) by block-encoding each
    material's mip chain. Every material gets extras blocks (the legacy
    rows always carry w2/w3); the alpha mirror keeps the legacy texel
    offsets (meta column 5 = the old texel base)."""
    flat_u32 = np.asarray(flat_u32, np.uint32)
    meta_in = np.asarray(meta)
    n = meta_in.shape[0]
    meta_out = np.zeros((n, 6), np.int32)
    rows, erows = [], []
    offset = eoffset = 0
    for mi in range(n):
        base, size, levels, address = (int(meta_in[mi, 0]),
                                       int(meta_in[mi, 1]),
                                       int(meta_in[mi, 2]),
                                       int(meta_in[mi, 3]))
        meta_out[mi] = [offset, size, levels, address, eoffset, base]
        toff = base
        for lvl in range(levels):
            s = max(size >> lvl, 1)
            w = flat_u32[toff:toff + s * s].reshape(s, s, 4)
            toff += s * s

            def u8(word, sh):
                return ((word >> sh) & 0xFF).astype(np.float32) / 255.0

            core = np.stack([u8(w[..., 0], 0), u8(w[..., 0], 8),
                             u8(w[..., 0], 16), u8(w[..., 0], 24),
                             u8(w[..., 1], 0), u8(w[..., 1], 8),
                             u8(w[..., 1], 16), u8(w[..., 1], 24)], -1)
            ex = np.stack([u8(w[..., 2], 0), u8(w[..., 2], 8),
                           u8(w[..., 2], 16), u8(w[..., 2], 24),
                           u8(w[..., 3], 0), u8(w[..., 3], 8)], -1)
            blk = _encode_core_blocks(core)
            rows.append(blk)
            offset += blk.shape[0]
            eblk = _encode_extra_blocks(ex)
            erows.append(eblk)
            eoffset += eblk.shape[0]
    return dict(
        flat=np.concatenate(rows).view(np.int32),
        extra=np.concatenate(erows).view(np.int32),
        meta=meta_out,
        alpha=_pack_alpha_bytes((flat_u32[:, 0] >> 24)),
        amask=_amask_default(meta_out))


AMASK_CELLS = 32          # cell grid per axis (cell = size/32 texels)
AMASK_LANES = 34


def _amask_words(alpha_mips, mode: int, cutoff: float, alpha_factor: float,
                 address: int) -> np.ndarray:
    """Conservative certainly-transparent cell bitplane for one material.

    alpha_mips: list of (s, s) float alpha images, mip 0 first (or [] for
    untextured). mode: 0 OPAQUE, 1 MASK, 2 BLEND. Returns (AMASK_LANES,)
    f32 row (see MaterialTextureStack.amask).

    A cell's bit is set iff NO sample the outside alpha test can draw —
    any covered mip, any bilinear tap, any cell-clamped uv jitter — can
    reach the material's lowest possible pass threshold. The margin of
    1/255 absorbs the alpha mirror's u8 quantization."""
    c = AMASK_CELLS
    reject = np.zeros((c, c), bool)
    if mode != 0:
        pad_mode = {ADDRESS_WRAP: "wrap", ADDRESS_CLAMP: "edge",
                    ADDRESS_MIRROR: "symmetric"}.get(address, "edge")

        def _dilate(x):
            cc = x.shape[0]
            pd = np.pad(x, 1, mode=pad_mode)
            return np.maximum.reduce([pd[i:i + cc, j:j + cc]
                                      for i in range(3) for j in range(3)])

        # Bounds are built on a 2x-fine grid (64x64) and max-pooled down,
        # so the effective dilation is HALF a cell — a full-cell dilation
        # plus coarse-mip pre-dilation inflated 1-2-cell foliage leaves to
        # 6+ cells, leaving only ~43% of an 84%-transparent card
        # rejectable.
        c2 = 2 * c
        mx = np.zeros((c2, c2), np.float32)
        for mi, a in enumerate(alpha_mips):
            if mi > 0 and a.shape[0] < c2:
                # Mips coarser than HALF a cell are NOT sampled by the
                # masked alpha test (masked_alpha clamps its lod to the
                # same bound) — including them would smear every cell's
                # max.
                break
            a_hi = _dilate(a)         # 1-texel pre-dilation: bilinear reach
            s = a.shape[0]
            if s >= c2:
                f = s // c2
                mx = np.maximum(
                    mx, a_hi[:f * c2, :f * c2]
                    .reshape(c2, f, c2, f).max(axis=(1, 3)))
            else:
                rep = -(-c2 // max(s, 1))
                mx = np.maximum(mx, np.repeat(np.repeat(a_hi, rep, 0),
                                              rep, 1)[:c2, :c2])
        # 1-fine-cell dilation: the half-cell-clamped stochastic uv jitter
        mx = _dilate(mx).reshape(c, 2, c, 2).max(axis=(1, 3))
        fac = max(float(alpha_factor), 1e-8)
        # lowest threshold the test can draw: MASK = cutoff; BLEND =
        # max(noise, 1e-3) >= 1e-3
        t_lo = (float(cutoff) if mode == 1 else 1e-3) / fac
        reject = mx < t_lo - 1.0 / 255.0
    cells = reject.reshape(-1).astype(np.uint32)    # cell = cv*32 + cu
    words = np.zeros(32, np.uint32)
    for k in range(32):
        words |= cells[k::32] << np.uint32(k)
    row = np.zeros(AMASK_LANES, np.int32)
    row[:32] = words.view(np.int32)
    row[32] = int(address)
    return row


def _amask_default(meta: np.ndarray) -> np.ndarray:
    """Reject-nothing amask rows (exactly the pre-classification
    behavior — every masked fragment goes through the peel ladder's alpha
    test)."""
    n = meta.shape[0]
    rows = np.zeros((n, AMASK_LANES), np.int32)
    rows[:, 32] = meta[:, 3].astype(np.int32)
    return rows


def _pack_alpha_bytes(a: np.ndarray) -> np.ndarray:
    """(K,) u8-valued uint32 alpha texels -> packed (ceil(K/16), 4) i32
    rows, 16 texels per row (4 per word)."""
    a = np.asarray(a, np.uint32)
    n = a.shape[0]
    pad = (-n) % 16
    if pad:
        a = np.concatenate([a, np.zeros(pad, np.uint32)])
    a = a.reshape(-1, 4, 4)
    words = (a[:, :, 0] | (a[:, :, 1] << 8) | (a[:, :, 2] << 16)
             | (a[:, :, 3] << 24))
    return words.view(np.int32)


# --- block encoder (load-time, numpy) --------------------------------------

_ENC_CHUNK = 1 << 16      # blocks per encode slice (bounds transient memory)


def _to_blocks(img: np.ndarray) -> np.ndarray:
    """(s, s, C) float -> (nb, 16, C) 4x4 blocks; s < 4 edge-pads to one
    block with the original texels at their own (y, x) positions (the
    decoder indexes texel (y & 3, x & 3))."""
    s = img.shape[0]
    if s < 4:
        img = np.pad(img, ((0, 4 - s), (0, 4 - s), (0, 0)), mode="edge")
        s = 4
    nb = s // 4
    c = img.shape[-1]
    return (img.reshape(nb, 4, nb, 4, c).transpose(0, 2, 1, 3, 4)
            .reshape(nb * nb, 16, c).astype(np.float32))


def _fit_line(v: np.ndarray):
    """Principal-axis endpoint fit: v (nb, 16, K) -> (e0, e1) each (nb, K).
    Power iteration on the centered block (the standard fast BC encoder
    axis); flat blocks degenerate to e0 == e1 == the constant value."""
    c = v.mean(axis=1, keepdims=True)
    d = v - c
    k = v.shape[2]
    a = np.full((v.shape[0], k), 1.0 / np.sqrt(k), np.float32)
    for _ in range(4):
        proj = np.einsum("btk,bk->bt", d, a)
        a_new = np.einsum("btk,bt->bk", d, proj)
        n = np.linalg.norm(a_new, axis=1, keepdims=True)
        a = np.where(n > 1e-12, a_new / np.maximum(n, 1e-12), a)
    t = np.einsum("btk,bk->bt", d, a)
    e0 = c[:, 0] + a * t.min(axis=1, keepdims=True)
    e1 = c[:, 0] + a * t.max(axis=1, keepdims=True)
    return np.clip(e0, 0.0, 1.0), np.clip(e1, 0.0, 1.0)


def _nearest_idx(v: np.ndarray, e0: np.ndarray, e1: np.ndarray) -> np.ndarray:
    """Per-texel nearest entry of the 4-point palette between the
    DEQUANTIZED endpoints (so index selection sees the storage error).
    v (nb, 16, K); e0/e1 (nb, K) -> (nb, 16) uint32 in 0..3."""
    w = np.asarray([0.0, 1 / 3, 2 / 3, 1.0], np.float32)
    pal = e0[:, None, :] + (e1 - e0)[:, None, :] * w[None, :, None]
    d2 = ((v[:, :, None, :] - pal[:, None, :, :]) ** 2).sum(-1)
    return d2.argmin(-1).astype(np.uint32)


def _pack_idx16(idx: np.ndarray) -> np.ndarray:
    """(nb, 16) 2-bit indices -> (nb,) uint32."""
    sh = (np.arange(16, dtype=np.uint32) * 2)[None, :]
    return np.bitwise_or.reduce(idx << sh, axis=1)


def _q8(e):
    return np.clip(e * 255.0 + 0.5, 0, 255).astype(np.uint32)


def _q565(e):
    r = np.clip(e[:, 0] * 31.0 + 0.5, 0, 31).astype(np.uint32)
    g = np.clip(e[:, 1] * 63.0 + 0.5, 0, 63).astype(np.uint32)
    b = np.clip(e[:, 2] * 31.0 + 0.5, 0, 31).astype(np.uint32)
    return r | (g << 5) | (b << 11)


def _dq565(q):
    return np.stack([(q & 31) / np.float32(31.0),
                     ((q >> 5) & 63) / np.float32(63.0),
                     ((q >> 11) & 31) / np.float32(31.0)], axis=-1)


def _enc_rgb565(v):
    """(nb, 16, 3) -> (endpoint word (nb,), index word (nb,)) — BC1-style
    shared rgb index."""
    e0, e1 = _fit_line(v)
    q0, q1 = _q565(e0), _q565(e1)
    idx = _nearest_idx(v, _dq565(q0).astype(np.float32),
                       _dq565(q1).astype(np.float32))
    return q0 | (q1 << 16), _pack_idx16(idx)


def _enc_chan(v):
    """(nb, 16, K) -> (e0q (nb, K) u8, e1q (nb, K) u8, index word (nb,)) —
    one shared 2-bit index per texel across the K channels."""
    e0, e1 = _fit_line(v)
    q0, q1 = _q8(e0), _q8(e1)
    idx = _nearest_idx(v, q0.astype(np.float32) / 255.0,
                       q1.astype(np.float32) / 255.0)
    return q0, q1, _pack_idx16(idx)


def _encode_core_blocks(store: np.ndarray) -> np.ndarray:
    """(s, s, 8) storage-space floats (sRGB base rgb, alpha, nx, ny,
    metallic, roughness) -> (nb, 8) uint32 core blocks."""
    blocks = _to_blocks(store)
    out = np.empty((blocks.shape[0], _CORE_WORDS), np.uint32)
    for i in range(0, blocks.shape[0], _ENC_CHUNK):
        v = blocks[i:i + _ENC_CHUNK]
        w0, w1 = _enc_rgb565(v[..., 0:3])
        a0, a1, w5 = _enc_chan(v[..., 3:4])
        n0, n1, w6 = _enc_chan(v[..., 4:6])
        m0, m1, w7 = _enc_chan(v[..., 6:8])
        o = out[i:i + _ENC_CHUNK]
        o[:, 0] = w0
        o[:, 1] = w1
        o[:, 2] = a0[:, 0] | (a1[:, 0] << 8) | (n0[:, 0] << 16) \
            | (n0[:, 1] << 24)
        o[:, 3] = n1[:, 0] | (n1[:, 1] << 8) | (m0[:, 0] << 16) \
            | (m0[:, 1] << 24)
        o[:, 4] = m1[:, 0] | (m1[:, 1] << 8)
        o[:, 5] = w5
        o[:, 6] = w6
        o[:, 7] = w7
    return out


def _encode_extra_blocks(store: np.ndarray) -> np.ndarray:
    """(s, s, 6) storage-space floats (sRGB emissive rgb, ao, transmission,
    clearcoat) -> (nb, 6) uint32 extras blocks."""
    blocks = _to_blocks(store)
    out = np.empty((blocks.shape[0], _EXTRA_WORDS), np.uint32)
    for i in range(0, blocks.shape[0], _ENC_CHUNK):
        v = blocks[i:i + _ENC_CHUNK]
        w0, w1 = _enc_rgb565(v[..., 0:3])
        a0, a1, w4 = _enc_chan(v[..., 3:4])
        t0, t1, w5 = _enc_chan(v[..., 4:6])
        o = out[i:i + _ENC_CHUNK]
        o[:, 0] = w0
        o[:, 1] = w1
        o[:, 2] = a0[:, 0] | (a1[:, 0] << 8) | (t0[:, 0] << 16) \
            | (t0[:, 1] << 24)
        o[:, 3] = t1[:, 0] | (t1[:, 1] << 8)
        o[:, 4] = w4
        o[:, 5] = w5
    return out


def _vmf_r_form(nm_f: np.ndarray, rough: np.ndarray) -> np.ndarray:
    """Normal map + roughness -> vMF r vectors
    (ref: prefilter-normal-roughness.hlsl:70-78)."""
    n = 2.0 * nm_f[..., :3] - 1.0
    n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-8)
    inv_lambda = 0.5 * rough * rough
    exp2l = np.exp(-2.0 / np.maximum(inv_lambda, 1e-8))
    coth = np.where(inv_lambda > 0.1, (1.0 + exp2l) / (1.0 - exp2l), 1.0)
    return (coth - inv_lambda)[..., None] * n


def _vmf_resolve(r_avg: np.ndarray):
    """Averaged r -> (unit normal, widened roughness alpha)
    (ref: prefilter-normal-roughness.hlsl:85-89)."""
    r2 = np.clip(np.sum(r_avg * r_avg, axis=-1), 1e-8, 1.0)
    inv_lambda = (1.0 / np.sqrt(r2)) * (1.0 - r2) / (3.0 - r2)
    alpha = np.sqrt(2.0 * inv_lambda)
    n = r_avg / np.maximum(np.linalg.norm(r_avg, axis=-1, keepdims=True),
                           1e-12)
    return n, np.clip(alpha, 0.0, 1.0)


def _level_offset(size, level):
    """Texel offset of mip `level` within a material's chain:
    sum_{j<l} (S>>j)^2 = (4*S^2 - 4*(S>>l)^2) / 3 (exact integer).
    Used by the (uncompressed) alpha mirror."""
    s_l = size >> level
    return (4 * size * size - 4 * s_l * s_l) // 3



def decode_image(data: bytes) -> np.ndarray:
    """Encoded PNG bytes -> (H, W, 4) uint8 RGBA."""
    return png.decode_png(data)


def _resize_axis(img: np.ndarray, axis: int, n: int) -> np.ndarray:
    m = img.shape[axis]
    if m == n:
        return img
    if m > n:
        if m % n:
            raise ValueError(
                f"texture resize {m} -> {n}: only integer downscales are "
                "supported")
        f = m // n
        shape = img.shape[:axis] + (n, f) + img.shape[axis + 1:]
        return img.reshape(shape).mean(axis=axis + 1, dtype=np.float32)
    # upscale: bilinear with half-pixel centres and edge clamp
    t = torch.from_numpy(np.ascontiguousarray(img, np.float32))
    t = t.permute(2, 0, 1)[None]
    size = [t.shape[2], t.shape[3]]
    size[axis] = n
    out = torch.nn.functional.interpolate(t, size=tuple(size),
                                          mode="bilinear",
                                          align_corners=False)
    return out[0].permute(1, 2, 0).numpy()


def _resize_rgba_f32(img: np.ndarray, size: int) -> np.ndarray:
    """Resize (H, W, 4) float to (size, size): area mean for integer
    downscales, bilinear for upscales, per axis."""
    img = img.astype(np.float32)
    return _resize_axis(_resize_axis(img, 0, size), 1, size)


def gltf_sampler_modes(gltf, texture: dict) -> tuple:
    """Map a glTF texture's sampler wrap modes to our address constants."""
    s = texture.get("sampler")
    if s is None:
        return (ADDRESS_WRAP, ADDRESS_WRAP)
    samp = gltf.samplers[s]
    return (_GLTF_WRAP.get(samp.get("wrapS", 10497), ADDRESS_WRAP),
            _GLTF_WRAP.get(samp.get("wrapT", 10497), ADDRESS_WRAP))


# ---------------------------------------------------------------------------
# Device side
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MaterialTextureStack:
    flat: torch.Tensor      # (NB, 8) int32 core 4x4 blocks
    extra: torch.Tensor     # (NBe, 6) int32 extras blocks; (1, 6) dummy
    meta: torch.Tensor      # (NM, 6) int32: core block base, size,
    #                         num_levels, address, extras block base
    #                         (-1 = none), alpha texel base
    alpha: torch.Tensor     # (ceil(K/16), 4) int32 alpha mirror, 4 texels
    #                         per word (exact u8 alpha for the cutoff tests)
    amask: torch.Tensor     # (NM, 34) int32 certainly-transparent 32x32
    #                         cell bitplane (lanes 0..31) + address (32)


def material_stack(arrays: dict, device) -> MaterialTextureStack:
    """Numpy stack arrays (build_material_stacks / make_material_stack, or
    a JAX stack's arrays) -> device MaterialTextureStack."""
    def dev(name):
        return torch.tensor(np.asarray(arrays[name]), dtype=torch.int32,
                            device=device)
    return MaterialTextureStack(flat=dev("flat"), extra=dev("extra"),
                                meta=dev("meta"), alpha=dev("alpha"),
                                amask=dev("amask"))


def srgb_to_linear(c):
    c = torch.clamp(c, 0.0, 1.0)
    return torch.where(c <= 0.04045, c / 12.92,
                       torch.pow((c + 0.055) / 1.055, 2.4))


def linear_to_srgb(c):
    c = torch.clamp(c, 0.0, 1.0)
    return torch.where(c <= 0.0031308, c * 12.92,
                       1.055 * torch.pow(c, 1.0 / 2.4) - 0.055)


def _address(coord, n, mode):
    """Address mode on int texel coordinates (coord, n, mode int tensors)."""
    wrapped = torch.remainder(coord, n)
    clamped = torch.minimum(torch.clamp(coord, min=0), n - 1)
    period = torch.remainder(coord, 2 * n)
    mirrored = torch.where(period < n, period, 2 * n - 1 - period)
    return torch.where(mode == ADDRESS_WRAP, wrapped,
                       torch.where(mode == ADDRESS_CLAMP, clamped, mirrored))


def _level_offset_blocks(size, levels, level):
    """Block offset of mip `level` within a material's chain."""
    s4 = torch.clamp(size >> 2, min=1)
    l4max = torch.clamp(levels - 3, min=0)
    lc = torch.minimum(level, l4max)
    sl4 = torch.clamp(s4 >> lc, min=1)
    return ((4 * s4 * s4 - 4 * sl4 * sl4) // 3
            + torch.clamp(level - l4max, min=0))


def _unpack_u8(word, shift):
    return ((word >> shift) & 0xFF).to(torch.float32) * (1.0 / 255.0)


def _dec565(c):
    return torch.stack([(c & 31).to(torch.float32) * (1.0 / 31.0),
                        ((c >> 5) & 63).to(torch.float32) * (1.0 / 63.0),
                        ((c >> 11) & 31).to(torch.float32) * (1.0 / 31.0)],
                       dim=-1)


def _dec565_pair(word):
    return _dec565(word & 0xFFFF), _dec565((word >> 16) & 0xFFFF)


def _fetch_texel(stack: MaterialTextureStack, base, ebase, x, y, s):
    """Decode core + extras channels (..., 16) of texel (x, y) of the mip
    whose block table starts at `base` with size `s` (storage space)."""
    s4 = torch.clamp(s >> 2, min=1)
    brel = (y >> 2) * s4 + (x >> 2)
    sh = (((y & 3) << 2) | (x & 3)) << 1

    def fsel(word):
        return ((word >> sh) & 3).to(torch.float32) * (1.0 / 3.0)

    w = mu.gather_rows(stack.flat, base + brel)           # (..., 8)
    c0, c1 = _dec565_pair(w[..., 0])
    fb = fsel(w[..., 1])[..., None]
    base_rgb = c0 + (c1 - c0) * fb
    a0 = _unpack_u8(w[..., 2], 0)
    a1 = _unpack_u8(w[..., 2], 8)
    n0 = torch.stack([_unpack_u8(w[..., 2], 16),
                      _unpack_u8(w[..., 2], 24)], -1)
    n1 = torch.stack([_unpack_u8(w[..., 3], 0),
                      _unpack_u8(w[..., 3], 8)], -1)
    m0 = torch.stack([_unpack_u8(w[..., 3], 16),
                      _unpack_u8(w[..., 3], 24)], -1)
    m1 = torch.stack([_unpack_u8(w[..., 4], 0),
                      _unpack_u8(w[..., 4], 8)], -1)
    fa = fsel(w[..., 5])
    fn = fsel(w[..., 6])[..., None]
    fm = fsel(w[..., 7])[..., None]
    core = torch.cat([
        base_rgb, (a0 + (a1 - a0) * fa)[..., None],
        n0 + (n1 - n0) * fn, m0 + (m1 - m0) * fm], dim=-1)   # (..., 8)
    if stack.extra.shape[0] <= 1:
        return torch.cat([core, torch.ones_like(core)], dim=-1)
    ew = mu.gather_rows(stack.extra, torch.clamp(ebase, min=0) + brel)
    e0, e1 = _dec565_pair(ew[..., 0])
    fe = fsel(ew[..., 1])[..., None]
    em_rgb = e0 + (e1 - e0) * fe
    ao0 = _unpack_u8(ew[..., 2], 0)
    ao1 = _unpack_u8(ew[..., 2], 8)
    t0 = torch.stack([_unpack_u8(ew[..., 2], 16),
                      _unpack_u8(ew[..., 2], 24)], -1)
    t1 = torch.stack([_unpack_u8(ew[..., 3], 0),
                      _unpack_u8(ew[..., 3], 8)], -1)
    fao = fsel(ew[..., 4])
    ftc = fsel(ew[..., 5])[..., None]
    ex = torch.cat([
        em_rgb, (ao0 + (ao1 - ao0) * fao)[..., None],
        t0 + (t1 - t0) * ftc,
        torch.zeros(core.shape[:-1] + (2,), dtype=core.dtype,
                    device=core.device)], dim=-1)
    ex = torch.where((ebase >= 0)[..., None], ex, 1.0)
    return torch.cat([core, ex], dim=-1)                 # (..., 16)


def _stack_bilinear(stack, base, ebase, s, uv, address):
    """One-level bilinear fetch of the full channel set (storage space)."""
    sf = s.to(torch.float32)
    fx = uv[..., 0] * sf - 0.5
    fy = uv[..., 1] * sf - 0.5
    x0 = torch.floor(fx).to(torch.int32)
    y0 = torch.floor(fy).to(torch.int32)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]
    xs = [_address(x0, s, address), _address(x0 + 1, s, address)]
    ys = [_address(y0, s, address), _address(y0 + 1, s, address)]

    def fetch(x, y):
        return _fetch_texel(stack, base, ebase, x, y, s)

    top = fetch(xs[0], ys[0]) * (1 - tx) + fetch(xs[1], ys[0]) * tx
    bot = fetch(xs[0], ys[1]) * (1 - tx) + fetch(xs[1], ys[1]) * tx
    return top * (1 - ty) + bot * ty


def _stack_point(stack, base, ebase, s, uv, address, jitter):
    """Stochastic-bilinear point fetch: texel floor(u s - 0.5 + j) picks
    the bilinear footprint's x0 + 1 with exactly the bilinear weight, so
    the expectation over the jitter j (uniforms in [0, 1)) is the bilinear
    result. The TAA accumulation (raster frame) and the path tracer's
    progressive one integrate it."""
    sf = s.to(torch.float32)
    fx = uv[..., 0] * sf - 0.5 + jitter[..., 0]
    fy = uv[..., 1] * sf - 0.5 + jitter[..., 1]
    x = _address(torch.floor(fx).to(torch.int32), s, address)
    y = _address(torch.floor(fy).to(torch.int32), s, address)
    return _fetch_texel(stack, base, ebase, x, y, s)


def stack_meta_lookup(stack: MaterialTextureStack, mat_id):
    """stack.meta[max(mat_id, 0)] -> (..., 6) int32."""
    return mu.gather_rows(stack.meta, mat_id)


def sample_material_stack(stack: MaterialTextureStack, mat_id, uv, lod=None,
                          trilinear: bool = True, jitter=None):
    """All material texture slots at once: mat_id (...,) int32, uv (..., 2),
    lod (...,) float mip or None. Returns (..., 16) channels in storage
    space (base/emissive rgb still sRGB; see decode_stack_channels).
    jitter: (..., 2) uniforms for a one-texel stochastic-bilinear fetch of
    mip floor(lod) (mip 0 where lod is None); pair it with a dithered
    integer lod and an accumulation."""
    meta = stack_meta_lookup(stack, mat_id)
    base = meta[..., 0]
    size = meta[..., 1]
    levels = meta[..., 2]
    address = meta[..., 3]
    ebase = meta[..., 4]

    def elevel(off):
        return torch.where(ebase >= 0, ebase + off, -1)

    if lod is None:
        if jitter is not None:
            return _stack_point(stack, base, ebase, size, uv, address,
                                jitter)
        return _stack_bilinear(stack, base, ebase, size, uv, address)
    lod = torch.minimum(torch.clamp(lod, min=0.0),
                        (levels - 1).to(torch.float32))
    l0 = torch.floor(lod).to(torch.int32)
    off0 = _level_offset_blocks(size, levels, l0)
    s0 = torch.clamp(size >> l0, min=1)
    if jitter is not None:
        return _stack_point(stack, base + off0, elevel(off0), s0, uv,
                            address, jitter)
    out0 = _stack_bilinear(stack, base + off0, elevel(off0), s0, uv, address)
    if not trilinear:
        return out0
    l1 = torch.minimum(l0 + 1, levels - 1)
    off1 = _level_offset_blocks(size, levels, l1)
    s1 = torch.clamp(size >> l1, min=1)
    out1 = _stack_bilinear(stack, base + off1, elevel(off1), s1, uv, address)
    frac = (lod - l0)[..., None]
    return out0 * (1 - frac) + out1 * frac


def sample_stack_alpha(stack: MaterialTextureStack, mat_id, uv, lod=None,
                       jitter=None):
    """Base-color alpha only, bilinear from the exact u8 alpha mirror;
    jitter: (..., 2) uniforms for the one-texel stochastic-bilinear fetch
    (_stack_point's texel)."""
    meta = stack_meta_lookup(stack, mat_id)
    base = meta[..., 5]          # alpha mirror keeps TEXEL offsets
    size = meta[..., 1]
    levels = meta[..., 2]
    address = meta[..., 3]
    if lod is None:
        b0, s0 = base, size
    else:
        lod = torch.minimum(torch.clamp(lod, min=0.0),
                            (levels - 1).to(torch.float32))
        l0 = torch.floor(lod).to(torch.int32)
        b0 = base + _level_offset(size, l0)
        s0 = torch.clamp(size >> l0, min=1)

    def fetch(x, y):
        idx = b0 + y * s0 + x
        row = mu.gather_rows(stack.alpha, idx >> 4)       # (..., 4)
        word = torch.gather(row, -1, ((idx >> 2) & 3)[..., None].long())
        return _unpack_u8(word[..., 0], (idx & 3) * 8)

    sf = s0.to(torch.float32)
    if jitter is not None:
        fx = uv[..., 0] * sf - 0.5 + jitter[..., 0]
        fy = uv[..., 1] * sf - 0.5 + jitter[..., 1]
        return fetch(_address(torch.floor(fx).to(torch.int32), s0, address),
                     _address(torch.floor(fy).to(torch.int32), s0, address))
    fx = uv[..., 0] * sf - 0.5
    fy = uv[..., 1] * sf - 0.5
    x0 = torch.floor(fx).to(torch.int32)
    y0 = torch.floor(fy).to(torch.int32)
    tx = fx - x0
    ty = fy - y0
    xs = [_address(x0, s0, address), _address(x0 + 1, s0, address)]
    ys = [_address(y0, s0, address), _address(y0 + 1, s0, address)]
    top = fetch(xs[0], ys[0]) * (1 - tx) + fetch(xs[1], ys[0]) * tx
    bot = fetch(xs[0], ys[1]) * (1 - tx) + fetch(xs[1], ys[1]) * tx
    return top * (1 - ty) + bot * ty


def decode_stack_channels(c):
    """(..., 16) storage channels -> dict of linear material inputs."""
    return dict(
        base_rgb=srgb_to_linear(c[..., 0:3]),
        opacity=c[..., 3],
        normal_xy=c[..., 4:6] * 2.0 - 1.0,
        metallic=c[..., 6],
        roughness=c[..., 7],
        emissive_rgb=srgb_to_linear(c[..., 8:11]),
        ao=c[..., 11],
        transmission=c[..., 12],
        clearcoat=c[..., 13],
    )
