"""Temporal anti-aliasing resolve (port of incarnation_tpu/kernels/taa.py).

Depth-based reprojection through m = inv_view_proj @ prev_view_proj, an
exact bilinear history fetch, 3x3 neighbourhood clamp and a
luminance-weighted 0.1 / 0.9 blend. The fetch is K3 (csrc/taa.cu) on CUDA
tensors and its twin (reproject_uv + bilinear_image) on CPU ones. When the
camera is static and only the jitter moved, m is a pure NDC translation and
the fetch is one constant sub-pixel shift; that choice is made on the host
from the numpy matrices, with no device sync.

A band of a band-sharded frame (dist/sharding.py) resolves with halos
copied from its neighbours: history rows above and below its viewport, so a
reprojection across the seam reads the neighbour's history, and one row of
the current HDR each way for the 3x3 clamp (JAX taa.py:272-290, :363-371).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .build import Kernel, ptr

_P, _I = ctypes.c_void_p, ctypes.c_int
# history, depth, m, out, width, height, y_off
K3 = Kernel("taa", "k3_taa_fetch", [_P, _P, _P, _P, _I, _I, _I])


def reproject_uv(depth, m, width: int, height: int):
    """(H, W, 2) previous-frame uv of each pixel centre (taa.py:140-149).
    m: (4, 4) tensor, inv_view_proj @ prev_view_proj."""
    dev = depth.device
    xs = (torch.arange(width, device=dev).to(torch.float32) + 0.5)[None, :]
    ys = (torch.arange(height, device=dev).to(torch.float32) + 0.5)[:, None]
    # divide by tensors: torch's CUDA division by a Python number multiplies
    # by its reciprocal, an ulp away from K3's division
    nx = 2.0 * xs / torch.full_like(xs, width) - 1.0
    ny = -2.0 * ys / torch.full_like(ys, height) + 1.0
    z = depth
    cx = nx * m[0, 0] + ny * m[1, 0] + z * m[2, 0] + m[3, 0]
    cy = nx * m[0, 1] + ny * m[1, 1] + z * m[2, 1] + m[3, 1]
    cw = nx * m[0, 3] + ny * m[1, 3] + z * m[2, 3] + m[3, 3]
    inv_w = torch.where(torch.abs(cw) > 1e-20, 1.0 / cw, 0.0)
    return torch.stack([0.5 * cx * inv_w + 0.5, -0.5 * cy * inv_w + 0.5],
                       dim=-1)


def bilinear_image(img, uv, width: int, height: int, y_off: int = 0):
    """Bilinear sample of (H, W, C) at uv in [0,1]^2 with edge clamp (the
    JAX _bilinear_image). The floor is kept in [-1, size] before the int
    conversion, as K3 does. y_off: img carries y_off halo rows above and
    below the (height, width) viewport, which rows address before they
    clamp."""
    fx = uv[..., 0] * width - 0.5
    fy = uv[..., 1] * height - 0.5
    x0f = torch.clamp(torch.floor(fx), -1.0, float(width))
    y0f = torch.clamp(torch.floor(fy), -1.0 - y_off, float(height + y_off))
    x0 = x0f.to(torch.int64)
    y0 = y0f.to(torch.int64)
    tx = (fx - x0f)[..., None]
    ty = (fy - y0f)[..., None]
    x0c = torch.clamp(x0, 0, width - 1)
    x1c = torch.clamp(x0 + 1, 0, width - 1)
    y0c = torch.clamp(y0, -y_off, height - 1 + y_off) + y_off
    y1c = torch.clamp(y0 + 1, -y_off, height - 1 + y_off) + y_off
    flat = img.reshape(-1, img.shape[-1])
    top = flat[y0c * width + x0c] * (1 - tx) + flat[y0c * width + x1c] * tx
    bot = flat[y1c * width + x0c] * (1 - tx) + flat[y1c * width + x1c] * tx
    return top * (1 - ty) + bot * ty


def history_fetch(history, depth, m, width: int, height: int,
                  y_off: int = 0):
    """Reprojected bilinear history fetch (H, W, 3): K3 on CUDA tensors,
    the twin on CPU ones. history: (H + 2 y_off, W, 3), y_off halo rows
    above and below the viewport."""
    if not depth.is_cuda:
        return history_fetch_plain(history, depth, m, width, height, y_off)
    dev = depth.device
    for name, t, shape in (("history", history,
                            (height + 2 * y_off, width, 3)),
                           ("depth", depth, (height, width)),
                           ("m", m, (4, 4))):
        if t.dtype != torch.float32 or t.device != dev \
                or not t.is_contiguous() or tuple(t.shape) != shape:
            raise ValueError(f"{name}: need a contiguous float32 {shape} "
                             f"tensor on {dev}")
    out = torch.empty((height, width, 3), dtype=torch.float32, device=dev)
    K3(ptr(history), ptr(depth), ptr(m), ptr(out), width, height, y_off)
    return out


def history_fetch_plain(history, depth, m, width: int, height: int,
                        y_off: int = 0):
    return bilinear_image(history, reproject_uv(depth, m, width, height),
                          width, height, y_off)


def bilinear_const_shift(img, sx: float, sy: float, y_off: int = 0):
    """Bilinear fetch at pixel + (sx, sy), a constant sub-pixel shift with
    edge clamp (|sx|, |sy| <= 3; the static-camera reprojection). img
    carries y_off halo rows above and below the viewport."""
    h, w = img.shape[0] - 2 * y_off, img.shape[1]
    ix = int(np.floor(sx))
    iy = int(np.floor(sy))
    tx = float(np.float32(sx) - np.float32(ix))
    ty = float(np.float32(sy) - np.float32(iy))
    pad = 4
    padded = torch.nn.functional.pad(
        img.permute(2, 0, 1)[None], (pad, pad, pad, pad),
        mode="replicate")[0].permute(1, 2, 0)

    def g(dy, dx):
        y0 = pad + y_off + iy + dy
        x0 = pad + ix + dx
        return padded[y0:y0 + h, x0:x0 + w]

    top = g(0, 0) * (1 - tx) + g(0, 1) * tx
    bot = g(1, 0) * (1 - tx) + g(1, 1) * tx
    return top * (1 - ty) + bot * ty


def static_shift(m_np: np.ndarray, width: int, height: int):
    """(sx, sy) pixel shift when m is a pure NDC translation of at most 3
    pixels (a static camera with only jitter moving), else None
    (taa.py:309-327, evaluated on the host)."""
    mn = m_np / m_np[3, 3]
    is_shift = (abs(mn[0, 0] - 1.0) < 1e-6 and abs(mn[1, 1] - 1.0) < 1e-6
                and abs(mn[0, 1]) < 1e-6 and abs(mn[1, 0]) < 1e-6
                and abs(mn[2, 0]) < 1e-5 and abs(mn[2, 1]) < 1e-5
                and abs(mn[0, 3]) < 1e-7 and abs(mn[1, 3]) < 1e-7
                and abs(mn[2, 3]) < 1e-5)
    sx = float(0.5 * mn[3, 0] * width)
    sy = float(-0.5 * mn[3, 1] * height)
    if is_shift and abs(sx) <= 3.0 and abs(sy) <= 3.0:
        return sx, sy
    return None


def _neighborhood_minmax(img, hdr_halo=None):
    """3x3 min/max with edge clamp; hdr_halo: the (1, W, C) rows above and
    below img (a band's neighbours), which take the place of the clamp."""
    if hdr_halo is not None:
        img_h = torch.cat([hdr_halo[0], img, hdr_halo[1]], 0)
        padded = torch.nn.functional.pad(img_h.permute(2, 0, 1)[None],
                                         (1, 1, 0, 0), mode="replicate")[0]
    else:
        padded = torch.nn.functional.pad(img.permute(2, 0, 1)[None],
                                         (1, 1, 1, 1), mode="replicate")[0]
    padded = padded.permute(1, 2, 0)
    h, w = img.shape[:2]
    mins = img
    maxs = img
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            s = padded[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
            mins = torch.minimum(mins, s)
            maxs = torch.maximum(maxs, s)
    return mins, maxs


def _luminance_weight(c):
    lum = c[..., 0] * 0.299 + c[..., 1] * 0.587 + c[..., 2] * 0.114
    return (1.0 / (1.0 + lum))[..., None]


def taa_resolve(current_hdr, history, depth, m_np: np.ndarray,
                history_valid: bool, width: int, height: int,
                hdr_halo=None):
    """-> new accumulation (H, W, 3). m_np: host (4, 4) f32
    inv_view_proj @ prev_view_proj. history_valid False passes the current
    frame through (frame 0) without fetching. A band of a sharded frame
    passes its history with y_off halo rows above and below (history
    (H + 2 y_off, W, 3)) and hdr_halo, the (1, W, 3) current-HDR rows just
    above and below the band."""
    if not history_valid:
        return current_hdr
    y_off = (history.shape[0] - height) // 2
    shift = static_shift(m_np, width, height)
    if shift is not None:
        prev_color = bilinear_const_shift(history, *shift, y_off=y_off)
    else:
        m = torch.as_tensor(m_np, dtype=torch.float32, device=depth.device)
        prev_color = history_fetch(history.contiguous(), depth.contiguous(),
                                   m, width, height, y_off)
    mins, maxs = _neighborhood_minmax(current_hdr, hdr_halo)
    clamped = torch.minimum(torch.maximum(prev_color, mins), maxs)
    w_cur = 0.1 * _luminance_weight(current_hdr)
    w_prev = 0.9 * _luminance_weight(clamped)
    return (current_hdr * w_cur + clamped * w_prev) / (w_cur + w_prev)
