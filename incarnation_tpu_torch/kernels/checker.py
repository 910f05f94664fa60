"""Checkerboard half-rate fetch (port of incarnation_tpu/kernels/checker.py).

Half the pixels fetch: in each horizontal pair of a row, the lane whose
parity is (row + parity) & 1. Each other pixel takes the mean of its two
horizontal neighbours' fetches (edge-clamped at the row's ends), a
[1/4, 1/2, 1/4] tent in x; with TAA alternating the parity every frame
the accumulation is half true fetches and half tents. The frame uses it
for the sun-shadow sample, the specular probe and the opaque layer's
material stack while the stochastic filters run.

row0 is the first row's index in the whole frame: a band of a sharded
frame takes its parity from whole-frame rows, so the bands put together
are the single frame's checkerboard.

compact and expand are the twins' (torch) form; K5 and K8 (csrc/
resolve.cu, csrc/skylight.cu) fetch the same pixels and fill the others
with the same sums in their kernels.
"""

from __future__ import annotations

import torch


def _row_parity(h: int, parity: int, extra_dims: int, device, row0: int = 0):
    """(H, 1[, 1...]) int64: which lane of each x-pair fetches."""
    rp = (torch.arange(row0, row0 + h, device=device)[:, None]
          + int(parity)) & 1
    return rp.reshape((h, 1) + (1,) * extra_dims)


def compact(parity: int, a, row0: int = 0):
    """(H, W, ...) -> (H, W/2, ...): the pixels that fetch, the lane of
    each x-pair whose parity is (row0 + row + parity) & 1."""
    h, w = a.shape[:2]
    if w % 2:
        raise ValueError("the checkerboard needs an even width")
    pairs = a.reshape((h, w // 2, 2) + tuple(a.shape[2:]))
    rp = _row_parity(h, parity, pairs.dim() - 3, a.device, row0)
    idx = rp[:, :, None].expand((h, w // 2, 1) + tuple(a.shape[2:]))
    return torch.gather(pairs, 2, idx)[:, :, 0]


def expand(parity: int, val, row0: int = 0):
    """(H, W/2, ...) fetched values -> (H, W, ...): fetched pixels keep
    their value, the others take the mean of their two horizontal fetched
    neighbours (edge-clamped at the row's ends)."""
    h, hw = val.shape[:2]
    right = torch.cat([val[:, 1:], val[:, -1:]], 1)
    left = torch.cat([val[:, :1], val[:, :-1]], 1)
    rp = _row_parity(h, parity, val.dim() - 2, val.device, row0)
    # fetched lane 0: the odd pixel 2i+1 lies between val_i and val_{i+1};
    # fetched lane 1: the even pixel 2i between val_{i-1} and val_i
    fill = torch.where(rp == 0, 0.5 * (val + right), 0.5 * (left + val))
    a = torch.where(rp == 0, val, fill)
    b = torch.where(rp == 0, fill, val)
    return torch.stack([a, b], 2).reshape((h, hw * 2) + tuple(val.shape[2:]))


def fetch_mask(shape, parity: int, device, row0: int = 0):
    """(H, W) bool: the pixels that fetch (compact's)."""
    h, w = shape
    x = torch.arange(w, device=device)[None, :]
    return (x & 1) == _row_parity(h, parity, 0, device, row0)[:, :1]
