#!/usr/bin/env python3
"""How the main path's triangles fall into the binning's tiers, and how
their pairs spread over K10's blocks, on the host.

    python3 tools/torch_bin_tiers.py

It builds the atrium on the CPU (chip_smoke.atrium_path with
device="cpu"), renders one frame of the main path (the camera and the
sun pass; frame constants of frame 3, no history) with the binning's twin,
and prints for each binning: valid triangles, small, mid (and the mids that
fit mid_tri_capacity), big, the pairs; the pairs of each block of
raster.K10_TRIS triangles (max and mean), and the fitted mids per block
(the most in one block, and the blocks that hold any). Counts only: no
time is taken.
"""

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from incarnation_tpu_torch.kernels import raster  # noqa: E402


def tiers(prep, p):
    """Per-triangle pair counts by the binning's rules, and the tiers."""
    b = prep.bbox.long()
    v = prep.valid
    tx0, ty0 = b[:, 0] // p.tile_w, b[:, 1] // p.tile_h
    span = (b[:, 2] // p.tile_w - tx0 + 1) * (b[:, 3] // p.tile_h - ty0 + 1)
    small = v & (span <= p.bin_max_span)
    mid = v & (span > p.bin_max_span) & (span <= p.bin_mid_span)
    fit = mid & (torch.cumsum(mid.long(), 0) - 1 < p.mid_tri_capacity)
    big = v & ~small & ~fit
    n = torch.where(small | fit, span, 0) + big.long()
    return n, dict(valid=v, small=small, mid=mid, fit=fit, big=big)


def main() -> int:
    torch.cuda.synchronize = lambda *a: None    # atrium_path syncs a card
    path = cs.atrium_path(torch.device("cpu"))
    captured = []
    twin = raster.bin_triangles_layered

    def record(prep, params, layer=None, n_layers=1):
        captured.append((prep, params))
        return twin(prep, params, layer=layer, n_layers=n_layers)

    raster.bin_triangles_layered = record
    try:
        path.run(path.make_fc(3, None), torch.zeros((cs.H, cs.W, 3)))
    finally:
        raster.bin_triangles_layered = twin
    for prep, p in captured:
        n, t = tiers(prep, p)
        nb = -(-n.shape[0] // raster.K10_TRIS)
        pad = torch.zeros(nb * raster.K10_TRIS, dtype=torch.long)
        pad[:n.shape[0]] = n
        per_block = pad.view(nb, -1).sum(1)
        fit_blocks = torch.nonzero(t["fit"]).flatten() // raster.K10_TRIS
        print(f"{'sun, depth-only' if p.depth_only else 'camera'}: "
              + ", ".join(f"{k} {int(x.sum())}" for k, x in t.items())
              + f", pairs {int(n.sum())}; pairs per block max "
              f"{int(per_block.max())}, mean {float(per_block.float().mean()):.1f}"
              f" over {nb} blocks; fitted mids: most in one block "
              f"{int(torch.bincount(fit_blocks).max()) if fit_blocks.numel() else 0}"
              f", blocks {sorted(set(fit_blocks.tolist()))}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
