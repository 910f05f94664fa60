"""Image comparison harness: PSNR gates against reference captures (port of
incarnation_tpu/app/compare.py on the port's PNG decoder).

The parity story (SURVEY.md §4): render a config with this framework, compare
against a captured image from the D3D12 reference (or a prior golden of this
renderer) and report PSNR. Usage:

  python -m incarnation_tpu_torch.app.compare a.png b.png [--min-psnr 40]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..utils import imageio as io_mod


def compare(path_a, path_b) -> float:
    a = io_mod.load_png(path_a).astype(np.float32) / 255.0
    b = io_mod.load_png(path_b).astype(np.float32) / 255.0
    if a.shape != b.shape:
        raise SystemExit(f"size mismatch: {a.shape} vs {b.shape}")
    return io_mod.psnr(a, b)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("image_a")
    ap.add_argument("image_b")
    ap.add_argument("--min-psnr", type=float, default=None)
    args = ap.parse_args(argv)
    value = compare(args.image_a, args.image_b)
    print(f"PSNR: {value:.2f} dB")
    if args.min_psnr is not None and value < args.min_psnr:
        print(f"FAIL: below gate {args.min_psnr} dB")
        sys.exit(1)


if __name__ == "__main__":
    main()
