"""Image IO helpers: PNG output, Radiance HDR input for environment probes,
PSNR (port of incarnation_tpu/utils/imageio.py on the port's own codecs:
PNG by scene/png.py, HDR by the reader here; no PIL, no OpenCV)."""

from __future__ import annotations

import pathlib

import numpy as np

from ..scene import png


def save_png(path, img):
    """img: (H, W, 3|4) uint8 or float in [0, 1]."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    pathlib.Path(path).write_bytes(png.encode_png(img))


def load_png(path) -> np.ndarray:
    """PNG file -> (H, W, 3) uint8 RGB."""
    return png.decode_png(pathlib.Path(path).read_bytes())[..., :3]


def _rle_scanline(data: bytes, off: int, width: int):
    """One new-style run-length scanline (4 planes, each in runs: a count
    byte > 128 repeats the next byte count - 128 times, else copies count
    bytes) -> ((width, 4) uint8, offset after it)."""
    out = np.empty((4, width), np.uint8)
    for c in range(4):
        x = 0
        while x < width:
            n = data[off]
            off += 1
            if n > 128:
                n -= 128
                out[c, x:x + n] = data[off]
                off += 1
            else:
                if n == 0:
                    raise ValueError("bad HDR run: zero length")
                out[c, x:x + n] = np.frombuffer(data, np.uint8, n, off)
                off += n
            x += n
        if x != width:
            raise ValueError("bad HDR scanline: run past its end")
    return out.T, off


def load_hdr(path) -> np.ndarray:
    """Radiance .hdr (RGBE, flat or run-length scanlines, -Y H +X W
    orientation) -> (H, W, 3) float32 linear RGB (for the HDRI probe path,
    ref: src/demo.cpp:313-321 uses DirectXTex LoadFromHDRFile). Each pixel
    decodes as OpenCV's reader does: mantissa x 2^(exponent - 136), 0
    where the exponent byte is 0."""
    path = pathlib.Path(path)
    data = path.read_bytes()
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError(f"{path}: not a Radiance HDR file")
    end = data.find(b"\n\n")
    if end < 0:
        raise ValueError(f"{path}: no end of header")
    for line in data[:end].split(b"\n"):
        if line.startswith(b"FORMAT=") and line != b"FORMAT=32-bit_rle_rgbe":
            raise ValueError(f"{path}: unsupported {line.decode()}")
    nl = data.index(b"\n", end + 2)
    res = data[end + 2:nl].split()
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"{path}: unsupported orientation "
                         f"{data[end + 2:nl].decode()!r} (-Y H +X W only)")
    height, width = int(res[1]), int(res[3])
    off = nl + 1
    rgbe = np.empty((height, width, 4), np.uint8)
    for y in range(height):
        head = data[off:off + 4]
        if (8 <= width < 32768 and len(head) == 4 and head[0] == 2
                and head[1] == 2 and ((head[2] << 8) | head[3]) == width):
            rgbe[y], off = _rle_scanline(data, off + 4, width)
        else:
            rgbe[y] = np.frombuffer(data, np.uint8, 4 * width,
                                    off).reshape(width, 4)
            off += 4 * width
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(1.0, e - 136), 0.0).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * scale[..., None]


def psnr(a, b, peak=1.0) -> float:
    """PSNR in dB between two images (the parity gate, SURVEY.md §4)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(peak * peak / mse))
