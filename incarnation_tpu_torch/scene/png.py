"""PNG codec on the standard library's zlib.

The JAX package decodes textures with PIL and writes the atrium's PNGs with
PIL; the machines the port runs on need not have PIL, so the port carries
its own codec for what the content uses: 8-bit greyscale, grey+alpha, RGB
and RGBA, non-interlaced, with all five scanline filter types (a PNG that
PIL wrote earlier may use any of them).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels (0 grey, 2 RGB, 4 grey+alpha, 6 RGBA)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunks(data: bytes):
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    off = 8
    while off + 8 <= len(data):
        length, kind = struct.unpack_from(">I4s", data, off)
        yield kind, data[off + 8:off + 8 + length]
        off += 12 + length
        if kind == b"IEND":
            return


def png_size(data: bytes) -> tuple:
    """(width, height) from the IHDR chunk, without decoding pixels."""
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            return struct.unpack_from(">II", body, 0)
    raise ValueError("PNG without IHDR")


def _paeth_row(raw: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    out = bytearray(raw.tobytes())
    up = prev.tobytes()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = up[i]
        c = up[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def _average_row(raw: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    out = bytearray(raw.tobytes())
    up = prev.tobytes()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        out[i] = (out[i] + ((a + up[i]) >> 1)) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def _sub_row(raw: np.ndarray, bpp: int) -> np.ndarray:
    # running sum per channel, modulo 256
    return np.cumsum(raw.reshape(-1, bpp), axis=0,
                     dtype=np.uint8).reshape(-1)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 4) uint8 RGBA."""
    header = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack_from(">IIBBBBB", body, 0)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    width, height, depth, ctype, _comp, _filt, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"unsupported PNG: bit depth {depth}, colour type {ctype}, "
            f"interlace {interlace} (8-bit grey/RGB/RGBA, non-interlaced "
            "only)")
    ch = _CHANNELS[ctype]
    stride = width * ch
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw[:height * (stride + 1)].reshape(height, stride + 1)
    img = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        f, row = raw[y, 0], raw[y, 1:]
        if f == 0:
            cur = row
        elif f == 1:
            cur = _sub_row(row, ch)
        elif f == 2:
            cur = row + prev            # uint8 wraps modulo 256
        elif f == 3:
            cur = _average_row(row, prev, ch)
        elif f == 4:
            cur = _paeth_row(row, prev, ch)
        else:
            raise ValueError(f"bad PNG filter type {f}")
        img[y] = cur
        prev = img[y]
    img = img.reshape(height, width, ch)
    if ch == 4:
        return img
    out = np.full((height, width, 4), 255, np.uint8)
    if ch == 3:
        out[..., :3] = img
    elif ch == 1:
        out[..., :3] = img
    else:
        out[..., :3] = img[..., :1]
        out[..., 3] = img[..., 1]
    return out


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(rgba: np.ndarray, level: int = 3) -> bytes:
    """(H, W, 4) uint8 RGBA or (H, W, 3) RGB -> PNG bytes (filter type 0
    on every row)."""
    rgba = np.ascontiguousarray(rgba, np.uint8)
    h, w, c = rgba.shape
    if c not in (3, 4):
        raise ValueError("encode_png takes (H, W, 4) RGBA or (H, W, 3) RGB "
                         "uint8")
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           rgba.reshape(h, w * c)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6 if c == 4 else 2, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _chunk(b"IEND", b""))
