"""Core math: transforms, projection, encodings (PyTorch port of
incarnation_tpu/core/mathutils.py).

Conventions are the reference renderer's:
- Left-handed, y-up world space; glTF content gets the root transform
  diag(1, 1, -1).
- Row-vector convention: ``p' = [p, 1] @ M``.
- Reverse-Z infinite-far perspective: depth 1 at the near plane, -> 0 at
  infinity; the depth buffer clears to 0.
- Octahedral normal encoding for the normal gbuffer.
- Visibility ids ``prim << 20 | tri`` (clear value 0xFFFFF000).

Host-side matrix helpers work on numpy; per-pixel helpers on torch tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch

PI = float(np.pi)
INV_PI = float(1.0 / np.pi)

PRIM_TRIANGLE_BIT_COUNT = 20
VIS_CLEAR_UINT = 0xFFFFF000
VIS_CLEAR_INT32 = int(np.uint32(VIS_CLEAR_UINT).view(np.int32))


# ---------------------------------------------------------------------------
# Visibility id packing. int32 tensors; torch's >> on int32 is arithmetic,
# so decoding masks after the shift to get the logical-shift result.
# ---------------------------------------------------------------------------

def encode_primitive_visibility(primitive_id, triangle_id):
    return (primitive_id << PRIM_TRIANGLE_BIT_COUNT) | triangle_id


def decode_primitive_visibility(data):
    """-> (primitive_id, triangle_id), logical-shift semantics."""
    prim = (data >> PRIM_TRIANGLE_BIT_COUNT) & (
        (1 << (32 - PRIM_TRIANGLE_BIT_COUNT)) - 1)
    tri = data & ((1 << PRIM_TRIANGLE_BIT_COUNT) - 1)
    return prim, tri


# ---------------------------------------------------------------------------
# Octahedral normal encoding
# ---------------------------------------------------------------------------

def oct_encode(n):
    """Unit normal (..., 3) -> (..., 2) in [0, 1]."""
    n = n / torch.sum(torch.abs(n), dim=-1, keepdim=True)
    nxy = n[..., :2]
    sgn = torch.where(nxy >= 0.0, 1.0, -1.0)
    wrapped = (1.0 - torch.abs(nxy.flip(-1))) * sgn
    nxy = torch.where(n[..., 2:3] >= 0.0, nxy, wrapped)
    return nxy * 0.5 + 0.5


def oct_decode(f):
    """(..., 2) in [0, 1] -> unit normal (..., 3)."""
    f = f * 2.0 - 1.0
    nz = 1.0 - torch.abs(f[..., 0]) - torch.abs(f[..., 1])
    t = torch.clamp(-nz, 0.0, 1.0)[..., None]
    nxy = f + torch.where(f >= 0.0, -t, t)
    n = torch.cat([nxy, nz[..., None]], dim=-1)
    return n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)


# ---------------------------------------------------------------------------
# Projection / view matrices (host, numpy, row-vector convention)
# ---------------------------------------------------------------------------

def perspective_reverse_z_infinite(fov_y: float, aspect: float, near: float):
    """Reverse-Z infinite-far LH perspective: ndc z = near / z_view."""
    t = 1.0 / np.tan(0.5 * fov_y)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = t / aspect
    m[1, 1] = t
    m[2, 3] = 1.0
    m[3, 2] = near
    return m


def view_matrix(position, right, up, look):
    """World->view for an orthonormal LH camera basis."""
    position = np.asarray(position, np.float32)
    right = np.asarray(right, np.float32)
    up = np.asarray(up, np.float32)
    look = np.asarray(look, np.float32)
    m = np.eye(4, dtype=np.float32)
    m[0, :3] = [right[0], up[0], look[0]]
    m[1, :3] = [right[1], up[1], look[1]]
    m[2, :3] = [right[2], up[2], look[2]]
    m[3, 0] = -float(position @ right)
    m[3, 1] = -float(position @ up)
    m[3, 2] = -float(position @ look)
    return m


def orthonormalize_basis(look, right):
    """Re-orthonormalize an LH camera basis from look and right hints."""
    look = np.asarray(look, np.float64)
    right = np.asarray(right, np.float64)
    look = look / np.linalg.norm(look)
    up = np.cross(look, right)
    up = up / np.linalg.norm(up)
    right = np.cross(up, look)
    return (right.astype(np.float32), up.astype(np.float32),
            look.astype(np.float32))


def quaternion_to_matrix(q):
    """glTF quaternion [x, y, z, w] -> 4x4 rotation (row-vector)."""
    x, y, z, w = [float(v) for v in q]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = np.eye(4, dtype=np.float32)
    m[0, :3] = [1 - 2 * (yy + zz), 2 * (xy + wz), 2 * (xz - wy)]
    m[1, :3] = [2 * (xy - wz), 1 - 2 * (xx + zz), 2 * (yz + wx)]
    m[2, :3] = [2 * (xz + wy), 2 * (yz - wx), 1 - 2 * (xx + yy)]
    return m


def trs_matrix(translation=None, rotation=None, scale=None):
    """scale * rotation * translation (row-vector order)."""
    m = np.eye(4, dtype=np.float32)
    if scale is not None:
        s = np.eye(4, dtype=np.float32)
        s[0, 0], s[1, 1], s[2, 2] = scale
        m = m @ s
    if rotation is not None:
        m = m @ quaternion_to_matrix(rotation)
    if translation is not None:
        t = np.eye(4, dtype=np.float32)
        t[3, :3] = translation
        m = m @ t
    return m


RH_TO_LH = np.diag([1.0, 1.0, -1.0, 1.0]).astype(np.float32)


# ---------------------------------------------------------------------------
# Per-pixel helpers (torch)
# ---------------------------------------------------------------------------

def dot3(a, b, keepdim: bool = False):
    """Dot product over the last axis of (..., 3) tensors, summed left to
    right, (x + y) + z, as the CUDA kernels sum it: torch.sum reduces a
    row of three on the card in another order, an ulp apart, which the
    GGX lobe's NoH amplifies to 1e-4 of a pixel's radiance."""
    p = a * b
    s = p[..., 0] + p[..., 1] + p[..., 2]
    return s[..., None] if keepdim else s


def normalize(v, eps=1e-20):
    """(..., 3) vectors scaled to unit length."""
    return v * (1.0 / torch.sqrt(dot3(v, v, keepdim=True) + eps))


def cross3(u, v):
    """Cross product of (..., 3) tensors, each component one product
    minus another, every operation rounded on its own (torch.cross on the
    card may fuse them)."""
    return torch.stack([u[..., 1] * v[..., 2] - u[..., 2] * v[..., 1],
                        u[..., 2] * v[..., 0] - u[..., 0] * v[..., 2],
                        u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0]], -1)


def rows_mat(v, m):
    """v @ m for (..., K) rows v and a (K, N) matrix m, each entry's sum
    left to right over k with every multiply and add rounded on its own:
    the same bits on the CPU and on the card, where a matmul's order is
    its library's own."""
    out = v[..., 0:1] * m[0]
    for k in range(1, m.shape[0]):
        out = out + v[..., k:k + 1] * m[k]
    return out


def ipow(x, n: int):
    """x ** n for a small positive integer n by repeated squaring, the
    multiplications XLA's integer_pow makes (torch's pow rounds otherwise,
    and 1 - q**4 at a light's range edge or (1 - u)**5 amplify the ulp)."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n:
            x = x * x
    return acc


def fma(a, b, c):
    """f32 a * b + c rounded once to nearest even, as a fused multiply-add
    does it (__fmaf_rn in csrc/bvh.cu and csrc/skylight.cu; XLA's CPU
    build fuses such products so). a and b are f32 tensors, or f64
    tensors or Python floats that hold f32 values (a caller may pass a
    tensor's f64 copy once instead of converting it on every call); c is
    an f32 tensor. The f64 product p of two f32 values is exact; the f64
    sum s = p + c rounds, and TwoSum gives its exact error e. Casting s to
    f32 rounds a * b + c correctly, except where s lies exactly halfway
    between two f32 values and e is not 0: the exact sum then lies on e's
    side of that midpoint and rounds to the neighbour there (the plain
    cast would round s a second time, to even). Exact for sums below the
    f32 overflow threshold."""
    p = (a.double() if torch.is_tensor(a) else float(a)) * b.double()
    cd = c.double()
    s = p + cd
    bv = s - p
    e = (p - (s - bv)) + (cd - bv)
    f = s.float()
    fd = f.double()
    g = torch.nextafter(f, torch.where(fd < s, math.inf, -math.inf))
    tie = ((fd + g.double()) * 0.5 == s) & ((e > 0) | (e < 0))
    side = torch.where(e > 0, torch.maximum(f, g), torch.minimum(f, g))
    return torch.where(tie, side, f)


def pixel_centers(height: int, width: int, device):
    """(xs, ys) f32 (H, W) pixel-center coordinates (x + 0.5, y + 0.5)."""
    xs = torch.arange(width, dtype=torch.float32, device=device) + 0.5
    ys = torch.arange(height, dtype=torch.float32, device=device) + 0.5
    return (xs[None, :].expand(height, width),
            ys[:, None].expand(height, width))


def gather_rows(table, idx):
    """table[idx] for an (N, C) table and an integer index tensor, with the
    index clamped into [0, N) as JAX gathers clamp (torch indexing would
    raise). The C words of each row are gathered one by one from the
    flattened table: torch's row gather of 16- and 32-byte rows
    (vectorized_gather_kernel) is several times slower on an H100
    (PERF.md)."""
    cols = table.shape[1]
    i = torch.clamp(idx, 0, table.shape[0] - 1).long()[..., None] * cols
    return table.reshape(-1)[i + torch.arange(cols, device=idx.device)]


# ---------------------------------------------------------------------------
# Halton jitter (ref: renderer.cpp:126-132 uses Halton(2,3) jitter)
# ---------------------------------------------------------------------------

def halton(index: int, base: int) -> float:
    f, r = 1.0, 0.0
    i = index
    while i > 0:
        f = f / base
        r = r + f * (i % base)
        i = i // base
    return r


def halton_jitter_table(n: int = 16) -> np.ndarray:
    """n x 2 sub-pixel jitter offsets in [-0.5, 0.5) from Halton(2, 3)."""
    return np.array(
        [[halton(i + 1, 2) - 0.5, halton(i + 1, 3) - 0.5] for i in range(n)],
        dtype=np.float32)


# ---------------------------------------------------------------------------
# Spherical <-> cartesian (LH y-up)
# ---------------------------------------------------------------------------

def latlong_uv_to_direction(uv):
    """Equirectangular uv in [0,1]^2 -> unit direction, LH y-up."""
    phi = (uv[..., 0] * 2.0 - 1.0) * PI
    theta = uv[..., 1] * PI
    sin_t = torch.sin(theta)
    return torch.stack(
        [sin_t * torch.sin(phi), torch.cos(theta), sin_t * torch.cos(phi)],
        dim=-1)


def direction_to_latlong_uv(d):
    phi = torch.atan2(d[..., 0], d[..., 2])
    theta = torch.arccos(torch.clamp(d[..., 1], -1.0, 1.0))
    return torch.stack([(phi / PI) * 0.5 + 0.5, theta / PI], dim=-1)
