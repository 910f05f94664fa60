"""Image-based lighting: split-sum precompute + environment probes (port of
incarnation_tpu/kernels/ibl.py).

Cube mips are one flat (total, 3) texel table per chain. The JAX package
samples the probes it builds through quad-packed rows whose +x/+y
neighbour is taken from the CLAMPED texel; CubeMips.packed keeps that
addressing (it differs from clamp(x0 + 1) at a face's first texel) so both
packages fetch the same texels. Such a probe's jittered one-texel fetch
(the stochastic filters) reads its shared-exponent RGBE copy
(CubeMips.rgbe_table, built once from flat as the JAX package's
rgbe_encode builds it), not the f32 texel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import mathutils as mu
from ..device import resolve_device
from . import shading


def hammersley(n: int) -> np.ndarray:
    """(n, 2) Hammersley points (radical inverse base 2)."""
    i = np.arange(n, dtype=np.uint32)
    bits = i.copy()
    bits = ((bits << 16) | (bits >> 16)) & 0xFFFFFFFF
    bits = ((bits & 0x55555555) << 1) | ((bits & 0xAAAAAAAA) >> 1)
    bits = ((bits & 0x33333333) << 2) | ((bits & 0xCCCCCCCC) >> 2)
    bits = ((bits & 0x0F0F0F0F) << 4) | ((bits & 0xF0F0F0F0) >> 4)
    bits = ((bits & 0x00FF00FF) << 8) | ((bits & 0xFF00FF00) >> 8)
    return np.stack([i / n, bits / 2 ** 32], axis=-1).astype(np.float32)


def sample_ggx(xi, roughness):
    """GGX half-vector sample in tangent space (z-up); xi (..., 2)."""
    a = roughness * roughness
    phi = 2.0 * mu.PI * xi[..., 0]
    cos_t = torch.sqrt((1.0 - xi[..., 1])
                       / (1.0 + (a * a - 1.0) * xi[..., 1]))
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    return torch.stack([sin_t * torch.sin(phi), sin_t * torch.cos(phi),
                        cos_t], dim=-1)


def tangent_to_world(n):
    """Tangent basis (T, B) for normals n (..., 3)."""
    z = torch.tensor([0.0, 0.0, 1.0], device=n.device)
    x = torch.tensor([1.0, 0.0, 0.0], device=n.device)
    up = torch.where(torch.abs(n[..., 2:3]) < 0.999, z, x)
    t = mu.normalize(torch.cross(up.expand_as(n), n, dim=-1))
    return t, torch.cross(n, t, dim=-1)


# ---------------------------------------------------------------------------
# Env BRDF LUT (split-sum second term)
# ---------------------------------------------------------------------------

def env_brdf_lut(size: int = 512, num_samples: int = 1024, device=None):
    """(size, size, 2) A/B terms; the y axis stores 1 - roughness."""
    device = resolve_device(device)
    xs = torch.arange(size, dtype=torch.float32, device=device)
    no_v = (xs / size)[None, :].expand(size, size)
    roughness = (1.0 - xs / size)[:, None].expand(size, size)
    v = torch.stack([torch.sqrt(torch.clamp(1.0 - no_v * no_v, min=0.0)),
                     torch.zeros_like(no_v), no_v], dim=-1)
    xi = torch.as_tensor(hammersley(num_samples), device=device)
    acc = torch.zeros((size, size, 2), dtype=torch.float32, device=device)
    for i in range(num_samples):
        h = sample_ggx(xi[i], roughness)
        l = mu.normalize(2.0 * torch.sum(v * h, -1, keepdim=True) * h - v)
        no_l = torch.clamp(l[..., 2], 0.0, 1.0)
        no_h = torch.clamp(h[..., 2], 0.0, 1.0)
        vo_h = torch.clamp(torch.sum(v * h, -1), 0.0, 1.0)
        g = shading.g_smith_ibl(no_v, no_l, roughness)
        g_vis = g * vo_h / torch.clamp(no_h * no_v, min=1e-6)
        fc = mu.ipow(1.0 - vo_h, 5)
        ok = (no_l > 0.0) & (no_v > 0.0)
        a = torch.where(ok, (1.0 - fc) * g_vis, 0.0)
        b = torch.where(ok, fc * g_vis, 0.0)
        acc = acc + torch.stack([a, b], dim=-1)
    return acc / num_samples


def quad_pack_image(img):
    """(H, W, C) -> (H*W, 4C): each row holds the texel and its clamped
    +x / +y / +xy neighbours."""
    xp = torch.cat([img[:, 1:], img[:, -1:]], dim=1)
    yp = torch.cat([img[1:], img[-1:]], dim=0)
    xyp = torch.cat([yp[:, 1:], yp[:, -1:]], dim=1)
    return torch.cat([img, xp, yp, xyp], dim=-1).reshape(
        -1, 4 * img.shape[-1])


def pack_env_brdf(lut):
    """(S, S, 2) env-BRDF LUT -> (S*S, 8) quad-packed rows."""
    return quad_pack_image(lut)


def env_brdf_approx(no_v, roughness):
    """Analytic split-sum env-BRDF (A, B): 16x16 Chebyshev tensor fit of
    NoV*A / NoV*B divided back by NoV (ibl_fit_coeffs.py).

    Each step of the Chebyshev recurrence, T_k = (2 t) T_{k-1} - T_{k-2},
    and each multiply-add of the tensor sums rounds once (mu.fma), as
    XLA's CPU build fuses them in the JAX package's jitted frame and K8
    (csrc/skylight.cu) issues them as FFMAs: row i's g starts at
    c_i0 T_0(v), then g = fma(c_ij, T_j(v), g) for j = 1..15; the sum
    starts at T_0(u) g_0, then out = fma(T_i(u), g_i, out). Every other
    operation rounds on its own. The fit is ill-conditioned in f32 (an
    ulp of T_i(u) moves A by about 1e-2), so K8 fuses exactly these
    steps."""
    from . import ibl_fit_coeffs as _fc
    nov = torch.clamp(no_v, 0.0, 1.0)
    r = torch.clamp(roughness, 0.0, 1.0)

    def cheb(t, n=16):
        # f64 copies of the f32 values, for mu.fma
        t2 = (2.0 * t).double()
        ts = [torch.ones_like(t), t]
        for _ in range(n - 2):
            ts.append(mu.fma(t2, ts[-1], -ts[-2]))
        return ts, [x.double() for x in ts]

    def eval_tensor(coeffs, tu, tv):
        (tu, tu64), (tv, tv64) = tu, tv
        out = None
        for i, row in enumerate(np.asarray(coeffs, np.float32).tolist()):
            g = row[0] * tv[0]
            for j in range(1, len(row)):
                g = mu.fma(row[j], tv64[j], g)
            out = tu[0] * g if i == 0 else mu.fma(tu64[i], g, out)
        return out

    tu = cheb(2.0 * torch.pow(torch.clamp(nov, min=1e-8), 0.25) - 1.0)
    an = eval_tensor(_fc.CHEB_A, tu, cheb(2.0 * r - 1.0))
    bn = eval_tensor(_fc.CHEB_B, tu, cheb(2.0 * torch.sqrt(r) - 1.0))
    inv = 1.0 / torch.clamp(nov, min=1.0 / 256.0)
    return torch.stack([an * inv, bn * inv], dim=-1)


def sample_env_brdf(lut, no_v, roughness):
    """Bilinear LUT fetch at uv = (NoV, roughness); lut (S, S, 2) raw or
    (S*S, 8) quad-packed."""
    packed = lut.dim() == 2
    size = int(round(np.sqrt(lut.shape[0]))) if packed else lut.shape[0]
    fx = torch.clamp(no_v, 0.0, 1.0) * size - 0.5
    fy = torch.clamp(roughness, 0.0, 1.0) * size - 0.5
    x0 = torch.clamp(torch.floor(fx).to(torch.int64), 0, size - 1)
    y0 = torch.clamp(torch.floor(fy).to(torch.int64), 0, size - 1)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]
    if packed:
        rows = lut[y0 * size + x0]
        top = rows[..., 0:2] * (1 - tx) + rows[..., 2:4] * tx
        bot = rows[..., 4:6] * (1 - tx) + rows[..., 6:8] * tx
        return top * (1 - ty) + bot * ty
    x1 = torch.clamp(x0 + 1, max=size - 1)
    y1 = torch.clamp(y0 + 1, max=size - 1)
    flat = lut.reshape(-1, 2)
    top = flat[y0 * size + x0] * (1 - tx) + flat[y0 * size + x1] * tx
    bot = flat[y1 * size + x0] * (1 - tx) + flat[y1 * size + x1] * tx
    return top * (1 - ty) + bot * ty


# ---------------------------------------------------------------------------
# Cubemap: direction <-> face/uv (reference orientation)
# ---------------------------------------------------------------------------

def get_env_dir(face: int, uv):
    vx = 2.0 * uv[..., 0] - 1.0
    vy = -2.0 * uv[..., 1] + 1.0
    one = torch.ones_like(vx)
    d = [
        lambda: torch.stack([one, vy, -vx], -1),
        lambda: torch.stack([-one, vy, vx], -1),
        lambda: torch.stack([vx, one, -vy], -1),
        lambda: torch.stack([vx, -one, vy], -1),
        lambda: torch.stack([vx, vy, one], -1),
        lambda: torch.stack([-vx, vy, -one], -1),
    ][face]()
    return mu.normalize(d)


def dir_to_face_uv(d):
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    ax, ay, az = torch.abs(x), torch.abs(y), torch.abs(z)
    is_x = (ax >= ay) & (ax >= az)
    is_y = (~is_x) & (ay >= az)
    face = torch.where(is_x, torch.where(x >= 0, 0, 1),
                       torch.where(is_y, torch.where(y >= 0, 2, 3),
                                   torch.where(z >= 0, 4, 5)))
    s = torch.where(is_x, ax, torch.where(is_y, ay, az))
    s = torch.clamp(s, min=1e-12)
    vx = torch.where(face == 0, -z / s,
         torch.where(face == 1, z / s,
         torch.where(face == 2, x / s,
         torch.where(face == 3, x / s,
         torch.where(face == 4, x / s, -x / s)))))
    vy = torch.where(face == 2, -z / s,
                     torch.where(face == 3, z / s, y / s))
    return face, torch.stack([(vx + 1.0) * 0.5, (1.0 - vy) * 0.5], dim=-1)


@dataclasses.dataclass
class CubeMips:
    """Mip chain of (6, S_l, S_l, 3) cube faces, flattened (total, 3).
    packed: bilinear neighbours come from the clamped texel, as the JAX
    package's quad-packed probe tables (with_packed) address them."""
    flat: torch.Tensor
    size: int
    num_levels: int
    bases: tuple
    packed: bool = False
    # the u32 RGBE table of a packed cube, built at its first jittered
    # fetch (rgbe_table)
    rgbe: torch.Tensor = dataclasses.field(default=None, repr=False,
                                           compare=False)

    def rgbe_table(self):
        """(total,) int32 RGBE words of flat (rgbe_encode), built once."""
        if self.rgbe is None:
            self.rgbe = rgbe_encode(self.flat)
        return self.rgbe

    @staticmethod
    def from_levels(levels, packed: bool = False):
        size = levels[0].shape[1]
        bases, chunks, off = [], [], 0
        for lv in levels:
            bases.append(off)
            c = lv.reshape(-1, 3)
            chunks.append(c)
            off += c.shape[0]
        return CubeMips(flat=torch.cat(chunks, 0), size=size,
                        num_levels=len(levels), bases=tuple(bases),
                        packed=packed)


def rgbe_encode(rgb):
    """(..., 3) f32 -> (...,) int32 words of u32 shared-exponent RGBE
    (Ward), as the JAX package's rgbe_encode: 8-bit mantissas round(c
    2^-e 256) of the exponent e = floor(log2(max channel)) + 1, and e +
    128 in the top byte; -128 (a zero word's exponent) where the max is at
    most 1e-32. log2 is jnp.log2's log(m) / log(2) in f32, which lands
    just below the integer at many powers of two (8192 -> 12.999999):
    there e is one less and the largest mantissa clips at 255, as in the
    JAX package's tables."""
    m = torch.amax(rgb, dim=-1)
    log2 = torch.log(torch.clamp(m, min=1e-32)) / torch.log(
        torch.tensor(2.0, device=rgb.device))
    e = torch.where(m > 1e-32, torch.floor(log2) + 1.0, -128.0)
    scale = torch.exp2(-e)[..., None] * 256.0
    # a max at most 1e-32 scales by 2^128 = inf, and a zero channel by
    # inf is NaN, whose mantissa is 0 (as JAX's cast makes it)
    mant = torch.clamp(torch.nan_to_num(torch.round(rgb * scale), nan=0.0),
                       0, 255).to(torch.int64)
    e8 = torch.clamp(e + 128.0, 0, 255).to(torch.int64)
    word = mant[..., 0] | (mant[..., 1] << 8) | (mant[..., 2] << 16) \
        | (e8 << 24)
    return (word - ((word >> 31) << 32)).to(torch.int32)


def rgbe_decode(word):
    """(...,) RGBE words (int32 or int64) -> (..., 3) f32: mantissa x
    2^(e - 136), the power of two built from its bits (exact; the JAX
    package's exp2 of an integer is exact too)."""
    w = word.to(torch.int64) & 0xFFFFFFFF
    p = ((w >> 24) & 0xFF) - 136                     # in [-136, 119]
    bits = torch.where(p >= -126, (p + 127) << 23, 1 << (p + 149).clamp(0))
    scale = bits.to(torch.int32).view(torch.float32)
    return torch.stack([(w & 0xFF).to(torch.float32),
                        ((w >> 8) & 0xFF).to(torch.float32),
                        ((w >> 16) & 0xFF).to(torch.float32)],
                       dim=-1) * scale[..., None]


def _sample_cube_level(cube: CubeMips, base, s, d, jitter=None):
    """Bilinear sample of one cube level at directions d (clamped at face
    edges). base/s: ints or (...,) int64 tensors. jitter: (..., 2)
    uniforms for the one-texel stochastic-bilinear fetch of a packed
    cube's RGBE table (ibl.py _sample_cube_level); an unpacked cube
    ignores it, as the JAX package's cubes without the packed tables
    do."""
    face, uv = dir_to_face_uv(d)
    sf = s.to(torch.float32) if torch.is_tensor(s) else float(s)
    fx = uv[..., 0] * sf - 0.5
    fy = uv[..., 1] * sf - 0.5
    hi = s - 1
    if jitter is not None and cube.packed:
        def clip(c):
            c = torch.clamp(c, min=0)
            return torch.minimum(c, hi) if torch.is_tensor(hi) else \
                torch.clamp(c, max=hi)
        x = clip(torch.floor(fx + jitter[..., 0]).to(torch.int64))
        y = clip(torch.floor(fy + jitter[..., 1]).to(torch.int64))
        return rgbe_decode(cube.rgbe_table()[base + (face * s + y) * s + x])
    x0 = torch.floor(fx).to(torch.int64)
    y0 = torch.floor(fy).to(torch.int64)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]
    x0c = torch.clamp(x0, min=0)
    x0c = torch.minimum(x0c, hi) if torch.is_tensor(hi) else \
        torch.clamp(x0c, max=hi)
    y0c = torch.clamp(y0, min=0)
    y0c = torch.minimum(y0c, hi) if torch.is_tensor(hi) else \
        torch.clamp(y0c, max=hi)
    if cube.packed:
        x1c, y1c = x0c + 1, y0c + 1
    else:
        x1c, y1c = torch.clamp(x0 + 1, min=0), torch.clamp(y0 + 1, min=0)
    x1c = torch.minimum(x1c, hi) if torch.is_tensor(hi) else \
        torch.clamp(x1c, max=hi)
    y1c = torch.minimum(y1c, hi) if torch.is_tensor(hi) else \
        torch.clamp(y1c, max=hi)

    def fetch(x, y):
        return cube.flat[base + (face * s + y) * s + x]

    top = fetch(x0c, y0c) * (1 - tx) + fetch(x1c, y0c) * tx
    bot = fetch(x0c, y1c) * (1 - tx) + fetch(x1c, y1c) * tx
    return top * (1 - ty) + bot * ty


def sample_cube(cube: CubeMips, d, lod=None, single_mip: bool = False,
                jitter=None):
    """Trilinear cube sample at float mip `lod` (None = level 0).
    single_mip: only level floor(lod) (pair with a dithered lod and an
    accumulation); jitter: (..., 2) uniforms, the one-texel fetch of that
    level (see _sample_cube_level)."""
    if lod is None:
        return _sample_cube_level(cube, cube.bases[0], cube.size, d,
                                  jitter)
    dev = d.device
    bases = torch.as_tensor(np.asarray(cube.bases, np.int64), device=dev)
    sizes = torch.as_tensor(np.asarray(
        [cube.size >> l for l in range(cube.num_levels)], np.int64),
        device=dev)
    lod = torch.clamp(lod, 0.0, cube.num_levels - 1.0)
    l0 = torch.floor(lod).to(torch.int64)
    s0 = _sample_cube_level(cube, bases[l0], sizes[l0], d, jitter)
    if single_mip:
        return s0
    l1 = torch.clamp(l0 + 1, max=cube.num_levels - 1)
    frac = (lod - l0)[..., None]
    s1 = _sample_cube_level(cube, bases[l1], sizes[l1], d)
    return s0 * (1 - frac) + s1 * frac


# ---------------------------------------------------------------------------
# Lat-long -> cubemap, GGX prefilter, SH9
# ---------------------------------------------------------------------------

def _latlong_mips(latlong, num_levels):
    mips = [latlong]
    cur = latlong
    for _ in range(num_levels - 1):
        h, w = cur.shape[:2]
        if h > 1 and w > 1:
            cur = 0.25 * (cur[0::2, 0::2] + cur[1::2, 0::2]
                          + cur[0::2, 1::2] + cur[1::2, 1::2])
        mips.append(cur)
    return mips


def _sample_latlong_bilinear(img, uv):
    h, w = img.shape[:2]
    fx = uv[..., 0] * w - 0.5
    fy = torch.clamp(uv[..., 1] * h - 0.5, 0.0, h - 1.0)
    x0 = torch.floor(fx).to(torch.int64)
    y0 = torch.floor(fy).to(torch.int64)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]
    x0w = torch.remainder(x0, w)
    x1w = torch.remainder(x0 + 1, w)
    y0c = torch.clamp(y0, 0, h - 1)
    y1c = torch.clamp(y0 + 1, 0, h - 1)
    flat = img.reshape(-1, img.shape[-1])
    top = flat[y0c * w + x0w] * (1 - tx) + flat[y0c * w + x1w] * tx
    bot = flat[y1c * w + x0w] * (1 - tx) + flat[y1c * w + x1w] * tx
    return top * (1 - ty) + bot * ty


def _face_uv(s: int, device):
    xs = (torch.arange(s, dtype=torch.float32, device=device) + 0.5) / s
    return torch.stack(torch.meshgrid(xs, xs, indexing="xy"), -1)


def latlong_to_cubemap(latlong, size: int) -> CubeMips:
    """Full cube mip chain; each cube mip samples the matching lat-long
    mip."""
    num_levels = int(np.log2(size)) + 1
    ll_mips = _latlong_mips(latlong, num_levels)
    levels = []
    for l in range(num_levels):
        uv = _face_uv(size >> l, latlong.device)
        faces = [_sample_latlong_bilinear(
            ll_mips[l], mu.direction_to_latlong_uv(get_env_dir(f, uv)))
            for f in range(6)]
        levels.append(torch.stack(faces, 0))
    return CubeMips.from_levels(levels)


def prefilter_cubemap(source: CubeMips, out_size: int,
                      num_samples: int = 1024,
                      batch_elems: int = 1 << 23) -> CubeMips:
    """GGX-prefiltered radiance cube; mip l has roughness l/(numMips-1).
    Samples are taken in batches (the sum order differs from the JAX
    package's one-sample loop by float rounding only)."""
    num_levels = int(np.log2(out_size)) + 1
    dev = source.flat.device
    xi_all = torch.as_tensor(hammersley(num_samples), device=dev)
    resolution = float(source.size)
    sa_texel = 4.0 * mu.PI / (6.0 * resolution * resolution)
    levels = []
    for l in range(num_levels):
        s = out_size >> l
        roughness = l / max(num_levels - 1, 1)
        uv = _face_uv(s, dev)
        n = torch.stack([get_env_dir(f, uv) for f in range(6)], 0)
        if roughness == 0.0:
            levels.append(_sample_cube_level(source, source.bases[0],
                                             source.size, n))
            continue
        t, b = tangent_to_world(n)
        color = torch.zeros((6, s, s, 3), dtype=torch.float32, device=dev)
        weight = torch.zeros((6, s, s), dtype=torch.float32, device=dev)
        step = max(1, batch_elems // (6 * s * s))
        for i0 in range(0, num_samples, step):
            xi = xi_all[i0:i0 + step][:, None, None, None, :]
            h_t = sample_ggx(xi, roughness)                # (B, 1, 1, 1, 3)
            h = h_t[..., 0:1] * t + h_t[..., 1:2] * b + h_t[..., 2:3] * n
            v = n
            l_dir = mu.normalize(
                2.0 * torch.sum(v * h, -1, keepdim=True) * h - v)
            no_l = torch.clamp(torch.sum(n * l_dir, -1), 0.0, 1.0)
            no_h = torch.clamp(torch.sum(n * h, -1), min=0.0)
            vo_h = torch.clamp(torch.sum(v * h, -1), min=0.0)
            d = shading.ggx_distribution(no_h, roughness)
            pdf = d * no_h / (4.0 * torch.clamp(vo_h, min=1e-6)) + 1e-4
            sa_sample = 1.0 / (num_samples * pdf + 1e-4)
            mip = torch.clamp(0.5 * torch.log2(sa_sample / sa_texel),
                              min=0.0)
            c = sample_cube(source, l_dir, lod=mip)
            color = color + (c * no_l[..., None]).sum(0)
            weight = weight + no_l.sum(0)
        levels.append(color / torch.clamp(weight, min=1e-6)[..., None])
    return CubeMips.from_levels(levels)


_SH_K = np.array([0.282095, 0.488603, 0.488603, 0.488603, 1.092548,
                  1.092548, 0.315392, 1.092548, 0.546274], np.float32)
_SH_A = np.array([np.pi, 2.094395, 0.785398], np.float32)


def sh_basis(d):
    """SH9 basis values at unit directions (..., 3) -> (..., 9)."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    k = [float(v) for v in _SH_K]
    return torch.stack([
        torch.full_like(x, k[0]),
        k[1] * y, k[2] * z, k[3] * x,
        k[4] * x * y, k[5] * y * z,
        k[6] * (3.0 * z * z - 1.0),
        k[7] * x * z, k[8] * (x * x - y * y),
    ], dim=-1)


def sh_project_latlong(latlong):
    """Integrate a lat-long radiance map onto SH9: (9, 3)."""
    h, w = latlong.shape[:2]
    dev = latlong.device
    us = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
    vs = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
    uv = torch.stack(torch.meshgrid(us, vs, indexing="xy"), -1)
    d = mu.latlong_uv_to_direction(uv)
    basis = sh_basis(d)
    sin_t = torch.sin(uv[..., 1] * mu.PI)
    w_solid = sin_t * (mu.PI / h) * (2.0 * mu.PI / w)
    return torch.einsum("hwc,hwk,hw->kc", latlong[..., :3], basis, w_solid)


def sh_irradiance(n, sh_coeffs):
    """Cosine-convolved irradiance at normals n (..., 3) from (9, 3) SH:
    the basis times the band weights, then per channel one chain of
    multiply-adds from zero over the nine terms, each rounded once
    (mu.fma), as K8 (csrc/skylight.cu) computes it. (A matmul's order over
    the nine terms is its library's own: cuBLAS on the card left K8 a few
    ulps from the twin on most pixels of some inputs.)"""
    a = torch.as_tensor(np.concatenate(
        [[_SH_A[0]], [_SH_A[1]] * 3, [_SH_A[2]] * 5]).astype(np.float32),
        device=n.device)
    b = sh_basis(n) * a
    acc = torch.zeros(b.shape[:-1] + (3,), dtype=torch.float32,
                      device=n.device)
    for k in range(9):
        acc = mu.fma(b[..., k:k + 1], sh_coeffs[k], acc)
    return acc


@dataclasses.dataclass
class EnvironmentProbe:
    envmap: CubeMips        # full-res radiance cube
    prefiltered: CubeMips   # GGX prefiltered, half res, mip = roughness
    sh: torch.Tensor        # (9, 3) radiance SH


def build_probe(latlong, envmap_size: int = 256,
                num_samples: int = 1024) -> EnvironmentProbe:
    """lat-long radiance -> probe: cube at envmap_size, prefilter at half
    res, SH from the lat-long. The probe's cubes sample with the packed
    (clamped-neighbour) addressing of the JAX probe."""
    envmap = latlong_to_cubemap(latlong, envmap_size)
    pref = prefilter_cubemap(envmap, envmap_size // 2,
                             num_samples=num_samples)
    sh = sh_project_latlong(latlong)
    return EnvironmentProbe(
        envmap=dataclasses.replace(envmap, packed=True),
        prefiltered=dataclasses.replace(pref, packed=True), sh=sh)


def probe_arrays(probe: EnvironmentProbe) -> dict:
    """Probe -> flat dict (the keys probe_from_arrays reads)."""
    out = {"sh": probe.sh}
    for name in ("envmap", "prefiltered"):
        c = getattr(probe, name)
        out.update({f"{name}.flat": c.flat, f"{name}.size": c.size,
                    f"{name}.num_levels": c.num_levels,
                    f"{name}.bases": c.bases, f"{name}.packed": c.packed})
    return out


def probe_from_arrays(arrays: dict, device) -> EnvironmentProbe:
    """EnvironmentProbe from numpy arrays: "sh", and per cube ("envmap",
    "prefiltered") ".flat", ".size", ".num_levels", ".bases" and
    ".packed" (True when the source probe sampled through quad-packed
    rows, as a JAX build_probe probe does)."""
    device = resolve_device(device)

    def cube(name):
        return CubeMips(
            flat=torch.tensor(np.asarray(arrays[f"{name}.flat"]),
                              dtype=torch.float32, device=device),
            size=int(arrays[f"{name}.size"]),
            num_levels=int(arrays[f"{name}.num_levels"]),
            bases=tuple(int(b) for b in arrays[f"{name}.bases"]),
            packed=bool(arrays[f"{name}.packed"]))

    return EnvironmentProbe(
        envmap=cube("envmap"), prefiltered=cube("prefiltered"),
        sh=torch.tensor(np.asarray(arrays["sh"]), dtype=torch.float32,
                        device=device))
