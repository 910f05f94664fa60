"""Sampling primitives (port of incarnation_tpu/kernels/sampling.py; ref:
shaders/common/uniform-sampling.hlsli): correlated multi-jittered sampling
[Kensler 2013], concentric disk mapping and cosine hemisphere sampling.

The CMJ hashes are uint32 arithmetic, bit-identical to the JAX package's.
torch's uint32 lacks shifts, remainders and comparisons, so the values are
carried in int64, reduced modulo 2^32 after every step, and products take
their low 32 bits from two 16-bit halves of one factor (each partial
product stays below 2^48, far from int64 overflow).
"""

from __future__ import annotations

import math

import torch

from ..core import mathutils as mu

_M32 = 0xFFFFFFFF


def _u32(x, device=None):
    """int64 tensor holding x modulo 2^32."""
    if not torch.is_tensor(x):
        x = torch.tensor(x, dtype=torch.int64, device=device)
    return x.to(torch.int64) & _M32


def _mul32(a, b):
    """(a * b) mod 2^32 for uint32 values a (tensor) and b (tensor or
    int)."""
    b_lo = b & 0xFFFF
    b_hi = b >> 16
    return (a * b_lo + (((a * b_hi) & 0xFFFF) << 16)) & _M32


def cmj_rand_float(i, p):
    """(ref: uniform-sampling.hlsli CMJ_RandFloat)."""
    i = _u32(i)
    p = _u32(p, i.device)
    i = i ^ p
    i = i ^ (i >> 17)
    i = i ^ (i >> 10)
    i = _mul32(i, 0xb36534e5)
    i = i ^ (i >> 12)
    i = i ^ (i >> 21)
    i = _mul32(i, 0x93fc4795)
    i = i ^ 0xdf6e307f
    i = i ^ (i >> 17)
    i = _mul32(i, 1 | (p >> 18))
    return i.to(torch.float32) * (1.0 / 4294967808.0)


def _permute_round(i, p, w: int):
    i = i ^ p
    i = _mul32(i, 0xe170893d)
    i = i ^ (p >> 16)
    i = i ^ ((i & w) >> 4)
    i = i ^ (p >> 8)
    i = _mul32(i, 0x0929eb3f)
    i = i ^ (p >> 23)
    i = i ^ ((i & w) >> 1)
    i = _mul32(i, 1 | (p >> 27))
    i = _mul32(i, 0x6935fa69)
    i = i ^ ((i & w) >> 11)
    i = _mul32(i, 0x74dcb303)
    i = i ^ ((i & w) >> 2)
    i = _mul32(i, 0x9e501cc3)
    i = i ^ ((i & w) >> 2)
    i = _mul32(i, 0xc860a3df)
    i = i & w
    i = i ^ (i >> 5)
    return i


# cycle-walking rounds cmj_permute allows for an l that is not a power of
# two; each round leaves an index in range with probability > 1/2
_MAX_WALK = 256


def cmj_permute(i, l: int, p):
    """Cycle-walking permutation (ref: CMJ_Permute); l is static. When l is
    a power of two one round always lands in range (i & w < l), so no walk
    and no host sync follow; otherwise the walk repeats the round on the
    indices still out of range."""
    w = l - 1
    for s in (1, 2, 4, 8, 16):
        w |= w >> s
    i = _u32(i)
    p = _u32(p, i.device)
    i = _permute_round(i, p, w)
    if l & (l - 1):
        for _ in range(_MAX_WALK):
            out = i >= l
            if not bool(out.any()):
                break
            i = torch.where(out, _permute_round(i, p, w), i)
        else:
            raise RuntimeError("cmj_permute: the cycle walk did not end")
    return (i + p) % l


def cmj_sample2d(sample_idx, pattern, sqrt_n: int):
    """(ref: CorrelatedMultiJitteredSampling): sample in [0,1)^2, (..., 2).
    The divisions are by tensors: torch's CUDA division by a Python number
    multiplies by its reciprocal, which rounds otherwise for sqrt_n = 5."""
    n = sqrt_n * sqrt_n
    pattern = _u32(pattern)
    s = cmj_permute(sample_idx, n, _mul32(pattern, 0x51633e2d))
    sx = cmj_permute(s % sqrt_n, sqrt_n, _mul32(pattern, 0x68bc21eb))
    sy = cmj_permute(s // sqrt_n, sqrt_n, _mul32(pattern, 0x02e5be93))
    jx = cmj_rand_float(s, _mul32(pattern, 0x967a889b))
    jy = cmj_rand_float(s, _mul32(pattern, 0x368cc8b7))
    sqf = torch.full(jx.shape, float(sqrt_n), device=jx.device)
    nf = torch.full(jx.shape, float(n), device=jx.device)
    x = (sx.to(torch.float32) + (sy.to(torch.float32) + jx) / sqf) / sqf
    y = (s.to(torch.float32) + jy) / nf
    return torch.stack([x, y], dim=-1)


def concentric_sample_disk(u):
    """(ref: ConcentricSampleDisk). u: (..., 2) -> (..., 2)."""
    uo = 2.0 * u - 1.0
    x, y = uo[..., 0], uo[..., 1]
    zero = (torch.abs(x) < 1e-12) & (torch.abs(y) < 1e-12)
    x_dom = torch.abs(x) > torch.abs(y)
    r = torch.where(x_dom, x, y)
    safe_x = torch.where(torch.abs(x) > 1e-12, x, torch.ones_like(x))
    safe_y = torch.where(torch.abs(y) > 1e-12, y, torch.ones_like(y))
    theta = torch.where(x_dom, (math.pi / 4) * (y / safe_x),
                        (math.pi / 2) - (math.pi / 4) * (x / safe_y))
    out = r[..., None] * torch.stack([torch.cos(theta), torch.sin(theta)],
                                     dim=-1)
    return torch.where(zero[..., None], 0.0, out)


def cosine_sample_hemisphere(u):
    """Malley's method (ref: CosineSampleHemisphere); z-up tangent space."""
    d = concentric_sample_disk(u)
    z = torch.sqrt(torch.clamp(1.0 - d[..., 0] ** 2 - d[..., 1] ** 2,
                               min=0.0))
    return torch.cat([d, z[..., None]], dim=-1)


def cosine_hemisphere_pdf(cos_theta):
    return cos_theta * mu.INV_PI
