"""The arithmetic contracts K8 and K9 share with their twins, on the CPU.

K8 (csrc/skylight.cu) evaluates the analytic env-BRDF fit with one fused
multiply-add per Chebyshev recurrence step and per product of its tensor
sums; its twin, ibl.env_brdf_approx, rounds each of those once through
mathutils.fma. Held here against an independent evaluation of the same
chain in exact rational arithmetic, each fused step rounded once to the
nearest f32 (ties to even).

K9 (csrc/setup.cu) forms each mesh's local_to_world = T @ R and
local_to_clip = local_to_world @ VP with every multiply and add rounded on
its own, each sum left to right; its twin's raster._mesh_rows does the
same in elementwise torch operations. Held here against numpy float32.
"""

from fractions import Fraction
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from incarnation_tpu_torch.core import mathutils as mu
from incarnation_tpu_torch.kernels import ibl, ibl_fit_coeffs, raster

torch.set_num_threads(1)


def _round_f32(x: Fraction) -> Fraction:
    """x rounded to the nearest f32, ties to the even significand."""
    f0 = np.float32(float(x))
    cands = {f0, np.nextafter(f0, np.float32(np.inf)),
             np.nextafter(f0, np.float32(-np.inf))}
    best = min(cands, key=lambda f: (abs(Fraction(float(f)) - x),
                                     int(np.float32(f).view(np.int32)) & 1))
    return Fraction(float(best))


def _fma(a: Fraction, b: Fraction, c: Fraction) -> Fraction:
    return _round_f32(a * b + c)


def _f32(x) -> Fraction:
    return Fraction(float(np.float32(x)))


def _cheb(t: Fraction) -> list:
    ts = [Fraction(1), t]
    t2 = 2 * t  # exact
    for _ in range(14):
        ts.append(_fma(t2, ts[-1], -ts[-2]))
    return ts


def _tensor_sum(coeffs, tu, tv) -> Fraction:
    out = None
    for i, row in enumerate(coeffs):
        g = _round_f32(_f32(row[0]) * tv[0])
        for j in range(1, 16):
            g = _fma(_f32(row[j]), tv[j], g)
        out = _round_f32(tu[0] * g) if i == 0 else _fma(tu[i], g, out)
    return out


def _points():
    """(NoV, roughness) pairs: a seeded grid plus the grazing corners (NoV
    at 0, 1/256 and 0.02; roughness at 0 and 1)."""
    r = np.random.default_rng(40)
    nov = list(r.uniform(0, 1, 220))
    rough = list(r.uniform(0, 1, 220))
    for nv in (0.0, 1.0 / 256.0, 0.02, 0.5, 1.0):
        for ro in (0.0, 1.0, 0.3):
            nov.append(nv)
            rough.append(ro)
    return (np.asarray(nov, np.float32), np.asarray(rough, np.float32))


def test_env_brdf_fit_rounds_each_fused_step_once():
    """ibl.env_brdf_approx equals, bit for bit, the fit evaluated with
    rational arithmetic where each fused step (recurrence, tensor sum) is
    rounded once to f32. The chain's unfused inputs (the clamps, pow,
    sqrt, 2x - 1 and the 1 / NoV factor) are torch's own operations, as in
    the twin; what is under test is the fused chain between them."""
    nov, rough = _points()
    got = ibl.env_brdf_approx(torch.tensor(nov), torch.tensor(rough))
    n = torch.clamp(torch.tensor(nov), 0.0, 1.0)
    r = torch.clamp(torch.tensor(rough), 0.0, 1.0)
    tu_arg = 2.0 * torch.pow(torch.clamp(n, min=1e-8), 0.25) - 1.0
    ta_arg = 2.0 * r - 1.0
    tb_arg = 2.0 * torch.sqrt(r) - 1.0
    inv = 1.0 / torch.clamp(n, min=1.0 / 256.0)
    want = np.empty((len(nov), 2), np.float32)
    for k in range(len(nov)):
        tu = _cheb(_f32(tu_arg[k]))
        an = _tensor_sum(ibl_fit_coeffs.CHEB_A, tu, _cheb(_f32(ta_arg[k])))
        bn = _tensor_sum(ibl_fit_coeffs.CHEB_B, tu, _cheb(_f32(tb_arg[k])))
        want[k] = [np.float32(float(an)) * inv[k].numpy(),
                   np.float32(float(bn)) * inv[k].numpy()]
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


def test_env_brdf_fit_is_not_the_unfused_chain():
    """The fused chain is what the twin computes: rounding each multiply
    and add apart lands elsewhere on most points (the fit is
    ill-conditioned), so the exact comparison above is a real check."""
    nov, rough = _points()
    got = ibl.env_brdf_approx(torch.tensor(nov), torch.tensor(rough))
    n = torch.clamp(torch.tensor(nov), 0.0, 1.0)
    r = torch.clamp(torch.tensor(rough), 0.0, 1.0)

    def cheb(t):
        ts = [torch.ones_like(t), t]
        for _ in range(14):
            ts.append(2.0 * t * ts[-1] - ts[-2])
        return ts

    def tensor_sum(coeffs, tu, tv):
        out = None
        for i, row in enumerate(np.asarray(coeffs, np.float32).tolist()):
            g = row[0] * tv[0]
            for j in range(1, 16):
                g = g + row[j] * tv[j]
            out = tu[0] * g if i == 0 else out + tu[i] * g
        return out
    tu = cheb(2.0 * torch.pow(torch.clamp(n, min=1e-8), 0.25) - 1.0)
    an = tensor_sum(ibl_fit_coeffs.CHEB_A, tu, cheb(2.0 * r - 1.0))
    unfused = an * (1.0 / torch.clamp(n, min=1.0 / 256.0))
    assert float((unfused != got[:, 0]).float().mean()) > 0.5


@pytest.mark.parametrize("shape", [(5,), (3, 4)])
def test_fma_takes_f32_scalars_and_f64_copies(shape):
    """mathutils.fma with a Python float holding an f32 value, or an f64
    copy of an f32 tensor, as the first factor gives the same bits as with
    the f32 tensor itself."""
    r = np.random.default_rng(41)
    a = r.normal(size=shape).astype(np.float32)
    b = r.normal(size=shape).astype(np.float32)
    c = r.normal(size=shape).astype(np.float32)
    ta, tb, tc = torch.tensor(a), torch.tensor(b), torch.tensor(c)
    ref = mu.fma(ta, tb, tc)
    assert torch.equal(mu.fma(ta.double(), tb.double(), tc), ref)
    s = float(a.reshape(-1)[0])
    assert torch.equal(mu.fma(s, tb, tc), mu.fma(torch.full_like(tb, s),
                                                  tb, tc))


def _mesh_scene(n_mesh, seed):
    r = np.random.default_rng(seed)
    xf = np.zeros((n_mesh, 4, 4), np.float32)
    for m in range(n_mesh):
        q = np.linalg.qr(r.normal(size=(3, 3)))[0]
        xf[m, :3, :3] = q * r.uniform(0.3, 3.0, 3)[:, None]
        xf[m, 3, :3] = r.uniform(-20, 20, 3)
        xf[m, 3, 3] = 1.0
    return SimpleNamespace(mesh_transforms=torch.tensor(xf)), xf


def _np_product(a, b):
    """a @ b in numpy float32, each sum left to right over k."""
    out = a[..., :, 0:1] * b[0]
    for k in range(1, 4):
        out = out + a[..., :, k:k + 1] * b[k]
    return out


@pytest.mark.parametrize("n_mesh", [1, 3, 17])
def test_mesh_rows_left_to_right_f32(n_mesh):
    """raster._mesh_rows: local_to_clip (16) then the 3x3 of
    local_to_world (9) per mesh, bit for bit a numpy float32 evaluation
    summed left to right, under a non-identity scene rotation and a
    perspective view_proj."""
    from incarnation_tpu_torch.core.view import View
    scene, xf = _mesh_scene(n_mesh, 42 + n_mesh)
    rot = np.eye(4, dtype=np.float32)
    rot[:3, :3] = np.linalg.qr(np.random.default_rng(7).normal(
        size=(3, 3)))[0]
    rot[3, :3] = [0.5, -0.25, 1.0]
    vp = View.from_lookat([0.5, 2.0, -12.0], [0.0, 0.0, 6.0],
                          aspect=16 / 9).view_proj().astype(np.float32)
    got = raster._mesh_rows(scene, torch.tensor(rot), torch.tensor(vp))
    lw = _np_product(xf, rot)
    lc = _np_product(lw, vp)
    want = np.concatenate([lc.reshape(-1, 16),
                           lw[:, :3, :3].reshape(-1, 9)], -1)
    assert got.dtype == torch.float32 and got.shape == (n_mesh, 25)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
