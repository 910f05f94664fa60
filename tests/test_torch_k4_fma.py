"""K4's multiply-add contract on the CPU: the twin's bvh._fma rounds
a * b + c once, to nearest even, as the card's fused multiply-add
(__fmaf_rn in csrc/bvh.cu) and XLA's fused products do. Held against exact
rational arithmetic on seeded random f32 triples and on constructed ties
where the f64 route rounds twice."""

from fractions import Fraction

import numpy as np
import pytest
import torch

from incarnation_tpu_torch.kernels import bvh

torch.set_num_threads(1)


def _round_f32(x: Fraction) -> np.float32:
    """x rounded to the nearest f32, ties to the even significand."""
    f0 = np.float32(float(x))
    cands = {f0, np.nextafter(f0, np.float32(np.inf)),
             np.nextafter(f0, np.float32(-np.inf))}
    best = min(cands, key=lambda f: (abs(Fraction(float(f)) - x),
                                     int(np.float32(f).view(np.int32)) & 1))
    return np.float32(best)


def _exact(a, b, c):
    return np.array([_round_f32(Fraction(float(x)) * Fraction(float(y))
                                + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _random_triples(n, seed):
    """f32 triples over 2^-30..2^30 of both signs; every third c nearly
    cancels a * b, as Moller-Trumbore's cross products do."""
    r = np.random.default_rng(seed)

    def f32(size):
        return (r.choice([-1.0, 1.0], size) * r.uniform(1, 2, size)
                * np.exp2(r.integers(-30, 30, size))).astype(np.float32)
    a, b, c = f32(n), f32(n), f32(n)
    near = np.arange(n) % 3 == 0
    c[near] = (-(a[near].astype(np.float64) * b[near])
               * (1 + r.uniform(-1e-6, 1e-6, near.sum()))).astype(np.float32)
    return a, b, c


def _ties(n, seed):
    """a * b an exact f32 midpoint (a 25-bit odd significand), c of either
    sign and far below half an f64 ulp of a * b: the f64 sum rounds back
    to the midpoint and the f32 cast then rounds to even, whichever side
    the exact sum lies on."""
    r = np.random.default_rng(seed)
    lo, hi = 1 << 12, int(2 ** 12.5)
    ia = r.integers(lo, hi, n) | 1
    ib = r.integers(lo, hi, n) | 1
    scale = np.exp2(r.integers(-20, 20, n))
    a = (ia * scale).astype(np.float32)
    b = (ib * np.exp2(-24.0)).astype(np.float32)
    p = a.astype(np.float64) * b
    c = (r.choice([-1.0, 1.0], n) * np.abs(p) * 2.0 ** -60
         * r.uniform(1, 2, n)).astype(np.float32)
    return a, b, c


def _old_fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


@pytest.mark.parametrize("kind", ["random", "ties"])
def test_fma_rounds_once(kind):
    a, b, c = _random_triples(3000, 0) if kind == "random" else _ties(600, 1)
    got = bvh._fma(torch.tensor(a), torch.tensor(b), torch.tensor(c))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(_exact(a, b, c)))


def test_double_rounding_misses_ties():
    """The f64 route that K4 and its twin took before rounds a * b + c
    twice and misses the exact result on a share of the ties; the twin's
    _fma does not."""
    a, b, c = _ties(600, 1)
    want = _bits(_exact(a, b, c))
    ta, tb, tc = torch.tensor(a), torch.tensor(b), torch.tensor(c)
    old = _bits(_old_fma(ta, tb, tc).numpy())
    assert (old != want).sum() > 100
    np.testing.assert_array_equal(_bits(bvh._fma(ta, tb, tc).numpy()), want)


def test_fma_keeps_shapes_and_specials():
    """Broadcasting as in _ray_setup (rays x 3 against rays x 1), signed
    zeros, and infinities and NaN passed through as the cast passes
    them."""
    a = torch.tensor([[1.0, -0.0, 2.0], [3.0, float("inf"), 0.5]])
    t = torch.tensor([[0.25], [2.0]])
    c = torch.tensor([[0.5, -0.0, -0.5], [float("nan"), 1.0, -1.0]])
    got = bvh._fma(a, t, c)
    want = (a.double() * t.double() + c.double()).float()
    assert got.shape == (2, 3) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    assert torch.signbit(got[0, 1])
