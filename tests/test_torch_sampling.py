"""Port parity for the path tracer's sampling primitives: CMJ sequences
bit-identical to JAX's (uint32 hashes carried in int64), the disk and
cosine-hemisphere maps to 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incarnation_tpu.kernels import sampling as jsamp
from incarnation_tpu_torch.kernels import sampling as tsamp

torch.set_num_threads(1)


@pytest.mark.parametrize("sqrt_n", [16, 5])
def test_cmj_sample2d_bit_identical(sqrt_n):
    """Every sample index of several patterns, patterns near 2^32 too:
    16 takes the power-of-two path (no cycle walk), 5 the walk."""
    rng = np.random.default_rng(sqrt_n)
    n = sqrt_n * sqrt_n
    idx = np.tile(np.arange(n, dtype=np.uint32), 40)
    pat = np.repeat(np.concatenate([
        rng.integers(0, 2**32, 36, dtype=np.uint64),
        [0, 1, 2**32 - 1, 2**31]]).astype(np.uint32), n)
    j = np.asarray(jsamp.cmj_sample2d(jnp.asarray(idx), jnp.asarray(pat),
                                      sqrt_n))
    t = tsamp.cmj_sample2d(torch.tensor(idx.astype(np.int64)),
                           torch.tensor(pat.astype(np.int64)), sqrt_n)
    np.testing.assert_array_equal(t.numpy(), j)
    assert t.min() >= 0.0 and t.max() < 1.0


def test_cmj_hashes_bit_identical():
    rng = np.random.default_rng(3)
    i = rng.integers(0, 2**32, 5000, dtype=np.uint64).astype(np.uint32)
    p = rng.integers(0, 2**32, 5000, dtype=np.uint64).astype(np.uint32)
    ti = torch.tensor(i.astype(np.int64))
    tp = torch.tensor(p.astype(np.int64))
    np.testing.assert_array_equal(
        tsamp.cmj_rand_float(ti, tp).numpy(),
        np.asarray(jsamp.cmj_rand_float(jnp.asarray(i), jnp.asarray(p))))
    for l in (7, 64, 256, 1000):
        np.testing.assert_array_equal(
            tsamp.cmj_permute(ti % l, l, tp).numpy(),
            np.asarray(jsamp.cmj_permute(jnp.asarray(i % l), l,
                                         jnp.asarray(p))).astype(np.int64))


def test_disk_and_hemisphere_match_jax():
    rng = np.random.default_rng(4)
    u = rng.uniform(0, 1, (4096, 2)).astype(np.float32)
    u[:4] = [[0.5, 0.5], [0.0, 0.0], [0.5, 0.9], [0.9, 0.5]]
    np.testing.assert_allclose(
        tsamp.concentric_sample_disk(torch.tensor(u)).numpy(),
        np.asarray(jsamp.concentric_sample_disk(jnp.asarray(u))),
        rtol=0, atol=1e-6)
    # the hemisphere: x, y (the disk) to 1e-6, and z through z^2 =
    # 1 - x^2 - y^2 to 1e-6: z = sqrt(1 - r^2) turns the ulp by which
    # torch's and XLA's cos / sin differ into up to 1e-5 near the rim
    t = tsamp.cosine_sample_hemisphere(torch.tensor(u)).numpy()
    j = np.asarray(jsamp.cosine_sample_hemisphere(jnp.asarray(u)))
    np.testing.assert_allclose(t[:, :2], j[:, :2], rtol=0, atol=1e-6)
    np.testing.assert_allclose(t[:, 2] ** 2, j[:, 2] ** 2, rtol=0,
                               atol=1e-6)
    assert (t[:, 2] >= 0).all()
    c = rng.uniform(0, 1, 100).astype(np.float32)
    np.testing.assert_allclose(
        tsamp.cosine_hemisphere_pdf(torch.tensor(c)).numpy(),
        np.asarray(jsamp.cosine_hemisphere_pdf(jnp.asarray(c))),
        rtol=1e-6)
