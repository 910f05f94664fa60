"""The checkerboard half-rate fetch (kernels/checker.py) against the JAX
package's: compact and expand equal JAX's exactly for both parities, with
and without channel dims, and a band's parity follows whole-frame rows."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incarnation_tpu.kernels import checker as jchecker
from incarnation_tpu_torch.kernels import checker as tchecker

torch.set_num_threads(1)

H, W = 6, 10


@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("trail", [(), (3,), (2, 2)])
def test_compact_expand_match_jax(parity, trail):
    """compact picks the same lanes, expand fills the same tents: both
    bit for bit (the same sums in the same order), on random f32 and on
    int32 (compact only: the material ids)."""
    r = np.random.default_rng(7 + parity)
    a = r.normal(size=(H, W) + trail).astype(np.float32)
    got = tchecker.compact(parity, torch.tensor(a))
    want = np.asarray(jchecker.compact(parity, jnp.asarray(a)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape == (H, W // 2) + trail
    np.testing.assert_array_equal(
        tchecker.expand(parity, got).numpy(),
        np.asarray(jchecker.expand(parity, jnp.asarray(want))))
    ids = r.integers(-1, 40, (H, W)).astype(np.int32)
    np.testing.assert_array_equal(
        tchecker.compact(parity, torch.tensor(ids)).numpy(),
        np.asarray(jchecker.compact(parity, jnp.asarray(ids))))


@pytest.mark.parametrize("parity", [0, 1])
def test_fetch_mask_and_edges(parity):
    """fetch_mask marks compact's pixels; expand keeps the fetched ones,
    fills the others with the mean of their horizontal neighbours and
    clamps at the row ends (the end pixel takes its one neighbour)."""
    r = np.random.default_rng(3)
    a = torch.tensor(r.normal(size=(H, W)).astype(np.float32))
    m = tchecker.fetch_mask((H, W), parity, "cpu")
    assert int(m.sum()) == H * W // 2
    np.testing.assert_array_equal(a[m].reshape(H, W // 2).numpy(),
                                  tchecker.compact(parity, a).numpy())
    e = tchecker.expand(parity, tchecker.compact(parity, a))
    assert torch.equal(e[m], a[m])
    for y in range(H):
        for x in range(W):
            if m[y, x]:
                continue
            left = a[y, x - 1] if x > 0 else a[y, x + 1]
            right = a[y, x + 1] if x + 1 < W else a[y, x - 1]
            assert e[y, x] == 0.5 * (left + right)


def test_band_rows_follow_the_whole_frame():
    """A band starting at row0 compacts and expands as the same rows of
    the whole frame do, and an odd width is refused."""
    r = np.random.default_rng(4)
    a = torch.tensor(r.normal(size=(H, W, 3)).astype(np.float32))
    for parity in (0, 1):
        whole = tchecker.expand(parity, tchecker.compact(parity, a))
        for row0 in (1, 3):
            band = tchecker.expand(
                parity, tchecker.compact(parity, a[row0:], row0), row0)
            assert torch.equal(band, whole[row0:])
    with pytest.raises(ValueError, match="even width"):
        tchecker.compact(0, a[:, :W - 1])
