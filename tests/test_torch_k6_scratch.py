"""K6's peel-step scratch (kernels/resolve.py _k6_scratch) on the host: the
state words csrc/resolve.cu's k6_peel_kernel reads, all zero between
launches, a buffer per (device, stream) that holds the four counters and a
look-back word for every block of the largest layer yet seen; the kernel
that uses it runs only on a card (tests/test_torch_kernels_cuda.py
test_k6_peel_step_*)."""

import types

import pytest
import torch

from incarnation_tpu_torch.kernels import resolve

torch.set_num_threads(1)


@pytest.fixture
def scratch(monkeypatch):
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(resolve, "_K6_SCRATCH", {})
    return lambda pixels: resolve._k6_scratch(torch.device("cpu"), pixels)


def test_block_size_is_the_kernels():
    """A block of K6's peel step takes 8 chunks of CHUNK_PX pixels (csrc
    K6_WARPS, K6_CHUNK)."""
    assert resolve.K6_BLOCK_PX == 8 * resolve.CHUNK_PX == 1024


@pytest.mark.parametrize("sizes", [
    [1920 * 1088, 64 * 200, 1920 * 1088],
    [64 * 200, 1920 * 1088, 1],
    [1, 1025, 1024, 2049],
], ids=["large_small_large", "small_large_one", "block_edges"])
def test_state_words_cover_every_block(scratch, sizes):
    """The scratch holds the 4 state words and a look-back word per block
    of the largest layer yet seen, int64, zero; a smaller layer reuses the
    buffer and a larger one gets a new zero one."""
    seen = 0
    for px in sizes:
        buf = scratch(px)
        blocks = -(-px // resolve.K6_BLOCK_PX)
        grew = blocks > seen
        seen = max(seen, blocks)
        assert buf.dtype == torch.int64
        assert buf.numel() == resolve._K6_STATE_WORDS + seen
        assert resolve._K6_SCRATCH[(None, 7)] is buf
        assert not buf.any()
        if not grew:
            assert scratch(px).data_ptr() == buf.data_ptr()
