"""K10's scratch (kernels/raster.py _k10_scratch) on the host: the
look-back state of every row yet seen stays at the front of the buffer,
in place and zero, whatever the shapes of the binnings between; the
kernels that use it run only on a card (tests/test_torch_kernels_cuda.py
test_k10_lookback_rows_and_state)."""

import types

import pytest
import torch

from incarnation_tpu_torch.kernels import raster

torch.set_num_threads(1)


@pytest.fixture
def scratch(monkeypatch):
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(raster, "_K10_SCRATCH", {})
    return lambda rows, words: raster._k10_scratch(torch.device("cpu"),
                                                    rows, words)


@pytest.mark.parametrize("shapes", [
    [(74, 5000), (5, 300), (74, 5000)],
    [(5, 300), (74, 5000), (5, 300)],
    [(2049, 100), (3, 90_000), (2049, 100)],
], ids=["wide_narrow_wide", "narrow_wide_narrow", "rows_then_work"])
def test_state_words_keep_their_place(scratch, shapes):
    """A binning writes its work past the state of every row yet seen, so
    a later binning with more rows never finds another's data in its
    look-back words: the state slice starts the buffer, covers every row
    seen so far (two int64 counters, then a word a row), and the work
    follows it, 16-byte aligned."""
    seen = 0
    for rows, words in shapes:
        state, work = scratch(rows, words)
        seen = max(seen, rows)
        buf, cap = raster._K10_SCRATCH[(None, 7)]
        assert cap == seen
        assert state.data_ptr() == buf.data_ptr()
        assert state.numel() >= 2 * (raster._K10_STATE_WORDS + seen)
        assert state.numel() == raster._k10_state_words(seen)
        assert work.data_ptr() == buf.data_ptr() + 4 * state.numel()
        assert work.data_ptr() % 16 == 0
        assert work.numel() == words
        assert not state.any()
        # the kernels leave the state zero; the work they fill
        work.fill_(-1)
