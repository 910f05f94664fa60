"""K8's checkerboard geometry on the host: the spans of csrc/skylight.cu's
k8_sky_checker_kernel, whose fetching warp takes K8C_PAIRS + 1 lanes of a
row's span, lane k the pixel x0 + 2 k - q, and the wrapper's count of the
lanes that fetch (kernels/skylight.py checker_fetch_lanes). Brute force
over every even width to 200 and both parities: the lanes take each pixel
of the fetching parity once as a span's own and, besides, only the halo
pixels; a filling pixel's two lanes are its neighbours. The kernel runs
only on a card (tests/test_torch_kernels_cuda.py
test_k8_checker_spans_match_twin)."""

import pathlib
import re

import numpy as np
import pytest
import torch

from incarnation_tpu_torch.kernels import skylight

torch.set_num_threads(1)

WIDTHS = range(2, 201, 2)
PAIRS, SPAN = skylight.K8C_PAIRS, skylight.K8C_SPAN


def lane_pixels(w: int, q: int) -> np.ndarray:
    """(spans, PAIRS + 1): the pixel each fetching lane of each span of a
    row of width w takes, where the row's fetching parity is q; a span a
    block column, the last one ragged."""
    spans = -(-w // SPAN)
    return (np.arange(spans)[:, None] * SPAN
            + 2 * np.arange(PAIRS + 1)[None, :] - q)


def test_constants_are_the_kernels():
    """The wrapper's span constant is csrc/skylight.cu's, and the kernel's
    fetching lanes take the pixels x0 + 2 k - q: a row's fetching warp
    holds its span's pairs and the halo, 32 lanes."""
    src = (pathlib.Path(skylight.__file__).resolve().parents[1] / "csrc"
           / "skylight.cu").read_text()
    assert re.findall(r"#define K8C_PAIRS (\d+)", src) == [str(PAIRS)]
    assert "#define K8C_SPAN (2 * K8C_PAIRS)" in src
    assert "filling ? 2 * lane + 1 - q : 2 * lane - q" in src
    assert PAIRS + 1 == 32 and SPAN == 2 * PAIRS


@pytest.mark.parametrize("q", [0, 1])
def test_lanes_cover_each_fetching_pixel_once(q):
    """Per span, lanes q .. PAIRS - 1 + q take exactly the span's pixels
    of parity q (those inside the row), the other lane its halo; over the
    spans, every pixel of parity q is some span's own exactly once, and
    the lanes take no pixel but those and the halos."""
    for w in WIDTHS:
        lanes = lane_pixels(w, q)
        own, halos = [], set()
        for s in range(lanes.shape[0]):
            x0 = s * SPAN
            span = min(SPAN, w - x0)
            assert span > 0 and span % 2 == 0
            halo = int(lanes[s, PAIRS if q == 0 else 0])
            assert halo == (x0 + SPAN if q == 0 else x0 - 1)
            inside = [int(x) for x in lanes[s, q:q + PAIRS] if 0 <= x < w]
            assert inside == [x for x in range(x0, x0 + span) if x % 2 == q]
            own += inside
            if 0 <= halo < w:
                halos.add(halo)
        fetching = [x for x in range(w) if x % 2 == q]
        assert sorted(own) == fetching
        taken = {int(x) for x in lanes.ravel() if 0 <= x < w}
        assert taken == set(fetching) | halos
        assert halos <= set(fetching)


@pytest.mark.parametrize("q", [0, 1])
def test_filling_pixels_read_their_neighbours(q):
    """Pair l's fetching pixel is lane l + q's, which shades it; its
    filling pixel (the filling warp's lane l) reads the fetching lanes l
    and l + 1, which fetched x - 1 and x + 1 (or lie outside the row at
    its ends, where the fill is clamped)."""
    for w in WIDTHS:
        lanes = lane_pixels(w, q)
        for s in range(lanes.shape[0]):
            x0 = s * SPAN
            for px in range(min(SPAN, w - x0)):
                x, pair = x0 + px, px >> 1
                if px % 2 == q:
                    assert lanes[s, pair + q] == x
                else:
                    left, right = lanes[s, pair], lanes[s, pair + 1]
                    assert left == x - 1 and right == x + 1
                    assert (left >= 0) == (x > 0)
                    assert (right < w) == (x < w - 1)


@pytest.mark.parametrize("parity,row0", [(0, 0), (1, 0), (0, 5), (1, 8)])
def test_fetch_lanes_against_brute_force(parity, row0):
    """checker_fetch_lanes counts the lanes a launch fetches with, halos
    included: brute force over every lane of random masks, at least the
    twin's distinct fetching pixels that a covered pixel needs."""
    r = np.random.default_rng(parity + 2 * row0)
    for w in (2, 30, 62, 64, 124, 130, 200):
        h = 7
        mask = r.random((h, w)) < r.choice([0.05, 0.5, 0.95])
        want, distinct = 0, 0
        for y in range(h):
            q = (row0 + y + parity) & 1
            for x in lane_pixels(w, q).ravel():
                if 0 <= x < w and mask[y, max(x - 1, 0):x + 2].any():
                    want += 1
            distinct += sum(mask[y, max(x - 1, 0):x + 2].any()
                            for x in range(q, w, 2))
        got = skylight.checker_fetch_lanes(torch.from_numpy(mask), parity,
                                           row0)
        assert got == want
        assert distinct <= got <= distinct + h * -(-w // SPAN)


@pytest.mark.parametrize("w,h", [(1920, 1088), (2, 1), (130, 11)])
def test_fetch_lanes_of_a_covered_frame(w, h):
    """On a wholly covered layer every lane inside the image fetches: a
    row's w / 2 fetching pixels and one halo between each two spans; on
    an empty one none does."""
    spans = -(-w // SPAN)
    full = torch.ones((h, w), dtype=torch.bool)
    assert skylight.checker_fetch_lanes(full, 0) == h * (w // 2 + spans - 1)
    assert skylight.checker_fetch_lanes(full, 1, 3) \
        == h * (w // 2 + spans - 1)
    assert skylight.checker_fetch_lanes(~full, 1) == 0
