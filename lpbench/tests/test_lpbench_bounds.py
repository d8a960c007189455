"""The roofline arithmetic against counts worked by hand."""

import numpy as np
import pytest

from lpbench import bounds

PEAKS = bounds.PEAKS["NVIDIA H100 80GB HBM3"]


def test_streaming_work_by_hand():
    # m = 2, n = 5, 20 pivots: 1 + 20 // 128 = 1 refresh, ceil(20 / 16) = 2 majors
    flops, nbytes = bounds.streaming_work(2, 5, 20)
    assert flops == 1 * (8 * 8 + 2 * 5 * 4) + 2 * (2 * 2 * 5 + 2 * 4 * 17)
    assert nbytes == 4 * ((10 + 2 + 15) + (2 + 5 + 4))


def test_streaming_work_at_25fv47():
    # 13974 pivots at 821 x 2392: 110 refreshes, 874 majors; operations set it
    flops, nbytes = bounds.streaming_work(821, 2392, 13974)
    m, n = 821, 2392
    assert flops == 110 * (8 * m ** 3 + 2 * n * m * m) + 874 * (2 * m * n + 2 * m * m * 17)
    secs, by = bounds.seconds(flops, nbytes, PEAKS)
    assert by == "operations" and secs == pytest.approx(flops / 67e12)
    assert 0.012 < secs < 0.016


def test_dense_simplex_work_by_hand():
    # two LPs of 2 x 4 with 3 and 33 pivots: one refresh (33 // 32)
    flops, nbytes = bounds.dense_simplex_work(np.array([3, 33]), 2, 4)
    per_pivot = 2 * 2 * 4 + 4 * 4
    assert flops == 36 * per_pivot + 1 * (8 * 8 + 4 * 2 * 4)
    assert nbytes == 2 * 4 * ((8 + 2 + 12) + (2 + 4 + 2))


def test_seconds_takes_the_larger_side():
    assert bounds.seconds(67e12, 1.0, PEAKS) == (1.0, "operations")
    assert bounds.seconds(1.0, 3.35e12, PEAKS) == (1.0, "bytes")
