"""The frozen operation and byte counts against hand-worked numbers."""
import pytest

from benchmark import counts
from benchmark.metrics import _roofline


@pytest.mark.parametrize("h, n, m", [(10, 120, 200), (16, 192, 320)])
def test_sizes(h, n, m):
    assert counts.condensed_sizes(h) == (n, m)


@pytest.mark.parametrize("n, ops, nbytes", [(120, 1_728_000, 115_200), (192, 7_077_888, 294_912)])
def test_invert_is_n_cubed(n, ops, nbytes):
    assert counts.invert_spd(n) == (ops, nbytes)


@pytest.mark.parametrize("n, m, ops, nbytes", [
    # 40 x (2 n^2 + 115 n / 3); 4 (n^2 + 4n + 7m)
    (120, 200, 40 * (28_800 + 4_600), 4 * (14_400 + 480 + 1_400)),
    (192, 320, 40 * (73_728 + 7_360), 4 * (36_864 + 768 + 2_240)),
])
def test_iterate(n, m, ops, nbytes):
    assert counts.iterate(n, m, 40) == (ops, nbytes)


def test_riccati_h16():
    # Per step: factor 2 x 16250 + Gauss-Jordan 210 x 23 = 37330; per sweep
    # and step 2 x 1106 + 360 = 2572; 3235 floats of operands.
    assert counts.riccati_admm(16, 40) == (16 * 37_330 + 40 * 16 * 2_572, 4 * 3_235)


def test_least_time_and_share():
    ops, nbytes = counts.invert_spd(192)
    assert counts.least_seconds(ops, nbytes) == pytest.approx(7_077_888 / 67e12)
    rec = {"batch": 4096, "kernels": {"k_invert(float const*)": [0.02, 4], "other": [1.0, 9]}}
    least = 4096 * 7_077_888 / 67e12
    assert _roofline.share(rec, ("k_invert",), (ops, nbytes)) == pytest.approx(100 * least / 0.005)
    assert _roofline.share(rec, ("absent",), (ops, nbytes)) is None
