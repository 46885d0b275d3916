"""The operation and byte counts reproduce the bounds PERF.md gives."""

import pytest

from benchmark.lib import flops, k1
from benchmark.lib.peaks import bound_ms


def test_k1_bound_at_16_windows():
    ms, by = bound_ms(k1.work("fwd", 16, 7, 4000, 4000, 2)[1],
                      k1.work("fwd", 16, 7, 4000, 4000, 2)[0])
    assert by == "operations" and ms == pytest.approx(1.37, abs=0.005)
    assert k1.least_ms("fwd", 16, 7, 4000, 4000, 2) == pytest.approx(ms)


@pytest.mark.parametrize("kind,n,cin,cout,want", [
    ("fwd", 8, 2000, 4000, 0.3425), ("fwd", 8, 4000, 4000, 0.685),
    ("dx", 8, 2000, 4000, 0.3425)])
def test_k1_bounds_of_the_kernel_table(kind, n, cin, cout, want):
    assert k1.least_ms(kind, n, 7, cin, cout, 2) == pytest.approx(want, abs=0.0005)


def test_model_flops():
    assert flops.backbone_frame_flops("resnet50", 64, 224, 1000) == pytest.approx(50.25e9, rel=1e-3)
    assert flops.backbone_frame_flops("resnet152", 64, 224, 1000) == pytest.approx(139.34e9,
                                                                                   rel=1e-3)
    assert flops.clstm_window_flops(1000, 1000, 7, 5) == pytest.approx(1.0584e12, rel=1e-4)
