"""Kernel 9's frozen least time (``metrics/k9_roofline.py``) against a hand
count at a small shape, each of its three terms in turn the largest."""
import numpy as np
import pytest

from test_iqbench_counts import PEAKS, FakeContext, metric, small_dgcnn


@pytest.mark.parametrize("bound_by", ["bytes", "f32", "tensor_cores"])
def test_k9_least_time_by_hand(bound_by):
    c = small_dgcnn()       # N = 5 rows, K = 4 + 6 in, C = 7 out
    e = {"clouds": 2, "d": np.array([5, 2]), "forwards": 3, "plans": 1}
    nbytes = 4 * (2 * 5 * 10 + 10 * 7 + 4 * 7 + 2 * 2 * 7)
    tc = 2 * 10 * 7 * (5 + 2)
    f32 = 2 * 7 * (5 + 2)
    # each term's rate made slow enough that it sets the bound
    peaks = dict(PEAKS, **{"bytes": {"hbm_bytes_per_s": 1e-6},
                           "f32": {"f32_flops_per_s": 1e-6},
                           "tensor_cores": {"tf32_flops_per_s": 1e-6}}[bound_by])
    want = 3 * max(nbytes / peaks["hbm_bytes_per_s"],
                   f32 / peaks["f32_flops_per_s"],
                   3 * tc / peaks["tf32_flops_per_s"])
    assert want == 3 * {"bytes": nbytes, "f32": f32,
                        "tensor_cores": 3 * tc}[bound_by] * 1e6
    ctx = FakeContext(c, [e])
    ctx.peaks = peaks
    assert metric("k9_roofline").read(ctx) == pytest.approx(100.0 * want)
