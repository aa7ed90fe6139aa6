"""PointConv's pieces of the benchmark: the kNN group counts
(``extra_counts``) and the operations behind ``mfu.attrib`` (``flops``)
against hand counts on a tiny cloud with duplicates, kernel 7's frozen
least time for a hand-sized launch, the slot yield and the KDE's share with
and without their spans, and (marked ``cuda``) the three readers of a
traced plan and forward on the card."""
import os

import numpy as np
import pytest
import torch

from iqbench import harness, work
from iqbench.reference import pointconv as ref
from iqbench.reference.pointnet2 import fps
from test_iqbench_counts import PEAKS
from test_iqbench_counts import FakeContext as RooflineContext
from test_iqbench_yields import FakeContext, FakeTrace, masked_batch

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def metric(name):
    return harness.load_module(os.path.join(PKG, "metrics", name + ".py"),
                               "p_" + name.replace(".", "_"))


def brute_groups(cfg, x, ident):
    """``group_counts`` by plain loops, distances in float64."""
    out = {}
    for level in ("sa1", "sa2"):
        spec = cfg[level]
        idx = fps(x[None], spec["npoint"])[0].tolist()
        seen, centres = set(), []
        for i in idx:
            if ident[i] not in seen:
                seen.add(ident[i])
                centres.append(i)
        slots = 0
        for c in centres:
            d = [(float(((x[j].double() - x[c].double()) ** 2).sum()), j)
                 for j in range(len(x))]
            slots += len({ident[j] for _, j in sorted(d)[:spec["nsample"]]})
        db, n = len(set(ident)), len(centres)
        out[level] = {"centres": n, "centres_sq": n * n, "db": db,
                      "db_sq": db * db, "centres_db": n * db, "slots": slots}
        x, ident = x[idx], [ident[i] for i in idx]
    return out


def test_group_counts_by_hand():
    cfg = {"sa1": {"npoint": 6, "nsample": 3}, "sa2": {"npoint": 3, "nsample": 4}}
    g = torch.Generator().manual_seed(0)
    x = torch.rand(10, 3, generator=g)
    ident = list(range(10))
    x[7:] = x[:3].mean(0)                   # three collapsed points
    ident[7:] = [10, 10, 10]
    got = ref.group_counts(cfg, x[None], torch.tensor([ident]))
    assert got == brute_groups(cfg, x, ident)
    assert got["sa1"]["db"] == 8            # 7 kept points and the centre


def test_group_counts_sum_over_clouds():
    cfg = {"sa1": {"npoint": 4, "nsample": 2}, "sa2": {"npoint": 2, "nsample": 2}}
    g = torch.Generator().manual_seed(1)
    x = torch.rand(2, 6, 3, generator=g)
    x[1, 3:] = x[1, :3].mean(0)
    ident = torch.tensor([list(range(6)), [0, 1, 2, 6, 6, 6]])
    got = ref.group_counts(cfg, x, ident)
    one = [ref.group_counts(cfg, x[i:i + 1], ident[i:i + 1]) for i in range(2)]
    for level in ("sa1", "sa2"):
        for key, value in got[level].items():
            assert value == one[0][level][key] + one[1][level][key], (level, key)


def small_pointconv():
    return {"family": "pointconv", "reference": "iqbench/reference/pointconv.py",
            "num_points": 8, "num_classes": 2,
            "sa1": {"npoint": 4, "nsample": 3, "mlp": [2, 3, 4], "bandwidth": 0.1},
            "sa2": {"npoint": 2, "nsample": 2, "mlp": [5, 6, 7], "bandwidth": 0.2},
            "sa3": {"group_all": True, "mlp": [3, 4, 5], "bandwidth": 0.4},
            "weightnet": [2, 2, 3], "densitynet": [2, 2, 1], "fc_widths": [2]}


def pointconv_entry():
    g = {"sa1": {"centres": 7, "centres_sq": 25, "db": 15, "db_sq": 113,
                 "centres_db": 52, "slots": 11},
         "sa2": {"centres": 3, "centres_sq": 5, "db": 7, "db_sq": 25,
                 "centres_db": 11, "slots": 5}}
    return {"clouds": 2, "forwards": 3, "plans": 1, "groups": g}


def test_flops_by_hand():
    c, e = small_pointconv(), pointconv_entry()
    side = (1 * 2 + 2 * 2 + 2 * 1) + (3 * 2 + 2 * 2 + 2 * 3)    # DensityNet, WeightNet
    # SA1: layer 1 hoisted on 15 rows of 3 and 7 centres, then per slot
    # 2x3 + 3x4, the side nets and 3 x 4 for the contraction; Linear 12 -> 4
    sa1 = 15 * 3 * 2 + 7 * 3 * 2 + 11 * (2 * 3 + 3 * 4 + side + 3 * 4) + 7 * 12 * 4
    # SA2: rows of 3 + 4 channels
    sa2 = 7 * 7 * 5 + 3 * 3 * 5 + 5 * (5 * 6 + 6 * 7 + side + 3 * 7) + 3 * 21 * 7
    # the last level on SA2's 3 distinct centres, its Linear 15 -> 5 a cloud
    sa3 = 3 * ((3 + 7) * 3 + 3 * 4 + 4 * 5 + side + 3 * 5) + 2 * 15 * 5
    head = 2 * (5 * 2 + 2 * 2)
    plan = 3 * (113 + 52 + 25 + 11 + 5)
    want = 2 * (3 * (sa1 + sa2 + sa3 + head) + plan)
    assert ref.flops(c, e) == want
    ctx = RooflineContext(c, [e, e], window_s=2.0)
    assert metric("mfu.attrib").read(ctx) == pytest.approx(100.0 * want)



@pytest.mark.parametrize("bound_by", ["bytes", "f32", "tensor_cores"])
def test_k7_least_time_by_hand(bound_by):
    c, e = small_pointconv(), pointconv_entry()
    wnet = 3 * 2 + 2 * 2 + 2 * 3                    # WeightNet's multiply-adds
    # SA1: B=2, S=4, K=3, N=8 rows, widths 2, 3, 4
    w1 = 2 * 3 + 3 + 3 * 4 + 4 + wnet + 7
    b1 = 4 * (2 * 2 * 4 * 3 + 2 * 4 * 3 + 2 * 8 * (2 + 3) + 2 * 4 * 2 + w1
              + 2 * 4 * 3 * 4)
    t1, f1 = 2 * 11 * (2 * 3 + 3 * 4 + 3 * 4), 2 * 11 * wnet
    # SA2: B=2, S=2, K=2, N=4 rows (SA1's centres), widths 5, 6, 7
    w2 = 5 * 6 + 6 + 6 * 7 + 7 + wnet + 7
    b2 = 4 * (2 * 2 * 2 * 2 + 2 * 2 * 3 + 2 * 4 * (5 + 3) + 2 * 2 * 5 + w2
              + 2 * 2 * 3 * 7)
    t2, f2 = 2 * 5 * (5 * 6 + 6 * 7 + 3 * 7), 2 * 5 * wnet
    peaks = dict(PEAKS, **{"bytes": {"hbm_bytes_per_s": 1e-6},
                           "f32": {"f32_flops_per_s": 1e-6},
                           "tensor_cores": {"tf32_flops_per_s": 1e-6}}[bound_by])
    want = 3 * sum(max(b / peaks["hbm_bytes_per_s"], f / peaks["f32_flops_per_s"],
                       3 * t / peaks["tf32_flops_per_s"])
                   for b, f, t in ((b1, f1, t1), (b2, f2, t2)))
    assert want == 3 * 1e6 * {"bytes": b1 + b2, "f32": f1 + f2,
                              "tensor_cores": 3 * (t1 + t2)}[bound_by]
    ctx = RooflineContext(c, [e])
    ctx.peaks = peaks
    assert metric("k7_roofline").read(ctx) == pytest.approx(100.0 * want)


def test_k7_slot_yield_by_hand():
    """Needed: 11 + 5 distinct slots a forward; launched: 2 clouds of
    4 x 3 + 2 x 2 slots a forward; None without kernel 7's span."""
    c, e = small_pointconv(), pointconv_entry()
    k7 = metric("k7_slot_yield")
    assert k7.needed([e, e]) == 2 * 3 * (11 + 5)
    assert k7.launched(c, [e, e]) == 2 * 3 * 2 * (4 * 3 + 2 * 2)
    traced = FakeTrace({"iq_pointconv_sa": [(0, 1)]})
    assert k7.read(FakeContext(c, [e, e], traced)) == pytest.approx(50.0)
    assert k7.read(FakeContext(c, [e, e], FakeTrace({"iq_plan": [(0, 1)]}))) is None


def test_density_share():
    share = metric("density_share.attrib")
    ctx = FakeContext({}, [], FakeTrace({"iq_density": [(0, 1)]}, busy_s=4.0,
                                        device_s=0.2))
    assert share.read(ctx) == pytest.approx(5.0)
    assert share.read(FakeContext({}, [], FakeTrace({"iq_plan": [(0, 1)]},
                                                    device_s=0.2))) is None


# ------------------------------------------------------------- on the card
@pytest.mark.cuda
def test_readers_of_a_traced_plan_and_forward(card):
    """One masked chunk's plan and forward through the port under the
    benchmark's window span: each of the three readers finds its span and
    reads within (0, 100]."""
    from torch.profiler import record_function
    from interpret_quality_tpu_torch.models import build_model, make_forward_fn
    from interpret_quality_tpu_torch.ops.precision import set_matmul_precision
    from iqbench import trace as trace_mod
    cfg = harness.load_json(os.path.join(PKG, "configs", "pointconv.json"))
    masked, keep, region = masked_batch(cfg, card)
    set_matmul_precision(cfg["precision"]["matmul_precision"])
    torch.manual_seed(0)
    fwd = make_forward_fn(build_model("pointconv", cfg["num_classes"]).to(card).eval())
    with torch.no_grad():
        fwd.apply_plan_fn(masked, fwd.plan_fn(masked))      # built and warm
        torch.cuda.synchronize()
        prof = trace_mod.start(card)
        with record_function(trace_mod.WINDOW):
            fwd.apply_plan_fn(masked, fwd.plan_fn(masked))
            torch.cuda.synchronize()
    ctx = FakeContext(cfg, [dict(work.chunk_counts(cfg, masked, keep, region),
                                 forwards=1, plans=1)], trace_mod.summarize(prof))
    ctx.peaks = harness.load_json(os.path.join(PKG, "peaks.json")).get(
        torch.cuda.get_device_name(0))
    names = ["k7_slot_yield", "density_share.attrib"]
    if ctx.peaks is not None:
        names.append("k7_roofline")
    for name in names:
        value = metric(name).read(ctx)
        assert value is not None and 0.0 < value <= 100.0, (name, value)
