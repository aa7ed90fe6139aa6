"""The readers of the port's spans and work counters: the counts each yield
needs against hand counts, the dense terms beside the kNN terms against
``flops``, the idle interval arithmetic, and (marked ``cuda``) each yield
of the port on masked clouds within (0, 100]."""
import os

import numpy as np
import pytest
import torch

from iqbench import harness, inputs, work
from iqbench.reference import attribution as ref_attr
from iqbench.reference import dgcnn as ref_dgcnn

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def metric(name):
    return harness.load_module(os.path.join(PKG, "metrics", name + ".py"),
                               "y_" + name.replace(".", "_"))


def small_dgcnn():
    return {"family": "dgcnn", "reference": "iqbench/reference/dgcnn.py",
            "num_points": 5, "input_channels": 3, "k": 2,
            "edge_widths": [4, 6], "emb_dims": 7, "fc_widths": [3, 2],
            "num_classes": 2}


class FakeTrace:
    def __init__(self, spans=None, busy_s=1.0, device_s=0.0, gaps=(),
                 window=(0, 1)):
        self.spans, self.busy_s, self._device_s = spans or {}, busy_s, device_s
        self._gaps, (self.w0, self.w1) = list(gaps), window

    def device_s(self, inside, outside=()):
        return self._device_s

    def gaps(self):
        return self._gaps


class FakeContext:
    def __init__(self, cfg, entries, trace=None):
        self.cfg, self.entries, self.trace = cfg, entries, trace

    def work(self):
        return self.entries


def with_counter(monkeypatch, reader, value):
    """The reader with the port's counter replaced by ``value``."""
    monkeypatch.setattr(reader, "port_counter", lambda name: value)
    return reader


def test_dense_operations_by_hand(monkeypatch):
    c, d = small_dgcnn(), np.array([5, 2])
    entry = {"clouds": 2, "d": d, "forwards": 3, "plans": 1}
    per = sum(2 * 3 * 4 * n + 2 * 4 * 6 * n + 10 * 7 * n for n in d)
    per += 2 * (14 * 3 + 3 * 2 + 2 * 2)
    dense = metric("dense_yield.attrib")
    assert dense.dense_operations(c, entry) == 2 * 3 * per
    ctx = FakeContext(c, [entry, entry])
    assert with_counter(monkeypatch, dense, 8 * 3 * per).read(ctx) == 50.0
    assert with_counter(monkeypatch, dense, None).read(ctx) is None


@pytest.mark.parametrize("plans", [0, 1])
def test_dense_terms_and_knn_terms_make_flops(plans):
    c, d = small_dgcnn(), np.array([5, 2, 4])
    entry = {"clouds": 3, "d": d, "forwards": 2, "plans": plans}
    s2 = float((d ** 2).sum())
    knn = 2 * (2 * (4 * s2 if plans else 3 * s2 + 4 * s2) + plans * 3 * s2)
    assert (metric("dense_yield.attrib").dense_operations(c, entry) + knn
            == pytest.approx(ref_dgcnn.flops(c, entry)))


@pytest.mark.parametrize("plans", [0, 1])
def test_k3_distances_needed_by_hand(monkeypatch, plans):
    c = small_dgcnn()
    entries = [{"clouds": 2, "d": np.array([5, 2]), "forwards": 3,
                "plans": plans}]
    want = 3 * (2 - plans) * (25 + 4)
    k3 = metric("k3_distance_yield")
    assert k3.needed(c, entries) == want
    ctx = FakeContext(c, entries)
    assert with_counter(monkeypatch, k3, 4 * want).read(ctx) == 25.0


def test_k5_rows_needed_by_hand(monkeypatch):
    entry = {"forwards": 3, "balls": {
        "sa1": {"slots": [11, 4]}, "sa2": {"slots": [5]}}}
    k5 = metric("k5_row_yield")
    assert k5.needed([entry]) == 3 * (11 + 4 + 5)
    ctx = FakeContext({}, [entry])
    assert with_counter(monkeypatch, k5, 240).read(ctx) == 25.0


def test_plan_share():
    plan = metric("plan_share.attrib")
    ctx = FakeContext({}, [], FakeTrace({"iq_plan": [(0, 1)]}, busy_s=4.0,
                                        device_s=0.5))
    assert plan.read(ctx) == 12.5
    assert plan.read(FakeContext({}, [], FakeTrace({}, device_s=0.5))) is None


def test_engine_idle_by_hand():
    """Idle 0-10 and 20-40; engine spans 5-30 (mask) and 35-38 (to_host),
    a forward 8-25 inside the first: idle in the engine but not in the
    model is 5-8 and 25-30 and 35-38, 11 of a window of 50."""
    idle = metric("engine_idle_share.attrib")
    spans = {"iq_engine.mask": [(5, 30)], "iq_engine.to_host": [(35, 38)],
             "iq_forward": [(8, 25)], "iqbench.engine": [(0, 50)]}
    gaps = [(0, 10), (20, 40)]
    assert idle.engine_idle_ns(gaps, spans) == 11
    ctx = FakeContext({}, [], FakeTrace(spans, gaps=gaps, window=(0, 50)))
    assert idle.read(ctx) == 22.0
    assert idle.read(FakeContext({}, [], FakeTrace({"iq_forward": [(0, 1)]},
                                                   gaps=gaps))) is None


def test_interval_arithmetic():
    idle = metric("engine_idle_share.attrib")
    assert idle.union([(5, 7), (0, 2), (1, 3)]) == [(0, 3), (5, 7)]
    assert idle.intersect([(0, 4), (6, 9)], [(3, 7), (8, 20)]) == [
        (3, 4), (6, 7), (8, 9)]
    assert idle.subtract([(0, 10), (12, 14)], [(2, 3), (5, 13)]) == [
        (0, 2), (3, 5), (13, 14)]


# ------------------------------------------------------------- on the card
def masked_batch(cfg, device, orders=1, seed=3):
    """One chunk of the enumeration's masked clouds of a synthetic cloud:
    (masked (O (R+1), N, 3) on the device, keep rows, region ids)."""
    rng = np.random.RandomState(seed)
    pc, _ = inputs.synthetic_cloud(rng, cfg["num_points"], cfg["num_classes"], 1)
    region = inputs.region_ids(pc, inputs.fps_np(pc, cfg["num_regions"]))
    keep = work.enum_chunk_keep(inputs.orders(rng, orders, cfg["num_regions"]))
    masked = ref_attr.mask(torch.from_numpy(pc).to(device),
                           torch.from_numpy(keep).to(device),
                           torch.from_numpy(region).to(device))
    return masked, keep, region


def port_forward_traced(cfg, masked, plan: bool):
    """The port's eval forward of ``masked`` under a profiler of the card,
    its counters cleared first; the forward's plan made untraced."""
    from torch.profiler import ProfilerActivity, profile
    from interpret_quality_tpu_torch.models import build_model, make_forward_fn
    from interpret_quality_tpu_torch.ops.precision import set_matmul_precision
    from interpret_quality_tpu_torch.utils import profiling
    set_matmul_precision(cfg["precision"]["matmul_precision"])
    torch.manual_seed(0)
    fwd = make_forward_fn(build_model(cfg["family"], cfg["num_classes"],
                                      cfg.get("k", 20)).to(masked.device))
    with torch.no_grad():
        p = fwd.plan_fn(masked) if plan else None
        profiling.reset_counters()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            fwd.apply_plan_fn(masked, p)


@pytest.mark.cuda
@pytest.mark.parametrize("config,plan,readers", [
    ("dgcnn", False, ["dense_yield.attrib", "k3_distance_yield"]),
    ("dgcnn", True, ["dense_yield.attrib", "k3_distance_yield"]),
    ("pointnet2", True, ["k5_row_yield"])])
def test_port_yields_on_masked_clouds(card, config, plan, readers):
    """Each yield of one masked chunk through the port lies in (0, 100]:
    the numerator counts what the inputs need, the port's counter what it
    did."""
    cfg = harness.load_json(os.path.join(PKG, "configs", config + ".json"))
    masked, keep, region = masked_batch(cfg, card)
    port_forward_traced(cfg, masked, plan)
    entry = dict(work.chunk_counts(cfg, masked, keep, region), forwards=1,
                 plans=int(plan))
    for name in readers:
        value = metric(name).read(FakeContext(cfg, [entry]))
        assert value is not None and 0.0 < value <= 100.0, (name, value)
