"""The port's spans and work counters (``utils.profiling``) on the CPU.

Under a ``torch.profiler`` the engines' stages, the forwards and the plans
run inside their ``iq_*`` spans, in order, and the work counters count;
outside a profiler nothing counts and no kernel is handed a counter.  The
kernels' counters are checked here against a stand-in launcher (the CPU
cannot run them); ``tests/test_torch_cuda.py`` checks them on the card.
"""
import ctypes

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from interpret_quality_tpu_torch.attrib.interactions import InteractionEngine
from interpret_quality_tpu_torch.attrib.perturbations import MODES
from interpret_quality_tpu_torch.attrib.shapley import ShapleyEngine
from interpret_quality_tpu_torch.models import build_model, make_forward_fn
from interpret_quality_tpu_torch.models.pointmlp import PointMLP
from interpret_quality_tpu_torch.ops import precision
from interpret_quality_tpu_torch.ops.cuda import group_mlp as gm
from interpret_quality_tpu_torch.ops.cuda import groups as gr
from interpret_quality_tpu_torch.ops.cuda import knn_group as kg
from interpret_quality_tpu_torch.ops.cuda import launch
from interpret_quality_tpu_torch.ops.cuda import neighbors as nb
from interpret_quality_tpu_torch.utils import profiling

N, R, K = 64, 4, 4


@pytest.fixture(autouse=True)
def clean_counters():
    profiling.reset_counters()
    yield
    profiling.reset_counters()


def cloud(seed=0, n=N):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, 3).astype(np.float32) - 0.5,
            rng.randint(0, R, n).astype(np.int32))


def dgcnn():
    torch.manual_seed(0)
    return make_forward_fn(build_model("dgcnn", 10, K))


def traced(fn):
    """fn() under a CPU profiler inside a span ``call``: (result, the
    ``iq_*`` events in order of start)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("call"):
            out = fn()
    events = sorted((e for e in prof.events() if e.name.startswith("iq_")),
                    key=lambda e: e.time_range.start)
    return out, events


def parents(event):
    out, p = [], event.cpu_parent
    while p is not None:
        out.append(p.name)
        p = p.cpu_parent
    return out


def stage_names(events):
    """The names of the spans no other ``iq_`` span contains."""
    return [e.name for e in events
            if not any(p.startswith("iq_") for p in parents(e))]


def check_forwards(events):
    """Every forward runs inside the engine's call and outside the
    engine's own stages."""
    forwards = [e for e in events if e.name == "iq_forward"]
    assert forwards
    for e in forwards:
        chain = parents(e)
        assert "call" in chain
        assert not any(p.startswith("iq_engine.") for p in chain)


def test_tracing_follows_the_profiler():
    assert not profiling.tracing()
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.tracing()
    with torch.autograd.profiler.profile():
        assert profiling.tracing()
    assert not profiling.tracing()


def test_enum_all_poses_plan_spans():
    """Per call the inputs' upload, per chunk its keep matrix, its masked
    batch and its plan, per chunk and pose the pose's batch, the forward
    and the marginals, and one copy to the host, in that order."""
    fwd = dgcnn()
    data, region = cloud()
    orders = np.stack([np.random.RandomState(s).permutation(R) for s in range(3)])
    params = np.array([[0.0, 0.0, 0.0], [0.1, -0.2, 0.05]], np.float32)
    engine = ShapleyEngine(fwd, R, "modified", batch_orders=2, device="cpu")
    (sv, logits), events = traced(lambda: engine.enum_all_poses_plan(
        MODES["trans"].disturb_fn, data, params, 3, region, orders,
        fwd.plan_fn, fwd.apply_plan_fn))
    assert sv.shape == (2, R) and logits.shape == (2, 3 * (R + 1), 10)
    chunk = ["iq_engine.keep", "iq_engine.mask", "iq_plan"] + [
        "iq_engine.mask", "iq_forward", "iq_engine.marginals"] * 2
    assert stage_names(events) == ["iq_engine.keep"] + chunk * 2 + [
        "iq_engine.to_host"]
    check_forwards(events)


def test_enum_all_poses_spans():
    """Without a plan: the inputs' and every chunk's upload first, then per
    pose its posed cloud and per chunk its batch, forward and marginals."""
    fwd = dgcnn()
    data, region = cloud()
    orders = np.stack([np.random.RandomState(s).permutation(R) for s in range(3)])
    params = np.array([[0.0, 0.0, 0.0], [0.1, -0.2, 0.05]], np.float32)
    engine = ShapleyEngine(fwd, R, "modified", batch_orders=2, device="cpu")
    (sv, logits), events = traced(lambda: engine.enum_all_poses(
        MODES["trans"].disturb_fn, data, params, 3, region, orders))
    assert sv.shape == (2, R) and logits.shape == (2, 3 * (R + 1), 10)
    pose = ["iq_engine.mask"] + [
        "iq_engine.mask", "iq_forward", "iq_engine.marginals"] * 2
    assert stage_names(events) == ["iq_engine.keep"] * 3 + pose * 2 + [
        "iq_engine.to_host"]
    check_forwards(events)


def test_shapley_for_poses_spans():
    """The poses' upload, each pose's ``shapley_for_pose`` stages, then the
    stacking of the host results."""
    fwd = dgcnn()
    data, region = cloud(4)
    orders = np.stack([np.random.RandomState(s).permutation(R) for s in range(2)])
    engine = ShapleyEngine(fwd, R, "modified", batch_orders=2, device="cpu")
    (sv, logits), events = traced(lambda: engine.shapley_for_poses(
        np.stack([data, data + 0.1]), 1, region, orders))
    assert sv.shape == (2, R) and logits.shape == (2, 2 * (R + 1), 10)
    pose = ["iq_engine.keep", "iq_engine.keep", "iq_engine.mask", "iq_forward",
            "iq_engine.marginals", "iq_engine.to_host"]
    assert stage_names(events) == ["iq_engine.keep"] + pose * 2 + [
        "iq_engine.to_host"]


def test_shapley_for_pose_spans():
    fwd = dgcnn()
    data, region = cloud(1)
    orders = np.stack([np.random.RandomState(s).permutation(R) for s in range(5)])
    engine = ShapleyEngine(fwd, R, "modified", batch_orders=2, device="cpu")
    sv, events = traced(lambda: engine.shapley_for_pose(data, 2, region, orders))
    assert sv.shape == (R,)
    chunk = ["iq_engine.keep", "iq_engine.mask", "iq_forward",
             "iq_engine.marginals"]
    assert stage_names(events) == ["iq_engine.keep"] + chunk * 3 + [
        "iq_engine.to_host"]
    check_forwards(events)


def test_logits_for_pairs_spans():
    """One upload of the keep masks, per chunk its masked batch and its
    forward, one copy to the host; no reward, so no marginals."""
    fwd = dgcnn()
    data, region = cloud(2)
    pairs = np.array([[0, 1], [1, 3]])
    contexts = np.array([[[2], [3], [0]], [[0], [2], [0]]])
    engine = InteractionEngine(fwd, R, batch_contexts=4, device="cpu")
    logits, events = traced(lambda: engine.logits_for_pairs(
        data, region, pairs, contexts))
    assert logits.shape == (2, 12, 10)
    assert stage_names(events) == ["iq_engine.keep"] + [
        "iq_engine.mask", "iq_forward"] * 2 + ["iq_engine.to_host"]
    check_forwards(events)


def test_forward_fn_spans():
    """A forward with no plan is one ``iq_forward``; a plan one ``iq_plan``
    that holds no forward."""
    fwd = dgcnn()
    x = torch.from_numpy(cloud(3)[0])[None]
    _, events = traced(lambda: (fwd(x), fwd.apply_plan_fn(x, None),
                                fwd.apply_plan_fn(x, fwd.plan_fn(x))))
    assert stage_names(events) == ["iq_forward", "iq_forward", "iq_plan",
                                   "iq_forward"]


def dgcnn_operations(B, n):
    """2 x rows x in x out of every product a DGCNN eval forward runs
    through ``matmul`` on the CPU: two hoisted products per edge conv on
    every point, the plain kNN's inner products (B n^2 C a layer; on the
    card kernel 3 computes them), conv5 and the head."""
    ops, c = 0, 3
    for f in (64, 64, 128, 256):
        ops += 2 * (2 * B * n * c * f) + 2 * B * n * n * c
        c = f
    ops += 2 * B * n * 512 * 1024
    ops += 2 * B * (2048 * 512 + 512 * 256 + 256 * 10)
    return ops


def pointnet2_operations(B, n):
    """The same for PointNet++ MSG: each branch's ball query (its inner
    products, B S N 3), SA2's hoisted feature rows (320 x C1 a point),
    the group-all level's three layers on SA2's centres and the head; the
    plain ball branches' own products run through ``torch.matmul``."""
    ops = 3 * 2 * B * 512 * n * 3                       # SA1 ball queries
    ops += 3 * 2 * B * 128 * 512 * 3                    # SA2 ball queries
    ops += 2 * B * 512 * 320 * (64 + 128 + 128)         # SA2 hoisted rows
    ops += 2 * B * 128 * (643 * 256 + 256 * 512 + 512 * 1024)
    ops += 2 * B * (1024 * 512 + 512 * 256 + 256 * 10)
    return ops


@pytest.mark.parametrize("family", ["dgcnn", "pointnet2"])
def test_dense_products_by_hand(family):
    torch.manual_seed(0)
    model = build_model(family, 10, 20)
    B, n = 2, (N if family == "dgcnn" else 600)
    x = torch.rand(B, n, 3, generator=torch.Generator().manual_seed(1)) - 0.5
    with torch.no_grad():
        model(x)                                    # untraced: counts nothing
        assert profiling.counters() == {}
        with profile(activities=[ProfilerActivity.CPU]):
            model(x)
    want = (dgcnn_operations(B, n) if family == "dgcnn"
            else pointnet2_operations(B, n))
    assert profiling.counters() == {precision.DENSE_PRODUCTS: want}


def test_product_operations_broadcast():
    f = precision.product_operations
    assert f(torch.zeros(4, 5, 3), torch.zeros(3, 7)) == 2 * 20 * 3 * 7
    assert f(torch.zeros(2, 1, 5, 3), torch.zeros(4, 3, 7)) == 2 * 8 * 5 * 3 * 7
    assert f(torch.zeros(2, 3), torch.zeros(3)) == 2 * 2 * 3


def test_nothing_counts_outside_a_profiler():
    """An untraced enumeration counts nothing and makes no accumulator."""
    fwd = dgcnn()
    data, region = cloud()
    orders = np.stack([np.random.RandomState(s).permutation(R) for s in range(2)])
    engine = ShapleyEngine(fwd, R, "modified", batch_orders=2, device="cpu")
    engine.enum_all_poses_plan(MODES["trans"].disturb_fn, data,
                               np.zeros((1, 3), np.float32), 0, region, orders,
                               fwd.plan_fn, fwd.apply_plan_fn)
    profiling.count("anything", 5)
    assert profiling.counters() == {}
    assert profiling._DEVICE_COUNTS == {}


def test_counters_add_and_reset():
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count("a", 3)
        profiling.count("a", 4)
        profiling.accumulator("b", "cpu").add_(torch.tensor(5, dtype=torch.int32))
        profiling.accumulator("b", torch.device("cpu")).add_(6)
        profiling.accumulator("c", "cpu").add_(2)
    assert profiling.counters() == {"a": 7, "b": 11, "c": 2}
    profiling.reset_counters()
    assert profiling.counters() == {}


class StandIn:
    """A launcher that records its arguments and returns success; ``act``
    runs on them first (to write what the kernel would)."""

    def __init__(self, act=None):
        self.calls, self.act = [], act

    def __call__(self, *args):
        self.calls.append(args)
        if self.act is not None:
            self.act(args)
        return 0


def stand_in(monkeypatch, module, name, act=None):
    launcher = StandIn(act)
    lib = type("Lib", (), {})()
    setattr(lib, name, launcher)
    monkeypatch.setattr(module, "_lib", lambda: lib)
    monkeypatch.setattr(module, "on_cpu", lambda *t: False)
    monkeypatch.setattr(module, "stream", lambda t: 0)
    return launcher


def ball_args():
    g = torch.Generator().manual_seed(0)
    C1, C2, C3 = 32, 32, 64
    w = [torch.rand(C1, generator=g), torch.rand(3, C1, generator=g),
         torch.rand(C1, C2, generator=g), torch.rand(C2, generator=g),
         torch.rand(C2, C3, generator=g), torch.rand(C3, generator=g)]
    xyz = torch.rand(2, 32, 3, generator=g)
    return (xyz[:, :8].contiguous(), xyz, None, *w)


def test_kernel5_gets_a_counter_only_while_tracing(monkeypatch):
    """The launcher's row, tile and wait counters: None untraced; traced,
    each counter's accumulator, into which the kernel adds (here the
    stand-in adds 7 rows, 3 tiles and 1 wait)."""
    def add_counts(args):
        for at, n in zip(args[11:14], (7, 3, 1)):
            if at is not None:
                (ctypes.c_longlong * 1).from_address(at)[0] += n
    launcher = stand_in(monkeypatch, gr, "iq_ball_mlp3", add_counts)
    gr.fused_ball_mlp3(*ball_args(), radius=0.3, k=8)
    assert launcher.calls[-1][11:14] == (None, None, None)
    assert profiling.counters() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        gr.fused_ball_mlp3(*ball_args(), radius=0.3, k=8)
        gr.fused_ball_mlp3(*ball_args(), radius=0.3, k=8)
    names = (gr.K5_ROWS, gr.K5_TILES, gr.K5_FRONT_WAITS)
    assert launcher.calls[-1][11:14] == tuple(
        profiling.accumulator(name, "cpu").data_ptr() for name in names)
    assert profiling.counters() == {gr.K5_ROWS: 14, gr.K5_TILES: 6,
                                    gr.K5_FRONT_WAITS: 2}


def test_kernel3_counts_distinct_rows_times_database_rows(monkeypatch):
    """From the distinct rows a launch leaves in its scratch (the stand-in
    writes 5 and 9 for the two clouds): 5^2 + 9^2, each cloud's distinct
    query rows times the distinct database rows the kernel scans for each;
    and the tie path's counter, None untraced, traced the accumulator into
    which the kernel adds (here the stand-in adds 3).  Nothing untraced."""
    B, n = 2, 16

    def write_counts(args):
        (ctypes.c_int * (B * (2 * n + 1))).from_address(args[4])[2 * B * n:] = [5, 9]
        if args[5] is not None:
            (ctypes.c_longlong * 1).from_address(args[5])[0] += 3
    launcher = stand_in(monkeypatch, nb, "iq_knn_gather_extrema", write_counts)
    xs = torch.rand(B, n, 3)
    a = torch.rand(B, n, 8)
    nb.knn_gather_extrema(xs, a, 4)
    assert launcher.calls[-1][5] is None
    assert profiling.counters() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        nb.knn_gather_extrema(xs, a, 4)
    assert len(launcher.calls) == 2
    assert launcher.calls[-1][5] == profiling.accumulator(nb.K3_TIE_ROWS,
                                                          "cpu").data_ptr()
    assert profiling.counters() == {nb.K3_DISTANCES: 5 * 5 + 9 * 9,
                                    nb.K3_TIE_ROWS: 3}


def test_density_runs_in_its_span():
    """PointConv's KDE density is one ``iq_density`` span a call, inside
    the plan and in no forward on a plan."""
    torch.manual_seed(0)
    fwd = make_forward_fn(build_model("pointconv", 10))
    x = torch.from_numpy(cloud(5, n=96)[0])[None]
    with torch.no_grad():
        plan, events = traced(lambda: fwd.plan_fn(x))
        _, forward_events = traced(lambda: fwd.apply_plan_fn(x, plan))
    density = [e for e in events if e.name == "iq_density"]
    assert len(density) == 3
    assert all("iq_plan" in parents(e) for e in density)
    assert not [e for e in forward_events if e.name == "iq_density"]


def test_kernel10_runs_in_its_span_and_counts_slots_while_tracing(monkeypatch):
    """Each launch of ``knn_group_max`` runs in one ``iq_knn_group_max``
    span and counts once in the launch registry; traced, ``k10_slots``
    counts B x S x K a launch (every centre, repeated ones too), untraced
    nothing."""
    launcher = stand_in(monkeypatch, kg, "iq_knn_group_max")
    g = torch.Generator().manual_seed(0)
    B, S, N, C1, C2 = 2, 5, 40, 64, 256
    args = (torch.randint(0, N, (B, S, kg.SLOTS), generator=g,
                          dtype=torch.int32),
            torch.rand(B, N, C1, generator=g), torch.rand(B, S, C1, generator=g),
            torch.rand(C1, C2, generator=g), torch.rand(C2, generator=g))
    before = launch.launches("knn_group_max")["knn_group_max"]
    assert kg.knn_group_max(*args).shape == (B, S, C2)
    assert launcher.calls[-1][7:14] == (B, S, N, kg.SLOTS, C1, C2, 0)
    assert profiling.counters() == {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        kg.knn_group_max(*args)
        kg.knn_group_max(*args)
    assert [e.name for e in prof.events()].count("iq_knn_group_max") == 2
    assert profiling.counters() == {kg.K10_SLOTS: 2 * B * S * kg.SLOTS}
    assert launch.launches("knn_group_max")["knn_group_max"] == before + 3


def test_offset_attention_runs_in_its_span():
    """PCT's four offset-attention layers are one ``iq_offset_attention``
    span each, inside the forward and not in the plan."""
    torch.manual_seed(0)
    model = build_model("pct", 10)
    model.levels = ((48, 32), (32, 32))
    fwd = make_forward_fn(model)
    x = torch.from_numpy(cloud(5, n=96)[0])[None]
    with torch.no_grad():
        plan, plan_events = traced(lambda: fwd.plan_fn(x))
        _, events = traced(lambda: fwd.apply_plan_fn(x, plan))
    attention = [e for e in events if e.name == "iq_offset_attention"]
    assert len(attention) == 4
    assert all("iq_forward" in parents(e) for e in attention)
    assert not [e for e in plan_events if e.name == "iq_offset_attention"]


def test_kernel11_runs_in_its_span_and_counts_slots_while_tracing(monkeypatch):
    """Each launch of ``group_res_mlp`` runs in one ``iq_group_res_mlp``
    span and counts once in the launch registry; traced, ``k11_slots``
    counts B x S x K a launch (every centre, repeated ones too), untraced
    nothing."""
    launcher = stand_in(monkeypatch, gm, "iq_group_res_mlp")
    monkeypatch.setattr(gm, "capacity", lambda C, code, device: 3)
    g = torch.Generator().manual_seed(0)
    B, S, N, C = 2, 5, 40, 128
    blocks = [tuple(torch.rand(*shape, generator=g)
                    for shape in ((C, C), (C,), (C, C), (C,)))
              for _ in range(2)]
    args = (torch.randint(0, N, (B, S, gm.SLOTS), generator=g,
                          dtype=torch.int32),
            torch.randint(0, N, (B, S), generator=g, dtype=torch.int32),
            torch.rand(B, N, C, generator=g), torch.rand(B, S, C, generator=g),
            torch.rand(B, generator=g), blocks)
    before = launch.launches("group_res_mlp")["group_res_mlp"]
    assert gm.group_res_mlp(*args).shape == (B, S, C)
    assert launcher.calls[-1][9:16] == (3, B, S, N, gm.SLOTS, C, 0)
    assert profiling.counters() == {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        gm.group_res_mlp(*args)
        gm.group_res_mlp(*args)
    assert [e.name for e in prof.events()].count("iq_group_res_mlp") == 2
    assert profiling.counters() == {gm.K11_SLOTS: 2 * B * S * gm.SLOTS}
    assert launch.launches("group_res_mlp")["group_res_mlp"] == before + 3


def test_group_std_runs_in_its_span():
    """PointMLP's four per-cloud standard deviations are one
    ``iq_group_std`` span each, inside the forward and not in the plan."""
    torch.manual_seed(0)
    fwd = make_forward_fn(PointMLP(10, points=192).eval())
    x = torch.from_numpy(cloud(5, n=192)[0])[None]
    with torch.no_grad():
        plan, plan_events = traced(lambda: fwd.plan_fn(x))
        _, events = traced(lambda: fwd.apply_plan_fn(x, plan))
    spans = [e for e in events if e.name == "iq_group_std"]
    assert len(spans) == 4
    assert all("iq_forward" in parents(e) for e in spans)
    assert not [e for e in plan_events if e.name == "iq_group_std"]
