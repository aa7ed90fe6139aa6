"""PCT's pieces of the benchmark: the reference's ``leaves`` against the
port's state dict (the tied Q/K weight one leaf under two names), its
``extra_counts`` and the operations behind ``mfu.attrib`` (``flops``)
against hand counts, kernel 10's frozen least time for a hand-sized
launch, the slot yield and the attention's share with and without what
they read; a sound run at small sizes on the CPU and the same run with
each fault of ``faults.py`` planted; and (marked ``cuda``) the three
readers of a traced plan and forward on the card, and the control failing
the cell's check where the program passes it."""
import os
import time

import numpy as np
import pytest
import torch

from iqbench import faults, harness, work
from iqbench.reference import pct as ref
from iqbench.reference import pointconv
from test_iqbench_counts import PEAKS
from test_iqbench_counts import FakeContext as RooflineContext
from test_iqbench_yields import FakeContext, FakeTrace, masked_batch

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "pct.enum_trans"
# the cell at 256 points with 128 and 64 centres, two orders a pose
SMALL = {"config": {"num_points": 256,
                    "sa1": {"npoint": 128, "nsample": 32, "mlp": [128, 128]},
                    "sa2": {"npoint": 64, "nsample": 32, "mlp": [256, 256]},
                    "assumed": {"shapley_batch_orders": 2}},
         "traffic": {"orders_per_pose": 2, "poses_per_call": 1,
                     "check_poses": 1}}


def metric(name):
    return harness.load_module(os.path.join(PKG, "metrics", name + ".py"),
                               "t_" + name.replace(".", "_"))


def config():
    return harness.load_json(os.path.join(PKG, "configs", "pct.json"))


def test_leaves_are_the_port_state_dict():
    """Every name and shape of the port's state dict, once; the tied Q/K
    weight one leaf with two names; 2,868,426 parameters at 10 classes."""
    from interpret_quality_tpu_torch.models import build_model
    cfg = config()
    sd = build_model("pct", cfg["num_classes"]).state_dict()
    names, params = {}, 0
    for leaf in ref.leaves(cfg):
        kind = leaf[2]
        for name in leaf[0]:
            if kind == "bn":
                for field in ("weight", "bias", "running_mean", "running_var"):
                    names[f"{name}.{field}"] = (leaf[1],)
                names[name + ".num_batches_tracked"] = ()
            else:
                names[name] = tuple(leaf[1])
        params += (2 * leaf[1] if kind == "bn" else
                   int(torch.Size(leaf[1]).numel()))
    assert names == {k: tuple(v.shape) for k, v in sd.items()}
    assert [leaf[0] for leaf in ref.leaves(cfg) if len(leaf[0]) > 1] == [
        [f"pt_last.sa{i}.q_conv.weight", f"pt_last.sa{i}.k_conv.weight"]
        for i in range(1, 5)]
    assert params == 2_868_426


def test_extra_counts_are_pointconv_group_counts():
    cfg = {"sa1": {"npoint": 6, "nsample": 3}, "sa2": {"npoint": 3, "nsample": 2}}
    g = torch.Generator().manual_seed(0)
    x = torch.rand(2, 10, 3, generator=g)
    x[1, 6:] = x[1, :6].mean(0)
    ident = torch.tensor([list(range(10)), list(range(6)) + [10] * 4])
    assert ref.extra_counts(cfg, x, ident) == {
        "groups": pointconv.group_counts(cfg, x, ident)}


def small_pct():
    return {"family": "pct", "reference": "iqbench/reference/pct.py",
            "num_points": 8, "num_classes": 2, "embed": [2, 3],
            "sa1": {"npoint": 4, "nsample": 3, "mlp": [4, 5]},
            "sa2": {"npoint": 2, "nsample": 2, "mlp": [6, 7]},
            "attention": {"channels": 8, "qk": 2, "layers": 2},
            "fuse": 9, "fc_widths": [4, 3]}


def pct_entry():
    g = {"sa1": {"centres": 7, "centres_sq": 25, "db": 15, "db_sq": 113,
                 "centres_db": 52, "slots": 11},
         "sa2": {"centres": 3, "centres_sq": 5, "db": 7, "db_sq": 25,
                 "centres_db": 11, "slots": 5}}
    return {"clouds": 2, "d": np.array([8, 7]), "forwards": 3, "plans": 1,
            "groups": g}


def test_flops_by_hand():
    c, e = small_pct(), pct_entry()
    embed = 15 * (3 * 2 + 2 * 3)
    # level 1: layer 1 hoisted on 15 rows and 7 centres of 3 features, then
    # 4 x 5 a distinct slot; level 2 on 7 rows and 3 centres of 5
    sa1 = (15 + 7) * 3 * 4 + 11 * 4 * 5
    sa2 = (7 + 3) * 5 * 6 + 5 * 6 * 7
    # pt_last's two convs 7 -> 8 -> 8 on 3 centres; per attention layer
    # Q (8 x 2), V and W_t (8 x 8) on 3 centres, energy (2) and x_r (8) on
    # 5 pairs; the fuse layer (2 x 8 + 7 -> 9) on 3 centres
    last = 3 * (7 * 8 + 8 * 8) + 2 * (3 * (8 * 2 + 2 * 8 * 8) + 5 * (2 + 8))
    fuse = 3 * (2 * 8 + 7) * 9
    head = 2 * (9 * 4 + 4 * 3 + 3 * 2)
    plan = 3 * (52 + 11)
    want = 2 * (3 * (embed + sa1 + sa2 + last + fuse + head) + plan)
    assert ref.flops(c, e) == want
    ctx = RooflineContext(c, [e, e], window_s=2.0)
    assert metric("mfu.attrib").read(ctx) == pytest.approx(100.0 * want)


@pytest.mark.parametrize("bound_by", ["bytes", "tensor_cores"])
def test_k10_least_time_by_hand(bound_by):
    c, e = small_pct(), pct_entry()
    # level 1: B=2, S=4, K=3, N=8 rows, widths 4 -> 5; level 2: S=2, K=2,
    # N=4 rows (level 1's centres), widths 6 -> 7
    b1 = 4 * (2 * 4 * 3 + 2 * 8 * 4 + 2 * 4 * 4 + 4 * 5 + 5 + 2 * 4 * 5)
    b2 = 4 * (2 * 2 * 2 + 2 * 4 * 6 + 2 * 2 * 6 + 6 * 7 + 7 + 2 * 2 * 7)
    t1, t2 = 2 * 11 * 4 * 5, 2 * 5 * 6 * 7
    peaks = dict(PEAKS, **{"bytes": {"hbm_bytes_per_s": 1e-6},
                           "tensor_cores": {"tf32_flops_per_s": 1e-6}}[bound_by])
    want = 3 * sum(max(b / peaks["hbm_bytes_per_s"],
                       3 * t / peaks["tf32_flops_per_s"])
                   for b, t in ((b1, t1), (b2, t2)))
    assert want == 3 * 1e6 * {"bytes": b1 + b2,
                              "tensor_cores": 3 * (t1 + t2)}[bound_by]
    ctx = RooflineContext(c, [e])
    ctx.peaks = peaks
    assert metric("k10_roofline").read(ctx) == pytest.approx(100.0 * want)


def test_k10_roofline_none_without_its_span_or_peaks():
    c, e = small_pct(), pct_entry()
    ctx = RooflineContext(c, [e], device_s=0.0)
    assert metric("k10_roofline").read(ctx) is None
    ctx = RooflineContext(c, [e])
    ctx.peaks = None
    assert metric("k10_roofline").read(ctx) is None


def test_k10_slot_yield_by_hand(monkeypatch):
    """Needed: 11 + 5 distinct slots a forward; done: the port's counter;
    None without it."""
    c, e = small_pct(), pct_entry()
    k10 = metric("k10_slot_yield")
    assert k10.needed([e, e]) == 2 * 3 * (11 + 5)
    monkeypatch.setattr(k10, "port_counter", lambda name: 4 * 2 * 3 * (11 + 5))
    assert k10.read(FakeContext(c, [e, e])) == pytest.approx(25.0)
    monkeypatch.setattr(k10, "port_counter", lambda name: None)
    assert k10.read(FakeContext(c, [e, e])) is None


def test_attention_share():
    share = metric("attention_share.attrib")
    ctx = FakeContext({}, [], FakeTrace({"iq_offset_attention": [(0, 1)]},
                                        busy_s=4.0, device_s=0.6))
    assert share.read(ctx) == pytest.approx(15.0)
    assert share.read(FakeContext({}, [], FakeTrace({"iq_plan": [(0, 1)]},
                                                    device_s=0.2))) is None


# ------------------------------------------------- small runs on the CPU
@pytest.fixture
def small_levels(monkeypatch):
    """The port's PCT at the small run's 128 and 64 centres."""
    from interpret_quality_tpu_torch.models import pct as port_pct
    monkeypatch.setattr(port_pct, "LEVELS", ((128, 32), (64, 32)))


def run(seed, trace=False):
    return harness.run_cell(CELL, seed, 0.3, trace, time.monotonic(),
                            device="cpu", overrides=SMALL)


def test_sound_run_is_correct_and_readers_find_nothing_on_the_cpu(small_levels):
    """A sound run passes its check; traced on the CPU (no device work, no
    kernel 10 launch), the three new readers return None and the line
    leaves them out."""
    got = run(2 ** 31 + 11)
    assert got["correct"], got["check"]
    assert set(got["metrics"]) == {"forwards_per_s", "setup_s"}
    traced = run(2 ** 31 + 12, trace=True)
    assert traced["correct"], traced["check"]
    assert not {"k10_roofline", "k10_slot_yield",
                "attention_share.attrib"} & set(traced["metrics"])


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_fault_is_not_correct(fault, small_levels):
    with faults.plant(fault):
        got = run(2 ** 31 + 13)
    assert not got["correct"], got["check"]


# ------------------------------------------------------------- on the card
@pytest.mark.cuda
def test_readers_of_a_traced_plan_and_forward(card):
    """One masked chunk's plan and forward through the port under the
    benchmark's window span: each of the three readers finds what it reads
    and reads within (0, 100]."""
    from torch.profiler import record_function
    from interpret_quality_tpu_torch.models import build_model, make_forward_fn
    from interpret_quality_tpu_torch.ops.precision import set_matmul_precision
    from interpret_quality_tpu_torch.utils import profiling
    from iqbench import trace as trace_mod
    cfg = config()
    masked, keep, region = masked_batch(cfg, card)
    set_matmul_precision(cfg["precision"]["matmul_precision"])
    torch.manual_seed(0)
    fwd = make_forward_fn(build_model("pct", cfg["num_classes"]).to(card).eval())
    with torch.no_grad():
        fwd.apply_plan_fn(masked, fwd.plan_fn(masked))      # built and warm
        torch.cuda.synchronize()
        profiling.reset_counters()
        prof = trace_mod.start(card)
        with record_function(trace_mod.WINDOW):
            fwd.apply_plan_fn(masked, fwd.plan_fn(masked))
            torch.cuda.synchronize()
    ctx = FakeContext(cfg, [dict(work.chunk_counts(cfg, masked, keep, region),
                                 forwards=1, plans=1)], trace_mod.summarize(prof))
    ctx.peaks = harness.load_json(os.path.join(PKG, "peaks.json")).get(
        torch.cuda.get_device_name(0))
    names = ["k10_slot_yield", "attention_share.attrib"]
    if ctx.peaks is not None:
        names.append("k10_roofline")
    try:
        for name in names:
            value = metric(name).read(ctx)
            assert value is not None and 0.0 < value <= 100.0, (name, value)
    finally:
        profiling.reset_counters()


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2 ** 31 + 101, 2 ** 31 + 202])
def test_control_fails_and_program_passes(seed, card):
    """The cell at its own sizes with a run's window: the program passes
    the check, the control (TF32 products, bfloat16 reward and marginals)
    fails it."""
    cell = harness.Cell(CELL)
    harness.prepare_environment(cell.cfg)
    harness.set_port_precision(cell.cfg)
    ctx = harness.Context(cell, seed, card)
    driver = ctx.driver = cell.driver_class()(ctx)
    driver.warmup()
    deadline = time.perf_counter() + cell.bench["run_seconds"]
    driver.step()
    while time.perf_counter() < deadline:
        driver.step()
    driver.finish()
    driver.release()
    program = harness.readings(driver, lambda s: s["program"], cell.limits)
    control = harness.readings(driver, lambda s: driver.reference(s, True),
                               cell.limits)
    assert all(program[n] <= cell.limits[n] for n in cell.limits), program
    assert any(control[n] > cell.limits[n] for n in cell.limits), control
