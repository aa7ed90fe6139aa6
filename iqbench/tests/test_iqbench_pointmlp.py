"""PointMLP's pieces of the benchmark: the reference's ``leaves`` against
the port's state dict, its ``extra_counts`` and the operations behind
``mfu.attrib`` (``flops``) against hand counts, kernel 11's frozen least
time for a hand-sized launch, the slot yield and the standard deviation's
share with and without what they read; a sound run at small sizes on the
CPU and the same run with each fault of ``faults.py`` planted; and (marked
``cuda``) the three readers of a traced plan and forward on the card, and
the control failing the cell's check where the program passes it."""
import os
import time

import numpy as np
import pytest
import torch

from iqbench import faults, harness, work
from iqbench.reference import pointconv
from iqbench.reference import pointmlp as ref
from test_iqbench_counts import PEAKS
from test_iqbench_counts import FakeContext as RooflineContext
from test_iqbench_yields import FakeContext, FakeTrace, masked_batch

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "pointmlp.enum_trans"
# the cell at 256 points (anchors 128, 64, 32 and 16), two orders a pose
SMALL = {"config": {"num_points": 256,
                    "stages": [{"anchors": 128, "k": 24, "width": 128},
                               {"anchors": 64, "k": 24, "width": 256},
                               {"anchors": 32, "k": 24, "width": 512},
                               {"anchors": 16, "k": 24, "width": 1024}],
                    "assumed": {"shapley_batch_orders": 2}},
         "traffic": {"orders_per_pose": 2, "poses_per_call": 1,
                     "check_poses": 1}}


def metric(name):
    return harness.load_module(os.path.join(PKG, "metrics", name + ".py"),
                               "t_" + name.replace(".", "_"))


def config():
    return harness.load_json(os.path.join(PKG, "configs", "pointmlp.json"))


def test_leaves_are_the_port_state_dict():
    """Every name and shape of the port's state dict, once; 13,230,794
    parameters at 10 classes."""
    from interpret_quality_tpu_torch.models import build_model
    cfg = config()
    sd = build_model("pointmlp", cfg["num_classes"]).state_dict()
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
    assert params == 13_230_794


def test_stage_counts_by_hand():
    """Two clouds of 8 points, stages of 4 anchors of 3 and 2 of 2; cloud 1
    has points 5-7 collapsed onto point 4: the distinct anchors, rows and
    slots are those of pointconv.group_counts on the same stages."""
    cfg = {"stages": [{"anchors": 4, "k": 3}, {"anchors": 2, "k": 2}]}
    g = torch.Generator().manual_seed(0)
    x = torch.rand(2, 8, 3, generator=g)
    x[1, 5:] = x[1, 4]
    ident = torch.tensor([list(range(8)), list(range(5)) + [4] * 3])
    got = ref.extra_counts(cfg, x, ident)["stages"]
    want = pointconv.group_counts(
        {"sa1": {"npoint": 4, "nsample": 3}, "sa2": {"npoint": 2, "nsample": 2}},
        x, ident)
    for counts, level in zip(got, ("sa1", "sa2")):
        assert counts == {k: want[level][k]
                          for k in ("centres", "db", "centres_db", "slots")}
    assert got[0]["db"] == 8 + 5 and got[0]["centres"] <= 4 + 4


def small_pointmlp():
    return {"family": "pointmlp", "reference": "iqbench/reference/pointmlp.py",
            "num_points": 8, "num_classes": 2, "embed": 3,
            "stages": [{"anchors": 4, "k": 3, "width": 4},
                       {"anchors": 2, "k": 2, "width": 6}],
            "pre_blocks": [2, 1], "pos_blocks": [1, 2], "fc_widths": [5, 3]}


def pointmlp_entry():
    st = [{"centres": 7, "db": 15, "centres_db": 52, "slots": 11},
          {"centres": 3, "db": 7, "centres_db": 11, "slots": 5}]
    return {"clouds": 2, "d": np.array([8, 7]), "forwards": 3, "plans": 1,
            "stages": st}


def test_flops_by_hand():
    c, e = small_pointmlp(), pointmlp_entry()
    embed = 15 * 3 * 3
    # stage 1 (3 -> 4): the transfer hoisted on 15 rows and 7 anchors, two
    # pre-blocks (4 products of 4 x 4) on 11 slots, one pos-block on 7
    s1 = (15 + 7) * 3 * 4 + 11 * 4 * 16 + 7 * 2 * 16
    # stage 2 (4 -> 6): on 7 rows and 3 anchors, one pre-block on 5 slots,
    # two pos-blocks on 3 anchors
    s2 = (7 + 3) * 4 * 6 + 5 * 2 * 36 + 3 * 4 * 36
    head = 2 * (6 * 5 + 5 * 3 + 3 * 2)
    plan = 3 * (52 + 11)
    want = 2 * (3 * (embed + s1 + s2 + head) + plan)
    assert ref.flops(c, e) == want
    ctx = RooflineContext(c, [e, e], window_s=2.0)
    assert metric("mfu.attrib").read(ctx) == pytest.approx(100.0 * want)


@pytest.mark.parametrize("bound_by", ["bytes", "tensor_cores"])
def test_k11_least_time_by_hand(bound_by):
    c, e = small_pointmlp(), pointmlp_entry()
    # stage 1: B=2, S=4, K=3, N=8 rows, C=4; stage 2: S=2, K=2, N=4 rows
    # (stage 1's anchors), C=6; indices and centres' rows, u, c, the scale,
    # four products and shifts, the output
    b1 = 4 * (2 * 4 * 3 + 2 * 4 + 2 * 8 * 4 + 2 * 4 * 4 + 2 + 4 * 16 + 4 * 4
              + 2 * 4 * 4)
    b2 = 4 * (2 * 2 * 2 + 2 * 2 + 2 * 4 * 6 + 2 * 2 * 6 + 2 + 4 * 36 + 4 * 6
              + 2 * 2 * 6)
    t1, t2 = 2 * 11 * 4 * 16, 2 * 5 * 4 * 36
    peaks = dict(PEAKS, **{"bytes": {"hbm_bytes_per_s": 1e-6},
                           "tensor_cores": {"tf32_flops_per_s": 1e-6}}[bound_by])
    want = 3 * sum(max(b / peaks["hbm_bytes_per_s"],
                       3 * t / peaks["tf32_flops_per_s"])
                   for b, t in ((b1, t1), (b2, t2)))
    assert want == 3 * 1e6 * {"bytes": b1 + b2,
                              "tensor_cores": 3 * (t1 + t2)}[bound_by]
    ctx = RooflineContext(c, [e])
    ctx.peaks = peaks
    assert metric("k11_roofline").read(ctx) == pytest.approx(100.0 * want)


def test_k11_roofline_none_without_its_span_or_peaks():
    c, e = small_pointmlp(), pointmlp_entry()
    ctx = RooflineContext(c, [e], device_s=0.0)
    assert metric("k11_roofline").read(ctx) is None
    ctx = RooflineContext(c, [e])
    ctx.peaks = None
    assert metric("k11_roofline").read(ctx) is None


def test_k11_slot_yield_by_hand(monkeypatch):
    """Needed: 11 + 5 distinct slots a forward; done: the port's counter;
    None without it."""
    c, e = small_pointmlp(), pointmlp_entry()
    k11 = metric("k11_slot_yield")
    assert k11.needed([e, e]) == 2 * 3 * (11 + 5)
    monkeypatch.setattr(k11, "port_counter", lambda name: 4 * 2 * 3 * (11 + 5))
    assert k11.read(FakeContext(c, [e, e])) == pytest.approx(25.0)
    monkeypatch.setattr(k11, "port_counter", lambda name: None)
    assert k11.read(FakeContext(c, [e, e])) is None


def test_group_std_share():
    share = metric("group_std_share.attrib")
    ctx = FakeContext({}, [], FakeTrace({"iq_group_std": [(0, 1)]},
                                        busy_s=4.0, device_s=0.2))
    assert share.read(ctx) == pytest.approx(5.0)
    assert share.read(FakeContext({}, [], FakeTrace({"iq_plan": [(0, 1)]},
                                                    device_s=0.2))) is None


# ------------------------------------------------- small runs on the CPU
@pytest.fixture
def small_points(monkeypatch):
    """The port's PointMLP at the small run's 256 points."""
    from interpret_quality_tpu_torch.models import pointmlp as port
    monkeypatch.setattr(port, "POINTS", 256)


def run(seed, trace=False):
    return harness.run_cell(CELL, seed, 0.3, trace, time.monotonic(),
                            device="cpu", overrides=SMALL)


def test_sound_run_is_correct_and_readers_find_nothing_on_the_cpu(small_points):
    """A sound run passes its check; traced on the CPU (no device work, no
    kernel 11 launch), the three new readers return None and the line
    leaves them out."""
    got = run(2 ** 31 + 11)
    assert got["correct"], got["check"]
    assert set(got["metrics"]) == {"forwards_per_s", "setup_s"}
    traced = run(2 ** 31 + 12, trace=True)
    assert traced["correct"], traced["check"]
    assert not {"k11_roofline", "k11_slot_yield",
                "group_std_share.attrib"} & set(traced["metrics"])


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_fault_is_not_correct(fault, small_points):
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
    fwd = make_forward_fn(build_model("pointmlp", cfg["num_classes"])
                          .to(card).eval())
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
    names = ["k11_slot_yield", "group_std_share.attrib"]
    if ctx.peaks is not None:
        names.append("k11_roofline")
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
