"""The coalition split over devices (``parallel.mesh``) and the stage
traces, on the CPU.

The JAX package's sharding tests run on a virtual 8-device CPU mesh
(``tests/test_sharding.py``); the port's split runs on a device list that
names the CPU 2 or 3 times, which takes the same code path as a split over
cards: the batch is cut with ``torch.tensor_split`` (no padding), each part
runs on its own replica of the model, and the logits come back in order on
the first device.  The batches (orders x (R + 1) rows, 4 rows a cell) are
chosen not to divide evenly.

Every kernel and every eval BatchNorm works per cloud, so a part's rows
never see another part's.  What a row's logits do depend on is the row
count of the dense layers' matrices: the CPU's BLAS picks its kernel, and
with it the order of a dot product's sums, by the shape (a product of 20
rows and of 10 differs in the last bits of most values; one row takes a
matrix-vector kernel).  So the split is held in two ways:

  * *equal* to the unsplit forward of the same parts, concatenated
    (``per_part``): the split adds no arithmetic of its own, and a
    difference there is a fault;
  * within ``F32_TOL`` of the unsplit run on the whole batch, the JAX
    sharding tests' tolerance, through the stages (init, the plan-path
    enumeration, interactions, a smoothness epoch), each of which must
    have gone through the split.
"""
import json
import os

import numpy as np
import pytest
import torch

from interpret_quality_tpu_torch.attrib import smoothness as tsm
from interpret_quality_tpu_torch.attrib import stages
from interpret_quality_tpu_torch.attrib.interactions import InteractionEngine
from interpret_quality_tpu_torch.attrib.shapley import ShapleyEngine
from interpret_quality_tpu_torch.config import ExperimentConfig
from interpret_quality_tpu_torch.models import build_model, make_forward_fn
from interpret_quality_tpu_torch.parallel import (SplitForward,
                                                  coalition_split, make_mesh)
from interpret_quality_tpu_torch.pipeline import split_forward

from test_torch_checkpoint import seeded_state

CPU = torch.device("cpu")
POINTS, REGIONS = 64, 4          # 5 rows an order


def cfg_for(model, root, **kw):
    return ExperimentConfig(model=model, checkpoints_root=root,
                            num_points=POINTS, num_regions=REGIONS,
                            device="cpu", **kw)


def test_make_mesh_semantics(monkeypatch):
    assert make_mesh(devices=["cpu", "cpu"]) == [CPU, CPU]
    if not torch.cuda.is_available():
        for call in (lambda: make_mesh(), lambda: make_mesh(1),
                     lambda: make_mesh(devices=["cuda:0"])):
            with pytest.raises(RuntimeError, match="visible"):
                call()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cuda = [torch.device("cuda", i) for i in range(2)]
    assert make_mesh() == cuda and make_mesh(2) == cuda
    assert make_mesh(1) == cuda[:1]
    for n in (0, 3):                     # no silent shrink, no CPU
        with pytest.raises(RuntimeError, match="2 are visible"):
            make_mesh(n)
    with pytest.raises(RuntimeError, match="visible"):
        make_mesh(devices=["cuda:2"])


def test_split_from_args():
    """--mesh_devices 0 (the default) is one device and no split; with
    --device cpu a count is a virtual split on the CPU."""
    from interpret_quality_tpu_torch.cli.common import (base_parser,
                                                        split_from_args)
    p = base_parser("t")
    assert split_from_args(p.parse_args([])) is None
    assert split_from_args(p.parse_args(["--mesh_devices", "0"])) is None
    assert split_from_args(p.parse_args(
        ["--device", "cpu", "--mesh_devices", "3"])) == [CPU] * 3


@pytest.mark.parametrize("cli,stage,traced", [
    ("shapley_value", "run_shapley_init", True),
    ("enum", "run_enum", True),
    ("interaction_logits", "run_interaction_logits", True),
    ("smoothness_enum", "run_smoothness", False)])
def test_clis_pass_the_split_and_the_trace_dir(cli, stage, traced,
                                               monkeypatch):
    import importlib
    mod = importlib.import_module(f"interpret_quality_tpu_torch.cli.{cli}")
    owner = importlib.import_module(
        "interpret_quality_tpu_torch.attrib." + {
            "run_interaction_logits": "interactions",
            "run_smoothness": "smoothness"}.get(stage, "stages"))
    seen = {}
    monkeypatch.setattr(owner, stage, lambda *a, **kw: seen.update(kw))
    mod.main(["--model", "gcnn", "--device", "cpu", "--mesh_devices", "2",
              "--trace_dir", "traces"])
    assert seen["coalition_devices"] == [CPU, CPU]
    assert seen.get("trace_dir") == ("traces" if traced else None)


F32_TOL = dict(rtol=1e-5, atol=1e-6)     # as tests/test_sharding.py


def gcnn_forward():
    model = build_model("gcnn", num_classes=10, k=8)
    model.load_state_dict(seeded_state("gcnn"), strict=True)
    return make_forward_fn(model.eval())


def per_part(fn, parts):
    """The unsplit ``fn`` on each part of ``tensor_split(x, parts)`` (with
    the part's plan), concatenated: what the split must equal."""
    def run(x, plans=None):
        xs = torch.tensor_split(x, parts)
        plans = plans if plans is not None else [None] * parts
        return torch.cat([fn(p) if plan is None else fn(p, plan)
                          for p, plan in zip(xs, plans) if p.shape[0]])
    return run


@pytest.fixture
def split_calls(monkeypatch):
    """How many batches went through a SplitForward."""
    calls = []
    original = SplitForward._run

    def run(self, *args):
        calls.append(len(self.devices))
        return original(self, *args)
    monkeypatch.setattr(SplitForward, "_run", run)
    return calls


@pytest.mark.parametrize("parts", [2, 3])
def test_split_forward_is_the_per_part_forward(parts):
    forward = gcnn_forward()
    split, device = split_forward(forward, CPU, [CPU] * parts)
    assert isinstance(split, SplitForward) and device == CPU
    assert all(r.model is not forward.model for r in split.replicas)
    assert len({id(r.model) for r in split.replicas}) == parts
    x = torch.from_numpy(np.random.RandomState(0).uniform(
        -1, 1, (7, POINTS, 3)).astype(np.float32))
    with torch.inference_mode():
        got = split(x)
        assert torch.equal(got, per_part(forward, parts)(x))
        np.testing.assert_allclose(got.numpy(), forward(x).numpy(),
                                   **F32_TOL)
        assert torch.equal(split(x[:2]), per_part(forward, parts)(x[:2]))
        plans = split.plan_fn(x)                  # the whole batch's graph
        assert [p.shape[0] for p in plans] == [
            t.shape[0] for t in torch.tensor_split(x, parts)]
        assert torch.equal(torch.cat(plans), forward.plan_fn(x))
        assert torch.equal(split.apply_plan_fn(x, plans),
                           per_part(forward.apply_plan_fn, parts)(x, plans))
        # the replicas were copied once: they share nothing with the model
        for p in forward.model.parameters():
            p.data.add_(1.0)
        assert torch.equal(split(x), got)
    assert split_forward(forward, CPU, None) == (forward, CPU)
    with pytest.raises(ValueError, match="at least one"):
        coalition_split(lambda d: forward, [])


@pytest.mark.parametrize("parts", [2, 3])
def test_shapley_init_and_enum_through_the_split(parts, tmp_path,
                                                 monkeypatch, split_calls):
    """Shapley init (7 orders in chunks of 5 and 2: 25 and 10 rows) and
    the trans enumeration on the plan path (GCNN) through the stages,
    split and unsplit."""
    monkeypatch.chdir(tmp_path)
    trees = []
    for devices in (None, [CPU] * parts):
        root = str(tmp_path / f"ck_{devices is not None}")
        cfg = cfg_for("gcnn", root, num_samples_save=7, num_samples=7,
                      shapley_batch_size=5)
        stages.run_shapley_init(cfg, synthetic=True, allow_random_init=True,
                                sample_indices=[0], coalition_devices=devices)
        stages.run_enum(cfg, "trans", synthetic=True, allow_random_init=True,
                        sample_indices=[0], max_poses=3,
                        coalition_devices=devices)
        folder = cfg.exp_folder + "synthetic_00/"
        trees.append({f: np.load(folder + f) for f in (
            "region_sv_all.npy", "norm_factor.npy",
            "trans_all/region_shapley_value.npy",
            "trans_all/orig_shapley_value.npy")})
        trees[-1]["logits"] = torch.load(
            folder + "trans_all/all_logits.pt").numpy()
    # init: norm factor + 2 chunks; enum: 2 chunks, then 3 poses x 2 chunks
    assert split_calls == [parts] * 11
    for key, value in trees[0].items():
        np.testing.assert_allclose(trees[1][key], value, err_msg=key,
                                   **F32_TOL)


@pytest.mark.parametrize("parts", [3])
def test_pointnet2_plan_path_through_the_split(parts):
    """PointNet++'s plan (FPS centres of both levels) computed once on the
    first device and split with the batch: the plan-path enumeration of a
    chunk of 5 orders (25 clouds) over two poses, equal to the per-part
    forwards and within F32_TOL of the unsplit ones."""
    torch.manual_seed(0)
    forward = make_forward_fn(build_model("pointnet2", num_classes=10))
    rng = np.random.RandomState(1)
    data = rng.uniform(-1, 1, (POINTS, 3)).astype(np.float32)
    region_id = np.arange(POINTS) % REGIONS
    orders = np.stack([rng.permutation(REGIONS) for _ in range(5)])
    poses = np.array([[0.0, 0.0, 0.0], [0.1, -0.2, 0.05]], np.float32)
    split = split_forward(forward, CPU, [CPU] * parts)[0]
    out = []
    for plan_fn, apply_plan in (
            (forward.plan_fn, forward.apply_plan_fn),
            (split.plan_fn, split.apply_plan_fn),
            (split.plan_fn, per_part(forward.apply_plan_fn, parts))):
        engine = ShapleyEngine(forward, REGIONS, batch_orders=5, device=CPU)
        out.append(engine.enum_all_poses_plan(
            lambda x, t: x + t, data, poses, 3, region_id, orders, plan_fn,
            apply_plan))
    unsplit, got, want = out
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[1], unsplit[1], **F32_TOL)
    np.testing.assert_allclose(got[0], unsplit[0], **F32_TOL)


@pytest.mark.parametrize("parts", [2, 3])
def test_interaction_engine_through_the_split(parts):
    """6 pairs x 4 contexts in chunks of 5 cells (20 clouds; a last chunk
    of 4 cells, 16 clouds)."""
    forward = gcnn_forward()
    rng = np.random.RandomState(2)
    data = rng.uniform(-1, 1, (POINTS, 3)).astype(np.float32)
    region_id = np.arange(POINTS) % REGIONS
    pairs = np.stack([rng.choice(REGIONS, 2, replace=False)
                      for _ in range(6)])
    contexts = np.stack([[rng.choice([r for r in range(REGIONS)
                                      if r not in pair], 1, replace=False)
                          for _ in range(4)] for pair in pairs])
    unsplit, got, want = (
        InteractionEngine(fwd, REGIONS, batch_contexts=5, device=CPU)
        .logits_for_pairs(data, region_id, pairs, contexts)
        for fwd in (forward, split_forward(forward, CPU, [CPU] * parts)[0],
                    per_part(forward, parts)))
    assert got.shape == (6, 16, 10)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, unsplit, **F32_TOL)


def test_smoothness_epoch_through_the_split(tmp_path, monkeypatch,
                                            split_calls):
    """One smoothness epoch (linearity, both objectives) after init, split
    over 3 and unsplit."""
    monkeypatch.chdir(tmp_path)
    trees = []
    for devices in (None, [CPU] * 3):
        root = str(tmp_path / f"ck_{devices is not None}")
        cfg = cfg_for("gcnn", root, num_samples_save=4, num_samples=4)
        stages.run_shapley_init(cfg, synthetic=True, allow_random_init=True,
                                sample_indices=[1])
        tsm.run_smoothness(cfg, modes=("linearity",), synthetic=True,
                           allow_random_init=True, sample_indices=[1],
                           max_epochs=1, coalition_devices=devices)
        folder = cfg.exp_folder + "synthetic_01/linearity_all/"
        tree = {}
        for objective in ("inc", "dec"):
            d = folder + f"allregion_{objective}/"
            tree[objective] = (np.load(d + "region_shapley_value.npy"),
                               torch.load(d + "all_logits.pt").numpy())
        trees.append(tree)
    assert split_calls and set(split_calls) == {3}
    for objective, (sv, logits) in trees[0].items():
        np.testing.assert_allclose(trees[1][objective][0], sv, **F32_TOL)
        np.testing.assert_allclose(trees[1][objective][1], logits,
                                   **F32_TOL)


def test_trace_dir_writes_a_trace_per_stage_call(tmp_path, monkeypatch):
    """cli.shapley_value --trace_dir on the CPU writes one Chrome trace of
    each cloud's estimate, with the forward's operators in it."""
    from interpret_quality_tpu_torch.cli import shapley_value
    monkeypatch.chdir(tmp_path)
    traces = tmp_path / "traces"
    shapley_value.main(["--model", "gcnn", "--synthetic", "--device", "cpu",
                        "--allow_random_init", "--checkpoints_root",
                        str(tmp_path / "ck"), "--num_points", str(POINTS),
                        "--num_regions", str(REGIONS), "--num_samples_save",
                        "2", "--samples", "0,1", "--trace_dir", str(traces)])
    assert sorted(os.listdir(traces)) == [
        "shapley_init_synthetic_00.pt.trace.json",
        "shapley_init_synthetic_01.pt.trace.json"]
    with open(traces / "shapley_init_synthetic_00.pt.trace.json") as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)
    assert {"iq_forward", "iq_engine.keep", "iq_engine.mask",
            "iq_engine.marginals", "iq_engine.to_host"} <= names
