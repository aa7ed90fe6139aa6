"""The harness: a cell, a configuration, a traffic mix and a per-layer
metric added as new files alone; the result line's keys; no result without
a card or without the port."""
import importlib
import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from iqbench import harness

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PKG)
SMALL = {"dgcnn.enum_trans": {"config": {"num_points": 128},
                              "traffic": {"orders_per_pose": 2, "poses_per_call": 2,
                                          "check_poses": 1}}}


def copy_benchmark(dst):
    shutil.copytree(PKG, os.path.join(dst, "iqbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)


STUB_FAMILY = '''"""A family added as a new file: DGCNN's model, with counts of its own."""
from .dgcnn import forward, leaves, plan  # noqa: F401


def extra_counts(cfg, masked, ident):
    return {"stub_clouds": int(masked.shape[0])}


def flops(cfg, e):
    return float(e["forwards"] * e["stub_clouds"])
'''
STUB_METRIC = '''from iqbench.reference import attribution


def read(ctx):
    family = attribution.model(ctx.cfg)
    return sum(family.flops(ctx.cfg, e) for e in ctx.work())
'''


def test_new_files_alone_add_a_cell(tmp_path, monkeypatch):
    """A configuration of a new family (its reference module), a traffic
    mix, the cell's limits and a per-layer metric, each a new file: the
    harness of the copy finds them all by name, and the shared code asks
    the new module for its weights, counts and operations."""
    copy_benchmark(tmp_path)
    pkg = tmp_path / "iqbench"
    (pkg / "reference" / "dgcnn_stub.py").write_text(STUB_FAMILY)
    cfg = json.loads((pkg / "configs" / "dgcnn.json").read_text())
    cfg.update(num_points=128, reference="iqbench/reference/dgcnn_stub.py")
    (pkg / "configs" / "dgcnn_stub.json").write_text(json.dumps(cfg))
    (pkg / "traffic" / "enum_tiny.json").write_text(json.dumps(dict(
        json.loads((pkg / "traffic" / "enum_trans.json").read_text()),
        orders_per_pose=1, poses_per_call=1, check_poses=1)))
    (pkg / "limits" / "dgcnn_stub.enum_tiny.json").write_text(
        json.dumps({"logit_gap": 1e-3, "shapley_gap": 1e-3}))
    (pkg / "metrics" / "stub_ops.tiny.py").write_text(STUB_METRIC)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="dgcnn_stub",
                                 file="iqbench/configs/dgcnn_stub.json"))
    bench["workloads"].append({"name": "dgcnn_stub.enum_tiny",
                               "config": "dgcnn_stub", "traffic": "enum_tiny",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("dgcnn_stub.enum_tiny")
    bench["per_layer"].append({"name": "stub_ops.tiny", "unit": "ops",
                               "better": "higher", "source": "host_clock",
                               "layer": "model", "moves": "forwards_per_s",
                               "workloads": ["dgcnn_stub.enum_tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    # the copy is the benchmark, as in a checkout that a later PR added to
    for name in [m for m in sys.modules if m.split(".")[0] == "iqbench"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.syspath_prepend(str(tmp_path))
    copy_harness = importlib.import_module("iqbench.harness")
    assert copy_harness.PKG == str(pkg)
    run = copy_harness.run_cell("dgcnn_stub.enum_tiny", 3, 0.2, False,
                                time.monotonic(), device="cpu",
                                root=str(tmp_path))
    assert run["correct"] and set(run["metrics"]) == {"forwards_per_s", "setup_s"}
    traced = copy_harness.run_cell("dgcnn_stub.enum_tiny", 4, 0.2, True,
                                   time.monotonic(), device="cpu",
                                   root=str(tmp_path))
    assert set(traced["metrics"]) == {"stub_ops.tiny"}
    assert traced["metrics"]["stub_ops.tiny"]["value"] >= 33
    assert sys.modules["iqbench.reference.dgcnn_stub"].__file__.startswith(str(pkg))


def test_result_line_keys():
    run = harness.run_cell("dgcnn.enum_trans", 2 ** 31 + 77, 0.2, False,
                           time.monotonic(), device="cpu",
                           overrides=SMALL["dgcnn.enum_trans"])
    assert list(run) == ["correct", "attempted", "failed", "metrics", "device",
                         "check"]
    assert set(run["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for m in run["metrics"].values():
        assert set(m) == {"value", "unit"}
    for v in run["check"].values():
        assert set(v) == {"value", "limit"}
    json.dumps(run)


def run_py(cwd):
    return subprocess.run([sys.executable, "iqbench/run.py", "--workload",
                           "dgcnn.enum_trans", "--seed", "1", "--seconds", "1"],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_result_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = run_py(ROOT)
    assert p.returncode != 0 and not p.stdout.strip()


def test_no_result_without_the_port(tmp_path):
    copy_benchmark(tmp_path)
    p = run_py(tmp_path)
    assert p.returncode != 0 and not p.stdout.strip()
