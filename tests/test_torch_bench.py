"""``bench_torch.py`` against ``bench.py``: the last line keeps the JAX
benchmark's keys, names and units; the log-rate reader and the suite
projection give ``bench.py``'s numbers on one fixture tree of StageTimer
lines (an aborted record and a non-JSON line among them); the evidence
fallback and the measured wall-clock read only the port's own files, never
the committed TPU evidence; the GFLOP table and the TITAN proxy are
``bench.py``'s constants; and ``--device cuda`` without a card raises.
"""
import ast
import importlib.util
import json
import math
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
NVIDIA = "NVIDIA H100 80GB HBM3, 700.00 W"
SMALL = ["--device", "cpu", "--model", "gcnn", "--orders", "2", "--steps",
         "1", "--warmup", "0", "--num_points", "128"]


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def benches():
    """(bench.py, bench_torch.py) as modules; bench.py with its re-exec
    guard off, as scripts/suite_wallclock.py loads it."""
    old = os.environ.get("_IQ_BENCH_REEXEC")
    os.environ["_IQ_BENCH_REEXEC"] = "1"
    try:
        jax_bench = _load(REPO / "bench.py", "_bench_jax")
    finally:
        if old is None:
            del os.environ["_IQ_BENCH_REEXEC"]
        else:
            os.environ["_IQ_BENCH_REEXEC"] = old
    return jax_bench, _load(REPO / "bench_torch.py", "_bench_torch")


def _headline_keys(path):
    """The keys of the dict literal with a "metric" key in ``path``: the
    last line a benchmark prints."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and any(
                isinstance(k, ast.Constant) and k.value == "metric"
                for k in node.keys):
            return [k.value for k in node.keys]
    raise AssertionError(f"no headline dict in {path}")


def _constant(path, name):
    tree = ast.parse(path.read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name
                for t in node.targets):
            return ast.literal_eval(node.value) if isinstance(
                node.value, ast.Dict) else ast.unparse(node.value)
    raise AssertionError(f"{name} not in {path}")


def _run(args, cwd):
    return subprocess.run([sys.executable, str(REPO / "bench_torch.py"),
                           *args], cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=dict(os.environ,
                                                PYTHONPATH=str(REPO)))


def test_cli_last_line_keeps_bench_py_keys(tmp_path):
    """A CPU run where the committed TPU evidence lies in the working
    directory: the last line has bench.py's keys, and nothing of the TPU
    files reaches it."""
    shutil.copytree(REPO / "results", tmp_path / "results")
    proc = _run(SMALL + ["--no_probe"], tmp_path)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    last = json.loads(lines[-1])
    assert list(last) == _headline_keys(REPO / "bench.py")
    assert list(last) == _headline_keys(REPO / "bench_torch.py")
    assert last["metric"] == "masked_coalition_forwards_per_sec_geomean"
    assert last["unit"] == "forwards/s" and last["value"] > 0
    assert last["suite_basis"] == "engine_rate_fallback"
    assert last["measured_suite_speedup_pointnet"] is None
    assert all(line.startswith("# ") for line in lines[:-1])
    device = json.loads(lines[0][len("# device "):])
    assert device["device"] == "cpu"
    per_model = next(json.loads(line[2:]) for line in lines
                     if line.startswith('# {"per_model"'))["per_model"]
    assert set(per_model) == {"gcnn"}
    assert per_model["gcnn"]["sustained_enum_forwards_per_sec"] is None
    sources = json.loads(next(line for line in lines if line.startswith(
        "# rate_sources "))[len("# rate_sources "):])
    assert sources == {"gcnn": []}


def test_cli_enum_stage(tmp_path):
    proc = _run(SMALL + ["--stage", "enum", "--max_poses", "2"], tmp_path)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[0].startswith("# device ")
    rec = json.loads(lines[-1])
    assert len(lines) == 2           # the stages' own prints went to stderr
    assert {"model", "stage", "poses", "sustained_forwards_per_sec",
            "vs_baseline"} <= set(rec)
    assert rec["model"] == "gcnn" and rec["stage"] == "enum_trans"
    assert rec["poses"] == 2 and rec["sustained_forwards_per_sec"] > 0
    assert rec["vs_baseline"] is None          # no proxy off N = 1024
    assert os.listdir(tmp_path) == []          # the probe ran in a temp dir


def test_cuda_without_a_card_raises(benches, tmp_path, monkeypatch, capsys):
    _, bench = benches
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    for argv in (["--model", "gcnn"], SMALL[2:], SMALL[2:] + ["--stage",
                                                              "enum"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            bench.main(argv)
    assert capsys.readouterr().out == ""
    assert os.listdir(tmp_path) == []


def _log_tree(root):
    """StageTimer lines as the port's stages write them, for two models:
    enum, interaction and smoothness logs at the depths the stages use, an
    aborted record, a line that is no JSON, a sample-root init log."""
    recs = {
        "dgcnn": {
            "synthetic_00/trans_all/log.txt": [
                {"stage": "enum:trans:synthetic_00", "seconds": 2.0,
                 "items": 26400, "items_per_sec": 13200.0}],
            "synthetic_01/trans_all/log.txt": [
                {"stage": "enum:trans:synthetic_01", "seconds": 2.5,
                 "items": 26400, "items_per_sec": 10560.0},
                {"stage": "enum:trans:synthetic_01", "seconds": 0.3,
                 "aborted": True}],
            "synthetic_00/interaction_seed1/log.txt": [
                {"stage": "interaction:synthetic_00", "seconds": 4.0,
                 "items": 48000, "items_per_sec": 12000.0}],
            "synthetic_00/linearity_all/allregion_inc/log.txt": [
                {"stage": "smoothness:linearity:inc", "seconds": 1.0,
                 "items": 6600, "items_per_sec": 6600.0}],
            "synthetic_00/log.txt": [
                {"stage": "shapley_init:synthetic_00", "seconds": 3.0,
                 "items": 33000, "items_per_sec": 11000.0}],
        },
        "pointnet2": {
            "synthetic_00/trans_all/log.txt": [
                {"stage": "enum:trans:synthetic_00", "seconds": 3.0,
                 "items": 26400, "items_per_sec": 8800.0}],
        },
    }
    for model, logs in recs.items():
        exp = (f"{root}/exp_MODEL_{model}_DATA_modelnet10_POINTNUM_1024_"
               f"REGIONNUM_32_shapley_test/")
        for rel, lines in logs.items():
            os.makedirs(os.path.dirname(exp + rel), exist_ok=True)
            with open(exp + rel, "w") as f:
                f.write("ExperimentConfig(model=...)\nnorm factor: 1.0\n")
                for rec in lines:
                    f.write(json.dumps(rec) + "\n")


def test_rates_and_projection_equal_bench_py(benches, tmp_path, monkeypatch):
    jax_bench, bench = benches
    _log_tree(str(tmp_path / "ck"))
    monkeypatch.chdir(tmp_path)
    for model in ("dgcnn", "pointnet2", "gcnn"):
        sources = []
        got = bench.stage_rates_from_logs(model, str(tmp_path / "ck"),
                                          sources=sources)
        want = jax_bench.stage_rates_from_logs(model, str(tmp_path / "ck"))
        assert got == want
        assert len(sources) == {"dgcnn": 4, "pointnet2": 1, "gcnn": 0}[model]
    rates = bench.stage_rates_from_logs("dgcnn", str(tmp_path / "ck"))
    assert rates == {"enum": (13200.0 + 10560.0) / 2, "interaction": 12000.0,
                     "smoothness": 6600.0}
    cases = [(5000.0, rates, "dgcnn", "stage_logs"),
             (5000.0, {"enum": 8800.0}, "pointnet2", "stage_logs"),
             (7000.0, {"enum": 900.0}, "gcnn", "enum_probe"),
             (7000.0, {}, "pointnet", None),
             (7000.0, {"shapley": 3.0, "enum": 1.0}, "gcnn_adv", None)]
    for case in cases:
        assert bench.suite_projection(*case) == \
            jax_bench.suite_projection(*case)
    for model in bench.GFLOP_PER_FORWARD:
        for n in (1024, 128):
            assert bench.reference_fwds_per_sec(model, n) == \
                jax_bench.reference_fwds_per_sec(model, n)
    assert (bench.W_INIT, bench.W_ENUM, bench.W_INTER) == \
        (jax_bench.W_INIT, jax_bench.W_ENUM, jax_bench.W_INTER)


def _evidence(path, model, gen, stages, device=None):
    rec = {"model": model, "dataset": "modelnet10", "generated_unix": gen,
           "stage_rates_by_stage": stages}
    if device is not None:
        rec["device"] = device
    path.parent.mkdir(exist_ok=True)
    path.write_text(json.dumps(rec))


def test_fallback_reads_only_the_ports_evidence(benches, tmp_path,
                                                monkeypatch):
    """The JAX evidence, as committed and copied under a port name, is
    ignored; port evidence counts only where its device is an NVIDIA card;
    the newest value per stage wins, as in bench.py."""
    jax_bench, bench = benches
    res = tmp_path / "results"
    res.mkdir()
    shutil.copy(REPO / "results" / "dgcnn_synthetic.json", res)
    shutil.copy(REPO / "results" / "dgcnn_synthetic.json",
                res / "dgcnn_tpu_torch.json")
    monkeypatch.chdir(tmp_path)
    none = str(tmp_path / "no_tree")
    assert jax_bench.stage_rates_from_logs("dgcnn", none)   # bench.py reads it
    assert bench.stage_rates_from_logs("dgcnn", none) == {}
    _evidence(res / "dgcnn_synthetic_torch.json", "dgcnn", 100,
              {"enum": 11000.0, "interaction": 12000.0}, NVIDIA)
    _evidence(res / "dgcnn_synthetic2_torch.json", "dgcnn", 200,
              {"enum": 11500.0}, NVIDIA)
    _evidence(res / "dgcnn_cpu_torch.json", "dgcnn", 300,
              {"enum": 50.0, "smoothness": 40.0}, "cpu")
    _evidence(res / "dgcnn_adv_torch.json", "gcnn_adv", 400,
              {"enum": 1.0}, NVIDIA)
    sources = []
    got = bench.stage_rates_from_logs("dgcnn", none, sources=sources)
    assert got == {"enum": 11500.0, "interaction": 12000.0}
    assert sorted(os.path.basename(s) for s in sources) == [
        "dgcnn_synthetic2_torch.json", "dgcnn_synthetic_torch.json"]


def test_headline_reads_port_evidence_and_wallclock(benches, tmp_path,
                                                    monkeypatch, capsys):
    """In-process run with no tree: GCNN's rates come from the port's
    evidence (basis stage_logs), the measured line from
    results/suite_wallclock_torch.json; the JAX suite_wallclock.json and
    gcnn_synthetic.json beside them are ignored."""
    _, bench = benches
    res = tmp_path / "results"
    res.mkdir()
    for name in ("suite_wallclock.json", "gcnn_synthetic.json"):
        shutil.copy(REPO / "results" / name, res)
    _evidence(res / "gcnn_synthetic_torch.json", "gcnn", 100,
              {"enum": 17000.0, "interaction": 15000.0,
               "shapley_init": 16000.0}, NVIDIA)
    (res / "suite_wallclock_torch.json").write_text(json.dumps(
        {"hardware": NVIDIA, "families": {
            "pointnet": {"measured_speedup_vs_ref_proxy": 2.5}}}))
    monkeypatch.chdir(tmp_path)
    bench.main(SMALL + ["--checkpoints_root", str(tmp_path / "none")])
    lines = capsys.readouterr().out.strip().splitlines()
    last = json.loads(lines[-1])
    assert last["suite_basis"] == "stage_logs"
    assert last["measured_suite_speedup_pointnet"] == 2.5
    per_model = next(json.loads(line[2:]) for line in lines
                     if line.startswith('# {"per_model"'))["per_model"]
    assert per_model["gcnn"]["sustained_enum_forwards_per_sec"] == 17000.0
    assert per_model["gcnn"]["sustained_interaction_forwards_per_sec"] == \
        15000.0


def test_gflop_table_is_bench_py_s(benches):
    jax_bench, bench = benches
    table = _constant(REPO / "bench.py", "GFLOP_PER_FORWARD")
    assert _constant(REPO / "bench_torch.py", "GFLOP_PER_FORWARD") == table
    assert bench.GFLOP_PER_FORWARD == jax_bench.GFLOP_PER_FORWARD == table
    assert _constant(REPO / "bench_torch.py", "_TITAN_EFF_FLOPS") == \
        _constant(REPO / "bench.py", "_TITAN_EFF_FLOPS")
    assert math.isclose(bench._TITAN_EFF_FLOPS, 16.3e12 * 0.30)
    assert set(table) == set(bench.ALL_MODELS) | {"gcnn_adv"}
