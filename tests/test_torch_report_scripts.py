"""The port's report scripts against the JAX package's on one artifact tree:
``collect_evidence``, ``make_results_md``, ``make_compare_md`` and
``suite_wallclock``.

The tree is written by the port's own CLIs on the CPU, GCNN at 64 points
(Shapley init, trans and rotate enumerations, rotate interactions for
clouds 0 and 1), with a training ``run.log`` beside it, as
``tests/test_torch_results.py`` builds its tree.  Evidence records are
equal apart from ``generated_unix``, ``label`` and the port's added
``device``; the markdown is equal apart from the line that names the label and the
checkpoint file each package loads by default (the JAX package's
``model_best.msgpack``, the port's ``model_best.t7``, in the same folder);
the wall-clock families (read from the same tree under the 1024-point
folder name the scripts glob) are equal.
"""
import contextlib
import importlib
import importlib.util
import io
import json
import os
import pathlib
import shutil
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
SCRIPTS = REPO / "scripts"
N, ORDERS, SAMPLES = 64, "6", "0,1"
TRAIN_LOG = ("Train 0, loss: 2.1, train acc: 0.2\n"
             "Test 0, loss: 2.000000, test acc: 0.250000, "
             "test avg acc: 0.200000\n"
             "Test 1, loss: 1.500000, test acc: 0.500000, "
             "test avg acc: 0.450000\n"
             "Test 2, loss: 1.700000, test acc: 0.375000, "
             "test avg acc: 0.350000\n")


def _script(name):
    """scripts/<name>.py as a module (scripts/ on sys.path, as the scripts
    themselves put it, so collect_evidence finds make_results_md)."""
    if str(SCRIPTS) not in sys.path:
        sys.path.insert(0, str(SCRIPTS))
    spec = importlib.util.spec_from_file_location(f"_rs_{name}",
                                                  SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _quiet(fn, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args)
    return out.getvalue()


def _jax_main(mod, argv, monkeypatch):
    """A JAX script's main(), which reads sys.argv."""
    monkeypatch.setattr(sys, "argv", [mod.__file__] + argv)
    return _quiet(mod.main)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The checkpoints root the port's CLIs wrote, GCNN at 64 points."""
    root = tmp_path_factory.mktemp("report_tree")
    cwd = os.getcwd()
    os.chdir(root)                               # save_fps writes into the cwd
    try:
        common = ["--model", "gcnn", "--synthetic", "--allow_random_init",
                  "--device", "cpu", "--checkpoints_root", str(root / "ck"),
                  "--num_points", str(N), "--num_samples_save", ORDERS,
                  "--num_samples", ORDERS, "--shapley_batch_size", "3",
                  "--interaction_batch_size", "64", "--samples", SAMPLES]

        def cli(name, argv):
            _quiet(importlib.import_module(
                f"interpret_quality_tpu_torch.cli.{name}").main, argv)
        cli("save_fps", common)
        cli("shapley_value", common)
        for mode in ("trans", "rotate"):
            cli("enum", common + ["--mode", mode, "--max_poses", "3"])
        inter = common + ["--mode", "rotate"]
        cli("gen_pair", inter + ["--num_pairs_random", "2",
                                 "--num_save_context_max", "2"])
        cli("interaction_logits", inter)
        cli("cal_interactions", inter)
    finally:
        os.chdir(cwd)
    run_dir = root / "ck" / f"exp_MODEL_gcnn_DATA_modelnet10_POINTNUM_{N}_clean"
    run_dir.mkdir(parents=True)
    (run_dir / "run.log").write_text(TRAIN_LOG)
    return root / "ck"


def _args(tree):
    return ["--model", "gcnn", "--synthetic", "--checkpoints_root",
            str(tree), "--num_points", str(N), "--num_samples", ORDERS,
            "--samples", SAMPLES]


def test_collect_evidence_equals_jax(tree, tmp_path, monkeypatch):
    jax_ev = _script("collect_evidence")
    port_ev = _script("collect_evidence_torch")
    _jax_main(jax_ev, _args(tree) + ["--label", "jax", "--out",
                                     str(tmp_path / "jax.json")], monkeypatch)
    _quiet(port_ev.main, _args(tree) + [
        "--label", "port", "--device", "cpu", "--out",
        str(tmp_path / "port.json")])
    want = json.loads((tmp_path / "jax.json").read_text())
    got = json.loads((tmp_path / "port.json").read_text())
    assert got.pop("device") == "cpu"
    assert (got.pop("label"), want.pop("label")) == ("port", "jax")
    got.pop("generated_unix"), want.pop("generated_unix")
    assert got == want
    # the tree reached every section
    assert got["train"]["best_epoch"] == 1 and got["train"]["best_acc"] == 0.5
    assert set(got["table2_sensitivity"]) == {"trans", "rotate"}
    assert set(got["table3_correlation"]) == {"trans", "rotate"}
    assert set(got["table4_smoothness"]) == {"trans", "rotate"}
    assert {"enum", "interaction", "shapley_init"} <= set(
        got["stage_rates_by_stage"])
    # an unchanged record is left as it is, whatever its timestamp
    out = _quiet(port_ev.main, _args(tree) + [
        "--label", "port", "--device", "cpu", "--out",
        str(tmp_path / "port.json")])
    assert out.startswith("unchanged")


def test_collect_evidence_default_path_is_the_ports(tree, tmp_path,
                                                    monkeypatch):
    port_ev = _script("collect_evidence_torch")
    monkeypatch.chdir(tmp_path)
    _quiet(port_ev.main, _args(tree) + ["--device", "cpu"])
    assert os.listdir(tmp_path / "results") == ["gcnn_synthetic_torch.json"]


def _drop_label(text, label):
    lines = text.splitlines()
    hit = [i for i, line in enumerate(lines) if label in line]
    assert len(hit) == 1, hit
    return lines[:hit[0]] + lines[hit[0] + 1:]


def test_make_results_md_equals_jax(tree, tmp_path, monkeypatch):
    jax_md = _script("make_results_md")
    port_md = _script("make_results_md_torch")
    _jax_main(jax_md, _args(tree) + ["--label", "JAX-LABEL", "--out",
                                     str(tmp_path / "jax.md")], monkeypatch)
    _quiet(port_md.main, _args(tree) + ["--label", "PORT-LABEL", "--out",
                                        str(tmp_path / "port.md")])
    got = (tmp_path / "port.md").read_text()
    want = (tmp_path / "jax.md").read_text()
    assert want.count("/models/model_best.msgpack`") == 1
    want = want.replace("/models/model_best.msgpack`", "/models/model_best.t7`")
    assert _drop_label(got, "PORT-LABEL") == _drop_label(want, "JAX-LABEL")
    for section in ("## Training", "## Table 2", "## Table 3", "## Table 4",
                    "## Interactions", "## Stage throughput"):
        assert section in got
    assert "incomplete" not in got
    monkeypatch.chdir(tmp_path)
    _quiet(port_md.main, _args(tree))
    assert (tmp_path / "RESULTS_torch.md").exists()


def test_make_compare_md_equals_jax(tree, tmp_path, monkeypatch):
    jax_cmp = _script("make_compare_md")
    port_cmp = _script("make_compare_md_torch")
    args = ["--synthetic", "--checkpoints_root", str(tree), "--num_points",
            str(N), "--num_samples", ORDERS, "--samples", SAMPLES,
            "--models", "gcnn,dgcnn"]
    _jax_main(jax_cmp, args + ["--label", "JAX-LABEL", "--out",
                               str(tmp_path / "jax.md")], monkeypatch)
    _quiet(port_cmp.main, args + ["--label", "PORT-LABEL", "--out",
                                  str(tmp_path / "port.md")])
    got = (tmp_path / "port.md").read_text()
    assert _drop_label(got, "PORT-LABEL") == _drop_label(
        (tmp_path / "jax.md").read_text(), "JAX-LABEL")
    assert "| gcnn |" in got and "| dgcnn |" not in got


def test_suite_wallclock_equals_jax(tree, tmp_path, monkeypatch):
    """The tree's StageTimer logs under the 1024-point folder name that
    both scripts glob."""
    ck = tmp_path / "checkpoints"
    src = tree / (f"exp_MODEL_gcnn_DATA_modelnet10_POINTNUM_{N}_"
                  "REGIONNUM_32_shapley_test")
    shutil.copytree(src, ck / src.name.replace(f"POINTNUM_{N}_",
                                               "POINTNUM_1024_"))
    monkeypatch.chdir(tmp_path)
    jax_wc = _script("suite_wallclock")
    _quiet(jax_wc.main)
    port_wc = _script("suite_wallclock_torch")
    _quiet(port_wc.main, ["--checkpoints_root", str(ck), "--device", "cpu",
                          "--out", str(tmp_path / "port.json")])
    want = json.loads((tmp_path / "results" / "suite_wallclock.json")
                      .read_text())
    got = json.loads((tmp_path / "port.json").read_text())
    assert got["families"] == want["families"]
    assert set(got["families"]) == {"gcnn"}
    assert {"shapley_init", "enum", "interaction"} <= set(
        got["families"]["gcnn"]["stages"])
    assert got["hardware"] == "cpu"
    assert port_wc.GFLOP == jax_wc.GFLOP and \
        port_wc.TITAN_EFF == jax_wc.TITAN_EFF
    _quiet(port_wc.main, ["--checkpoints_root", str(ck), "--device", "cpu"])
    assert sorted(os.listdir(tmp_path / "results")) == [
        "suite_wallclock.json", "suite_wallclock_torch.json"]
