"""The port stands alone: no JAX, no module of the JAX package, and no
silent fall back to the CPU."""
import ast
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import interpret_quality_tpu_torch

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "interpret_quality_tpu"}
PKG_DIR = os.path.dirname(interpret_quality_tpu_torch.__file__)
REPO = os.path.dirname(PKG_DIR)


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [PKG_DIR], prefix="interpret_quality_tpu_torch."))


def _imported_top_levels(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_file_imports_jax_or_the_jax_package():
    offenders = []
    for d, _, names in os.walk(PKG_DIR):
        for n in names:
            if n.endswith(".py"):
                path = os.path.join(d, n)
                # whole top-level names: interpret_quality_tpu_torch is fine
                bad = set(_imported_top_levels(path)) & FORBIDDEN
                if bad:
                    offenders.append((os.path.relpath(path, REPO), bad))
    assert offenders == []


PORT_SCRIPTS = {"adv_robustness_torch.py", "model_flops_torch.py",
                "suite_wallclock_torch.py", "collect_evidence_torch.py",
                "make_results_md_torch.py", "make_compare_md_torch.py",
                "export_t7_torch.py", "make_shapenet_fixture_torch.py"}


def _string_constants(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    return {node.value for node in ast.walk(tree)
            if isinstance(node, ast.Constant) and isinstance(node.value, str)}


def test_port_scripts_import_no_jax():
    """The port's scripts beside the package, bench_torch.py and
    chip_smoke.py, which run on a machine without JAX; none of them loads
    the JAX benchmark bench.py by path."""
    paths = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "bench_torch.py")] + sorted(
        os.path.join(REPO, "scripts", n)
        for n in os.listdir(os.path.join(REPO, "scripts"))
        if n.endswith("_torch.py"))
    assert PORT_SCRIPTS <= {os.path.basename(p) for p in paths}
    for path in paths:
        assert not set(_imported_top_levels(path)) & FORBIDDEN, path
        assert "bench.py" not in _string_constants(path), path


def test_importing_every_port_module_loads_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {_port_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(FORBIDDEN)!r})\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert len(_port_modules()) >= 58
    assert {f"interpret_quality_tpu_torch.{m}" for m in (
        "ops.cuda.fps", "ops.cuda.groups", "ops.cuda.launch",
        "models.pointnet", "models.pointnet2", "models.pointconv",
        "attrib.interactions", "attrib.smoothness", "utils.region_geom",
        "cli.gen_pair", "cli.interaction_logits", "cli.cal_interactions",
        "cli.smoothness_enum", "data.native", "data.augment",
        "models.checkpoint", "results.tables", "results.plots",
        "results.visualization", "cli.result", "cli.plot_interaction",
        "train", "train.losses", "train.trainer", "cli.train",
        "train.adversarial", "cli.train_adv", "parallel", "parallel.mesh",
        "ops.transforms", "parallel.data_parallel", "parallel.dryrun")
    } <= set(_port_modules())


def test_cli_asks_for_cuda_and_raises_without_it(tmp_path, monkeypatch):
    from interpret_quality_tpu_torch.cli import shapley_value
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        shapley_value.main(["--model", "dgcnn", "--synthetic",
                            "--allow_random_init", "--device", "cuda",
                            "--num_points", "64", "--num_regions", "4",
                            "--num_samples_save", "2", "--samples", "0"])
    assert not os.listdir(tmp_path)        # nothing ran on the CPU instead


@pytest.mark.parametrize("cli", ["gen_pair", "interaction_logits",
                                 "smoothness_enum"])
def test_stage_clis_ask_for_cuda_and_raise_without_it(cli, tmp_path,
                                                      monkeypatch):
    import importlib
    mod = importlib.import_module(f"interpret_quality_tpu_torch.cli.{cli}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(["--model", "dgcnn", "--synthetic", "--allow_random_init",
                  "--checkpoints_root", str(tmp_path / "ck"),
                  "--num_points", "64", "--num_regions", "4", "--samples", "0"])
    assert not os.listdir(tmp_path)        # nothing ran on the CPU instead


def test_cli_train_asks_for_cuda_and_raises_without_it(tmp_path,
                                                       monkeypatch):
    """cli.train runs on CUDA unless --device cpu is given, and raises
    before it writes anything when there is no card."""
    from interpret_quality_tpu_torch.cli import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--model", "gcnn", "--synthetic", "--num_points", "64",
                    "--epochs", "1", "--train_samples", "4",
                    "--test_samples", "4", "--checkpoints_root",
                    str(tmp_path / "ck")])
    assert not os.listdir(tmp_path)        # nothing ran on the CPU instead


def test_cli_train_adv_asks_for_cuda_and_raises_without_it(tmp_path,
                                                           monkeypatch):
    """cli.train_adv runs on CUDA unless --device cpu is given, and raises
    before it writes anything when there is no card."""
    from interpret_quality_tpu_torch.cli import train_adv
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_adv.main(["--synthetic", "--num_points", "64", "--epochs", "1",
                        "--allow_random_init", "--checkpoints_root",
                        str(tmp_path / "ck")])
    assert not os.listdir(tmp_path)        # nothing ran on the CPU instead


def test_make_mesh_asks_for_cuda_and_raises_without_it(monkeypatch):
    """A split over CUDA devices that are not there raises: it never
    shrinks and never moves to the CPU."""
    from interpret_quality_tpu_torch.cli.common import (base_parser,
                                                        split_from_args)
    from interpret_quality_tpu_torch.parallel import make_mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: make_mesh(), lambda: make_mesh(2),
                 lambda: make_mesh(devices=["cuda:0", "cuda:0"]),
                 lambda: split_from_args(base_parser("t").parse_args(
                     ["--mesh_devices", "2"]))):
        with pytest.raises(RuntimeError, match="0 are visible|0 CUDA"):
            call()


def test_config_defaults_to_cuda():
    from interpret_quality_tpu_torch.config import ExperimentConfig
    assert ExperimentConfig(model="dgcnn").device == "cuda"
    assert ExperimentConfig(model="gcnn_adv").interaction_batch_size == 200
    with pytest.raises(ValueError):
        ExperimentConfig(model="dgcnn", device="tpu")
