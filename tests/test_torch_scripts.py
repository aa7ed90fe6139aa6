"""Static checks of the port's shell scripts (as ``tests/test_scripts.py``
does for the JAX package's): each parses under ``bash -n``, and every
``interpret_quality_tpu_torch.cli.<m>`` module it runs exists and builds
its argument parser."""
import importlib
import pathlib
import re
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
SCRIPTS = ["train_models_torch.sh", "run_results_suite_torch.sh"]


def cli_modules_of(script: pathlib.Path):
    """Direct invocations plus the suite's ``run <stage> ...`` helper."""
    text = script.read_text()
    mods = set(re.findall(r"interpret_quality_tpu_torch\.cli\.([a-z_]+)",
                          text))
    mods |= set(re.findall(r"^\s*run ([a-z_]+) ", text, re.M))
    return mods


@pytest.mark.parametrize("name", SCRIPTS)
def test_script_bash_syntax(name):
    subprocess.run(["bash", "-n", str(REPO / "scripts" / name)], check=True)


@pytest.mark.parametrize("name,want", [
    ("train_models_torch.sh", {"train", "train_adv"}),
    ("run_results_suite_torch.sh", {
        "save_fps", "shapley_value", "enum", "smoothness_enum", "gen_pair",
        "interaction_logits", "cal_interactions", "result",
        "plot_interaction"})])
def test_script_cli_modules_exist_and_parse(name, want):
    mods = cli_modules_of(REPO / "scripts" / name)
    assert mods == want
    for m in mods:
        importlib.import_module(f"interpret_quality_tpu_torch.cli.{m}")
    # every module's parser builds: --help exits 0 (one process for all)
    prog = ("import importlib, sys\n"
            f"for m in {sorted(mods)!r}:\n"
            "    mod = importlib.import_module("
            "'interpret_quality_tpu_torch.cli.' + m)\n"
            "    try:\n"
            "        mod.main(['--help'])\n"
            "    except SystemExit as e:\n"
            "        assert e.code in (0, None), (m, e.code)\n"
            "print('HELP_OK')\n")
    r = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                       cwd=REPO, text=True, timeout=120)
    assert r.returncode == 0 and "HELP_OK" in r.stdout, r.stderr[-800:]


def test_adv_gcnn_resumes_from_the_port_checkpoint():
    """adv-GCNN is fine-tuned from the rot-augmented GCNN's epoch-100
    ``.t7``, which ``cli.train`` writes every 10 epochs."""
    text = (REPO / "scripts" / "train_models_torch.sh").read_text()
    assert ("--resume_path=checkpoints/exp_MODEL_gcnn_DATA_${dataset}_"
            "POINTNUM_1024_clean_with_all_rot_da/models/model_99.t7") in text
    assert "interpret_quality_tpu." not in text
    suite = (REPO / "scripts" / "run_results_suite_torch.sh").read_text()
    assert "interpret_quality_tpu." not in suite
