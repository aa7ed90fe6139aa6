"""``scripts/adv_robustness_torch.py`` against the JAX package's
``scripts/adv_robustness.py`` on the CPU, at 64 points and 2 rotation
draws (the script's flags shrink it; the widths are the real ones).

  * Seeded GCNN and adv-GCNN weights, saved by the JAX package as ``model_best.msgpack`` in one checkpoint tree and by
    the port as ``model_best.t7`` in another: the port reads either, and
    its clean and balanced accuracy equal the JAX script's ``eval_model``
    on the same weights, and their predictions are the JAX eval step's.
    A seeded GCNN predicts one class for every cloud, so each model's
    running statistics are first set by CALIBRATION train-mode forwards
    of the test clouds: its predictions then vary from cloud to cloud.
  * The rotation eval: both scripts' ``random_rotation_eval_batch`` patched
    to return the same rotated clouds, call by call (the two random
    streams differ by design), give the same mean and spread.
  * A checkpoint tree without a model is recorded as missing, not raised.
"""
import functools
import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interpret_quality_tpu.data.datasets import SyntheticClouds as JaxClouds
from interpret_quality_tpu.models import build_model as jax_build_model
from interpret_quality_tpu.models.checkpoint import save_variables
from interpret_quality_tpu.models.torch_convert import convert_state_dict
from interpret_quality_tpu.train.trainer import make_eval_step
from interpret_quality_tpu_torch.data.datasets import SyntheticClouds
from interpret_quality_tpu_torch.models import build_model
from interpret_quality_tpu_torch.models.common import Dropout
from interpret_quality_tpu_torch.train.trainer import evaluate, save_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POINTS, DRAWS, SAMPLES = 64, 2, 16
SEEDS = {"gcnn": 1, "gcnn_adv": 2}
CALIBRATION = 20
CPU = torch.device("cpu")


def _script(name, module):
    spec = importlib.util.spec_from_file_location(
        module, os.path.join(REPO, "scripts", name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scripts():
    return (_script("adv_robustness_torch.py", "adv_robustness_torch"),
            _script("adv_robustness.py", "adv_robustness_jax"))


@pytest.fixture(scope="module")
def jax_eval_step():
    """The JAX script's eval step of GCNN, compiled once for the module."""
    return make_eval_step(jax_build_model("gcnn", 10, 20), smoothing=True)


@functools.lru_cache(maxsize=None)
def calibrated_state(seed):
    """A seeded GCNN's state dict, its running statistics those of the
    test clouds (CALIBRATION train-mode forwards, dropouts off)."""
    ds = SyntheticClouds(num_samples=SAMPLES, num_points=POINTS, seed=2)
    x = torch.from_numpy(np.stack([ds[i][0] for i in range(SAMPLES)]))
    torch.manual_seed(seed)
    model = build_model("gcnn", 10, 20).train()
    for m in model.modules():
        if isinstance(m, Dropout):
            m.eval()
    with torch.no_grad():
        for _ in range(CALIBRATION):
            model(x)
    return {k: v.clone() for k, v in model.eval().state_dict().items()}


def write_tree(root, port, fmt):
    """Both models' weights under ``root`` in the script's run folders, as
    the port's .t7 or the JAX package's .msgpack."""
    for name, seed in SEEDS.items():
        state = calibrated_state(seed)
        path = os.path.join(root, port.RUNS[name], "model_best." + fmt)
        if fmt == "t7":
            os.makedirs(os.path.dirname(path))
            model = build_model("gcnn", 10, 20)
            model.load_state_dict(state)
            save_state(model, path)
        else:
            save_variables(path, convert_state_dict(
                "gcnn", {k: v.numpy() for k, v in state.items()}))


def jax_variables(name):
    return convert_state_dict("gcnn", {
        k: v.numpy() for k, v in calibrated_state(SEEDS[name]).items()})


@pytest.mark.parametrize("fmt", ["t7", "msgpack"])
def test_clean_accuracy_matches_the_jax_script(scripts, jax_eval_step,
                                               tmp_path, fmt):
    port, jscript = scripts
    write_tree(str(tmp_path), port, fmt)
    out = port.run(CPU, str(tmp_path), POINTS, rot_draws=1,
                   num_samples=SAMPLES)
    eval_step = jax_eval_step
    test_ds = JaxClouds(num_samples=SAMPLES, num_points=POINTS, seed=2)
    data, labels, _ = next(test_ds.batches(SAMPLES, shuffle=False))
    for name in SEEDS:
        rec = out["models"][name]
        assert rec["checkpoint"].endswith("model_best." + fmt)
        acc, bal = jscript.eval_model(jax_variables(name), eval_step, test_ds)
        assert (rec["clean_acc"], rec["clean_balanced_acc"]) == (acc, bal)
        assert 0.0 <= rec["rot_robust_acc_mean"] <= 1.0
        want = np.asarray(eval_step(jax_variables(name), jnp.asarray(data),
                                    jnp.asarray(labels))[1])
        _, _, got = evaluate(port.load_gcnn(rec["checkpoint"], CPU),
                             port.SyntheticClouds(SAMPLES, POINTS, seed=2),
                             SAMPLES, True, CPU)
        assert np.array_equal(got, want) and len(set(want.tolist())) > 1


def fixed_rotations(n_calls, make):
    """A stand-in for random_rotation_eval_batch: call i rotates the batch
    by the i-th of n_calls seeded rotation matrices (``make`` turns the
    rotated numpy clouds into the script's array type)."""
    rng = np.random.RandomState(0)
    mats = [np.linalg.qr(rng.randn(3, 3))[0] for _ in range(n_calls)]
    calls = []

    def rotate(_rng, data):
        out = np.asarray(data, np.float64) @ mats[len(calls)].T
        calls.append(None)
        return make(out.astype(np.float32))
    return rotate, calls


def test_rot_robustness_matches_the_jax_script_on_the_same_clouds(
        scripts, jax_eval_step, tmp_path, monkeypatch):
    port, jscript = scripts
    n_calls = DRAWS                       # one batch of 16 clouds a draw
    port_rot, port_calls = fixed_rotations(n_calls, torch.from_numpy)
    jax_rot, jax_calls = fixed_rotations(n_calls, jnp.asarray)
    monkeypatch.setattr(port, "random_rotation_eval_batch", port_rot)
    monkeypatch.setattr(jscript, "random_rotation_eval_batch", jax_rot)
    monkeypatch.setattr(jscript, "ROT_DRAWS", DRAWS)
    write_tree(str(tmp_path), port, "t7")
    model = port.load_gcnn(os.path.join(
        str(tmp_path), port.RUNS["gcnn_adv"], "model_best.t7"), CPU)
    got = port.eval_rot_robustness(
        model, port.SyntheticClouds(num_samples=SAMPLES, num_points=POINTS,
                                    seed=2), CPU, DRAWS)
    want = jscript.eval_rot_robustness(
        jax_variables("gcnn_adv"), jax_eval_step,
        JaxClouds(num_samples=SAMPLES, num_points=POINTS, seed=2))
    assert len(port_calls) == len(jax_calls) == n_calls
    assert got == want


def test_a_missing_checkpoint_is_recorded(scripts, tmp_path):
    port, _ = scripts
    write_tree(str(tmp_path / "ck"), port, "t7")
    os.remove(os.path.join(str(tmp_path / "ck"), port.RUNS["gcnn"],
                           "model_best.t7"))
    out_path = tmp_path / "out" / "rob.json"
    port.main(["--device", "cpu", "--checkpoints_root",
               str(tmp_path / "ck"), "--out", str(out_path),
               "--num_points", str(POINTS), "--rot_draws", "1",
               "--num_samples", "4"])
    out = json.loads(out_path.read_text())
    assert out["models"]["gcnn"] == {"error": "checkpoint missing: " + (
        os.path.join(str(tmp_path / "ck"), port.RUNS["gcnn"],
                     "model_best.*"))}
    rec = out["models"]["gcnn_adv"]
    assert set(rec) == {"checkpoint", "clean_acc", "clean_balanced_acc",
                        "rot_robust_acc_mean", "rot_robust_acc_std"}
    assert all(0.0 <= rec[k] <= 1.0 for k in rec if k != "checkpoint")
    assert out["device"] == "cpu" and "card" not in out
