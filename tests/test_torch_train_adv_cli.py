"""``cli.train_adv`` on the CPU: resumed from a ``.t7`` the port wrote and
from a flax ``.msgpack`` the JAX package wrote (``save_variables``) of the
same weights, it writes the same run.log numbers, the three ``.backup``
sources and ``models/model_best.t7`` under the JAX package's experiment
name; ``cli.shapley_value --model gcnn_adv`` then reads that
``model_best.t7`` by its default path (``model_399.t7`` absent); without
``--resume_path`` or ``--allow_random_init`` it refuses to start."""
import os

import numpy as np
import pytest
import torch

from interpret_quality_tpu.models.checkpoint import save_variables
from interpret_quality_tpu.models.torch_convert import convert_state_dict
from interpret_quality_tpu_torch.cli import shapley_value, train_adv
from interpret_quality_tpu_torch.config import ExperimentConfig

from test_torch_checkpoint import seeded_state
from test_torch_train_fit import log_numbers

POINTS = 64
EXP = "exp_MODEL_gcnn_adv_DATA_modelnet10_POINTNUM_%d_clean_with_all_rot_da" \
    % POINTS


def adv_argv(root, *extra):
    return ["--synthetic", "--device", "cpu", "--num_points", str(POINTS),
            "--epochs", "1", "--batch_size", "32", "--best_acc_gate", "0",
            "--checkpoints_root", root, "--train_rot_all_perturbation",
            *extra]


def test_train_adv_resumes_from_t7_and_msgpack(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    state = seeded_state("gcnn")
    t7 = str(tmp_path / "model_99.t7")
    torch.save(state, t7)
    msgpack = str(tmp_path / "model_99.msgpack")
    save_variables(msgpack, convert_state_dict(
        "gcnn", {key: v.numpy() for key, v in state.items()}))

    logs = []
    for name, path in (("t7", t7), ("msgpack", msgpack)):
        root = str(tmp_path / name)
        train_adv.main(adv_argv(root, "--resume_path", path))
        exp = os.path.join(root, EXP)
        assert sorted(f for f in os.listdir(exp) if f.endswith(".backup")) \
            == ["adversarial.py.backup", "config.py.backup",
                "registry.py.backup"]
        with open(exp + "/run.log") as f:
            lines = f.read().splitlines()
        assert lines[0].startswith("Namespace(")
        assert lines[1] == "resumed from %s" % path
        assert [line.split(",")[0] for line in lines[2:]] == [
            "Train 0", "Test 0", "Test adv 0"]
        assert os.listdir(exp + "/models") == ["model_best.t7"]
        logs.append(log_numbers(exp + "/run.log")[0])
    np.testing.assert_allclose(np.concatenate(logs[0]),
                               np.concatenate(logs[1]), rtol=1e-6)

    # the attribution stages read the adv run's model_best.t7 by default
    cfg = ExperimentConfig(model="gcnn_adv", checkpoints_root=str(
        tmp_path / "t7"), num_points=POINTS, num_regions=4,
        num_samples_save=6, device="cpu")
    assert not os.path.exists(cfg.default_model_path())       # model_399
    shapley_value.main(["--model", "gcnn_adv", "--synthetic", "--device",
                        "cpu", "--checkpoints_root", cfg.checkpoints_root,
                        "--num_points", str(POINTS), "--num_regions", "4",
                        "--num_samples_save", "6", "--samples", "0"])
    folder = cfg.exp_folder + "synthetic_00/"
    sv_all = np.load(folder + "region_sv_all.npy")
    nf = float(np.load(folder + "norm_factor.npy"))
    assert sv_all.shape == (6, 4) and np.isfinite(sv_all).all()
    np.testing.assert_allclose(sv_all.sum(1), nf, rtol=1e-4, atol=1e-5)


def test_train_adv_needs_a_checkpoint_or_random_init(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="resume_path"):
        train_adv.main(adv_argv(str(tmp_path / "ck")))
    assert not os.listdir(tmp_path)
    train_adv.main(adv_argv(str(tmp_path / "ck"), "--allow_random_init"))
    assert os.path.exists(tmp_path / "ck" / EXP / "models" / "model_best.t7")
