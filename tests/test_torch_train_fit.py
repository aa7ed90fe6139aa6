"""The port's ``fit`` against the JAX package's, one epoch of PointNet (64
points, Adam) and of GCNN (48 points, k = 4, SGD and label smoothing),
and ``cli.train`` end to end on the CPU.

Both ``fit`` runs start from the same weights (a seeded port model carried
into JAX variables by the JAX package's ``convert_state_dict``) and the
same numpy seed, which fixes the batches' shuffle and augmentations: the
prefetch thread is the only consumer of numpy's global stream on either
side.  Dropout is off (flax's interceptor on the JAX side, p = 0 on the
port's ``Dropout``).  The training set's size leaves a padded tail batch.
Both run in float64 (``jax.enable_x64``; the datasets yield float64
clouds), for the reasons of ``test_torch_train_step_edge.py``; in float32
Adam would turn the rounding noise of a gradient that is 0 (a bias before a
BatchNorm) into steps of +-lr.  Compared: every number of the run.log lines
(the epoch's time aside) at rtol 1e-6, the "new best" lines, and the final
parameters and running statistics at rtol 1e-6 / atol 1e-7 (the JAX
variables are rounded to float32 on their way to the port's names).
"""
import os
import re

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

from interpret_quality_tpu.data.datasets import \
    SyntheticClouds as JaxSyntheticClouds
from interpret_quality_tpu.models import build_model as jax_build_model
from interpret_quality_tpu.models.torch_convert import convert_state_dict
from interpret_quality_tpu.train.trainer import fit as jax_fit
from interpret_quality_tpu.utils.io import IOStream as JaxIOStream
from interpret_quality_tpu_torch.config import ExperimentConfig
from interpret_quality_tpu_torch.data.datasets import SyntheticClouds
from interpret_quality_tpu_torch.models import build_model
from interpret_quality_tpu_torch.models.common import Dropout
from interpret_quality_tpu_torch.models.convert import state_dict_from_jax
from interpret_quality_tpu_torch.pipeline import load_frozen_model
from interpret_quality_tpu_torch.train.trainer import fit
from interpret_quality_tpu_torch.utils.io import IOStream

from test_torch_train_step_edge import no_dropout

NUMBER = re.compile(r"[-+]?\d+\.\d+")
FIT_CASES = {   # name: (points, k, train samples, batch, test samples)
    "pointnet": (64, 20, 10, 4, 6),
    "gcnn": (48, 4, 10, 4, 6),
}


class Float64Clouds:
    """A dataset whose batches are float64 clouds."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def batches(self, *args, **kwargs):
        for data, labels, valid in self.ds.batches(*args, **kwargs):
            yield data.astype(np.float64), labels, valid


def log_numbers(path):
    """(Train/Test lines' numbers without the epoch time, other lines)."""
    numbers, other = [], []
    with open(path) as f:
        for line in f:
            if line.startswith(("Train", "Test")):
                line = re.sub(r"\(\d+\.\ds\)", "", line)
                numbers.append([float(v) for v in NUMBER.findall(line)])
            else:
                other.append(line.strip())
    return numbers, other


@pytest.mark.parametrize("name", ["pointnet", "gcnn"])
def test_one_fit_epoch_matches_jax(name, tmp_path):
    n, k, n_train, batch, n_test = FIT_CASES[name]
    torch.manual_seed(0)
    model = build_model(name, num_classes=3, k=k)
    state = {key: v.clone() for key, v in model.state_dict().items()}
    kw = dict(num_points=n, num_classes=3)

    with jax.enable_x64(True):
        variables = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64),
            convert_state_dict(name, {key: v.numpy()
                                      for key, v in state.items()}))
        np.random.seed(5)
        jdir = str(tmp_path / "jax")
        os.makedirs(jdir)
        with fnn.intercept_methods(no_dropout):
            jstate, jbest = jax_fit(
                jax_build_model(name, num_classes=3, k=k), variables, name,
                Float64Clouds(JaxSyntheticClouds(n_train, seed=0, train=True,
                                                 **kw)),
                Float64Clouds(JaxSyntheticClouds(n_test, seed=1, **kw)),
                batch_size=batch, test_batch_size=batch, epochs=1,
                exp_dir=jdir, io=JaxIOStream(jdir + "/run.log"), seed=0,
                best_acc_gate=0.0)
        want = state_dict_from_jax(name, jax.tree_util.tree_map(
            np.asarray, jstate.variables), k=k)

    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    model.double()
    np.random.seed(5)
    pdir = str(tmp_path / "port")
    with IOStream(pdir + "_run.log") as io:
        _, best = fit(model, name,
                      Float64Clouds(SyntheticClouds(n_train, seed=0,
                                                    train=True, **kw)),
                      Float64Clouds(SyntheticClouds(n_test, seed=1, **kw)),
                      batch_size=batch, test_batch_size=batch, epochs=1,
                      exp_dir=pdir, io=io, seed=0, best_acc_gate=0.0)

    got_numbers, got_other = log_numbers(pdir + "_run.log")
    want_numbers, want_other = log_numbers(jdir + "/run.log")
    assert len(got_numbers) == 2 and got_other == want_other == \
        ["#### new best ####"]
    np.testing.assert_allclose(np.array(got_numbers), np.array(want_numbers),
                               rtol=1e-6)
    assert best == jbest
    assert os.path.exists(pdir + "/models/model_best.t7")
    final = model.state_dict()
    assert int(final["bn1.num_batches_tracked"] if name == "pointnet"
               else final["bn5.num_batches_tracked"]) == 3   # 3 steps
    for key, value in want.items():
        if not key.endswith("num_batches_tracked"):
            np.testing.assert_allclose(final[key].numpy(), value.numpy(),
                                       rtol=1e-6, atol=1e-7, err_msg=key)
    assert not torch.allclose(final["fc3.weight" if name == "pointnet"
                                    else "linear3.weight"].float(),
                              state["fc3.weight" if name == "pointnet"
                                    else "linear3.weight"])
    saved = torch.load(pdir + "/models/model_best.t7")
    assert all(torch.equal(saved[key], final[key]) for key in final)


def train_argv(root, *extra):
    return ["--model", "gcnn", "--synthetic", "--device", "cpu",
            "--num_points", "64", "--epochs", "1", "--train_samples", "6",
            "--test_samples", "4", "--batch_size", "4",
            "--test_batch_size", "4", "--best_acc_gate", "0",
            "--checkpoints_root", root, *extra]


def test_cli_train_then_shapley_reads_its_checkpoint(tmp_path, monkeypatch):
    """cli.train on the CPU writes run.log, the .backup sources and
    models/model_best.t7 in the reference's naming; cli.shapley_value
    loads that file by its default path (no --allow_random_init) and
    writes finite, efficient estimates."""
    from interpret_quality_tpu_torch.cli import shapley_value, train
    monkeypatch.chdir(tmp_path)
    root = str(tmp_path / "ck")
    train.main(train_argv(root))
    cfg = ExperimentConfig(model="gcnn", checkpoints_root=root, num_points=64,
                           num_regions=4, num_samples_save=6, device="cpu")
    exp = os.path.dirname(os.path.dirname(cfg.default_model_path()))
    assert sorted(f for f in os.listdir(exp) if f.endswith(".backup")) == [
        "config.py.backup", "datasets.py.backup", "registry.py.backup",
        "trainer.py.backup"]
    with open(exp + "/run.log") as f:
        lines = f.read().splitlines()
    assert lines[0].startswith("Namespace(") and lines[1].startswith("Train 0")
    assert lines[2].startswith("Test 0") and lines[3] == "#### new best ####"
    saved = torch.load(cfg.default_model_path())
    model, _, _ = load_frozen_model(cfg)
    assert all(torch.equal(model.state_dict()[key], value)
               for key, value in saved.items())
    shapley_value.main(["--model", "gcnn", "--synthetic", "--device", "cpu",
                        "--checkpoints_root", root, "--num_points", "64",
                        "--num_regions", "4", "--num_samples_save", "6",
                        "--samples", "0"])
    folder = cfg.exp_folder + "synthetic_00/"
    sv_all = np.load(folder + "region_sv_all.npy")
    nf = float(np.load(folder + "norm_factor.npy"))
    assert sv_all.shape == (6, 4) and np.isfinite(sv_all).all()
    np.testing.assert_allclose(sv_all.sum(1), nf, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("flag,suffix", [
    ("--train_rot_y_perturbation", "_with_y_rot_da"),
    ("--train_rot_all_perturbation", "_with_all_rot_da")])
def test_cli_train_folder_suffix(flag, suffix, tmp_path, monkeypatch):
    from interpret_quality_tpu_torch.cli import train
    monkeypatch.chdir(tmp_path)
    train.main(train_argv(str(tmp_path / "ck"), flag))
    exp = tmp_path / "ck" / ("exp_MODEL_gcnn_DATA_modelnet10_POINTNUM_64_clean"
                             + suffix)
    assert (exp / "models" / "model_best.t7").exists()
    assert (exp / "run.log").exists() and (exp / "trainer.py.backup").exists()
