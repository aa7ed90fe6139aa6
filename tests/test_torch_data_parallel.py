"""The data-parallel train step (``parallel.data_parallel``) over gloo ranks
on the CPU, against the single-process step on the whole batch and
against the JAX package's step sharded over a 4-device ``dp`` mesh (the
step of ``__graft_entry__.dryrun_multichip``, rebuilt here).

The JAX step is the single-device step on the whole batch: BatchNorm's
statistics, the loss's mean and PointNet's regulariser span the global
batch, and the dropout masks are drawn for it from one key.  The port's
step over WORLD ranks is held to the same:

  * against ``trainer.make_train_step`` on the whole batch, from the same
    weights and the same dropout generator seed (dropout on), with a padded
    tail (rows VALID.. of the batch, on the last two ranks): in float64 the
    loss within rtol 1e-12, every gradient within 1e-12 of the model's
    largest, every running statistic within 1e-12 of its buffer's largest
    value, the parameters after the step within 1e-12; in float32 the loss
    and the running statistics within rtol 1e-5, the gradients within 1e-4
    of the largest (f32 sums over another split of the batch, amplified by
    train-mode BatchNorm), the parameters within 1e-6;
  * against the JAX step in float64 with the dropouts off (float32 steps
    of the two packages lie further apart: flax's one-pass variance and
    XLA's sums): the loss within rtol 1e-8, the parameters within 1e-8,
    the batch statistics within 1e-8 of their largest value (at least 1).

The parameters after the step are held through the optimiser's first
step: two gradients within d of each other put SGD's parameters (GCNN) at
most lr * d apart, and Adam's (PointNet; the step lr * g / (|g| + eps),
g with the weight decay) at most lr * eps * d / (m + eps)^2 apart, m the
least |g| within d, and at most 2 lr: where a gradient is 0 up to rounding (a bias that feeds a
BatchNorm) Adam's step is lr times noise on both sides.  So each
parameter is held within the tolerance above plus that allowance, d the
gradients' tolerance.

The clouds lie on a 1/64 grid, so GCNN's kNN sees exact distances in both
packages.  Three tests start ranks: the all-reduce (2 ranks), one module
fixture that runs every step case in one set of 4 ranks, and the dryrun's
command line.
"""
import os
import subprocess
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from interpret_quality_tpu.models import build_model as jax_build_model
from interpret_quality_tpu.models.torch_convert import convert_state_dict
from interpret_quality_tpu.train import trainer as jax_trainer
from interpret_quality_tpu_torch.data.datasets import SyntheticClouds
from interpret_quality_tpu_torch.models import (build_model,
                                                feature_transform_regularizer)
from interpret_quality_tpu_torch.models.common import (BN_EPS, Dropout,
                                                       batch_norm)
from interpret_quality_tpu_torch.parallel import (DPContext, DPGroup,
                                                  shard_batch, spawn)
from interpret_quality_tpu_torch.parallel.dryrun import K
from interpret_quality_tpu_torch.train import losses
from interpret_quality_tpu_torch.train.trainer import (SMOOTHED,
                                                       make_optimizer,
                                                       make_train_step)

import torch_dp_ranks
from test_torch_checkpoint import seeded_state
from test_torch_train_step_edge import no_dropout

WORLD, BATCH, VALID, POINTS, SEED = 4, 8, 5, 64, 1
MODELS = ("pointnet", "gcnn")
F64, F32 = torch.float64, torch.float32
TOL = {F64: dict(loss=1e-12, grad=1e-12, stat=1e-12, param=1e-12),
       F32: dict(loss=1e-5, grad=1e-4, stat=1e-5, param=1e-6)}
JAX_TOL = 1e-8
ADAM_EPS, WEIGHT_DECAY = 1e-8, 1e-4
CASES = [(name, dtype, dropout) for name in MODELS
         for dtype, dropout in ((F64, True), (F32, True), (F64, False))]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def grid_batch():
    """BATCH synthetic clouds of POINTS points on a 1/64 grid, and labels."""
    ds = SyntheticClouds(num_samples=BATCH, num_points=POINTS, seed=3)
    x = np.stack([ds[i][0] for i in range(BATCH)])
    labels = np.array([ds[i][1] for i in range(BATCH)], np.int64)
    return (np.round(x * 64) / 64).astype(np.float64), labels


@pytest.fixture
def one_thread_ranks(monkeypatch):
    """Ranks (and the dryrun's process) on one thread each: the steps are
    small, and the test workers share the machine's cores."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


@pytest.fixture(scope="module")
def dp_runs():
    """Every case's step over WORLD gloo ranks, in one set of ranks, one
    thread each: the results of each rank, keyed by case."""
    x, labels = grid_batch()
    args = [(name, seeded_state(name), x, labels, VALID, SEED, dropout,
             dtype) for name, dtype, dropout in CASES]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        ranks = spawn(torch_dp_ranks.dp_step_cases, WORLD, "gloo",
                      args=(args,))
    return {case: [r[i] for r in ranks] for i, case in enumerate(CASES)}


def single_step(name, dtype, dropout):
    """trainer.make_train_step on the whole batch, as the ranks start it."""
    x, labels = grid_batch()
    model = build_model(name, 10, K)
    model.load_state_dict(seeded_state(name))
    model = model.to(dtype).train()
    for m in model.modules():
        if isinstance(m, Dropout) and not dropout:
            m.eval()
    optimizer, scheduler, _ = make_optimizer(model, name, 1, 1)
    step = make_train_step(model, optimizer, scheduler, name,
                           torch.Generator().manual_seed(SEED))
    loss, preds = step(torch.as_tensor(x, dtype=dtype),
                       torch.as_tensor(labels), VALID)
    return {"loss": loss, "preds": preds,
            "grads": {n: p.grad for n, p in model.named_parameters()},
            "state": model.state_dict()}


def step_allowance(name, grad, p0, d):
    """How far the first steps of two gradients within ``d`` of ``grad``
    may put the parameters ``p0`` apart (see above)."""
    if name != "pointnet":
        return 0.1 * d * torch.ones_like(grad)          # SGD, lr 0.1
    # the least |g| within d of this one bounds the step's slope
    g = ((grad + WEIGHT_DECAY * p0).abs() - d).clamp(min=0)
    return torch.clamp(1e-3 * ADAM_EPS * d / (g + ADAM_EPS) ** 2, max=2e-3)


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
def test_dp_step_matches_the_single_step(dp_runs, name, dtype):
    ranks = dp_runs[(name, dtype, True)]
    want = single_step(name, dtype, dropout=True)
    tol = TOL[dtype]
    for got in ranks:                        # every rank holds the result
        assert torch.equal(got["loss"], ranks[0]["loss"])
        assert torch.equal(got["preds"], want["preds"])
    got = ranks[0]
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=tol["loss"])
    largest = max(float(g.abs().max()) for g in want["grads"].values())
    for key, g in want["grads"].items():
        np.testing.assert_allclose(got["grads"][key].numpy(), g.numpy(),
                                   rtol=0, atol=tol["grad"] * largest,
                                   err_msg=key)
    p0 = seeded_state(name)
    checked = 0
    for key, v in want["state"].items():
        for r in ranks[1:]:
            assert torch.equal(r["state"][key], got["state"][key]), key
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(
                got["state"][key].numpy(), v.numpy(), rtol=0,
                atol=tol["stat"] * float(v.abs().max()), err_msg=key)
            checked += 1
        elif key in want["grads"]:
            allowed = tol["param"] + step_allowance(
                name, want["grads"][key], p0[key].to(dtype),
                tol["grad"] * largest)
            assert bool(((got["state"][key] - v).abs() <= allowed).all()), key
    assert checked > 0


def jax_dp_step(name, x, labels):
    """The JAX package's train step with the batch sharded over a WORLD-
    device ``dp`` mesh and the state replicated (``__graft_entry__.py``'s
    step), in float64 with the dropouts off: (loss, new variables)."""
    state = {k: v.double().numpy() for k, v in seeded_state(name).items()}
    with jax.enable_x64(True):
        variables = convert_state_dict(name, state)
        jmodel = jax_build_model(name, num_classes=10, k=K)
        tx, _ = jax_trainer.make_optimizer(name, steps_per_epoch=1, epochs=1)
        mesh = Mesh(np.array(jax.devices()[:WORLD]), ("dp",))
        batch_sh, repl = NamedSharding(mesh, P("dp")), NamedSharding(mesh, P())
        st = jax.device_put(jax_trainer.TrainState(
            variables["params"], variables["batch_stats"],
            tx.init(variables["params"]), jnp.array(0)), repl)
        step = jax_trainer.make_train_step(jmodel, tx, name,
                                           smoothing=name in SMOOTHED)
        with fnn.intercept_methods(no_dropout):
            new, loss, _ = step(st, jax.device_put(jnp.asarray(x), batch_sh),
                                jax.device_put(jnp.asarray(
                                    labels.astype(np.int32)), batch_sh),
                                jax.random.PRNGKey(SEED), VALID)
        return float(loss), jax.tree_util.tree_map(
            np.asarray, {"params": new.params,
                         "batch_stats": new.batch_stats})


@pytest.mark.parametrize("name", MODELS)
def test_dp_step_matches_the_jax_dp_step(dp_runs, name):
    got = dp_runs[(name, F64, False)][0]
    x, labels = grid_batch()
    want_loss, want = jax_dp_step(name, x, labels)
    np.testing.assert_allclose(float(got["loss"]), want_loss, rtol=JAX_TOL)
    port = convert_state_dict(name, {k: v.numpy()
                                     for k, v in got["state"].items()})
    p0 = seeded_state(name)
    largest = max(float(g.abs().max()) for g in got["grads"].values())
    allowed = convert_state_dict(name, {
        k: (JAX_TOL + step_allowance(name, got["grads"][k], p0[k].double(),
                                     JAX_TOL * largest)).numpy()
        if k in got["grads"] else np.full(v.shape, JAX_TOL)
        for k, v in got["state"].items()})
    leaves = jax.tree_util.tree_leaves_with_path(want)
    assert len(leaves) == len(jax.tree_util.tree_leaves(port))
    for path, ref in leaves:
        val = _at(port, path)
        assert val.dtype == ref.dtype == np.float64
        scale = 1.0 if path[0].key == "params" else \
            max(1.0, float(np.abs(ref).max()))
        assert (np.abs(val - ref) <= _at(allowed, path) * scale).all(), path


def _at(tree, path):
    for p in path:
        tree = tree[p.key]
    return np.asarray(tree)


def test_all_reduce_sum_over_two_ranks(one_thread_ranks):
    """The forward sums x over the ranks on every rank; the backward sums
    the ranks' gradients, so rank r's x gets the gradient of the summed
    shares, 1 + 2 = 3, from both."""
    ranks = spawn(torch_dp_ranks.all_reduce_rank, 2, "gloo")
    for r in ranks:
        assert torch.equal(r["y"], torch.arange(3, dtype=F64) * 3)
        assert torch.equal(r["grad"], torch.full((3,), 3.0, dtype=F64))


def test_layers_without_a_group_are_unchanged():
    """No context active: batch_norm, Dropout, the regulariser and the
    weighted loss compute, bit for bit, the formulas they had before the
    data-parallel step."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(6, 10, 5, generator=g)
    for unbiased in (False, True):
        bn, ref = torch.nn.BatchNorm1d(5), torch.nn.BatchNorm1d(5)
        with torch.no_grad():
            bn.weight.uniform_(0.5, 1.5)
            ref.load_state_dict(bn.state_dict())
        y = batch_norm(x, bn, unbiased)
        mean = x.mean(dim=(0, 1))
        xc = x - mean
        var = xc.square().mean(dim=(0, 1))
        n = 60
        upd = var * (n / (n - 1)) if unbiased else var
        want = xc * (torch.rsqrt(var + BN_EPS) * ref.weight) + ref.bias
        assert torch.equal(y, want)
        assert torch.equal(bn.running_mean, 0.9 * ref.running_mean
                           + 0.1 * mean)
        assert torch.equal(bn.running_var, ref.running_var.mul(0.9)
                           .add(0.1 * upd))
    drop = Dropout(0.3).train()
    got = drop(x, torch.Generator().manual_seed(5))
    mask = torch.rand(x.shape, generator=torch.Generator().manual_seed(5)) \
        < 0.7
    assert torch.equal(got, torch.where(mask, x / 0.7, torch.zeros_like(x)))
    trans = torch.randn(4, 8, 8, generator=g)
    diff = trans @ trans.transpose(-1, -2) - torch.eye(8)
    assert torch.equal(feature_transform_regularizer(trans),
                       torch.linalg.matrix_norm(diff).mean())
    per = torch.randn(7, generator=g)
    w = torch.arange(7) < 5
    assert torch.equal(losses._weighted_mean(per, w),
                       (per * w).sum() / w.sum().clamp(min=1.0))
    assert torch.equal(losses._weighted_mean(per, None), per.mean())


def test_shard_batch_and_rows_refuse_uneven_parts():
    group = DPGroup(3, WORLD, None, torch.device("cpu"))
    x = torch.arange(8)
    assert torch.equal(shard_batch(x, group), torch.tensor([6, 7]))
    with pytest.raises(ValueError, match="equal parts"):
        shard_batch(torch.arange(6), group)
    ctx = DPContext(group, 8)
    assert ctx.rows(2) == slice(6, 8)
    with pytest.raises(ValueError, match="global batch"):
        ctx.rows(3)


def test_spawn_refuses_devices_it_cannot_have(monkeypatch):
    """nccl needs a card per rank, and a card that is not visible is never
    replaced by the CPU; nothing is started."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="nccl"):
        spawn(torch_dp_ranks.all_reduce_rank, 2, "nccl")
    with pytest.raises(RuntimeError, match="0 CUDA devices"):
        spawn(torch_dp_ranks.all_reduce_rank, 2, "nccl",
              devices=["cuda:0", "cuda:1"])


def test_dryrun_on_four_cpu_ranks(tmp_path, one_thread_ranks):
    """python -m interpret_quality_tpu_torch.parallel.dryrun --devices 4
    --device cpu: every step of the JAX dryrun, each announced."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "interpret_quality_tpu_torch.parallel.dryrun",
         "--devices", str(WORLD), "--device", "cpu"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [line for line in proc.stdout.splitlines()
             if line.startswith("[dryrun]")]
    assert [line.split(" ok")[0] for line in lines] == [
        "[dryrun] dp training step", "[dryrun] coalition-split shapley",
        "[dryrun] split enum stage",
        "[dryrun] split interaction-logits stage",
        "[dryrun] split smoothness stage",
        "[dryrun] coalition-split interaction engine"]
    assert f"on {WORLD} devices" in lines[0]
    assert not os.listdir(tmp_path)            # artifacts in a temp folder
