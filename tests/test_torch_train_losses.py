"""The port's training pieces against the JAX package's: the losses and
PointNet's regulariser, the learning-rate schedules step by step, one and
two optimiser updates, ``balanced_accuracy``, ``prefetch``, and the
train-mode BatchNorm and Dropout of ``models/common.py``.

Tolerances: the losses and the regulariser rtol 1e-6 (float32, a few sums
in another order); the schedules rtol 1e-6 (optax evaluates them in
float32, the port in float64 but for the staircase, which it too takes
in float32); the optimiser updates rtol 1e-12 / atol 1e-14 in float64
(under ``jax.enable_x64``): the same arithmetic; BatchNorm against flax's in
float64, rtol 1e-10 / atol 1e-12 (flax's one-pass variance is exact enough
there).
"""
import threading
import time

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from interpret_quality_tpu.models import \
    feature_transform_regularizer as jax_ft_reg
from interpret_quality_tpu.train import losses as jax_losses
from interpret_quality_tpu.train import trainer as jax_trainer
from interpret_quality_tpu_torch.models import feature_transform_regularizer
from interpret_quality_tpu_torch.models.common import (Dropout, batch_norm,
                                                       bn_apply)
from interpret_quality_tpu_torch.train import losses, trainer

TOL = dict(rtol=1e-6, atol=1e-7)
F64_TOL = dict(rtol=1e-12, atol=1e-14)


def _logits(seed, rows=6, classes=10):
    rng = np.random.RandomState(seed)
    return (3 * rng.randn(rows, classes)).astype(np.float32), \
        rng.randint(0, classes, rows).astype(np.int32)


@pytest.mark.parametrize("fn", ["cross_entropy", "smooth_cross_entropy",
                                "cal_loss_smoothed", "cal_loss_plain"])
@pytest.mark.parametrize("weighted", [False, True])
def test_losses_match_jax(fn, weighted):
    logits, labels = _logits(0 if weighted else 1)
    weights = (np.arange(6) < 4) if weighted else None
    calls = {
        "cross_entropy": lambda m, lg, lb, w: m.cross_entropy(lg, lb, weights=w),
        "smooth_cross_entropy":
            lambda m, lg, lb, w: m.smooth_cross_entropy(lg, lb, weights=w),
        "cal_loss_smoothed":
            lambda m, lg, lb, w: m.cal_loss(lg, lb, True, weights=w),
        "cal_loss_plain": lambda m, lg, lb, w: m.cal_loss(lg, lb, False,
                                                          weights=w)}[fn]
    want = float(calls(jax_losses, jnp.asarray(logits), jnp.asarray(labels),
                       None if weights is None else jnp.asarray(weights)))
    got = float(calls(losses, torch.from_numpy(logits),
                      torch.from_numpy(labels),
                      None if weights is None else torch.from_numpy(weights)))
    np.testing.assert_allclose(got, want, **TOL)
    if weighted:       # the masked rows carry no weight: only rows 0-3 count
        alone = float(calls(losses, torch.from_numpy(logits[:4]),
                            torch.from_numpy(labels[:4]), None))
        np.testing.assert_allclose(got, alone, **TOL)


def test_feature_transform_regularizer_matches_jax():
    rng = np.random.RandomState(2)
    trans = (np.eye(64) + 0.1 * rng.randn(3, 64, 64)).astype(np.float32)
    want = float(jax_ft_reg(jnp.asarray(trans)))
    got = float(feature_transform_regularizer(torch.from_numpy(trans)))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name", ["pointnet", "pointnet2", "pointconv",
                                  "dgcnn", "gcnn", "gcnn_adv"])
def test_schedules_match_optax_step_by_step(name):
    """spe = 5, epochs = 3: the staircases through three of their drops
    (steps 0..400 for PointNet/PointNet++, 0..600 for PointConv), the
    cosine over its 15 steps and past them; and the LambdaLR that
    ``make_optimizer`` returns gives lr(0) at the first step and lr(t) at
    step t."""
    spe, epochs = 5, 3
    want_fn = jax_trainer.lr_schedule_for(name, spe, epochs)
    got_fn = trainer.lr_schedule_for(name, spe, epochs)
    last = {"pointnet": 400, "pointnet2": 400, "pointconv": 600}.get(name, 20)
    steps = np.arange(last + 1)
    want = np.array([float(want_fn(int(t))) for t in steps])
    got = np.array([got_fn(int(t)) for t in steps])
    np.testing.assert_allclose(got, want, **TOL)
    assert len(np.unique(np.round(got, 12))) >= (4 if last > 20 else 16)

    model = torch.nn.Linear(3, 2)
    opt, sched, ep = trainer.make_optimizer(model, name, spe, epochs)
    assert ep == epochs
    seen = []
    for _ in range(20):
        seen.append(opt.param_groups[0]["lr"])
        opt.step()
        sched.step()
    np.testing.assert_allclose(seen, want[:20], **TOL)


@pytest.mark.parametrize("name", ["pointnet", "pointconv", "dgcnn"])
def test_optimizer_updates_match_optax(name):
    """Two updates (Adam for PointNet, SGD with momentum for PointConv and
    DGCNN, L2 1e-4 added to the gradient) from the same params and grads,
    in float64."""
    rng = np.random.RandomState(3)
    w0, b0 = rng.randn(4, 5), rng.randn(4)
    grads = [(rng.randn(4, 5), rng.randn(4)) for _ in range(2)]
    with jax.enable_x64(True):
        tx, _ = jax_trainer.make_optimizer(name, steps_per_epoch=5, epochs=3)
        params = {"w": jnp.asarray(w0), "b": jnp.asarray(b0)}
        state = tx.init(params)
        for gw, gb in grads:
            updates, state = tx.update({"w": jnp.asarray(gw),
                                        "b": jnp.asarray(gb)}, state, params)
            params = optax.apply_updates(params, updates)
        want = {k: np.asarray(v) for k, v in params.items()}
    model = torch.nn.Linear(5, 4).double()
    with torch.no_grad():
        model.weight.copy_(torch.from_numpy(w0))
        model.bias.copy_(torch.from_numpy(b0))
    opt, sched, _ = trainer.make_optimizer(model, name, 5, 3)
    for gw, gb in grads:
        model.weight.grad = torch.from_numpy(gw)
        model.bias.grad = torch.from_numpy(gb)
        opt.step()
        sched.step()
    np.testing.assert_allclose(model.weight.detach().numpy(), want["w"],
                               **F64_TOL)
    np.testing.assert_allclose(model.bias.detach().numpy(), want["b"],
                               **F64_TOL)
    assert not np.allclose(want["w"], w0)


def test_balanced_accuracy_matches_jax():
    rng = np.random.RandomState(4)
    y_true = rng.randint(0, 5, 40)
    y_pred = np.where(rng.rand(40) < 0.6, y_true, rng.randint(0, 5, 40))
    assert trainer.balanced_accuracy(y_true, y_pred) == \
        jax_trainer.balanced_accuracy(y_true, y_pred)
    assert trainer.balanced_accuracy([0, 0, 1], [0, 1, 1]) == 0.75


def test_prefetch_keeps_order_and_releases_its_producer():
    assert list(trainer.prefetch(iter(range(7)))) == list(range(7))
    before = threading.active_count()
    gen = trainer.prefetch(iter(range(1000)))
    assert next(gen) == 0
    gen.close()                                  # the consumer walks away
    deadline = time.time() + 5.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() == before

    def broken():
        yield 1
        raise KeyError("producer failed")
    with pytest.raises(KeyError, match="producer failed"):
        list(trainer.prefetch(broken()))


@pytest.mark.parametrize("shape", [(6, 5), (3, 7, 5), (2, 4, 3, 5)])
def test_batch_norm_matches_flax(shape):
    """The train-mode BatchNorm against flax's ``nn.BatchNorm`` (momentum
    0.9) over every axis but the last, in float64: output, running mean
    and the biased running variance; with ``unbiased_update`` the running
    variance takes n/(n-1), as torch's ``F.batch_norm`` stores it."""
    rng = np.random.RandomState(5)
    x = 2.0 + rng.randn(*shape)
    scale, bias = rng.uniform(0.5, 1.5, 5), rng.randn(5)
    mean0, var0 = rng.randn(5), rng.uniform(0.5, 1.5, 5)
    with jax.enable_x64(True):
        y, upd = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                               epsilon=1e-5).apply(
            {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
             "batch_stats": {"mean": jnp.asarray(mean0),
                             "var": jnp.asarray(var0)}},
            jnp.asarray(x), mutable=["batch_stats"])
        y = np.asarray(y)
        upd = {k: np.asarray(v) for k, v in upd["batch_stats"].items()}

    def bn_module():
        bn = torch.nn.BatchNorm1d(5).double()
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(scale))
            bn.bias.copy_(torch.from_numpy(bias))
            bn.running_mean.copy_(torch.from_numpy(mean0))
            bn.running_var.copy_(torch.from_numpy(var0))
        return bn
    tol = dict(rtol=1e-10, atol=1e-12)
    bn = bn_module()
    got = batch_norm(torch.from_numpy(x), bn)
    np.testing.assert_allclose(got.detach().numpy(), y, **tol)
    np.testing.assert_allclose(bn.running_mean.numpy(), upd["mean"], **tol)
    np.testing.assert_allclose(bn.running_var.numpy(), upd["var"], **tol)
    assert int(bn.num_batches_tracked) == 1

    bn, ref = bn_module(), bn_module()
    got = bn_apply(torch.from_numpy(x), bn.train(), unbiased_update=True)
    flat = torch.from_numpy(x).reshape(-1, 5)
    want = torch.nn.functional.batch_norm(
        flat, ref.running_mean, ref.running_var, ref.weight, ref.bias,
        training=True, momentum=0.1, eps=1e-5)
    np.testing.assert_allclose(got.reshape(-1, 5).detach().numpy(),
                               want.detach().numpy(), **tol)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               ref.running_var.numpy(), **tol)


def test_dropout_draws_from_its_generator_only():
    drop = Dropout(0.4).train()
    x = torch.ones(20000)
    torch.manual_seed(0)
    state = torch.get_rng_state()
    a = drop(x, torch.Generator().manual_seed(7))
    assert torch.equal(torch.get_rng_state(), state)   # global stream untouched
    assert torch.equal(a, drop(x, torch.Generator().manual_seed(7)))
    kept = a != 0
    assert abs(float(kept.float().mean()) - 0.6) < 0.02
    assert torch.allclose(a[kept], torch.full_like(a[kept], 1 / 0.6))
    assert torch.equal(drop.eval()(x), x)
    assert torch.equal(Dropout(0.0).train()(x), x)
    assert drop.state_dict() == {}
