"""One adversarial train step of the port's GCNN against the JAX package's
``adv_step`` (as ``fit_adversarial`` builds it), and ``fit_adversarial``
against the JAX one for an epoch.

The JAX step is rebuilt here from the JAX package's own pieces, line for
line as ``interpret_quality_tpu/train/adversarial.py`` builds it inside
``fit_adversarial`` (the BIM variants of ``make_adv_batch_fn``, two
train-mode ``value_and_grad`` passes from the same parameters, the second
on the first's batch statistics, the gradients summed into one update of
``make_optimizer("gcnn_adv", ...)``), with dropout off through the flax
interceptor of ``test_torch_train_step_edge``; the port's dropouts are in
eval (the attack restores each module's own mode, so they stay off; in
``fit_adversarial``, which puts the model in training every epoch, they
have p = 0).  Both sides run in float64 from a seeded port model's
weights with every BatchNorm randomised, carried into JAX variables by the
JAX package's ``convert_state_dict``; the port's state goes back the same
way, so the comparison stays in float64.  Two steps: a full batch, then a
padded one (``valid < batch``), so the momentum buffer and the schedule's
second value are exercised.  Compared within 1e-8 relative: the logged loss
(l1 + l2), both variants' predictions, every parameter after each step and
every running statistic after both forwards.

The clouds are random and non-grid, for the reasons of
``test_torch_adversarial.py``: the test asserts the kNN gap of the input
clouds (rotations and translations keep every distance) and |g_alpha| at
every attack step before it compares.
"""
import os
import re

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from interpret_quality_tpu.data.datasets import \
    SyntheticClouds as JaxSyntheticClouds
from interpret_quality_tpu.models import build_model as jax_build_model
from interpret_quality_tpu.models.torch_convert import convert_state_dict
from interpret_quality_tpu.train import adversarial as jax_adv
from interpret_quality_tpu.train.losses import cal_loss as jax_cal_loss
from interpret_quality_tpu.train.trainer import \
    make_optimizer as jax_make_optimizer
from interpret_quality_tpu.utils.io import IOStream as JaxIOStream
from interpret_quality_tpu_torch.data.datasets import SyntheticClouds
from interpret_quality_tpu_torch.models import build_model
from interpret_quality_tpu_torch.models.common import Dropout
from interpret_quality_tpu_torch.train import adversarial as adv
from interpret_quality_tpu_torch.train.trainer import make_optimizer
from interpret_quality_tpu_torch.utils.io import IOStream

from test_torch_adversarial import (G_ALPHA_FLOOR, GRAD_MARGIN, knn_gap,
                                    recorded_alpha_gradients)
from test_torch_checkpoint import seeded_state
from test_torch_train_fit import Float64Clouds, log_numbers
from test_torch_train_step_edge import dropout_off, no_dropout

B, N, K = 4, 96, 8
STEPS_PER_EPOCH, EPOCHS = 2, 3
TOL = dict(rtol=1e-8, atol=1e-10)


def flat(tree, prefix=()):
    """{path: array} of a nested dict."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(flat(value, prefix + (key,)))
        else:
            out[prefix + (key,)] = np.asarray(value)
    return out


def jax_adv_steps(state, batches):
    """The JAX package's adv_step of ``fit_adversarial`` over ``batches``
    of (data, labels, valid), dropout off, in float64: per step (loss,
    preds1, preds2, variables after the step)."""
    with jax.enable_x64(True):
        variables = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64),
            convert_state_dict("gcnn", {key: v.numpy()
                                        for key, v in state.items()}))
        model = jax_build_model("gcnn", num_classes=10, k=K)
        tx, _ = jax_make_optimizer("gcnn_adv", STEPS_PER_EPOCH, EPOCHS)
        gen_adv = jax_adv.make_adv_batch_fn(model)

        def loss_fn(params, batch_stats, data, labels, weights):
            with fnn.intercept_methods(no_dropout):
                out, mutated = model.apply(
                    {"params": params, "batch_stats": batch_stats}, data,
                    train=True, mutable=["batch_stats"])
            return jax_cal_loss(out, labels, smoothing=True,
                                weights=weights), (out, mutated["batch_stats"])

        @jax.jit
        def adv_step(params, batch_stats, opt_state, data, labels, valid):
            weights = jnp.arange(data.shape[0]) < valid
            data_rot, data_disturb = gen_adv(
                {"params": params, "batch_stats": batch_stats}, data, labels)
            grad = jax.value_and_grad(loss_fn, has_aux=True)
            (l1, (lg1, bs1)), g1 = grad(params, batch_stats, data_rot,
                                        labels, weights)
            (l2, (lg2, bs2)), g2 = grad(params, bs1, data_disturb, labels,
                                        weights)
            grads = jax.tree_util.tree_map(lambda a, b: a + b, g1, g2)
            updates, new_opt = tx.update(grads, opt_state, params)
            return (optax.apply_updates(params, updates), bs2, new_opt,
                    l1 + l2, jnp.argmax(lg1, -1), jnp.argmax(lg2, -1))

        params, stats = variables["params"], variables["batch_stats"]
        opt_state = tx.init(params)
        out = []
        for data, labels, valid in batches:
            params, stats, opt_state, loss, p1, p2 = adv_step(
                params, stats, opt_state, jnp.asarray(data),
                jnp.asarray(labels), valid)
            out.append((float(loss), np.asarray(p1), np.asarray(p2),
                        flat({"params": params, "batch_stats": stats})))
        return out


def test_adv_steps_match_jax(monkeypatch):
    rng = np.random.RandomState(0)
    batches = [(rng.uniform(-1, 1, (B, N, 3)),
                rng.randint(0, 10, B).astype(np.int32), valid)
               for valid in (B, B - 1)]
    for data, _, _ in batches:
        assert knn_gap(data, K) > GRAD_MARGIN
    state = seeded_state("gcnn")
    want = jax_adv_steps(state, batches)

    model = build_model("gcnn", num_classes=10, k=K)
    model.load_state_dict(state, strict=True)
    model = dropout_off(model.double().train())
    optimizer, scheduler, _ = make_optimizer(model, "gcnn_adv",
                                             STEPS_PER_EPOCH, EPOCHS)
    step = adv.make_adv_step(model, optimizer, scheduler)
    g_alpha = recorded_alpha_gradients(monkeypatch)
    for i, ((data, labels, valid), (w_loss, w_p1, w_p2, w_vars)) in \
            enumerate(zip(batches, want)):
        loss, p1, p2 = step(torch.from_numpy(data),
                            torch.from_numpy(labels).long(), valid)
        assert model.training
        assert int(model.bn5.num_batches_tracked) == 2 * (i + 1)
        np.testing.assert_allclose(float(loss), w_loss, **TOL)
        assert np.array_equal(p1.numpy(), w_p1)
        assert np.array_equal(p2.numpy(), w_p2)
        got = flat(convert_state_dict("gcnn", {
            key: v.detach() for key, v in model.state_dict().items()}))
        assert got.keys() == w_vars.keys()
        for path, value in w_vars.items():
            np.testing.assert_allclose(got[path], value, err_msg=str(path),
                                       **TOL)
    assert len(g_alpha) == 2 * adv.ROT_ADV_ITER
    assert float(torch.stack([g.abs().min() for g in g_alpha]).min()) \
        > G_ALPHA_FLOOR


LINE_FORMATS = (r"Train 0, loss: \d+\.\d{6}, train acc: \d\.\d{6} "
                r"\(\d+\.\ds\)",
                r"Test 0, loss: \d+\.\d{6}, test acc: \d\.\d{6}, test avg "
                r"acc: \d\.\d{6}",
                r"Test adv 0, rot-robust acc: \d\.\d{6}")


def test_fit_adversarial_epoch_matches_jax(tmp_path):
    """One epoch at 48 points, k = 4, batch 4 over 7 training clouds (two
    steps, the second padded) in float64, dropout off on both sides, from
    the same weights and numpy seed: the three log lines in the JAX
    formats, the Train and Test lines' numbers within rtol 1e-6 (the
    rotation eval draws from another generator, so its accuracy is only
    checked for its form), finite parameters, and model_best.t7 with
    gate 0."""
    n, k, n_train, n_test, batch = 48, 4, 7, 4, 4
    kw = dict(num_points=n, num_classes=3)
    torch.manual_seed(0)
    model = build_model("gcnn", num_classes=3, k=k)
    state = {key: v.clone() for key, v in model.state_dict().items()}

    jdir = str(tmp_path / "jax")
    os.makedirs(jdir)
    with jax.enable_x64(True):
        variables = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64),
            convert_state_dict("gcnn", {key: v.numpy()
                                        for key, v in state.items()}))
        np.random.seed(5)
        with fnn.intercept_methods(no_dropout):
            jax_adv.fit_adversarial(
                jax_build_model("gcnn", num_classes=3, k=k), variables,
                "gcnn_adv",
                Float64Clouds(JaxSyntheticClouds(n_train, seed=0, train=True,
                                                 **kw)),
                Float64Clouds(JaxSyntheticClouds(n_test, seed=1, **kw)),
                batch_size=batch, test_batch_size=batch, epochs=1,
                exp_dir=jdir, io=JaxIOStream(jdir + "/run.log"), seed=0,
                best_acc_gate=0.0)

    for m in model.double().modules():      # fit calls model.train()
        if isinstance(m, Dropout):
            m.p = 0.0
    pdir = str(tmp_path / "port")
    np.random.seed(5)
    with IOStream(str(tmp_path / "port_run.log")) as io:
        _, best = adv.fit_adversarial(
            model, "gcnn_adv",
            Float64Clouds(SyntheticClouds(n_train, seed=0, train=True, **kw)),
            Float64Clouds(SyntheticClouds(n_test, seed=1, **kw)),
            batch_size=batch, test_batch_size=batch, epochs=1, exp_dir=pdir,
            io=io, seed=0, best_acc_gate=0.0)

    with open(tmp_path / "port_run.log") as f:
        lines = f.read().splitlines()
    assert len(lines) == 3
    for line, form in zip(lines, LINE_FORMATS):
        assert re.fullmatch(form, line), line
    got, _ = log_numbers(str(tmp_path / "port_run.log"))
    want, _ = log_numbers(jdir + "/run.log")
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g, w, rtol=1e-6)
    assert int(model.bn5.num_batches_tracked) == 4      # 2 steps x 2 passes
    assert all(torch.isfinite(p).all() for p in model.parameters())
    assert not torch.equal(model.linear3.weight.float(),
                           state["linear3.weight"])
    assert best == float(got[1][1])
    saved = torch.load(pdir + "/models/model_best.t7")
    final = model.state_dict()
    assert all(torch.equal(saved[key], final[key]) for key in final)
