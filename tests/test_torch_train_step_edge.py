"""One train step of the port's DGCNN and GCNN against the JAX package's,
from the same weights on the same batch, and the un-fused eval path
(``fused=False``) against the fused one.

The weights are a seeded port model's with every BatchNorm randomised
(``test_torch_checkpoint.seeded_state``), carried into JAX variables by the
JAX package's own ``convert_state_dict``.  Dropout is off on both sides:
``flax.linen.intercept_methods`` returns the input of every ``nn.Dropout``,
and the port's dropouts are put in eval.  The batch has a padded tail (the
last row's weight is 0).

Both packages run the step in float64 (``jax.enable_x64``, the port model
in double).  In float32 the JAX package is the less exact of the two, and
by more than a tolerance could excuse: flax's BatchNorm takes the one-pass
variance E[x^2] - E[x]^2, which loses digits where a channel's mean^2 is
large against its variance (1e-4 relative at PointNet's first layer), and
XLA's CPU reductions over (B, S, K) lose more (PointNet++'s SA1 gradients
lie up to 0.36 of their norm from a float64 step, the port's within 0.016).
The port takes the two-pass variance, as the reference's torch does.  In
float64 the two packages compute the same function; compared:

  * logits and loss, rtol 1e-9 / atol 1e-10;
  * every parameter's gradient (the JAX gradients mapped onto the port's
    names by ``state_dict_from_jax``, which rounds them to float32), rtol
    1e-6, atol 1e-6 of the tensor's largest magnitude plus 1e-9 of the
    model's: the bias of a layer that feeds a BatchNorm has a gradient
    that is 0 up to rounding;
  * the running statistics after the step (rounded to float32 the same
    way), rtol 1e-6 / atol 1e-9.

The clouds' coordinates are multiples of 1/64, so every xyz selection
(kNN, FPS, ball query) sees exact distances on both sides.  DGCNN re-selects
neighbours in feature space, where two arithmetic orders could pick another
neighbour at a near tie (ROADMAP §3); the test checks that no k-th and
(k+1)-th feature distance of its batch lie within ``TIE_MARGIN`` of each
other, relative to the cloud's largest |x|^2, before it compares.
"""
import contextlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interpret_quality_tpu.models import build_model as jax_build_model
from interpret_quality_tpu.models import \
    feature_transform_regularizer as jax_ft_reg
from interpret_quality_tpu.models.torch_convert import convert_state_dict
from interpret_quality_tpu.train.losses import cal_loss as jax_cal_loss
from interpret_quality_tpu_torch.data.datasets import SyntheticClouds
from interpret_quality_tpu_torch.models import (
    build_model, feature_transform_regularizer, train_forward)
from interpret_quality_tpu_torch.models import dgcnn as port_dgcnn
from interpret_quality_tpu_torch.models.common import Dropout
from interpret_quality_tpu_torch.models.convert import state_dict_from_jax
from interpret_quality_tpu_torch.models.plans import make_plan_fn
from interpret_quality_tpu_torch.train.losses import cal_loss
from interpret_quality_tpu_torch.train.trainer import SMOOTHED

from test_torch_checkpoint import seeded_state

K = 20
B, VALID = 4, 3
TIE_MARGIN = 1e-9
LOGIT_TOL = dict(rtol=1e-9, atol=1e-10)
STAT_TOL = dict(rtol=1e-6, atol=1e-9)
GRAD_REL, GRAD_MODEL_REL, GRAD_RTOL = 1e-6, 1e-9, 1e-6
EVAL_TOL = dict(rtol=1e-4, atol=1e-5)     # float32, as the eval tests


def cloud_batch(n: int, seed: int):
    """B synthetic clouds of n points and their labels, the coordinates
    rounded to multiples of 1/64: every squared distance between them is
    then exact in f32, whatever the order of its sums, so xyz selections
    (FPS, kNN, ball queries) agree exactly across the two packages, and
    distinct shapes keep the batch statistics of the head well apart."""
    ds = SyntheticClouds(num_samples=B, num_points=n, seed=seed)
    x = np.stack([ds[i][0] for i in range(B)])
    labels = np.array([ds[i][1] for i in range(B)], np.int32)
    return (np.round(x * 64) / 64).astype(np.float32), labels


def no_dropout(next_fun, args, kwargs, context):
    """A flax interceptor that returns the input of every nn.Dropout."""
    if isinstance(context.module, fnn.Dropout) and \
            context.method_name == "__call__":
        return args[0]
    return next_fun(*args, **kwargs)


def jax_train_step(name, state, x, labels, valid):
    """The JAX package's loss, logits, gradients and updated batch stats of
    one train step (``trainer.make_train_step``'s loss_fn) in float64 from
    the port's state dict, dropout off."""
    with jax.enable_x64(True):
        variables = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64),
            convert_state_dict(name, {k: v.numpy() for k, v in state.items()}))
        return _jax_train_step(name, variables, x.astype(np.float64), labels,
                               valid)


def _jax_train_step(name, variables, x, labels, valid):
    jmodel = jax_build_model(name, num_classes=10, k=K)
    weights = jnp.arange(x.shape[0]) < valid

    def loss_fn(params, data, lab):
        with fnn.intercept_methods(no_dropout):
            out, mutated = jmodel.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                data, train=True, mutable=["batch_stats"])
        logits, trans_feat = (out[0], out[1]) if isinstance(out, tuple) \
            else (out, None)
        loss = jax_cal_loss(logits, lab, smoothing=name in SMOOTHED,
                            weights=weights)
        if name == "pointnet":
            loss = loss + jax_ft_reg(trans_feat) * 1e-3
        return loss, (logits, mutated["batch_stats"])

    (loss, (logits, stats)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"], jnp.asarray(x),
                                jnp.asarray(labels))
    mapped = state_dict_from_jax(name, jax.tree_util.tree_map(
        np.asarray, {"params": grads, "batch_stats": stats}))
    return float(loss), np.asarray(logits), mapped


def dropout_off(model):
    for m in model.modules():
        if isinstance(m, Dropout):
            m.eval()
    return model


def port_model(name, state, dtype=torch.float64):
    """The port model in training with the state's weights, in ``dtype``,
    its dropouts off."""
    model = build_model(name, num_classes=10, k=K)
    model.load_state_dict(state, strict=True)
    return dropout_off(model.to(dtype).train())


def port_train_step(model, name, x, labels, valid):
    """The port's loss, logits and gradients of one train step (the loss of
    ``trainer.make_train_step``), dropout off; the model keeps its updated
    running statistics."""
    x = torch.as_tensor(x, dtype=next(model.parameters()).dtype)
    logits, trans_feat = train_forward(model, x)
    weights = torch.arange(x.shape[0], device=x.device) < valid
    loss = cal_loss(logits, torch.as_tensor(labels, device=x.device),
                    smoothing=name in SMOOTHED, weights=weights)
    if name == "pointnet":
        loss = loss + feature_transform_regularizer(trans_feat) * 1e-3
    model.zero_grad(set_to_none=True)
    loss.backward()
    return loss.detach(), logits.detach()


def assert_step_agrees(model, loss, logits, want_loss, want_logits, want):
    """Loss, logits, every parameter's gradient and every running statistic
    of the port's model against the JAX step's (``want``: the JAX gradients
    and stats under the port's names)."""
    np.testing.assert_allclose(float(loss), want_loss, **LOGIT_TOL)
    np.testing.assert_allclose(logits.cpu().numpy(), want_logits, **LOGIT_TOL)
    names = [pname for pname, _ in model.named_parameters()]
    floor = GRAD_MODEL_REL * max(float(want[n].abs().max()) for n in names)
    checked = 0
    for pname, p in model.named_parameters():
        got, ref = p.grad.cpu().double().numpy(), want[pname].double().numpy()
        np.testing.assert_allclose(
            got, ref, rtol=GRAD_RTOL,
            atol=GRAD_REL * float(np.abs(ref).max()) + floor, err_msg=pname)
        checked += 1
    for bname, buf in model.named_buffers():
        if bname.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.cpu().double().numpy(),
                                       want[bname].double().numpy(),
                                       err_msg=bname, **STAT_TOL)
    assert checked == len(list(model.parameters()))


@contextlib.contextmanager
def recorded_knn_inputs():
    """The feature rows each kNN selection of the edge-conv forward runs on."""
    rows = []
    original = port_dgcnn.knn

    def knn(query, database, k, select=None):
        rows.append((query.detach().double().cpu(), k))
        return original(query, database, k, select=select)

    port_dgcnn.knn = knn
    try:
        yield rows
    finally:
        port_dgcnn.knn = original


def knn_margin(rows) -> float:
    """Smallest gap between the k-th and (k+1)-th distance of any query
    over the recorded selections, relative to its cloud's largest |x|^2
    (exact, in f64)."""
    worst = np.inf
    for h, k in rows:
        d = ((h[:, :, None] - h[:, None]) ** 2).sum(-1).sort(-1).values
        scale = (h ** 2).sum(-1).amax(-1)[:, None]
        worst = min(worst, float(((d[..., k] - d[..., k - 1]) / scale).min()))
    return worst


@pytest.mark.parametrize("name", ["dgcnn", "gcnn"])
def test_train_step_matches_jax(name):
    x, labels = cloud_batch(64, 0)
    state = seeded_state(name)
    want_loss, want_logits, want = jax_train_step(name, state, x, labels,
                                                  VALID)
    model = port_model(name, state)
    with recorded_knn_inputs() as rows:
        loss, logits = port_train_step(model, name, x, labels, VALID)
    assert len(rows) == (4 if name == "dgcnn" else 1)
    assert knn_margin(rows[1:]) > TIE_MARGIN      # layer 1: xyz, exact
    assert int(model.bn1.num_batches_tracked) == 1
    assert_step_agrees(model, loss, logits, want_loss, want_logits, want)


@pytest.mark.parametrize("name", ["dgcnn", "gcnn"])
def test_unfused_eval_matches_fused(name):
    """fused=False in eval (the differentiable path) gives the fused eval
    logits, with and without a plan; it runs the kNN selection on the same
    rows, so no tie class."""
    torch.manual_seed(0)
    model = build_model(name, num_classes=10, k=K)
    model.load_state_dict(seeded_state(name))
    x = torch.from_numpy(cloud_batch(128, 5)[0])
    plan = make_plan_fn(model)(x)
    with torch.no_grad():
        fused = model(x)
        for kwargs in ({}, {"plan": plan}):
            unfused = model(x, fused=False, **kwargs)
            np.testing.assert_allclose(unfused.numpy(), fused.numpy(),
                                       **EVAL_TOL)


def test_train_mode_refuses_the_fused_path_and_a_missing_generator():
    model = build_model("gcnn", num_classes=10, k=K).train()
    x = torch.from_numpy(cloud_batch(32, 0)[0])
    with pytest.raises(ValueError, match="fused"):
        model(x, fused=True)
    with pytest.raises(ValueError, match="Generator"):
        model(x)
    g = torch.Generator().manual_seed(0)
    a = model(x, generator=g)
    b = model(x, generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b)
    c = model(x, generator=torch.Generator().manual_seed(1))
    assert not torch.equal(a, c)            # another mask
