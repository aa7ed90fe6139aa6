"""The port's PointNet, PointNet++ and PointConv against the JAX package's,
on the same weights, and the three repairs of the forward wrapper and the
weight bridge that these families need.

Random JAX variables get every BatchNorm overwritten with random running
statistics and scales of both signs (``test_torch_models.random_variables``)
and are carried into the port with ``state_dict_from_jax`` (strict=True).
Logits are compared with the JAX XLA path (``fused=False``) on a
masked-coalition batch of a 256-point cloud, with and without the plan, at
rtol 1e-4, atol 1e-4: f32 sums in another order, and the port folds each
BatchNorm into its layer (as the JAX fused path does) where the XLA path
applies it after the layer.  Plans are compared exactly (FPS and kNN
indices) and within 1e-5 relative (densities).  No row needs the near-tie
exception of the edge-conv tests here: xyz-space selections on this cloud
have no tie at f32 noise, so every row is held to the tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interpret_quality_tpu.models.plans import make_plan_fn as jax_plan_fn
from interpret_quality_tpu.models.torch_convert import export_state_dict
from interpret_quality_tpu_torch.attrib.coalitions import (
    keep_matrix_from_orders, masked_coalitions)
from interpret_quality_tpu_torch.models import build_model, make_forward_fn
from interpret_quality_tpu_torch.models.convert import state_dict_from_jax
from interpret_quality_tpu_torch.models.plans import make_plan_fn

from test_torch_models import random_variables

N = 256
TOL = dict(rtol=1e-4, atol=1e-4)


def coalition_batch() -> np.ndarray:
    """One 256-point cloud masked into 2 orders x 5 rows."""
    rng = np.random.RandomState(11)
    cloud = rng.randn(N, 3).astype(np.float32)
    cloud /= np.sqrt((cloud ** 2).sum(-1)).max()
    region_id = torch.from_numpy(rng.randint(0, 4, N))
    orders = np.stack([rng.permutation(4) for _ in range(2)])
    keep = torch.from_numpy(keep_matrix_from_orders(orders))
    data = torch.from_numpy(cloud)
    return masked_coalitions(data, data.mean(0), keep, region_id).numpy()


def port_model(name, variables):
    model = build_model(name, num_classes=10)
    model.load_state_dict(state_dict_from_jax(name, variables), strict=True)
    return model


def _jax_logits(jmodel, variables, x, **kwargs):
    if jmodel.__class__.__name__ != "PointNetCls":     # it has no fused path
        kwargs["fused"] = False
    out = jax.jit(lambda v, x: jmodel.apply(v, x, train=False, **kwargs))(
        variables, jnp.asarray(x))
    return np.asarray(out[0] if isinstance(out, tuple) else out)


def _assert_plans_equal(got, want):
    got_leaves = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda t: t.numpy(), got,
                               is_leaf=lambda t: isinstance(t, torch.Tensor)))
    want_leaves = [np.asarray(w) for w in jax.tree_util.tree_leaves(want)]
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        assert g.shape == w.shape
        if w.dtype == np.int32:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5)


@pytest.mark.parametrize("name,with_plan", [
    ("pointnet", False), ("pointnet2", False), ("pointnet2", True),
    ("pointconv", False), ("pointconv", True)])
def test_logits_match_jax(name, with_plan):
    jmodel, variables = random_variables(name)
    x = coalition_batch()
    fwd = make_forward_fn(port_model(name, variables))
    xt = torch.from_numpy(x)
    kwargs = {}
    with torch.inference_mode():
        if with_plan:
            plan = fwd.plan_fn(xt)
            kwargs["plan"] = jax_plan_fn(jmodel, fused=False)(jnp.asarray(x))
            _assert_plans_equal(plan, kwargs["plan"])
            got = fwd.apply_plan_fn(xt, plan).numpy()
        else:
            got = fwd(xt).numpy()
    want = _jax_logits(jmodel, variables, x, **kwargs)
    assert got.shape == want.shape == (x.shape[0], 10)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name", ["pointnet", "pointnet2", "pointconv"])
def test_state_dict_equals_jax_export(name):
    _, variables = random_variables(name)
    ours = state_dict_from_jax(name, variables)
    template = build_model(name, num_classes=10).state_dict()
    theirs = export_state_dict(name, variables, template=template)
    assert set(ours) == set(theirs) == set(template)
    for key in theirs:
        np.testing.assert_array_equal(ours[key].numpy(), theirs[key],
                                      err_msg=key)
    build_model(name, num_classes=10).load_state_dict(ours, strict=True)


# ------------------------------------------------------------- repairs
@pytest.mark.parametrize("name,last", [("pointnet", "fc3"),
                                       ("pointconv", "fc3"),
                                       ("dgcnn", "linear3")])
def test_num_classes_read_from_the_last_layer(name, last):
    """state_dict_from_jax reads num_classes from the family's last layer:
    fc3 (PointNet, PointNet++, PointConv) or linear3 (edge-conv)."""
    _, variables = random_variables(name)
    params = dict(variables["params"])
    kernel = np.asarray(params[last]["kernel"])
    params[last] = {"kernel": np.ones((kernel.shape[0], 40), np.float32),
                    "bias": np.zeros(40, np.float32)}
    state = state_dict_from_jax(name, {**variables, "params": params})
    assert state[f"{last}.weight"].shape == (40, kernel.shape[0])
    build_model(name, num_classes=40).load_state_dict(state, strict=True)


def test_plan_fn_is_none_for_a_family_without_a_plan():
    """PointNet has no plan: plan_fn returns None and apply_plan_fn with
    None is the plain forward; make_plan_fn still raises for a model it
    does not know."""
    fwd = make_forward_fn(build_model("pointnet"))
    x = torch.from_numpy(coalition_batch()[:3])
    with torch.inference_mode():
        assert fwd.plan_fn(x) is None
        torch.testing.assert_close(fwd.apply_plan_fn(x, None), fwd(x))
    with pytest.raises(NotImplementedError):
        make_plan_fn(torch.nn.Linear(3, 3))


class _TupleModel(torch.nn.Module):
    """Returns (logits, extra) like PointNet, and takes a plan."""

    def forward(self, x, plan=None):
        logits = x.sum(dim=1) + (0 if plan is None else plan)
        return logits, torch.zeros(1)


def test_forward_fn_returns_the_logits_of_a_tuple_return():
    fwd = make_forward_fn(_TupleModel())
    x = torch.arange(12.0).reshape(2, 2, 3)
    torch.testing.assert_close(fwd(x), x.sum(dim=1))
    torch.testing.assert_close(fwd.apply_plan_fn(x, 1.0), x.sum(dim=1) + 1)
    out = make_forward_fn(build_model("pointnet"))(
        torch.from_numpy(coalition_batch()[:2]))
    assert isinstance(out, torch.Tensor) and out.shape == (2, 10)
