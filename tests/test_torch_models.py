"""The port's DGCNN/GCNN against the JAX package's, on the same weights.

Random JAX variables from ``init_model`` get every BatchNorm overwritten with
random running statistics and scales of both signs, so both the max and the
min branch of the eval edge conv run.  ``state_dict_from_jax`` carries them
into the port model (``strict=True``).  Logits are compared with the JAX XLA
path (``fused=False``, the CPU path of the JAX package) at rtol 1e-4,
atol 1e-4: both are f32, summed in different orders.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interpret_quality_tpu.models import build_model as jax_build_model
from interpret_quality_tpu.models import init_model
from interpret_quality_tpu.models.torch_convert import (export_state_dict,
                                                        load_t7)
from interpret_quality_tpu.ops.geometry import knn as jax_knn
from interpret_quality_tpu_torch.attrib.coalitions import (
    keep_matrix_from_orders, masked_coalitions)
from interpret_quality_tpu_torch.models import build_model, make_forward_fn
from interpret_quality_tpu_torch.models.convert import (
    load_reference_state_dict, state_dict_from_jax)

N, K = 128, 20
TOL = dict(rtol=1e-4, atol=1e-4)


@functools.lru_cache(maxsize=None)
def random_variables(name: str, seed: int = 0):
    """JAX variables with random BN statistics and scales of both signs
    (cached: callers only read them)."""
    model = jax_build_model(name, num_classes=10, k=K)
    variables = jax.tree_util.tree_map(
        np.asarray, init_model(model, jax.random.PRNGKey(seed), num_points=N))
    rng = np.random.RandomState(seed)

    def fill(tree):
        for key, value in tree.items():
            if isinstance(value, dict):
                fill(value)
            elif key.endswith("scale"):
                sign = np.where(rng.rand(*value.shape) < 0.5, -1.0, 1.0)
                tree[key] = (sign * rng.uniform(0.5, 1.5, value.shape)
                             ).astype(np.float32)
            elif key.endswith("bias") or key.endswith("mean"):
                tree[key] = (0.1 * rng.randn(*value.shape)).astype(np.float32)
            elif key.endswith("var"):
                tree[key] = rng.uniform(0.5, 1.5, value.shape).astype(np.float32)

    fill(variables)
    return model, variables


def coalition_batch() -> np.ndarray:
    """One 128-point cloud masked into 2 orders x 5 rows (regions collapsed
    onto the centre: exact kNN ties inside every layer)."""
    rng = np.random.RandomState(5)
    cloud = rng.randn(N, 3).astype(np.float32)
    cloud /= np.abs(cloud).max()
    region_id = torch.from_numpy(rng.randint(0, 4, N))
    orders = np.stack([rng.permutation(4) for _ in range(2)])
    keep = torch.from_numpy(keep_matrix_from_orders(orders))
    data = torch.from_numpy(cloud)
    return masked_coalitions(data, data.mean(0), keep, region_id).numpy()


def port_model(name, variables):
    model = build_model(name, num_classes=10, k=K)
    model.load_state_dict(state_dict_from_jax(name, variables), strict=True)
    return model


@pytest.mark.parametrize("name,with_plan", [
    ("dgcnn", False), ("dgcnn", True), ("gcnn", False), ("gcnn", True)])
def test_logits_match_jax(name, with_plan):
    jmodel, variables = random_variables(name)
    x = coalition_batch()
    fwd = make_forward_fn(port_model(name, variables))
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        if with_plan:
            plan = fwd.plan_fn(xt)
            np.testing.assert_array_equal(plan.numpy(),
                                          np.asarray(jax_knn(jnp.asarray(x), K)))
            got = fwd.apply_plan_fn(xt, plan).numpy()
        else:
            got = fwd(xt).numpy()
    kwargs = {"plan": jax_knn(jnp.asarray(x), K)} if with_plan else {}
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(
        v, x, train=False, fused=False, **kwargs))(variables, jnp.asarray(x)))
    assert got.shape == want.shape == (x.shape[0], 10)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name", ["dgcnn", "gcnn_adv"])
def test_state_dict_equals_jax_export(name):
    _, variables = random_variables(name)
    ours = state_dict_from_jax(name, variables)
    template = build_model(name, num_classes=10, k=K).state_dict()
    theirs = export_state_dict(name, variables, template=template)
    assert set(ours) == set(theirs) == set(template)
    for key in theirs:
        np.testing.assert_array_equal(ours[key].numpy(), theirs[key],
                                      err_msg=key)


def test_reference_t7_round_trip(tmp_path):
    """A reference-layout .t7 (DataParallel prefixes included) loads into
    the port with strict=True and gives the logits that the JAX package
    computes from what its load_t7 reads out of the same file."""
    jmodel, variables = random_variables("dgcnn")
    state = state_dict_from_jax("dgcnn", variables)
    path = str(tmp_path / "model_best.t7")
    torch.save({"module." + key: v for key, v in state.items()}, path)

    model = build_model("dgcnn", num_classes=10, k=K)
    model.load_state_dict(load_reference_state_dict(path), strict=True)
    x = coalition_batch()[:4]
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    jvars = load_t7("dgcnn", path)
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(
        v, x, train=False, fused=False))(jvars, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, **TOL)


def test_other_models_are_not_ported_yet():
    """Every classifier family is registered now; a name outside the
    registry still raises."""
    with pytest.raises(NotImplementedError):
        build_model("pointnet_seg")
