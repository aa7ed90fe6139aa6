"""One train step of the port's PointNet++, PointConv and PointNet against
the JAX package's, from the same weights on the same batch, in float64, and
the un-fused eval path (``fused=False``) of PointNet++ and PointConv against
the fused one.  Weights, dropout, the padded tail, the dtype and the
tolerances are those of ``test_torch_train_step_edge.py`` (its docstring
says why float64).  The clouds have 512 points, so FPS never repeats a
centre, with coordinates on a 1/64 grid, so the ball queries, kNN and FPS
see exact distances on both sides.
"""
import numpy as np
import pytest
import torch

from interpret_quality_tpu_torch.models import build_model
from interpret_quality_tpu_torch.models.plans import make_plan_fn

from test_torch_checkpoint import seeded_state
from test_torch_train_step_edge import (EVAL_TOL, VALID, assert_step_agrees,
                                        cloud_batch, jax_train_step,
                                        port_model, port_train_step)

N = 512


@pytest.mark.parametrize("name", ["pointnet2", "pointconv", "pointnet"])
def test_train_step_matches_jax(name):
    x, labels = cloud_batch(N, 0)
    assert np.array_equal(x * 64, np.round(x * 64))      # on the grid
    state = seeded_state(name)
    want_loss, want_logits, want = jax_train_step(name, state, x, labels,
                                                  VALID)
    model = port_model(name, state)
    loss, logits = port_train_step(model, name, x, labels, VALID)
    assert_step_agrees(model, loss, logits, want_loss, want_logits, want)


@pytest.mark.parametrize("name", ["pointnet2", "pointconv"])
def test_unfused_eval_matches_fused(name):
    """fused=False in eval (the differentiable path) gives the fused eval
    logits, with and without a plan, with the same tolerance as the fused
    path against JAX."""
    model = build_model(name, num_classes=10)
    model.load_state_dict(seeded_state(name))
    x = torch.from_numpy(cloud_batch(N, 1)[0])
    plan = make_plan_fn(model)(x)
    with torch.no_grad():
        fused = model(x)
        for kwargs in ({}, {"plan": plan}):
            unfused = model(x, fused=False, **kwargs)
            np.testing.assert_allclose(unfused.numpy(), fused.numpy(),
                                       **EVAL_TOL)
