"""The plain reference against the port's CPU path at real widths and a
few hundred points: eval forwards through the enumeration's plan and
without it, the Shapley values, and the seeded weights."""
import json
import os

import numpy as np
import pytest
import torch

from iqbench import inputs, weights
from iqbench.reference import attribution as A

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cfg(name):
    return json.load(open(os.path.join(PKG, "configs", name + ".json")))


def masked_batch(n_points, n_orders, seed):
    rng = np.random.RandomState(seed)
    pc, label = inputs.synthetic_cloud(rng, n_points)
    region = inputs.region_ids(pc, inputs.fps_np(pc, 32))
    orders = inputs.orders(rng, n_orders, 32)
    keep = torch.from_numpy(A.keep_matrix(orders))
    return A.mask(torch.from_numpy(pc), keep, torch.from_numpy(region)), orders, label


def port_model(c, state):
    from interpret_quality_tpu_torch.models import build_model
    m = build_model(c["family"], c["num_classes"], c.get("k", 20))
    m.load_state_dict(state, strict=True)
    return m.eval()


@pytest.mark.parametrize("family,points,orders", [("dgcnn", 256, 2),
                                                  ("pointnet2", 128, 1)])
def test_enumeration_forward_matches_the_port(family, points, orders):
    from interpret_quality_tpu_torch.models import make_forward_fn
    c = cfg(family)
    state = weights.seeded_state(c, 3, "cpu")
    fwd = make_forward_fn(port_model(c, state))
    masked, order, label = masked_batch(points, orders, 4)
    shift = torch.tensor([0.2, -0.1, 0.3])
    with torch.no_grad():
        got = fwd.apply_plan_fn(masked + shift, fwd.plan_fn(masked))
        want = A.logits(c, state, masked, shift, block=16)
        plain = fwd(masked[:8])
        plain_want = A.logits(c, state, masked[:8], block=8)
    scale = want.pow(2).mean().sqrt()
    assert float((got - want).abs().max() / scale) < 1e-5
    assert float((plain - plain_want).abs().max() / scale) < 1e-5
    sv_got, sv_want = A.shapley(got, order, label), A.shapley(want, order, label)
    assert np.abs(sv_got - sv_want).max() < 1e-4 * np.abs(sv_want).max()


@pytest.mark.parametrize("family", ["dgcnn", "pointnet2"])
def test_seeded_weights_load_strictly_and_repeat(family):
    c = cfg(family)
    a, b = weights.seeded_state(c, 7, "cpu"), weights.seeded_state(c, 7, "cpu")
    port_model(c, a)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a[next(iter(a))], weights.seeded_state(c, 8, "cpu")[next(iter(a))])
