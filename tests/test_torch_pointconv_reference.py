"""The port's PointConv against the benchmark's plain reference
(``iqbench/reference/pointconv.py``) on the CPU: published widths, the
benchmark's seeded weights, 300 points and two orders of masked clouds
(66 clouds).

The weights' seed is one under which every level's DensityNet passes a
signal: seeded BatchNorms take scales of both signs, and DensityNet ends in
a ReLU, so under about a third of the seeds a level's density scale is 0
for every input and the logits no longer depend on what comes before it
(``test_the_seed_drives_every_level`` holds this seed to that).

Tolerances: logits within 1e-5 of their RMS (the port folds BatchNorm,
hoists layer 1 above the gather and sums the contraction in another order
than the reference: float32 rounding through seven layers is about 1e-6 of
the RMS); Shapley values within 1e-4 of the largest (the reward's
logsumexp of those logits and the marginals' differences); the plan's
indices equal (the CPU's kNN and FPS keep ties to the lowest index, as the
reference does, and its distances split no near-tie on these clouds); the
plan's densities within 1e-5 relative (the KDE's sum in another order)."""
import json
import os

import numpy as np
import pytest
import torch

from interpret_quality_tpu_torch.models import build_model, make_forward_fn
from iqbench import inputs, weights
from iqbench.reference import attribution as A
from iqbench.reference import pointconv as ref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 20
POINTS, ORDERS = 300, 2
SHIFT = torch.tensor([0.2, -0.1, 0.3])


def config():
    with open(os.path.join(ROOT, "iqbench", "configs", "pointconv.json")) as f:
        return json.load(f)


def port_model(cfg, state):
    model = build_model(cfg["family"], cfg["num_classes"])
    model.load_state_dict(state, strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def case():
    """Seeded weights, the masked clouds of one synthetic cloud, and both
    sides' plans and logits."""
    cfg = config()
    state = weights.seeded_state(cfg, SEED, "cpu")
    fwd = make_forward_fn(port_model(cfg, state))
    rng = np.random.RandomState(4)
    pc, label = inputs.synthetic_cloud(rng, POINTS)
    region = inputs.region_ids(pc, inputs.fps_np(pc, cfg["num_regions"]))
    orders = inputs.orders(rng, ORDERS, cfg["num_regions"])
    masked = A.mask(torch.from_numpy(pc), torch.from_numpy(A.keep_matrix(orders)),
                    torch.from_numpy(region))
    with torch.no_grad():
        plan = fwd.plan_fn(masked)
        out = dict(cfg=cfg, state=state, fwd=fwd, masked=masked, orders=orders,
                   label=label, plan=plan, ref_plan=ref.plan(cfg, masked),
                   got=fwd.apply_plan_fn(masked + SHIFT, plan),
                   want=A.logits(cfg, state, masked, SHIFT, block=33))
    return out


def relative(got, want):
    return float((got - want).abs().max() / want.pow(2).mean().sqrt())


def test_the_seed_drives_every_level(case):
    """Every level's DensityNet passes a signal on these clouds, so the
    logits vary from cloud to cloud through all three levels."""
    cfg, state, x = case["cfg"], case["state"], case["masked"]
    levels, inv3 = case["ref_plan"]
    dens = [levels[0][2] / levels[0][3], levels[1][2] / levels[1][3],
            inv3 / inv3.amax(-1, keepdim=True)]
    for level, d in zip(("sa1", "sa2", "sa3"), dens):
        scale = ref._stack(d[..., None], state, f"{level}.densitynet",
                           len(cfg["densitynet"]))
        assert float((scale > 0).float().mean()) > 0.5, level
    assert float(case["want"].std(0).mean()) > 1e-2 * float(case["want"].abs().mean())
    assert x.shape == (ORDERS * (cfg["num_regions"] + 1), POINTS, 3)


def test_plan_matches_the_reference(case):
    (port_levels, port_inv3), (ref_levels, ref_inv3) = case["plan"], case["ref_plan"]
    for port, want in zip(port_levels, ref_levels):
        fps_idx, idx, den, dmax = port
        assert torch.equal(fps_idx.long(), want[0])
        assert torch.equal(idx.long(), want[1])
        torch.testing.assert_close(den, want[2], rtol=1e-5, atol=0)
        torch.testing.assert_close(dmax, want[3], rtol=1e-5, atol=0)
    torch.testing.assert_close(port_inv3, ref_inv3, rtol=1e-5, atol=0)


def test_plan_path_with_a_translation_matches_the_reference(case):
    assert relative(case["got"], case["want"]) < 1e-5


def test_forward_without_a_plan_matches_the_reference(case):
    x = case["masked"][::6] + SHIFT
    with torch.no_grad():
        got = case["fwd"](x)
        want = ref.forward(case["state"], case["cfg"], x)
    assert relative(got, want) < 1e-5


def test_shapley_values_match_the_reference(case):
    got = A.shapley(case["got"], case["orders"], case["label"])
    want = A.shapley(case["want"], case["orders"], case["label"])
    assert np.abs(want).max() > 1e-3
    assert np.abs(got - want).max() < 1e-4 * np.abs(want).max()


def test_seeded_weights_load_strictly_and_repeat():
    cfg = config()
    a, b = weights.seeded_state(cfg, 7, "cpu"), weights.seeded_state(cfg, 7, "cpu")
    port_model(cfg, a)                      # strict: every name and shape
    assert all(torch.equal(a[k], b[k]) for k in a)
    first = next(iter(a))
    assert not torch.equal(a[first], weights.seeded_state(cfg, 8, "cpu")[first])
