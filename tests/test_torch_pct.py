"""The port's PCT against the benchmark's plain reference
(``iqbench/reference/pct.py``) on the CPU: published widths, the
benchmark's seeded weights, 256 points with 128 and 64 centres (the
published 512 and 256 cut to fit the cloud) and two orders of masked
clouds (66 clouds); kernel 10's plain version against its emulated split
and its wrapper's checks against a stand-in launcher (its span and counter:
``tests/test_torch_tracing.py``).

The weights' seed is one under which no column sum of the last two
offset-attention layers lies near the 1e-9 that the column normalisation
adds (``test_the_seed_keeps_late_column_sums_off_the_floor``).  Without a
1/sqrt(d) scale the energies reach 1e4 and more there, so a column that is
only some row's runner-up sums to about e^-20, the order of that floor, and
its normalised weights then move by percents for f32 rounding of the
energies (about 1e-3 absolute): a few clouds of a sound run jump, as DGCNN's
do at near-tied neighbours.  The benchmark's check reads medians and
quantiles for that reason; these tests take a seed where no cloud jumps.

Tolerances: logits within 2e-3 of their RMS (the port hoists layer 1 above
the gather, folds BatchNorm into kernel 10's products and sums in other
orders: about 1e-6 relative at the attention's input, which the energies,
up to 2.6e4 on these clouds, amplify into softmax weights that move by
about 1e-4; the largest gap read 4.4e-4 of the RMS); Shapley values within
1e-3 of the largest (the reward's logsumexp of those logits and the
marginals' differences; read 1.7e-4); the plan's indices equal (the CPU's
FPS and kNN keep ties to the lowest index, as the reference does, and its
distances split no near-tie on these clouds).  Kernel 10's plain version
against its emulated split: within 1e-5 of the largest output at
``highest`` (the split drops lo * lo, 2^-22 of a product), within the
operands' rounding at ``high`` (TF32, 2^-11) and ``default`` (bf16, 2^-8),
summed over 128 products."""
import json
import os

import numpy as np
import pytest
import torch

from interpret_quality_tpu_torch.config import ExperimentConfig
from interpret_quality_tpu_torch.models import build_model, make_forward_fn
from interpret_quality_tpu_torch.models.plans import (PLAN_MODES,
                                                      make_plan_fn)
from interpret_quality_tpu_torch.ops.cuda import emulation as em
from interpret_quality_tpu_torch.ops.cuda import knn_group as kg
from interpret_quality_tpu_torch.ops.cuda import launch
from interpret_quality_tpu_torch.ops.precision import round_bf16
from iqbench import inputs, weights
from iqbench.reference import attribution as A
from iqbench.reference import pct as ref
from test_torch_tracing import stand_in

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 5
POINTS, ORDERS = 256, 2
LEVELS = ((128, 32), (64, 32))
SHIFT = torch.tensor([0.2, -0.1, 0.3])
FLOOR = (1e-12, 1e-6)       # column sums within three orders of the 1e-9


def config(points=POINTS, levels=LEVELS):
    with open(os.path.join(ROOT, "iqbench", "configs", "pct.json")) as f:
        cfg = json.load(f)
    for level, (npoint, _) in zip(ref.LEVELS, levels):
        cfg[level] = dict(cfg[level], npoint=npoint)
    return dict(cfg, num_points=points)


def port_model(cfg, state):
    model = build_model(cfg["family"], cfg["num_classes"])
    model.load_state_dict(state, strict=True)
    model.levels = tuple((cfg[level]["npoint"], cfg[level]["nsample"])
                         for level in ref.LEVELS)
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


def column_sums(state, cfg, x, levels):
    """Each offset-attention layer's column sums of the softmax, (B, S)."""
    f = ref._conv_bn_relu(x, state, "conv1", "bn1")
    f = ref._conv_bn_relu(f, state, "conv2", "bn2")
    for i, (fps_idx, idx) in enumerate(levels):
        f = ref.sample_and_group(state, i, f, fps_idx, idx)
    h = ref._conv_bn_relu(f, state, "pt_last.conv1", "pt_last.bn1")
    h = ref._conv_bn_relu(h, state, "pt_last.conv2", "pt_last.bn2")
    sums = []
    for i in range(1, cfg["attention"]["layers"] + 1):
        q = ref._conv(h, state, f"pt_last.sa{i}.q_conv")
        sums.append(torch.softmax(q @ q.transpose(1, 2), dim=-1).sum(dim=1))
        h = ref.offset_attention(state, f"pt_last.sa{i}", h)
    return sums


def test_the_seed_keeps_late_column_sums_off_the_floor(case):
    """Layers 3 and 4 have no column sum within three orders of magnitude
    of the normalisation's 1e-9 (layers 1-2 have many, where the energies
    are too small for rounding to move them), and the logits vary from
    cloud to cloud."""
    with torch.no_grad():
        sums = column_sums(case["state"], case["cfg"], case["masked"] + SHIFT,
                           case["ref_plan"])
    near = [int(((s > FLOOR[0]) & (s < FLOOR[1])).sum()) for s in sums]
    assert near[0] > 0 and near[2:] == [0, 0], near
    want = case["want"]
    assert float(want.std(0).mean()) > 1e-2 * float(want.abs().mean())
    assert want.shape == (ORDERS * (case["cfg"]["num_regions"] + 1), 10)


def test_plan_matches_the_reference(case):
    for port, want in zip(case["plan"], case["ref_plan"]):
        assert torch.equal(port[0].long(), want[0])
        assert torch.equal(port[1].long(), want[1])


def test_plan_path_with_a_translation_matches_the_reference(case):
    assert relative(case["got"], case["want"]) < 2e-3


def test_forward_without_a_plan_matches_the_reference(case):
    x = case["masked"][::6] + SHIFT
    with torch.no_grad():
        got = case["fwd"](x)
        want = ref.forward(case["state"], case["cfg"], x)
    assert relative(got, want) < 2e-3


def test_unfused_path_matches_the_reference_and_differentiates(case):
    """``fused=False``: the grouped features gathered, every layer a
    product; differentiable in the cloud."""
    model = case["fwd"].model
    x = (case["masked"][::6] + SHIFT).clone().requires_grad_(True)
    got = model(x, fused=False)
    with torch.no_grad():
        want = ref.forward(case["state"], case["cfg"], x.detach())
    assert relative(got.detach(), want) < 2e-3
    (g,) = torch.autograd.grad(got.sum(), x)
    assert torch.isfinite(g).all() and float(g.abs().max()) > 0


def test_shapley_values_match_the_reference(case):
    got = A.shapley(case["got"], case["orders"], case["label"])
    want = A.shapley(case["want"], case["orders"], case["label"])
    assert np.abs(want).max() > 1e-3
    assert np.abs(got - want).max() < 1e-3 * np.abs(want).max()


def test_seeded_weights_load_strictly_and_repeat():
    cfg = config()
    a, b = weights.seeded_state(cfg, 7, "cpu"), weights.seeded_state(cfg, 7, "cpu")
    port_model(cfg, a)                      # strict: every name and shape
    assert all(torch.equal(a[k], b[k]) for k in a)
    first = next(iter(a))
    assert not torch.equal(a[first], weights.seeded_state(cfg, 8, "cpu")[first])


def test_tied_qk_weight_is_one_tensor_with_two_names():
    """The release ties q_conv and k_conv: one parameter, two state-dict
    names; the reference's leaves seed it once, under both."""
    cfg = config()
    model = build_model("pct", cfg["num_classes"])
    for i in range(1, 5):
        sa = getattr(model.pt_last, f"sa{i}")
        assert sa.q_conv.weight is sa.k_conv.weight
        assert sa.q_conv.bias is None and sa.k_conv.bias is None
    names = set(model.state_dict())
    assert {"pt_last.sa1.q_conv.weight", "pt_last.sa1.k_conv.weight"} <= names
    tied = [leaf[0] for leaf in ref.leaves(cfg) if len(leaf[0]) > 1]
    assert tied == [[f"pt_last.sa{i}.q_conv.weight", f"pt_last.sa{i}.k_conv.weight"]
                    for i in range(1, 5)]
    state = weights.seeded_state(cfg, 3, "cpu")
    assert state["pt_last.sa2.q_conv.weight"] is state["pt_last.sa2.k_conv.weight"]
    assert set(state) == names
    params = sum(p.numel() for p in model.parameters())
    assert params == 2_868_426              # 2.87 M at 10 classes (2.88 M at 40)


def test_family_is_registered_for_the_cli_and_the_plan():
    cfg = ExperimentConfig(model="pct", device="cpu")
    assert (cfg.shapley_batch_size, cfg.interaction_batch_size) == (50, 200)
    assert PLAN_MODES["pct"] == {"trans", "rotate", "scale"}
    model = build_model("pct")
    assert make_plan_fn(model) is not None
    assert "knn_group_max" in launch.KERNELS
    assert launch.SETTINGS["knn_group_max"] is launch.PRECISION_CODES
    with pytest.raises(ValueError, match="training"):
        model.train()(torch.rand(2, 64, 3), fused=True)


# ------------------------------------------------------------ kernel 10
def group_args(B=3, S=5, N=40, C1=64, C2=128, seed=0):
    g = torch.Generator().manual_seed(seed)
    idx = torch.randint(0, N, (B, S, kg.SLOTS), generator=g, dtype=torch.int32)
    u = torch.randn(B, N, C1, generator=g)
    c = torch.randn(B, S, C1, generator=g)
    a2 = torch.randn(C1, C2, generator=g) / C1 ** 0.5
    b2 = torch.randn(C2, generator=g)
    return idx, u, c, a2, b2


@pytest.mark.parametrize("precision,tol", [("highest", 1e-5), ("high", 5e-3),
                                           ("default", 4e-2)])
def test_knn_group_max_plain_against_the_emulated_split(precision, tol):
    args = group_args()
    want = kg.knn_group_max_plain(*args)
    got = em.knn_group_max_at(*args, precision=precision)
    assert float((got - want).abs().max()) < tol * float(want.abs().max())
    if precision == "highest":
        assert not torch.equal(got, want)   # the split is not the f32 product


def test_knn_group_max_plain_by_hand():
    """One centre by loops: the gathered rows, layer 1's ReLU, layer 2, its
    bias and ReLU, the max over the slots; and bf16 gathers at parts 1."""
    idx, u, c, a2, b2 = group_args(B=1, S=1)
    out = kg.knn_group_max_plain(idx, u, c, a2, b2)
    rows = torch.stack([torch.relu(u[0, j] + c[0, 0]) for j in idx[0, 0].tolist()])
    want = torch.relu(rows @ a2 + b2).amax(dim=0)
    torch.testing.assert_close(out[0, 0], want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(
        kg.knn_group_max_plain(idx, u, c, a2, b2, parts=1),
        kg.knn_group_max_plain(idx, round_bf16(u), c, a2, b2), rtol=0, atol=0)


def test_knn_group_max_on_the_cpu_is_the_plain_version():
    args = group_args()
    assert torch.equal(kg.knn_group_max(*args), kg.knn_group_max_plain(*args))


@pytest.mark.parametrize("change,match", [
    ({"K": 16}, "K must be 32"), ({"C1": 48}, "C1 must be"),
    ({"C2": 64}, "C2 one of"), ({"c_rows": 4}, "disagree"),
    ({"idx64": True}, "int32")])
def test_knn_group_max_refuses_shapes_it_does_not_take(monkeypatch, change,
                                                       match):
    stand_in(monkeypatch, kg, "iq_knn_group_max")
    C1 = change.get("C1", 64)
    idx, u, c, a2, b2 = group_args(C1=C1, C2=change.get("C2", 128))
    if "K" in change:
        idx = idx[..., :change["K"]].contiguous()
    if "c_rows" in change:
        c = c[:, :change["c_rows"]].contiguous()
    if "idx64" in change:
        idx = idx.long()
    with pytest.raises(ValueError, match=match):
        kg.knn_group_max(idx, u, c, a2, b2)
