"""The port's PointMLP against the benchmark's plain reference
(``iqbench/reference/pointmlp.py``) on the CPU: published widths, the
benchmark's seeded weights loaded with ``strict=True``, 256 points (the
model's ``points``, so 128, 64, 32 and 16 anchors of 24 neighbours) and one
order of masked clouds (33 clouds, among them the empty coalition, whose
points all collapse to the centre); the hoisted transfer, the per-cloud
standard deviation and kernel 11's plain version against its emulated
split and against a stand-in launcher (its span and counter:
``tests/test_torch_tracing.py``).

Tolerances: logits within 1e-4 of their RMS, fused and un-fused (the port
folds BatchNorm into the products, hoists the transfer above the gather and
sums in other orders: f32 rounding, about 1e-7 relative a layer, through
20 layers with the stages' scales of up to 1e5; the largest gap read
3.5e-6); Shapley values within 1e-4 of the
largest (the reward's logsumexp of those logits and the marginals'
differences); the plan's indices equal (the CPU's FPS and kNN keep ties to
the lowest index, as the reference does).  The hoist against the transfer
on gathered inputs in float64 within 1e-12 of the largest value (both are
the same sums in another order).  Kernel 11's plain version against its
emulated split: within 1e-5 of the largest output at ``highest`` (the split
drops lo * lo, 2^-22 of a product, over four chained products of up to
1024 terms), within the operands' rounding at ``high`` (TF32, 2^-11) and
``default`` (bf16, 2^-8)."""
import json
import os

import numpy as np
import pytest
import torch

from interpret_quality_tpu_torch.config import ExperimentConfig
from interpret_quality_tpu_torch.models import build_model, make_forward_fn
from interpret_quality_tpu_torch.models import pointmlp as pm
from interpret_quality_tpu_torch.models.plans import PLAN_MODES, make_plan_fn
from interpret_quality_tpu_torch.ops.cuda import emulation as em
from interpret_quality_tpu_torch.ops.cuda import group_mlp as gm
from interpret_quality_tpu_torch.ops.cuda import launch
from interpret_quality_tpu_torch.ops.precision import round_bf16
from iqbench import inputs, weights
from iqbench.reference import attribution as A
from iqbench.reference import pointmlp as ref
from test_torch_tracing import stand_in

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 5
POINTS, ORDERS = 256, 1
SHIFTS = (torch.tensor([0.2, -0.1, 0.3]), torch.tensor([-0.25, 0.05, 0.1]))


def config(points=POINTS):
    with open(os.path.join(ROOT, "iqbench", "configs", "pointmlp.json")) as f:
        cfg = json.load(f)
    cfg["stages"] = [dict(s, anchors=points >> (i + 1))
                     for i, s in enumerate(cfg["stages"])]
    return dict(cfg, num_points=points)


def port_model(cfg, state):
    model = pm.PointMLP(cfg["num_classes"], points=cfg["num_points"])
    model.load_state_dict(state, strict=True)
    return model.eval()


def relative(got, want):
    return float((got - want).abs().max() / want.pow(2).mean().sqrt())


@pytest.fixture(scope="module")
def case():
    """Seeded weights, the masked clouds of one synthetic cloud, and both
    sides' plans and logits at two translations."""
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
        got = [fwd.apply_plan_fn(masked + SHIFTS[0], plan),
               fwd.apply_plan_fn(masked[::5] + SHIFTS[1],
                                 [(a[::5], b[::5]) for a, b in plan])]
        want = A.logits(cfg, state, masked, SHIFTS[0], block=33)
    return dict(cfg=cfg, state=state, fwd=fwd, masked=masked, orders=orders,
                label=label, plan=plan, ref_plan=ref.plan(cfg, masked),
                got=got, want=want)


def test_the_clouds_collapse_and_the_logits_vary(case):
    """The empty coalition's cloud is one point (so its every difference,
    and its standard deviation at each stage, is 0), and the logits vary
    from cloud to cloud."""
    assert torch.equal(case["masked"][0], case["masked"][0, :1].expand(POINTS, 3))
    fps_idx, idx = case["plan"][0]
    with torch.no_grad():
        f = case["fwd"].model.embedding(case["masked"][:1] + SHIFTS[0])
        assert float(pm.group_std(f, fps_idx[:1], idx[:1])) == 0.0
    want = case["want"]
    assert want.shape == (ORDERS * (case["cfg"]["num_regions"] + 1), 10)
    assert float(want.std(0).mean()) > 1e-2 * float(want.abs().mean())


def test_plan_matches_the_reference(case):
    assert len(case["plan"]) == 4
    for (fps_idx, idx), (want_fps, want_idx), spec in zip(
            case["plan"], case["ref_plan"], case["cfg"]["stages"]):
        assert idx.shape[1:] == (spec["anchors"], 24)
        assert torch.equal(fps_idx.long(), want_fps)
        assert torch.equal(idx.long(), want_idx)


def test_plan_path_with_a_translation_matches_the_reference(case):
    assert relative(case["got"][0], case["want"]) < 1e-4


def test_one_plan_serves_every_translation(case):
    """The plan made from the clouds as they are, reused for another
    translation, gives the logits of a forward that makes its own plan."""
    x = case["masked"][::5] + SHIFTS[1]
    with torch.no_grad():
        own = case["fwd"](x)
    assert relative(case["got"][1], own) < 1e-5


def test_forward_without_a_plan_matches_the_reference(case):
    x = case["masked"][::6] + SHIFTS[0]
    with torch.no_grad():
        got = case["fwd"](x)
        want = ref.forward(case["state"], case["cfg"], x)
    assert relative(got, want) < 1e-4


def test_unfused_path_matches_the_reference_and_differentiates(case):
    """``fused=False``: the groups gathered, every layer a product;
    differentiable in the cloud."""
    model = case["fwd"].model
    x = (case["masked"][1::8] + SHIFTS[0]).clone().requires_grad_(True)
    got = model(x, fused=False)
    with torch.no_grad():
        want = ref.forward(case["state"], case["cfg"], x.detach())
    assert relative(got.detach(), want) < 1e-4
    (g,) = torch.autograd.grad(got.sum(), x)
    assert torch.isfinite(g).all() and float(g.abs().max()) > 0


def test_shapley_values_match_the_reference(case):
    got = A.shapley(case["got"][0], case["orders"], case["label"])
    want = A.shapley(case["want"], case["orders"], case["label"])
    assert np.abs(want).max() > 1e-3
    assert np.abs(got - want).max() < 1e-4 * np.abs(want).max()


def test_hoisted_transfer_equals_the_transfer_in_float64():
    """h0 = relu((u_j - u_s) sig + c_s) from the model's own kernel inputs
    (``PointMLP.group_inputs``) equals the transfer (ConvBNReLU on
    [alpha d / (std + eps) + beta, f_s]) on the gathered groups, in
    float64, with the affine and the BatchNorm randomised."""
    torch.manual_seed(0)
    B, N, S, K = 2, 40, 6, 24
    model = pm.PointMLP(10, points=64).double().eval()
    grouper = model.local_grouper_list[0]
    transfer = model.pre_blocks_list[0].transfer
    with torch.no_grad():
        for p in (grouper.affine_alpha, grouper.affine_beta,
                  transfer.net[1].weight, transfer.net[1].bias):
            p.uniform_(-1, 1)
        transfer.net[1].running_mean.uniform_(-0.2, 0.2)
        transfer.net[1].running_var.uniform_(0.5, 1.5)
    f = torch.randn(B, N, pm.EMBED, dtype=torch.float64)
    fps_idx = torch.randint(0, N, (B, S))
    idx = torch.randint(0, N, (B, S, K))
    with torch.no_grad():
        u, c, sig, _ = model.group_inputs(0, f, fps_idx, idx)
        d = pm.group_differences(f, fps_idx, idx)
        g = (grouper.affine_alpha * d / (torch.std(d.reshape(B, -1), dim=1)
                                         + pm.STD_EPS)[:, None, None, None]
             + grouper.affine_beta)
        fs = f.gather(1, fps_idx[..., None].expand(-1, -1, pm.EMBED))
        want = transfer(torch.cat([g, fs[:, :, None].expand_as(g)], dim=-1))
        C = u.shape[-1]
        ug = u.gather(1, idx.reshape(B, -1, 1).expand(-1, -1, C)).reshape(
            B, S, K, C)
        us = u.gather(1, fps_idx[..., None].expand(-1, -1, C))
        got = torch.relu((ug - us[:, :, None]) * sig[:, None, None, None]
                         + c[:, :, None])
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-12 * float(want.abs().max()))


def test_group_std_is_the_release_formula_and_finite_on_one_point():
    """sigma_b = torch.std((grouped - anchor).reshape(B, -1)) as the
    release computes it, in chunks of clouds or not; a cloud whose
    differences are all 0 has sigma 0 and a finite scale 1 / (0 + eps)."""
    g = torch.Generator().manual_seed(1)
    B, N, S, K, C = 5, 30, 7, 24, 16
    f = torch.randn(B, N, C, generator=g)
    f[2] = f[2, :1]                     # one point, 30 times
    fps_idx = torch.randint(0, N, (B, S), generator=g)
    idx = torch.randint(0, N, (B, S, K), generator=g)
    grouped = torch.stack([f[b][idx[b]] for b in range(B)])
    anchor = torch.stack([f[b][fps_idx[b]] for b in range(B)])[:, :, None]
    want = torch.std((grouped - anchor).reshape(B, -1), dim=-1)
    torch.testing.assert_close(pm.group_std(f, fps_idx, idx), want,
                               rtol=1e-6, atol=0)
    old = pm.STD_CHUNK_BYTES
    try:
        pm.STD_CHUNK_BYTES = 4 * S * K * C * 2          # two clouds a chunk
        torch.testing.assert_close(pm.group_std(f, fps_idx, idx), want,
                                   rtol=1e-6, atol=0)
    finally:
        pm.STD_CHUNK_BYTES = old
    assert float(want[2]) == 0.0
    scale = 1.0 / (want + pm.STD_EPS)
    assert torch.isfinite(scale).all() and float(scale[2]) == pytest.approx(1e5)


def test_seeded_weights_load_strictly_and_repeat():
    cfg = config(1024)
    a, b = weights.seeded_state(cfg, 7, "cpu"), weights.seeded_state(cfg, 7, "cpu")
    model = build_model("pointmlp", cfg["num_classes"])
    model.load_state_dict(a, strict=True)       # every name and shape
    assert all(torch.equal(a[k], b[k]) for k in a)
    first = next(iter(a))
    assert not torch.equal(a[first], weights.seeded_state(cfg, 8, "cpu")[first])
    assert float(a["local_grouper_list.0.affine_alpha"].abs().max()) <= 1.0


def test_release_layout_and_size():
    """The release's module names; 13,230,794 parameters at 10 classes; the
    anchors halve from ``points``; the published widths."""
    model = build_model("pointmlp")
    names = set(model.state_dict())
    for name in ("embedding.net.0.weight", "embedding.net.1.running_var",
                 "local_grouper_list.3.affine_alpha",
                 "local_grouper_list.3.affine_beta",
                 "pre_blocks_list.0.transfer.net.0.weight",
                 "pre_blocks_list.3.operation.1.net2.1.weight",
                 "pos_blocks_list.2.operation.0.net1.0.weight",
                 "classifier.0.bias", "classifier.1.running_mean",
                 "classifier.4.weight", "classifier.5.weight",
                 "classifier.8.bias"):
        assert name in names, name
    assert model.levels == ((512, 24), (256, 24), (128, 24), (64, 24))
    assert model.local_grouper_list[1].affine_alpha.shape == (1, 1, 1, 128)
    assert model.pre_blocks_list[3].transfer.net[0].weight.shape == (1024, 1024, 1)
    assert sum(p.numel() for p in model.parameters()) == 13_230_794
    assert pm.PointMLP(10, points=256).levels[-1] == (16, 24)


def test_family_is_registered_for_the_cli_and_the_plan():
    cfg = ExperimentConfig(model="pointmlp", device="cpu")
    assert (cfg.shapley_batch_size, cfg.interaction_batch_size) == (50, 200)
    assert PLAN_MODES["pointmlp"] == {"trans", "rotate", "scale"}
    model = build_model("pointmlp")
    assert make_plan_fn(model) is not None
    assert "group_res_mlp" in launch.KERNELS
    assert launch.SETTINGS["group_res_mlp"] is launch.PRECISION_CODES
    with pytest.raises(ValueError, match="training"):
        model.train()(torch.rand(2, 64, 3), fused=True)


def test_cli_train_refuses_pointmlp():
    from interpret_quality_tpu_torch.cli import train
    with pytest.raises(SystemExit):
        train.main(["--model", "pointmlp", "--device", "cpu", "--synthetic"])


# ------------------------------------------------------------ kernel 11
def res_args(B=2, S=5, N=40, C=128, seed=0):
    g = torch.Generator().manual_seed(seed)
    idx = torch.randint(0, N, (B, S, gm.SLOTS), generator=g, dtype=torch.int32)
    idx[:, :, 12:] = idx[:, :, :1]                  # repeated slots
    fps = torch.randint(0, N, (B, S), generator=g, dtype=torch.int32)
    u = torch.randn(B, N, C, generator=g)
    c = torch.randn(B, S, C, generator=g) * 0.5
    sig = torch.rand(B, generator=g) + 0.5
    blocks = [(torch.randn(C, C, generator=g) / C ** 0.5,
               torch.randn(C, generator=g) * 0.1,
               torch.randn(C, C, generator=g) / C ** 0.5,
               torch.randn(C, generator=g) * 0.1) for _ in range(2)]
    return idx, fps, u, c, sig, blocks


@pytest.mark.parametrize("precision,tol", [("highest", 1e-5), ("high", 5e-3),
                                           ("default", 4e-2)])
def test_group_res_mlp_plain_against_the_emulated_split(precision, tol):
    args = res_args(C=256)
    want = gm.group_res_mlp_plain(*args)
    got = em.group_res_mlp_at(*args, precision=precision)
    assert float((got - want).abs().max()) < tol * float(want.abs().max())
    if precision == "highest":
        assert not torch.equal(got, want)   # the split is not the f32 product


def test_group_res_mlp_plain_by_hand():
    """One centre by loops: h0 from the gathered rows less the centre's,
    both residual blocks, the max over the slots; and bf16 gathers at
    parts 1."""
    idx, fps, u, c, sig, blocks = res_args(B=1, S=1)
    out = gm.group_res_mlp_plain(idx, fps, u, c, sig, blocks)
    rows = []
    for j in idx[0, 0].tolist():
        x = torch.relu((u[0, j] - u[0, int(fps[0, 0])]) * sig[0] + c[0, 0])
        for a1, b1, a2, b2 in blocks:
            x = torch.relu(torch.relu(x @ a1 + b1) @ a2 + b2 + x)
        rows.append(x)
    torch.testing.assert_close(out[0, 0], torch.stack(rows).amax(dim=0),
                               rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(
        gm.group_res_mlp_plain(idx, fps, u, c, sig, blocks, parts=1),
        gm.group_res_mlp_plain(idx, fps, round_bf16(u), c, sig, blocks),
        rtol=0, atol=0)


def test_group_res_mlp_on_the_cpu_is_the_plain_version():
    args = res_args()
    assert torch.equal(gm.group_res_mlp(*args), gm.group_res_mlp_plain(*args))


@pytest.mark.parametrize("change,match", [
    ({"K": 16}, "K must be 24"), ({"C": 64}, "one of"),
    ({"c_rows": 4}, "disagree"), ({"idx64": True}, "int32"),
    ({"blocks": 1}, "two residual blocks"), ({"a": 64}, "float32")])
def test_group_res_mlp_refuses_shapes_it_does_not_take(monkeypatch, change,
                                                       match):
    stand_in(monkeypatch, gm, "iq_group_res_mlp")
    monkeypatch.setattr(gm, "capacity", lambda C, code, device: 3)
    idx, fps, u, c, sig, blocks = res_args(C=change.get("C", 128))
    if "K" in change:
        idx = idx[..., :change["K"]].contiguous()
    if "c_rows" in change:
        c = c[:, :change["c_rows"]].contiguous()
    if "idx64" in change:
        idx = idx.long()
    if "blocks" in change:
        blocks = blocks[:1]
    if "a" in change:
        blocks = [(blocks[0][0][:, :64],) + blocks[0][1:], blocks[1]]
    with pytest.raises(ValueError, match=match):
        gm.group_res_mlp(idx, fps, u, c, sig, blocks)
