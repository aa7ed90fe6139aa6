"""Kernel 9's plain version and wrapper on the CPU (``ops/cuda/dense.py``):
DGCNN's eval head, conv5 with its eval BatchNorm and LeakyReLU and the max
and the mean over the points, against the head as the model computed it
before the kernel (cat, ``pointwise``, ``bn_eval``, ``leaky_relu02``,
``amax`` / ``mean``, cat), bit for bit; what the wrapper refuses; the eval
forward of DGCNN and GCNN through it against the JAX package's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interpret_quality_tpu_torch.models import build_model, dgcnn
from interpret_quality_tpu_torch.models.common import (bn_apply, leaky_relu02,
                                                       pointwise)
from interpret_quality_tpu_torch.ops.cuda import dense as dn
from test_torch_models import TOL, coalition_batch, port_model, random_variables


def head(feats, conv, bn):
    """The head as the model computed it before the kernel."""
    h = torch.cat(feats, dim=-1)
    h = leaky_relu02(bn_apply(pointwise(h, conv), bn))
    return torch.cat([h.amax(dim=1), h.mean(dim=1)], dim=-1)


def head_args(name, B, N, seed):
    """A family's conv5 and BatchNorm, with random statistics and scales of
    both signs, and four edge outputs (B, N, 64/64/128/256)."""
    torch.manual_seed(seed)
    model = build_model(name, num_classes=10, k=20).eval()
    g = torch.Generator().manual_seed(seed)
    bn = model.bn5
    c = bn.num_features
    with torch.no_grad():
        bn.running_mean.copy_(0.1 * torch.randn(c, generator=g))
        bn.running_var.copy_(0.5 + torch.rand(c, generator=g))
        sign = torch.where(torch.rand(c, generator=g) < 0.5, -1.0, 1.0)
        bn.weight.copy_(sign * (0.5 + torch.rand(c, generator=g)))
        bn.bias.copy_(0.1 * torch.randn(c, generator=g))
    feats = [torch.randn(B, N, w, generator=g) for w in dgcnn.EDGE_WIDTHS]
    return feats, model.conv5[0], bn


@pytest.mark.parametrize("name", ["dgcnn", "gcnn"])
@pytest.mark.parametrize("N", [1024, 1000, 37])
@pytest.mark.parametrize("B", [1, 3])
def test_plain_is_the_head_bit_for_bit(name, B, N):
    feats, conv, bn = head_args(name, B, N, seed=B + N)
    want = head(feats, conv, bn)
    with torch.inference_mode():
        assert torch.equal(dn.dense_pool_plain(feats, conv, bn), want)
        assert torch.equal(dn.dense_pool(feats, conv, bn), want)


def test_float64_head_on_the_cpu():
    """A float64 model (the float64 train and fit tests' eval passes) takes
    the head in float64 on the CPU, as before the kernel."""
    feats, conv, bn = head_args("gcnn", 2, 37, seed=7)
    feats = [f.double() for f in feats]
    conv, bn = conv.double(), bn.double()
    got = dn.dense_pool(feats, conv, bn)
    assert got.dtype == torch.float64
    assert torch.equal(got, head(feats, conv, bn))


@pytest.mark.parametrize("case", ["shape", "rank", "dtype", "device", "bias",
                                  "widths", "segments", "training"])
def test_wrapper_refuses_what_the_head_does_not_take(case):
    feats, conv, bn = head_args("dgcnn", 2, 40, seed=0)
    match = {"shape": r"feats\[1\]", "rank": r"feats\[2\]",
             "dtype": r"feats\[0\]", "device": "CPU or on one CUDA",
             "bias": "no bias", "widths": "sum to", "segments": "1 to 4",
             "training": "eval BatchNorm"}[case]
    if case == "shape":
        feats[1] = feats[1][:, :39]
    elif case == "rank":
        feats[2] = feats[2][0]
    elif case == "dtype":
        feats = [f.double() for f in feats]
    elif case == "device":
        feats[3] = feats[3].to("meta")
    elif case == "bias":
        conv = torch.nn.Conv1d(512, 1024, 1, bias=True)
    elif case == "widths":
        feats = feats[:3]
    elif case == "segments":
        feats = [f for w in feats for f in w.split(32, dim=-1)]
    else:
        bn.train()
    with pytest.raises(ValueError, match=match):
        dn.dense_pool(feats, conv, bn)


@pytest.mark.parametrize("name", ["dgcnn", "gcnn"])
def test_eval_forward_through_the_head_matches_jax(name, monkeypatch):
    """The CPU eval forward takes the head once, through the wrapper, and
    its logits stay within ``test_torch_models``' tolerance of the JAX
    package's; the differentiable eval forward (``fused=False``) does not
    take it and gives the same head's values."""
    jmodel, variables = random_variables(name)
    x = coalition_batch()
    model = port_model(name, variables).eval()
    calls = []

    def counted(*args):
        calls.append(args)
        return dn.dense_pool(*args)
    monkeypatch.setattr(dgcnn, "dense_pool", counted)
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
        assert len(calls) == 1
        unfused = model(torch.from_numpy(x), fused=False).numpy()
        assert len(calls) == 1
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(
        v, x, train=False, fused=False))(variables, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(unfused, want, **TOL)


def coalition_head_args(kind):
    """DGCNN's four edge outputs of ``coalition_batch`` (regions collapsed
    onto the centre: copies of one row in every segment), or random edge
    outputs with no row repeated, with conv5 and a random eval BatchNorm,
    and each cloud's copy lists (``emulation.copy_lists`` of the
    concatenated rows)."""
    from interpret_quality_tpu_torch.ops.cuda import emulation as em
    feats, conv, bn = head_args("dgcnn", 10, 128, seed=11)
    if kind == "coalitions":
        torch.manual_seed(3)
        model = build_model("dgcnn", num_classes=10, k=20).eval()
        h, feats = torch.from_numpy(coalition_batch()), []
        with torch.inference_mode():
            for block in (model.conv1, model.conv2, model.conv3, model.conv4):
                h = dgcnn.edge_conv(h, block, 20)
                feats.append(h)
    lists = [em.copy_lists(cloud) for cloud in torch.cat(feats, dim=-1)]
    return feats, conv, bn, lists


@pytest.mark.parametrize("kind", ["coalitions", "distinct"])
def test_listed_walk_is_the_head(kind):
    """The listed walk's plain model (``emulation.dense_pool_listed``): on
    each cloud's distinct rows, its max equals ``dense_pool_plain``'s bit
    for bit and its mean lies within 1e-6 of it (relative); where no row
    repeats it equals the plain version bit for bit."""
    from interpret_quality_tpu_torch.ops.cuda import emulation as em
    feats, conv, bn, lists = coalition_head_args(kind)
    N, C = feats[0].shape[1], bn.num_features
    with torch.inference_mode():
        want = dn.dense_pool_plain(feats, conv, bn)
        got = em.dense_pool_listed(feats, conv, bn, lists)
    d = torch.tensor([len(cl.rows) for cl in lists])
    if kind == "coalitions":
        # the first and last row of each order keep 1 and all 4 regions
        assert 1 <= int(d.min()) and int(d.max()) == N > int(d.float().mean())
        assert torch.equal(got[:, :C], want[:, :C])
        gap = (got[:, C:] - want[:, C:]).abs() / want[:, C:].abs().clamp_min(
            want[:, C:].abs().mean())
        assert float(gap.max()) < 1e-6
    else:
        assert bool((d == N).all())
        assert torch.equal(got, want)


def test_listed_walk_weighs_each_row_by_its_copies():
    """Clouds of one row repeated N = 37 times: the listed walk takes the
    row once, so its max is the row's value y and its sum 37 y (rounded),
    divided by 37."""
    from interpret_quality_tpu_torch.ops.cuda import emulation as em
    feats, conv, bn = head_args("dgcnn", 2, 37, seed=4)
    feats = [f[:, :1].expand_as(f).contiguous() for f in feats]
    lists = [em.copy_lists(c) for c in torch.cat(feats, dim=-1)]
    assert [len(cl.rows) for cl in lists] == [1, 1]
    assert [cl.starts.tolist() for cl in lists] == [[0, 37]] * 2
    with torch.inference_mode():
        got = em.dense_pool_listed(feats, conv, bn, lists)
        want = dn.dense_pool_plain(feats, conv, bn)
    y = want[:, :bn.num_features]
    assert torch.equal(got, torch.cat([y, 37.0 * y / 37], dim=-1))


@pytest.mark.parametrize("with_plan", [False, True])
def test_fused_forward_takes_no_lists_on_the_cpu(with_plan, monkeypatch):
    """On the CPU the fused DGCNN forward still calls the head once, with
    its three arguments (kernel 3's lists are None there, so none is
    passed), and the first kernel-3 layer's edge conv, asked for its lists,
    returns None beside the same output."""
    from interpret_quality_tpu_torch.models import make_forward_fn
    x = torch.from_numpy(coalition_batch())
    torch.manual_seed(0)
    model = build_model("dgcnn", num_classes=10, k=20).eval()
    calls = []

    def counted(*args):
        calls.append(args)
        return dn.dense_pool(*args)
    monkeypatch.setattr(dgcnn, "dense_pool", counted)
    fwd = make_forward_fn(model)
    with torch.inference_mode():
        if with_plan:
            fwd.apply_plan_fn(x, fwd.plan_fn(x))
        else:
            model(x)
        h, lists = dgcnn.edge_conv(x, model.conv1, 20, copy_lists=True)
        assert lists is None
        assert torch.equal(h, dgcnn.edge_conv(x, model.conv1, 20))
    assert len(calls) == 1 and len(calls[0]) == 3


def test_plain_version_takes_no_lists():
    """The lists are kernel 3's, on the card: the CPU head refuses them,
    and the CPU kNN extrema return None for them."""
    from interpret_quality_tpu_torch.ops.cuda import neighbors as nb
    feats, conv, bn = head_args("dgcnn", 2, 40, seed=0)
    lists = nb.DistinctRows(torch.zeros(2, 40, dtype=torch.int32),
                            torch.ones(2, dtype=torch.int32),
                            torch.zeros(2, 41, dtype=torch.int32))
    with pytest.raises(ValueError, match="every row"):
        dn.dense_pool(feats, conv, bn, lists)
    xs, a = feats[0], feats[1]
    amax, amin, none = nb.knn_gather_extrema(xs, a, 5, copy_lists=True)
    assert none is None
    for got, want in zip((amax, amin), nb.knn_gather_extrema(xs, a, 5)):
        assert torch.equal(got, want)
