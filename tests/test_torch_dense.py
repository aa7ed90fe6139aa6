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
