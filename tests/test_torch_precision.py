"""The JAX package's precision settings in the port: ``--matmul_precision``
and ``--gather_precision``.

On the CPU the port computes f32 products at every matmul setting, as
XLA:CPU does, and exact gathers unless a caller names ``parts``; the card's
arithmetic at the other settings is held here through its emulation
(``ops/cuda/emulation.py``) and on the card by ``chip_smoke.py``'s
``precision`` phase.

Tolerances:
  * kernels 2, 3 and 8 at ``parts=1`` (bf16 values): bit-equal to the
    Pallas functions in interpret mode (``select="two_pass"``): a one-hot
    product of bf16 values copies them exactly, and max and min are exact;
  * kernels 5 and 7 at ``parts=1``: rtol 1e-4, atol 1e-5, as at
    ``parts=2`` (tests/test_torch_groups.py): both sides round the feature
    rows alike, and f32 sums run in another order; the JAX side carries
    kernel 7's xyz offsets as a hi/lo pair (about 2^-16), the port exactly;
  * the emulated one-pass products against float64 products of the rounded
    operands: within the f32 sum's error bound, K 2^-24 sum_k |x_k w_k|
    (the products of rounded operands are exact, only the sums round);
  * the differentiable product: ``torch.autograd.gradcheck`` in float64,
    and its f32 gradients against float64 products of the rounded operands.
"""
import argparse
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interpret_quality_tpu import config as jax_config
from interpret_quality_tpu.cli import common as jax_cli
from interpret_quality_tpu.ops.pallas import (fused_ball_mlp3, fused_pointconv_sa,
                                              gather_extrema, gather_rows,
                                              knn_gather_extrema)
from interpret_quality_tpu_torch import config
from interpret_quality_tpu_torch.cli import common as port_cli
from interpret_quality_tpu_torch.models import common
from interpret_quality_tpu_torch.ops import precision as pr
from interpret_quality_tpu_torch.ops.cuda import emulation as em
from interpret_quality_tpu_torch.ops.cuda import groups as gr
from interpret_quality_tpu_torch.ops.cuda import neighbors as nb

TOL = dict(rtol=1e-4, atol=1e-5)
PORT_CLIS = ("save_fps", "shapley_value", "enum", "gen_pair",
             "interaction_logits", "cal_interactions", "smoothness_enum",
             "result", "plot_interaction", "train", "train_adv")


@pytest.fixture
def settings():
    """Both packages' process-global settings, restored after the test."""
    saved = (config.matmul_precision(), config.gather_value_parts(),
             jax_config.gather_value_parts(),
             jax.config.jax_default_matmul_precision)
    yield
    config.set_matmul_precision(saved[0])
    config.set_gather_value_parts(saved[1])
    jax_config.set_gather_value_parts(saved[2])
    jax.config.update("jax_default_matmul_precision", saved[3])


def _values(rng, *shape):
    # spread over several binades, so that rounding to bf16 moves most values
    return (rng.randn(*shape) * 3.0 ** rng.randint(-3, 4, shape)).astype(
        np.float32)


# --------------------------------------------------- kernels 2, 3 and 8
def test_gather_extrema_plain_bf16_equals_pallas():
    rng = np.random.RandomState(0)
    a = _values(rng, 2, 48, 16)
    idx = rng.randint(0, 48, (2, 48, 7)).astype(np.int32)   # a row a point
    got = nb.gather_extrema_plain(torch.from_numpy(idx), torch.from_numpy(a),
                                  parts=1)
    want = gather_extrema(jnp.asarray(idx), jnp.asarray(a), parts=1,
                          interpret=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    exact = nb.gather_extrema_plain(torch.from_numpy(idx), torch.from_numpy(a))
    assert not torch.equal(got[0], exact[0])       # the rounding shows


def test_knn_gather_extrema_plain_bf16_equals_pallas():
    rng = np.random.RandomState(1)
    xs = rng.randn(2, 64, 5).astype(np.float32)
    a = _values(rng, 2, 64, 16)
    got = nb.knn_gather_extrema_plain(torch.from_numpy(xs),
                                      torch.from_numpy(a), 7, parts=1)
    want = knn_gather_extrema(jnp.asarray(xs), jnp.asarray(a), 7, parts=1,
                              select="two_pass", interpret=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_gather_rows_plain_bf16_equals_pallas():
    rng = np.random.RandomState(2)
    a = _values(rng, 2, 40, 12)
    idx = rng.randint(0, 40, (2, 16, 5)).astype(np.int32)
    got = gr.gather_rows_plain(torch.from_numpy(a), torch.from_numpy(idx),
                               parts=1)
    want = gather_rows(jnp.asarray(a), jnp.asarray(idx), parts=1,
                       interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("call", ["gather_extrema", "knn_gather_extrema",
                                  "gather_rows"])
def test_cpu_gathers_are_exact_at_either_setting(call, settings):
    """On the CPU a wrapper without ``parts`` gathers exactly whatever
    ``--gather_precision`` says, as the JAX package's CPU path does; named
    ``parts`` it takes the rounded values."""
    rng = np.random.RandomState(3)
    xs = torch.from_numpy(rng.randn(2, 32, 4).astype(np.float32))
    a = torch.from_numpy(_values(rng, 2, 32, 8))
    idx = torch.from_numpy(rng.randint(0, 32, (2, 32, 6)).astype(np.int32))
    fn = {"gather_extrema": lambda **kw: nb.gather_extrema(idx, a, **kw)[0],
          "knn_gather_extrema": lambda **kw: nb.knn_gather_extrema(
              xs, a, 6, **kw)[0],
          "gather_rows": lambda **kw: gr.gather_rows(a, idx, **kw)}[call]
    config.set_gather_value_parts(2)
    exact = fn()
    config.set_gather_value_parts(1)
    assert torch.equal(fn(), exact)
    assert torch.equal(fn(parts=2), exact)
    assert not torch.equal(fn(parts=1), exact)


# ------------------------------------------------------- kernels 5 and 7
def _affines(rng, widths):
    return [((rng.randn(cin, cout) / np.sqrt(cin)).astype(np.float32),
             (0.1 * rng.randn(cout)).astype(np.float32))
            for cin, cout in zip(widths[:-1], widths[1:])]


def _cloud(seed):
    return (np.random.RandomState(seed).rand(2, 128, 3) - 0.5).astype(
        np.float32)


def test_fused_ball_mlp3_plain_bf16_close_to_pallas():
    rng = np.random.RandomState(4)
    xyz = _cloud(4)
    new_xyz = xyz[:, ::4]
    D, widths, radius, k = 24, (64, 64, 128), 0.25, 32
    (a1, b1), (a2, b2), (a3, b3) = _affines(rng, (D + 3,) + widths)
    uf = 4.0 * rng.randn(2, 128, D).astype(np.float32) @ a1[:D]
    args = [new_xyz, xyz, uf, b1, a1[D:], a2, b2, a3, b3]
    got = gr.fused_ball_mlp3_plain(
        *[torch.from_numpy(np.ascontiguousarray(t)) for t in args],
        radius=radius, k=k, parts=1)
    want = np.asarray(fused_ball_mlp3(*[jnp.asarray(t) for t in args],
                                      radius=radius, k=k, parts=1,
                                      interpret=True))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    exact = gr.fused_ball_mlp3_plain(
        *[torch.from_numpy(np.ascontiguousarray(t)) for t in args],
        radius=radius, k=k)
    assert float((got - exact).abs().max()) > 10 * TOL["atol"]


def test_fused_pointconv_sa_plain_bf16_close_to_pallas():
    rng = np.random.RandomState(5)
    xyz = _cloud(5)
    new_xyz = xyz[:, ::4]
    D, widths, k = 16, (32, 48, 64), 16
    inv = (rng.rand(2, 128) + 0.5).astype(np.float32)
    idx, den, dmax = gr.knn_with_density_plain(
        torch.from_numpy(new_xyz), torch.from_numpy(xyz),
        torch.from_numpy(inv), k)
    (a1, b1), (a2, b2), (a3, b3) = _affines(rng, (D + 3,) + widths)
    src = np.concatenate([xyz, 4.0 * rng.randn(2, 128, D).astype(np.float32)],
                         -1)
    u, csw = src @ a1 + b1, new_xyz @ a1[:3]
    dnet, wnet = _affines(rng, (1, 16, 8, 1)), _affines(rng, (3, 8, 8, 16))
    arrays = [idx.numpy(), den.numpy(), dmax.numpy(), new_xyz, u, xyz, csw,
              a2, b2, a3, b3]
    tt = [torch.from_numpy(np.ascontiguousarray(t)) for t in arrays]
    tnets = [[(torch.from_numpy(w), torch.from_numpy(b)) for w, b in net]
             for net in (dnet, wnet)]
    got = gr.fused_pointconv_sa_plain(*tt, *tnets, k=k, parts=1)
    want = np.asarray(fused_pointconv_sa(
        *[jnp.asarray(t) for t in arrays],
        [(jnp.asarray(w), jnp.asarray(b)) for w, b in dnet],
        [(jnp.asarray(w), jnp.asarray(b)) for w, b in wnet],
        k=k, parts=1, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the kernel's emulation at parts=1 and highest is the plain version's
    # arithmetic up to its split products
    emulated = em.pointconv_sa_at(*tt, *tnets, k=k, precision="highest",
                                  parts=1)
    torch.testing.assert_close(emulated, got, **TOL)


# -------------------------------------------------- the one-pass products
def _assert_f32_sums(got, x, w):
    """got (f32) against x @ w in float64 (x, w float64, exact products),
    within the error bound of an f32 sum of K terms."""
    bound = x.shape[-1] * 2.0 ** -24 * torch.matmul(x.abs(), w.abs())
    over = (got.double() - torch.matmul(x, w)).abs() - bound
    assert float(over.max()) <= 0.0


@pytest.mark.parametrize("name,rounding", [("matmul_tf32", em.round_tf32),
                                           ("matmul_bf16", pr.round_bf16)])
def test_one_pass_products_are_exact_products_of_rounded_operands(name,
                                                                  rounding):
    rng = np.random.RandomState(6)
    x = torch.from_numpy(_values(rng, 3, 40, 24))
    w = torch.from_numpy(_values(rng, 24, 16))
    got = getattr(em, name)(x, w)
    _assert_f32_sums(got, rounding(x).double(), rounding(w).double())
    assert float((got.double() - torch.matmul(x.double(), w.double())
                  ).abs().max()) > 1e-3                # coarser than f32


def test_roundings():
    """bf16: to nearest even, as torch and XLA round; TF32: to nearest, ties
    away from zero; both keep the sign and leave representable values."""
    one = 1.0
    ulp_bf16, ulp_tf32 = 2.0 ** -7, 2.0 ** -10
    x = torch.tensor([one + ulp_bf16 / 2, one + 3 * ulp_bf16 / 2,
                      -(one + ulp_bf16 / 2), one + ulp_bf16], dtype=torch.float32)
    assert pr.round_bf16(x).tolist() == [one, one + 2 * ulp_bf16, -one,
                                         one + ulp_bf16]
    jx = np.asarray(jnp.asarray(x.numpy()).astype(jnp.bfloat16).astype(
        jnp.float32))
    np.testing.assert_array_equal(pr.round_bf16(x).numpy(), jx)
    t = torch.tensor([one + ulp_tf32 / 2, -(one + ulp_tf32 / 2),
                      one + ulp_tf32 / 4], dtype=torch.float32)
    assert em.round_tf32(t).tolist() == [one + ulp_tf32, -(one + ulp_tf32), one]
    rng = np.random.RandomState(7)
    v = torch.from_numpy(_values(rng, 1000))
    for rnd, bits in ((pr.round_bf16, 16), (em.round_tf32, 13)):
        r = rnd(v)
        assert int((r.view(torch.int32) & ((1 << bits) - 1)).abs().max()) == 0
        assert torch.equal(rnd(r), r)
        assert torch.equal(torch.sign(r), torch.sign(v))


@pytest.mark.parametrize("x_shape,w_shape", [((2, 5, 6), (6, 4)),
                                             ((2, 5, 6), (2, 6, 3)),
                                             ((7, 6), (6, 4))])
def test_precision_product_gradcheck(x_shape, w_shape):
    """The product's backward in float64, on bf16-rounded inputs: a float64
    product is exact at every setting, so gradcheck holds the backward's
    transposes and its sums over broadcast dimensions."""
    rng = np.random.RandomState(8)
    x = pr.round_bf16(torch.from_numpy(rng.randn(*x_shape))).requires_grad_()
    w = pr.round_bf16(torch.from_numpy(rng.randn(*w_shape))).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda a, b: pr.PrecisionMatmul.apply(a, b, em.matmul_bf16),
        (x, w))


@pytest.mark.parametrize("name,rounding", [("matmul_tf32", em.round_tf32),
                                           ("matmul_bf16", pr.round_bf16)])
def test_precision_product_backward_rounds_its_operands(name, rounding):
    """In f32 each backward product takes its operands rounded, as the
    forward's: dx = round(g) @ round(w)^T, dw = round(x)^T @ round(g)."""
    rng = np.random.RandomState(9)
    x = torch.from_numpy(_values(rng, 3, 10, 12)).requires_grad_()
    w = torch.from_numpy(_values(rng, 12, 8)).requires_grad_()
    g = torch.from_numpy(_values(rng, 3, 10, 8))
    y = pr.PrecisionMatmul.apply(x, w, getattr(em, name))
    y.backward(g)
    rx, rw, rg = (rounding(t.detach()).double() for t in (x, w, g))
    _assert_f32_sums(y.detach(), rx, rw)
    _assert_f32_sums(x.grad, rg, rw.T)
    _assert_f32_sums(w.grad, rx.reshape(-1, 12).T, rg.reshape(-1, 8))


@pytest.mark.parametrize("precision", config.MATMUL_PRECISIONS)
def test_cpu_products_are_f32_at_every_setting(precision, settings):
    rng = np.random.RandomState(10)
    x = torch.from_numpy(_values(rng, 4, 9, 6))
    w = torch.from_numpy(_values(rng, 6, 5))
    config.set_matmul_precision(precision)
    assert torch.equal(pr.matmul(x, w), torch.matmul(x, w))
    layer = torch.nn.Linear(6, 5)
    assert torch.equal(common.pointwise(x, layer), layer(x))


# ------------------------------------------------------ the settings
def _state():
    return (config.matmul_precision(), config.gather_value_parts())


def _jax_state():
    # the JAX package resets to "default" after a flag, from None at start
    mm = jax.config.jax_default_matmul_precision
    return (mm or "default", jax_config.gather_value_parts())


FLAGS = ["--matmul_precision", "high", "--gather_precision", "bf16"]


def test_config_from_args_sets_both_settings_on_every_call(settings):
    """Called twice, with the flags and then without them, each package's
    ``config_from_args`` leaves the state a call without flags leaves: no
    setting leaks from one call to the next.  With the same explicit flags
    both packages hold the same state."""
    for cli, state, plain in ((port_cli, _state, ("highest", 2)),
                              (jax_cli, _jax_state, ("default", 1))):
        parser = cli.base_parser("t")
        cli.config_from_args(parser.parse_args([]))
        assert state() == plain
        cli.config_from_args(parser.parse_args(FLAGS))
        assert state() == ("high", 1)
        cli.config_from_args(parser.parse_args([]))
        assert state() == plain
    for mm in config.MATMUL_PRECISIONS:
        for gp in config.GATHER_PRECISIONS:
            argv = ["--matmul_precision", mm, "--gather_precision", gp]
            port_cli.config_from_args(port_cli.base_parser("t").parse_args(argv))
            jax_cli.config_from_args(jax_cli.base_parser("t").parse_args(argv))
            assert _state() == _jax_state() == (mm, 1 if gp == "bf16" else 2)


def _choices(parser, flag):
    action = next(a for a in parser._actions if flag in a.option_strings)
    return list(action.choices), action.default


class _Parsed(Exception):
    pass


@pytest.mark.parametrize("name", PORT_CLIS)
def test_every_cli_takes_both_flags(name, monkeypatch, settings):
    """Each CLI built on ``base_parser`` parses both flags with the JAX
    package's choices and hands them to ``config_from_args`` (stopped
    there, before any work)."""
    for flag in ("--matmul_precision", "--gather_precision"):
        port = _choices(port_cli.base_parser("t"), flag)
        jax_side = _choices(jax_cli.base_parser("t"), flag)
        assert sorted(port[0]) == sorted(jax_side[0])
        assert port[1] == {"--matmul_precision": "highest",
                           "--gather_precision": "hilo"}[flag]
    module = importlib.import_module(f"interpret_quality_tpu_torch.cli.{name}")
    seen = []

    def stop(args: argparse.Namespace):
        seen.append((args.matmul_precision, args.gather_precision))
        raise _Parsed
    monkeypatch.setattr(module, "config_from_args", stop)
    for mm in config.MATMUL_PRECISIONS:
        for gp in config.GATHER_PRECISIONS:
            with pytest.raises(_Parsed):
                module.main(["--device", "cpu", "--matmul_precision", mm,
                             "--gather_precision", gp])
    assert len(seen) == 6
