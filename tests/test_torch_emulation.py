"""The arithmetic of the redesigned CUDA kernels, pinned on the CPU.

The kernels of ``fused_ball_mlp3`` and ``fused_pointconv_sa`` run layers 2
and 3 (the latter its contraction too) on the tensor cores with a
three-product TF32 split, ``select_knn`` computes a distance as one
multiply-add chain per (query, database row), and ``fps`` takes its argmax
over the distances' bits.  No kernel runs without a card, so
``ops/cuda/emulation.py`` repeats their arithmetic in plain PyTorch and
these tests hold it against the plain versions: the split keeps f32 accuracy
(rtol 1e-5 on the layers, where a single TF32 pass would keep 1e-3),
identical database rows get bit-identical distances, so that a lowest-index
selection over them is ``knn_plain``'s, and the bitwise argmax picks
``fps_plain``'s index at every step.
"""
import numpy as np
import pytest
import torch

from interpret_quality_tpu_torch.attrib.coalitions import (
    keep_matrix_from_orders, masked_coalitions)
from interpret_quality_tpu_torch.models.pointnet2 import SA1, SA2
from interpret_quality_tpu_torch.ops.cuda import emulation as em
from interpret_quality_tpu_torch.ops.cuda import fps as fp
from interpret_quality_tpu_torch.ops.cuda import groups as gr
from interpret_quality_tpu_torch.ops.cuda import neighbors as nb
from interpret_quality_tpu_torch.ops.geometry import sorted_topk_indices

# (C1, C2, C3) of the six PointNet++ MSG branches
BRANCHES = list(SA1[3]) + list(SA2[3])


def _randn(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def test_split_tf32_halves_are_tf32_and_sum_to_x():
    rng = np.random.RandomState(0)
    x = _randn(rng, 4096) * torch.from_numpy(
        (10.0 ** rng.uniform(-6, 6, 4096)).astype(np.float32))
    hi, lo = em.split_tf32(x)
    for part in (hi, lo):        # the 13 low mantissa bits are clear
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    # hi keeps 11 significant bits, lo the next 11: 2**-21 of |x| is left
    assert float(((hi + lo) - x).abs().div(x.abs()).max()) <= 2.0 ** -21
    assert torch.equal(em.split_tf32(hi)[0], hi)
    assert float(em.split_tf32(hi)[1].abs().max()) == 0.0


@pytest.mark.parametrize("widths", BRANCHES,
                         ids=[f"sa{1 + i // 3}-branch{i % 3}" for i in range(6)])
def test_three_product_split_matches_f32_layers(widths):
    """Layers 2-3 on the emulated split vs ``_mlp23`` (f32 matmuls) at the
    widths of every PointNet++ branch: rtol 1e-5 (atol 1e-5 for the values
    that ReLU leaves near 0).  One TF32 pass alone misses that by far."""
    C1, C2, C3 = widths
    rng = np.random.RandomState(C1 + C2 + C3)
    h = torch.relu(_randn(rng, 512, C1))
    a2, b2 = _randn(rng, C1, C2) / C1 ** 0.5, 0.1 * _randn(rng, C2)
    a3, b3 = _randn(rng, C2, C3) / C2 ** 0.5, 0.1 * _randn(rng, C3)
    want = gr._mlp23(h, a2, b2, a3, b3)
    got = em.mlp23_3xtf32(h, a2, b2, a3, b3)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    single = torch.relu(torch.matmul(em.split_tf32(torch.relu(torch.matmul(
        em.split_tf32(h)[0], em.split_tf32(a2)[0]) + b2))[0],
        em.split_tf32(a3)[0]) + b3)
    assert float((single - want).abs().max()) > 20 * float(
        (got - want).abs().max())


@pytest.mark.parametrize("C,k", [(3, 20), (3, 32), (5, 7), (64, 20)])
def test_duplicate_rows_get_identical_distances(C, k):
    """An exact-duplicate cloud (128 rows, 8 times over): the chain gives
    the 8 copies of a row bit-identical distances to every query, a copy's
    distance to itself included, so the lowest-index selection takes the
    copies in index order; at C = 3 that is ``knn_plain``'s selection."""
    g = torch.Generator().manual_seed(C)
    base = torch.randn(4, 128, C, generator=g)
    xs = base.repeat(1, 8, 1).contiguous()
    d = em.square_distance_chain(xs, xs)
    copies = d.reshape(4, 1024, 8, 128)
    assert torch.equal(copies, copies[:, :, :1].expand_as(copies))
    idx = sorted_topk_indices(d, k)
    # the nearest 8 are the query's own copies, lowest index first
    own = (torch.arange(1024) % 128)[None, :, None] + 128 * torch.arange(8)
    assert torch.equal(idx[..., :min(k, 8)].long(),
                       own.expand(4, -1, -1)[..., :min(k, 8)])
    if C == 3:
        assert torch.equal(idx, nb.knn_plain(xs, xs, k))


def test_chain_distance_close_to_plain():
    rng = np.random.RandomState(5)
    q, db = _randn(rng, 2, 77, 64), _randn(rng, 2, 100, 64)
    from interpret_quality_tpu_torch.ops.geometry import square_distance
    torch.testing.assert_close(em.square_distance_chain(q, db),
                               square_distance(q, db), rtol=1e-5, atol=1e-4)


def _masked_batch(n: int, regions: int, seed: int) -> torch.Tensor:
    """The coalition batch of one order of a random cloud: regions + 1
    clouds, from every region on the centre to none (exact ties all over)."""
    rng = np.random.RandomState(seed)
    data = torch.from_numpy((rng.rand(n, 3) - 0.5).astype(np.float32))
    region_id = torch.from_numpy(rng.randint(0, regions, n))
    keep = torch.from_numpy(keep_matrix_from_orders(
        rng.permutation(regions)[None]))
    return masked_coalitions(data, data.mean(0), keep, region_id).contiguous()


def _affine(rng, cin, cout):
    return _randn(rng, cin, cout) / cin ** 0.5, 0.1 * _randn(rng, cout)


@pytest.mark.parametrize("widths,k,D", [
    ((64, 64, 128), 32, 0), ((128, 128, 256), 64, 128), ((64, 64, 128), 16, 0),
    ((32, 32, 64), 20, 8)], ids=["sa1", "sa2", "sa1-k16", "narrow-k20"])
def test_pointconv_sa_split_matches_plain(widths, k, D):
    """Kernel 7's arithmetic (layers 2-3 and the contraction on the split
    products) against ``fused_pointconv_sa_plain`` at both real width sets
    and two more the kernel takes, on a masked batch: rtol 1e-4 / atol 1e-5,
    the tolerance the kernel is held to on the card.  Only lo @ w_lo, 2**-22
    of a product, is dropped, and sums run in another order."""
    C1, C2, C3 = widths
    rng = np.random.RandomState(k)
    xyz = _masked_batch(128, 4, seed=k)[1:4]
    new_xyz = xyz[:, ::4].contiguous()
    inv = torch.from_numpy((rng.rand(3, 128) + 0.5).astype(np.float32))
    idx, den, dmax = gr.knn_with_density_plain(new_xyz, xyz, inv, k)
    (a1, b1), (a2, b2), (a3, b3) = (_affine(rng, 3 + D, C1),
                                    _affine(rng, C1, C2), _affine(rng, C2, C3))
    u = torch.cat([xyz, _randn(rng, 3, 128, D)], -1) @ a1 + b1
    csw = new_xyz @ a1[:3]
    dnet = [_affine(rng, 1, 16), _affine(rng, 16, 8), _affine(rng, 8, 1)]
    dnet[-1] = (dnet[-1][0].abs(), dnet[-1][1].abs())   # a scale that is not all 0
    wnet = [_affine(rng, 3, 8), _affine(rng, 8, 8), _affine(rng, 8, 16)]
    args = (idx, den, dmax, new_xyz, u, xyz, csw, a2, b2, a3, b3, dnet, wnet)
    want = gr.fused_pointconv_sa_plain(*args, k=k)
    got = em.pointconv_sa_3xtf32(*args, k=k)
    assert got.shape == want.shape == (3, 32, C3 * 16)
    assert float((want != 0).float().mean()) > 0.25
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case,n,npoint", [
    ("masked", 1024, 64), ("masked", 512, 128), ("masked", 300, 40),
    ("masked", 100, 130), ("coincident", 256, 9), ("random", 77, 77)])
def test_fps_bitwise_argmax_picks_the_plain_index(case, n, npoint):
    """The register route's argmax (thread-strided points, strict > inside a
    thread, max of the f32 bits as unsigned integers and the lowest index
    among the equal across lanes and warps, empty slots at distance 0) picks
    ``fps_plain``'s index at every step: on masked clouds with whole regions
    on one point, with N no multiple of the block, with npoint > N, and
    where all points coincide."""
    if case == "masked":
        xyz = _masked_batch(n, 6, seed=n)[1:6]
    elif case == "coincident":
        xyz = torch.full((2, n, 3), 0.25)
    else:
        xyz = _randn(np.random.RandomState(n), 3, n, 3)
    got = em.fps_register_route(xyz, npoint)
    assert got.dtype == torch.int32 and bool((got[:, 0] == 0).all())
    assert torch.equal(got, fp.fps_plain(xyz, npoint))
