"""Kernel 3's compacted scan (``csrc/knn_select.cuh`` ``select_knn`` with
kCompact), step for step through its emulation,
``ops.cuda.emulation.select_knn_compact``: a cloud's distinct rows scanned,
each entering the neighbour lists with its copies, give the indices of a
stable sort over all N rows, at every selection class, on clouds whose
collapsed centre has more copies than k and on a coarse grid where rows of
other classes tie with it.  The kernel is held against the emulation on the
card (``tests/test_torch_cuda.py``)."""
from __future__ import annotations

import pytest
import torch

from interpret_quality_tpu_torch.ops.cuda import emulation as em
from interpret_quality_tpu_torch.ops.geometry import sorted_topk_indices


def clouds(kind, B, N, C, seed):
    """random; masked (70% of the points on the cloud's mean, as a
    coalition puts its absent regions on the centre); coincident (every
    point on one); grid: every coordinate in {-1, -0.5, 0, 0.5, 1}, so
    every distance is exact and rows of other classes tie often, with 70%
    of the points from N // 3 on sitting on the grid point of row N // 3,
    so the collapsed row arrives after rows it ties with."""
    g = torch.Generator().manual_seed(seed)
    if kind == "grid":
        x = torch.randint(-2, 3, (B, N, C), generator=g).float() / 2
        absent = ((torch.rand(B, N, generator=g) < 0.7)
                  & (torch.arange(N) >= N // 3))
        return torch.where(absent[..., None], x[:, N // 3:N // 3 + 1], x)
    if kind == "coincident":
        return torch.randn(B, 1, C, generator=g).expand(B, N, C).contiguous()
    x = torch.randn(B, N, C, generator=g)
    if kind == "masked":
        kept = torch.rand(B, N, 1, generator=g) < 0.3
        x = torch.where(kept, x, x.mean(1, keepdim=True))
    return x


def stable_sort(xs, k, cls="exact"):
    # + 0.0 turns -0 into +0: the kernel's float compares do not tell them apart
    return sorted_topk_indices(em.square_distance_chain(xs, xs, cls) + 0.0, k)


@pytest.mark.parametrize("kind", ["random", "masked", "coincident", "grid"])
@pytest.mark.parametrize("k", [7, 20, 32])
def test_compacted_scan_is_the_stable_sort(kind, k):
    """At ragged N (100, 300) and C = 3 and 64: the emulated scan's indices
    equal a stable sort's over every row, copies of a centre of more than
    k copies falling off at entry k - 1; its distances are each cloud's
    distinct rows squared."""
    for N, C in ((100, 3), (300, 64)):
        xs = clouds(kind, 2, N, C, seed=N + k)
        sel = em.select_knn_compact(xs, k)
        assert torch.equal(sel.idx, stable_sort(xs, k)), (N, C)
        d = [torch.unique(x, dim=0).shape[0] for x in xs]
        assert sel.distances.tolist() == [n * n for n in d]
        if kind == "coincident":
            assert torch.equal(sel.idx, torch.arange(k, dtype=torch.int32)
                               .expand(2, N, k))


@pytest.mark.parametrize("cls", ["packed", "bf16"])
@pytest.mark.parametrize("kind", ["masked", "grid"])
def test_compacted_scan_at_each_class(cls, kind):
    """The packed and bf16 classes make more keys equal; the scan still
    gives the stable sort of the class's keys."""
    xs = clouds(kind, 2, 300, 16, seed=3)
    assert torch.equal(em.select_knn_compact(xs, 20, cls).idx,
                       stable_sort(xs, 20, cls))


def test_tie_path_engages_on_grid_clouds_only():
    """The tie path (a row of several copies at the distance of another
    row's entry) engages on grid clouds, at C = 3 and 64, and never on
    random clouds, which have no copies."""
    for C in (3, 64):
        assert int(em.select_knn_compact(clouds("grid", 2, 300, C, 1),
                                         20).tie_rows.sum()) > 0, C
        assert em.select_knn_compact(clouds("random", 2, 300, C, 1),
                                     20).tie_rows.tolist() == [0, 0]


def test_copy_lists_are_each_class_ascending():
    """Each distinct row, in ascending order, lists its copies ascending,
    itself first; together the lists hold every row once."""
    x = clouds("grid", 1, 200, 3, seed=4)[0]
    cl = em.copy_lists(x)
    assert torch.equal(cl.rows, torch.nonzero(cl.first == torch.arange(200))
                       .flatten())
    assert torch.equal(torch.sort(cl.copies).values, torch.arange(200))
    assert int(cl.starts[-1]) == 200
    for p, row in enumerate(cl.rows.tolist()):
        own = cl.copies[int(cl.starts[p]):int(cl.starts[p + 1])]
        assert int(own[0]) == row
        assert torch.equal(own, torch.nonzero(cl.first == row).flatten())
        assert bool((x[own] == x[row]).all())


def test_compacted_scan_takes_k_up_to_32():
    xs = clouds("random", 1, 40, 3, seed=0)
    with pytest.raises(ValueError):
        em.select_knn_compact(xs, 33)
