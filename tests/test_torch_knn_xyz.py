"""The xyz route of the kNN kernels (``csrc/knn_xyz.cuh``), held on the CPU
through its emulation, ``ops.cuda.emulation.select_knn_xyz``.

No kernel runs without a card.  The emulation repeats the route's
algorithm step for step (lane partition, the prefilter's first list, the
survivor buffer and its merges, the (distance, index) key) on
``square_distance_chain``'s distances, so that:

- on any cloud it must equal a stable ascending sort of those same
  distances (the route's contract: ties to the lowest index, whatever order
  the candidates arrive in);
- on clouds where every distance is exact (a 1/64 grid, masked coalitions
  of a grid cloud with a grid centre, all points on one) it must equal
  ``knn_plain`` / ``knn_with_density_plain`` and the JAX package's Pallas
  kernels in interpret mode, bit for bit.

The card itself holds the kernel against its tiled route and the plain
versions (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interpret_quality_tpu.ops.pallas.groups import knn_with_density
from interpret_quality_tpu.ops.pallas.neighbors import knn_pallas
from interpret_quality_tpu_torch.attrib.coalitions import (
    keep_matrix_from_orders, masked_coalitions)
from interpret_quality_tpu_torch.ops.cuda import emulation as em
from interpret_quality_tpu_torch.ops.cuda import groups as gr
from interpret_quality_tpu_torch.ops.cuda import neighbors as nb
from interpret_quality_tpu_torch.ops.geometry import sorted_topk_indices

KINDS = ("random", "grid", "masked", "coincident")


def _cloud(kind: str, B: int, N: int, seed: int) -> torch.Tensor:
    """(B, N, 3) float32 clouds; all but "random" have exact distances."""
    rng = np.random.RandomState(seed)
    if kind == "random":
        x = rng.standard_normal((B, N, 3))
    elif kind == "grid":
        x = rng.randint(-64, 64, (B, N, 3)) / 64
    elif kind == "coincident":
        x = np.broadcast_to(rng.randint(-64, 64, (B, 1, 3)) / 64, (B, N, 3))
    else:
        return _masked_grid_batch(B, N, rng)
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))


def _masked_grid_batch(B: int, N: int, rng) -> torch.Tensor:
    """B coalition clouds of one grid cloud of 8 regions: regions off the
    coalition sit on a grid centre, so exact ties are everywhere."""
    data = torch.from_numpy((rng.randint(-32, 32, (N, 3)) / 64).astype(np.float32))
    centre = torch.round(data.mean(0) * 64) / 64
    region_id = torch.from_numpy(rng.randint(0, 8, N))
    keep = torch.from_numpy(keep_matrix_from_orders(rng.permutation(8)[None]))
    batch = masked_coalitions(data, centre, keep, region_id)       # (9, N, 3)
    return batch[rng.randint(0, 9, B)].contiguous()


def _queries(db: torch.Tensor, S: int, seed: int) -> torch.Tensor:
    """S query rows: the database itself when S == N, else rows of it with
    a few grid points beside them."""
    B, N, _ = db.shape
    if S == N:
        return db
    rng = np.random.RandomState(seed + 1)
    q = db[:, rng.randint(0, N, S)].clone()
    q[:, ::3] += torch.from_numpy((rng.randint(-4, 4, q[:, ::3].shape) / 64)
                                  .astype(np.float32))
    return q.contiguous()


CASES = [(k, N) for k in (1, 20, 32, 64) for N in (k, 33, 100, 256) if N >= k]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k,N", CASES, ids=[f"k{k}-N{N}" for k, N in CASES])
def test_xyz_selection_is_a_stable_sort_of_its_distances(kind, k, N):
    """On every cloud, and with S == N and S != N: the emulated route equals
    a stable ascending sort of the chain's distances."""
    db = _cloud(kind, 2, N, seed=k + N)
    for S in (N, 48):
        q = _queries(db, S, seed=k)
        got = em.select_knn_xyz(q, db, k).idx
        want = sorted_topk_indices(em.square_distance_chain(q, db) + 0.0, k)
        assert got.dtype == torch.int32 and got.shape == (2, S, k)
        assert torch.equal(got, want)


@pytest.mark.parametrize("kind", ("grid", "masked", "coincident"))
@pytest.mark.parametrize("k", [1, 20, 32, 64])
def test_xyz_selection_equals_the_plain_versions(kind, k):
    """Where every distance is exact: the plain kNN's indices, and the plain
    kNN-with-density's indices, densities and maxima at them."""
    db = _cloud(kind, 3, 100, seed=k)
    q = _queries(db, 40, seed=k)
    got = em.select_knn_xyz(q, db, k).idx
    assert torch.equal(got, nb.knn_plain(q, db, k))
    inv = torch.from_numpy(np.random.RandomState(k).rand(3, 100).astype(np.float32) + 0.5)
    idx, den, dmax = gr.knn_with_density_plain(q, db, inv, k)
    assert torch.equal(got, idx)
    got_den = torch.gather(inv, 1, got.reshape(3, -1).long()).reshape(den.shape)
    assert torch.equal(got_den, den)
    assert torch.equal(got_den.amax(-1, keepdim=True), dmax)


@pytest.mark.parametrize("k", [1, 20, 32, 64])
def test_xyz_selection_equals_the_pallas_kernels(k):
    """Against ``knn_pallas`` (k <= 32, kernel 1's range) and
    ``knn_with_density`` in interpret mode, lowest-index ties
    (``select="two_pass"``): 32 queries among 64 points, one cloud of each
    exact kind (grid, masked, coincident)."""
    db = torch.cat([_cloud(kind, 1, 64, seed=2 * k)
                    for kind in ("grid", "masked", "coincident")])
    q = _queries(db, 32, seed=k)
    got = em.select_knn_xyz(q, db, k).idx.numpy()
    if k <= 32:
        want = knn_pallas(jnp.asarray(q.numpy()), jnp.asarray(db.numpy()), k,
                          select="two_pass", interpret=True)
        np.testing.assert_array_equal(got, np.asarray(want))
    inv = (np.random.RandomState(k).rand(3, 64) + 0.5).astype(np.float32)
    want = knn_with_density(jnp.asarray(q.numpy()), jnp.asarray(db.numpy()),
                            jnp.asarray(inv), k, select="two_pass",
                            interpret=True)
    np.testing.assert_array_equal(got, np.asarray(want[0]))


def _lane_skewed_cloud(N: int = 1024):
    """One query at the origin and N points whose squared distances are set
    lane by lane (lane l = index mod 32): lane 0's points are the nearest,
    lane l's lie at 1 + l / 100 + j / 10**4 (j = index // 32).  The first
    list (each lane's nearest) then reaches far out, so pass 2 lets through
    more candidates than the buffer holds at once."""
    rng = np.random.RandomState(0)
    c = np.arange(N)
    lane, j = c % 32, c // 32
    d2 = np.where(lane == 0, 0.01 + j / 10 ** 4, 1 + lane / 100 + j / 10 ** 4)
    u = rng.standard_normal((N, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    db = torch.from_numpy((u * np.sqrt(d2)[:, None]).astype(np.float32))[None]
    return torch.zeros(1, 1, 3), db


@pytest.mark.parametrize("k", [20, 64])
def test_prefilter_passing_more_than_the_buffer_holds(k):
    """The buffer holds 64 survivors and is merged every 32: a query whose
    survivors overflow it many times still gets the exact answer."""
    q, db = _lane_skewed_cloud()
    sel = em.select_knn_xyz(q, db, k)
    assert int(sel.survivors.max()) > em.XYZ_BUFFER
    assert int(sel.flushes.max()) >= 2
    assert torch.equal(sel.idx, nb.knn_plain(q, db, k))
    assert torch.equal(sel.idx, sorted_topk_indices(em.square_distance_chain(q, db), k))


@pytest.mark.parametrize("kind", ["random", "masked"])
@pytest.mark.parametrize("k", [20, 64])
def test_xyz_selection_over_several_segments(kind, k):
    """N = 1100: 32 candidates a lane in registers, so two segments, the
    second computed again in pass 2."""
    db = _cloud(kind, 1, 1100, seed=k)
    q = _queries(db, 24, seed=k)
    got = em.select_knn_xyz(q, db, k).idx
    assert torch.equal(got, sorted_topk_indices(em.square_distance_chain(q, db) + 0.0, k))


def test_coincident_copies_never_survive_the_prefilter():
    """All points on one: every distance ties, the first list holds the
    lanes' lowest indices, and the key rejects every later copy."""
    db = _cloud("coincident", 2, 256, seed=0)
    sel = em.select_knn_xyz(db, db, 20)
    assert int(sel.survivors.max()) == 0
    assert torch.equal(sel.idx, torch.arange(20, dtype=torch.int32).expand(2, 256, 20))


def test_negative_and_signed_zero_distances_order_as_floats():
    """Rounding can make a distance slightly negative, and a distance can be
    -0: the key orders them as floats (-0 == +0, ties to the lower index)."""
    db = torch.tensor([[[1e4, 1e4, 1e4], [0.0, 0.0, 0.0], [1e4, 1e4, 1.0001e4]]])
    q = torch.tensor([[[1e4, 1e4, 1e4]]])
    dist = em.square_distance_chain(q, db)
    sel = em.select_knn_xyz(q, db, 3)
    assert torch.equal(sel.idx, sorted_topk_indices(dist + 0.0, 3))
    assert torch.equal(sel.idx, torch.tensor([[[0, 2, 1]]], dtype=torch.int32))


def test_emulation_refuses_k_beyond_n():
    with pytest.raises(ValueError):
        em.select_knn_xyz(torch.zeros(1, 2, 3), torch.zeros(1, 4, 3), 5)
