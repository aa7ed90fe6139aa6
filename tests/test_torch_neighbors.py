"""The port's neighbour functions against the JAX package's.

On the CPU the wrappers of ``interpret_quality_tpu_torch/ops/cuda/neighbors``
run their plain versions; those are held here against the JAX XLA ops
(``geometry.knn``, ``index_points`` + max/min) and against the Pallas
kernels in interpret mode with the exact settings (``select="two_pass"``,
``parts=2``).  The CUDA kernels themselves are held against the plain
versions on the card (tests/test_torch_cuda.py and ``chip_smoke.py``).

Tolerances:
  * indices: exactly equal — ascending distance, ties to the lowest index —
    on random clouds, on clouds whose points are each duplicated 8x (exact
    ties everywhere) and on a real masked-coalition batch (whole regions
    collapsed onto the centre);
  * extrema vs XLA: exactly equal (the same rows, max/min are exact);
  * extrema vs Pallas ``parts=2``: atol 5e-5, the hi/lo bf16 gather's ~2^-16
    relative error on values of order 1, as in tests/test_pallas_neighbors.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interpret_quality_tpu.ops.geometry import index_points as jax_index_points
from interpret_quality_tpu.ops.geometry import knn as jax_knn
from interpret_quality_tpu.ops.pallas import (gather_extrema as pallas_gather,
                                              knn_gather_extrema as pallas_kge,
                                              knn_pallas)
from interpret_quality_tpu_torch.attrib.coalitions import (
    keep_matrix_from_orders, masked_coalitions)
from interpret_quality_tpu_torch.ops.cuda import launch
from interpret_quality_tpu_torch.ops.cuda import neighbors as nb

K, F = 7, 16
PALLAS_ATOL = 5e-5


def _clouds(kind: str) -> np.ndarray:
    rng = np.random.RandomState({"random": 0, "dup8": 1, "masked": 2}[kind])
    if kind == "random":
        return rng.randn(3, 64, 5).astype(np.float32)
    if kind == "dup8":
        base = rng.randn(3, 8, 5).astype(np.float32)
        return np.concatenate([base] * 8, axis=1)
    # a masked-coalition batch: 2 orders x 5 rows of one 64-point cloud
    cloud = rng.randn(64, 3).astype(np.float32)
    region_id = torch.from_numpy(rng.randint(0, 4, 64))
    orders = np.stack([rng.permutation(4) for _ in range(2)])
    keep = torch.from_numpy(keep_matrix_from_orders(orders))
    data = torch.from_numpy(cloud)
    return masked_coalitions(data, data.mean(0), keep, region_id).numpy()


def _values(xs: np.ndarray) -> np.ndarray:
    rng = np.random.RandomState(7)
    return rng.randn(xs.shape[0], xs.shape[1], F).astype(np.float32)


KINDS = ["random", "dup8", "masked"]


@pytest.mark.parametrize("kind", KINDS)
def test_knn_indices_equal_xla_and_pallas(kind):
    xs = _clouds(kind)
    got = nb.knn(torch.from_numpy(xs), torch.from_numpy(xs), K).numpy()
    assert got.dtype == np.int32 and got.shape == xs.shape[:2] + (K,)
    np.testing.assert_array_equal(got, np.asarray(jax_knn(jnp.asarray(xs), K)))
    pallas = knn_pallas(jnp.asarray(xs), jnp.asarray(xs), K,
                        select="two_pass", interpret=True)
    np.testing.assert_array_equal(got, np.asarray(pallas))


def test_knn_separate_query_equals_pallas():
    rng = np.random.RandomState(2)
    q = rng.randn(3, 32, 5).astype(np.float32)
    db = rng.randn(3, 64, 5).astype(np.float32)
    got = nb.knn(torch.from_numpy(q), torch.from_numpy(db), K).numpy()
    pallas = knn_pallas(jnp.asarray(q), jnp.asarray(db), K,
                        select="two_pass", interpret=True)
    np.testing.assert_array_equal(got, np.asarray(pallas))


@pytest.mark.parametrize("kind", KINDS)
def test_gather_extrema_equals_xla_and_pallas(kind):
    xs = _clouds(kind)
    a = _values(xs)
    idx = np.array(jax_knn(jnp.asarray(xs), K))
    amax, amin = nb.gather_extrema(torch.from_numpy(idx), torch.from_numpy(a))
    g = np.asarray(jax_index_points(jnp.asarray(a), jnp.asarray(idx)))
    np.testing.assert_array_equal(amax.numpy(), g.max(axis=2))
    np.testing.assert_array_equal(amin.numpy(), g.min(axis=2))
    pmax, pmin = pallas_gather(jnp.asarray(idx), jnp.asarray(a), parts=2,
                               interpret=True)
    np.testing.assert_allclose(amax.numpy(), np.asarray(pmax), atol=PALLAS_ATOL)
    np.testing.assert_allclose(amin.numpy(), np.asarray(pmin), atol=PALLAS_ATOL)


@pytest.mark.parametrize("kind", KINDS)
def test_knn_gather_extrema_equals_xla_and_pallas(kind):
    xs = _clouds(kind)
    a = _values(xs)
    amax, amin = nb.knn_gather_extrema(torch.from_numpy(xs),
                                       torch.from_numpy(a), K)
    g = np.asarray(jax_index_points(jnp.asarray(a),
                                    jax_knn(jnp.asarray(xs), K)))
    np.testing.assert_array_equal(amax.numpy(), g.max(axis=2))
    np.testing.assert_array_equal(amin.numpy(), g.min(axis=2))
    pmax, pmin = pallas_kge(jnp.asarray(xs), jnp.asarray(a), K, parts=2,
                            select="two_pass", interpret=True)
    np.testing.assert_allclose(amax.numpy(), np.asarray(pmax), atol=PALLAS_ATOL)
    np.testing.assert_allclose(amin.numpy(), np.asarray(pmin), atol=PALLAS_ATOL)


def test_cpu_tensors_take_the_plain_versions_without_counting():
    xs = torch.from_numpy(_clouds("random"))
    a = torch.from_numpy(_values(xs.numpy()))
    launch.reset_launches()
    idx = nb.knn(xs, xs, K)
    assert torch.equal(idx, nb.knn_plain(xs, xs, K))
    for got, want in zip(nb.gather_extrema(idx, a),
                         nb.gather_extrema_plain(idx, a)):
        assert torch.equal(got, want)
    for got, want in zip(nb.knn_gather_extrema(xs, a, K),
                         nb.knn_gather_extrema_plain(xs, a, K)):
        assert torch.equal(got, want)
    assert launch.launches("knn", "gather_extrema", "knn_gather_extrema") == {
        "knn": 0, "gather_extrema": 0, "knn_gather_extrema": 0}


@pytest.mark.parametrize("call", ["knn", "gather_extrema",
                                  "knn_gather_extrema"])
def test_non_cpu_tensors_never_reach_a_plain_version(call):
    """A tensor off the CPU goes to the kernel or raises; here a meta
    tensor (neither CPU nor CUDA) must raise, not compute."""
    xs = torch.empty((2, 16, 3), device="meta")
    a = torch.empty((2, 16, 4), device="meta")
    idx = torch.empty((2, 16, 3), dtype=torch.int32, device="meta")
    args = {"knn": (xs, xs, 3), "gather_extrema": (idx, a),
            "knn_gather_extrema": (xs, a, 3)}[call]
    with pytest.raises(ValueError):
        getattr(nb, call)(*args)
