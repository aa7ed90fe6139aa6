"""The port's ball query, kNN-of-queries and KDE density against the JAX
package's (``interpret_quality_tpu/ops/geometry.py:92-160``).

Indices exactly equal, on random clouds and on a masked-coalition batch
(whole regions collapsed onto the centre: exact ties everywhere); the
density within rtol 1e-5 (f32 exp and mean summed in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interpret_quality_tpu.ops import geometry as jgeo
from interpret_quality_tpu_torch.attrib.coalitions import (
    keep_matrix_from_orders, masked_coalitions)
from interpret_quality_tpu_torch.ops import geometry as tgeo


def _clouds(kind: str) -> np.ndarray:
    rng = np.random.RandomState({"random": 0, "masked": 1}[kind])
    if kind == "random":
        return (rng.rand(3, 96, 3) - 0.5).astype(np.float32)
    cloud = (rng.rand(96, 3) - 0.5).astype(np.float32)
    region_id = torch.from_numpy(rng.randint(0, 4, 96))
    orders = np.stack([rng.permutation(4) for _ in range(2)])
    keep = torch.from_numpy(keep_matrix_from_orders(orders))
    data = torch.from_numpy(cloud)
    return masked_coalitions(data, data.mean(0), keep, region_id).numpy()


KINDS = ["random", "masked"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("radius,nsample", [(0.1, 16), (0.2, 32), (0.4, 128),
                                            (1e-4, 8)])
def test_query_ball_point_equals_jax(kind, radius, nsample):
    """Includes nsample > N (the slots are cut to N, as the JAX sort-and-
    slice does) and a radius so small that balls hold their centre only, or
    nothing (index 0)."""
    xyz = _clouds(kind)
    centres = xyz[:, ::3] + np.float32(1e-3) * (kind == "random")
    got = tgeo.query_ball_point(radius, nsample, torch.from_numpy(xyz),
                                torch.from_numpy(centres)).numpy()
    want = np.asarray(jgeo.query_ball_point(radius, nsample, jnp.asarray(xyz),
                                            jnp.asarray(centres)))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", [8, 32])
def test_knn_point_equals_jax(kind, k):
    xyz = _clouds(kind)
    centres = xyz[:, 1::2]
    got = tgeo.knn_point(k, torch.from_numpy(xyz), torch.from_numpy(centres))
    want = jgeo.knn_point(k, jnp.asarray(xyz), jnp.asarray(centres))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("bandwidth", [0.1, 0.4])
def test_compute_density_equals_jax(kind, bandwidth, monkeypatch):
    xyz = _clouds(kind)
    want = np.asarray(jgeo.compute_density(jnp.asarray(xyz), bandwidth))
    got = tgeo.compute_density(torch.from_numpy(xyz), bandwidth).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # chunked over the clouds, each cloud's arithmetic is the same
    monkeypatch.setattr(tgeo, "DENSITY_CHUNK", 96 * 96)     # one cloud each
    chunked = tgeo.compute_density(torch.from_numpy(xyz), bandwidth)
    np.testing.assert_array_equal(chunked.numpy(), got)
