"""The benchmark's own input generators, frozen here so that a change to the
port cannot move the yardstick.  Each is a copy of the generator the port's
pipeline uses, named beside it; all draw from a ``numpy.random.RandomState``
the caller seeds, never from a global stream.

  * ``synthetic_cloud``: ``data/datasets.SyntheticClouds._load`` (its ten
    parametric surface families, morph, warp, stretch, noise, outliers);
  * ``fps_np`` and ``region_ids``: ``data/datasets.farthest_point_sample_np``
    and the nearest-centre rule of ``attrib/shapley.region_id_from_fps``
    (here in float64 on the host);
  * ``orders``: ``attrib/shapley.generate_all_orders``;
  * ``trans_grid``: ``attrib/perturbations.generate_trans_vector``;
  * ``random_pairs`` and ``contexts``: ``attrib/interactions.gen_pair_random``
    and ``gen_context`` (the draws vectorised: a uniform subset of the
    other regions per context; the 13 ratios are in the traffic file);
"""
from __future__ import annotations

import itertools
import math
from typing import List, Optional, Tuple

import numpy as np

MORPH_ALPHA_MAX = 0.45


def child_seeds(seed: int, n: int) -> List[int]:
    """``n`` independent 32-bit seeds from one seed of any size."""
    return [int(s) for s in
            np.random.SeedSequence(int(seed)).generate_state(n, np.uint32)]


def _shape(kind: int, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    theta, phi = u * np.pi, v * 2 * np.pi
    k = kind % 10
    if k == 0:              # lobed sphere
        r = 1.0 + 0.1 * np.sin(5 * phi)
        return np.stack([r * np.sin(theta) * np.cos(phi),
                         r * np.sin(theta) * np.sin(phi), r * np.cos(theta)], -1)
    if k == 1:              # box surface
        return np.stack([u * 2 - 1, v * 2 - 1, np.sign(u * v - 0.25)], -1)
    if k == 2:              # cylinder
        return np.stack([np.cos(phi), np.sin(phi), u * 2 - 1], -1)
    if k == 3:              # torus
        r0, r1 = 1.0, 0.35
        return np.stack([(r0 + r1 * np.cos(theta * 2)) * np.cos(phi),
                         (r0 + r1 * np.cos(theta * 2)) * np.sin(phi),
                         r1 * np.sin(theta * 2)], -1)
    if k == 4:              # cone
        return np.stack([u * np.cos(phi), u * np.sin(phi), 1 - u * 2], -1)
    if k == 5:              # flat ellipsoid
        return np.stack([np.sin(theta) * np.cos(phi),
                         0.6 * np.sin(theta) * np.sin(phi),
                         0.25 * np.cos(theta)], -1)
    if k == 6:              # helix tube
        t = u * 4 * np.pi
        return np.stack([np.cos(t) + 0.2 * np.cos(phi),
                         np.sin(t) + 0.2 * np.sin(phi),
                         (t / (2 * np.pi) - 1) * 0.8], -1)
    if k == 7:              # two-sphere dumbbell
        s = np.where(v < 0.5, 1.0, -1.0)
        return np.stack([0.5 * np.sin(theta) * np.cos(4 * phi),
                         0.5 * np.sin(theta) * np.sin(4 * phi),
                         0.5 * np.cos(theta) + s * 0.7], -1)
    if k == 8:              # rippled plane
        return np.stack([u * 2 - 1, v * 2 - 1,
                         0.3 * np.sin(3 * np.pi * u) * np.cos(3 * np.pi * v)], -1)
    w = np.stack([u * 2 - 1, (v * 2 - 1) * 0.25,       # cross of two slabs
                  np.sign(u - 0.5) * (v * 0.5 + 0.2)], -1)
    swap = (np.arange(len(u)) % 2).astype(bool)
    w[swap] = w[swap][:, [1, 0, 2]]
    return w


def synthetic_cloud(rng: np.random.RandomState, num_points: int,
                    num_classes: int = 10,
                    label: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """A surface cloud (num_points, 3) float32 in the unit sphere, centred,
    and its class (drawn, or ``label``): the class's base shape, a morph
    toward another class, a smooth warp, an anisotropic stretch, noise and
    outliers."""
    drawn = int(rng.randint(num_classes))
    label = drawn if label is None else label
    u, v = rng.rand(num_points), rng.rand(num_points)
    pc = _shape(label, u, v).astype(np.float32)
    other = int(rng.randint(num_classes))
    alpha = float(rng.uniform(0.0, MORPH_ALPHA_MAX))
    if other != label:
        pc = (1.0 - alpha) * pc + alpha * _shape(other, u, v).astype(np.float32)
    d1 = rng.randn(3).astype(np.float32)
    d1 /= np.linalg.norm(d1)
    d2 = rng.randn(3).astype(np.float32)
    d2 /= np.linalg.norm(d2)
    amp, freq = rng.uniform(0.03, 0.12), rng.uniform(1.5, 4.0)
    phase = rng.uniform(0, 2 * np.pi)
    pc = pc + (amp * np.sin(freq * (pc @ d1) + phase))[:, None] * d2[None]
    pc = pc * rng.uniform(0.8, 1.25, size=(1, 3)).astype(np.float32)
    pc += rng.uniform(0.01, 0.03) * rng.randn(num_points, 3)
    n_out = num_points // 64
    if n_out:
        out_idx = rng.choice(num_points, n_out, replace=False)
        pc[out_idx] = rng.uniform(-1, 1, size=(n_out, 3))
    pc -= pc.mean(axis=0, keepdims=True)
    pc /= np.max(np.sqrt((pc ** 2).sum(-1)))
    return pc.astype(np.float32), label


def fps_np(points: np.ndarray, npoint: int) -> np.ndarray:
    """Farthest-point sampling with the first point fixed at 0."""
    xyz = points[:, :3].astype(np.float64)
    centroids = np.zeros((npoint,), dtype=np.int64)
    distance = np.full((xyz.shape[0],), 1e10)
    farthest = 0
    for i in range(npoint):
        centroids[i] = farthest
        distance = np.minimum(distance, np.sum((xyz - xyz[farthest]) ** 2, -1))
        farthest = int(np.argmax(distance))
    return centroids


def region_ids(points: np.ndarray, centres: np.ndarray) -> np.ndarray:
    """Each point's nearest centre (ties to the lowest centre), int64."""
    xyz = points.astype(np.float64)
    d2 = ((xyz[:, None, :] - xyz[centres][None, :, :]) ** 2).sum(-1)
    return np.argmin(d2, axis=1).astype(np.int64)


def orders(rng: np.random.RandomState, n: int, num_regions: int) -> np.ndarray:
    """``n`` random permutations of the regions, (n, R) int64."""
    return np.stack([rng.permutation(num_regions) for _ in range(n)])


def trans_grid(threshold: float = 0.5, num_grid: int = 6) -> np.ndarray:
    """The 6^3 translation grid in [-0.5, 0.5]^3 clipped to the ball of 0.5,
    (216, 3) float32."""
    g = np.linspace(-threshold, threshold, num_grid)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    vecs = np.stack([X.ravel(), Y.ravel(), Z.ravel()], -1).astype(np.float32)
    norms = np.linalg.norm(vecs, axis=-1, keepdims=True)
    vecs = np.where(norms > threshold,
                    vecs / np.maximum(norms, 1e-12) * threshold, vecs)
    return vecs.astype(np.float32)


def random_pairs(rng: np.random.RandomState, num_regions: int,
                 num_pairs: int) -> np.ndarray:
    """Distinct region pairs (i, j), i < j, drawn without replacement."""
    all_pairs = np.array([[i, j] for i in range(num_regions)
                          for j in range(i + 1, num_regions)])
    return all_pairs[rng.choice(len(all_pairs), num_pairs, replace=False)]


def contexts(rng: np.random.RandomState, pairs: np.ndarray, num_regions: int,
             ratio: float, max_contexts: int) -> np.ndarray:
    """Contexts S of the other regions, |S| = floor((R - 2) * ratio), per
    pair: every subset where there are at most ``max_contexts``, else that
    many uniform draws.  (P, C, m) int64."""
    m = int((num_regions - 2) * ratio)
    P = len(pairs)
    others = np.stack([[r for r in range(num_regions) if r not in (i, j)]
                       for i, j in pairs])                     # (P, R - 2)
    if math.comb(num_regions - 2, m) <= max_contexts:
        combos = list(itertools.combinations(range(num_regions - 2), m))
        combos = np.array(combos, np.int64).reshape(len(combos), m)
        return others[:, combos]                                # (P, C, m)
    draws = np.argsort(rng.rand(P, max_contexts, num_regions - 2), -1)[..., :m]
    return np.take_along_axis(others[:, None, :].repeat(max_contexts, 1),
                              draws, -1)

