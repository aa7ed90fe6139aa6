"""Datasets: the deterministic 30-sample Shapley evaluation sets, the
training sets with their augmentations, and a synthetic set for runs
without the real data.  The port's copy of
``interpret_quality_tpu/data/datasets.py``, arithmetic for arithmetic, so
both packages read the same clouds from the same files and draw the same
ones from the same seeds.

The eval loaders follow reference final_data_shapley.py: ModelNet takes the
*first* ``num_points`` points of each .npy shape (:63); ShapeNet centres
and unit-sphere normalises each .pts cloud and resamples it by FPS with the
first point fixed (:71-92, 149-176).

Batching is plain numpy on the host (a cloud is 12 KB); the device takes
whole batches.
"""
from __future__ import annotations

import json
import os
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..config import (DATA_MODELNET_SHAPLEY_TEST, DATA_SHAPENET_SHAPLEY_TEST,
                      SHAPENET_CLASS, SHAPENET_ID2CAT)
from . import augment

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the static eval-sample lists ship inside the package (pyproject
# package-data), in the repo checkout and in installed wheels alike
MISC_DIR = os.path.join(_PKG_DIR, "misc")

MODELNET10_SHAPES = ["bathtub", "bed", "chair", "desk", "dresser",
                     "monitor", "night_stand", "sofa", "table", "toilet"]

# Synthetic-set distribution version: the cross-class morph strength cap
# (the same value as the JAX package's, so the distributions agree).
SYNTHETIC_MORPH_ALPHA_MAX = 0.45


def farthest_point_sample_np(point: np.ndarray, npoint: int) -> np.ndarray:
    """Numpy FPS with the first point fixed at 0 (reference
    final_data_shapley.py:71-92)."""
    N = point.shape[0]
    xyz = point[:, :3]
    centroids = np.zeros((npoint,), dtype=np.int64)
    distance = np.ones((N,)) * 1e10
    farthest = 0
    for i in range(npoint):
        centroids[i] = farthest
        dist = np.sum((xyz - xyz[farthest, :]) ** 2, -1)
        mask = dist < distance
        distance[mask] = dist[mask]
        farthest = int(np.argmax(distance, -1))
    return centroids


def _read_modelnet_names(misc_dir: str = MISC_DIR) -> List[str]:
    with open(os.path.join(misc_dir, DATA_MODELNET_SHAPLEY_TEST)) as f:
        return [line.rstrip() for line in f.readlines()]


def _read_shapenet_selected(misc_dir: str = MISC_DIR) -> List[Tuple[str, str]]:
    with open(os.path.join(misc_dir, DATA_SHAPENET_SHAPLEY_TEST)) as f:
        filelist = json.load(f)
    out = []
    for file in filelist:
        _, category, uuid = file.split("/")
        out.append((category, uuid))
    return out


def get_folder_name_list(dataset: str, misc_dir: str = MISC_DIR) -> List[str]:
    """Artifact folder names per eval sample (reference final_util.py:265-283)."""
    if dataset == "modelnet10":
        return _read_modelnet_names(misc_dir)
    elif dataset == "shapenet":
        return [SHAPENET_ID2CAT[cat] + "_" + uuid
                for cat, uuid in _read_shapenet_selected(misc_dir)]
    raise ValueError(f"dataset {dataset!r} does not exist")


def _unit_sphere_pts(path: str) -> np.ndarray:
    """A ShapeNet .pts cloud, centred and scaled into the unit sphere."""
    from . import native
    point_set = native.parse_pts(path).astype(np.float32)
    point_set = point_set - point_set.mean(axis=0, keepdims=True)
    dist = np.max(np.sqrt(np.sum(point_set ** 2, axis=1)))
    return point_set / dist


# ---------------------------------------------------------------------------
# Shapley evaluation sets (deterministic, 30 samples)
# ---------------------------------------------------------------------------
class ModelNetShapleyEval:
    """The 30 selected ModelNet10 training shapes, first `num_points` points."""

    def __init__(self, data_root: str = "./data", num_points: int = 1024,
                 misc_dir: str = MISC_DIR):
        self.data_dir = os.path.join(data_root, "modelnet10_numpy")
        self.num_points = num_points
        self.items = []
        for name in _read_modelnet_names(misc_dir):
            folder = name[0:-5]
            label = MODELNET10_SHAPES.index(folder)
            self.items.append((os.path.join(self.data_dir, folder, name + ".npy"),
                               label))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index) -> Tuple[np.ndarray, int]:
        path, label = self.items[index]
        data = np.load(path)
        return data[0:self.num_points, 0:3].astype(np.float32), label


class ShapeNetShapleyEval:
    """The 30 selected ShapeNet-Part shapes, centred, unit-sphere normalised
    and FPS-resampled to `num_points` points."""

    def __init__(self, data_root: str = "./data", num_points: int = 1024,
                 misc_dir: str = MISC_DIR,
                 class_choice: Sequence[str] = tuple(SHAPENET_CLASS)):
        self.root = os.path.join(data_root,
                                 "shapenetcore_partanno_segmentation_benchmark_v0")
        self.num_points = num_points
        classes = dict(zip(sorted(class_choice), range(len(class_choice))))
        self.items = []
        for cat_id, uuid in _read_shapenet_selected(misc_dir):
            cat_name = SHAPENET_ID2CAT[cat_id]
            if cat_name not in classes:
                continue
            self.items.append((os.path.join(self.root, cat_id, "points",
                                            uuid + ".pts"),
                               classes[cat_name]))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index) -> Tuple[np.ndarray, int]:
        from . import native
        path, label = self.items[index]
        point_set = _unit_sphere_pts(path)
        choice = native.fps(point_set, self.num_points)
        return point_set[choice, :].astype(np.float32), label


def make_eval_dataset(dataset: str, data_root: str = "./data",
                      num_points: int = 1024, misc_dir: str = MISC_DIR):
    if dataset == "modelnet10":
        return ModelNetShapleyEval(data_root, num_points, misc_dir)
    elif dataset == "shapenet":
        return ShapeNetShapleyEval(data_root, num_points, misc_dir)
    raise ValueError(f"dataset {dataset!r} does not exist")


# ---------------------------------------------------------------------------
# Training sets
# ---------------------------------------------------------------------------
class _TrainBase:
    """Shuffled mini-batch iterator over (cloud, label) items."""

    items: list
    num_points: int
    train: bool
    drop_point: bool = False
    rot_y: bool = False
    rot_all: bool = False

    def _load(self, index) -> Tuple[np.ndarray, int]:
        raise NotImplementedError

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index):
        pc, label = self._load(index)
        if self.train:
            pc = augment.translate_pointcloud(pc)
            if self.drop_point:
                pc = augment.random_dropout_pointcloud(pc)
            if self.rot_y:
                pc = augment.rotate_point_cloud_y(pc)
            if self.rot_all:
                pc = augment.rotate_perturbation_point_cloud(pc)
        return pc.astype(np.float32), label

    def batches(self, batch_size: int, shuffle: bool = True,
                rng: Optional[np.random.RandomState] = None,
                pad_last: bool = True
                ) -> Iterator[Tuple[np.ndarray, np.ndarray, int]]:
        """Yield (data, labels, valid_count).  The ragged tail batch is
        padded to `batch_size` by repeating its last item, so every step has
        the same shape; `valid_count` tells the consumer how many rows are
        real."""
        idx = np.arange(len(self))
        if shuffle:
            (rng if rng is not None else np.random).shuffle(idx)
        for i in range(0, len(idx), batch_size):
            chunk = idx[i:i + batch_size]
            valid = len(chunk)
            if pad_last and valid < batch_size:
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], batch_size - valid)])
            data = np.stack([self[j][0] for j in chunk])
            labels = np.array([self[j][1] for j in chunk], np.int32)
            yield data, labels, valid


class ModelNetTrain(_TrainBase):
    def __init__(self, data_root="./data", num_points=1024, partition="train",
                 drop_point=False, rot_y=False, rot_all=False):
        self.data_dir = os.path.join(data_root, "modelnet10_numpy")
        self.num_points = num_points
        self.train = partition == "train"
        self.drop_point, self.rot_y, self.rot_all = drop_point, rot_y, rot_all
        with open(os.path.join(self.data_dir, f"modelnet10_{partition}.txt")) as f:
            names = [line.rstrip() for line in f.readlines()]
        self.items = []
        for name in names:
            folder = name[0:-5]
            label = MODELNET10_SHAPES.index(folder)
            self.items.append((os.path.join(self.data_dir, folder, name + ".npy"),
                               label))

    def _load(self, index):
        path, label = self.items[index]
        data = np.load(path)
        sel = np.random.choice(data.shape[0], self.num_points, replace=False)
        return data[sel, 0:3].astype(np.float32), label


class ShapeNetTrain(_TrainBase):
    def __init__(self, data_root="./data", num_points=1024, split="train",
                 class_choice=tuple(SHAPENET_CLASS),
                 drop_point=False, rot_y=False, rot_all=False):
        self.root = os.path.join(data_root,
                                 "shapenetcore_partanno_segmentation_benchmark_v0")
        self.num_points = num_points
        self.train = split == "train"
        self.drop_point, self.rot_y, self.rot_all = drop_point, rot_y, rot_all
        classes = dict(zip(sorted(class_choice), range(len(class_choice))))
        splitfile = os.path.join(self.root, "train_test_split",
                                 f"shuffled_{split}_file_list.json")
        with open(splitfile) as f:
            filelist = json.load(f)
        self.items = []
        for file in filelist:
            _, cat, uuid = file.split("/")
            cat_name = SHAPENET_ID2CAT.get(cat)
            if cat_name in classes:
                self.items.append((os.path.join(self.root, cat, "points",
                                                uuid + ".pts"),
                                   classes[cat_name]))

    def _load(self, index):
        path, label = self.items[index]
        point_set = _unit_sphere_pts(path)
        choice = np.random.choice(point_set.shape[0], self.num_points,
                                  replace=True)
        return point_set[choice, :].astype(np.float32), label


# ---------------------------------------------------------------------------
# Synthetic set (tests and runs without the real datasets)
# ---------------------------------------------------------------------------
class SyntheticClouds(_TrainBase):
    """Deterministic parametric shapes (sphere/box/cylinder/... per class),
    unit-sphere normalised — lets every pipeline stage run end to end when
    the ModelNet/ShapeNet files are not on disk."""

    def __init__(self, num_samples=30, num_points=1024, num_classes=10,
                 seed=0, train=False, drop_point=False, rot_y=False,
                 rot_all=False):
        self.num_points = num_points
        self.train = train
        self.num_classes = num_classes
        self.drop_point, self.rot_y, self.rot_all = drop_point, rot_y, rot_all
        rng = np.random.RandomState(seed)
        self.items = [(i, int(rng.randint(num_classes)))
                      for i in range(num_samples)]
        self._seed = seed

    def _shape(self, kind: int, u: np.ndarray, v: np.ndarray) -> np.ndarray:
        """Ten geometrically distinct parametric families, one per class."""
        theta, phi = u * np.pi, v * 2 * np.pi
        k = kind % 10
        if k == 0:              # lobed sphere
            r = 1.0 + 0.1 * np.sin(5 * phi)
            return np.stack([r * np.sin(theta) * np.cos(phi),
                             r * np.sin(theta) * np.sin(phi),
                             r * np.cos(theta)], -1)
        if k == 1:              # box surface
            return np.stack([u * 2 - 1, v * 2 - 1,
                             np.sign(u * v - 0.25)], -1)
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
                             0.3 * np.sin(3 * np.pi * u) *
                             np.cos(3 * np.pi * v)], -1)
        # k == 9: orthogonal cross of two slabs
        w = np.stack([u * 2 - 1, (v * 2 - 1) * 0.25,
                      np.sign(u - 0.5) * (v * 0.5 + 0.2)], -1)
        swap = (np.arange(len(u)) % 2).astype(bool)
        w[swap] = w[swap][:, [1, 0, 2]]
        return w

    def _load(self, index) -> Tuple[np.ndarray, int]:
        """Deterministic per-index cloud: base shape, a morph toward another
        class, a smooth warp, an anisotropic stretch, noise and outliers."""
        idx, label = self.items[index]
        rng = np.random.RandomState(self._seed * 10007 + idx)
        u = rng.rand(self.num_points)
        v = rng.rand(self.num_points)
        pc = self._shape(label, u, v).astype(np.float32)
        other = int(rng.randint(self.num_classes))
        alpha = float(rng.uniform(0.0, SYNTHETIC_MORPH_ALPHA_MAX))
        if other != label:
            pc = ((1.0 - alpha) * pc
                  + alpha * self._shape(other, u, v).astype(np.float32))
        d1 = rng.randn(3).astype(np.float32)
        d1 /= np.linalg.norm(d1)
        d2 = rng.randn(3).astype(np.float32)
        d2 /= np.linalg.norm(d2)
        amp = rng.uniform(0.03, 0.12)
        freq = rng.uniform(1.5, 4.0)
        phase = rng.uniform(0, 2 * np.pi)
        pc = pc + (amp * np.sin(freq * (pc @ d1) + phase))[:, None] * d2[None]
        pc = pc * rng.uniform(0.8, 1.25, size=(1, 3)).astype(np.float32)
        pc += rng.uniform(0.01, 0.03) * rng.randn(self.num_points, 3)
        n_out = self.num_points // 64
        if n_out:
            out_idx = rng.choice(self.num_points, n_out, replace=False)
            pc[out_idx] = rng.uniform(-1, 1, size=(n_out, 3))
        pc -= pc.mean(axis=0, keepdims=True)
        pc /= np.max(np.sqrt((pc ** 2).sum(-1)))
        return pc.astype(np.float32), label
