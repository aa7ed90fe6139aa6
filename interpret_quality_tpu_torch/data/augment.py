"""Host-side numpy training augmentations (the port's copy of
``interpret_quality_tpu/data/augment.py``).

Semantics follow reference final_data_train.py:48-139; all run on the host
with numpy's global RNG (the reference's seeding scheme), so both packages
draw the same augmentations after the same ``np.random.seed``.
"""
from __future__ import annotations

import numpy as np


def translate_pointcloud(pointcloud: np.ndarray) -> np.ndarray:
    """Anisotropic scale in [2/3, 3/2] plus shift in [-0.2, 0.2]."""
    xyz1 = np.random.uniform(low=2.0 / 3.0, high=3.0 / 2.0, size=[3])
    xyz2 = np.random.uniform(low=-0.2, high=0.2, size=[3])
    return (pointcloud * xyz1 + xyz2).astype("float32")


def jitter_pointcloud(pointcloud: np.ndarray, sigma=0.01, clip=0.02) -> np.ndarray:
    N, C = pointcloud.shape
    # float32, like the reference's in-place `+=`
    return (pointcloud
            + np.clip(sigma * np.random.randn(N, C), -clip, clip)
            ).astype(np.float32)


def scale_pointcloud(pointcloud: np.ndarray) -> np.ndarray:
    xyz1 = np.random.uniform(low=2.0 / 3.0, high=1.5, size=[3])
    return (pointcloud * xyz1).astype("float32")


def _rot(angles):
    rx, ry, rz = angles
    Rx = np.array([[1, 0, 0],
                   [0, np.cos(rx), -np.sin(rx)],
                   [0, np.sin(rx), np.cos(rx)]])
    Ry = np.array([[np.cos(ry), 0, np.sin(ry)],
                   [0, 1, 0],
                   [-np.sin(ry), 0, np.cos(ry)]])
    Rz = np.array([[np.cos(rz), -np.sin(rz), 0],
                   [np.sin(rz), np.cos(rz), 0],
                   [0, 0, 1]])
    return Rx, Ry, Rz


def rotate_perturbation_point_cloud(data: np.ndarray) -> np.ndarray:
    """Random full 3-axis rotation: x @ (Rz Ry Rx)."""
    angles = np.random.uniform(low=0, high=360, size=[3]) * np.pi / 180.0
    Rx, Ry, Rz = _rot(angles)
    R = Rz @ Ry @ Rx
    return (data @ R).astype(np.float32)


def rotate_point_cloud_z(data: np.ndarray) -> np.ndarray:
    angle = np.random.uniform(low=0, high=360) * np.pi / 180.0
    Rz = np.array([[np.cos(angle), -np.sin(angle), 0],
                   [np.sin(angle), np.cos(angle), 0],
                   [0, 0, 1]])
    return data @ Rz


def rotate_point_cloud_y(data: np.ndarray) -> np.ndarray:
    angle = np.random.uniform(low=0, high=360) * np.pi / 180.0
    Ry = np.array([[np.cos(angle), 0, np.sin(angle)],
                   [0, 1, 0],
                   [-np.sin(angle), 0, np.cos(angle)]])
    return data @ Ry


def random_dropout_pointcloud(pointcloud: np.ndarray) -> np.ndarray:
    """Randomly collapse up to 10% of points onto the first point."""
    N, _ = pointcloud.shape
    dropout_ratio = float(np.random.random() * 0.1)
    drop_idx = np.where(np.random.random(N) <= dropout_ratio)[0]
    pointcloud = pointcloud.copy()
    pointcloud[drop_idx, 0:3] = pointcloud[0, 0:3]
    return pointcloud
