"""Rigid-body and scale transforms of point clouds (counterpart of
``interpret_quality_tpu/ops/transforms.py``).  Every transform is built
from torch primitives, so autograd differentiates it in all its arguments
(the reference's rotation has a 115-line hand-written backward,
tools/final_util.py:287-401)."""
from __future__ import annotations

import torch


def translate_pc(data: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """Translate; data (..., N, 3), trans (3,) or broadcastable."""
    return data + trans


def scale_pc(data: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Uniform scale; data (..., N, 3), scale a scalar."""
    return data * scale


def rotation_matrix_xyz(angle_tuple: torch.Tensor) -> torch.Tensor:
    """R = Rx @ Ry @ Rz from Euler angles (theta_x, theta_y, theta_z)
    (reference final_rotate_center_enum_all.py:15-38)."""
    c = torch.cos(angle_tuple)
    s = torch.sin(angle_tuple)
    one = torch.ones_like(c[0])
    zero = torch.zeros_like(c[0])
    rx = torch.stack([one, zero, zero,
                      zero, c[0], -s[0],
                      zero, s[0], c[0]]).reshape(3, 3)
    ry = torch.stack([c[1], zero, s[1],
                      zero, one, zero,
                      -s[1], zero, c[1]]).reshape(3, 3)
    rz = torch.stack([c[2], -s[2], zero,
                      s[2], c[2], zero,
                      zero, zero, one]).reshape(3, 3)
    return rx @ ry @ rz


def rotate_xyz(x: torch.Tensor, angle_tuple: torch.Tensor) -> torch.Tensor:
    """Rotate a cloud by Euler angles: x @ R^T; x (..., N, 3), angles (3,)."""
    return torch.matmul(x, rotation_matrix_xyz(angle_tuple).T)


def rot_angle_axis(x: torch.Tensor, angle: torch.Tensor, theta: torch.Tensor,
                   phi: torch.Tensor) -> torch.Tensor:
    """Rotate each cloud by ``angle`` about the axis of spherical angles
    (theta, phi), v = (sin t cos p, sin t sin p, cos t): the Rodrigues
    matrix, term by term as the JAX package builds it.

    Args:
      x: (B, N, 3); angle, theta, phi: (B,).
    Returns:
      (B, N, 3) rotated clouds.
    """
    ca = torch.cos(angle)
    sa = torch.sin(angle)
    ax = torch.sin(theta) * torch.cos(phi)
    ay = torch.sin(theta) * torch.sin(phi)
    az = torch.cos(theta)
    one_m_ca = 1.0 - ca
    row0 = torch.stack([ca + ax * ax * one_m_ca,
                        ax * ay * one_m_ca - az * sa,
                        ax * az * one_m_ca + ay * sa], dim=-1)
    row1 = torch.stack([ax * ay * one_m_ca + az * sa,
                        ca + ay * ay * one_m_ca,
                        ay * az * one_m_ca - ax * sa], dim=-1)
    row2 = torch.stack([ax * az * one_m_ca - ay * sa,
                        ay * az * one_m_ca + ax * sa,
                        ca + az * az * one_m_ca], dim=-1)
    rot = torch.stack([row0, row1, row2], dim=-2)          # (B, 3, 3)
    return torch.einsum("bij,bnj->bni", rot, x)
