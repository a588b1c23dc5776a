"""SE(3) / SO(3) utilities on tensors (port of ``ops/se3.py``).

All functions broadcast over leading batch dimensions and compute in fp32.
"""

from __future__ import annotations

import torch

_EPS = 1e-7


def _safe_norm(vec: torch.Tensor) -> torch.Tensor:
    """||vec|| with a finite derivative at zero."""
    return torch.sqrt(torch.sum(vec * vec, dim=-1, keepdim=True) + 1e-24)


def _eye(n: int, batch, like: torch.Tensor) -> torch.Tensor:
    eye = torch.eye(n, dtype=torch.float32, device=like.device)
    return eye.expand(*batch, n, n).clone()


def rotation_from_axisangle(vec: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula: axis-angle [..., 3] -> rotation [..., 3, 3],
    with the reference's ``angle + 1e-7`` axis normalization."""
    vec = vec.float()
    angle = _safe_norm(vec)  # [..., 1]
    axis = vec / (angle + _EPS)

    ca = torch.cos(angle)[..., None]  # [..., 1, 1]
    sa = torch.sin(angle)[..., None]
    C = 1.0 - ca

    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    zeros = torch.zeros_like(x)
    K = torch.stack(
        [
            torch.stack([zeros, -z, y], dim=-1),
            torch.stack([z, zeros, -x], dim=-1),
            torch.stack([-y, x, zeros], dim=-1),
        ],
        dim=-2,
    )
    eye = torch.eye(3, dtype=torch.float32, device=vec.device)
    outer = axis[..., :, None] * axis[..., None, :]
    return ca * eye + sa * K + C * outer


def translation_matrix(t: torch.Tensor) -> torch.Tensor:
    """Translation [..., 3] -> homogeneous 4x4 [..., 4, 4]."""
    t = t.float()
    T = _eye(4, t.shape[:-1], t)
    T[..., :3, 3] = t
    return T


def transformation_from_parameters(
    axisangle: torch.Tensor, translation: torch.Tensor, invert: bool = False
) -> torch.Tensor:
    """(axisangle, translation) [..., 3] -> 4x4 camera-to-camera transform:
    ``T(t) @ R``, or ``R^T @ T(-t)`` with ``invert=True``."""
    R3 = rotation_from_axisangle(axisangle)
    t = translation.float()
    if invert:
        R3 = R3.transpose(-1, -2)
        t = -t
    R = _eye(4, R3.shape[:-2], R3)
    R[..., :3, :3] = R3
    T = translation_matrix(t)
    if invert:
        return R @ T
    return T @ R


def invert_se3(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a rigid transform [..., 4, 4]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3:]
    Rt = R.transpose(-1, -2)
    out = torch.eye(4, dtype=T.dtype, device=T.device).expand(T.shape).clone()
    out[..., :3, :3] = Rt
    out[..., :3, 3:] = -(Rt @ t)
    return out
