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


def _skew3(x, y, z) -> torch.Tensor:
    """Cross-product matrix [..., 3, 3] from its three components [...]."""
    zeros = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zeros, -z, y], dim=-1),
            torch.stack([z, zeros, -x], dim=-1),
            torch.stack([-y, x, zeros], dim=-1),
        ],
        dim=-2,
    )


def axisangle_from_rotation(R: torch.Tensor) -> torch.Tensor:
    """Log map SO(3): rotation [..., 3, 3] -> axis-angle [..., 3]; a
    first-order series below an angle of 1e-4, the cosine clipped to
    [-1 + 1e-6, 1 - 1e-6]."""
    R = R.float()
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_angle = torch.clamp((trace - 1.0) * 0.5, -1.0 + 1e-6, 1.0 - 1e-6)
    angle = torch.arccos(cos_angle)
    w = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    ) * 0.5
    sin_angle = torch.sin(angle)
    small = angle < 1e-4
    factor = torch.where(
        small, 1.0 + angle**2 / 6.0, angle / torch.where(small, 1.0, sin_angle)
    )
    return w * factor[..., None]


def _so3_left_jacobian(vec: torch.Tensor) -> torch.Tensor:
    """Left Jacobian J of SO(3); the se(3) exponential's translation is
    J @ rho. Series coefficients below an angle of 1e-4."""
    vec = vec.float()
    angle = _safe_norm(vec)[..., None]  # [..., 1, 1]
    K = _skew3(vec[..., 0], vec[..., 1], vec[..., 2])
    eye = torch.eye(3, dtype=torch.float32, device=vec.device)
    a2 = angle * angle
    small = angle < 1e-4
    safe = torch.where(small, 1.0, angle)
    c1 = torch.where(small, 0.5 - a2 / 24.0, (1.0 - torch.cos(safe)) / (safe * safe))
    c2 = torch.where(small, 1.0 / 6.0 - a2 / 120.0, (safe - torch.sin(safe)) / safe**3)
    return eye + c1 * K + c2 * (K @ K)


def _so3_exp_rotation(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues as ``I + A K + B K^2`` with ``A = sin(a)/a`` and
    ``B = (1 - cos a)/a^2`` (series below 1e-4): unlike
    :func:`rotation_from_axisangle` its derivative at phi = 0 is exactly
    the cross-product matrix, where the BA's retraction linearizes."""
    phi = phi.float()
    a2 = torch.sum(phi * phi, dim=-1)[..., None, None]
    a = torch.sqrt(a2)
    K = _skew3(phi[..., 0], phi[..., 1], phi[..., 2])
    small = a < 1e-4
    safe = torch.where(small, 1.0, a)
    A = torch.where(small, 1.0 - a2 / 6.0, torch.sin(safe) / safe)
    B = torch.where(small, 0.5 - a2 / 24.0, (1.0 - torch.cos(safe)) / (safe * safe))
    eye = torch.eye(3, dtype=torch.float32, device=phi.device)
    return eye + A * K + B * (K @ K)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Exponential map se(3) -> SE(3): ``xi = [rho, phi]`` [..., 6] ->
    [..., 4, 4]."""
    xi = xi.float()
    rho, phi = xi[..., :3], xi[..., 3:]
    R = _so3_exp_rotation(phi)
    t = (_so3_left_jacobian(phi) @ rho[..., None])[..., 0]
    T = _eye(4, xi.shape[:-1], xi)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    return T


def se3_inv(T: torch.Tensor) -> torch.Tensor:
    """Closed-form SE(3) inverse ``[R^T, -R^T t; 0, 1]`` of [..., 4, 4]."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    top = torch.cat([Rt, -(Rt @ T[..., :3, 3:])], dim=-1)
    # The eye's last row, made on the device: a tensor from a Python list
    # would be a host-to-device copy, which waits for the card.
    bottom = torch.eye(4, dtype=T.dtype, device=T.device)[3:]
    return torch.cat([top, bottom.expand(*T.shape[:-2], 1, 4)], dim=-2)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """Log map SE(3) -> se(3): [..., 4, 4] -> [..., 6] (rho first).

    The solve checks no errors (no device synchronisation); a singular
    Jacobian gives NaN, as JAX's solve does."""
    phi = axisangle_from_rotation(T[..., :3, :3])
    J = _so3_left_jacobian(phi)
    rho, info = torch.linalg.solve_ex(J, T[..., :3, 3:].float())
    rho = torch.where((info == 0)[..., None, None], rho, float("nan"))
    return torch.cat([rho[..., 0], phi], dim=-1)
