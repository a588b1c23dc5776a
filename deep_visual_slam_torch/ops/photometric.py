"""Photometric losses in NHWC (port of ``ops/photometric.py``).

``reprojection_loss`` is kernel K1's wrapper (``ops/photometric_cuda.py``):
the CUDA kernel on CUDA tensors, the plain version on CPU tensors.
"""

from __future__ import annotations

import torch

from deep_visual_slam_torch.ops.photometric_cuda import (  # noqa: F401
    reprojection_loss,
    reprojection_loss_plain,
    ssim,
)


def smooth_loss(disp: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    """Edge-aware first-order smoothness of disp [B, H, W, 1] against
    img [B, H, W, 3], scalar."""
    grad_disp_x = torch.abs(disp[:, :, :-1, :] - disp[:, :, 1:, :])
    grad_disp_y = torch.abs(disp[:, :-1, :, :] - disp[:, 1:, :, :])

    grad_img_x = torch.mean(
        torch.abs(img[:, :, :-1, :] - img[:, :, 1:, :]), dim=-1, keepdim=True
    )
    grad_img_y = torch.mean(
        torch.abs(img[:, :-1, :, :] - img[:, 1:, :, :]), dim=-1, keepdim=True
    )

    grad_disp_x = grad_disp_x * torch.exp(-grad_img_x)
    grad_disp_y = grad_disp_y * torch.exp(-grad_img_y)
    return torch.mean(grad_disp_x) + torch.mean(grad_disp_y)


def normalized_smooth_loss(disp: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    """Smoothness on ``disp / (max(mean(disp), 0.001) + 1e-7)``."""
    mean_disp = torch.mean(disp, dim=(1, 2), keepdim=True)
    mean_disp = torch.clamp(mean_disp, min=0.001)
    return smooth_loss(disp / (mean_disp + 1e-7), img)
