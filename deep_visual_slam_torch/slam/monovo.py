"""DepthNet + PoseNet inference for the SLAM loop (port of
``slam/monovo.py:Networks``).

``step`` runs the two networks with their own stems; the JAX package merges
the two stems into one ``[7, 7, 6, 128]`` conv (``models/fused_vo.py``) to
save a TPU dispatch, which computes the same function.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from deep_visual_slam_torch import resolve_device
from deep_visual_slam_torch.models import DepthNet, PoseNet
from deep_visual_slam_torch.ops import disp_to_depth, transformation_from_parameters


def _f01(img: torch.Tensor) -> torch.Tensor:
    """uint8 -> [0, 1] fp32 on the device (the low-H2D ingest path); float
    images pass through."""
    if img.dtype == torch.uint8:
        return img.float() / 255.0
    return img


class Networks:
    """DepthNet + PoseNet inference at B=1 for the SLAM loop.

    ``depth_state``/``pose_state`` are the networks' ``state_dict``s
    (``utils/weights.py`` carries JAX variables across); ``None`` draws
    random weights from a ``torch.Generator`` seeded with ``seed``. The
    networks run under ``torch.autocast`` in ``dtype`` unless it is fp32.

    With ``predict_uncertainty`` the DepthNet sigma head feeds the BA Eq.13
    weights through ``unc = unc_weight_scale * max(sigma^2 -
    unc_sigma_floor^2, 0)``: pixels at or below the noise floor get unc = 0.
    """

    def __init__(
        self,
        depth_state: Optional[Dict[str, torch.Tensor]] = None,
        pose_state: Optional[Dict[str, torch.Tensor]] = None,
        min_depth: float = 0.1,
        max_depth: float = 10.0,
        dtype: torch.dtype = torch.bfloat16,
        seed: int = 0,
        predict_uncertainty: bool = False,
        unc_sigma_floor: float = 0.1,
        unc_weight_scale: float = 100.0,
        device=None,
    ):
        self.device = resolve_device(device)
        self.predict_uncertainty = predict_uncertainty
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.dtype = dtype
        self._unc_floor2 = float(unc_sigma_floor) ** 2
        self._unc_scale = float(unc_weight_scale)
        generator = torch.Generator().manual_seed(seed)
        self.depth_model = DepthNet(
            predict_uncertainty=predict_uncertainty, generator=generator
        )
        self.pose_model = PoseNet(generator=generator)
        if depth_state is not None:
            self.depth_model.load_state_dict(depth_state)
        if pose_state is not None:
            self.pose_model.load_state_dict(pose_state)
        self.depth_model.to(self.device).eval()
        self.pose_model.to(self.device).eval()

    def _autocast(self):
        return torch.autocast(
            self.device.type, self.dtype, enabled=self.dtype != torch.float32
        )

    def _sigma_to_unc(self, disps) -> Optional[torch.Tensor]:
        """Head sigma map -> BA uncertainty (None when the head is off)."""
        if not self.predict_uncertainty:
            return None
        sigma = disps[("unc", 0)][..., 0]
        return self._unc_scale * torch.clamp(sigma * sigma - self._unc_floor2, min=0.0)

    def _depth(self, img: torch.Tensor):
        with self._autocast():
            disps = self.depth_model(_f01(img))
        _, depth = disp_to_depth(disps[("disp", 0)], self.min_depth, self.max_depth)
        return depth[..., 0], self._sigma_to_unc(disps)

    def _pose(self, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        pair = torch.cat([_f01(img1), _f01(img2)], dim=-1)
        with self._autocast():
            aa, t = self.pose_model(pair)
        return transformation_from_parameters(aa[:, 0, 0], t[:, 0, 0])

    @torch.inference_mode()
    def depth(self, image) -> np.ndarray:
        """[H, W, 3] float-or-uint8 image -> [H, W] metric depth."""
        d, _ = self._depth(self.to_device(image))
        return d[0].float().cpu().numpy()

    @torch.inference_mode()
    def depth_unc(self, image):
        """([H, W] metric depth, [H, W] BA uncertainty or None)."""
        d, u = self._depth(self.to_device(image))
        return (
            d[0].float().cpu().numpy(),
            None if u is None else u[0].float().cpu().numpy(),
        )

    @torch.inference_mode()
    def pose(self, image1, image2) -> np.ndarray:
        """Relative transform prev->cur as a 4x4 (prev frame 1, cur frame 2)."""
        T = self._pose(self.to_device(image1), self.to_device(image2))
        return T[0].cpu().numpy().astype(np.float64)

    @torch.inference_mode()
    def step(self, prev_image, image):
        """Per-frame inference: ([H, W] depth of ``image``, 4x4 relative
        transform prev->cur)."""
        prev, cur = self.to_device(prev_image), self.to_device(image)
        depth, _ = self._depth(cur)
        T = self._pose(prev, cur)
        return depth[0].float().cpu().numpy(), T[0].cpu().numpy().astype(np.float64)

    def to_device(self, image) -> torch.Tensor:
        """[H, W, 3] numpy or tensor image -> [1, H, W, 3] on the device;
        uint8 stays uint8 on the wire and is scaled on the device."""
        if not torch.is_tensor(image):
            image = torch.from_numpy(np.ascontiguousarray(image))
        if image.dim() == 3:
            image = image[None]
        if image.dtype != torch.uint8:
            image = image.float()
        return image.to(self.device)
