"""Self-supervised VO training: ``make_vo_train_step``'s step over DepthNet
and PoseNet at the configuration's loss settings, on (left, target, right)
snippet batches with the auto-mask tie-break noise handed in."""

from __future__ import annotations

from typing import Dict

import torch

from benchmark import inputs
from benchmark.training import TrainDriver


class Driver(TrainDriver):
    kind = "vo"

    def build_models(self):
        from deep_visual_slam_torch.models import DepthNet, PoseNet

        with torch.device("meta"):
            depth, pose = DepthNet(), PoseNet()
        return {"depth.": depth.to_empty(device=self.device),
                "pose.": pose.to_empty(device=self.device)}

    def build_step(self, mesh):
        from deep_visual_slam_torch.training import TrainState, VOLossConfig, make_vo_train_step

        loss = self.config["loss"]
        cfg = VOLossConfig(num_scales=loss["num_scales"], min_depth=loss["min_depth"],
                           max_depth=loss["max_depth"], ssim_ratio=loss["ssim_ratio"],
                           smoothness_ratio=loss["smoothness_ratio"],
                           auto_mask=loss["auto_mask"], uncertainty=False)
        state = TrainState.create(self.models["depth."], self.models["pose."],
                                  self.optim["lr"], total_steps=0, beta1=self.optim["beta1"],
                                  weight_decay=self.optim["weight_decay"])
        step = make_vo_train_step(self.models["depth."], self.models["pose."], cfg, self.dtype,
                                  device=self.device, mesh=mesh)
        return state, step

    def draw_entry(self, gen_batch, gen_noise, B: int) -> Dict:
        H, W = self.height, self.width
        return {"batch": inputs.vo_batch(gen_batch, B, H, W, self.device),
                "noise": inputs.vo_noise(gen_noise, B, H, W, self.config["loss"]["num_scales"],
                                         self.device)}

    def call_step(self, entry: Dict) -> Dict[str, torch.Tensor]:
        return self.train_step(self.state, entry["batch"], noise=entry["noise"])
