"""Supervised metric-depth training: ``make_depth_train_step``'s step over
DepthNet (SILog plus smoothness) on batches of image, depth and valid mask."""

from __future__ import annotations

from typing import Dict

import torch

from benchmark import inputs
from benchmark.training import TrainDriver


class Driver(TrainDriver):
    def build_models(self):
        from deep_visual_slam_torch.models import DepthNet

        with torch.device("meta"):
            depth = DepthNet()
        return {"depth.": depth.to_empty(device=self.device)}

    def build_step(self, mesh):
        from deep_visual_slam_torch.training import (
            DepthLossConfig,
            TrainState,
            make_depth_train_step,
        )

        loss = self.config["loss"]
        cfg = DepthLossConfig(num_scales=loss["num_scales"], min_depth=loss["min_depth"],
                              max_depth=loss["max_depth"], alphas=tuple(loss["alphas"]),
                              smooth_weight=loss["smooth_weight"],
                              silog_weight=loss["silog_weight"],
                              variance_focus=loss["variance_focus"])
        state = TrainState.create(self.models["depth."], None, self.optim["lr"], total_steps=0,
                                  beta1=self.optim["beta1"],
                                  weight_decay=self.optim["weight_decay"])
        step = make_depth_train_step(self.models["depth."], cfg, self.dtype, device=self.device,
                                     mesh=mesh)
        return state, step

    def draw_entry(self, gen_batch, gen_noise, B: int) -> Dict:
        return {"batch": inputs.depth_batch(gen_batch, B, self.height, self.width, self.device),
                "noise": None}

    def call_step(self, entry: Dict) -> Dict[str, torch.Tensor]:
        return self.train_step(self.state, entry["batch"])
