"""Train state and optimizer (port of ``training/state.py``).

One Adam (or decoupled AdamW) over both networks' parameters, as in the
reference's single optimizer over depth and pose. The learning rate follows
the polynomial decay per update, evaluated like ``optax.polynomial_schedule``
at the update count before the increment. Gradient clipping by the global
norm, where asked for, runs before the update as ``optax.clip_by_global_norm``
does. The optimizer is ``torch.optim``: the JAX package has no kernel of its
own there.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
import torch.nn as nn

from deep_visual_slam_torch.models import DepthNet, PoseNet


def polynomial_lr(
    init_lr: float, total_steps: int, power: float = 0.9, end_lr: float = 0.0
) -> Callable[[int], float]:
    """``lr(t) = (init - end) * (1 - min(t, T)/T)^power + end``; constant
    ``init_lr`` when ``total_steps <= 0`` (optax's rule)."""

    def schedule(step: int) -> float:
        if total_steps <= 0:
            return init_lr
        frac = 1.0 - min(max(step, 0), total_steps) / total_steps
        return (init_lr - end_lr) * frac**power + end_lr

    return schedule


def make_optimizer(
    params, init_lr: float, beta1: float = 0.9, weight_decay: float = 0.0
) -> torch.optim.Optimizer:
    """Adam with betas (beta1, 0.999), or AdamW when ``weight_decay > 0``
    (decay decoupled and scaled by the learning rate, as ``optax.adamw``)."""
    if weight_decay > 0:
        return torch.optim.AdamW(
            params, lr=init_lr, betas=(beta1, 0.999), eps=1e-8,
            weight_decay=weight_decay,
        )
    return torch.optim.Adam(params, lr=init_lr, betas=(beta1, 0.999), eps=1e-8)


@dataclass
class TrainState:
    """The two networks, their one optimizer, the schedule and the count of
    updates applied (``step``)."""

    depth_model: nn.Module
    pose_model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    max_grad_norm: float | None = None
    step: int = 0

    @classmethod
    def create(
        cls,
        depth_model: nn.Module,
        pose_model: nn.Module,
        init_lr: float,
        total_steps: int,
        beta1: float = 0.9,
        weight_decay: float = 0.0,
        power: float = 0.9,
        end_lr: float = 0.0,
        max_grad_norm: float | None = None,
    ) -> "TrainState":
        params = [*depth_model.parameters(), *pose_model.parameters()]
        return cls(
            depth_model,
            pose_model,
            make_optimizer(params, init_lr, beta1, weight_decay),
            polynomial_lr(init_lr, total_steps, power, end_lr),
            max_grad_norm,
        )

    def apply_gradients(self) -> torch.Tensor:
        """One update from the ``.grad`` of every parameter, a parameter with
        none taking a zero gradient (as JAX differentiates every leaf, so Adam
        moves it along its old momentum). Returns the global gradient norm
        before clipping."""
        params = [p for group in self.optimizer.param_groups for p in group["params"]]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        norm = torch.nn.utils.get_total_norm([p.grad for p in params])
        if self.max_grad_norm is not None:
            scale = torch.where(
                norm < self.max_grad_norm, 1.0, self.max_grad_norm / norm
            )
            for p in params:
                p.grad.mul_(scale)
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1
        return norm


def init_vo_models(
    seed: int, predict_uncertainty: bool = False
) -> tuple[DepthNet, PoseNet]:
    """ResNet-18 DepthNet and PoseNet with weights drawn from one generator
    seeded with ``seed`` (on the CPU; the steps move them to their device)."""
    g = torch.Generator().manual_seed(seed)
    return (
        DepthNet(predict_uncertainty=predict_uncertainty, generator=g),
        PoseNet(generator=g),
    )
