"""Supervised metric-depth training loop (port of
``training/depth_trainer.py``).

Epochs over the depth loader with Adam (beta1 from the config, decoupled
weight decay) under a polynomial decay (power 0.9) over every update;
validation through the eval step and :class:`DepthMetrics`; a checkpoint
(``utils/checkpoint.py``, the network and the optimizer) at the end of every
``save_freq``-th epoch, from which a new ``Trainer`` on the same directory
resumes at the next epoch.

One process on one device (``device=None`` -> CUDA), or, under a process
group (``torchrun --nproc_per_node N -m deep_visual_slam_torch.train_depth``),
one rank per card as the JAX trainer's mesh (``use_mesh``): each rank loads
its rows of every global batch, the steps run DepthNet under DDP and take
SILog over the global batch (``training/steps.py``), the depth metrics are
summed over the ranks, and rank 0 alone logs and writes the checkpoints,
which every rank resumes from.
"""

from __future__ import annotations

import os
from typing import Dict

import torch

from deep_visual_slam_torch import resolve_device
from deep_visual_slam_torch.data.loader import device_prefetch
from deep_visual_slam_torch.data.nyu import DepthLoader
from deep_visual_slam_torch.eval.metrics import DepthMetrics
from deep_visual_slam_torch.parallel.mesh import trainer_mesh, world_and_rank
from deep_visual_slam_torch.training.depth_learner import DepthLossConfig
from deep_visual_slam_torch.training.state import TrainState, init_depth_model
from deep_visual_slam_torch.training.steps import make_depth_eval_step, make_depth_train_step
from deep_visual_slam_torch.utils.checkpoint import CheckpointManager
from deep_visual_slam_torch.utils.config import experiment_name
from deep_visual_slam_torch.utils.logging import MetricsWriter, StepTimer
from deep_visual_slam_torch.utils.pretrained import apply_depth_pretrained

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class Trainer:
    """The supervised-depth trainer over ``config`` (the JAX package's
    schema, ``configs/depth.yaml``).

    ``data_loader`` (a :class:`DepthLoader`) replaces the one the config's
    sources would give. Logs go to ``<log_dir>/depth_<experiment_name>``,
    checkpoints to ``<weights>/depth_<experiment_name>/``; the newest
    checkpoint there is restored at construction. ``use_mesh`` (the JAX
    trainer's) trains over the process group where there is one;
    ``Experiment.num_devices``, where set, must equal the world size.
    """

    def __init__(
        self,
        config: Dict,
        device=None,
        data_loader: DepthLoader | None = None,
        use_mesh: bool = True,
    ):
        self.device = resolve_device(device)
        self.mesh = trainer_mesh(self.device, config["Experiment"].get("num_devices"), use_mesh)
        if self.mesh is not None:
            self.device = self.mesh.device
        self.chief = world_and_rank()[1] == 0
        self.config = config
        t = config["Train"]
        self.epochs = t["epoch"]
        self.valid_freq = t.get("valid_freq", 2)
        self.save_freq = t.get("save_freq", 1)
        self.batch_size = t["batch_size"]
        dtype = _DTYPES[t.get("compute_dtype", "bfloat16")]
        self.loss_cfg = DepthLossConfig.from_config(config)

        self.data_loader = data_loader if data_loader is not None else DepthLoader(config)
        self.steps_per_epoch = max(len(self.data_loader.train_loader), 1)

        depth = init_depth_model(t.get("seed", 42))
        for msg in apply_depth_pretrained(depth, config):
            self._print(msg)
        self.state = TrainState.create(
            depth, None, t["init_lr"], self.epochs * self.steps_per_epoch,
            beta1=t.get("beta1", 0.9), weight_decay=t.get("weight_decay", 0.0), power=0.9,
        )
        self.train_step = make_depth_train_step(
            depth, self.loss_cfg, dtype, self.device, mesh=self.mesh
        )
        self.eval_step = make_depth_eval_step(
            depth, self.loss_cfg, dtype, self.device, mesh=self.mesh
        )

        exp = "depth_" + experiment_name(config)
        self.writer = MetricsWriter(
            os.path.join(config["Directory"]["log_dir"], exp) if self.chief else None
        )
        self.ckpt = CheckpointManager(os.path.join(config["Directory"]["weights"], exp))
        self.start_epoch = 1
        self.state, meta, step = self.ckpt.restore_latest(self.state)
        if step is not None:
            self.start_epoch = meta.get("epoch", 0) + 1
            self._print(f"Resumed from checkpoint step {step}")
        self.metrics = DepthMetrics(self.loss_cfg.min_depth, self.loss_cfg.max_depth)
        self.timer = StepTimer()

    def _print(self, msg: str) -> None:
        if self.chief:
            print(msg)

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        """One epoch; returns its mean of each loss. The sums stay on the
        device; the losses are read back at the first step and every tenth,
        and the step timer marks each readback and the epoch's end."""
        self.state.depth_model.train()
        self.timer.restart()
        loader = self.data_loader.train_loader
        loader.set_epoch(epoch)
        sums: Dict[str, torch.Tensor] = {}
        count = 0
        for batch in device_prefetch(loader, self.device):
            losses = self.train_step(self.state, batch)
            count += 1
            for k, v in losses.items():
                sums[k] = sums.get(k, 0.0) + v
            if count % 10 == 0 or count == 1:
                self.writer.scalars({k: v.item() for k, v in losses.items()},
                                    self.state.step, prefix="train/")
                self.timer.mark(count)
        means = {k: v.item() / count for k, v in sums.items()}
        self.timer.mark(count)
        self.writer.flush()
        return means

    def validate(self, epoch: int) -> Dict[str, float]:
        """The eval step over the valid loader: the mean loss and the depth
        metrics of the predicted depth at scale 0, read back once."""
        self.state.depth_model.eval()
        self.metrics.reset()
        loss_sum, count = 0.0, 0
        for batch in device_prefetch(self.data_loader.valid_loader, self.device):
            losses, pred_depth = self.eval_step(batch)
            loss_sum = loss_sum + losses["loss"]
            self.metrics.update(pred_depth, batch["depth"], batch["valid_mask"])
            count += 1
        self.state.depth_model.train()
        if count == 0:
            return {}
        if self.mesh is not None:
            self.metrics.merge_ranks()
        out = {"valid/loss": loss_sum.item() / count}
        out.update({f"valid/{k}": v for k, v in self.metrics.result().items()})
        self.writer.scalars(out, self.state.step)
        self.writer.flush()
        return out

    def save_checkpoint(self, epoch: int) -> str | None:
        """The checkpoint's path; under a mesh rank 0 writes it and the
        others return ``None``."""
        if not self.chief:
            return None
        return self.ckpt.save(self.state.step, self.state, metadata={"epoch": epoch})

    def train(self) -> None:
        for epoch in range(self.start_epoch, self.epochs + 1):
            m = self.train_epoch(epoch)
            self._print(f"epoch {epoch}/{self.epochs}: loss={m.get('loss', float('nan')):.4f} "
                        f"({self.timer.throughput(self.batch_size):.1f} images/s)")
            if epoch % self.valid_freq == 0:
                self.validate(epoch)
            if epoch % self.save_freq == 0:
                self.save_checkpoint(epoch)
        self.writer.close()
        self.ckpt.close()
