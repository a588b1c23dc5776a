"""Self-supervised VO training loop (port of ``training/vo_trainer.py``).

Epochs over the mono loader with one Adam over both networks and a
polynomial decay (power 0.9) over every update, the interleaved stereo
updates included; a stereo batch follows each mono batch until the stereo
stream of the epoch runs out. Validation runs the eval step and scores the
predicted poses with ``EvalTrajectory``; checkpoints (``utils/checkpoint.py``)
are written at the end of every ``save_freq``-th epoch and, with
``Train.save_every_steps``, inside an epoch, from which a new ``Trainer`` on
the same directories resumes exactly: the loaders fast-forward past the
consumed batches and the generator that draws the jitter and the
auto-mask noise takes its saved state.

Single device (``device=None`` -> CUDA), no mesh. The JAX trainer's image
panel and trajectory plot (matplotlib) are not ported (ROADMAP.md §1,
item 7).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch

from deep_visual_slam_torch import resolve_device
from deep_visual_slam_torch.data.loader import VoDataLoader, device_prefetch
from deep_visual_slam_torch.eval.traj_eval import EvalTrajectory
from deep_visual_slam_torch.training.state import TrainState, init_vo_models
from deep_visual_slam_torch.training.steps import (
    make_stereo_train_step,
    make_vo_eval_step,
    make_vo_train_step,
)
from deep_visual_slam_torch.training.vo_learner import VOLossConfig
from deep_visual_slam_torch.utils.checkpoint import CheckpointManager
from deep_visual_slam_torch.utils.config import experiment_name
from deep_visual_slam_torch.utils.logging import MetricsWriter, StepTimer
from deep_visual_slam_torch.utils.pretrained import apply_vo_pretrained

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class Trainer:
    """The VO trainer over ``config`` (the JAX package's schema).

    ``data_root`` replaces ``Directory.data_dir`` for the sources under it.
    Logs go to ``<log_dir>/<experiment_name>/metrics.jsonl``, checkpoints to
    ``<weights>/<experiment_name>/``; the newest checkpoint there is restored
    at construction.
    """

    def __init__(self, config: Dict, data_root: Optional[str] = None, device=None):
        self.device = resolve_device(device)
        self.config = config
        t = config["Train"]
        self.epochs = t["epoch"]
        self.valid_freq = t.get("valid_freq", 2)
        self.save_freq = t.get("save_freq", 1)
        self.batch_size = t["batch_size"]
        self.save_every_steps = t.get("save_every_steps") or 0
        self.profile_dir = t.get("profile_dir")
        dtype = _DTYPES[t.get("compute_dtype", "bfloat16")]
        seed = t.get("seed", 42)
        self.loss_cfg = VOLossConfig.from_config(config)

        self.data_loader = VoDataLoader(config, root_dir=data_root)
        self.steps_per_epoch = max(len(self.data_loader.train_loader), 1)
        # Stereo batches are optimizer updates too (one per mono batch until
        # the stereo stream drains): the schedule counts them.
        stereo_loader = self.data_loader.train_stereo_loader
        stereo_per_epoch = min(len(stereo_loader), self.steps_per_epoch) if stereo_loader else 0
        self.total_updates = self.epochs * (self.steps_per_epoch + stereo_per_epoch)

        depth, pose = init_vo_models(seed, predict_uncertainty=self.loss_cfg.uncertainty)
        for msg in apply_vo_pretrained(depth, pose, config):
            print(msg)
        self.state = TrainState.create(
            depth, pose, t["init_lr"], self.total_updates, beta1=t.get("beta1", 0.9),
            weight_decay=0.0, power=0.9, end_lr=0.0,
        )
        self.train_step = make_vo_train_step(
            depth, pose, self.loss_cfg, dtype, remat=t.get("remat", False),
            device_augment=t.get("device_augment", False),
            accum_steps=int(t.get("accum_steps", 1)), device=self.device,
        )
        self.eval_step = make_vo_eval_step(depth, pose, self.loss_cfg, dtype, device=self.device)
        self.stereo_step = (
            make_stereo_train_step(depth, self.loss_cfg, dtype, device=self.device)
            if stereo_loader is not None else None
        )

        exp = experiment_name(config)
        self.writer = MetricsWriter(os.path.join(config["Directory"]["log_dir"], exp))
        self.ckpt = CheckpointManager(os.path.join(config["Directory"]["weights"], exp))
        self.eval_tool = EvalTrajectory()
        self.timer = StepTimer()
        # Draws the device jitter and the auto-mask tie-break noise.
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.start_epoch = 1
        self.resume_step_in_epoch = 0
        self.state, meta, step = self.ckpt.restore_latest(self.state)
        if step is not None:
            sie = int(meta.get("step_in_epoch", 0))
            if sie > 0:
                # Re-enter the interrupted epoch past the consumed batches.
                self.start_epoch = meta.get("epoch", 1)
                self.resume_step_in_epoch = sie
            else:
                self.start_epoch = meta.get("epoch", 0) + 1
            if "generator" in meta:
                self.generator.set_state(torch.tensor(meta["generator"], dtype=torch.uint8))
            print(f"Resumed from checkpoint step {step} (epoch {self.start_epoch}, "
                  f"step_in_epoch {sie})")
        self._mode(True)  # the eval step, made last, left the models in eval mode

    def _mode(self, train: bool) -> None:
        self.state.depth_model.train(train)
        self.state.pose_model.train(train)

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        """One epoch (or its rest, after a mid-epoch resume); returns the
        epoch's mean of each loss. The sums stay on the device; losses are
        read back at the first step and every tenth."""
        self._mode(True)
        loader = self.data_loader.train_loader
        loader.set_epoch(epoch)
        sums: Dict[str, torch.Tensor] = {}
        counts: Dict[str, int] = {}
        count = 0
        if self.resume_step_in_epoch and epoch == self.start_epoch:
            count = self.resume_step_in_epoch
            loader.skip_batches(count)
            self.resume_step_in_epoch = 0
        stereo_iter = None
        if self.stereo_step is not None:
            stereo_loader = self.data_loader.train_stereo_loader
            stereo_loader.set_epoch(epoch)
            if count:  # one stereo batch went with each consumed mono batch
                stereo_loader.skip_batches(count)
            stereo_iter = iter(device_prefetch(stereo_loader, self.device))
        profiler = None
        profile = self.profile_dir and epoch == self.start_epoch
        for batch in device_prefetch(loader, self.device):
            if profile and count == 2:
                profiler = _start_profiler(self.device)
            losses = self.train_step(self.state, batch, self.generator)
            if stereo_iter is not None:
                stereo_batch = next(stereo_iter, None)
                if stereo_batch is None:
                    stereo_iter = None
                else:
                    stereo_losses = self.stereo_step(self.state, stereo_batch, self.generator)
                    losses = dict(losses)
                    losses["stereo_loss"] = stereo_losses["loss"]
            if profiler is not None and count == 6:
                _stop_profiler(profiler, self.device, self.profile_dir)
                profiler = profile = None
            self.timer.tick()
            count += 1
            if self.save_every_steps and count % self.save_every_steps == 0:
                self.save_checkpoint(epoch, step_in_epoch=count)
            for k, v in losses.items():
                sums[k] = sums.get(k, 0.0) + v
                counts[k] = counts.get(k, 0) + 1
            if count % 10 == 0 or count == 1:
                step = self.state.step
                self.writer.scalars({k: v.item() for k, v in losses.items()}, step,
                                    prefix="train/")
                self.writer.scalar("train/frames_per_sec",
                                   self.timer.throughput(self.batch_size), step)
        if profiler is not None:
            _stop_profiler(profiler, self.device, self.profile_dir)
        self.writer.flush()
        return {k: v.item() / counts[k] for k, v in sums.items()}

    def validate(self, epoch: int) -> Dict[str, float]:
        """The eval step over the valid loader: mean losses and the
        trajectory metrics of the predicted target -> right poses."""
        self._mode(False)
        self.eval_tool.reset()
        agg: Dict[str, float] = {}
        count = 0
        for batch in device_prefetch(self.data_loader.valid_loader, self.device):
            outputs, losses = self.eval_step(batch, self.generator)
            for k, v in losses.items():
                agg[k] = agg.get(k, 0.0) + v.item()
            count += 1
            self.eval_tool.update_state(
                outputs["cam_T_cam_right"], batch.get("gt_pose_target_to_right")
            )
        if count == 0:
            return {}
        metrics = {f"valid/{k}": v / count for k, v in agg.items()}
        metrics.update({f"valid/{k}": v for k, v in self.eval_tool.metrics().items()})
        self.writer.scalars(metrics, self.state.step)
        self.writer.flush()
        return metrics

    def save_checkpoint(self, epoch: int, step_in_epoch: int = 0) -> str:
        """``step_in_epoch=0`` marks a completed epoch; above 0 a save inside
        it. Either carries the generator's state. Returns the file's path."""
        return self.ckpt.save(self.state.step, self.state, metadata={
            "epoch": epoch,
            "step_in_epoch": int(step_in_epoch),
            "generator": self.generator.get_state().tolist(),
        })

    def train(self) -> None:
        for epoch in range(self.start_epoch, self.epochs + 1):
            train_metrics = self.train_epoch(epoch)
            msg = ", ".join(
                f"{k}={v:.4f}" for k, v in sorted(train_metrics.items())
                if k in ("loss", "grad_norm")
            )
            print(f"epoch {epoch}/{self.epochs}: {msg} "
                  f"({self.timer.throughput(self.batch_size):.1f} frames/s)")
            if epoch % self.valid_freq == 0:
                val = self.validate(epoch)
                if "valid/loss" in val:
                    print(f"  valid loss={val['valid/loss']:.4f}")
            if epoch % self.save_freq == 0:
                self.save_checkpoint(epoch)
        self.writer.close()
        self.ckpt.close()


def _start_profiler(device: torch.device):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
    profiler.start()
    return profiler


def _stop_profiler(profiler, device: torch.device, profile_dir: str) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    profiler.stop()
    os.makedirs(profile_dir, exist_ok=True)
    profiler.export_chrome_trace(os.path.join(profile_dir, "train_steps.json"))
