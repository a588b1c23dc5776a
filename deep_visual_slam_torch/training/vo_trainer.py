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

One process on one device (``device=None`` -> CUDA), or, under a process
group (``torchrun --nproc_per_node N -m deep_visual_slam_torch.train_vo``),
one rank per card, as the JAX trainer's mesh (``use_mesh``): each rank
loads its rows of every global batch, the steps run the networks under DDP
(``training/steps.py``) and return the global batch's losses, validation
gathers the predicted poses of all ranks, rank 0 alone logs and writes the
checkpoints, and every rank resumes from them.

Where the metrics writer takes images (tensorboardX imported), each
validation also logs the first batch's panel [target | warped left | warped
right | disparity] (``utils/plot.py``) and the trajectory figure
(``EvalTrajectory.eval_plot``), both drawn with matplotlib; unlike the JAX
trainer, which prints and goes on, a failure to draw them raises.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import torch

from deep_visual_slam_torch import resolve_device
from deep_visual_slam_torch.data.loader import VoDataLoader, device_prefetch
from deep_visual_slam_torch.eval.traj_eval import EvalTrajectory
from deep_visual_slam_torch.parallel.collectives import all_gather
from deep_visual_slam_torch.parallel.mesh import trainer_mesh, world_and_rank
from deep_visual_slam_torch.training.state import TrainState, init_vo_models
from deep_visual_slam_torch.training.steps import (
    make_stereo_train_step,
    make_vo_eval_step,
    make_vo_train_step,
)
from deep_visual_slam_torch.training.vo_learner import VOLossConfig
from deep_visual_slam_torch.utils import logging as tracing
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
    at construction. ``use_mesh`` (the JAX trainer's) trains over the
    process group where there is one; ``Experiment.num_devices``, where
    set, must equal the world size.
    """

    def __init__(
        self, config: Dict, data_root: Optional[str] = None, device=None, use_mesh: bool = True
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
            self._print(msg)
        self.state = TrainState.create(
            depth, pose, t["init_lr"], self.total_updates, beta1=t.get("beta1", 0.9),
            weight_decay=0.0, power=0.9, end_lr=0.0,
        )
        self.train_step = make_vo_train_step(
            depth, pose, self.loss_cfg, dtype, remat=t.get("remat", False),
            device_augment=t.get("device_augment", False),
            accum_steps=int(t.get("accum_steps", 1)), device=self.device, mesh=self.mesh,
        )
        self.eval_step = make_vo_eval_step(
            depth, pose, self.loss_cfg, dtype, device=self.device, mesh=self.mesh
        )
        self.stereo_step = (
            make_stereo_train_step(depth, self.loss_cfg, dtype, device=self.device,
                                   mesh=self.mesh)
            if stereo_loader is not None else None
        )

        exp = experiment_name(config)
        self.writer = MetricsWriter(
            os.path.join(config["Directory"]["log_dir"], exp) if self.chief else None
        )
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
            self._print(f"Resumed from checkpoint step {step} (epoch {self.start_epoch}, "
                        f"step_in_epoch {sie})")
        self._mode(True)  # the eval step, made last, left the models in eval mode

    def _print(self, msg: str) -> None:
        if self.chief:
            print(msg)

    def _gather(self, x):
        """The global batch's rows of ``x`` (this rank's rows) under a mesh."""
        return x if self.mesh is None or x is None else all_gather(x).flatten(0, 1)

    def _mode(self, train: bool) -> None:
        self.state.depth_model.train(train)
        self.state.pose_model.train(train)

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        """One epoch (or its rest, after a mid-epoch resume); returns the
        epoch's mean of each loss. The sums stay on the device; losses are
        read back at the first step and every tenth, and the step timer
        marks each readback and the epoch's end."""
        self._mode(True)
        self.timer.restart()
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
        profile = self.profile_dir and epoch == self.start_epoch and self.chief
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
                self.timer.mark(count)
                self.writer.scalar("train/frames_per_sec",
                                   self.timer.throughput(self.batch_size), step)
        if profiler is not None:
            _stop_profiler(profiler, self.device, self.profile_dir)
        means = {k: v.item() / counts[k] for k, v in sums.items()}
        self.timer.mark(count)
        self.writer.flush()
        return means

    def validate(self, epoch: int) -> Dict[str, float]:
        """The eval step over the valid loader: mean losses and the
        trajectory metrics of the predicted target -> right poses."""
        self._mode(False)
        self.eval_tool.reset()
        agg: Dict[str, float] = {}
        count = 0
        for batch in device_prefetch(self.data_loader.valid_loader, self.device):
            outputs, losses = self.eval_step(batch, self.generator)
            if count == 0 and self.writer.takes_images:
                from deep_visual_slam_torch.utils.plot import vo_panel

                keys = ("color_left_0", "color_right_0", "disp_0")
                self.writer.image("valid/panel", vo_panel(
                    {"target_image": _host(batch["target_image"][:1])},
                    {k: _host(outputs[k][:1]) for k in keys},
                ), self.state.step)
            for k, v in losses.items():
                agg[k] = agg.get(k, 0.0) + v.item()
            count += 1
            self.eval_tool.update_state(
                self._gather(outputs["cam_T_cam_right"]),
                self._gather(batch.get("gt_pose_target_to_right")),
            )
        if count == 0:
            return {}
        metrics = {f"valid/{k}": v / count for k, v in agg.items()}
        metrics.update({f"valid/{k}": v for k, v in self.eval_tool.metrics().items()})
        self.writer.scalars(metrics, self.state.step)
        if self.writer.takes_images:
            self.writer.image("valid/trajectory", self.eval_tool.eval_plot(f"epoch {epoch}"),
                              self.state.step)
        self.writer.flush()
        return metrics

    def save_checkpoint(self, epoch: int, step_in_epoch: int = 0) -> Optional[str]:
        """``step_in_epoch=0`` marks a completed epoch; above 0 a save inside
        it. Either carries the generator's state. Returns the file's path;
        under a mesh rank 0 writes it and the others return ``None``."""
        if not self.chief:
            return None
        return self.ckpt.save(self.state.step, self.state, metadata={
            "epoch": epoch,
            "step_in_epoch": int(step_in_epoch),
            "generator": self.generator.get_state().tolist(),
        })

    def train(self, on_phase: Optional[Callable[[int, str, Dict[str, float]], None]] = None
              ) -> None:
        """The epochs from ``start_epoch``: each trains, validates every
        ``valid_freq``-th epoch and saves every ``save_freq``-th.
        ``on_phase(epoch, phase, metrics)``, where given, is called at the
        end of each of these parts (``phase`` ``"train"``, ``"valid"`` or
        ``"save"``) with its metrics (empty for a save)."""
        def ended(epoch, phase, metrics):
            if on_phase is not None:
                on_phase(epoch, phase, metrics)

        for epoch in range(self.start_epoch, self.epochs + 1):
            train_metrics = self.train_epoch(epoch)
            ended(epoch, "train", train_metrics)
            msg = ", ".join(
                f"{k}={v:.4f}" for k, v in sorted(train_metrics.items())
                if k in ("loss", "grad_norm")
            )
            self._print(f"epoch {epoch}/{self.epochs}: {msg} "
                        f"({self.timer.throughput(self.batch_size):.1f} frames/s)")
            if epoch % self.valid_freq == 0:
                val = self.validate(epoch)
                ended(epoch, "valid", val)
                if "valid/loss" in val:
                    self._print(f"  valid loss={val['valid/loss']:.4f}")
            if epoch % self.save_freq == 0:
                self.save_checkpoint(epoch)
                ended(epoch, "save", {})
        self.writer.close()
        self.ckpt.close()


def _host(x: torch.Tensor):
    """A tensor as a float32 numpy array on the host."""
    return x.detach().float().cpu().numpy()


def _start_profiler(device: torch.device):
    """A running ``torch.profiler`` over the host and the device; the
    program's spans record while it runs, so its trace shows them by name."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
    profiler.start()
    return profiler


def _stop_profiler(profiler, device: torch.device, profile_dir: str) -> None:
    """The profiler stopped, the spans' buffer emptied (the trace holds
    the spans) and the trace written to ``<profile_dir>/train_steps.json``."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    profiler.stop()
    tracing.drain()
    os.makedirs(profile_dir, exist_ok=True)
    profiler.export_chrome_trace(os.path.join(profile_dir, "train_steps.json"))
