"""The trainer's checkpoints, with automatic resume (the port's own format;
the JAX package writes orbax directories).

A checkpoint is one ``torch.save`` file per step, ``ckpt_<step>.pt``,
holding the networks' ``state_dict``s (``depth``, and ``pose`` for VO), the
optimizer's ``state_dict``, the
update count ``step`` and a JSON metadata string (epoch, step in the epoch,
the trainer's generator state). It is written under a temporary name and
renamed, so a run killed while saving leaves the previous checkpoint whole;
the newest ``max_to_keep`` are kept. Files are read back with
``torch.load(weights_only=True)``.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Optional, Tuple

import torch

from deep_visual_slam_torch.utils.pretrained import strip_compile_prefix

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


def _steps(directory: str):
    """The steps with a checkpoint under ``directory``, ascending."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(directory)) if m)


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt_{step:08d}.pt")


def _atomic_save(obj, path: str) -> None:
    tmp = f"{path}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


class CheckpointManager:
    """Saves and restores a :class:`~deep_visual_slam_torch.training.state.TrainState`
    under ``directory``."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def save(self, step: int, state, metadata: Optional[Dict] = None) -> str:
        """Write ``state`` as the checkpoint of ``step`` (replacing one of the
        same step), then drop all but the newest ``max_to_keep``. Returns
        the file's path."""
        path = _path(self.directory, step)
        tree = {
            "depth": state.depth_model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "step": int(state.step),
            "metadata": json.dumps(metadata or {}),
        }
        if state.pose_model is not None:
            tree["pose"] = state.pose_model.state_dict()
        _atomic_save(tree, path)
        for old in _steps(self.directory)[: -self.max_to_keep]:
            os.remove(_path(self.directory, old))
        return path

    def latest_step(self) -> Optional[int]:
        steps = _steps(self.directory)
        return steps[-1] if steps else None

    def restore_latest(self, state) -> Tuple[object, Optional[Dict], Optional[int]]:
        """Load the newest checkpoint into ``state`` (models, optimizer,
        update count). Returns ``(state, metadata, step)``, or ``(state,
        None, None)`` with nothing to restore."""
        step = self.latest_step()
        if step is None:
            return state, None, None
        tree = torch.load(_path(self.directory, step), map_location="cpu", weights_only=True)
        state.depth_model.load_state_dict(tree["depth"])
        if state.pose_model is not None:
            state.pose_model.load_state_dict(tree["pose"])
        state.optimizer.load_state_dict(tree["optimizer"])
        state.step = int(tree["step"])
        return state, json.loads(tree["metadata"]), step

    def close(self) -> None:
        """Nothing stays open between saves; kept for the JAX interface."""


def load_latest_tree(directory: str) -> Optional[Tuple[Dict, int]]:
    """The newest checkpoint under ``directory`` as ``(tree, step)``: the
    saved dict, its tensors on the CPU; ``None`` if there is none."""
    directory = os.path.abspath(directory)
    steps = _steps(directory)
    if not steps:
        return None
    tree = torch.load(_path(directory, steps[-1]), map_location="cpu", weights_only=True)
    return tree, steps[-1]


def save_params_only(state_dicts: Dict[str, Dict[str, torch.Tensor]], path: str) -> None:
    """Weights alone, e.g. ``{"depth": ..., "pose": ...}`` state_dicts."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    _atomic_save(state_dicts, path)


def load_params_only(path: str) -> Dict[str, Dict[str, torch.Tensor]]:
    return torch.load(path, map_location="cpu", weights_only=True)


def load_network_states(path: str) -> Tuple[Dict, Optional[int]]:
    """The networks' weights that ``path`` holds, as ``(tree, step)``: a
    trainer's checkpoint directory gives its newest checkpoint and its step,
    a params-only file (``{"depth": ..., "pose": ...}``, or a bare
    ``state_dict``) its contents and ``None``."""
    if os.path.isfile(path):
        return load_params_only(path), None
    latest = load_latest_tree(path)
    if latest is None:
        raise FileNotFoundError(f"no checkpoint under {path}")
    return latest


def network_state(tree: Dict, name: str) -> Dict[str, torch.Tensor]:
    """``tree[name]`` (``"depth"`` or ``"pose"``) of :func:`load_network_states`,
    or the tree itself when it is a bare ``state_dict``, compile prefixes
    stripped."""
    return tree[name] if isinstance(tree.get(name), dict) else strip_compile_prefix(tree)
