"""Pretrained weights for the VO and supervised-depth trainers (port of
``utils/pretrained.py``).

The port's parameter names are the reference torch ``state_dict``'s, so
this is ``load_state_dict`` of files the user supplies; nothing is
downloaded. Config keys (under ``Train``, null by default)::

    pretrained_encoder: weights/resnet18_imagenet.pth   # torchvision ResNet
    pretrained_weights:
      depth: weights/vo/depth_net_epoch_30.pth          # full DepthNet
      pose:  weights/vo/pose_net_epoch_30.pth           # full PoseNet

The encoder goes in first (under ``encoder.encoder.`` of each network; the
pose encoder's 3-channel conv1 is tiled over its two images and divided by
two), the full networks then override it. The depth trainer reads the
encoder and ``pretrained_weights.depth`` only. A file may wrap its weights in a
``"state_dict"`` entry and carry torch.compile's ``_orig_mod.`` prefixes.
Every graft must match the model's keys and shapes exactly. A reference
RAFT checkpoint (FlowPoseNet's frozen flow network) loads through
:func:`load_raft_state_dict`.
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import torch
import torch.nn as nn

_ENCODER = "encoder.encoder."


def strip_compile_prefix(state_dict: Mapping) -> Dict:
    """Remove torch.compile's ``_orig_mod.`` prefixes from the keys."""
    return {
        (k[len("_orig_mod."):] if k.startswith("_orig_mod.") else k): v
        for k, v in state_dict.items()
    }


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """A ``state_dict`` file, unwrapped from a ``"state_dict"`` entry (when
    the file's other entries are not tensors) and with compile prefixes
    stripped."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd and all(
        not hasattr(v, "shape") for k, v in sd.items() if k != "state_dict"
    ):
        sd = sd["state_dict"]
    return strip_compile_prefix(sd)


def _weights_only(keys):
    return {k for k in keys if not k.endswith("num_batches_tracked")}


def _graft(model: nn.Module, new: Mapping[str, torch.Tensor], prefix: str, where: str) -> None:
    """Load ``new`` (keys relative to ``prefix``) into ``model``: its keys
    must be the model's keys under ``prefix`` (BatchNorm batch counters
    aside) and every shape must match."""
    own = model.state_dict()
    ref = {k[len(prefix):]: v for k, v in own.items() if k.startswith(prefix)}
    new_keys, ref_keys = _weights_only(new), _weights_only(ref)
    if new_keys != ref_keys:
        missing = sorted(ref_keys - new_keys)[:5]
        extra = sorted(new_keys - ref_keys)[:5]
        raise ValueError(
            f"pretrained graft at '{prefix or '/'}' ({where}) does not match the "
            f"model (missing {missing}, extra {extra}): wrong num_layers or file?"
        )
    for k in new_keys:
        if tuple(new[k].shape) != tuple(ref[k].shape):
            raise ValueError(
                f"pretrained graft at '{prefix}{k}' ({where}): shape "
                f"{tuple(new[k].shape)} != model shape {tuple(ref[k].shape)}"
            )
    own.update({prefix + k: new[k].to(ref[k].dtype) for k in new_keys})
    model.load_state_dict(own)


def _encoder_weights(sd: Mapping[str, torch.Tensor], num_input_images: int) -> Dict:
    """A torchvision ResNet's weights for an encoder of ``num_input_images``
    stacked frames: the classifier dropped and a 3-channel conv1 tiled over
    the frames and divided by their count (a conv1 already of 3 x N
    channels passes through)."""
    out = {k: v for k, v in sd.items() if not k.startswith("fc.")}
    conv1 = out["conv1.weight"]
    if num_input_images > 1 and conv1.shape[1] == 3:
        out["conv1.weight"] = torch.cat([conv1] * num_input_images, dim=1) / num_input_images
    return out


def apply_vo_pretrained(depth_model: nn.Module, pose_model: nn.Module, config: Dict) -> List[str]:
    """Apply ``Train.pretrained_encoder`` and ``Train.pretrained_weights`` to
    freshly made VO networks, in place; returns what was loaded."""
    t = config.get("Train", {})
    report: List[str] = []
    enc_path = t.get("pretrained_encoder")
    if enc_path:
        sd = load_state_dict_file(enc_path)
        _graft(depth_model, _encoder_weights(sd, 1), _ENCODER, enc_path)
        _graft(pose_model, _encoder_weights(sd, 2), _ENCODER, enc_path)
        report.append(f"pretrained encoder (1x + 2x input): {enc_path}")
    pw = t.get("pretrained_weights") or {}
    for name, model in (("depth", depth_model), ("pose", pose_model)):
        if pw.get(name):
            _graft(model, load_state_dict_file(pw[name]), "", pw[name])
            report.append(f"pretrained {name} net: {pw[name]}")
    return report


def apply_depth_pretrained(depth_model: nn.Module, config: Dict) -> List[str]:
    """The same for the supervised-depth trainer's DepthNet alone."""
    t = config.get("Train", {})
    report: List[str] = []
    enc_path = t.get("pretrained_encoder")
    if enc_path:
        sd = load_state_dict_file(enc_path)
        _graft(depth_model, _encoder_weights(sd, 1), _ENCODER, enc_path)
        report.append(f"pretrained encoder: {enc_path}")
    pw = t.get("pretrained_weights") or {}
    if pw.get("depth"):
        _graft(depth_model, load_state_dict_file(pw["depth"]), "", pw["depth"])
        report.append(f"pretrained depth net: {pw['depth']}")
    return report


def load_raft_state_dict(path: str, small: bool = True) -> Dict[str, torch.Tensor]:
    """A reference RAFT checkpoint (``raft-small.pth``, ``raft-things.pth``,
    ...) as the port's RAFT ``state_dict``: DataParallel's ``module.`` and
    compile prefixes stripped, and checked by a strict load into
    ``RAFT(small=small)``, which raises on a missing, extra or misshapen
    key. The names are the reference's, so nothing is converted; load the
    result into a RAFT, or into ``FlowPoseNet.flow_net``."""
    from deep_visual_slam_torch.models.raft import RAFT

    sd = {(k[len("module."):] if k.startswith("module.") else k): v
          for k, v in load_state_dict_file(path).items()}
    RAFT(small=small).load_state_dict(sd)
    return sd
