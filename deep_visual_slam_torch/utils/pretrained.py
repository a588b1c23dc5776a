"""Pretrained weights for the VO and supervised-depth trainers (port of
``utils/pretrained.py``).

The port's parameter names are the reference torch ``state_dict``'s, so
this is ``load_state_dict`` of files the user supplies; nothing is
downloaded. Config keys (under ``Train``, null by default)::

    pretrained_encoder: weights/resnet18_imagenet.pth   # torchvision ResNet, or .npz
    pretrained_weights:
      depth: weights/vo/depth_net_epoch_30.pth          # full DepthNet, or .npz
      pose:  weights/vo/pose_net_epoch_30.pth           # full PoseNet, or .npz

The encoder goes in first (under ``encoder.encoder.`` of each network; the
pose encoder's 3-channel conv1 is tiled over its two images and divided by
two), the full networks then override it. The depth trainer reads the
encoder and ``pretrained_weights.depth`` only. A file may wrap its weights in a
``"state_dict"`` entry and carry torch.compile's ``_orig_mod.`` prefixes.
Every graft must match the model's keys and shapes exactly. A reference
RAFT checkpoint (FlowPoseNet's frozen flow network) loads through
:func:`load_raft_state_dict`, a Depth-Anything-V2 one through
:func:`load_depth_anything_state_dict`.

Every one of these paths also takes an ``.npz`` of JAX variables (the JAX
package's ``save_variables_npz``, flattened ``params/...`` and
``batch_stats/...`` keys), converted by ``utils/weights.py``: a DepthNet,
PoseNet or RAFT tree, or a bare ResNet encoder's. An encoder ``.npz`` goes
in as it is, as the JAX package loads it: no conv1 tiling, so a
3-channel encoder file fails on the pose encoder's 6-channel conv1.
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import numpy as np
import torch
import torch.nn as nn

_ENCODER = "encoder.encoder."


def strip_compile_prefix(state_dict: Mapping) -> Dict:
    """Remove torch.compile's ``_orig_mod.`` prefixes from the keys."""
    return {
        (k[len("_orig_mod."):] if k.startswith("_orig_mod.") else k): v
        for k, v in state_dict.items()
    }


def _is_npz(path: str) -> bool:
    return str(path).endswith(".npz")


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


def _encoder_num_layers(params: Mapping) -> int:
    """The depth of a JAX ``ResNetEncoder`` tree, from its block names and
    count (18 and 34 have basic blocks, 50 and up bottlenecks)."""
    from deep_visual_slam_torch.models.resnet import STAGE_SIZES

    basic = sum(k.startswith("BasicBlock_") for k in params)
    blocks = basic or sum(k.startswith("BottleneckBlock_") for k in params)
    for n, stages in STAGE_SIZES.items():
        if sum(stages) == blocks and (n <= 34) == bool(basic):
            return n
    raise ValueError(f"not a ResNet encoder tree ({blocks} blocks)")


def _encoder_weights_for(path: str, num_input_images: int) -> Dict[str, torch.Tensor]:
    """The encoder file at ``path`` as weights relative to ``encoder.encoder.``:
    a torchvision ``.pth`` through :func:`_encoder_weights`, a JAX encoder
    ``.npz`` converted as it is."""
    if not _is_npz(path):
        return _encoder_weights(load_state_dict_file(path), num_input_images)
    from deep_visual_slam_torch.utils.weights import _encoder

    variables = load_variables_npz(path)
    params, stats = variables["params"], variables.get("batch_stats", {})
    out: Dict[str, torch.Tensor] = {}
    _encoder(out, params, stats, _encoder_num_layers(params))
    return {k[len(_ENCODER):]: v for k, v in out.items()}


def _network_weights(path: str, name: str) -> Dict[str, torch.Tensor]:
    """A full ``name`` (``"depth"`` or ``"pose"``) network's file as the
    port's ``state_dict``: torch files as they are, JAX ``.npz`` trees
    through ``depthnet_from_jax``/``posenet_from_jax``."""
    if not _is_npz(path):
        return load_state_dict_file(path)
    from deep_visual_slam_torch.utils.weights import depthnet_from_jax, posenet_from_jax

    variables = load_variables_npz(path)
    convert = depthnet_from_jax if name == "depth" else posenet_from_jax
    try:
        return convert(variables, _encoder_num_layers(variables["params"]["encoder"]))
    except KeyError as e:
        raise ValueError(f"{path} is not a JAX {name} network's variables (no {e})") from None


def apply_vo_pretrained(depth_model: nn.Module, pose_model: nn.Module, config: Dict) -> List[str]:
    """Apply ``Train.pretrained_encoder`` and ``Train.pretrained_weights`` to
    freshly made VO networks, in place; returns what was loaded."""
    t = config.get("Train", {})
    report: List[str] = []
    enc_path = t.get("pretrained_encoder")
    if enc_path:
        _graft(depth_model, _encoder_weights_for(enc_path, 1), _ENCODER, enc_path)
        _graft(pose_model, _encoder_weights_for(enc_path, 2), _ENCODER, enc_path)
        report.append(f"pretrained encoder (1x + 2x input): {enc_path}")
    pw = t.get("pretrained_weights") or {}
    for name, model in (("depth", depth_model), ("pose", pose_model)):
        if pw.get(name):
            _graft(model, _network_weights(pw[name], name), "", pw[name])
            report.append(f"pretrained {name} net: {pw[name]}")
    return report


def apply_depth_pretrained(depth_model: nn.Module, config: Dict) -> List[str]:
    """The same for the supervised-depth trainer's DepthNet alone."""
    t = config.get("Train", {})
    report: List[str] = []
    enc_path = t.get("pretrained_encoder")
    if enc_path:
        _graft(depth_model, _encoder_weights_for(enc_path, 1), _ENCODER, enc_path)
        report.append(f"pretrained encoder: {enc_path}")
    pw = t.get("pretrained_weights") or {}
    if pw.get("depth"):
        _graft(depth_model, _network_weights(pw["depth"], "depth"), "", pw["depth"])
        report.append(f"pretrained depth net: {pw['depth']}")
    return report


def load_raft_state_dict(path: str, small: bool = True) -> Dict[str, torch.Tensor]:
    """A reference RAFT checkpoint (``raft-small.pth``, ``raft-things.pth``,
    ...) as the port's RAFT ``state_dict``: DataParallel's ``module.`` and
    compile prefixes stripped, and checked by a strict load into
    ``RAFT(small=small)``, which raises on a missing, extra or misshapen
    key. The names are the reference's, so nothing is converted; load the
    result into a RAFT, or into ``FlowPoseNet.flow_net``. An ``.npz`` of
    JAX RAFT variables goes through ``raft_from_jax``."""
    from deep_visual_slam_torch.models.raft import RAFT

    if _is_npz(path):
        from deep_visual_slam_torch.utils.weights import raft_from_jax

        sd = raft_from_jax(load_variables_npz(path), small)
    else:
        sd = {(k[len("module."):] if k.startswith("module.") else k): v
              for k, v in load_state_dict_file(path).items()}
    RAFT(small=small).load_state_dict(sd)
    return sd


_SEP = "/"


def unflatten_variables(flat: Mapping) -> Dict:
    """Flat ``{"a/b/c": array}`` (the JAX package's ``flatten_variables``
    keys, as its ``.npz`` weight caches hold them) -> nested dicts."""
    out: Dict = {}
    for key, value in flat.items():
        node = out
        parts = key.split(_SEP)
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return out


def load_variables_npz(path: str) -> Dict:
    """A JAX variables tree saved as an ``.npz`` of flattened keys."""
    with np.load(path) as data:
        return unflatten_variables({k: data[k] for k in data.files})


# Entries of a published Depth-Anything-V2 file the model never runs: the
# ViT's masked-token embedding (training only) and refinenet4's skip unit
# (refinenet4 is called without a skip input).
_DA_UNUSED = ("pretrained.mask_token", "depth_head.scratch.refinenet4.resConfUnit1.")


def load_depth_anything_state_dict(
    path: str, encoder: str = "vits", config: Dict | None = None
) -> Dict[str, torch.Tensor]:
    """Depth-Anything-V2 weights as the port's ``state_dict``, checked by a
    strict load into ``DepthAnythingV2(encoder)`` (or ``config``'s widths).

    ``.pth``/``.pt``: a reference checkpoint (``depth_anything_v2_vits.pth``,
    ...) with DataParallel's ``module.`` and compile prefixes stripped and
    the entries the model never runs dropped; the names are the
    reference's, so nothing else changes. ``.npz``: the JAX package's cache
    of converted variables, mapped by ``depth_anything_from_jax``."""
    from deep_visual_slam_torch.models.depth_anything import DepthAnythingV2
    from deep_visual_slam_torch.utils.weights import depth_anything_from_jax

    if _is_npz(path):
        sd = depth_anything_from_jax(load_variables_npz(path))
    else:
        sd = {}
        for k, v in load_state_dict_file(path).items():
            while k.startswith(("module.", "_orig_mod.")):
                k = k.split(".", 1)[1]
            if not k.startswith(_DA_UNUSED):
                sd[k] = v
    with torch.device("meta"):  # the check needs the names and shapes only
        model = DepthAnythingV2(encoder, config=config)
    model.load_state_dict(sd, assign=True)
    return sd
