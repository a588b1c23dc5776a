"""Carry JAX variables into the port's ``state_dict``s.

The inverse of the JAX package's ``utils/torch_weights.py``
(``convert_depthnet``, ``convert_posenet``), plus ``TwoEncoderPoseNet``,
which the JAX package has no converter for: the input is the JAX
``{"params", "batch_stats"}`` tree as nested dicts of numpy arrays, the
output the port's ``state_dict`` in the reference torch naming. Conv
kernels go from ``[kh, kw, I, O]`` to ``[O, I, kh, kw]``; BatchNorm
``scale/bias/mean/var`` become ``weight/bias/running_mean/running_var``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from deep_visual_slam_torch.models.resnet import STAGE_SIZES


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _kernel(k) -> torch.Tensor:
    """flax ``[kh, kw, I, O]`` -> torch ``[O, I, kh, kw]``."""
    return _t(np.asarray(k).transpose(3, 2, 0, 1))


def _conv(out: Dict, prefix: str, p: Mapping) -> None:
    out[f"{prefix}.weight"] = _kernel(p["kernel"])
    if "bias" in p:
        out[f"{prefix}.bias"] = _t(p["bias"])


def _bn(out: Dict, prefix: str, p: Mapping, s: Mapping) -> None:
    out[f"{prefix}.weight"] = _t(p["scale"])
    out[f"{prefix}.bias"] = _t(p["bias"])
    out[f"{prefix}.running_mean"] = _t(s["mean"])
    out[f"{prefix}.running_var"] = _t(s["var"])
    out[f"{prefix}.num_batches_tracked"] = torch.tensor(0)


def _encoder(out: Dict, params: Mapping, stats: Mapping, num_layers: int) -> None:
    """JAX ``ResNetEncoder`` variables -> ``encoder.encoder.*``: basic
    blocks (two convs) up to 34 layers, bottlenecks (three) above; the
    projection shortcut is the block's next conv and BatchNorm."""
    pre = "encoder.encoder"
    _conv(out, f"{pre}.conv1", params["Conv_0"])
    _bn(out, f"{pre}.bn1", params["BatchNorm_0"], stats["BatchNorm_0"])
    block, n_convs = ("BasicBlock", 2) if num_layers <= 34 else ("BottleneckBlock", 3)
    block_i = 0
    for stage, n_blocks in enumerate(STAGE_SIZES[num_layers]):
        for b in range(n_blocks):
            name = f"{block}_{block_i}"
            bp, bs = params[name], stats[name]
            t = f"{pre}.layer{stage + 1}.{b}"
            for ci in range(n_convs):
                _conv(out, f"{t}.conv{ci + 1}", bp[f"Conv_{ci}"])
                _bn(out, f"{t}.bn{ci + 1}", bp[f"BatchNorm_{ci}"],
                    bs[f"BatchNorm_{ci}"])
            if f"Conv_{n_convs}" in bp:
                _conv(out, f"{t}.downsample.0", bp[f"Conv_{n_convs}"])
                _bn(out, f"{t}.downsample.1", bp[f"BatchNorm_{n_convs}"],
                    bs[f"BatchNorm_{n_convs}"])
            block_i += 1


def depthnet_from_jax(variables: Mapping, num_layers: int = 18) -> Dict[str, torch.Tensor]:
    """JAX ``DepthNet`` variables -> the port's ``DepthNet`` ``state_dict``.

    Decoder indices: 0..9 = ``upconv_{i}_{j}`` for i = 4..0, 10..13 =
    ``dispconv_{0..3}``, then 14 = ``uncconv_0`` where the tree has one.
    """
    params, stats = variables["params"], variables["batch_stats"]
    out: Dict[str, torch.Tensor] = {}
    _encoder(out, params["encoder"], stats["encoder"], num_layers)
    dec = params["decoder"]
    idx = 0
    for i in range(4, -1, -1):
        for j in range(2):
            _conv(out, f"decoder.{idx}.conv.conv",
                  dec[f"upconv_{i}_{j}"]["ReflectConv3x3_0"]["Conv_0"])
            idx += 1
    heads = [f"dispconv_{s}" for s in range(4)]
    if "uncconv_0" in dec:
        heads.append("uncconv_0")
    for name in heads:
        _conv(out, f"decoder.{idx}.conv", dec[name]["Conv_0"])
        idx += 1
    return out


def posenet_from_jax(variables: Mapping, num_layers: int = 18) -> Dict[str, torch.Tensor]:
    """JAX ``PoseNet`` or ``TwoEncoderPoseNet`` variables -> the port's
    ``state_dict`` of the same class (``net.0`` squeeze, ``net.1``/``net.2``
    pose convs, ``net.3`` output): the two share their tree's names."""
    params, stats = variables["params"], variables["batch_stats"]
    out: Dict[str, torch.Tensor] = {}
    _encoder(out, params["encoder"], stats["encoder"], num_layers)
    for i, name in enumerate(("squeeze", "pose_0", "pose_1", "pose_2")):
        _conv(out, f"net.{i}", params[name])
    return out


# TwoEncoderPoseNet's tree (one shared ``encoder``, ``squeeze``,
# ``pose_0..2``) has PoseNet's names, and its port the same ``net.0..3``.
two_encoder_posenet_from_jax = posenet_from_jax


def _raft_encoder(out: Dict, pre: str, params: Mapping, stats: Mapping, small: bool) -> None:
    """A JAX RAFT ``Encoder`` -> ``{pre}.*``. Norms carry parameters only in
    the batch-normed (Basic ``cnet``) encoder; its shortcut norm appears under
    both of the reference's names, ``norm3``/``norm4`` and ``downsample.1``."""
    _conv(out, f"{pre}.conv1", params["Conv_0"])
    if "_Norm_0" in params:
        _bn(out, f"{pre}.norm1", params["_Norm_0"]["BatchNorm_0"],
            stats["_Norm_0"]["BatchNorm_0"])
    block, n_convs = ("BottleneckBlock", 3) if small else ("ResidualBlock", 2)
    for i in range(6):
        bp = params[f"{block}_{i}"]
        bs = stats.get(f"{block}_{i}", {})
        t = f"{pre}.layer{i // 2 + 1}.{i % 2}"
        for ci in range(n_convs):
            _conv(out, f"{t}.conv{ci + 1}", bp[f"Conv_{ci}"])
            if f"_Norm_{ci}" in bp:
                _bn(out, f"{t}.norm{ci + 1}", bp[f"_Norm_{ci}"]["BatchNorm_0"],
                    bs[f"_Norm_{ci}"]["BatchNorm_0"])
        if f"Conv_{n_convs}" in bp:
            _conv(out, f"{t}.downsample.0", bp[f"Conv_{n_convs}"])
            norm = f"_Norm_{n_convs}"
            if norm in bp:
                for name in (f"{t}.norm{n_convs + 1}", f"{t}.downsample.1"):
                    _bn(out, name, bp[norm]["BatchNorm_0"], bs[norm]["BatchNorm_0"])
    _conv(out, f"{pre}.conv2", params["Conv_1"])


def raft_from_jax(variables: Mapping, small: bool = True) -> Dict[str, torch.Tensor]:
    """JAX ``models.RAFT`` variables -> the port's RAFT ``state_dict`` (the
    reference torch names): the inverse of the JAX package's
    ``convert_raft``, ``batch_stats`` (the Basic ``cnet``) included."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    out: Dict[str, torch.Tensor] = {}
    for name in ("fnet", "cnet"):
        _raft_encoder(out, name, params[name], stats.get(name, {}), small)
    up = params["refine"]["update"]
    u = "update_block"
    if small:
        enc_names = ("convc1", "convf1", "convf2", "conv")
        enc, gru = up["SmallMotionEncoder_0"], up["ConvGRU_0"]
        for g, key in zip("zrq", ("Conv_0", "Conv_1", "Conv_2")):
            _conv(out, f"{u}.gru.conv{g}", gru[key])
    else:
        enc_names = ("convc1", "convc2", "convf1", "convf2", "conv")
        enc, gru = up["BasicMotionEncoder_0"], up["SepConvGRU_0"]
        for i, axis in ((1, "h"), (2, "v")):
            for g in "zrq":
                _conv(out, f"{u}.gru.conv{g}{i}", gru[f"conv{g}_{axis}"])
        _conv(out, f"{u}.mask.0", up["Conv_0"])
        _conv(out, f"{u}.mask.2", up["Conv_1"])
    for i, name in enumerate(enc_names):
        _conv(out, f"{u}.encoder.{name}", enc[f"Conv_{i}"])
    _conv(out, f"{u}.flow_head.conv1", up["FlowHead_0"]["Conv_0"])
    _conv(out, f"{u}.flow_head.conv2", up["FlowHead_0"]["Conv_1"])
    return out


def _linear(out: Dict, prefix: str, p: Mapping) -> None:
    """flax ``Dense`` (kernel [in, out]) -> torch ``Linear`` ([out, in])."""
    out[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    out[f"{prefix}.bias"] = _t(p["bias"])


def flow_posenet_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``FlowPoseNet`` variables -> the port's ``state_dict``: its
    SmallRAFT ``flow_net`` through :func:`raft_from_jax`, the head's
    ``Conv_0..2`` to ``conv1..3`` and ``Dense_0`` to ``fc``."""
    params = variables["params"]
    raft = raft_from_jax({"params": params["flow_net"]}, small=True)
    out = {f"flow_net.{k}": v for k, v in raft.items()}
    for i in range(3):
        _conv(out, f"conv{i + 1}", params[f"Conv_{i}"])
    _linear(out, "fc", params["Dense_0"])
    return out


def flow_update_module_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``FlowUpdateModule`` variables -> the port's ``state_dict``."""
    params = variables["params"]
    out: Dict[str, torch.Tensor] = {}
    for i, name in enumerate(("convc1", "convc2", "convf1", "convf2", "conv")):
        _conv(out, name, params[f"Conv_{i}"])
    for name, p in params["GlobalContextConvGRU_0"].items():
        _conv(out, f"gru.{name}", p)
    _linear(out, "fc", params["Dense_0"])
    return out
