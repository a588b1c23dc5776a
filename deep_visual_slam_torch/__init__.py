"""PyTorch/CUDA port of ``deep_visual_slam_tpu`` for NVIDIA Hopper.

Module names mirror the JAX package so each counterpart is easy to find.
The public functions of ``ops/`` and ``training/`` keep the JAX package's
NHWC layout; the ``nn.Module``s run NCHW inside and keep the reference torch
``state_dict`` naming. Every kernel the JAX package wrote in Pallas is a
hand-written CUDA kernel here (sources under ``csrc/``), built with ``nvcc``
at first use.

Entry points take a ``device`` argument that defaults to CUDA and raise when
CUDA is absent; pass ``device="cpu"`` to run the plain PyTorch paths.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raises if a CUDA device is asked for but absent."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path"
        )
    return device
