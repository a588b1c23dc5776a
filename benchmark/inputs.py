"""Everything a run feeds both sides, drawn from ``--seed`` on the device:
the weights, the batches and the auto-mask tie-break noise.

Each kind of draw has its own generator, seeded from the run's seed and a
fixed stream number, so that the same seed gives the same weights, batches
and noise whatever else the run does. Sizes never depend on the seed.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from benchmark.reference import losses

WEIGHTS, BATCHES, NOISE = 1, 2, 3


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed((seed * 16 + stream) % 2**63)


def draw_weights(spec: List[tuple], seed: int, device) -> Dict[str, torch.Tensor]:
    """The parameters that ``spec`` lists as (name, shape, kind), in its
    order: a ``weight`` He-uniform (bound sqrt(6 / fan_in), fan_in the
    product of its shape after the first axis), a ``bias`` uniform in
    +-1/sqrt(fan_in) of its module's weight, ``ones`` and ``zeros`` as
    named; one uniform draw for all of them, fp32."""
    total = sum(math.prod(s) for _, s, _ in spec)
    u = torch.rand(total, generator=generator(seed, WEIGHTS, device), device=device) * 2 - 1
    out, at = {}, 0
    for name, shape, kind in spec:
        n = math.prod(shape)
        if kind == "ones":
            out[name] = torch.ones(shape, device=device)
        elif kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
        else:
            fan_in = math.prod(_weight_shape(spec, name)[1:])
            bound = math.sqrt(6.0 / fan_in) if kind == "weight" else 1.0 / math.sqrt(fan_in)
            out[name] = (u[at:at + n] * bound).view(shape).clone()
        at += n
    return out


def _weight_shape(spec, name):
    weight = name.rsplit(".", 1)[0] + ".weight"
    return next(s for n, s, _ in spec if n == weight)


def _texture(gen, B: int, H: int, W: int, device) -> torch.Tensor:
    """[B, H, W, 3] in [0, 1]: three octaves of uniform noise, bilinearly
    upsampled, at a contrast drawn per row."""
    tex = torch.zeros(B, 3, H, W, device=device)
    for div, amp in ((32, 0.5), (8, 0.3), (2, 0.2)):
        low = torch.rand(B, 3, max(H // div, 2), max(W // div, 2), generator=gen, device=device)
        tex += amp * F.interpolate(low, size=(H, W), mode="bilinear", align_corners=False)
    contrast = 0.5 + 1.5 * torch.rand(B, 1, 1, 1, generator=gen, device=device)
    mean = tex.mean(dim=(1, 2, 3), keepdim=True)
    return torch.clamp(0.5 + (tex - mean) * contrast * 2, 0, 1).permute(0, 2, 3, 1).contiguous()


def _smooth(gen, B: int, H: int, W: int, div: int, lo: float, hi: float, device):
    low = torch.rand(B, 1, max(H // div, 2), max(W // div, 2), generator=gen, device=device)
    up = F.interpolate(low, size=(H, W), mode="bilinear", align_corners=False)
    return (lo + (hi - lo) * up).permute(0, 2, 3, 1).contiguous()


def intrinsics(B: int, H: int, W: int, device):
    """Redwood's 525-pixel focal length at 640x480, scaled to W x H."""
    K = torch.eye(4, device=device)
    K[0, 0], K[1, 1] = 525.0 * W / 640, 525.0 * H / 480
    K[0, 2], K[1, 2] = (W - 1) / 2, (H - 1) / 2
    K = K.expand(B, 4, 4).contiguous()
    return K, torch.linalg.inv(K)


def vo_batch(gen, B: int, H: int, W: int, device) -> Dict[str, torch.Tensor]:
    """A (left, target, right) snippet batch: a textured target over a
    smooth depth in [1, 8] m, each source rendered from it at a small
    random pose (rotations within 0.01 rad, translations within 5 cm)."""
    target = _texture(gen, B, H, W, device)
    depth = _smooth(gen, B, H, W, 64, 1.0, 8.0, device)
    K, inv_K = intrinsics(B, H, W, device)
    points = losses.backproject(depth, inv_K)
    batch = {"target_image": target, "K": K, "inv_K": inv_K}
    for key in ("source_left", "source_right"):
        aa = (torch.rand(B, 3, generator=gen, device=device) * 2 - 1) * 0.01
        t = (torch.rand(B, 3, generator=gen, device=device) * 2 - 1) * 0.05
        grid = losses.project(points, K, losses.pose_matrix(aa, t, True))
        batch[key] = losses.warp(target, grid).contiguous()
    return batch


def vo_noise(gen, B: int, H: int, W: int, scales: int, device) -> List[torch.Tensor]:
    """The auto-mask tie-break noise: a standard normal [B, H, W, 2] a scale."""
    return [torch.randn(B, H, W, 2, generator=gen, device=device) for _ in range(scales)]


def depth_batch(gen, B: int, H: int, W: int, device) -> Dict[str, torch.Tensor]:
    """An image, a smooth metric depth and a valid mask with blocks of
    missing returns (about 5% of the 8x8 blocks), as NYU's Kinect depth
    has. Each row is its own room: its nearest depth is drawn in [0.5, 2]
    m and its farthest 1 to 8 m beyond, at most 10 m."""
    image = _texture(gen, B, H, W, device)
    near = 0.5 + 1.5 * torch.rand(B, 1, 1, 1, generator=gen, device=device)
    far = torch.clamp(near + 1 + 7 * torch.rand(B, 1, 1, 1, generator=gen, device=device),
                      max=10.0)
    depth = near + (far - near) * _smooth(gen, B, H, W, 32, 0.0, 1.0, device)
    holes = torch.rand(B, 1, max(H // 8, 1), max(W // 8, 1), generator=gen, device=device)
    valid = F.interpolate((holes > 0.05).float(), size=(H, W), mode="nearest")
    return {"image": image, "depth": depth, "valid_mask": valid.permute(0, 2, 3, 1).contiguous()}
