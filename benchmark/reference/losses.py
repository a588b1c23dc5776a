"""Plain fp32 losses of the two training paths.

The self-supervised VO loss (Monodepth2): per scale the disparity is
upsampled to the image (bilinear, half-pixel centres), turned into depth in
[0.1, 10], backprojected, moved by each source pose, projected and used to
sample the source (bilinear, border padding, corner-aligned). The
reprojection map is 0.85 SSIM (3x3 windows over a 1-pixel reflect pad) plus
0.15 L1, each averaged over the channels; the auto-mask takes the per-pixel
minimum over the identity maps (plus 1e-5 times the given standard normal
noise) and the warped maps; smoothness 1e-3 / 2^s on the mean-normalised
disparity. The supervised depth loss: SILog (variance focus 0.85) plus 0.1
times the edge-aware smoothness of the mean-normalised depth, the scales
weighted 1, 1/2, 1/4, 1/8.

Every loss here is a mean over rows of per-row terms or a function of sums
over rows, so a caller can evaluate it in blocks of rows.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

SSIM_C1 = 0.01**2
SSIM_C2 = 0.03**2


# --- geometry --------------------------------------------------------------

def rotation(aa: torch.Tensor) -> torch.Tensor:
    """Rodrigues: axis-angle [N, 3] -> [N, 3, 3], axis = aa / (|aa| + 1e-7)."""
    angle = torch.sqrt((aa * aa).sum(-1, keepdim=True) + 1e-24)
    axis = aa / (angle + 1e-7)
    c = torch.cos(angle)[..., None]
    s = torch.sin(angle)[..., None]
    x, y, z = axis.unbind(-1)
    zero = torch.zeros_like(x)
    skew = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], -1).view(-1, 3, 3)
    outer = axis[:, :, None] * axis[:, None, :]
    eye = torch.eye(3, device=aa.device, dtype=aa.dtype)
    return c * eye + s * skew + (1 - c) * outer


def pose_matrix(aa: torch.Tensor, t: torch.Tensor, invert: bool) -> torch.Tensor:
    """4x4 transform T(t) R, or R^T T(-t) when ``invert``."""
    n = aa.shape[0]
    R = torch.eye(4, device=aa.device, dtype=aa.dtype).repeat(n, 1, 1)
    T = R.clone()
    r = rotation(aa)
    R[:, :3, :3] = r.transpose(1, 2) if invert else r
    T[:, :3, 3] = -t if invert else t
    return R @ T if invert else T @ R


def backproject(depth: torch.Tensor, inv_K: torch.Tensor) -> torch.Tensor:
    """depth [B, H, W, 1] -> camera points [B, H, W, 3]."""
    B, H, W, _ = depth.shape
    ys, xs = torch.meshgrid(
        torch.arange(H, device=depth.device, dtype=depth.dtype),
        torch.arange(W, device=depth.device, dtype=depth.dtype), indexing="ij")
    pix = torch.stack([xs, ys, torch.ones_like(xs)], -1)  # [H, W, 3]
    rays = torch.einsum("bij,hwj->bhwi", inv_K[:, :3, :3], pix)
    return depth * rays


def project(points: torch.Tensor, K: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """points [B, H, W, 3] through T then K -> grid [B, H, W, 2] in [-1, 1]
    (corner-aligned)."""
    _, H, W, _ = points.shape
    P = (K @ T)[:, :3, :]
    cam = torch.einsum("bij,bhwj->bhwi", P[:, :, :3], points) + P[:, None, None, :, 3]
    z = cam[..., 2:3] + 1e-7
    u = cam[..., 0:1] / z
    v = cam[..., 1:2] / z
    return torch.cat([(u / (W - 1) - 0.5) * 2.0, (v / (H - 1) - 0.5) * 2.0], -1)


def warp(source: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of ``source`` [B, H, W, C] at ``grid``, border padding."""
    out = F.grid_sample(source.permute(0, 3, 1, 2), grid, mode="bilinear",
                        padding_mode="border", align_corners=True)
    return out.permute(0, 2, 3, 1)


def upsample(x: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Bilinear resize of NHWC ``x`` to H x W, half-pixel centres."""
    if x.shape[1:3] == (H, W):
        return x
    out = F.interpolate(x.permute(0, 3, 1, 2), size=(H, W), mode="bilinear",
                        align_corners=False)
    return out.permute(0, 2, 3, 1)


def disp_to_depth(disp: torch.Tensor, min_depth: float, max_depth: float) -> torch.Tensor:
    lo, hi = 1.0 / max_depth, 1.0 / min_depth
    return 1.0 / (lo + (hi - lo) * disp)


# --- photometric terms -----------------------------------------------------

def reprojection(pred: torch.Tensor, target: torch.Tensor, ssim_ratio: float) -> torch.Tensor:
    """[B, H, W, C] x 2 -> [B, H, W, 1]: ssim_ratio * mean_c SSIM loss +
    (1 - ssim_ratio) * mean_c L1."""
    x = F.pad(pred.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    y = F.pad(target.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    pool = lambda t: F.avg_pool2d(t, 3, 1)  # noqa: E731
    mx, my = pool(x), pool(y)
    sx = pool(x * x) - mx * mx
    sy = pool(y * y) - my * my
    sxy = pool(x * y) - mx * my
    n = (2 * mx * my + SSIM_C1) * (2 * sxy + SSIM_C2)
    d = (mx * mx + my * my + SSIM_C1) * (sx + sy + SSIM_C2)
    ssim = torch.clamp((1 - n / d) * 0.5, 0, 1).mean(1, keepdim=True).permute(0, 2, 3, 1)
    l1 = (target - pred).abs().mean(-1, keepdim=True)
    return ssim_ratio * ssim + (1 - ssim_ratio) * l1


def edge_smoothness(x: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    """Per row: mean |dx x| exp(-mean_c |dx img|) + the same along y, [B]."""
    gx = (x[:, :, :-1] - x[:, :, 1:]).abs() * torch.exp(
        -(img[:, :, :-1] - img[:, :, 1:]).abs().mean(-1, keepdim=True))
    gy = (x[:, :-1] - x[:, 1:]).abs() * torch.exp(
        -(img[:, :-1] - img[:, 1:]).abs().mean(-1, keepdim=True))
    return gx.mean(dim=(1, 2, 3)) + gy.mean(dim=(1, 2, 3))


# --- VO --------------------------------------------------------------------

def vo_loss_rows(
    disps: Sequence[torch.Tensor],
    T_left: torch.Tensor,
    T_right: torch.Tensor,
    batch: Dict[str, torch.Tensor],
    noise: Sequence[torch.Tensor],
    cfg: Dict,
) -> torch.Tensor:
    """The VO loss of the rows given, summed over them (the batch's loss is
    this sum over all rows divided by the batch size)."""
    target = batch["target_image"]
    B, H, W, _ = target.shape
    identity = torch.cat([reprojection(batch["source_left"], target, cfg["ssim_ratio"]),
                          reprojection(batch["source_right"], target, cfg["ssim_ratio"])], -1)
    total = 0.0
    for s, disp in enumerate(disps):
        disp_up = upsample(disp, H, W)
        points = backproject(disp_to_depth(disp_up, cfg["min_depth"], cfg["max_depth"]),
                             batch["inv_K"])
        reproj = torch.cat([
            reprojection(warp(batch[key], project(points, batch["K"], T)), target,
                         cfg["ssim_ratio"])
            for key, T in (("source_left", T_left), ("source_right", T_right))], -1)
        combined = torch.cat([identity + noise[s] * 1e-5, reproj], -1) \
            if cfg["auto_mask"] else reproj
        per_row = combined.min(-1).values.mean(dim=(1, 2))
        mean = disp_up.mean(dim=(1, 2), keepdim=True).clamp(min=1e-3)
        smooth = edge_smoothness(disp_up / (mean + 1e-7), target)
        total = total + (per_row + cfg["smoothness_ratio"] * smooth / 2**s).sum()
    return total / len(disps)


# --- supervised depth ------------------------------------------------------

def depth_loss_sums(
    disps: Sequence[torch.Tensor], batch: Dict[str, torch.Tensor], cfg: Dict
) -> List[torch.Tensor]:
    """Per scale: the valid count, sum of d and sum of d^2 (d the log-depth
    error over the valid pixels), and the summed per-row smoothness, over
    the rows given."""
    rgb, gt, valid = batch["image"], batch["depth"], batch["valid_mask"] > 0.5
    H, W = gt.shape[1:3]
    out = []
    for disp in disps:
        pred = upsample(disp_to_depth(disp, cfg["min_depth"], cfg["max_depth"]), H, W)
        d = torch.where(valid, torch.log(pred.clamp(min=1e-6)) - torch.log(gt.clamp(min=1e-6)),
                        0.0)
        mean = pred.mean(dim=(1, 2), keepdim=True).clamp(min=1e-7)
        out.append(torch.stack([valid.float().sum(), d.sum(), (d * d).sum(),
                                edge_smoothness(pred / mean, rgb).sum()]))
    return out


def depth_loss_from_sums(sums: Sequence[torch.Tensor], B: int, cfg: Dict) -> torch.Tensor:
    """The supervised loss of a batch of ``B`` rows from its per-scale sums."""
    silog = smooth = 0.0
    for alpha, s in zip(cfg["alphas"], sums):
        n = s[0].clamp(min=1.0)
        var = s[2] / n - cfg["variance_focus"] * (s[1] / n) ** 2
        silog = silog + alpha * torch.sqrt(var.clamp(min=1e-6))
        smooth = smooth + alpha * s[3] / B
    return cfg["silog_weight"] * silog + cfg["smooth_weight"] * smooth
