"""Color jitter on the device, inside the train step (port of
``training/augment.py``).

Per sample, one set of factors (brightness, contrast, saturation, hue) and a
p=0.5 gate are drawn and applied identically to the snippet's three frames,
with the host jitter's order and formulas. The factors come from an explicit
``torch.Generator``: they are other random numbers than JAX's, with the same
distributions, so parity is held on :func:`apply_color_jitter` with given
factors.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """[..., 3] RGB in [0, 1] -> HSV with H in degrees [0, 360)
    (``cv2.cvtColor(f32, COLOR_RGB2HSV)``'s convention)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    c = maxc - minc
    safe_c = torch.where(c > 0, c, 1.0)
    h = torch.where(
        maxc == r,
        (g - b) / safe_c % 6.0,
        torch.where(maxc == g, (b - r) / safe_c + 2.0, (r - g) / safe_c + 4.0),
    )
    h = torch.where(c > 0, h * 60.0, 0.0)
    s = torch.where(maxc > 0, c / torch.where(maxc > 0, maxc, 1.0), 0.0)
    return torch.stack([h, s, maxc], dim=-1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`rgb_to_hsv` (H in degrees)."""
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    h6 = (h / 60.0) % 6.0
    i = torch.floor(h6)
    f = h6 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))

    def select(choices, default):
        out = default
        for k in range(4, -1, -1):
            out = torch.where(i == k, choices[k], out)
        return out

    r = select([v, q, p, p, t], v)
    g = select([t, v, v, q, p], p)
    b = select([p, p, t, v, v], q)
    return torch.stack([r, g, b], dim=-1)


def apply_color_jitter(images: torch.Tensor, b, c, s, h) -> torch.Tensor:
    """Jitter a stack ``[..., N, H, W, 3]`` by factors b, c, s, h (numbers,
    or tensors of the leading shape ``[...]``, one set per stack).

    Brightness scale, contrast about each frame's mean, saturation about
    luma, hue rotation in HSV degrees (only where |h| > 1e-6), clipping
    between stages as the host jitter does.
    """
    def per_stack(f):
        f = torch.as_tensor(f, dtype=images.dtype, device=images.device)
        return f.reshape(f.shape + (1,) * 4)

    b, c, s, h = (per_stack(f) for f in (b, c, s, h))
    out = images * b
    mean = out.mean(dim=(-3, -2, -1), keepdim=True)
    out = (out - mean) * c + mean
    gray = 0.299 * out[..., 0:1] + 0.587 * out[..., 1:2] + 0.114 * out[..., 2:3]
    out = (out - gray) * s + gray
    out = torch.clamp(out, 0.0, 1.0)

    hsv = rgb_to_hsv(out)
    hue = (hsv[..., 0] + h[..., 0] * 360.0) % 360.0
    rotated = hsv_to_rgb(torch.stack([hue, hsv[..., 1], hsv[..., 2]], dim=-1))
    out = torch.where(h.abs() > 1e-6, rotated, out)
    return torch.clamp(out, 0.0, 1.0)


def draw_jitter_factors(
    n: int,
    generator: torch.Generator | None = None,
    device=None,
    brightness: float = 0.3,
    contrast: float = 0.3,
    saturation: float = 0.3,
    hue: float = 0.2,
) -> Tuple[torch.Tensor, ...]:
    """``n`` draws of (apply?, b, c, s, h) with the host jitter's
    distributions: factors uniform in [max(0, 1-x), 1+x], hue uniform in
    [-hue, hue], the gate true with p=0.5."""

    def uniform(lo: float, hi: float) -> torch.Tensor:
        u = torch.rand(n, generator=generator, device=device)
        return lo + (hi - lo) * u

    b = uniform(max(0.0, 1 - brightness), 1 + brightness)
    c = uniform(max(0.0, 1 - contrast), 1 + contrast)
    s = uniform(max(0.0, 1 - saturation), 1 + saturation)
    h = uniform(-hue, hue)
    gate = torch.rand(n, generator=generator, device=device) < 0.5
    return gate, b, c, s, h


def batch_snippet_jitter(
    batch: Dict[str, torch.Tensor], generator: torch.Generator | None = None
) -> Dict[str, torch.Tensor]:
    """Jitter source_left / target_image / source_right identically per
    sample (one draw per snippet, gated with p=0.5). Returns a new batch
    dict; the other keys pass through."""
    triplet = torch.stack(
        [batch["source_left"], batch["target_image"], batch["source_right"]],
        dim=1,
    )  # [B, 3, H, W, C]
    gate, b, c, s, h = draw_jitter_factors(
        triplet.shape[0], generator, triplet.device
    )
    jittered = torch.where(
        gate.reshape(-1, 1, 1, 1, 1), apply_color_jitter(triplet, b, c, s, h), triplet
    )
    out = dict(batch)
    out["source_left"] = jittered[:, 0]
    out["target_image"] = jittered[:, 1]
    out["source_right"] = jittered[:, 2]
    return out
