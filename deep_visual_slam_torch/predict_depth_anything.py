"""Depth-Anything-V2 metric depth on images (port of
``predict_depth_anything.py``).

    python3 -m deep_visual_slam_torch.predict_depth_anything \\
        --weights depth_anything_v2_vits.pth --encoder vits \\
        --input img_or_dir [--output results/depth_anything] [--max_depth 20] \\
        [--colormap]

Loads a reference checkpoint (``.pth``) or the JAX package's ``.npz`` cache
of one, pads each frame with zeros to the 14-pixel patch grid, runs the
model (bf16 under autocast on the card, as the JAX CLI runs bfloat16; fp32
with ``--device cpu``, the plain path), crops, and writes
``<output>/<stem>_depth.png``: depth in millimetres, 16-bit, written by
``utils/png.py``; with ``--colormap`` also ``<stem>_depth_vis.png``, the
depth's min-max range in cv2's MAGMA map. Frames are read by
:func:`read_rgb` (cv2, imported there, as the JAX CLI reads them) or by a
caller's ``read_image(path) -> [H, W, 3] uint8 RGB`` (``main(read_image=...)``).
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Callable, List, Optional

import numpy as np
import torch


def infer_depth(model, rgb: np.ndarray, device: torch.device, dtype: torch.dtype) -> np.ndarray:
    """``rgb`` ([H, W, 3] uint8) -> metric depth [H, W] fp32 on the host:
    the frame over 255, zero-padded at the bottom and right to multiples of
    14, through ``model`` under autocast in ``dtype`` (none for fp32),
    cropped back."""
    from deep_visual_slam_torch.models.depth_anything import PATCH

    H, W = rgb.shape[:2]
    Hp = (H + PATCH - 1) // PATCH * PATCH
    Wp = (W + PATCH - 1) // PATCH * PATCH
    padded = np.zeros((Hp, Wp, 3), np.float32)
    padded[:H, :W] = rgb.astype(np.float32) / 255.0
    x = torch.from_numpy(padded).permute(2, 0, 1)[None].to(device)
    with torch.inference_mode(), torch.autocast(
        device.type, dtype, enabled=dtype != torch.float32
    ):
        depth = model(x)
    return depth[0, :H, :W].float().cpu().numpy()


def read_rgb(path: str) -> Optional[np.ndarray]:
    """The image file ``path`` as [H, W, 3] uint8 RGB; ``None`` when cv2
    cannot read it."""
    import cv2

    bgr = cv2.imread(path)
    return None if bgr is None else cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)


def write_colormap(path: str, depth: np.ndarray) -> None:
    """``depth`` [H, W] scaled to its min-max range, truncated to uint8 and
    written through cv2's MAGMA colormap as a PNG."""
    import cv2

    norm = (depth - depth.min()) / max(float(np.ptp(depth)), 1e-6)
    cv2.imwrite(path, cv2.applyColorMap((norm * 255).astype(np.uint8), cv2.COLORMAP_MAGMA))


def main(
    argv=None,
    read_image: Optional[Callable[[str], np.ndarray]] = None,
    device=None,
) -> List[str]:
    """The CLI; returns the depth PNGs written. ``device`` (or
    ``--device``) defaults to CUDA, which must be present; ``read_image``
    defaults to :func:`read_rgb`."""
    parser = argparse.ArgumentParser(description="Depth-Anything-V2 inference")
    parser.add_argument("--weights", required=True,
                        help=".pth torch checkpoint or cached .npz")
    parser.add_argument("--encoder", default="vits",
                        choices=["vits", "vitb", "vitl", "vitg"])
    parser.add_argument("--input", required=True, help="image file or dir")
    parser.add_argument("--output", default="results/depth_anything")
    parser.add_argument("--max_depth", type=float, default=20.0)
    parser.add_argument("--colormap", action="store_true",
                        help="also write a magma-colored visualization")
    parser.add_argument("--device", default=None,
                        help="torch device (default: CUDA, which must be present)")
    args = parser.parse_args(argv)

    from deep_visual_slam_torch import resolve_device
    from deep_visual_slam_torch.models.depth_anything import DepthAnythingV2
    from deep_visual_slam_torch.utils.png import write_png16
    from deep_visual_slam_torch.utils.pretrained import load_depth_anything_state_dict

    reader = read_image or read_rgb
    device = resolve_device(device if device is not None else args.device)
    if os.path.isdir(args.input):
        files = sorted(
            f for ext in ("*.jpg", "*.jpeg", "*.png")
            for f in glob.glob(os.path.join(args.input, ext))
        )
    else:
        files = [args.input]
    if not files:
        parser.error(f"no images under {args.input}")

    model = DepthAnythingV2(args.encoder, max_depth=args.max_depth)
    model.load_state_dict(load_depth_anything_state_dict(args.weights, args.encoder))
    model.to(device).eval()
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32

    os.makedirs(args.output, exist_ok=True)
    written = []
    for path in files:
        rgb = reader(path)
        if rgb is None:
            print(f"skipping unreadable {path}")
            continue
        depth = infer_depth(model, rgb, device, dtype)
        stem = os.path.splitext(os.path.basename(path))[0]
        out16 = os.path.join(args.output, f"{stem}_depth.png")
        write_png16(out16, (depth * 1000.0).astype(np.uint16))
        written.append(out16)
        if args.colormap:
            write_colormap(os.path.join(args.output, f"{stem}_depth_vis.png"), depth)
        print(f"{path}: depth [{depth.min():.2f}, {depth.max():.2f}] m -> {out16}")
    return written


if __name__ == "__main__":
    main()
