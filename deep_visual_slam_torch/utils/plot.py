"""Image panels for the metrics writer (port of ``utils/plot.py``): the VO
panel [target | warped left | warped right | disparity] and the depth panel
[RGB | prediction | ground truth], with matplotlib's magma colormap,
imported where it is used."""

from __future__ import annotations

from typing import Dict

import numpy as np


def colorize_disparity(disp: np.ndarray) -> np.ndarray:
    """[H, W] or [H, W, 1] disparity -> [H, W, 3] fp32 magma colours of its
    2-98 percentile range."""
    import matplotlib.cm as cm

    d = np.asarray(disp)
    if d.ndim == 3:
        d = d[..., 0]
    lo, hi = np.percentile(d, 2), np.percentile(d, 98)
    d = np.clip((d - lo) / max(hi - lo, 1e-6), 0, 1)
    return cm.magma(d)[..., :3].astype(np.float32)


def vo_panel(batch: Dict, outputs: Dict, index: int = 0) -> np.ndarray:
    """[target | warped left | warped right | disparity] of sample
    ``index`` as one uint8 row, from the host arrays of a batch and of the
    eval step's outputs (``color_left_0``, ``color_right_0``, ``disp_0``)."""
    target = np.asarray(batch["target_image"][index])
    warped_l = np.asarray(outputs["color_left_0"][index])
    warped_r = np.asarray(outputs["color_right_0"][index])
    disp = colorize_disparity(np.asarray(outputs["disp_0"][index]))
    row = np.concatenate([np.clip(x, 0, 1) for x in (target, warped_l, warped_r, disp)], axis=1)
    return (row * 255).astype(np.uint8)


def depth_panel(
    image: np.ndarray, pred_depth: np.ndarray, gt_depth: np.ndarray, max_depth: float = 10.0,
) -> np.ndarray:
    """[RGB | predicted depth | ground-truth depth] as one uint8 row, the
    depths in magma over [0, ``max_depth``]."""
    import matplotlib.cm as cm

    def cmap(d):
        d = np.asarray(d)
        if d.ndim == 3:
            d = d[..., 0]
        return cm.magma(np.clip(d / max_depth, 0, 1))[..., :3]

    row = np.concatenate(
        [np.clip(np.asarray(image), 0, 1), cmap(pred_depth), cmap(gt_depth)], axis=1
    )
    return (row * 255).astype(np.uint8)
