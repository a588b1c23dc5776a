"""Offline Redwood trajectory evaluation of PoseNet (port of
``eval_redwood_cli.py``).

    python3 -m deep_visual_slam_torch.eval_redwood_cli --config configs/vo.yaml \
        [--weights <checkpoint dir or params-only file>] [--data_root <redwood>] \
        [--output results/redwood] [--scenes apartment ...] \
        [--no_scale_correction] [--device cpu]

Writes ``{scene}_pairs.csv`` per scene and ``summary.json`` (the list of the
scenes' result dicts) under ``--output`` and prints one line a scene.
Without ``--weights`` PoseNet keeps its random initialization (seed 0).
The port has no image decoder, so from the command line it raises
``NotImplementedError`` (``ROADMAP.md`` §1, item 1f) once a scene's frames
are to be read; :func:`evaluate_redwood` takes a ``read_image`` function.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deep_visual_slam_torch import resolve_device
from deep_visual_slam_torch.data.redwood import TEST_SCENES
from deep_visual_slam_torch.eval.redwood_eval import RedwoodEvaluator, make_pose_fn
from deep_visual_slam_torch.utils.checkpoint import load_network_states, network_state


def load_pose_weights(model: torch.nn.Module, path: str) -> None:
    """PoseNet weights from a trainer's checkpoint directory (its newest
    checkpoint) or a params-only file (``{"pose": state_dict}`` or a bare
    ``state_dict``)."""
    model.load_state_dict(network_state(load_network_states(path)[0], "pose"))


def evaluate_redwood(
    pose_model: torch.nn.Module,
    data_root: str,
    image_size: Tuple[int, int],
    output: str,
    scenes: Sequence[str] = TEST_SCENES,
    use_scale_correction: bool = True,
    read_image: Optional[Callable[[str, int, int], np.ndarray]] = None,
    device=None,
) -> List[Dict]:
    """Evaluate ``pose_model`` on ``data_root``'s test scenes, write the CSVs
    and ``summary.json`` under ``output``, print a line a scene; returns the
    results."""
    pose_fn = make_pose_fn(pose_model, invert=True, device=device)
    evaluator = RedwoodEvaluator(pose_fn, data_root, image_size=image_size,
                                 read_image=read_image)
    results = evaluator.evaluate(scenes=scenes, output_dir=output,
                                 use_scale_correction=use_scale_correction)
    os.makedirs(output, exist_ok=True)
    with open(os.path.join(output, "summary.json"), "w") as f:
        json.dump(results, f, indent=2, default=float)
    for r in results:
        print(
            f"{r['scene']}: ATE {r['ate_rmse']:.4f} m, "
            f"RPE {r['rpe_pos_mean']:.4f} m / {r['rpe_rot_mean_deg']:.3f} deg, "
            f"scale {r['scale_factor']:.3f}"
        )
    return results


def main(argv=None) -> List[Dict]:
    parser = argparse.ArgumentParser(description="Redwood trajectory eval")
    parser.add_argument("--config", default=None)
    parser.add_argument("--weights", default=None,
                        help="a VO trainer checkpoint directory or a params-only file")
    parser.add_argument("--data_root", default=None)
    parser.add_argument("--output", default="results/redwood")
    parser.add_argument("--scenes", nargs="*", default=None)
    parser.add_argument("--no_scale_correction", action="store_true")
    parser.add_argument("--device", default=None,
                        help="torch device (default: CUDA, which must be present)")
    args = parser.parse_args(argv)

    from deep_visual_slam_torch.models import PoseNet
    from deep_visual_slam_torch.utils.config import load_config

    device = resolve_device(args.device)
    config = load_config(args.config)
    t = config["Train"]
    root = args.data_root or os.path.join(config["Directory"]["data_dir"], "redwood")
    pose_model = PoseNet(generator=torch.Generator().manual_seed(0))
    if args.weights:
        load_pose_weights(pose_model, args.weights)
    return evaluate_redwood(
        pose_model, root, (t["img_h"], t["img_w"]), args.output,
        scenes=args.scenes or TEST_SCENES,
        use_scale_correction=not args.no_scale_correction, device=device,
    )


if __name__ == "__main__":
    main()
