"""VO inference with trajectory integration and a 3D scene (port of
``predict.py``, the reference's ``vo/predict.py``).

    python3 -m deep_visual_slam_torch.predict --config configs/vo.yaml \\
        [--weights <checkpoint dir or params-only file>] [--data_root <redwood>] \\
        [--output results/predict] [--max_frames 200] [--pointcloud_every 10] \\
        [--device cpu]

Over the config's test split (``VoDataLoader``, batches of
``Train.vis_batch_size``, the first sample of each used): DepthNet on the
target frame, its disparity to metric depth in [``Train.min_depth``,
``Train.max_depth``], backprojected with the batch's ``inv_K``; PoseNet on
the pair (target, source_right), composed into the world pose
``world_T = world_T @ T``; every ``--pointcloud_every``-th frame's cloud
into the scene. Written under ``--output``: ``trajectory.npy`` ([N, 4, 4])
and ``scene.png`` (``utils/viz.py``, matplotlib). The networks run bf16
under autocast on the card, as the JAX CLI runs bfloat16, and fp32 with
``--device cpu``; without ``--weights`` they keep their random
initialization (seed 0).

:func:`run` is the loop over any iterable of batches; only the figure needs
matplotlib.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Iterable, Tuple

import numpy as np
import torch

from deep_visual_slam_torch import resolve_device
from deep_visual_slam_torch.ops import backproject, disp_to_depth, transformation_from_parameters


def load_models(weights, device: torch.device):
    """ResNet-18 DepthNet and PoseNet with weights from seed 0, replaced by
    ``weights`` (a VO trainer checkpoint directory or a params-only file of
    ``{"depth", "pose"}``) where given; on ``device``, in eval mode."""
    from deep_visual_slam_torch.training.state import init_vo_models
    from deep_visual_slam_torch.utils.checkpoint import load_network_states, network_state

    depth_model, pose_model = init_vo_models(0)
    if weights:
        tree, _ = load_network_states(weights)
        depth_model.load_state_dict(network_state(tree, "depth"))
        pose_model.load_state_dict(network_state(tree, "pose"))
    return depth_model.to(device).eval(), pose_model.to(device).eval()


@torch.inference_mode()
def infer(depth_model, pose_model, target: torch.Tensor, source_right: torch.Tensor,
          inv_K: torch.Tensor, min_depth: float, max_depth: float,
          dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depth on ``target`` backprojected to camera points [B, H, W, 3] and
    the relative pose [B, 4, 4] of the pair (target, source_right)."""
    with torch.autocast(target.device.type, dtype, enabled=dtype != torch.float32):
        disps = depth_model(target)
        aa, t = pose_model(torch.cat([target, source_right], dim=-1))
    _, depth = disp_to_depth(disps[("disp", 0)].float(), min_depth, max_depth)
    T = transformation_from_parameters(aa[:, 0, 0].float(), t[:, 0, 0].float())
    return backproject(depth[..., 0], inv_K), T


def run(batches: Iterable[Dict[str, torch.Tensor]], depth_model, pose_model, config: Dict,
        args, device=None):
    """The loop over ``batches`` (tensors on the networks' device) with the
    options of ``args``; writes ``trajectory.npy`` under ``--output`` and
    returns the ``Visualizer`` holding the poses and clouds."""
    from deep_visual_slam_torch.utils.viz import Visualizer

    device = resolve_device(device)
    t = config["Train"]
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    os.makedirs(args.output, exist_ok=True)
    viz = Visualizer(args.output)
    world_T = np.eye(4)
    n = 0
    for batch in batches:
        points, T = infer(depth_model, pose_model, batch["target_image"],
                          batch["source_right"], batch["inv_K"], t["min_depth"],
                          t["max_depth"], dtype)
        world_T = world_T @ T[0].cpu().numpy().astype(np.float64)
        viz.add_pose(world_T)
        if n % args.pointcloud_every == 0:
            viz.add_pointcloud(points[0].cpu().numpy(), batch["target_image"][0].cpu().numpy(),
                               world_T, stride=8)
        n += 1
        if n >= args.max_frames:
            break
    np.save(os.path.join(args.output, "trajectory.npy"), np.asarray(viz.poses))
    return viz


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="VO inference + visualization")
    p.add_argument("--config", default=None)
    p.add_argument("--weights", default=None,
                   help="a VO trainer checkpoint directory or a params-only file")
    p.add_argument("--data_root", default=None)
    p.add_argument("--output", default="results/predict")
    p.add_argument("--max_frames", type=int, default=200)
    p.add_argument("--pointcloud_every", type=int, default=10)
    p.add_argument("--device", default=None,
                   help="torch device (default: CUDA, which must be present)")
    return p


def main(argv=None):
    """The CLI; returns the ``Visualizer`` of the run."""
    from deep_visual_slam_torch.data.loader import VoDataLoader, device_prefetch
    from deep_visual_slam_torch.utils.config import load_config

    p = parser()
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    config = load_config(args.config)
    depth_model, pose_model = load_models(args.weights, device)
    loader = VoDataLoader(config, root_dir=args.data_root)
    if len(loader.test_dataset) == 0:
        p.error("no test data found; enable a dataset in the config "
                "(Dataset.redwood.mono or Dataset.synthetic.mono)")
    viz = run(device_prefetch(loader.test_loader, device), depth_model, pose_model, config,
              args, device)
    viz.render(os.path.join(args.output, "scene.png"))
    print(f"predicted {len(viz.poses)} frames -> {args.output}/scene.png, trajectory.npy")
    return viz


if __name__ == "__main__":
    main()
