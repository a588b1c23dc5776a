"""Supervised-depth evaluation (port of ``eval_depth_cli.py``).

    python3 -m deep_visual_slam_torch.eval_depth_cli --config configs/depth.yaml \
        [--weights <checkpoint dir or params-only file>] \
        [--output results/depth_eval.csv] [--device cpu]

Streams the validation split through DepthNet in the config's compute dtype
and writes one CSV row (``samples``, then the seven metrics of
:class:`DepthMetrics` and ``abs_diff``/``abs_log``). Without ``--weights``
the network keeps its random initialization (seed 0). The config's
NYU/Redwood file sources are not ported yet (ROADMAP.md §1, item 1f);
:func:`evaluate` takes any loader of depth batches.
"""

from __future__ import annotations

import argparse
import csv
import os
from typing import Dict, Iterable, Tuple

import torch

from deep_visual_slam_torch import resolve_device
from deep_visual_slam_torch.data.loader import device_prefetch
from deep_visual_slam_torch.eval.metrics import DepthMetrics
from deep_visual_slam_torch.ops.depth import disp_to_depth
from deep_visual_slam_torch.utils.checkpoint import load_network_states, network_state


def load_depth_weights(model: torch.nn.Module, path: str) -> None:
    """DepthNet weights from a trainer's checkpoint directory (its newest
    checkpoint) or a params-only file (``{"depth": state_dict}`` or a bare
    ``state_dict``)."""
    model.load_state_dict(network_state(load_network_states(path)[0], "depth"))


def evaluate(
    depth_model: torch.nn.Module,
    loader: Iterable[Dict],
    min_depth: float,
    max_depth: float,
    compute_dtype: torch.dtype = torch.bfloat16,
    device=None,
) -> Tuple[int, Dict[str, float]]:
    """``(samples, metrics)`` of ``depth_model`` (moved to ``device``, in
    eval mode) over ``loader``'s batches of ``image``, ``depth`` and
    ``valid_mask``: the depth at scale 0 against the labels."""
    device = resolve_device(device)
    depth_model.to(device).eval()
    metrics = DepthMetrics(min_depth=min_depth, max_depth=max_depth)
    n = 0
    for batch in device_prefetch(loader, device):
        with torch.inference_mode():
            with torch.autocast(device.type, compute_dtype,
                                enabled=compute_dtype != torch.float32):
                disp = depth_model(batch["image"])[("disp", 0)]
            _, depth = disp_to_depth(disp.float(), min_depth, max_depth)
        metrics.update(depth, batch["depth"], batch["valid_mask"])
        n += batch["image"].shape[0]
    return n, metrics.result()


def write_csv(path: str, samples: int, result: Dict[str, float]) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    row = {"samples": samples, **result}
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(row))
        writer.writeheader()
        writer.writerow(row)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Depth metric evaluation")
    parser.add_argument("--config", default=None)
    parser.add_argument("--weights", default=None,
                        help="a trainer checkpoint directory or a params-only file")
    parser.add_argument("--output", default="results/depth_eval.csv")
    parser.add_argument("--device", default=None,
                        help="torch device (default: CUDA, which must be present)")
    args = parser.parse_args(argv)

    from deep_visual_slam_torch.data.nyu import DepthLoader
    from deep_visual_slam_torch.training.state import init_depth_model
    from deep_visual_slam_torch.utils.config import load_config

    device = resolve_device(args.device)
    config = load_config(args.config)
    t = config["Train"]
    model = init_depth_model(0)
    if args.weights:
        load_depth_weights(model, args.weights)
    loader = DepthLoader(config)
    if len(loader.valid_dataset) == 0:
        parser.error("no validation data found; check Dataset flags/data_dir")
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        t.get("compute_dtype", "bfloat16")
    ]
    n, result = evaluate(model, loader.valid_loader, t["min_depth"], t["max_depth"],
                         dtype, device)
    write_csv(args.output, n, result)
    print(f"evaluated {n} samples")
    for k, v in result.items():
        print(f"  {k}: {v:.4f}")


if __name__ == "__main__":
    main()
