"""Convert a JAX trainer checkpoint into the PyTorch port's weights file.

    JAX_PLATFORMS=cpu python scripts/jax_checkpoint_to_torch.py \
        --ckpt <weights>/<experiment_name> --out weights/vo_port.pt \
        [--config configs/vo.yaml]

Run it where the JAX package and orbax are installed. It restores the newest
checkpoint of a JAX VO (``train_vo.py``) or supervised-depth
(``train_depth.py``) trainer run through the JAX package's own reader
(``deep_visual_slam_tpu/utils/checkpoint.py:load_latest_tree``), converts
the ``params`` and ``batch_stats`` of each network the checkpoint holds with
the port's ``depthnet_from_jax`` and ``posenet_from_jax``
(``deep_visual_slam_torch/utils/weights.py``; ``num_layers`` from the
config's ``Train.num_layers``, 18 without one), and writes
``{"depth": state_dict[, "pose": state_dict]}`` with the port's
``save_params_only``: the params-only file that
``deep_visual_slam_torch.eval_redwood_cli --weights``,
``deep_visual_slam_torch.eval_depth_cli --weights`` and
``Networks.from_checkpoint`` read.

The optimizer state and the update count are not carried (the two
trainers' optimizers differ in layout), so the file evaluates the networks
or starts a new port run from them; it does not resume the JAX run.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def convert(ckpt_dir: str, num_layers: int = 18) -> Dict:
    """The newest JAX trainer checkpoint under ``ckpt_dir`` as the port's
    ``{"depth": ..., "pose": ...}`` state_dicts (``pose`` for VO runs)."""
    from deep_visual_slam_tpu.utils.checkpoint import load_latest_tree

    from deep_visual_slam_torch.utils.weights import depthnet_from_jax, posenet_from_jax

    loaded = load_latest_tree(ckpt_dir)
    if loaded is None:
        raise FileNotFoundError(f"no JAX checkpoint under {ckpt_dir}")
    tree, step = loaded
    print(f"restored {ckpt_dir} @ step {step}")
    out = {}
    for name, fn in (("depth", depthnet_from_jax), ("pose", posenet_from_jax)):
        if name in tree["params"]:
            out[name] = fn({"params": tree["params"][name],
                            "batch_stats": tree["batch_stats"][name]}, num_layers)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", required=True, help="a JAX trainer's checkpoint directory")
    ap.add_argument("--out", required=True, help="the port's params-only file to write")
    ap.add_argument("--config", default=None, help="the run's config (for Train.num_layers)")
    args = ap.parse_args(argv)

    num_layers = 18
    if args.config:
        from deep_visual_slam_tpu.utils.config import load_config

        num_layers = load_config(args.config)["Train"].get("num_layers", 18)

    from deep_visual_slam_torch.utils.checkpoint import save_params_only

    states = convert(args.ckpt, num_layers)
    save_params_only(states, args.out)
    print(f"wrote {sorted(states)} (ResNet-{num_layers}) to {args.out}")


if __name__ == "__main__":
    main()
