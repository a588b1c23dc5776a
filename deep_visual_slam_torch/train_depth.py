"""Supervised metric-depth training (port of ``train_depth.py``).

    python3 -m deep_visual_slam_torch.train_depth --config configs/depth.yaml

Trains on the card unless ``--device cpu``; resumes from the newest
checkpoint under ``<Directory.weights>/depth_<experiment_name>``. The
config's NYU/Redwood file sources are not ported yet (they need an image
decoder, ROADMAP.md §1, item 1f) and raise ``NotImplementedError``; from
Python, ``Trainer(config, data_loader=DepthLoader(config, train, valid))``
trains on datasets of one's own.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Supervised depth training")
    parser.add_argument("--config", default=None, help="YAML config path")
    parser.add_argument("--device", default=None,
                        help="torch device (default: CUDA, which must be present)")
    args = parser.parse_args(argv)

    from deep_visual_slam_torch.training.depth_trainer import Trainer
    from deep_visual_slam_torch.utils.config import load_config

    Trainer(load_config(args.config), device=args.device).train()


if __name__ == "__main__":
    main()
