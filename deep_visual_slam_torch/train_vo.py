"""Self-supervised VO training (port of ``train_vo.py``).

    python3 -m deep_visual_slam_torch.train_vo --config configs/vo_fixture_640.yaml

Trains on the card unless ``--device cpu``; resumes from the newest
checkpoint under ``<Directory.weights>/<experiment_name>``. Packed scenes
for ``Dataset.packed`` come from ``python3 -m
deep_visual_slam_torch.pack_dataset``.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="VO self-supervised training")
    parser.add_argument("--config", default=None, help="YAML config path")
    parser.add_argument("--data_root", default=None,
                        help="replaces Directory.data_dir (the default packed root's parent)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: CUDA, which must be present)")
    args = parser.parse_args(argv)

    from deep_visual_slam_torch.training.vo_trainer import Trainer
    from deep_visual_slam_torch.utils.config import load_config

    trainer = Trainer(load_config(args.config), data_root=args.data_root, device=args.device)
    trainer.train()


if __name__ == "__main__":
    main()
