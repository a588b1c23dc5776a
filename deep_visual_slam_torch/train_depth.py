"""Supervised metric-depth training (port of ``train_depth.py``).

    python3 -m deep_visual_slam_torch.train_depth --config configs/depth.yaml

Trains on the card unless ``--device cpu``; resumes from the newest
checkpoint under ``<Directory.weights>/depth_<experiment_name>``. On N
cards: ``torchrun --nproc_per_node N -m deep_visual_slam_torch.train_depth
--config ...`` (``Train.batch_size`` is the global batch). The data are
the config's NYU/Redwood file trees (``data/nyu.py``, read with cv2); from
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
    parser.add_argument("--no_mesh", action="store_true",
                        help="no data parallelism over a torchrun process group")
    args = parser.parse_args(argv)

    import torch.distributed as dist

    from deep_visual_slam_torch.training.depth_trainer import Trainer
    from deep_visual_slam_torch.utils.config import load_config

    Trainer(load_config(args.config), device=args.device, use_mesh=not args.no_mesh).train()
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
