"""Supervised-depth datasets and their loaders (port of ``data/nyu.py``).

``DepthLoader`` assembles the config-gated sources (``Dataset.nyu_depth_v2``
and ``Dataset.redwood_depth``) into a shuffled train loader and an ordered
valid loader, both dropping the last partial batch. The sources are trees
of RGB images and 16-bit depth PNGs in millimetres (:func:`nyu_dataset`);
a caller may hand ``DepthLoader`` datasets of its own instead.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Optional, Tuple

from deep_visual_slam_torch.data.base import ConcatDataset, PathDepthDataset
from deep_visual_slam_torch.data.loader import DataLoader


def _paired_files(split_dir: str, rgb_glob: str, depth_glob: str):
    rgbs = sorted(glob.glob(os.path.join(split_dir, rgb_glob)))
    depths = sorted(glob.glob(os.path.join(split_dir, depth_glob)))
    n = min(len(rgbs), len(depths))
    return rgbs[:n], depths[:n]


def nyu_dataset(
    root_dir: str,
    split: str,
    image_size: Tuple[int, int],
    max_depth: float,
    is_train: bool,
) -> Optional[PathDepthDataset]:
    """The ``<root>/<split>`` tree of paired files, ``rgb/*`` and ``depth/*``
    or flat ``rgb_*`` and ``depth_*``, paired in name order (depth in
    millimetres); ``None`` when the split has no directory or no pairs."""
    split_dir = os.path.join(root_dir, split)
    if not os.path.isdir(split_dir):
        return None
    if os.path.isdir(os.path.join(split_dir, "rgb")):
        rgbs, depths = _paired_files(split_dir, "rgb/*", "depth/*")
    else:
        rgbs, depths = _paired_files(split_dir, "rgb_*", "depth_*")
    if not rgbs:
        return None
    return PathDepthDataset(rgbs, depths, image_size, max_depth=max_depth,
                            is_train=is_train, augment=is_train, depth_scale=1000.0)


class DepthLoader:
    """``train_loader`` and ``valid_loader`` over the supervised-depth data.

    With ``train_dataset``/``valid_dataset`` given, those are the data and
    the config's sources are not read; otherwise the enabled sources under
    ``Directory.data_dir`` (``nyu_depth_v2/{train,test}``,
    ``redwood/{train,validation}``) are concatenated.
    """

    def __init__(self, config: Dict, train_dataset=None, valid_dataset=None):
        t = config["Train"]
        if train_dataset is None and valid_dataset is None:
            image_size = (t["img_h"], t["img_w"])
            max_depth = t["max_depth"]
            data_dir = config["Directory"]["data_dir"]
            ds_cfg = config.get("Dataset", {})
            train_sets, valid_sets = [], []
            for flag, sub, valid_split in (
                ("nyu_depth_v2", "nyu_depth_v2", "test"),
                ("redwood_depth", "redwood", "validation"),
            ):
                if ds_cfg.get(flag, False):
                    root = os.path.join(data_dir, sub)
                    train_sets.append(nyu_dataset(root, "train", image_size, max_depth, True))
                    valid_sets.append(
                        nyu_dataset(root, valid_split, image_size, max_depth, False)
                    )
            train_dataset, valid_dataset = ConcatDataset(train_sets), ConcatDataset(valid_sets)
        self.train_dataset = train_dataset if train_dataset is not None else ConcatDataset([])
        self.valid_dataset = valid_dataset if valid_dataset is not None else ConcatDataset([])

        workers, seed = t.get("num_workers", 8), t.get("seed", 42)
        self.train_loader = DataLoader(
            self.train_dataset, t["batch_size"], shuffle=t.get("use_shuffle", True),
            drop_last=True, num_workers=workers, seed=seed,
        )
        self.valid_loader = DataLoader(
            self.valid_dataset, t["batch_size"], shuffle=False, drop_last=True,
            num_workers=workers, seed=seed,
        )
