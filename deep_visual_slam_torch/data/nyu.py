"""Supervised-depth datasets and their loaders (port of ``data/nyu.py``).

``DepthLoader`` assembles the config-gated sources (``Dataset.nyu_depth_v2``
and ``Dataset.redwood_depth``) into a shuffled train loader and an ordered
valid loader, both dropping the last partial batch. The sources read RGB
JPEGs and 16-bit depth PNGs, which needs an image decoder the port does not
have yet (ROADMAP.md §1, item 1f): :func:`nyu_dataset` raises, and a caller
hands ``DepthLoader`` its own :class:`DepthSampleDataset` subclasses
instead.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

from deep_visual_slam_torch.data.base import DepthSampleDataset
from deep_visual_slam_torch.data.loader import ConcatDataset, DataLoader


def nyu_dataset(
    root_dir: str,
    split: str,
    image_size: Tuple[int, int],
    max_depth: float,
    is_train: bool,
) -> DepthSampleDataset:
    """The ``<root>/<split>`` tree of paired ``rgb``/``depth`` files (depth
    in millimetres). Not ported yet: raises."""
    raise NotImplementedError(
        f"{os.path.join(root_dir, split)}: the NYU/Redwood file readers need an "
        "image decoder and are not ported yet (ROADMAP.md §1, item 1f); pass "
        "DepthLoader(config, train_dataset, valid_dataset) instead"
    )


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
