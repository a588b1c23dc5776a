"""Redwood RGB-D scenes as VO snippets (port of ``data/redwood.py``).

A scene is ``<root>/<fold>/<scene>/image/*.jpg`` with its camera-to-world
trajectory in ``<root>/<fold>/<scene>/<scene>.json`` (an Open3D PoseGraph)
and the camera in ``<root>/intrinsic.npy``. The folds are ``train``,
``validation`` and ``test``; a scene that does not load is skipped with a
warning, and in evaluation a snippet carries the ground-truth relative
poses ``inv(T1) @ T2``.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from deep_visual_slam_torch.data.base import SCENE_ERRORS, ConcatDataset, PathSnippetDataset

REDWOOD_NATIVE_SIZE = (480, 640)  # (H, W)
# fx = fy = 525, cx = 319.5, cy = 239.5: the published Redwood camera.
REDWOOD_DEFAULT_K3 = np.array(
    [[525.0, 0.0, 319.5], [0.0, 525.0, 239.5], [0.0, 0.0, 1.0]], np.float32
)
TEST_SCENES = ("apartment", "bedroom", "boardroom", "lobby", "loft")


def load_posegraph_json(json_path: str) -> List[np.ndarray]:
    """Open3D PoseGraph JSON -> list of 4x4 camera-to-world poses. A node's
    16 values are column-major: reshaped with ``order="F"`` the translation
    is the last column."""
    with open(json_path) as f:
        data = json.load(f)
    return [
        np.asarray(node["pose"], np.float32).reshape(4, 4, order="F")
        for node in data.get("nodes", [])
    ]


def load_intrinsic(root_dir: str, image_size: Tuple[int, int]) -> np.ndarray:
    """``<root_dir>/intrinsic.npy`` (3x3; the published camera when the file
    is absent) scaled from the native 480x640 to ``image_size`` (H, W) and
    lifted to 4x4."""
    path = os.path.join(root_dir, "intrinsic.npy")
    K3 = np.load(path) if os.path.exists(path) else REDWOOD_DEFAULT_K3
    H0, W0 = REDWOOD_NATIVE_SIZE
    H, W = image_size
    K4 = np.eye(4, dtype=np.float32)
    K4[0, 0] = K3[0, 0] * W / W0
    K4[1, 1] = K3[1, 1] * H / H0
    K4[0, 2] = K3[0, 2] * W / W0
    K4[1, 2] = K3[1, 2] * H / H0
    return K4


def load_scene(
    scene_dir: str,
    scene_name: str,
    intrinsic: np.ndarray,
    image_size: Tuple[int, int],
    is_train: bool,
    augment: bool,
) -> PathSnippetDataset:
    """One scene as a :class:`PathSnippetDataset`, its frames cut to the
    number of poses."""
    image_files = sorted(glob.glob(os.path.join(scene_dir, "image", "*.jpg")))
    poses = load_posegraph_json(os.path.join(scene_dir, f"{scene_name}.json"))
    n = min(len(image_files), len(poses))
    if n == 0:
        raise ValueError(f"scene {scene_name}: no frames/poses")
    return PathSnippetDataset(
        rgb_paths=image_files[:n],
        intrinsic=intrinsic,
        image_size=image_size,
        is_train=is_train,
        augment=augment,
        poses=poses[:n],
    )


class RedwoodDataset(ConcatDataset):
    """The scenes of one fold, in name order, concatenated (``datasets``,
    their names in ``scene_names``); scenes without snippets are left
    out."""

    def __init__(
        self,
        root_dir: str,
        fold: str,
        image_size: Tuple[int, int],
        is_train: bool = True,
        augment: bool = True,
    ):
        scenes: List[PathSnippetDataset] = []
        self.scene_names: List[str] = []
        fold_dir = os.path.join(root_dir, fold)
        names = sorted(os.listdir(fold_dir)) if os.path.isdir(fold_dir) else []
        intrinsic = load_intrinsic(root_dir, image_size)
        for scene in names:
            scene_dir = os.path.join(fold_dir, scene)
            if not os.path.isdir(scene_dir):
                continue
            try:
                ds = load_scene(scene_dir, scene, intrinsic, image_size, is_train, augment)
            except SCENE_ERRORS as e:
                print(f"Warning: skipping Redwood scene '{scene}': {e}")
                continue
            if len(ds) > 0:
                scenes.append(ds)
                self.scene_names.append(scene)
        super().__init__(scenes)


class RedwoodDataHandler:
    """The three folds under ``root_dir`` (default
    ``<Directory.data_dir>/redwood``) when ``Dataset.redwood.mono`` is on;
    training augments, validation and test do not."""

    def __init__(self, config: Dict, root_dir: Optional[str] = None):
        t = config["Train"]
        image_size = (t["img_h"], t["img_w"])
        self.root_dir = root_dir or os.path.join(config["Directory"]["data_dir"], "redwood")
        self.train_dataset = self.valid_dataset = self.test_dataset = None
        if not config["Dataset"].get("redwood", {}).get("mono", False):
            return
        self.train_dataset = RedwoodDataset(self.root_dir, "train", image_size, True, True)
        self.valid_dataset = RedwoodDataset(self.root_dir, "validation", image_size, False, False)
        self.test_dataset = RedwoodDataset(self.root_dir, "test", image_size, False, False)
