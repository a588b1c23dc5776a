"""The Redwood scene layout (port of ``data/redwood.py``'s file layout).

A scene is ``<root>/<fold>/<scene>/image/*.jpg`` with its camera-to-world
trajectory in ``<root>/<fold>/<scene>/<scene>.json`` (an Open3D PoseGraph)
and the camera in ``<root>/intrinsic.npy``. The training datasets over it
(``RedwoodDataset``/``RedwoodDataHandler``) decode images and come with the
path datasets (``ROADMAP.md`` §1, item 1f).
"""

from __future__ import annotations

import json
import os
from typing import List, Tuple

import numpy as np

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
