"""Packed scenes: pre-resized uint8 memmap shards (port of ``data/packed.py``).

One directory per scene, in the JAX package's format, so that shards packed
by either package load in both::

  scene_dir/
    images.npy   uint8 [N, H, W, 3] (np.save; read with mmap_mode="r")
    meta.npz     intrinsic [4, 4] scaled to (H, W); optional poses
                 [N, 4, 4] (camera-to-world)

A training sample then costs three memmap row copies (and, on the fp32
path, one uint8 -> fp32 scale) instead of three image decodes.
``python -m deep_visual_slam_torch.pack_dataset`` writes synthetic scenes or
packs the path sources a config enables (:func:`pack_from_paths`).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from deep_visual_slam_torch.data.base import SnippetDataset, read_image_rgb

IMAGES = "images.npy"
META = "meta.npz"


def pack_scene(
    out_dir: str,
    frames_u8: np.ndarray,
    intrinsic: np.ndarray,
    poses: Optional[np.ndarray] = None,
) -> None:
    """Write one scene's shard (frames already at the target size)."""
    if frames_u8.dtype != np.uint8 or frames_u8.ndim != 4:
        raise ValueError(f"frames must be uint8 [N, H, W, 3], got {frames_u8.dtype} "
                         f"{frames_u8.shape}")
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, IMAGES), frames_u8)
    meta = {"intrinsic": np.asarray(intrinsic, np.float32)}
    if poses is not None:
        meta["poses"] = np.asarray(poses, np.float32)
    np.savez(os.path.join(out_dir, META), **meta)


def pack_from_paths(
    out_dir: str,
    rgb_paths,
    intrinsic: np.ndarray,
    image_size: Tuple[int, int],
    poses=None,
    chunk: int = 64,
) -> None:
    """Decode and resize a path-listed sequence into a shard, ``chunk``
    frames at a time through a memmap. A frame is stored as
    ``(read_image_rgb(...) * 255).astype(uint8)``, the JAX package's
    truncation, so that both packages write the same bytes."""
    H, W = image_size
    os.makedirs(out_dir, exist_ok=True)
    n = len(rgb_paths)
    out = np.lib.format.open_memmap(
        os.path.join(out_dir, IMAGES), mode="w+", dtype=np.uint8, shape=(n, H, W, 3)
    )
    for start in range(0, n, chunk):
        batch = [(read_image_rgb(p, H, W) * 255.0).astype(np.uint8)
                 for p in rgb_paths[start : start + chunk]]
        out[start : start + len(batch)] = np.stack(batch)
    out.flush()
    del out
    meta = {"intrinsic": np.asarray(intrinsic, np.float32)}
    if poses is not None:
        meta["poses"] = np.asarray(poses, np.float32)
    np.savez(os.path.join(out_dir, META), **meta)


def list_packed_scenes(root: str):
    """Sorted scene directories under ``root`` that hold a shard."""
    if not os.path.isdir(root):
        return []
    return sorted(
        os.path.join(root, d)
        for d in os.listdir(root)
        if os.path.exists(os.path.join(root, d, IMAGES))
        and os.path.exists(os.path.join(root, d, META))
    )


class PackedSnippetDataset(SnippetDataset):
    """:class:`SnippetDataset` over a shard: memmap frame IO, no decode."""

    def __init__(
        self,
        scene_dir: str,
        image_size: Tuple[int, int],
        is_train: bool = True,
        augment: bool = True,
        num_scales: int = 4,
    ):
        self.scene_dir = scene_dir
        self._images = np.load(os.path.join(scene_dir, IMAGES), mmap_mode="r")
        with np.load(os.path.join(scene_dir, META)) as meta:
            intrinsic = meta["intrinsic"]
            poses = meta["poses"] if "poses" in meta.files else None
        n, H, W = self._images.shape[:3]
        if (H, W) != tuple(image_size):
            raise ValueError(
                f"packed shard {scene_dir} is {(H, W)}, requested "
                f"{tuple(image_size)}: re-pack at the training resolution"
            )
        super().__init__(
            num_frames=n,
            intrinsic=intrinsic,
            image_size=image_size,
            is_train=is_train,
            augment=augment,
            poses=poses,
            num_scales=num_scales,
        )

    def _load_triplet(self, indices) -> np.ndarray:
        # One fancy-index read of the three rows, then one uint8 -> fp32 scale.
        return self._images[np.asarray(indices)].astype(np.float32) / 255.0

    def _load_triplet_u8(self, indices) -> np.ndarray:
        return self._images[np.asarray(indices)]

    def __getstate__(self):
        # A memmap does not pickle: reopen it on the other side.
        state = dict(self.__dict__)
        state["_images"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._images = np.load(os.path.join(self.scene_dir, IMAGES), mmap_mode="r")
