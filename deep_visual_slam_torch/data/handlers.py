"""The other path sources: MarsLogger videos, the custom capture rig, IRS,
and known-baseline stereo pairs (port of ``data/handlers.py``).

- MarsLogger (phone capture): ``<scene>/movie.mp4`` is extracted once to
  ``<scene>/rgb/rgb_%06d.jpg``, each frame rotated 90 degrees
  counter-clockwise and resized; the calibration under
  ``<root>/calibration_results`` is rescaled with its axes swapped.
- The custom rig: ``rgb_left/*.jpg|png`` and
  ``sensor/left_intrinsics.npy`` at the first frame's native size; its
  stereo pairs take the baseline from ``sensor/stereo_parameters.json``.
- IRS: ``l_*.png`` or ``left/*`` frames with the dataset's fixed camera
  (fx = fy = 480, cx = 480, cy = 270 at 540x960) and a 10 cm baseline.
- :class:`StereoSnippetDataset`: both directed samples of every rectified
  pair, with the softer ColorJitter (0.2, 0.2, 0.2, 0.1).

cv2 is imported by the functions that decode or write video and images.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from deep_visual_slam_torch.data.base import (
    SCENE_ERRORS,
    ConcatDataset,
    PathSnippetDataset,
    color_jitter,
    read_image_rgb,
)

IRS_NATIVE_SIZE = (540, 960)
IRS_K3 = np.array([[480.0, 0.0, 480.0], [0.0, 480.0, 270.0], [0.0, 0.0, 1.0]], np.float32)
IRS_BASELINE_M = 0.1


def rescale_intrinsic_4x4(
    K3: np.ndarray, target_size: Tuple[int, int], current_size: Tuple[int, int]
) -> np.ndarray:
    """3x3 intrinsics at ``current_size`` (H, W) -> 4x4 at ``target_size``."""
    K4 = np.eye(4, dtype=np.float32)
    K4[0, 0] = K3[0, 0] * target_size[1] / current_size[1]
    K4[1, 1] = K3[1, 1] * target_size[0] / current_size[0]
    K4[0, 2] = K3[0, 2] * target_size[1] / current_size[1]
    K4[1, 2] = K3[1, 2] * target_size[0] / current_size[0]
    return K4


def extract_video_frames(
    video_file: str,
    out_dir: str,
    image_size: Tuple[int, int],
    rotate_ccw: bool = True,
) -> List[str]:
    """Every frame of ``video_file`` as ``out_dir/rgb_%06d.jpg`` at
    ``image_size``, rotated 90 degrees counter-clockwise first; done once:
    a non-empty ``out_dir`` is taken as extracted. Returns the sorted JPEGs."""
    if not os.path.isdir(out_dir) or not os.listdir(out_dir):
        import cv2

        os.makedirs(out_dir, exist_ok=True)
        cap = cv2.VideoCapture(video_file)
        if not cap.isOpened():
            raise ValueError(f"Failed to open video file: {video_file}")
        H, W = image_size
        idx = 0
        while True:
            ret, frame = cap.read()
            if not ret:
                break
            if rotate_ccw:
                frame = cv2.rotate(frame, cv2.ROTATE_90_COUNTERCLOCKWISE)
            frame = cv2.resize(frame, (W, H))
            cv2.imwrite(os.path.join(out_dir, f"rgb_{idx:06d}.jpg"), frame)
            idx += 1
        cap.release()
    return sorted(glob.glob(os.path.join(out_dir, "*.jpg")))


def _native_size(path: str) -> Tuple[int, int]:
    """(H, W) of the image file ``path``."""
    import cv2

    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(path)
    return img.shape[:2]


def _frames(scene_dir: str, *patterns: str) -> List[str]:
    """The files of every pattern under ``scene_dir``, sorted together."""
    return sorted(f for p in patterns for f in glob.glob(os.path.join(scene_dir, p)))


class MarsLoggerDataset(PathSnippetDataset):
    """One MarsLogger scene: its extracted video frames and the calibration
    in ``calib_dir`` (``calibration_results.json`` with the native
    ``image_height``/``image_width``, ``camera_matrix.npy``)."""

    def __init__(
        self,
        scene_dir: str,
        calib_dir: str,
        image_size: Tuple[int, int],
        is_train: bool = True,
        augment: bool = True,
    ):
        frames = extract_video_frames(
            os.path.join(scene_dir, "movie.mp4"), os.path.join(scene_dir, "rgb"), image_size
        )
        with open(os.path.join(calib_dir, "calibration_results.json")) as f:
            meta = json.load(f)
        current = (meta["image_height"], meta["image_width"])
        K3 = np.load(os.path.join(calib_dir, "camera_matrix.npy"))
        # The frames were rotated 90 degrees counter-clockwise: swap the axes.
        K3_rot = np.array(
            [[K3[1, 1], 0, K3[1, 2]], [0, K3[0, 0], K3[0, 2]], [0, 0, 1]], np.float32
        )
        K4 = rescale_intrinsic_4x4(K3_rot, image_size, (current[1], current[0]))
        super().__init__(frames, K4, image_size, is_train, augment)


class CustomRigDataset(PathSnippetDataset):
    """A capture-rig scene: ``rgb_left/*.jpg|png`` and
    ``sensor/left_intrinsics.npy`` (3x3 at the first frame's size)."""

    def __init__(
        self,
        scene_dir: str,
        image_size: Tuple[int, int],
        is_train: bool = True,
        augment: bool = True,
    ):
        frames = _frames(scene_dir, os.path.join("rgb_left", "*.jpg"),
                         os.path.join("rgb_left", "*.png"))
        if not frames:
            raise ValueError(f"no rgb_left frames in {scene_dir}")
        K3 = np.load(os.path.join(scene_dir, "sensor", "left_intrinsics.npy"))
        K4 = rescale_intrinsic_4x4(K3, image_size, _native_size(frames[0]))
        super().__init__(frames, K4, image_size, is_train, augment)


def _irs_lefts(scene_dir: str) -> List[str]:
    return _frames(scene_dir, "l_*.png", os.path.join("left", "*.png"),
                   os.path.join("left", "*.jpg"))


class IrsDataset(PathSnippetDataset):
    """An IRS sequence's left frames with the dataset's fixed camera."""

    def __init__(
        self,
        scene_dir: str,
        image_size: Tuple[int, int],
        is_train: bool = True,
        augment: bool = True,
    ):
        frames = _irs_lefts(scene_dir)
        if not frames:
            raise ValueError(f"no left frames in {scene_dir}")
        K4 = rescale_intrinsic_4x4(IRS_K3, image_size, IRS_NATIVE_SIZE)
        super().__init__(frames, K4, image_size, is_train, augment)


class StereoSnippetDataset:
    """Stereo samples ``{source_image, target_image, intrinsic, pose}`` with
    a known pose per pair (target-frame points into the source camera), and
    in training the softer ColorJitter with p=0.5 on both images at once."""

    def __init__(
        self,
        source_paths: Sequence[str],
        target_paths: Sequence[str],
        intrinsics: Sequence[np.ndarray],
        poses: Sequence[np.ndarray],
        image_size: Tuple[int, int],
        is_train: bool = True,
        augment: bool = True,
    ):
        if not len(source_paths) == len(target_paths) == len(intrinsics) == len(poses):
            raise ValueError("stereo sources, targets, intrinsics and poses differ in length")
        self.source_paths = list(source_paths)
        self.target_paths = list(target_paths)
        self.intrinsics = list(intrinsics)
        self.poses = list(poses)
        self.image_size = image_size
        self.is_train = is_train
        self.augment = augment and is_train

    def __len__(self) -> int:
        return len(self.source_paths)

    def __getitem__(self, idx: int, rng: Optional[np.random.Generator] = None) -> Dict:
        if rng is None:
            rng = np.random.default_rng()
        H, W = self.image_size
        src = read_image_rgb(self.source_paths[idx], H, W)
        tgt = read_image_rgb(self.target_paths[idx], H, W)
        if self.augment and rng.uniform() < 0.5:
            stack = color_jitter(np.stack([src, tgt]), rng, brightness=0.2, contrast=0.2,
                                 saturation=0.2, hue=0.1)
            src, tgt = stack[0], stack[1]
        return {
            "source_image": src,
            "target_image": tgt,
            "intrinsic": np.asarray(self.intrinsics[idx], np.float32),
            "pose": np.asarray(self.poses[idx], np.float32),
        }


def build_stereo_dataset(
    left_paths: Sequence[str],
    right_paths: Sequence[str],
    K4: np.ndarray,
    baseline_m: float,
    image_size: Tuple[int, int],
    is_train: bool = True,
    augment: bool = True,
) -> StereoSnippetDataset:
    """Both directed samples of each rectified pair: (target left, source
    right) with t_x = -baseline, then (target right, source left) with
    +baseline, the right camera at +baseline along the left's x."""
    n = min(len(left_paths), len(right_paths))
    if n == 0:
        raise ValueError("no stereo pairs")
    lefts, rights = list(left_paths[:n]), list(right_paths[:n])
    T_rl = np.eye(4, dtype=np.float32)
    T_rl[0, 3] = -baseline_m
    T_lr = np.eye(4, dtype=np.float32)
    T_lr[0, 3] = baseline_m
    return StereoSnippetDataset(
        source_paths=rights + lefts,
        target_paths=lefts + rights,
        intrinsics=[K4] * (2 * n),
        poses=[T_rl] * n + [T_lr] * n,
        image_size=image_size,
        is_train=is_train,
        augment=augment,
    )


def irs_stereo_dataset(
    scene_dir: str, image_size: Tuple[int, int], is_train: bool = True
) -> StereoSnippetDataset:
    """IRS left/right pairs at the dataset's 10 cm baseline."""
    rights = _frames(scene_dir, "r_*.png", os.path.join("right", "*.png"),
                     os.path.join("right", "*.jpg"))
    K4 = rescale_intrinsic_4x4(IRS_K3, image_size, IRS_NATIVE_SIZE)
    return build_stereo_dataset(_irs_lefts(scene_dir), rights, K4, IRS_BASELINE_M,
                                image_size, is_train, is_train)


def custom_stereo_dataset(
    scene_dir: str, image_size: Tuple[int, int], is_train: bool = True
) -> StereoSnippetDataset:
    """Capture-rig pairs ``rgb_left``/``rgb_right`` with the calibrated
    baseline of ``sensor/stereo_parameters.json``."""
    lefts = _frames(scene_dir, os.path.join("rgb_left", "*.jpg"),
                    os.path.join("rgb_left", "*.png"))
    rights = _frames(scene_dir, os.path.join("rgb_right", "*.jpg"),
                     os.path.join("rgb_right", "*.png"))
    with open(os.path.join(scene_dir, "sensor", "stereo_parameters.json")) as f:
        baseline_m = float(json.load(f)["baseline_m"])
    K3 = np.load(os.path.join(scene_dir, "sensor", "left_intrinsics.npy"))
    native = _native_size(lefts[0]) if lefts else IRS_NATIVE_SIZE
    K4 = rescale_intrinsic_4x4(K3, image_size, native)
    return build_stereo_dataset(lefts, rights, K4, baseline_m, image_size, is_train, is_train)


def _scene_dirs(root: str) -> List[str]:
    """The sorted subdirectories of ``root``."""
    if not os.path.isdir(root):
        return []
    return sorted(d for d in glob.glob(os.path.join(root, "*")) if os.path.isdir(d))


def load_scenes(fold_dir: str, what: str, build) -> List:
    """``build(scene_dir)`` for every scene directory under ``fold_dir`` in
    name order; a scene that does not load is skipped with a warning naming
    it as ``what``."""
    scenes = []
    for scene in _scene_dirs(fold_dir):
        try:
            scenes.append(build(scene))
        except SCENE_ERRORS as e:
            print(f"Warning: skipping {what} {scene}: {e}")
    return scenes


class MarsLoggerDataHandler:
    """MarsLogger scenes under ``<root>/{train,valid}`` (``root`` defaulting
    to ``<Directory.data_dir>/mars_logger``) when
    ``Dataset.mars_logger.mono`` is on; a scene that does not load is
    skipped with a warning."""

    def __init__(self, config: Dict, root_dir: Optional[str] = None):
        t = config["Train"]
        image_size = (t["img_h"], t["img_w"])
        root = root_dir or os.path.join(config["Directory"]["data_dir"], "mars_logger")
        self.train_dataset = self.valid_dataset = None
        if not config["Dataset"].get("mars_logger", {}).get("mono", False):
            return
        calib = os.path.join(root, "calibration_results")

        def build(fold, is_train):
            sets = load_scenes(os.path.join(root, fold), "mars_logger scene",
                               lambda d: MarsLoggerDataset(d, calib, image_size, is_train,
                                                           is_train))
            return ConcatDataset(sets) if sets else None

        self.train_dataset = build("train", True)
        self.valid_dataset = build("valid", False)
