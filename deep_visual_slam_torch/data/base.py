"""3-frame VO snippet sources and supervised-depth samples (port of
``data/base.py``).

A snippet is (left, target, right) with random temporal gaps in
[1, max_gap] (3 for training, 1 for evaluation), the 4-scale intrinsics
pyramid and, in evaluation with poses, the ground-truth relative poses. The
triplet ColorJitter (brightness, contrast, saturation 0.3, hue 0.2, p=0.5,
one draw for all three frames) runs in numpy on the host; its hue step
computes OpenCV's float RGB<->HSV formulas (H in degrees) in numpy, so the
port needs no cv2.

Frame IO belongs to subclasses (``data/packed.py``); the JAX package's path
decoders (``read_image_rgb`` and the 16-bit PNG read) need an image decoder
and wait for the path datasets (ROADMAP.md §1, item 1f).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

NUM_SCALES = 4
_FLT_EPSILON = np.float32(np.finfo(np.float32).eps)


def rgb_to_hsv_np(rgb: np.ndarray) -> np.ndarray:
    """[..., 3] fp32 RGB -> HSV, H in degrees [0, 360): OpenCV's
    ``cvtColor(COLOR_RGB2HSV)`` on float32, formula for formula."""
    rgb = np.asarray(rgb, np.float32)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    vmin = np.minimum(np.minimum(r, g), b)
    diff = v - vmin
    s = diff / (np.abs(v) + _FLT_EPSILON)
    scale = np.float32(60.0) / (diff + _FLT_EPSILON)
    h = np.where(
        v == r,
        (g - b) * scale,
        np.where(v == g, (b - r) * scale + np.float32(120.0),
                 (r - g) * scale + np.float32(240.0)),
    )
    h = np.where(h < 0, h + np.float32(360.0), h)
    return np.stack([h, s, v], axis=-1).astype(np.float32)


def hsv_to_rgb_np(hsv: np.ndarray) -> np.ndarray:
    """Inverse of :func:`rgb_to_hsv_np`: OpenCV's ``COLOR_HSV2RGB`` on
    float32 (sector table, H wrapped into [0, 6) sextants)."""
    hsv = np.asarray(hsv, np.float32)
    h, s, v = hsv[..., 0] * np.float32(6.0 / 360.0), hsv[..., 1], hsv[..., 2]
    h = np.mod(h, np.float32(6.0))
    sector = np.floor(h).astype(np.int64)
    frac = h - sector
    bad = (sector < 0) | (sector >= 6)
    sector = np.where(bad, 0, sector)
    frac = np.where(bad, np.float32(0.0), frac).astype(np.float32)
    tab = np.stack([
        v, v * (1 - s), v * (1 - s * frac), v * (1 - s * (1 - frac)),
    ], axis=-1)
    # OpenCV's (b, g, r) indices into tab per sector.
    sectors = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])
    idx = sectors[sector]
    bgr = np.take_along_axis(tab, idx, axis=-1)
    rgb = bgr[..., ::-1]
    gray = np.broadcast_to(v[..., None], rgb.shape)
    return np.where((s == 0)[..., None], gray, rgb).astype(np.float32)


def color_jitter(
    images: np.ndarray,
    rng: np.random.Generator,
    brightness: float = 0.3,
    contrast: float = 0.3,
    saturation: float = 0.3,
    hue: float = 0.2,
) -> np.ndarray:
    """torchvision-style ColorJitter on a [N, H, W, 3] stack in [0, 1], one
    factor draw for every frame of the stack."""
    b = rng.uniform(max(0.0, 1 - brightness), 1 + brightness)
    c = rng.uniform(max(0.0, 1 - contrast), 1 + contrast)
    s = rng.uniform(max(0.0, 1 - saturation), 1 + saturation)
    h = rng.uniform(-hue, hue)
    return apply_color_jitter_np(images, b, c, s, h)


def apply_color_jitter_np(
    images: np.ndarray, b: float, c: float, s: float, h: float
) -> np.ndarray:
    """Given jitter factors applied to a [N, H, W, 3] stack: brightness,
    contrast about each frame's mean, saturation about luma, then a hue
    rotation in HSV degrees where |h| > 1e-6."""
    out = images * b
    mean = out.mean(axis=(1, 2, 3), keepdims=True)
    out = (out - mean) * c + mean
    gray = 0.299 * out[..., 0:1] + 0.587 * out[..., 1:2] + 0.114 * out[..., 2:3]
    out = (out - gray) * s + gray
    out = np.clip(out, 0.0, 1.0).astype(np.float32)
    if abs(h) > 1e-6:
        hsv = rgb_to_hsv_np(out)
        hsv[..., 0] = (hsv[..., 0] + np.float32(h * 360.0)) % np.float32(360.0)
        out = hsv_to_rgb_np(hsv)
    return np.clip(out, 0.0, 1.0)


def intrinsics_pyramid_np(K4: np.ndarray, num_scales: int = NUM_SCALES):
    """[(K, inv_K)] per scale; scale s halves the pixel rows s times."""
    out = []
    for s in range(num_scales):
        K = K4.copy()
        K[0, :] /= 2**s
        K[1, :] /= 2**s
        out.append((K.astype(np.float32), np.linalg.inv(K).astype(np.float32)))
    return out


class SnippetDataset:
    """Indexable 3-frame snippet source over one image sequence of
    ``num_frames`` frames with a 4x4 intrinsic scaled to ``image_size``.
    ``poses`` (camera-to-world) give the ground-truth relative poses in
    evaluation.

    Subclasses read frames in :meth:`_load_triplet` (fp32 in [0, 1]) and
    :meth:`_load_triplet_u8` (uint8, for ``output_uint8``): the loader sets
    ``output_uint8`` under ``Train.uint8_h2d``, the step then scales on the
    device, and host jitter is off.
    """

    def __init__(
        self,
        num_frames: int,
        intrinsic: np.ndarray,
        image_size: Tuple[int, int],
        is_train: bool = True,
        augment: bool = True,
        poses: Optional[Sequence[np.ndarray]] = None,
        num_scales: int = NUM_SCALES,
    ):
        self.num_frames = num_frames
        self.intrinsic = np.asarray(intrinsic, np.float32)
        self.image_size = image_size  # (H, W)
        self.is_train = is_train
        self.max_gap = 3 if is_train else 1
        self.augment = augment and is_train
        self.poses = list(poses) if poses is not None else None
        self.num_scales = num_scales
        self._pyramid = intrinsics_pyramid_np(self.intrinsic, num_scales)
        self.output_uint8 = False

    def __len__(self) -> int:
        return max(0, self.num_frames - 2 * self.max_gap)

    def _load_triplet(self, indices) -> np.ndarray:
        raise NotImplementedError(
            "path-listed image sources need an image decoder: they come with "
            "the path datasets (ROADMAP.md §1, items 3-4); use packed shards"
        )

    def _load_triplet_u8(self, indices) -> np.ndarray:
        return self._load_triplet(indices)

    def __getitem__(self, idx: int, rng: Optional[np.random.Generator] = None) -> Dict:
        if rng is None:
            rng = np.random.default_rng()
        size_1 = int(rng.integers(1, self.max_gap + 1))
        size_2 = int(rng.integers(1, self.max_gap + 1))
        left_idx = idx
        target_idx = idx + size_1
        right_idx = idx + size_1 + size_2

        if self.output_uint8:
            stack = self._load_triplet_u8([left_idx, target_idx, right_idx])
        else:
            stack = self._load_triplet([left_idx, target_idx, right_idx])
            if self.augment and rng.uniform() < 0.5:
                stack = color_jitter(stack, rng)

        sample: Dict = {
            "source_left": stack[0],
            "target_image": stack[1],
            "source_right": stack[2],
            "K": self._pyramid[0][0],
            "inv_K": self._pyramid[0][1],
        }
        for s in range(self.num_scales):
            sample[f"K_{s}"] = self._pyramid[s][0]
            sample[f"inv_K_{s}"] = self._pyramid[s][1]

        if not self.is_train and self.poses is not None:
            max_idx = len(self.poses) - 1
            t_i = min(target_idx, max_idx)
            r_i = min(right_idx, max_idx)
            p_l, p_t, p_r = self.poses[left_idx], self.poses[t_i], self.poses[r_i]
            # Source -> target: inv(T_wc1) @ T_wc2.
            sample["gt_pose_left_to_target"] = (np.linalg.inv(p_l) @ p_t).astype(np.float32)
            sample["gt_pose_target_to_right"] = (np.linalg.inv(p_t) @ p_r).astype(np.float32)
            sample["frame_indices"] = np.array([left_idx, t_i, r_i], np.int64)
        return sample


class DepthSampleDataset:
    """Supervised-depth samples: RGB and a depth map in sensor units
    (millimetres for NYU) -> metres and the valid mask ``0 < d <
    max_depth``, with a horizontal flip (p=0.5) then ColorJitter (p=0.5)
    drawn in that order from the sample's generator in training.

    Subclasses read sample ``idx`` in :meth:`_load`: the image [H, W, 3]
    fp32 in [0, 1] and the raw depth [H, W], both at ``image_size``.
    """

    def __init__(
        self,
        num_samples: int,
        image_size: Tuple[int, int],
        max_depth: float = 10.0,
        is_train: bool = True,
        augment: bool = True,
        depth_scale: float = 1000.0,
    ):
        self.num_samples = num_samples
        self.image_size = image_size
        self.max_depth = max_depth
        self.is_train = is_train
        self.augment = augment and is_train
        self.depth_scale = depth_scale

    def __len__(self) -> int:
        return self.num_samples

    def _load(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError(
            "RGB/depth image files need an image decoder: they come with the "
            "path datasets (ROADMAP.md §1, item 1f); subclass DepthSampleDataset "
            "with a reader of your own"
        )

    def __getitem__(self, idx: int, rng: Optional[np.random.Generator] = None) -> Dict:
        if rng is None:
            rng = np.random.default_rng()
        rgb, depth_raw = self._load(idx)
        if rgb.shape[:2] != tuple(self.image_size) or depth_raw.shape != rgb.shape[:2]:
            raise ValueError(
                f"sample {idx}: image {rgb.shape} and depth {depth_raw.shape} "
                f"are not at image_size {tuple(self.image_size)}"
            )
        rgb = np.asarray(rgb, np.float32)
        depth = depth_raw.astype(np.float32) / self.depth_scale
        if self.augment:
            if rng.uniform() < 0.5:
                rgb = rgb[:, ::-1].copy()
                depth = depth[:, ::-1].copy()
            if rng.uniform() < 0.5:
                rgb = color_jitter(rgb[None], rng)[0]
        valid = (depth > 0) & (depth < self.max_depth)
        return {"image": rgb, "depth": depth[..., None], "valid_mask": valid[..., None]}
