"""The ORB frontend and the Frame and Point bookkeeping of the SLAM loop
(port of ``slam/frontend.py``).

``extract_features`` is ORB with 3000 features, 8 levels and scale 1.2, in
PyTorch on the loop's device (``ops/orb.py``, which computes what the JAX
package's cv2 ORB computes); ``match_descriptors`` is Lowe's ratio test
(0.75), a Hamming threshold (32) and one match per descriptor on either
side, on the device (``ops/matching.py``). A ``Frame`` built without
``features`` runs ORB on its image. ``Frame.pose`` is the global
camera-from-world transform ``T_cw``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from deep_visual_slam_torch import resolve_device
from deep_visual_slam_torch.ops.matching import match_descriptors_device
from deep_visual_slam_torch.ops.orb import detect_and_compute, rgb_to_gray


def _gray_u8(image: torch.Tensor) -> torch.Tensor:
    """RGB or gray, uint8 or float in [0, 1] -> uint8 ``[H, W]``: a float
    image becomes ``uint8(clip(x, 0, 1) * 255)`` in its own precision (a
    truncation, as the JAX package's numpy cast), then ``COLOR_RGB2GRAY``."""
    if image.dim() == 4:
        image = image[0]
    if image.dtype != torch.uint8:
        image = (image.clamp(0.0, 1.0) * 255).to(torch.uint8)
    return rgb_to_gray(image) if image.dim() == 3 else image


def extract_features(image, device=None) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """ORB keypoints and descriptors of an RGB (or gray) image, numpy or a
    tensor, uint8 or float in [0, 1]: ``([N, 2] int32 (x, y), [N, 32]
    uint8)``, or ``(zeros [0, 2], None)`` when there are none. A numpy image
    goes to ``device`` (None: CUDA); a tensor stays where it is."""
    if torch.is_tensor(image):
        t = image
    else:
        t = torch.from_numpy(np.ascontiguousarray(image)).to(resolve_device(device))
    pts, _, _, _, des = detect_and_compute(_gray_u8(t))
    if pts.shape[0] == 0:
        return np.zeros((0, 2), np.int32), None
    return pts.to(torch.int32).cpu().numpy(), des.cpu().numpy()


def match_descriptors(
    des1: Optional[np.ndarray], des2: Optional[np.ndarray], device=None
) -> Tuple[List[int], List[int]]:
    """Lowe-ratio 2-NN matching with one match per descriptor on either side
    (the reference's ``slam/frontend.py:46-67``), on ``device`` (None:
    CUDA): the query and train indices. None, or fewer than two descriptors
    on a side, gives no match."""
    if des1 is None or des2 is None or len(des1) < 2 or len(des2) < 2:
        return [], []
    return match_descriptors_device(des1, des2, device=device)


def match_frame_kps(f1: "Frame", f2: "Frame", device=None) -> Tuple[List[int], List[int]]:
    return match_descriptors(f1.des, f2.des, device=device)


class Point:
    """A scene point tracked over several frames; its host is the first."""

    def __init__(self, map_):
        self.frames: List["Frame"] = []
        self.idxs: List[int] = []
        self.id = map_.add_point(self)
        self.valid = True

    def get_host_frame(self) -> Tuple["Frame", Tuple[int, int]]:
        f = self.frames[0]
        x, y = f.kps[self.idxs[0]]
        return f, (int(x), int(y))

    def update_host_depth(self, depth: float) -> None:
        f, (x, y) = self.get_host_frame()
        f.depth[y, x] = depth

    def add_observation(self, frame: "Frame", idx: int) -> None:
        if idx in frame.pts or frame in self.frames:
            raise ValueError(f"point {self.id} already observed at slot {idx} of frame {frame.id}")
        frame.pts[idx] = self
        self.frames.append(frame)
        self.idxs.append(idx)


class Frame:
    """One camera frame: image, network outputs, tracked keypoints.

    ``features`` is ``(kps [N, 2] int (x, y), descriptors or None)``; without
    it the frame runs ORB on its image on the map's device. ``depth`` /
    ``uncertainty`` may be None on frames that do not fetch
    them. A non-keyframe stores its pose relative to its anchor keyframe
    (``set_anchor``), so BA corrections of the keyframe move it rigidly.
    """

    def __init__(
        self,
        map_,
        image: np.ndarray,
        depth: Optional[np.ndarray],
        uncertainty: Optional[np.ndarray],
        pose: np.ndarray,
        brightness_params: Tuple[float, float] = (1.0, 0.0),
        features: Optional[Tuple[np.ndarray, Optional[np.ndarray]]] = None,
    ):
        self.id = map_.add_frame(self)
        self.image = np.asarray(image)
        # Writable copy: the BA write-back mutates keyframe depth.
        self.depth = None if depth is None else np.array(depth)
        self.uncertainty = None if uncertainty is None else np.asarray(uncertainty)
        self.pose = np.asarray(pose, np.float64)
        self.a, self.b = brightness_params
        self.marginalize = False
        self.anchor = None  # keyframes: self; non-keyframes: last keyframe
        self.T_rel_anchor = None  # T_cw(self) @ inv(T_cw(anchor)) at creation
        # ``features`` lets the caller run ORB while the card is busy.
        self.kps, self.des = features or extract_features(self.image, map_.device)
        self.pts: Dict[int, Point] = {}

        H, W = self.image.shape[:2]
        if len(self.kps):
            kp = np.asarray(self.kps)
            if kp.min() < 0 or kp[:, 0].max() >= W or kp[:, 1].max() >= H:
                raise ValueError("keypoints outside the image")

    def set_anchor(self, anchor: "Frame") -> None:
        """Fix this frame's pose to an anchor keyframe (itself for
        keyframes)."""
        self.anchor = anchor
        self.T_rel_anchor = None if anchor is self else self.pose @ np.linalg.inv(anchor.pose)

    def current_pose(self) -> np.ndarray:
        """Global T_cw: a keyframe's own (BA-corrected) pose, or a
        non-keyframe's relative pose on its anchor's current pose."""
        if self.anchor is None or self.anchor is self:
            return self.pose
        return self.T_rel_anchor @ self.anchor.pose
