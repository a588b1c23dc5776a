"""Frame and Point bookkeeping of the SLAM loop (port of
``slam/frontend.py:Point``/``Frame``).

The ORB frontend (cv2 ORB and Lowe-ratio matching) is not ported: a
``Frame`` needs its keypoints from the caller (the KLT frontend's track
table). ``Frame.pose`` is the global camera-from-world transform ``T_cw``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


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

    ``features`` is ``(kps [N, 2] int (x, y), descriptors or None)``;
    ``depth`` / ``uncertainty`` may be None on frames that do not fetch
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
        if features is None:
            raise NotImplementedError(
                "Frame needs its keypoints: the ORB frontend (cv2) is not "
                "ported yet; pass features=(kps, None) from the KLT frontend"
            )
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
        self.kps, self.des = features
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
