"""Keyframe map and the BA behind it, on the KLT path (port of
``slam/map.py:Map``).

The map gathers a fixed-shape ``BAProblem`` (``num_kf`` keyframe slots x
``max_points`` point slots, padded) from the KLT frontend's per-keyframe
slot snapshots and runs the photometric BA pyramid on the device. The
solve is pipelined: ``optimize`` queues it and returns; ``flush_ba``
copies the result to the host frames and points when something reads
them.

``global_bundle_adjustment`` solves over the whole keyframe history,
marginalized keyframes included, with the track-banded solver of
``slam/global_ba.py``. Its shapes are padded to buckets (``_F_BUCKETS``,
``_P_BUCKETS``), so a growing trajectory meets few distinct shapes.

Not ported yet: the descriptor-matching keyframe policy
(``check_add_key_frame``/``check_key_frame``) and the ``keypoints()``
track walk, both on the ORB path.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from deep_visual_slam_torch import resolve_device
from deep_visual_slam_torch.slam.ba import BAProblem, photometric_ba_pyramid
from deep_visual_slam_torch.slam.frontend import Frame, Point
from deep_visual_slam_torch.slam.global_ba import (
    GlobalBAProblem,
    photometric_ba_global_pyramid,
)


class Map:
    """Frames, points and the keyframe window, with its BA backend.

    ``alpha``: the D3VO weight ``alpha^2 / (alpha^2 + unc)``;
    ``ba_levels``: BA pyramid levels, coarsest first; ``depth_damping``:
    the depth-Hessian floor; ``pose_prior_weight``: the odometry prior
    (D3VO Eq. 15); ``estimate_affine``: per-frame brightness (a, b) in the
    solve; ``huber_delta``: the photometric Huber threshold.
    """

    def __init__(
        self,
        alpha: float = 0.5,
        num_kf: int = 7,
        max_points: int = 256,
        ba_levels: Tuple[int, ...] = (2, 1),
        depth_damping: float = 1.0,
        pose_prior_weight: float = 1e3,
        estimate_affine: bool = False,
        huber_delta: float = 0.11,
        device=None,
    ):
        self.device = resolve_device(device)
        self.frames: List[Frame] = []
        self.points: List[Point] = []
        self.keyframes: List[Frame] = []
        self.frame_idx = 0
        self.pt_idx = 0
        self.num_kf = num_kf
        self.alpha = alpha
        self.max_points = max_points
        self.ba_levels = tuple(ba_levels)
        self.depth_damping = float(depth_damping)
        self.pose_prior_weight = float(pose_prior_weight)
        self.estimate_affine = bool(estimate_affine)
        self.huber_delta = float(huber_delta)
        # Host time spent assembling BA problems.
        self.build_s = 0.0
        # Device image cache keyed by frame id: keyframe images are uploaded
        # once, not once per solve; evicted when a frame leaves the window.
        self._dev_images: Dict[int, torch.Tensor] = {}
        self._zero_img_cache: Optional[torch.Tensor] = None
        # In-flight windowed BA: (window, points, poses, depths) on the device.
        self._pending_ba = None

    # ------------------------------------------------------------- registry
    def add_frame(self, frame) -> int:
        ret = self.frame_idx
        self.frame_idx += 1
        self.frames.append(frame)
        return ret

    def add_point(self, pt) -> int:
        ret = self.pt_idx
        self.pt_idx += 1
        self.points.append(pt)
        return ret

    # ----------------------------------------------------------- keyframes
    def register_keyframe(self, frame: Frame) -> None:
        """Append a keyframe to the window, flagging the head for
        marginalization when the window is full."""
        frame.set_anchor(frame)
        self.keyframes.append(frame)
        if len(self.keyframes) >= self.num_kf:
            self.keyframes[0].marginalize = True

    # ------------------------------------------------------------ geometry
    def relative_to_global(self) -> List[np.ndarray]:
        """Global poses of all frames, non-keyframes refreshed against their
        anchor keyframe's BA-corrected pose."""
        self.flush_ba()
        return [f.current_pose() for f in self.frames]

    # ------------------------------------------------------------- backend
    def _device_image(self, f: Frame) -> torch.Tensor:
        """Frame image as a cached [H, W, 3] fp32 device tensor with the
        brightness affine applied (uploaded at most once)."""
        cached = self._dev_images.get(f.id)
        if cached is None:
            img = np.asarray(f.image, np.float32)
            if f.image.dtype == np.uint8:
                img = img / 255.0
            if img.ndim == 2:
                img = np.repeat(img[..., None], 3, axis=-1)
            cached = torch.from_numpy(np.ascontiguousarray(f.a * img + f.b)).to(self.device)
            self._dev_images[f.id] = cached
        return cached

    def _zero_image(self, H: int, W: int, dtype=torch.float32) -> torch.Tensor:
        """Cached zero image for padded window slots, of the window's dtype."""
        cached = self._zero_img_cache
        if cached is None or cached.shape[:2] != (H, W) or cached.dtype != dtype:
            cached = torch.zeros((H, W, 3), dtype=dtype, device=self.device)
            self._zero_img_cache = cached
        return cached

    def register_device_image(self, frame_id: int, image: torch.Tensor) -> None:
        """Seed the device cache with the image already uploaded for the
        networks (a=1, b=0 frames only), evicting every frame that is not a
        keyframe at once, so that a sequence without keyframes holds one
        image."""
        self._dev_images[frame_id] = image
        self._evict_device_images(extra_live={frame_id})

    def _evict_device_images(self, extra_live=()) -> None:
        live = {f.id for f in self.keyframes} | set(extra_live)
        for fid in [k for k in self._dev_images if k not in live]:
            del self._dev_images[fid]

    def _gather_tracks_fast(self, frames: List[Frame], max_points: int, window: bool = True):
        """Track gather from the KLT frontend's slot -> Point-id snapshots
        (``Frame.slot_pt_id``). Returns ``(points, host_uv [n, 2], host_idx
        [n], depth [n], unc [n], obs [n, F_real])``, longest tracks first, or
        None when a frame has no snapshot (ORB frames). ``window=False``
        keeps the points that ``Point.valid`` retired from the sliding window
        (their observations stay true history, for global BA)."""
        snaps = [getattr(f, "slot_pt_id", None) for f in frames]
        if any(s is None for s in snaps):
            return None
        F_real = len(frames)
        M = np.stack(snaps)  # [F_real, S], -1 = empty slot
        uids, inv = np.unique(M, return_inverse=True)
        inv = inv.reshape(M.shape)
        obs_full = np.zeros((len(uids), F_real), bool)
        obs_full[inv, np.arange(F_real)[:, None]] = True
        # A Point keeps one slot for its life: any occurrence gives it.
        slot_arr = np.zeros(len(uids), np.int64)
        slot_arr[inv] = np.broadcast_to(np.arange(M.shape[1]), M.shape)
        n_obs = obs_full.sum(1)
        if window:
            valid = np.array([u >= 0 and self.points[u].valid for u in uids], bool)
        else:
            valid = uids >= 0
        keep = valid & (n_obs >= 2)
        if not keep.any():
            return [], None, None, None, None, None
        order = np.flatnonzero(keep)[np.argsort(-n_obs[keep], kind="stable")]
        order = order[:max_points]

        host_f = obs_full[order].argmax(1)  # first observation = host
        slots = slot_arr[order]
        kps_all = np.stack([f.kps for f in frames])  # [F_real, S, 2] int
        uv = kps_all[host_f, slots].astype(np.float32)
        depth = np.empty(len(order), np.float32)
        unc = np.empty(len(order), np.float32)
        xs = uv[:, 0].astype(np.int64)
        ys = uv[:, 1].astype(np.int64)
        for fi, f in enumerate(frames):
            sel = host_f == fi
            if sel.any():
                depth[sel] = f.depth[ys[sel], xs[sel]]
                unc[sel] = f.uncertainty[ys[sel], xs[sel]]
        points = [self.points[u] for u in uids[order]]
        return points, uv, host_f.astype(np.int32), depth, unc, obs_full[order]

    def _build_problem(
        self,
        intrinsic: np.ndarray,
        frames: List[Frame],
        max_points: int,
        pad_frames: Optional[int] = None,
    ) -> Optional[Tuple[BAProblem, List[Point]]]:
        """Gather the fixed-shape BAProblem, padding the frame axis to
        ``pad_frames`` with identity-pose, zero-image, unobserved slots (their
        Hessian rows are zero; LM damping keeps the system solvable and their
        updates are zero). None when no track spans two keyframes."""
        F_real = len(frames)
        F = max(pad_frames or F_real, F_real)
        H, W = frames[0].image.shape[:2]
        P = max_points

        fast = self._gather_tracks_fast(frames, max_points)
        if fast is None:
            raise NotImplementedError(
                "window frames without KLT slot snapshots: the ORB track walk "
                "(Map.keypoints) is not ported yet"
            )
        points, t_uv, t_host, t_depth, t_unc, t_obs = fast
        if not points:
            return None
        n = len(points)
        host_uv = np.zeros((P, 2), np.float32)
        host_idx = np.zeros(P, np.int64)
        depths = np.full(P, 1.0, np.float32)
        obs = np.zeros((P, F), bool)
        weight = np.zeros(P, np.float32)
        host_uv[:n] = t_uv
        host_idx[:n] = t_host
        depths[:n] = np.maximum(0.01, t_depth)
        obs[:n, :F_real] = t_obs
        weight[:n] = self.alpha**2 / (self.alpha**2 + np.sqrt(np.abs(t_unc)) ** 2)

        images = tuple(self._device_image(f) for f in frames)
        # One dtype across the window: the solve scales uint8 by 1/255 by
        # the stack's dtype, so a uint8/fp32 mix would be 255x off.
        if any(im.dtype != images[0].dtype for im in images[1:]):
            raise ValueError(
                f"window images have mixed dtypes {[str(im.dtype) for im in images]}: "
                "the BA image stack must be all uint8 or all fp32"
            )
        zero = self._zero_image(H, W, dtype=images[0].dtype)
        images = images + (zero,) * (F - F_real)
        poses = np.stack([f.pose for f in frames] + [np.eye(4)] * (F - F_real)).astype(np.float32)

        def dev(a):
            return torch.from_numpy(a).to(self.device)

        problem = BAProblem(
            images=images,
            K=dev(np.asarray(intrinsic, np.float32)),
            poses=dev(poses),
            depths=dev(depths),
            host_uv=dev(host_uv),
            host_idx=dev(host_idx),
            obs_mask=dev(obs),
            weight=dev(weight),
        )
        return problem, points

    def solve(self, problem: BAProblem, num_real: int, iters: int = 6):
        """The windowed solve of ``optimize`` on a built problem: the BA
        pyramid at ``ba_levels``, queued on the device with no host
        synchronisation."""
        return photometric_ba_pyramid(
            problem, levels=self.ba_levels,
            iters_per_level=(iters,) * len(self.ba_levels),
            depth_damping=self.depth_damping, prior_weight=self.pose_prior_weight,
            num_real=num_real, estimate_affine=self.estimate_affine,
            huber_delta=self.huber_delta,
        )

    def _write_back(self, frames, points, poses, depths) -> None:
        poses = np.asarray(poses, np.float64)
        depths = np.asarray(depths)
        for i, f in enumerate(frames):
            f.pose = poses[i]
        for p_i, pt in enumerate(points):
            pt.update_host_depth(max(0.01, float(depths[p_i])))

    def flush_ba(self) -> None:
        """Copy an in-flight BA result to the host frames and points (waits
        for the device). Called before anything reads or rebuilds from host
        poses or depths."""
        if self._pending_ba is None:
            return
        window, points, poses, depths = self._pending_ba
        self._pending_ba = None
        self._write_back(window, points, poses[: len(window)].cpu().numpy(), depths.cpu().numpy())

    def optimize(self, intrinsic: np.ndarray, iters: int = 6) -> bool:
        """Windowed BA over the current keyframes, then marginalization of
        the oldest keyframe once the window is full.

        The solve is queued and its write-back deferred to the next
        ``flush_ba``: it runs while the frontend works on the next frame.
        The results are the same as a blocking solve's; they land one frame
        later.
        """
        self.flush_ba()
        window = self.keyframes[-self.num_kf:]
        t0 = time.perf_counter()
        built = self._build_problem(intrinsic, window, self.max_points, pad_frames=self.num_kf)
        self.build_s += time.perf_counter() - t0
        if built is None:
            return False
        problem, points = built
        poses, depths, _ = self.solve(problem, len(window), iters)
        self._pending_ba = (window, points, poses, depths)

        if len(self.keyframes) >= self.num_kf:
            old = self.keyframes.pop(0)
            for pt in old.pts.values():
                pt.valid = False
        self._evict_device_images()
        return True

    # ------------------------------------------------------------ global BA
    _F_BUCKETS = (8, 16, 32, 48, 64, 96, 128, 192, 256, 384, 512)
    _P_BUCKETS = (256, 512, 1024, 2048, 4096)
    # The JAX package's defaults: LM iterations over all levels, the
    # track-length cap L of the banded solver, and the tracks kept.
    _GLOBAL_ITERS = 21
    _GLOBAL_OFFSETS = 8
    _GLOBAL_POINTS = 2048

    @staticmethod
    def _bucket(n: int, buckets) -> int:
        """The smallest bucket that holds ``n``, else ``n`` itself."""
        for b in buckets:
            if n <= b:
                return b
        return n

    def _gather_global_tracks(self, kfs: List[Frame]):
        """Track gather over the whole keyframe history, retired points
        included, the ``_GLOBAL_POINTS`` longest kept. Observations more
        than ``_GLOBAL_OFFSETS`` keyframes after a point's host are dropped
        (the banded solver's track-length cap); a point left with none keeps
        its slot, its edges masked.

        Returns ``(points, host_uv [n, 2], host_idx [n], depth [n], weight
        [n], obs_off [n, _GLOBAL_OFFSETS])``, longest tracks first, or None
        when no track spans two keyframes."""
        gathered = self._gather_tracks_fast(kfs, self._GLOBAL_POINTS, window=False)
        if gathered is None:
            raise NotImplementedError(
                "keyframes without KLT slot snapshots: the ORB track walk of "
                "global BA is not ported yet"
            )
        points, uv, host_f, depth, unc, obs = gathered
        if not points:
            return None
        # Offset grid: observed at host + 1 + l, l in [0, max_offsets).
        cols = host_f[:, None] + 1 + np.arange(self._GLOBAL_OFFSETS)[None, :]
        obs_off = np.take_along_axis(obs, np.clip(cols, 0, len(kfs) - 1), axis=1)
        obs_off &= cols < len(kfs)
        weight = self.alpha**2 / (self.alpha**2 + np.sqrt(np.abs(unc)) ** 2)
        return (
            points, uv, host_f.astype(np.int64), np.maximum(0.01, depth),
            weight.astype(np.float32), obs_off,
        )

    def build_global_problem(
        self, intrinsic: np.ndarray
    ) -> Optional[Tuple[GlobalBAProblem, List[Frame], List[Point]]]:
        """The bucketed ``GlobalBAProblem`` over every keyframe (``f.anchor
        is f``), with the keyframes and points it covers; None with fewer
        than two keyframes or no shared track. The images go up as one
        stack, uint8 when every keyframe is uint8 with brightness (1, 0)."""
        self.flush_ba()
        kfs = [f for f in self.frames if f.anchor is f]
        F_real = len(kfs)
        if F_real < 2:
            return None
        gathered = self._gather_global_tracks(kfs)
        if gathered is None:
            return None
        points, uv, host_idx, depth0, weight, obs_off = gathered
        n = len(points)
        F = self._bucket(F_real, self._F_BUCKETS)
        P = self._bucket(n, self._P_BUCKETS)
        H, W = kfs[0].image.shape[:2]

        if all(f.image.dtype == np.uint8 and f.a == 1.0 and f.b == 0.0 for f in kfs):
            stack = np.zeros((F, H, W, 3), np.uint8)
            for i, f in enumerate(kfs):
                stack[i] = f.image
        else:
            stack = np.zeros((F, H, W, 3), np.float32)
            for i, f in enumerate(kfs):
                img = np.asarray(f.image, np.float32)
                if f.image.dtype == np.uint8:
                    img = img / 255.0
                if img.ndim == 2:
                    img = np.repeat(img[..., None], 3, axis=-1)
                stack[i] = f.a * img + f.b

        host_uv = np.zeros((P, 2), np.float32)
        host_i = np.zeros(P, np.int64)
        depths = np.full(P, 1.0, np.float32)
        w_arr = np.zeros(P, np.float32)
        obs = np.zeros((P, self._GLOBAL_OFFSETS), bool)
        host_uv[:n] = uv
        host_i[:n] = host_idx
        depths[:n] = depth0
        w_arr[:n] = weight
        obs[:n] = obs_off
        poses = np.stack([f.pose for f in kfs] + [np.eye(4)] * (F - F_real)).astype(np.float32)

        def dev(a):
            return torch.from_numpy(a).to(self.device)

        problem = GlobalBAProblem(
            images=dev(stack),
            K=dev(np.asarray(intrinsic, np.float32)),
            poses=dev(poses),
            depths=dev(depths),
            host_uv=dev(host_uv),
            host_idx=dev(host_i),
            obs_off=dev(obs),
            weight=dev(w_arr),
        )
        return problem, kfs, points

    def solve_global(self, problem: GlobalBAProblem, num_real: int):
        """The global solve on a built problem: ``_GLOBAL_ITERS //
        len(ba_levels)`` LM iterations at each of the ``ba_levels``, queued
        on the device with no host synchronisation."""
        levels = self.ba_levels
        it = max(self._GLOBAL_ITERS // len(levels), 1)
        return photometric_ba_global_pyramid(
            problem, num_real, levels=levels, iters_per_level=(it,) * len(levels),
            depth_damping=self.depth_damping, prior_weight=self.pose_prior_weight,
            huber_delta=self.huber_delta,
        )

    def global_bundle_adjustment(self, intrinsic: np.ndarray) -> bool:
        """Photometric BA over the whole keyframe history, marginalized
        keyframes included, written back to the keyframes and the points'
        host depths. False when there is nothing to solve."""
        built = self.build_global_problem(intrinsic)
        if built is None:
            return False
        problem, kfs, points = built
        poses, depths, _ = self.solve_global(problem, len(kfs))
        self._write_back(kfs, points, poses[: len(kfs)].cpu().numpy(), depths.cpu().numpy())
        return True
