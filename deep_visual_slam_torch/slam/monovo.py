"""The per-frame SLAM loop: DepthNet + PoseNet inference, the KLT
frontend and the windowed photometric BA (port of ``slam/monovo.py``).

``Networks.step`` runs the two networks with their own stems; the JAX
package merges the two stems into one ``[7, 7, 6, 128]`` conv
(``models/fused_vo.py``) to save a TPU dispatch, which computes the same
function.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from deep_visual_slam_torch import resolve_device
from deep_visual_slam_torch.models import DepthNet, PoseNet
from deep_visual_slam_torch.ops import disp_to_depth, transformation_from_parameters
from deep_visual_slam_torch.slam.frontend import Frame
from deep_visual_slam_torch.slam.klt_frontend import KLTFrontend
from deep_visual_slam_torch.slam.map import Map


def _f01(img: torch.Tensor) -> torch.Tensor:
    """uint8 -> [0, 1] fp32 on the device (the low-H2D ingest path); float
    images pass through."""
    if img.dtype == torch.uint8:
        return img.float() / 255.0
    return img


class Networks:
    """DepthNet + PoseNet inference at B=1 for the SLAM loop.

    ``depth_state``/``pose_state`` are the networks' ``state_dict``s
    (``utils/weights.py`` carries JAX variables across); ``None`` draws
    random weights from a ``torch.Generator`` seeded with ``seed``. The
    networks run under ``torch.autocast`` in ``dtype`` unless it is fp32.

    With ``predict_uncertainty`` the DepthNet sigma head feeds the BA Eq.13
    weights through ``unc = unc_weight_scale * max(sigma^2 -
    unc_sigma_floor^2, 0)``: pixels at or below the noise floor get unc = 0.
    """

    def __init__(
        self,
        depth_state: Optional[Dict[str, torch.Tensor]] = None,
        pose_state: Optional[Dict[str, torch.Tensor]] = None,
        min_depth: float = 0.1,
        max_depth: float = 10.0,
        dtype: torch.dtype = torch.bfloat16,
        seed: int = 0,
        predict_uncertainty: bool = False,
        unc_sigma_floor: float = 0.1,
        unc_weight_scale: float = 100.0,
        device=None,
    ):
        self.device = resolve_device(device)
        self.predict_uncertainty = predict_uncertainty
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.dtype = dtype
        self._unc_floor2 = float(unc_sigma_floor) ** 2
        self._unc_scale = float(unc_weight_scale)
        generator = torch.Generator().manual_seed(seed)
        self.depth_model = DepthNet(
            predict_uncertainty=predict_uncertainty, generator=generator
        )
        self.pose_model = PoseNet(generator=generator)
        if depth_state is not None:
            self.depth_model.load_state_dict(depth_state)
        if pose_state is not None:
            self.pose_model.load_state_dict(pose_state)
        self.depth_model.to(self.device).eval()
        self.pose_model.to(self.device).eval()

    @classmethod
    def from_checkpoint(cls, ckpt_dir: str, **kwargs) -> "Networks":
        """The networks of the newest VO trainer checkpoint under
        ``ckpt_dir`` (``<weights>/<experiment_name>``), or of a params-only
        file of ``{"depth", "pose"}`` weights (such as
        ``scripts/jax_checkpoint_to_torch.py`` writes). The uncertainty head
        is on when the depth weights hold it (decoder index 14, the
        reference's ``uncconv_0``), unless ``predict_uncertainty`` is given;
        other ``kwargs`` pass to the constructor."""
        from deep_visual_slam_torch.utils.checkpoint import load_network_states

        tree, step = load_network_states(ckpt_dir)
        print(f"Networks.from_checkpoint: {ckpt_dir}"
              + ("" if step is None else f" @ step {step}"))
        kwargs.setdefault(
            "predict_uncertainty", any(k.startswith("decoder.14.") for k in tree["depth"])
        )
        return cls(depth_state=tree["depth"], pose_state=tree["pose"], **kwargs)

    def _autocast(self):
        return torch.autocast(
            self.device.type, self.dtype, enabled=self.dtype != torch.float32
        )

    def _sigma_to_unc(self, disps) -> Optional[torch.Tensor]:
        """Head sigma map -> BA uncertainty (None when the head is off)."""
        if not self.predict_uncertainty:
            return None
        sigma = disps[("unc", 0)][..., 0]
        return self._unc_scale * torch.clamp(sigma * sigma - self._unc_floor2, min=0.0)

    def _depth(self, img: torch.Tensor):
        with self._autocast():
            disps = self.depth_model(_f01(img))
        _, depth = disp_to_depth(disps[("disp", 0)], self.min_depth, self.max_depth)
        return depth[..., 0], self._sigma_to_unc(disps)

    def _pose(self, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        pair = torch.cat([_f01(img1), _f01(img2)], dim=-1)
        with self._autocast():
            aa, t = self.pose_model(pair)
        return transformation_from_parameters(aa[:, 0, 0], t[:, 0, 0])

    @torch.inference_mode()
    def depth(self, image) -> np.ndarray:
        """[H, W, 3] float-or-uint8 image -> [H, W] metric depth."""
        d, _ = self._depth(self.to_device(image))
        return d[0].float().cpu().numpy()

    @torch.inference_mode()
    def depth_unc(self, image):
        """([H, W] metric depth, [H, W] BA uncertainty or None)."""
        d, u = self._depth(self.to_device(image))
        return (
            d[0].float().cpu().numpy(),
            None if u is None else u[0].float().cpu().numpy(),
        )

    @torch.inference_mode()
    def pose(self, image1, image2) -> np.ndarray:
        """Relative transform prev->cur as a 4x4 (prev frame 1, cur frame 2)."""
        T = self._pose(self.to_device(image1), self.to_device(image2))
        return T[0].cpu().numpy().astype(np.float64)

    @torch.inference_mode()
    def step(self, prev_image, image):
        """Per-frame inference: ([H, W] depth of ``image``, 4x4 relative
        transform prev->cur)."""
        depth, _, T = self.step_async(prev_image, image)
        return depth[0].cpu().numpy(), T[0].cpu().numpy().astype(np.float64)

    @torch.inference_mode()
    def step_async(self, prev_image, image):
        """The per-frame inference left on the device, with no host copy:
        (depth [1, H, W] fp32, BA uncertainty [1, H, W] fp32 or None, T
        [1, 4, 4] prev->cur)."""
        prev, cur = self.to_device(prev_image), self.to_device(image)
        depth, unc = self._depth(cur)
        T = self._pose(prev, cur)
        return depth.float(), None if unc is None else unc.float(), T

    def to_device(self, image) -> torch.Tensor:
        """[H, W, 3] numpy or tensor image -> [1, H, W, 3] on the device;
        uint8 stays uint8 on the wire and is scaled on the device."""
        if not torch.is_tensor(image):
            image = torch.from_numpy(np.ascontiguousarray(image))
        if image.dim() == 3:
            image = image[None]
        if image.dtype != torch.uint8:
            image = image.float()
        return image.to(self.device)


class MonoVO:
    """The monocular SLAM loop with the KLT frontend: per frame, one
    network + LK step on the device, the keyframe decision on the host, and
    at keyframes the tracks' bookkeeping, corner refill and a windowed BA
    (pipelined: it lands at the next frame).

    ``networks`` defaults to random-weight bf16 ``Networks`` on ``device``
    (None means CUDA and raises without a card). ``frontend="orb"`` raises:
    the ORB frontend needs cv2 and is not ported. ``fetch_depth=False``
    leaves non-keyframes' depth on the device (``process_frame`` returns
    None for it).
    """

    def __init__(
        self,
        intrinsic: np.ndarray,
        networks: Optional[Networks] = None,
        image_shape: Tuple[int, int] = (480, 640),
        num_kf: int = 7,
        max_points: int = 256,
        frontend: str = "klt",
        fetch_depth: bool = True,
        ba_levels=(2, 1),
        depth_damping: float = 1.0,
        pose_prior_weight: float = 1e3,
        estimate_affine: bool = False,
        huber_delta: float = 0.11,
        device=None,
    ):
        if frontend == "orb":
            raise NotImplementedError(
                "the ORB frontend (cv2 ORB and matching) is not ported yet; use frontend='klt'"
            )
        if frontend != "klt":
            raise ValueError(f"unknown frontend {frontend!r} (klt|orb)")
        self.device = resolve_device(device)
        self.intrinsic = np.asarray(intrinsic)
        self.mp = Map(
            num_kf=num_kf, max_points=max_points, ba_levels=ba_levels,
            depth_damping=depth_damping, pose_prior_weight=pose_prior_weight,
            estimate_affine=estimate_affine, huber_delta=huber_delta,
            device=self.device,
        )
        self.nn = networks or Networks(device=self.device)
        # Cumulative wall time per stage, in seconds.
        self.timings = {"networks": 0.0, "frontend": 0.0, "detect": 0.0, "backend_ba": 0.0}
        self.n_keyframes = 0
        self._prev_dev = None  # previous frame, on the device
        self._zero_unc = None  # shared read-only zero uncertainty map
        self.fetch_depth = fetch_depth
        self.klt = KLTFrontend(
            self.nn, image_shape, self.intrinsic, max_tracks=max_points, device=self.device,
        )

    def _zero_uncertainty(self, shape) -> np.ndarray:
        """Shared read-only zero uncertainty map for keyframes without one."""
        z = self._zero_unc
        if z is None or z.shape != tuple(shape):
            z = np.zeros(shape, np.float32)
            z.flags.writeable = False
            self._zero_unc = z
        return z

    @torch.inference_mode()
    def process_frame(
        self,
        frame: np.ndarray,
        optimize: bool = True,
        oracle_depth: Optional[np.ndarray] = None,
        oracle_rel: Optional[np.ndarray] = None,
        oracle_uncertainty: Optional[np.ndarray] = None,
    ):
        """Run one RGB frame ([H, W, 3] float in [0, 1] or uint8) through the
        loop; returns ``(depth, uncertainty, pose_global, a, b)``.

        ``oracle_depth`` / ``oracle_rel`` replace this frame's network depth
        map / relative prev->cur pose, and ``oracle_uncertainty`` injects its
        uncertainty map: the hooks that evaluate the backend from a
        controlled initialization.
        """
        return self._process_frame_klt(
            frame, optimize, oracle_depth, oracle_rel, oracle_uncertainty
        )

    def _process_frame_klt(
        self,
        frame: np.ndarray,
        optimize: bool,
        oracle_depth: Optional[np.ndarray] = None,
        oracle_rel: Optional[np.ndarray] = None,
        oracle_uncertainty: Optional[np.ndarray] = None,
    ):
        t0 = time.perf_counter()
        cur_dev = self.nn.to_device(frame)
        first = len(self.mp.frames) == 0
        depth_dev = None
        unc_dev = None
        if first:
            if oracle_depth is not None:
                depth = np.asarray(oracle_depth, np.float32)
            else:
                depth, unc_dev = self.nn.depth_unc(frame)
            pose_global = np.eye(4)
            self.klt.init_first(cur_dev)
        else:
            depth_dev, unc_dev, rel = self.klt.step(self._prev_dev, cur_dev)
            if oracle_depth is not None:
                depth = np.asarray(oracle_depth, np.float32)
            else:
                depth = depth_dev[0].cpu().numpy() if self.fetch_depth else None
            if oracle_rel is not None:
                rel = np.asarray(oracle_rel, np.float64)
            # Land the in-flight BA before chaining: a frame chained off the
            # keyframe's pose before its correction would carry the stale
            # pose into the next window.
            self.mp.flush_ba()
            pose_global = rel @ self.mp.frames[-1].current_pose()
        self._prev_dev = cur_dev
        a, b = 1.0, 0.0
        if first:
            is_kf = True
        else:
            score = self.klt.keyframe_score(pose_global, self.mp.keyframes[-1].pose)
            is_kf = score is None or score > 1.0
        t1 = time.perf_counter()
        self.timings["networks"] += t1 - t0

        kf_depth = None
        unc = None
        if is_kf:
            # Writable copy: the BA write-back mutates keyframe depth.
            src = depth if depth is not None else depth_dev[0].cpu().numpy()
            kf_depth = np.array(src)
            if depth is not None:
                depth = kf_depth
            # Oracle uncertainty, else the network's head, else zeros.
            if oracle_uncertainty is not None:
                unc = np.asarray(oracle_uncertainty, np.float32)
            elif unc_dev is not None:
                u = unc_dev.cpu().numpy() if torch.is_tensor(unc_dev) else unc_dev
                u = np.asarray(u, np.float32)
                unc = u[0] if u.ndim == 3 else u
            else:
                unc = self._zero_uncertainty(frame.shape[:2])
        f = Frame(
            self.mp, np.asarray(frame), kf_depth, unc, pose_global, (a, b),
            features=(self.klt.kps_int(), None),
        )
        detect_delta = 0.0
        if is_kf:
            if depth is None:
                depth = kf_depth
            det0 = self.klt.detect_s
            self.mp.register_keyframe(f)
            self.klt.register_keyframe(self.mp, f)
            detect_delta = self.klt.detect_s - det0
            self.timings["detect"] += detect_delta
        else:
            f.set_anchor(self.mp.keyframes[-1])
        self.mp.register_device_image(f.id, cur_dev[0])
        t2 = time.perf_counter()
        self.timings["frontend"] += (t2 - t1) - detect_delta
        if not is_kf:
            return depth, f.uncertainty, f.pose, a, b

        self.n_keyframes += 1
        if optimize and not first:
            self.mp.optimize(self.intrinsic)
            self.klt.drop_dead_points()
            self.timings["backend_ba"] += time.perf_counter() - t2
        return depth, f.uncertainty, f.pose, a, b

    def trajectory(self) -> np.ndarray:
        """Camera-to-world poses of all frames ([N, 4, 4]): keyframes at
        their BA-corrected poses, non-keyframes riding their anchor."""
        self.mp.flush_ba()
        return np.stack([np.linalg.inv(f.current_pose()) for f in self.mp.frames])
