"""Offline monocular SLAM over a video file or an image directory (port of
``slam_cli.py``, the reference's ``OfflineRunner``).

    python3 -m deep_visual_slam_torch.slam_cli --input video.mp4|image_dir \\
        [--output results/slam] [--max_frames N] [--frontend klt|orb] \\
        [--global_ba] [--depth_video] [--scene_video] [--vo_ckpt <dir or file>] \\
        [--ba_levels 2 1] [--depth_damping 1.0] [--pose_prior_weight 1e3] \\
        [--num_kf 7] [--max_points 256] [--device cpu]

Frames are decoded by cv2 as uint8 RGB at ``--img_h`` x ``--img_w``
(:func:`iter_frames`) and go one at a time through ``MonoVO``: the
networks (random bf16 weights from seed 0, or ``--vo_ckpt``'s), the KLT or
ORB frontend and the windowed BA; ``--global_ba`` corrects the keyframes
at the end. Written under ``--output``: ``trajectory.npy`` (camera-to-world
[N, 4, 4]) and ``trajectory.png``, with ``--depth_video`` ``depth.mp4``
(each frame's depth in cv2's MAGMA map), with ``--scene_video``
``scene.mp4`` (the growing cloud and trajectory from a chase camera, one
frame a keyframe).

:func:`run` is the loop over any iterable of uint8 frames; only the video
writers need cv2 and only the figures need matplotlib, both imported where
they are used.
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np


def iter_frames(path: str, image_size: Tuple[int, int]) -> Iterator[np.ndarray]:
    """[H, W, 3] uint8 RGB frames of a video file, or of the ``*.jpg`` then
    ``*.png`` files of a directory (unreadable files skipped), resized to
    ``image_size`` (H, W) with cv2's default bilinear filter."""
    import cv2

    H, W = image_size
    if os.path.isdir(path):
        files = sorted(glob.glob(os.path.join(path, "*.jpg"))
                       + glob.glob(os.path.join(path, "*.png")))
        for fp in files:
            img = cv2.imread(fp, cv2.IMREAD_COLOR)
            if img is None:
                continue
            yield cv2.cvtColor(cv2.resize(img, (W, H)), cv2.COLOR_BGR2RGB)
    else:
        cap = cv2.VideoCapture(path)
        while True:
            ok, img = cap.read()
            if not ok:
                break
            yield cv2.cvtColor(cv2.resize(img, (W, H)), cv2.COLOR_BGR2RGB)
        cap.release()


def depth_colormap(depth: np.ndarray, max_depth: float = 10.0) -> np.ndarray:
    """[H, W] metric depth over [0, ``max_depth``] in cv2's MAGMA map:
    [H, W, 3] uint8 BGR."""
    import cv2

    d = np.clip(depth / max_depth, 0, 1)
    return cv2.applyColorMap((d * 255).astype(np.uint8), cv2.COLORMAP_MAGMA)


def save_trajectory_plot(traj: np.ndarray, out_path: str) -> None:
    """The camera positions of ``traj`` [N, 4, 4] in 3D, the first green and
    the last red, as a PNG."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(8, 6))
    ax = fig.add_subplot(111, projection="3d")
    p = traj[:, :3, 3]
    ax.plot(p[:, 0], p[:, 1], p[:, 2], "b-")
    ax.scatter(p[0, 0], p[0, 1], p[0, 2], c="g", s=40)
    ax.scatter(p[-1, 0], p[-1, 1], p[-1, 2], c="r", s=40)
    ax.set_title("SLAM trajectory")
    fig.savefig(out_path, dpi=100)
    plt.close(fig)


def intrinsic_from_args(args) -> np.ndarray:
    """The 4x4 camera matrix of ``--fx --fy --cx --cy``; the principal point
    defaults to the image centre."""
    H, W = args.img_h, args.img_w
    K = np.eye(4)
    K[0, 0], K[1, 1] = args.fx, args.fy
    K[0, 2] = args.cx if args.cx is not None else (W - 1) / 2
    K[1, 2] = args.cy if args.cy is not None else (H - 1) / 2
    return K


def run(frames: Iterable[np.ndarray], args, device=None) -> Optional[np.ndarray]:
    """The SLAM loop over ``frames`` ([H, W, 3] uint8 RGB at ``--img_h`` x
    ``--img_w``) with the options of ``args``: the depth and scene videos
    when asked for, global BA at the end with ``--global_ba``, and
    ``trajectory.npy`` under ``--output``. Returns the trajectory
    (camera-to-world [N, 4, 4]), or ``None`` when there was no frame.

    ``MonoVO`` gets the networks of ``--vo_ckpt`` or random bf16 ones, and
    fetches dense depth to the host only where something reads it
    (``--depth_video``, the ORB frontend)."""
    from deep_visual_slam_torch import resolve_device
    from deep_visual_slam_torch.slam import MonoVO, Networks

    device = resolve_device(device)
    H, W = args.img_h, args.img_w
    K = intrinsic_from_args(args)
    nets = Networks.from_checkpoint(args.vo_ckpt, device=device) if args.vo_ckpt else None
    vo = MonoVO(
        K, networks=nets, image_shape=(H, W), num_kf=args.num_kf, max_points=args.max_points,
        frontend=args.frontend, fetch_depth=args.depth_video or args.frontend == "orb",
        ba_levels=tuple(args.ba_levels), depth_damping=args.depth_damping,
        pose_prior_weight=args.pose_prior_weight, device=device,
    )
    os.makedirs(args.output, exist_ok=True)
    writer = viz = None
    if args.depth_video:
        import cv2

        writer = cv2.VideoWriter(os.path.join(args.output, "depth.mp4"),
                                 cv2.VideoWriter_fourcc(*"mp4v"), 15, (W, H))
    if args.scene_video:
        from deep_visual_slam_torch.utils.viz import Visualizer

        viz = Visualizer(args.output)
        uu, vv = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))

    n = n_kf = 0
    for frame in frames:
        depth, _, pose, _, _ = vo.process_frame(frame)
        if writer is not None:
            writer.write(depth_colormap(depth))
        if viz is not None and vo.n_keyframes > n_kf and depth is not None:
            # One chase-camera frame a keyframe, its depth unprojected.
            n_kf = vo.n_keyframes
            pts_cam = np.stack([(uu - K[0, 2]) / K[0, 0] * depth,
                                (vv - K[1, 2]) / K[1, 1] * depth, depth], axis=-1)
            T_wc = np.linalg.inv(pose)
            viz.add_pose(T_wc)
            viz.add_pointcloud(pts_cam, frame.astype(np.float32) / 255.0, T_wc)
            viz.render(follow_cam=True, floor=True)
        n += 1
        if n % 10 == 0:
            print(f"frame {n}: |t| = {np.linalg.norm(pose[:3, 3]):.3f} m, "
                  f"{len(vo.mp.keyframes)} keyframes, {len(vo.mp.points)} points")
        if args.max_frames and n >= args.max_frames:
            break
    if writer is not None:
        writer.release()
    if viz is not None:
        path = viz.save_movie(os.path.join(args.output, "scene.mp4"), fps=5)
        if path:
            print(f"scene video -> {path}")
    if args.global_ba and len(vo.mp.keyframes) >= 2:
        print("running global bundle adjustment...")
        vo.mp.global_bundle_adjustment(K)
    if n == 0:
        print("no frames decoded from input; nothing to do")
        return None
    traj = vo.trajectory()
    np.save(os.path.join(args.output, "trajectory.npy"), traj)
    print(f"processed {n} frames -> {args.output}/trajectory.npy")
    return traj


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Offline monocular SLAM")
    p.add_argument("--input", required=True, help="video file or image dir")
    p.add_argument("--output", default="results/slam")
    p.add_argument("--img_h", type=int, default=480)
    p.add_argument("--img_w", type=int, default=640)
    p.add_argument("--fx", type=float, default=525.0)
    p.add_argument("--fy", type=float, default=525.0)
    p.add_argument("--cx", type=float, default=None)
    p.add_argument("--cy", type=float, default=None)
    p.add_argument("--max_frames", type=int, default=0)
    p.add_argument("--global_ba", action="store_true")
    p.add_argument("--depth_video", action="store_true")
    p.add_argument("--scene_video", action="store_true",
                   help="record a chase-camera 3D scene mp4 (growing cloud and trajectory, "
                   "one frame a keyframe)")
    p.add_argument("--vo_ckpt", default=None,
                   help="a VO trainer checkpoint directory or a params-only file "
                   "(default: random weights)")
    p.add_argument("--frontend", choices=("klt", "orb"), default="klt")
    p.add_argument("--ba_levels", type=int, nargs="+", default=[2, 1],
                   help="BA pyramid downsample factors, coarsest first")
    p.add_argument("--depth_damping", type=float, default=1.0,
                   help="absolute floor on the depth Hessian diagonal (0: free depths)")
    p.add_argument("--pose_prior_weight", type=float, default=1e3,
                   help="odometry relative-pose prior weight")
    p.add_argument("--num_kf", type=int, default=7, help="windowed-BA keyframe window")
    p.add_argument("--max_points", type=int, default=256, help="BA point slots per window")
    p.add_argument("--device", default=None,
                   help="torch device (default: CUDA, which must be present)")
    return p


def main(argv=None) -> Optional[np.ndarray]:
    """The CLI; returns the trajectory written, or ``None``."""
    p = parser()
    args = p.parse_args(argv)
    if not os.path.exists(args.input):
        p.error(f"--input path does not exist: {args.input}")
    traj = run(iter_frames(args.input, (args.img_h, args.img_w)), args, args.device)
    if traj is not None:
        save_trajectory_plot(traj, os.path.join(args.output, "trajectory.png"))
        print(f"trajectory figure -> {args.output}/trajectory.png")
    return traj


if __name__ == "__main__":
    main()
