"""How far the port's ORB loop on its own features drifts from the JAX
package's ORB loop on cv2's.

    JAX_PLATFORMS=cpu python scripts/orb_order_gap.py --size 96 128 --frames 30
    JAX_PLATFORMS=cpu python scripts/orb_order_gap.py --size 480 640 --frames 30

The two ORBs give equal keypoint sets, angles, responses and descriptors
(``tests/test_torch_orb.py``), but the one-to-one match pass takes queries in
index order, so a contested train index goes to whichever query comes first:
the order of the keypoints within a pyramid level decides the matches, and
with them the tracks and the poses. cv2 leaves a level in the order that
``retainBest``'s ``nth_element`` and ``partition`` make of FAST's raster
order; the port reproduces it (``ops/orb.py:_retain_best``). This script
shows whether the loops then agree.

Both loops run on the CPU at the JAX package's SLAM defaults (``num_kf=7``,
``max_points=256``, BA on) with the same random fp32 networks (the JAX
package's ``Networks(seed=0)``, carried across by ``utils/weights.py``) over
``synthetic_multidepth_sequence(seed=101, step_translation=0.003,
step_rotation=0.0006)`` rendered at the given size as uint8, the slow sweep
of ``chip_smoke.py`` phase 7c. The JAX side is ``MonoVO(frontend="orb")``
with cv2's ORB and ``BFMatcher``; the port's is ``MonoVO(frontend="orb",
device="cpu")`` with its own ORB and matcher (``--port-features cv2``
serves it the JAX side's cv2 features instead: what is left is the gap of
the rest of the loop).

Every call of either matcher is recorded; a match list is compared as the
set of (query descriptor, train descriptor) pairs, since the indices of the
two orders differ. Prints, per frame, the keypoint counts, whether the two
frames' keypoint sets and orders are equal and whether each match list of
the frame is equal, then one JSON line: the frames whose lists differ, the
keyframe ids of each side, the largest gap between the two
trajectories' camera centres in metres, each frame's gap at the end and the
gap of the newest frame's centre just after it was processed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def _pairs(des1, des2, l1, l2):
    return sorted((bytes(des1[q]), bytes(des2[t])) for q, t in zip(l1, l2))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--size", type=int, nargs=2, default=(96, 128), metavar=("H", "W"))
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--port-features", choices=("own", "cv2"), default="own",
                    help="cv2: serve the port's loop the JAX side's cv2 features "
                         "(as tests/test_torch_orb.py does), to separate ORB from the "
                         "rest of the loop")
    args = ap.parse_args()
    H, W = args.size

    import jax.numpy as jnp
    import torch

    from deep_visual_slam_tpu.slam import MonoVO as JaxMonoVO
    from deep_visual_slam_tpu.slam import Networks as JaxNetworks
    from deep_visual_slam_tpu.slam import frontend as jfrontend
    from deep_visual_slam_torch.data.synthetic import synthetic_multidepth_sequence
    from deep_visual_slam_torch.slam import MonoVO, Networks
    from deep_visual_slam_torch.slam import frontend as tfrontend
    from deep_visual_slam_torch.utils.weights import depthnet_from_jax, posenet_from_jax

    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    frames, K, _, _ = synthetic_multidepth_sequence(
        args.frames, H, W, seed=101, step_translation=0.003, step_rotation=0.0006)
    frames = (frames * 255).round().astype(np.uint8)
    jax_nets = JaxNetworks(image_shape=(H, W), dtype=jnp.float32, seed=0)
    nets = Networks(depthnet_from_jax(jax_nets._dv), posenet_from_jax(jax_nets._pv),
                    dtype=torch.float32, device="cpu")

    # Each side's matcher calls and features, by frame.
    calls = {"jax": [], "port": []}
    feats = {"jax": [], "port": []}
    frame_of = {"jax": 0, "port": 0}

    cv2_match = jfrontend.match_descriptors_cv2
    cv2_extract = jfrontend.extract_features

    def jax_match(des1, des2):
        out = cv2_match(des1, des2)
        calls["jax"].append((frame_of["jax"], _pairs(des1, des2, *out)))
        return out

    def jax_extract(image):
        out = cv2_extract(image)
        feats["jax"].append(out)
        return out

    port_match = tfrontend.match_descriptors_device
    port_extract = tfrontend.extract_features

    def t_match(des1, des2, device=None):
        out = port_match(des1, des2, device=device)
        calls["port"].append((frame_of["port"], _pairs(des1, des2, *out)))
        return out

    def t_extract(image, device=None):
        if args.port_features == "cv2":
            out = feats["jax"][len(feats["port"])]
        else:
            out = port_extract(image, device)
        feats["port"].append(out)
        return out

    jfrontend.match_descriptors_cv2 = jax_match
    jfrontend.extract_features = jax_extract
    tfrontend.match_descriptors_device = t_match
    from deep_visual_slam_torch.slam import monovo as tmonovo

    tmonovo.extract_features = t_extract

    seconds = {}
    runs = {}
    for side in ("jax", "port"):
        if side == "jax":
            vo = JaxMonoVO(K, networks=jax_nets, image_shape=(H, W), frontend="orb")
        else:
            vo = MonoVO(K, networks=nets, image_shape=(H, W), frontend="orb", device="cpu")
        t0 = time.perf_counter()
        newest = []
        for i, f in enumerate(frames):
            frame_of[side] = i
            vo.process_frame(f)
            newest.append(vo.trajectory()[-1, :3, 3])
        traj = vo.trajectory()
        seconds[side] = time.perf_counter() - t0
        kfs = sorted(f.id for f in vo.mp.frames if f.anchor is f)
        runs[side] = (traj, kfs, np.stack(newest))

    differ = []
    for i in range(len(frames)):
        (pj, dj), (pt, dt) = feats["jax"][i], feats["port"][i]
        kj = sorted(map(tuple, np.concatenate([pj, dj], 1).tolist()))
        kt = sorted(map(tuple, np.concatenate([pt, dt], 1).tolist()))
        same_order = len(pj) == len(pt) and bool((pj == pt).all() and (dj == dt).all())
        mj = [m for f, m in calls["jax"] if f == i]
        mt = [m for f, m in calls["port"] if f == i]
        equal = [a == b for a, b in zip(mj, mt)] + [False] * abs(len(mj) - len(mt))
        if not all(equal):
            differ.append(i)
        print(f"frame {i:2d}: keypoints {len(pj)} / {len(pt)}, sets equal {kj == kt}, "
              f"order equal {same_order}; match lists {len(mj)} / {len(mt)} "
              f"(matches {[len(m) for m in mj]} / {[len(m) for m in mt]}), "
              f"equal {equal}")

    (tj, kfj, nj), (tt, kft, nt) = runs["jax"], runs["port"]
    gap = np.linalg.norm(tj[:, :3, 3] - tt[:, :3, 3], axis=1)
    gap_then = np.linalg.norm(nj - nt, axis=1)
    print(json.dumps({
        "size": [H, W], "frames": len(frames), "port_features": args.port_features,
        "frames_with_unequal_match_lists": differ,
        "keyframes_jax": kfj, "keyframes_port": kft, "keyframes_equal": kfj == kft,
        "largest_pose_gap_m": float(gap.max()),
        "pose_gap_by_frame_m": [float(g) for g in gap],
        "newest_pose_gap_by_frame_m": [float(g) for g in gap_then],
        "seconds": {k: round(v, 1) for k, v in seconds.items()},
    }))


if __name__ == "__main__":
    main()
