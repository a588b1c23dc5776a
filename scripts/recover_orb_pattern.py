"""Recover the 256 test pairs of OpenCV's ORB descriptor by probing cv2.

    python scripts/recover_orb_pattern.py [--images 12] [--seed 0] [--check]

Run it where ``cv2`` is installed. It prints the table as the Python
literal that ``deep_visual_slam_torch/ops/orb_pattern.py`` holds, then one
line per pair that disagrees with cv2 on any probe keypoint (none when the
table is right). ``--check`` holds the committed table to cv2 instead of
printing a new one and exits 1 on a disagreement.

How: ``ORB.compute`` keeps a given keypoint's angle, and at angle 0 and
octave 0 bit ``j`` of descriptor byte ``k`` is ``B[p1] < B[p2]`` for pair
``8k + j``, where ``B`` is the frame smoothed as ORB smooths its pyramid
levels. ORB blurs each level in place inside its pyramid buffer, a
sub-matrix, so ``GaussianBlur`` skips its bit-exact fixed-point route and
runs the float separable filter: ``cv2.sepFilter2D`` with the 7-tap float32
kernel of ``cv2.getGaussianKernel(7, 2, CV_32F)`` and ``BORDER_REFLECT_101``
gives the same image. (``cv2.GaussianBlur`` on a whole numpy image takes the
fixed-point route and disagrees on about one bit in a hundred.) Each pair is
first located by correlating its bit with the smoothed 31x31 patches (``p2``
at the most positive correlation, ``p1`` at the most negative), then held
exactly to every probe keypoint, searching the neighbours of both ends when
the first guess disagrees anywhere.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

R = 15  # half the 31x31 patch


def _orb():
    import cv2

    return cv2.ORB_create(
        nfeatures=3000, scaleFactor=1.2, nlevels=8, edgeThreshold=31,
        firstLevel=0, WTA_K=2, patchSize=31,
    )


def probe(n_images: int, seed: int, per_image: int = 3000):
    """Smoothed patches ``[N, 31, 31]`` (int16) and descriptor bits
    ``[N, 256]`` of ``n_images`` random frames at angle-0 level-0
    keypoints."""
    import cv2

    rng = np.random.default_rng(seed)
    kernel = cv2.getGaussianKernel(7, 2, cv2.CV_32F)
    orb = _orb()
    patches, bits = [], []
    for _ in range(n_images):
        gray = rng.integers(0, 256, (480, 640)).astype(np.uint8)
        xy = rng.integers(40, 440, (per_image, 2))
        kps = [cv2.KeyPoint(float(x), float(y), 31.0, 0.0, 0.0, 0) for x, y in xy]
        kps, des = orb.compute(gray, kps)
        blur = cv2.sepFilter2D(
            gray, cv2.CV_8U, kernel, kernel, borderType=cv2.BORDER_REFLECT_101
        )
        pts = np.array([k.pt for k in kps]).round().astype(np.int64)
        if any(k.angle != 0.0 or k.octave != 0 for k in kps):
            raise RuntimeError("ORB.compute changed a given angle or octave")
        dy, dx = np.mgrid[-R:R + 1, -R:R + 1]
        patches.append(blur[pts[:, 1, None, None] + dy, pts[:, 0, None, None] + dx])
        bits.append(np.unpackbits(des, axis=1, bitorder="little"))
    return np.concatenate(patches).astype(np.int16), np.concatenate(bits).astype(bool)


def _agreement(flat: np.ndarray, bit: np.ndarray, i1: int, i2: int) -> float:
    return float(((flat[:, i1] < flat[:, i2]) == bit).mean())


def recover(patches: np.ndarray, bits: np.ndarray):
    """The pairs as ``[(x1, y1, x2, y2)] * 256`` and each one's agreement
    with cv2 over the probe keypoints."""
    n = patches.shape[0]
    flat = patches.reshape(n, -1).astype(np.float64)
    centred = flat - flat.mean(0)
    side = 2 * R + 1
    pairs, agree = [], []
    for j in range(bits.shape[1]):
        b = bits[:, j].astype(np.float64)
        corr = (b - b.mean()) @ centred
        i1, i2 = int(np.argmin(corr)), int(np.argmax(corr))
        best = (_agreement(flat, bits[:, j], i1, i2), i1, i2)
        if best[0] < 1.0:
            # Search the neighbourhoods of the two ends.
            cand1 = np.argsort(corr)[:25]
            cand2 = np.argsort(-corr)[:25]
            for c1 in cand1:
                for c2 in cand2:
                    a = _agreement(flat, bits[:, j], int(c1), int(c2))
                    if a > best[0]:
                        best = (a, int(c1), int(c2))
        a, i1, i2 = best
        y1, x1 = divmod(i1, side)
        y2, x2 = divmod(i2, side)
        pairs.append((x1 - R, y1 - R, x2 - R, y2 - R))
        agree.append(a)
    return pairs, agree


def check(pairs, patches: np.ndarray, bits: np.ndarray):
    """Per pair, the share of probe keypoints whose cv2 bit it reproduces."""
    side = 2 * R + 1
    flat = patches.reshape(patches.shape[0], -1)
    out = []
    for j, (x1, y1, x2, y2) in enumerate(pairs):
        i1 = (y1 + R) * side + (x1 + R)
        i2 = (y2 + R) * side + (x2 + R)
        out.append(_agreement(flat, bits[:, j], i1, i2))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--images", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--check", action="store_true",
                    help="hold the committed table to cv2 instead of recovering one")
    args = ap.parse_args(argv)
    import cv2

    patches, bits = probe(args.images, args.seed)
    print(f"cv2 {cv2.__version__}: {len(patches)} probe keypoints")
    if args.check:
        from deep_visual_slam_torch.ops.orb_pattern import BIT_PATTERN_31

        pairs = [tuple(p) for p in BIT_PATTERN_31]
        agree = check(pairs, patches, bits)
    else:
        pairs, agree = recover(patches, bits)
        print("BIT_PATTERN_31 = (")
        for k in range(0, len(pairs), 4):
            print("    " + " ".join(f"({x1}, {y1}, {x2}, {y2})," for x1, y1, x2, y2 in pairs[k:k + 4]))
        print(")")
    bad = [(j, pairs[j], a) for j, a in enumerate(agree) if a < 1.0]
    for j, p, a in bad:
        print(f"pair {j} {p}: agrees on {a:.5f} of the probe keypoints")
    print(f"{256 - len(bad)} of 256 pairs agree with cv2 on every probe keypoint")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
