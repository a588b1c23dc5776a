"""ORB detection and description in plain PyTorch, on the frame's device.

It computes what ``cv2.ORB_create(nfeatures=3000, scaleFactor=1.2,
nlevels=8, edgeThreshold=31, firstLevel=0, WTA_K=2, patchSize=31)`` and
``detectAndCompute`` compute (OpenCV's ``orb.cpp``), step by step and in the
same arithmetic, so that the port and the JAX package, which calls cv2, see
the same keypoints and descriptors:

1. The pyramid: level ``l`` has the size ``cvRound(W * (1 / 1.2f^l))`` in
   float32, and is resized from level ``l - 1`` by cv2's ``INTER_LINEAR_EXACT``
   (taps from correctly rounded doubles, 8-bit fixed-point weights rounded
   half to even, the two passes summed in integers and rounded half up).
2. FAST-9 at threshold 20 on every level: a corner has 9 contiguous pixels
   of the radius-3 circle all darker than ``v - 20`` or all brighter than
   ``v + 20``; its score is cv2's ``cornerScore`` (the largest threshold at
   which it stays a corner), and non-max suppression keeps a corner whose
   score is strictly above its 8 neighbours'. Keypoints closer than
   ``edgeThreshold`` (31) to a level's border are dropped.
3. Per level, the best ``2 n_l`` by FAST score, then the Harris response
   (block 7, k = 0.04, cv2's integer gradient sums and its float32
   expression), then the best ``n_l``. ``n_l`` is cv2's quota: a geometric
   series in 1/1.2 rounded per level, the remainder to the last level. cv2's
   ``retainBest`` keeps every keypoint whose score ties the n-th best, so
   the kept set does not depend on the order of ties; the port does the same.
4. The angle of the intensity centroid over the radius-15 disc, through
   cv2's ``fastAtan2`` polynomial in float32 (not ``atan2``).
5. The descriptor: each level smoothed by a 7x7, sigma 2 Gaussian as cv2
   smooths it inside its pyramid buffer (a sub-matrix, so the float separable
   filter, not the bit-exact fixed-point one: the row pass and the symmetric
   column pass are chains of fused multiply-adds in float32, emulated here
   in float64, where the row chain is exact), then the 256 pairs of
   ``orb_pattern.py`` rotated by the angle's float32 cos and sin and rounded
   half to even.

Order: cv2 orders the keypoints of a level as ``retainBest``'s
``nth_element`` and ``partition`` leave them, from FAST's raster order for
the ``2 n_l`` retain and then for the ``n_l`` one; the port runs libstdc++'s
algorithms step by step on the host (``_retain_best``), so the order within
a level is cv2's too, and with it the one-to-one match pass's choices
(``scripts/orb_order_gap.py``).

Every step is integer arithmetic or IEEE float32/float64 elementwise
operations, so the CPU and the card give the same keypoints and
descriptors; the only float64 sums that can round twice are the column
pass's, in a way that changes a pixel only when a float32 value lies within
2^-29 of a rounding boundary.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from deep_visual_slam_torch.ops.orb_pattern import BIT_PATTERN_31

NFEATURES = 3000
SCALE_FACTOR = 1.2
NLEVELS = 8
EDGE_THRESHOLD = 31
PATCH_SIZE = 31
FAST_THRESHOLD = 20
HARRIS_BLOCK = 7
HARRIS_K = np.float32(0.04)

# cv2.getGaussianKernel(7, 2, CV_32F): the float32 taps of ORB's blur.
_GAUSS7 = np.array(
    [0.07015932351350784, 0.13107487559318542, 0.1907128244638443,
     0.21610593795776367, 0.1907128244638443, 0.13107487559318542,
     0.07015932351350784], np.float32,
)

# FAST's radius-3 Bresenham circle as (dx, dy), in cyclic order.
_CIRCLE16 = (
    (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3),
)

# fastAtan2's polynomial, in degrees (float32 products, as cv2 forms them).
_ATAN_P = [
    np.float32(np.float32(c) * np.float32(180.0 / math.pi))
    for c in (0.9997878412794807, -0.3258083974640975, 0.1555786518463281,
              -0.04432655554792128)
]
_DBL_EPS_F32 = np.float32(np.finfo(np.float64).eps)


# ------------------------------------------------------------ host tables
def level_scales(nlevels: int = NLEVELS) -> List[np.float32]:
    """cv2's level scales: ``pow(1.2f, l)``, the factor held in float32,
    rounded to float32 (probed: level 3 is 1.7280002, not 1.728)."""
    f = float(np.float32(SCALE_FACTOR))
    return [np.float32(math.pow(f, l)) for l in range(nlevels)]


def level_sizes(H: int, W: int, nlevels: int = NLEVELS) -> List[Tuple[int, int]]:
    """``(h_l, w_l)``: ``cvRound(side * (1.0f / scale_l))`` in float32."""
    out = []
    for s in level_scales(nlevels):
        inv = np.float32(1.0) / s
        out.append((int(np.rint(np.float32(H) * inv)), int(np.rint(np.float32(W) * inv))))
    return out


def feature_quotas() -> List[int]:
    """cv2's per-level feature counts: a geometric series in ``1 / 1.2f``
    rounded per level, the remainder to the last."""
    factor = np.float32(1.0 / float(np.float32(SCALE_FACTOR)))
    desired = (np.float32(NFEATURES) * (np.float32(1) - factor)
               / (np.float32(1) - np.float32(math.pow(float(factor), NLEVELS))))
    out, total = [], 0
    for _ in range(NLEVELS - 1):
        n = int(np.rint(desired))
        out.append(n)
        total += n
        desired = np.float32(desired * factor)
    out.append(max(NFEATURES - total, 0))
    return out


@lru_cache(maxsize=None)
def _umax(half: int = PATCH_SIZE // 2) -> Tuple[int, ...]:
    """Half-widths of the circular patch's rows (cv2's ``umax``)."""
    umax = [0] * (half + 2)
    vmax = math.floor(half * float(np.sqrt(np.float32(2))) / 2 + 1)
    vmin = math.ceil(half * float(np.sqrt(np.float32(2))) / 2)
    for v in range(vmax + 1):
        umax[v] = int(np.rint(math.sqrt(half * half - v * v)))
    v0 = 0
    for v in range(half, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return tuple(umax)


@lru_cache(maxsize=None)
def _disc_offsets() -> Tuple[np.ndarray, np.ndarray]:
    """(u, v) of the radius-15 disc the intensity centroid sums over."""
    half = PATCH_SIZE // 2
    umax = _umax(half)
    us, vs = [], []
    for v in range(-half, half + 1):
        d = umax[abs(v)]
        for u in range(-d, d + 1):
            us.append(u)
            vs.append(v)
    return np.array(us, np.int64), np.array(vs, np.int64)


@lru_cache(maxsize=None)
def _linear_taps(src: int, dst: int) -> Tuple[np.ndarray, np.ndarray]:
    """``INTER_LINEAR_EXACT`` taps along one axis: first source index and
    the 8-bit fixed-point weight of the second (the first's is 256 minus
    it). Out-of-range positions take the edge pixel at weight 256."""
    scale = 1.0 / (dst / src)
    idx = np.zeros(dst, np.int64)
    w1 = np.zeros(dst, np.int64)
    for i in range(dst):
        fval = scale * (i + 0.5) - 0.5
        ival = math.floor(fval)
        if ival >= 0 and src > 1:
            if ival < src - 1:
                idx[i] = ival
                w1[i] = round((fval - ival) * 256.0)  # half to even
            else:
                idx[i] = src - 1
        # ival < 0: idx 0, weight 0 on the second tap
    return idx, w1


_DEVICE_CACHE: Dict[Tuple, torch.Tensor] = {}


def _on(device: torch.device, key, make) -> torch.Tensor:
    """A constant tensor built once per device."""
    k = (str(device),) + key
    t = _DEVICE_CACHE.get(k)
    if t is None:
        t = make().to(device)
        _DEVICE_CACHE[k] = t
    return t


# ---------------------------------------------------------------- pyramid
def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """``cv2.cvtColor(COLOR_RGB2GRAY)`` of a uint8 ``[H, W, 3]`` tensor:
    ``(9798 R + 19235 G + 3735 B + 2^14) >> 15``."""
    c = rgb.to(torch.int32)
    y = c[..., 0] * 9798 + c[..., 1] * 19235 + c[..., 2] * 3735 + (1 << 14)
    return (y >> 15).to(torch.uint8)


def resize_linear_exact(img: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """``cv2.resize(img, (w, h), interpolation=INTER_LINEAR_EXACT)`` of a
    uint8 ``[h0, w0]`` tensor."""
    h0, w0 = img.shape
    h, w = size
    dev = img.device

    def taps(src, dst):
        return (
            _on(dev, ("taps", src, dst, 0), lambda: torch.from_numpy(_linear_taps(src, dst)[0])),
            _on(dev, ("taps", src, dst, 1), lambda: torch.from_numpy(_linear_taps(src, dst)[1]).to(torch.int32)),
        )

    xi, xw = taps(w0, w)
    yi, yw = taps(h0, h)
    s = img.to(torch.int32)
    x2 = torch.clamp(xi + 1, max=w0 - 1)
    hrow = s[:, xi] * (256 - xw) + s[:, x2] * xw  # [h0, w], 1/256 units
    y2 = torch.clamp(yi + 1, max=h0 - 1)
    acc = hrow[yi] * (256 - yw)[:, None] + hrow[y2] * yw[:, None]  # 1/65536 units
    return ((acc + (1 << 15)) >> 16).clamp(0, 255).to(torch.uint8)


def build_pyramid(gray: torch.Tensor, nlevels: int = NLEVELS) -> List[torch.Tensor]:
    """ORB's pyramid: level 0 is the frame, level ``l`` is resized from
    level ``l - 1`` to ``level_sizes``."""
    H, W = gray.shape
    levels = [gray]
    for size in level_sizes(H, W, nlevels)[1:]:
        levels.append(resize_linear_exact(levels[-1], size))
    return levels


# ------------------------------------------------------------------- FAST
def fast_scores(img: torch.Tensor) -> torch.Tensor:
    """FAST-9 corners of a uint8 ``[h, w]`` level after non-max suppression:
    an int32 ``[h, w]`` map of cv2's corner score at the corners, 0
    elsewhere."""
    h, w = img.shape
    out = torch.zeros((h, w), dtype=torch.int32, device=img.device)
    if h < 7 or w < 7:
        return out
    s = img.to(torch.int16)
    c = s[3:h - 3, 3:w - 3]
    # The circle's differences, its first 8 repeated: arc k is d[k:k + 9].
    circle = _CIRCLE16 + _CIRCLE16[:8]
    d = torch.stack([c - s[3 + dy:h - 3 + dy, 3 + dx:w - 3 + dx] for dx, dy in circle])
    # Minimum and maximum over each arc of 9, by doubling (2, 4, 8, then 9).
    lo, hi = d, d
    for span in (1, 2, 4):
        n = lo.shape[0] - span
        lo = torch.minimum(lo[:n], lo[span:])
        hi = torch.maximum(hi[:n], hi[span:])
    lo = torch.minimum(lo[:16], d[8:24])
    hi = torch.maximum(hi[:16], d[8:24])
    best = torch.maximum(lo.amax(0), (-hi).amax(0)).to(torch.int32)
    score = torch.where(best > FAST_THRESHOLD, best - 1, torch.zeros_like(best))
    out[3:h - 3, 3:w - 3] = score
    p = F.pad(out, (1, 1, 1, 1))
    nb = None
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            if dy == 1 and dx == 1:
                continue
            v = p[dy:dy + h, dx:dx + w]
            nb = v if nb is None else torch.maximum(nb, v)
    return torch.where(out > nb, out, torch.zeros_like(out))


def _retain_best(score: torch.Tensor, n: int) -> torch.Tensor:
    """cv2's ``KeyPointsFilter::retainBest(keypoints, n)`` on the entries of
    ``score`` (1-D, the keypoints' responses in their order): the indices of
    the kept entries in the order it leaves them, int64 on the host. The
    kept set is every entry scoring at least the n-th best (all ties of
    it); the order is what libstdc++'s ``std::nth_element(begin, begin + n
    - 1, end, response greater)`` and then ``std::partition(begin + n, end,
    response >= the n-th's)`` make of the given order, step by step:
    introselect with the median of three moved to the front, an unguarded
    partition, a heap select once the depth limit of 2 floor(log2 size) is
    spent and an insertion sort once 3 or fewer entries remain."""
    a = list(range(score.numel()))
    if len(a) <= n:
        return torch.tensor(a, dtype=torch.int64)
    if n == 0:
        return torch.zeros(0, dtype=torch.int64)
    v = score.tolist()

    def adjust_heap(first, hole, length, x):  # std::__adjust_heap, then __push_heap
        top = child = hole
        while child < (length - 1) // 2:
            child = 2 * (child + 1)
            if v[a[first + child]] > v[a[first + child - 1]]:
                child -= 1
            a[first + hole] = a[first + child]
            hole = child
        if length % 2 == 0 and child == (length - 2) // 2:
            child = 2 * (child + 1)
            a[first + hole] = a[first + child - 1]
            hole = child - 1
        parent = (hole - 1) // 2
        while hole > top and v[a[first + parent]] > v[x]:
            a[first + hole] = a[first + parent]
            hole = parent
            parent = (hole - 1) // 2
        a[first + hole] = x

    first, nth, last = 0, n - 1, len(a)
    depth = 2 * (last.bit_length() - 1)
    while last - first > 3:
        if depth == 0:  # std::__heap_select(first, nth + 1, last), then swap first, nth
            length = nth + 1 - first
            if length >= 2:
                for parent in range((length - 2) // 2, -1, -1):
                    adjust_heap(first, parent, length, a[first + parent])
            for i in range(nth + 1, last):
                if v[a[i]] > v[a[first]]:
                    x, a[i] = a[i], a[first]
                    adjust_heap(first, 0, length, x)
            a[first], a[nth] = a[nth], a[first]
            break
        depth -= 1
        # std::__move_median_to_first(first, first + 1, mid, last - 1)
        x, y, z = first + 1, first + (last - first) // 2, last - 1
        vx, vy, vz = v[a[x]], v[a[y]], v[a[z]]
        if vx > vy:
            m = y if vy > vz else (z if vx > vz else x)
        else:
            m = x if vx > vz else (z if vy > vz else y)
        a[first], a[m] = a[m], a[first]
        # std::__unguarded_partition(first + 1, last, pivot = first)
        pivot = v[a[first]]
        lo, hi = first + 1, last
        while True:
            while v[a[lo]] > pivot:
                lo += 1
            hi -= 1
            while pivot > v[a[hi]]:
                hi -= 1
            if lo >= hi:
                break
            a[lo], a[hi] = a[hi], a[lo]
            lo += 1
        if lo <= nth:
            first = lo
        else:
            last = lo
    else:  # std::__insertion_sort(first, last)
        for i in range(first + 1, last):
            x, j = a[i], i
            if v[x] > v[a[first]]:
                a[first + 1:i + 1] = a[first:i]
                a[first] = x
                continue
            while v[x] > v[a[j - 1]]:
                a[j] = a[j - 1]
                j -= 1
            a[j] = x
    # std::partition(begin + n, end, response >= threshold), bidirectional.
    threshold = v[a[n - 1]]
    lo, hi = n, len(a)
    while True:
        while lo != hi and v[a[lo]] >= threshold:
            lo += 1
        if lo == hi:
            break
        hi -= 1
        while lo != hi and not v[a[hi]] >= threshold:
            hi -= 1
        if lo == hi:
            break
        a[lo], a[hi] = a[hi], a[lo]
        lo += 1
    return torch.tensor(a[:lo], dtype=torch.int64)


# ------------------------------------------------------------ Harris, angle
def harris_response(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """cv2's ORB ``HarrisResponses`` at integer positions (at least
    ``block // 2 + 1`` from the border): Sobel-like integer gradients summed
    over the block, then ``(a b - c^2 - k (a + b)^2) * scale^4`` in float32."""
    s = img.to(torch.int32)
    h, w = s.shape
    Ix = ((s[1:-1, 2:] - s[1:-1, :-2]) * 2 + (s[:-2, 2:] - s[:-2, :-2])
          + (s[2:, 2:] - s[2:, :-2]))
    Iy = ((s[2:, 1:-1] - s[:-2, 1:-1]) * 2 + (s[2:, :-2] - s[:-2, :-2])
          + (s[2:, 2:] - s[:-2, 2:]))
    # Gradient maps cover [1, h-1) x [1, w-1).
    block = HARRIS_BLOCK
    r = block // 2
    dy, dx = torch.meshgrid(
        torch.arange(-r, r + 1, device=img.device), torch.arange(-r, r + 1, device=img.device),
        indexing="ij",
    )
    flat = ((ys[:, None] - 1 + dy.reshape(1, -1)) * (w - 2) + (xs[:, None] - 1 + dx.reshape(1, -1)))
    gx = Ix.reshape(-1)[flat].to(torch.int64)
    gy = Iy.reshape(-1)[flat].to(torch.int64)
    a = (gx * gx).sum(1).to(torch.float32)
    b = (gy * gy).sum(1).to(torch.float32)
    c = (gx * gy).sum(1).to(torch.float32)
    scale = np.float32(1.0) / (np.float32((1 << 2) * block) * np.float32(255.0))
    scale4 = np.float32(np.float32(np.float32(scale * scale) * scale) * scale)
    ab = a + b
    resp = ((a * b - c * c) - (ab * float(HARRIS_K)) * ab) * float(scale4)
    return resp


def fast_atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """cv2's ``fastAtan2`` in degrees [0, 360), float32, operation by
    operation."""
    ax, ay = x.abs(), y.abs()
    eps = float(_DBL_EPS_F32)
    steep = ay > ax
    c = torch.where(steep, ax / (ay + eps), ay / (ax + eps))
    c2 = c * c
    p1, p3, p5, p7 = (float(p) for p in _ATAN_P)
    a = (((c2 * p7 + p5) * c2 + p3) * c2 + p1) * c
    a = torch.where(steep, 90.0 - a, a)
    a = torch.where(x < 0, 180.0 - a, a)
    a = torch.where(y < 0, 360.0 - a, a)
    return a


def ic_angle(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation in degrees (cv2's ``ICAngles``): the
    integer moments over the radius-15 disc, then ``fastAtan2(m01, m10)``."""
    us, vs = _disc_offsets()
    dev = img.device
    u = _on(dev, ("disc_u",), lambda: torch.from_numpy(us))
    v = _on(dev, ("disc_v",), lambda: torch.from_numpy(vs))
    w = img.shape[1]
    vals = img.reshape(-1)[(ys[:, None] + v[None]) * w + xs[:, None] + u[None]].to(torch.int64)
    m10 = (vals * u[None]).sum(1)
    m01 = (vals * v[None]).sum(1)
    return fast_atan2(m01.to(torch.float32), m10.to(torch.float32))


# ------------------------------------------------------------- descriptor
def gaussian_blur(img: torch.Tensor) -> torch.Tensor:
    """ORB's 7x7, sigma 2 blur of a uint8 ``[h, w]`` level: cv2's float
    separable filter with ``BORDER_REFLECT_101``. The row pass is the chain
    ``s = fma(x_t, k_t, s)`` from 0, the column pass ``fma(s_0, k_3, 0)``
    then ``fma(s_t + s_-t, k_{3+t}, acc)``, each rounded to float32, and
    the result rounded half to even."""
    h, w = img.shape
    k = [float(v) for v in _GAUSS7]
    x = F.pad(img.to(torch.float64)[None, None], (3, 3, 3, 3), mode="reflect")[0, 0]

    def f32(t):
        return t.to(torch.float32).to(torch.float64)

    s = f32(x[:, 0:w] * k[0])
    for t in range(1, 7):
        s = f32(x[:, t:t + w] * k[t] + s)
    acc = f32(s[3:3 + h] * k[3])
    for t in range(1, 4):
        pair = f32(s[3 + t:3 + t + h] + s[3 - t:3 - t + h])
        acc = f32(pair * k[3 + t] + acc)
    return torch.round(acc.to(torch.float32)).clamp(0, 255).to(torch.uint8)


def _pattern(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pattern's 512 points as float32 (x, y), pairs interleaved."""
    def make(col):
        p = np.asarray(BIT_PATTERN_31, np.float32).reshape(-1, 2)
        return torch.from_numpy(np.ascontiguousarray(p[:, col]))
    return (_on(device, ("pat_x",), lambda: make(0)), _on(device, ("pat_y",), lambda: make(1)))


def describe(blurred: List[torch.Tensor], octave: torch.Tensor, cx: torch.Tensor,
             cy: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """``[N, 32]`` uint8 descriptors at level positions ``(cx, cy)`` of the
    smoothed levels, the pattern rotated by ``angle`` (degrees, float32):
    cv2's ``computeOrbDescriptors`` with ``WTA_K=2``."""
    dev = cx.device
    if cx.numel() == 0:
        return torch.zeros((0, 32), dtype=torch.uint8, device=dev)
    rad = angle * float(np.float32(math.pi / 180.0))
    a = torch.cos(rad.to(torch.float64)).to(torch.float32)
    b = torch.sin(rad.to(torch.float64)).to(torch.float32)
    px, py = _pattern(dev)
    x = px[None] * a[:, None] - py[None] * b[:, None]
    y = px[None] * b[:, None] + py[None] * a[:, None]
    ix = torch.round(x).to(torch.int64)
    iy = torch.round(y).to(torch.int64)
    widths = [t.shape[1] for t in blurred]
    offsets = np.cumsum([0] + [t.numel() for t in blurred])[:-1]
    meta = torch.tensor(np.stack([offsets, widths], 1), dtype=torch.int64).to(dev)[octave]
    buf = torch.cat([t.reshape(-1) for t in blurred])
    base = meta[:, 0] + cy * meta[:, 1] + cx
    vals = buf[base[:, None] + iy * meta[:, 1:] + ix]
    bits = (vals[:, 0::2] < vals[:, 1::2]).to(torch.int32).reshape(-1, 32, 8)
    weights = (1 << torch.arange(8, device=dev, dtype=torch.int32))
    return (bits * weights).sum(-1).to(torch.uint8)


# ------------------------------------------------------------------ entry
def detect_and_compute(gray: torch.Tensor):
    """ORB keypoints and descriptors of a uint8 ``[H, W]`` tensor, on its
    device: ``(pts [N, 2] float32 level-0 (x, y), octave [N] int64, angle [N]
    float32 degrees, response [N] float32 Harris, descriptors [N, 32]
    uint8)``, by level, each level in cv2's order."""
    if gray.dtype != torch.uint8 or gray.dim() != 2:
        raise ValueError(f"expected a uint8 [H, W] tensor, got {gray.dtype} {tuple(gray.shape)}")
    dev = gray.device
    H, W = gray.shape
    levels = build_pyramid(gray)
    scales = level_scales()
    quotas = feature_quotas()
    e = EDGE_THRESHOLD
    per = []
    for l, img in enumerate(levels):
        h, w = img.shape
        if h <= 2 * e or w <= 2 * e or quotas[l] == 0:
            continue
        score = fast_scores(img)
        inner = score[e:h - e, e:w - e]
        ys, xs = torch.nonzero(inner, as_tuple=True)  # raster order
        fs = inner[ys, xs]
        ys, xs = ys + e, xs + e
        keep = _retain_best(fs, 2 * quotas[l]).to(dev)
        ys, xs = ys[keep], xs[keep]
        resp = harris_response(img, ys, xs)
        keep = _retain_best(resp, quotas[l]).to(dev)
        per.append((l, ys[keep], xs[keep], resp[keep]))
    if not per:
        empty = torch.zeros(0, device=dev)
        return (empty.reshape(0, 2), empty.to(torch.int64), empty, empty,
                torch.zeros((0, 32), dtype=torch.uint8, device=dev))
    octave = torch.cat([torch.full_like(ys, l) for l, ys, _, _ in per])
    ys = torch.cat([p[1] for p in per])
    xs = torch.cat([p[2] for p in per])
    resp = torch.cat([p[3] for p in per])
    angle = torch.cat([ic_angle(levels[l], y, x) for l, y, x, _ in per])
    blurred = [gaussian_blur(img) for img in levels]
    des = describe(blurred, octave, xs, ys, angle)
    sf = _on(dev, ("scales", NLEVELS), lambda: torch.from_numpy(np.array(scales, np.float32)))[octave]
    pts = torch.stack([xs.to(torch.float32) * sf, ys.to(torch.float32) * sf], 1)
    return pts, octave, angle, resp, des


def compute(gray: torch.Tensor, pts: torch.Tensor, octave: torch.Tensor,
            angle: torch.Tensor) -> torch.Tensor:
    """Descriptors at given keypoints (level-0 float32 positions, octaves,
    angles in degrees), as cv2's ``ORB.compute`` with keypoints whose angle
    is kept: the level position is ``cvRound(pt * (1 / scale))``."""
    levels = build_pyramid(gray, int(octave.max().item()) + 1 if octave.numel() else 1)
    inv = torch.from_numpy(np.array([np.float32(1.0) / s for s in level_scales()], np.float32))
    inv = inv.to(gray.device)[octave]
    cx = torch.round(pts[:, 0] * inv).to(torch.int64)
    cy = torch.round(pts[:, 1] * inv).to(torch.int64)
    blurred = [gaussian_blur(img) for img in levels]
    return describe(blurred, octave, cx, cy, angle)
