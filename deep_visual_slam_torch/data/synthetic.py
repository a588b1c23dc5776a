"""Synthetic VO snippets and stereo pairs with known depth, pose and
intrinsics (port of ``data/synthetic.py``).

A textured slanted plane is rendered into photometrically consistent
(left, target, right) frames with the port's own warp ops, so the VO loss
has a known optimum at the true pose. Textures and poses are drawn with
numpy from ``seed``, as in the JAX package; the rendering runs in torch on
the requested device.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from deep_visual_slam_torch import resolve_device
from deep_visual_slam_torch.ops import (
    backproject,
    grid_sample,
    invert_se3,
    project,
    transformation_from_parameters,
)


def _box_blur_1d(x: np.ndarray, axis: int, k: int) -> np.ndarray:
    """Zero-padded 'same' box filter along ``axis`` via cumulative sums."""
    h = k // 2
    x = np.moveaxis(x, axis, -1)
    pad = np.zeros(x.shape[:-1] + (x.shape[-1] + k,), np.float64)
    pad[..., h + 1 : h + 1 + x.shape[-1]] = x
    cs = np.cumsum(pad, axis=-1)
    out = (cs[..., k:] - cs[..., :-k]) / k
    return np.moveaxis(out.astype(np.float32), -1, axis)


def smooth_texture(
    rng: np.random.Generator, batch: int, height: int, width: int, sigma: int = 4
) -> np.ndarray:
    """Band-limited random RGB texture in [0, 1] (bilinear-friendly)."""
    base = rng.uniform(size=(batch, height, width, 3)).astype(np.float32)
    k = 2 * sigma + 1
    for axis in (1, 2):
        base = _box_blur_1d(base, axis, k)
    lo = base.min(axis=(1, 2, 3), keepdims=True)
    hi = base.max(axis=(1, 2, 3), keepdims=True)
    return (base - lo) / np.maximum(hi - lo, 1e-6)


def plane_depth(
    batch: int, height: int, width: int, z0: float = 2.0, slope: float = 0.3
) -> np.ndarray:
    """Slanted-plane depth map in meters: z = z0 + slope * (v/H - 0.5)."""
    v = np.linspace(-0.5, 0.5, height, dtype=np.float32)[None, :, None]
    return np.broadcast_to(z0 + slope * v, (batch, height, width)).copy()


def default_intrinsics(height: int, width: int) -> np.ndarray:
    """Redwood-style intrinsics rescaled to the target size (fx=fy=525 at
    640x480), as a 4x4 fp32 matrix."""
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = 525.0 * width / 640.0
    K[1, 1] = 525.0 * height / 480.0
    K[0, 2] = (width - 1) / 2.0
    K[1, 2] = (height - 1) / 2.0
    return K


def synthetic_vo_batch(
    seed: int,
    batch_size: int,
    height: int,
    width: int,
    max_translation: float = 0.05,
    max_rotation: float = 0.01,
    device=None,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Photometrically consistent (left, target, right) snippet batch.

    Returns ``(batch, truth)``: ``batch`` feeds the VO loss (keys
    source_left/target_image/source_right/K/inv_K), ``truth`` holds the
    generating poses ``T_left``/``T_right`` (target -> source) and the depth.
    """
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    target = torch.from_numpy(smooth_texture(rng, batch_size, height, width)).to(device)
    depth = torch.from_numpy(plane_depth(batch_size, height, width)).to(device)
    K = torch.from_numpy(default_intrinsics(height, width)).to(device)
    K = K.expand(batch_size, 4, 4).contiguous()
    inv_K = torch.linalg.inv(K)

    def rand_pose():
        aa = rng.uniform(-max_rotation, max_rotation, size=(batch_size, 3))
        t = rng.uniform(-max_translation, max_translation, size=(batch_size, 3))
        return transformation_from_parameters(
            torch.from_numpy(aa.astype(np.float32)).to(device),
            torch.from_numpy(t.astype(np.float32)).to(device),
        )

    # T maps target-frame points into the source camera; rendering the
    # source view samples the target image at the inverse warp.
    T_left = rand_pose()
    T_right = rand_pose()
    pts = backproject(depth, inv_K)

    def render(T):
        grid = project(pts, K, T)
        return grid_sample(target, grid, align_corners=True, padding_mode="border")

    batch = {
        "source_left": render(invert_se3(T_left)),
        "target_image": target,
        "source_right": render(invert_se3(T_right)),
        "K": K,
        "inv_K": inv_K,
    }
    truth = {"T_left": T_left, "T_right": T_right, "depth": depth}
    return batch, truth


def _stereo_draw(seed: int, i: int, height: int, width: int):
    """Texture [1, H, W, 3] and plane depth [1, H, W] of stereo pair ``i``,
    drawn from ``default_rng((seed, i))``."""
    rng = np.random.default_rng((seed, i))
    texture = smooth_texture(rng, 1, height, width)
    return texture, plane_depth(1, height, width, z0=float(rng.uniform(1.5, 3.0)))


def _render_stereo(target: torch.Tensor, depth: torch.Tensor, baseline: float):
    """The source view of a rectified pair whose source camera sits at
    +baseline along x: (source, K, T), ``T`` mapping target-frame points
    into the source camera."""
    B, H, W = depth.shape
    K = torch.from_numpy(default_intrinsics(H, W)).to(depth.device)
    K = K.expand(B, 4, 4).contiguous()
    T = torch.eye(4, device=depth.device).repeat(B, 1, 1)
    T[:, 0, 3] = -baseline
    grid = project(backproject(depth, torch.linalg.inv(K)), K, invert_se3(T))
    source = grid_sample(target, grid, align_corners=True, padding_mode="border")
    return source, K, T


def synthetic_stereo_batch(
    seed: int,
    batch_size: int,
    height: int,
    width: int,
    baseline: float = 0.1,
    device=None,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Rectified stereo pairs with an exactly known baseline pose: the batch
    of :class:`SyntheticStereoDataset` items 0 .. batch_size-1.

    Returns ``(batch, truth)``: ``batch`` feeds the stereo loss (keys
    source_image / target_image / intrinsic / pose, ``pose`` mapping
    target-frame points into the source camera, which sits at +baseline
    along x), ``truth`` holds the plane depth.
    """
    device = resolve_device(device)
    draws = [_stereo_draw(seed, i, height, width) for i in range(batch_size)]
    target = torch.from_numpy(np.concatenate([t for t, _ in draws])).to(device)
    depth = torch.from_numpy(np.concatenate([d for _, d in draws])).to(device)
    source, K, T = _render_stereo(target, depth, baseline)
    batch = {"source_image": source, "target_image": target, "intrinsic": K, "pose": T}
    return batch, {"depth": depth}


class SyntheticStereoDataset:
    """Rendered stereo pairs with an exactly known baseline, as indexable
    samples ``{source_image, target_image, intrinsic, pose, depth}`` (numpy);
    item ``idx`` is drawn from ``default_rng((seed, idx))`` and rendered on
    the CPU. ``pose`` maps target-frame points into the source camera, so
    the photometric optimum is at the true depth."""

    def __init__(
        self,
        image_size: Tuple[int, int],
        length: int = 64,
        baseline: float = 0.1,
        seed: int = 0,
        is_train: bool = True,
    ):
        self.image_size = image_size
        self.length = length
        self.baseline = baseline
        self.seed = seed
        self.is_train = is_train

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, idx: int, rng=None) -> Dict:
        H, W = self.image_size
        target, depth = _stereo_draw(self.seed, idx, H, W)
        source, K, T = _render_stereo(
            torch.from_numpy(target), torch.from_numpy(depth), self.baseline
        )
        return {
            "source_image": source[0].numpy(),
            "target_image": target[0],
            "intrinsic": K[0].numpy(),
            "pose": T[0].numpy(),
            "depth": depth[0],
        }


def synthetic_slam_sequence(
    n_frames: int,
    height: int,
    width: int,
    seed: int = 0,
    step_translation: float = 0.01,
    step_rotation: float = 0.002,
    distractor: "str | None" = None,
    flicker_amp: float = 0.3,
    device=None,
):
    """Temporally coherent camera sweep over the slanted plane, for the SLAM
    loop: ``(frames [N, H, W, 3] fp32 in [0, 1], K [4, 4], gt_T_cw
    [N, 4, 4])`` as numpy. The texture is high-contrast (8x8 cells mixed
    with ``smooth_texture``) so that the tracker finds corners; each frame
    is the plane seen along a random walk (inverse-warp render, as
    :func:`synthetic_vo_batch`), drawn with numpy from ``seed`` and rendered
    on ``device``.

    ``distractor="flicker"`` replaces a rectangle of the plane with
    :func:`_distractor_texture`, its gain swinging by ``flicker_amp`` per
    frame (the geometry is untouched; only photometric constancy breaks),
    and adds a fourth element, ``masks [N, H, W] bool``, of the pixels that
    sample the patch.
    """
    if distractor not in (None, "none", "flicker"):
        raise ValueError(f"slam_sequence distractor must be 'flicker' (got {distractor!r})")
    if distractor == "none":
        distractor = None
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    cells = rng.uniform(size=(height // 8 + 1, width // 8 + 1, 3)).astype(np.float32)
    blocky = np.repeat(np.repeat(cells, 8, axis=0), 8, axis=1)[:height, :width]
    tex = 0.75 * blocky + 0.25 * smooth_texture(rng, 1, height, width)[0]

    if distractor:
        drng = np.random.default_rng(seed * 7919 + 13)
        gains = 1.0 + flicker_amp * drng.uniform(-1, 1, size=n_frames)
        r0, r1 = int(0.15 * height), int(0.45 * height)
        c0, c1 = int(0.55 * width), int(0.85 * width)
        jj, ii = np.meshgrid(np.arange(c0, c1), np.arange(r0, r1))
        # ~12 px checker period at any resolution.
        patch = _distractor_texture(jj * 0.005, ii * 0.005)
        patch_mask = np.zeros((1, height, width, 1), np.float32)
        patch_mask[0, r0:r1, c0:c1, 0] = 1.0
        mask_dev = torch.from_numpy(patch_mask).to(device)

    def tex_for(i):
        if not distractor:
            return tex
        t = tex.copy()
        t[r0:r1, c0:c1] = np.clip(patch * gains[i], 0.0, 1.0)
        return t

    target = torch.from_numpy(tex_for(0)[None]).to(device)
    depth = torch.from_numpy(plane_depth(1, height, width)).to(device)
    K_np = default_intrinsics(height, width)
    K = torch.from_numpy(K_np[None]).to(device)
    pts = backproject(depth, torch.linalg.inv(K))

    frames = [target[0].cpu().numpy()]
    poses = [np.eye(4, dtype=np.float32)]
    masks = [patch_mask[0, ..., 0] > 0.5] if distractor else None
    T_cw = torch.eye(4, device=device)[None]
    for i in range(1, n_frames):
        aa = rng.uniform(-step_rotation, step_rotation, size=(1, 3)).astype(np.float32)
        t = rng.uniform(-step_translation, step_translation, size=(1, 3)).astype(np.float32)
        T_rel = transformation_from_parameters(
            torch.from_numpy(aa).to(device), torch.from_numpy(t).to(device)
        )
        T_cw = T_rel @ T_cw
        grid = project(pts, K, invert_se3(T_cw))
        if distractor:
            target = torch.from_numpy(tex_for(i)[None]).to(device)
        view = grid_sample(target, grid, align_corners=True, padding_mode="border")
        frames.append(view[0].cpu().numpy())
        poses.append(T_cw[0].cpu().numpy().astype(np.float32))
        if distractor:
            m = grid_sample(mask_dev, grid, align_corners=True, padding_mode="zeros")
            masks.append(m[0, ..., 0].cpu().numpy() > 0.5)
    out = (np.stack(frames).astype(np.float32), K_np.astype(np.float32), np.stack(poses))
    if distractor:
        return out + (np.stack(masks),)
    return out


def _distractor_texture(x: np.ndarray, y: np.ndarray, cell: float = 0.06) -> np.ndarray:
    """Magenta/green checker over world (x, y), continuous (sharpened) at
    cell edges: the texture of the photometric-violation slab."""
    u, v = x / cell, y / cell
    iu, iv = np.floor(u), np.floor(v)
    fu, fv = u - iu, v - iv
    su = np.clip((fu - 0.4) / 0.2, 0.0, 1.0)
    sv = np.clip((fv - 0.4) / 0.2, 0.0, 1.0)
    par = (iu + iv) % 2
    t = par + (1 - 2 * par) * (su + sv - 2 * su * sv)
    t = np.asarray(t, np.float32)[..., None]
    magenta = np.array([0.95, 0.08, 0.90], np.float32)
    green = np.array([0.08, 0.90, 0.15], np.float32)
    return t * magenta + (1.0 - t) * green


def _hash_cells(ix: np.ndarray, iy: np.ndarray, salt: float) -> np.ndarray:
    """Deterministic pseudo-random RGB per integer cell (a trig hash)."""
    out = []
    for k, mul in enumerate((12.9898, 39.3468, 73.156)):
        v = np.sin(ix * mul + iy * (78.233 + 11.0 * k) + salt * 37.719) * 43758.5453
        out.append(v - np.floor(v))
    return np.stack(out, axis=-1).astype(np.float32)


def _cell_texture(x: np.ndarray, y: np.ndarray, salt: float, cell: float) -> np.ndarray:
    """Bilinear mix of hashed cell colours over world (x, y) with a
    sharpened but continuous transition: corners at every cell junction,
    no aliasing for the photometric residuals."""
    u, v = x / cell, y / cell
    iu, iv = np.floor(u), np.floor(v)
    fu, fv = u - iu, v - iv
    su = np.clip((fu - 0.35) / 0.3, 0.0, 1.0)[..., None]
    sv = np.clip((fv - 0.35) / 0.3, 0.0, 1.0)[..., None]
    c00 = _hash_cells(iu, iv, salt)
    c01 = _hash_cells(iu + 1, iv, salt)
    c10 = _hash_cells(iu, iv + 1, salt)
    c11 = _hash_cells(iu + 1, iv + 1, salt)
    top = c00 * (1 - su) + c01 * su
    bot = c10 * (1 - su) + c11 * su
    return top * (1 - sv) + bot * sv


def synthetic_multidepth_sequence(
    n_frames: int,
    height: int,
    width: int,
    seed: int = 0,
    step_translation: float = 0.01,
    step_rotation: float = 0.002,
    distractor: "str | None" = None,
    flicker_amp: float = 0.3,
    move_amp: float = 0.18,
):
    """Ray-cast camera sweep over a piecewise-planar scene (a background
    plane and three slabs at other depths), each frame rendered exactly in
    numpy (ray/plane intersection, z-buffer, texture at the world hit).

    Returns ``(frames [N, H, W, 3], K [4, 4], gt_T_cw [N, 4, 4],
    depths [N, H, W])`` with exact metric depth per frame; the depth
    discontinuities make bundle adjustment identifiable. ``distractor``
    adds a slab that breaks photometric constancy (``"flicker"``: its gain
    swings by ``flicker_amp`` per frame; ``"moving"``: it slides along
    world x by up to ``move_amp`` m) and a fifth element, ``masks
    [N, H, W] bool``, of the pixels it covers.
    """
    if distractor not in (None, "none", "flicker", "moving"):
        raise ValueError(f"unknown distractor {distractor!r}")
    if distractor == "none":
        distractor = None
    rng = np.random.default_rng(seed)
    K = default_intrinsics(height, width)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]

    # (x0, x1, y0, y1, z, cell, salt) in the frame-0 camera (= world).
    inf = np.inf
    slabs = [
        (-inf, inf, -inf, inf, 3.2, 0.14, 1.0),
        (-1.3, -0.15, -1.0, 0.35, 1.9, 0.09, 2.0),
        (0.2, 1.5, -0.45, 1.0, 2.5, 0.11, 3.0),
        (-0.5, 0.45, 0.5, 1.6, 1.6, 0.08, 4.0),
    ]
    d_bounds, d_z = (-0.05, 0.75, -1.05, -0.3), 2.2
    if distractor:
        drng = np.random.default_rng(seed * 7919 + 13)
        gains = 1.0 + flicker_amp * drng.uniform(-1, 1, size=n_frames)
        offsets = move_amp * np.sin(2 * np.pi * np.arange(n_frames) / max(n_frames - 1, 1))

    u, v = np.meshgrid(np.arange(width, dtype=np.float64), np.arange(height, dtype=np.float64))
    d_cam = np.stack([(u - cx) / fx, (v - cy) / fy, np.ones_like(u)], -1)

    frames, depths, poses, masks = [], [], [], []
    T_cw = np.eye(4, dtype=np.float64)
    for i in range(n_frames):
        if i:
            aa = rng.uniform(-step_rotation, step_rotation, size=(1, 3)).astype(np.float32)
            t = rng.uniform(-step_translation, step_translation, size=(1, 3)).astype(np.float32)
            T_rel = transformation_from_parameters(torch.from_numpy(aa), torch.from_numpy(t))
            T_cw = T_rel[0].numpy().astype(np.float64) @ T_cw
        T_wc = np.linalg.inv(T_cw)
        C = T_wc[:3, 3]
        d_w = d_cam @ T_wc[:3, :3].T  # d_cam.z = 1, so lam is the camera depth

        frame_slabs = list(slabs)
        if distractor:
            ox = offsets[i] if distractor == "moving" else 0.0
            x0, x1, y0, y1 = d_bounds
            frame_slabs.append((x0 + ox, x1 + ox, y0, y1, d_z, "distractor", ox))

        best_lam = np.full((height, width), 1e6)
        img = np.zeros((height, width, 3), np.float32)
        dmask = np.zeros((height, width), bool)
        for (x0, x1, y0, y1, z0, cell, salt) in frame_slabs:
            dz = d_w[..., 2]
            lam = (z0 - C[2]) / np.where(np.abs(dz) < 1e-9, 1e-9, dz)
            Xx = C[0] + lam * d_w[..., 0]
            Xy = C[1] + lam * d_w[..., 1]
            hit = (
                (lam > 1e-3) & (lam < best_lam)
                & (Xx >= x0) & (Xx <= x1) & (Xy >= y0) & (Xy <= y1)
            )
            if not hit.any():
                continue
            if cell == "distractor":
                tex = _distractor_texture(Xx[hit] - salt, Xy[hit])
                if distractor == "flicker":
                    tex = np.clip(tex * gains[i], 0.0, 1.0)
                dmask = hit
            else:
                tex = _cell_texture(Xx[hit], Xy[hit], salt, cell)
            img[hit] = tex
            best_lam = np.where(hit, lam, best_lam)
        frames.append(img)
        depths.append(best_lam.astype(np.float32))
        poses.append(T_cw.astype(np.float32).copy())
        masks.append(dmask)

    out = (np.stack(frames), K.astype(np.float32), np.stack(poses), np.stack(depths))
    if distractor:
        return out + (np.stack(masks),)
    return out


class SyntheticVoDataset:
    """Indexable synthetic snippets with the :class:`SnippetDataset`
    interface: item ``idx`` is the photometrically consistent triplet of
    ``synthetic_vo_batch(seed * 100003 + idx, 1, H, W)``, rendered on the
    CPU, with the 4-scale intrinsics pyramid; in evaluation
    (``is_train=False``) also the generating relative poses (source ->
    target) under the keys of the path datasets."""

    def __init__(self, image_size, length: int = 256, seed: int = 0, is_train: bool = True):
        self.image_size = image_size
        self.length = length
        self.seed = seed
        self.is_train = is_train

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, idx: int, rng=None) -> Dict:
        H, W = self.image_size
        batch, truth = synthetic_vo_batch(self.seed * 100003 + idx, 1, H, W, device="cpu")
        sample = {k: v[0].numpy() for k, v in batch.items()}
        K = sample["K"]
        for s in range(4):
            Ks = K.copy()
            Ks[0, :] /= 2**s
            Ks[1, :] /= 2**s
            sample[f"K_{s}"] = Ks
            sample[f"inv_K_{s}"] = np.linalg.inv(Ks).astype(np.float32)
        if not self.is_train:
            # truth["T_left"] maps target -> left; the left pair's GT is
            # left -> target.
            sample["gt_pose_left_to_target"] = torch.linalg.inv(truth["T_left"][0]).numpy()
            sample["gt_pose_target_to_right"] = truth["T_right"][0].numpy()
            sample["frame_indices"] = np.array([idx, idx + 1, idx + 2])
        return sample


def synthetic_depth_batch(
    seed: int, batch_size: int, height: int, width: int, max_depth: float = 10.0,
    device=None,
) -> Dict[str, torch.Tensor]:
    """Supervised-depth sample: ``image`` [B, H, W, 3], metric ``depth``
    [B, H, W, 1] of the slanted plane and its ``valid_mask``."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    image = torch.from_numpy(smooth_texture(rng, batch_size, height, width)).to(device)
    depth = torch.from_numpy(plane_depth(batch_size, height, width)).to(device)[..., None]
    return {"image": image, "depth": depth, "valid_mask": (depth > 0) & (depth < max_depth)}


def _perturb_rel(rel: np.ndarray, rot_noise: np.ndarray, trans_noise: np.ndarray) -> np.ndarray:
    """Left-compose a rotation of ``rot_noise`` (Rodrigues) and add
    ``trans_noise``: the odometry-noise model of oracle initializations."""
    th = float(np.linalg.norm(rot_noise))
    if th < 1e-12:
        R = np.eye(3)
    else:
        k = rot_noise / th
        Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0.0]])
        R = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * (Kx @ Kx)
    out = np.array(rel, np.float64)
    out[:3, :3] = R @ out[:3, :3]
    out[:3, 3] = out[:3, 3] + trans_noise
    return out


def make_oracle_inits(gt_cw, gt_depths, seed, rot_std_deg, trans_std, depth_noise):
    """Per-frame ``(oracle_depth, oracle_rel)`` lists for ``MonoVO``: GT
    depth (with multiplicative noise of std ``depth_noise``) and GT
    relative poses with odometry noise (``rot_std_deg`` degrees,
    ``trans_std`` metres), drawn from ``10_000 + seed``; the first rel is
    None. The initialization of the JAX package's BA ablation."""
    rng = np.random.default_rng(10_000 + seed)
    depths, rels = [], [None]
    for i in range(len(gt_cw)):
        d = np.asarray(gt_depths[i], np.float32)
        if depth_noise > 0:
            d = d * (1.0 + rng.normal(0, depth_noise, d.shape)).astype(np.float32)
        depths.append(d)
        if i > 0:
            rel = gt_cw[i] @ np.linalg.inv(gt_cw[i - 1])
            rels.append(_perturb_rel(rel, rng.normal(0, np.deg2rad(rot_std_deg), 3),
                                     rng.normal(0, trans_std, 3)))
    return depths, rels
