"""Global photometric bundle adjustment over the whole keyframe history
(port of ``slam/global_ba.py``).

The windowed solver's dense (point x frame) edge grid grows as F*P; this
solver keeps the structure SLAM tracks have instead:

- **Track-banded edges.** A track observes a run of keyframes after its
  host, so the edges form a [P, L] grid: edge (p, l) joins point p's host
  keyframe to the keyframe ``l + 1`` after it, masked by ``obs_off``. E =
  P*L whatever the length of the trajectory.
- **Offset-banded normal equations.** Each edge couples the frame pair
  (host, host + 1 + l), so the pose Hessian has nonzero blocks only on the
  diagonal and the first L off-diagonals.

The residuals and the closed-form Jacobians are the windowed solver's
(``edges_evaluate``, ``edges_jacobian``), as are the LM semantics: the
escape-proof acceptance, the odometry prior (D3VO Eq. 15), the depth
Hessian floor, the Schur complement onto the poses with frame 0 fixed, and
a dense Cholesky of the reduced [6(F-1), 6(F-1)] system. Every LM decision
is a ``torch.where``, so a solve queues on the card with no host
synchronisation.

**Summation.** The per-edge 6x6 blocks are summed into frames by two
one-hot matrix products, host-indexed ([F, P] x [P, 42 + 36L]) and
dest-indexed ([F, E] x [E, 42]), which also give the off-diagonal blocks,
and then written into the dense [F, F, 6, 6] Hessian at distinct
positions. This is the JAX package's one-hot contraction in two GEMMs in
place of 3L + 2. A per-frame ``index_add_`` would be the plain segment sum,
but on CUDA it adds with atomics in no fixed order, so the solve would not
repeat itself bit for bit; a GEMM does (with TF32 off, PyTorch's default),
and at F=128, P=2048, L=8 it is ~0.2 GFLOP. The point-frame block is the
one scatter left: ``index_put_(accumulate=True)``, whose only duplicate
positions are the clipped slots of masked edges, which add exact zeros.

The JAX package stores the image stack channel-first, a TPU lane-padding
layout; here it is [F, H, W, C] as in the windowed solver.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch

from deep_visual_slam_torch.ops.se3 import se3_exp, se3_inv, se3_log
from deep_visual_slam_torch.slam.ba import (
    EdgeGeometry,
    _downsample,
    _image_stack,
    bilinear_sample_stack,
    edges_evaluate,
    edges_jacobian,
    huber_weight,
    lm_accept,
    se3_adjoint,
)


class GlobalBAProblem(NamedTuple):
    """Track-banded global BA problem (tensors on one device).

    images:   [F, H, W, C] float in [0, 1] or uint8 (scaled by 1/255 on the
              device); padded slots zero
    K:        [4, 4] intrinsics
    poses:    [F, 4, 4] initial T_cw per keyframe
    depths:   [P] initial host depth per point
    host_uv:  [P, 2] (x, y) pixel location in the host keyframe
    host_idx: [P] int host keyframe index
    obs_off:  [P, L] bool, point p is observed in keyframe
              ``host_idx[p] + 1 + l``
    weight:   [P] per-point D3VO uncertainty weight a^2/(a^2+unc^2)
    """

    images: torch.Tensor
    K: torch.Tensor
    poses: torch.Tensor
    depths: torch.Tensor
    host_uv: torch.Tensor
    host_idx: torch.Tensor
    obs_off: torch.Tensor
    weight: torch.Tensor


def photometric_ba_global(
    problem: GlobalBAProblem,
    num_real: Union[int, torch.Tensor],
    num_iters: int = 7,
    scale: int = 1,
    huber_delta: float = 0.11,
    init_lambda: float = 1e-4,
    depth_damping: float = 0.0,
    prior_weight: float = 0.0,
    prior_anchor: Optional[torch.Tensor] = None,
):
    """LM over the whole keyframe history; returns (poses, depths, diag)
    on the problem's device.

    The semantics of :func:`ba.photometric_ba` with frame 0 fixed (see the
    module docstring for what differs). ``scale`` box-pools the images and
    moves the intrinsics and host pixels to the pooled pixel centres.
    Keyframes from ``num_real`` on are padding: their odometry prior is
    masked. The prior is anchored at ``prior_anchor`` (default: the
    problem's poses). ``diag``: ``chi2`` (``chi2_photo`` + ``chi2_prior``) of the accepted
    state, ``chi2_history`` (the total before each iteration) and the final
    ``lambda``.
    """
    if scale != 1:
        problem = _downsample(problem, scale)
    images = _image_stack(problem.images)
    dev = images.device
    K = problem.K.float()
    poses0 = problem.poses.float()
    depths0 = problem.depths.float()
    F = poses0.shape[0]
    P, L = problem.obs_off.shape
    host_idx = problem.host_idx.long()

    # Banded edge list, flattened [P*L]: edge (p, l) runs host -> host+1+l.
    dest_raw = host_idx[:, None] + torch.arange(1, L + 1, device=dev)  # [P, L]
    e_mask = (problem.obs_off & (dest_raw < F)).reshape(-1)
    e_dest = torch.clamp(dest_raw, max=F - 1).reshape(-1)
    e_point = torch.arange(P, device=dev)[:, None].expand(P, L).reshape(-1)
    e_host = host_idx[e_point]
    e_weight = problem.weight.float()[e_point]

    host_uv = problem.host_uv.float()
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    dir_p = torch.stack(
        [(host_uv[:, 0] - cx) / fx, (host_uv[:, 1] - cy) / fy, torch.ones_like(host_uv[:, 0])],
        dim=-1,
    )
    e_dir = dir_p[e_point]
    # Host intensities: one fetch per point for the whole solve.
    I_host_e = bilinear_sample_stack(images, host_idx, host_uv)[e_point]

    anchor = poses0 if prior_anchor is None else prior_anchor.float()
    prior_inv = se3_inv(anchor[1:] @ se3_inv(anchor[:-1]))
    p_mask = ((torch.arange(F - 1, device=dev) + 1) < num_real).float()
    pw = prior_weight * p_mask  # [F-1]

    def prior_eval(poses):
        T_rel = poses[1:] @ se3_inv(poses[:-1])
        r = se3_log(T_rel @ prior_inv)  # [F-1, 6]
        return r, T_rel, torch.sum(pw * torch.sum(r * r, dim=-1))

    def evaluate(poses, depths):
        r, geom = edges_evaluate(
            poses, depths, e_dest, e_host, e_point, e_dir, I_host_e, images, K
        )
        r_norm = torch.linalg.vector_norm(r, dim=-1)
        w = huber_weight(r_norm, huber_delta) * e_weight * e_mask.float() * geom.ok.float()
        return r, w, torch.sum(w * torch.sum(r * r, dim=-1)), geom

    # Placement, fixed for the solve: frame one-hots of every point's host
    # and every edge's dest, and the band's positions (h + 1 + l, h) with
    # h + 1 + l < F, built from Python bounds (no device-to-host read).
    frames = torch.arange(F, device=dev)
    onehot_host_T = (frames[:, None] == host_idx[None, :]).float()  # [F, P]
    onehot_dest_T = (frames[:, None] == e_dest[None, :]).float()  # [F, E]
    band_h = torch.cat([torch.arange(F - 1 - l, device=dev) for l in range(min(L, F - 1))])
    band_l = torch.cat(
        [torch.full((F - 1 - l,), l, device=dev) for l in range(min(L, F - 1))]
    )
    band_d = band_h + 1 + band_l
    points = torch.arange(P, device=dev)
    idx = torch.arange(F - 1, device=dev)
    eye6 = torch.eye(6, device=dev)

    def build_system(r, w, J_dest, J_host, J_depth, r_prior, T_rel):
        # Every per-edge product from one batched [14, C] x [C, 14] Gram
        # matrix of (J_dest | J_host | J_depth | r).
        J = torch.cat([J_dest, J_host, J_depth[..., None], r[..., None]], dim=-1)
        M = torch.einsum("eca,ecb->eab", J * w[:, None, None], J)  # [E, 14, 14]
        Mp = M.reshape(P, L, 14, 14).sum(1)  # host-side sums per point
        Bdd = M[:, :6, :6].reshape(-1, 36)
        bp_d = -M[:, :6, 13]
        Bdh = M[:, :6, 6:12].reshape(P, L * 36)  # block (dest, host)
        Bhh = Mp[:, 6:12, 6:12].reshape(P, 36)
        bp_h = -Mp[:, 6:12, 13]

        host_sum = onehot_host_T @ torch.cat([Bhh, bp_h, Bdh], dim=-1)  # [F, 42 + 36L]
        dest_sum = onehot_dest_T @ torch.cat([Bdd, bp_d], dim=-1)  # [F, 42]
        diag = host_sum[:, :36] + dest_sum[:, :36]
        b_p = host_sum[:, 36:42] + dest_sum[:, 36:42]
        band = host_sum[:, 42:].reshape(F, L, 36)[band_h, band_l]  # [nb, 36]

        H_pp = torch.zeros(F, F, 36, device=dev)
        H_pp[frames, frames] = diag
        H_pp[band_d, band_h] = band
        H_pp[band_h, band_d] = band.reshape(-1, 6, 6).transpose(-1, -2).reshape(-1, 36)
        H_pp = H_pp.reshape(F, F, 6, 6)

        A = torch.zeros(P, F, 6, device=dev)  # H_pd
        A.index_put_((points, host_idx), Mp[:, 6:12, 12], accumulate=True)
        A.index_put_((e_point, e_dest), M[:, :6, 12], accumulate=True)
        H_dd = Mp[:, 12, 12]
        b_d = -Mp[:, 12, 13]

        # Odometry prior: J_{i+1} = I, J_i = -Ad(T_rel); each frame index
        # appears once in each group.
        Ad = se3_adjoint(T_rel)
        AdTAd = torch.einsum("fki,fkj->fij", Ad, Ad)
        AdTr = torch.einsum("fji,fj->fi", Ad, r_prior)
        pwb = pw[:, None, None]
        H_pp = H_pp.index_put((idx, idx), pwb * AdTAd, accumulate=True)
        H_pp = H_pp.index_put((idx + 1, idx + 1), pwb * eye6, accumulate=True)
        H_pp = H_pp.index_put((idx + 1, idx), -pwb * Ad, accumulate=True)
        H_pp = H_pp.index_put((idx, idx + 1), -pwb * Ad.transpose(-1, -2), accumulate=True)
        b_p = b_p.index_put((idx + 1,), -pw[:, None] * r_prior, accumulate=True)
        b_p = b_p.index_put((idx,), pw[:, None] * AdTr, accumulate=True)
        return H_pp, A, H_dd, b_p, b_d

    eye_F6 = torch.eye(F * 6, device=dev)
    eye_red = torch.eye(6 * (F - 1), device=dev)
    zeros6 = torch.zeros(6, device=dev)

    def solve(H_pp, A, H_dd, b_p, b_d, lam):
        H_dd_d = H_dd + lam + depth_damping + 1e-10
        Af = A.reshape(P, F * 6)
        Ainv = Af / H_dd_d[:, None]
        H_full = H_pp.permute(0, 2, 1, 3).reshape(F * 6, F * 6) + lam * eye_F6
        H_sc = H_full - Af.T @ Ainv
        b_sc = b_p.reshape(F * 6) - Ainv.T @ b_d
        # Gauge: frame 0 fixed.
        Lc, info = torch.linalg.cholesky_ex(H_sc[6:, 6:] + 1e-8 * eye_red)
        Lc = torch.where(info == 0, Lc, float("nan"))
        dx_red = torch.cholesky_solve(b_sc[6:, None], Lc)[:, 0]
        dx_pose = torch.cat([zeros6, dx_red])
        dz = (b_d - Af @ dx_pose) / H_dd_d
        return dx_pose.reshape(F, 6), dz

    poses, depths = poses0, depths0
    lam = torch.full((), init_lambda, device=dev)
    r, w, chi2_photo, geom = evaluate(poses, depths)
    chi2_prior = prior_eval(poses)[2]
    history = []
    for _ in range(num_iters):
        chi2 = chi2_photo + chi2_prior
        history.append(chi2)
        Jd, Jh, Jz = edges_jacobian(geom, e_dir, K)
        r_pr, T_rel, _ = prior_eval(poses)
        dx_pose, dz = solve(*build_system(r, w, Jd, Jh, Jz, r_pr, T_rel), lam)
        cand_poses = se3_exp(dx_pose) @ poses
        cand_depths = depths + dz

        r2, w2, chi2_new, geom2 = evaluate(cand_poses, cand_depths)
        prior_new = prior_eval(cand_poses)[2]
        accept = lm_accept(chi2, (r, w, geom.ok), (r2, w2, geom2.ok), prior_new,
                           cand_poses, cand_depths)

        poses = torch.where(accept, cand_poses, poses)
        depths = torch.where(accept, cand_depths, depths)
        r = torch.where(accept, r2, r)
        w = torch.where(accept, w2, w)
        geom = EdgeGeometry(*(torch.where(accept, a, b) for a, b in zip(geom2, geom)))
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-8, 1e6)
        chi2_photo = torch.where(accept, chi2_new, chi2_photo)
        chi2_prior = torch.where(accept, prior_new, chi2_prior)
    return poses, depths, {
        "chi2": chi2_photo + chi2_prior,
        "chi2_photo": chi2_photo,
        "chi2_prior": chi2_prior,
        "chi2_history": torch.stack(history) if history else torch.zeros(0, device=dev),
        "lambda": lam,
    }


def photometric_ba_global_pyramid(
    problem: GlobalBAProblem,
    num_real: Union[int, torch.Tensor],
    levels: Tuple[int, ...] = (2, 1),
    iters_per_level: Tuple[int, ...] = (7, 7),
    **kwargs,
):
    """Coarse-to-fine :func:`photometric_ba_global`, coarsest level first,
    carrying poses and depths down; every level's prior is anchored at the
    original odometry chain. Returns the finest level's result."""
    poses, depths = problem.poses, problem.depths
    anchor = problem.poses
    diag = None
    for s, it in zip(levels, iters_per_level):
        problem = problem._replace(poses=poses, depths=depths)
        poses, depths, diag = photometric_ba_global(
            problem, num_real, num_iters=int(it), scale=int(s), prior_anchor=anchor, **kwargs
        )
    return poses, depths, diag
