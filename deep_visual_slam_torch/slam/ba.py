"""Windowed photometric bundle adjustment: fixed-shape batched
Levenberg-Marquardt in PyTorch (port of ``slam/ba.py``).

F keyframes x P points give E = F*P candidate edges; invalid edges (the
host frame, unobserved frames, reprojections off the image) are masked to
weight 0. Residuals sample the images bilinearly; the Jacobians are closed
form (SE(3) point Jacobians chained with the pinhole projection and the
bilinear image gradient carried from the last accepted evaluation). The
depth block is eliminated by a Schur complement and the reduced pose system
solved by a dense Cholesky.

The LM loop is a Python loop of ``torch.where`` selections with no host
synchronisation: the Cholesky checks no errors (a matrix that is not
positive definite gives NaN, which the candidate's ``finite`` test rejects,
as JAX's NaN does), so on the card a whole solve is queued without waiting
and the pipelined BA of ``slam/map.py`` overlaps the next frame. Everything
is fp32; the normal equations need true fp32 matmuls (TF32 off, PyTorch's
default).

State conventions: poses [F, 4, 4] ``T_cw``; the pose update is
left-multiplicative ``T <- exp(xi) T`` with ``xi = [rho, phi]``, the depth
update additive; the first pose is held fixed.

The single-edge forms (``edge_residual``, ``edge_residual_grad``,
``edge_jacobian``, ``bilinear_sample``, ``bilinear_sample_stack_grad``)
differentiate through the sampler with ``torch.func.jacfwd``: they are the
tests' oracle for the closed-form ``edges_jacobian``, and no solve calls
them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch

from deep_visual_slam_torch.ops.se3 import se3_exp, se3_inv, se3_log


class BAProblem(NamedTuple):
    """Fixed-shape windowed BA problem (tensors on one device).

    images:   [F, H, W, C] float in [0, 1] or uint8 (scaled by 1/255 inside
              the solve), or a sequence of [H, W, C] tensors of one dtype
    K:        [4, 4] intrinsics
    poses:    [F, 4, 4] initial T_cw per keyframe
    depths:   [P] initial depth of each point in its host frame
    host_uv:  [P, 2] (x, y) pixel location in the host frame
    host_idx: [P] int host keyframe index
    obs_mask: [P, F] bool, point p has a residual against frame f
    weight:   [P] per-point D3VO uncertainty weight a^2/(a^2+unc^2)
    """

    images: Union[torch.Tensor, Sequence[torch.Tensor]]
    K: torch.Tensor
    poses: torch.Tensor
    depths: torch.Tensor
    host_uv: torch.Tensor
    host_idx: torch.Tensor
    obs_mask: torch.Tensor
    weight: torch.Tensor


def _image_stack(images) -> torch.Tensor:
    """The window's images as one fp32 [F, H, W, C] stack in [0, 1]."""
    if isinstance(images, (tuple, list)):
        images = torch.stack(list(images))
    if images.dtype == torch.uint8:
        images = images.float() / 255.0
    return images


def _taps(images, frame_idx, uv):
    """Flat indices of the 4 texels around ``uv`` [E, 2] in frames
    ``frame_idx`` [E] of an [F, H, W, C] stack, with the bilinear weights:
    (flat, base [E, C], x step, y step, wx [E, 1], wy [E, 1])."""
    _, H, W, C = images.shape
    x = torch.clamp(uv[:, 0], 0.0, W - 1.0)
    y = torch.clamp(uv[:, 1], 0.0, H - 1.0)
    # A NaN coordinate (a diverged LM candidate, rejected afterwards) reads
    # texel 0 with NaN weights: an index must stay in bounds, where JAX's
    # gather clamps it and a CUDA gather would fault.
    x0 = torch.clamp(torch.floor(torch.nan_to_num(x)), 0, W - 2)
    y0 = torch.clamp(torch.floor(torch.nan_to_num(y)), 0, H - 2)
    wx = (x - x0)[:, None]
    wy = (y - y0)[:, None]
    pix = y0.long() * W + x0.long()
    base = (frame_idx.long() * (H * W) + pix)[:, None] * C + torch.arange(C, device=uv.device)
    return images.reshape(-1), base, C, W * C, wx, wy


def bilinear_sample_stack(
    images: torch.Tensor, frame_idx: torch.Tensor, uv: torch.Tensor
) -> torch.Tensor:
    """Sample frames ``frame_idx`` [E] of an [F, H, W, C] stack at
    continuous (x, y) ``uv`` [E, 2], clamped to the border: [E, C]. The JAX
    function samples one edge and is mapped over the edges; this is that
    map."""
    flat, base, sx, sy, wx, wy = _taps(images, frame_idx, uv)
    v00 = flat[base]
    v01 = flat[base + sx]
    v10 = flat[base + sy]
    v11 = flat[base + sy + sx]
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


def bilinear_sample(image: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Sample one [H, W, C] image at a continuous (x, y) ``uv`` [2], clamped
    to the border: [C]."""
    zero = torch.zeros(1, dtype=torch.long, device=uv.device)
    return bilinear_sample_stack(image[None], zero, uv[None])[0]


def bilinear_sample_stack_grad(
    images: torch.Tensor, frame_idx: torch.Tensor, uv: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Value and spatial gradient of the bilinear interpolant of frame
    ``frame_idx`` (a scalar) at one (x, y) ``uv`` [2]: (I [C], dI/d(x,y)
    [C, 2]), the single-edge form of :func:`bilinear_sample_many_grad`."""
    val, grad = bilinear_sample_many_grad(images, frame_idx.reshape(1), uv[None])
    return val[0], grad[0]


def _unproject(K: torch.Tensor, uv: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Host pixel ``uv`` [2] at ``depth`` -> the point in the host camera [3]."""
    x = (uv[0] - K[0, 2]) / K[0, 0] * depth
    y = (uv[1] - K[1, 2]) / K[1, 1] * depth
    return torch.stack([x, y, depth])


def _project(K: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    z = torch.clamp(X[2], min=1e-6)
    return torch.stack([X[0] / z * K[0, 0] + K[0, 2], X[1] / z * K[1, 1] + K[1, 2]])


def _edge_geometry(xi_d, xi_h, dd, T_dest, T_host, depth, uv, K):
    """Reprojection of one edge at the retraction ``exp(xi) T``: (uv_dest
    [2], dest-camera z, perturbed depth). No image access."""
    Td = se3_exp(xi_d) @ T_dest
    Th = se3_exp(xi_h) @ T_host
    d = depth + dd
    T_rel = Td @ torch.linalg.inv(Th)
    X_dest = T_rel[:3, :3] @ _unproject(K, uv, d) + T_rel[:3, 3]
    return _project(K, X_dest), X_dest[2], d


def _edge_in_bounds(uv_dest, z, d, H: int, W: int) -> torch.Tensor:
    return (
        (uv_dest[0] >= 1.0)
        & (uv_dest[0] <= W - 2.0)
        & (uv_dest[1] >= 1.0)
        & (uv_dest[1] <= H - 2.0)
        & (z > 1e-3)
        & (d > 1e-3)
    )


def edge_residual(
    xi_dest: torch.Tensor,  # [6] se(3) perturbation of the dest pose
    xi_host: torch.Tensor,  # [6] se(3) perturbation of the host pose
    d_depth: torch.Tensor,  # [] depth perturbation
    T_dest: torch.Tensor,  # [4, 4] dest T_cw
    T_host: torch.Tensor,  # [4, 4] host T_cw
    depth: torch.Tensor,  # [] depth in the host frame
    uv: torch.Tensor,  # [2] host pixel
    host_i: torch.Tensor,  # [] host frame index into images
    dest_i: torch.Tensor,  # [] dest frame index into images
    images: torch.Tensor,  # [F, H, W, C]
    K: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Photometric residual of one (point, dest frame) edge and its
    validity, ``I_dest(proj(T_dest T_host^-1 unproj(uv, d))) - I_host(uv)``
    at the retraction: differentiating it in (xi_dest, xi_host, d_depth) at
    zero (``torch.func.jacfwd``) gives the Gauss-Newton Jacobians through
    the image sampler. An edge out of bounds has residual 0."""
    _, H, W, _ = images.shape
    uv_dest, z, d = _edge_geometry(xi_dest, xi_host, d_depth, T_dest, T_host, depth, uv, K)
    ok = _edge_in_bounds(uv_dest, z, d, H, W)
    r = bilinear_sample_stack(images, dest_i.reshape(1), uv_dest[None])[0] - (
        bilinear_sample_stack(images, host_i.reshape(1), uv[None])[0]
    )
    return torch.where(ok, r, 0.0), ok


def edge_residual_grad(
    T_dest: torch.Tensor,
    T_host: torch.Tensor,
    depth: torch.Tensor,
    uv: torch.Tensor,
    I_host: torch.Tensor,  # [C] host intensity at uv
    dest_i: torch.Tensor,
    images: torch.Tensor,
    K: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Residual of one edge at the current estimate with the bilinear
    image gradient at its reprojection: (r [C], in bounds [], gI [C, 2])."""
    _, H, W, _ = images.shape
    zeros6 = torch.zeros(6, device=uv.device)
    uv_dest, z, d = _edge_geometry(
        zeros6, zeros6, torch.zeros((), device=uv.device), T_dest, T_host, depth, uv, K
    )
    ok = _edge_in_bounds(uv_dest, z, d, H, W)
    I_dest, gI = bilinear_sample_stack_grad(images, dest_i, uv_dest)
    return torch.where(ok, I_dest - I_host, 0.0), ok, gI


def edge_jacobian(
    T_dest: torch.Tensor,
    T_host: torch.Tensor,
    depth: torch.Tensor,
    uv: torch.Tensor,
    gI: torch.Tensor,  # [C, 2] image gradient at the current reprojection
    images: torch.Tensor,  # for H and W only
    K: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Jacobian of one edge with no image access: ``torch.func.jacfwd`` of
    the reprojection geometry chained with the carried image gradient
    ``gI``. Returns (J_dest [C, 6], J_host [C, 6], J_depth [C]), zero out of
    bounds."""
    _, H, W, _ = images.shape
    zeros6 = torch.zeros(6, device=uv.device)
    zero = torch.zeros((), device=uv.device)

    def f_uv(xi_d, xi_h, dd):
        return _edge_geometry(xi_d, xi_h, dd, T_dest, T_host, depth, uv, K)[0]

    uv_dest, z, d = _edge_geometry(zeros6, zeros6, zero, T_dest, T_host, depth, uv, K)
    ok = _edge_in_bounds(uv_dest, z, d, H, W)
    Ju_d, Ju_h, Ju_z = torch.func.jacfwd(f_uv, argnums=(0, 1, 2))(zeros6, zeros6, zero)
    return (
        torch.where(ok, gI @ Ju_d, 0.0),
        torch.where(ok, gI @ Ju_h, 0.0),
        torch.where(ok, gI @ Ju_z, 0.0),
    )


def _skew(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] cross-product matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zeros = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zeros, -z, y], dim=-1),
            torch.stack([z, zeros, -x], dim=-1),
            torch.stack([-y, x, zeros], dim=-1),
        ],
        dim=-2,
    )


def bilinear_sample_many_grad(
    images: torch.Tensor, frame_idx: torch.Tensor, uv: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Value and spatial gradient of the bilinear interpolant from one
    4-texel fetch: frame_idx [E], uv [E, 2] -> (I [E, C], dI/d(x,y)
    [E, C, 2]). The gradient is the interpolant's exact derivative."""
    flat, base, sx, sy, wx, wy = _taps(images, frame_idx, uv)
    v00 = flat[base]
    v01 = flat[base + sx]
    v10 = flat[base + sy]
    v11 = flat[base + sy + sx]
    val = (v00 * (1 - wx) + v01 * wx) * (1 - wy) + (v10 * (1 - wx) + v11 * wx) * wy
    gx = (v01 - v00) * (1 - wy) + (v11 - v10) * wy
    gy = (v10 - v00) * (1 - wx) + (v11 - v01) * wx
    return val, torch.stack([gx, gy], dim=-1)


class EdgeGeometry(NamedTuple):
    """What the closed-form linearization needs at the last accepted
    evaluation, carried across LM iterations. ``gI`` is the gradient of the
    (affine-corrected, when (a, b) are estimated) dest intensity; ``I_dest``
    the raw sampled intensity (dr/da_dest)."""

    gI: torch.Tensor  # [E, C, 2]
    R_rel: torch.Tensor  # [E, 3, 3] dest <- host rotation
    X_h: torch.Tensor  # [E, 3] point in the host camera
    X_d: torch.Tensor  # [E, 3] point in the dest camera
    ok: torch.Tensor  # [E] in bounds, valid depth
    I_dest: torch.Tensor  # [E, C]


def edges_evaluate(
    poses: torch.Tensor,  # [F, 4, 4]
    depths: torch.Tensor,  # [P]
    e_dest: torch.Tensor,  # [E]
    e_host: torch.Tensor,  # [E]
    e_point: torch.Tensor,  # [E]
    e_dir: torch.Tensor,  # [E, 3] host unprojection ray (depth-1 point)
    I_host_e: torch.Tensor,  # [E, C] host intensities
    images: torch.Tensor,  # [F, H, W, C]
    K: torch.Tensor,
    ab: Optional[torch.Tensor] = None,  # [F, 2] per-frame brightness (a, b)
) -> Tuple[torch.Tensor, EdgeGeometry]:
    """Residual pass at the current estimate: window poses inverted once,
    relative transforms from one [F, F] pair table, the 4-texel fetch also
    giving the bilinear gradient. Returns (r [E, C], geometry). With ``ab``
    the residual is ``(a_d I_dest + b_d) - (a_h I_host + b_h)``."""
    _, H, W, _ = images.shape
    inv_poses = se3_inv(poses)
    T_pair = torch.einsum("aij,bjk->abik", poses, inv_poses)  # [F, F, 4, 4]
    T_rel = T_pair[e_dest, e_host]  # [E, 4, 4]
    R_rel = T_rel[:, :3, :3]

    d = depths[e_point]
    X_h = e_dir * d[:, None]
    X_d = torch.einsum("eij,ej->ei", R_rel, X_h) + T_rel[:, :3, 3]
    z = torch.clamp(X_d[:, 2], min=1e-6)
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    uv_dest = torch.stack([X_d[:, 0] / z * fx + cx, X_d[:, 1] / z * fy + cy], dim=-1)
    ok = (
        (uv_dest[:, 0] >= 1.0)
        & (uv_dest[:, 0] <= W - 2.0)
        & (uv_dest[:, 1] >= 1.0)
        & (uv_dest[:, 1] <= H - 2.0)
        & (X_d[:, 2] > 1e-3)
        & (d > 1e-3)
    )
    I_dest, gI = bilinear_sample_many_grad(images, e_dest, uv_dest)
    if ab is None:
        diff = I_dest - I_host_e
    else:
        a_d = ab[e_dest, 0][:, None]
        b_d = ab[e_dest, 1][:, None]
        a_h = ab[e_host, 0][:, None]
        b_h = ab[e_host, 1][:, None]
        diff = (a_d * I_dest + b_d) - (a_h * I_host_e + b_h)
        gI = gI * a_d[..., None]  # d(a_d I)/duv = a_d gI
    r = torch.where(ok[:, None], diff, 0.0)
    return r, EdgeGeometry(gI, R_rel, X_h, X_d, ok, I_dest)


def edges_jacobian(
    geom: EdgeGeometry, e_dir: torch.Tensor, K: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Closed-form GN Jacobians of every edge at the carried geometry, with
    no image access: ``dX_d/dxi_dest = [I | -[X_d]x]``,
    ``dX_d/dxi_host = -R_rel [I | -[X_h]x]``, the pinhole Jacobian
    ``[[fx/z, 0, -fx x/z^2], [0, fy/z, -fy y/z^2]]`` and the carried gI.

    Returns (J_dest [E, C, 6], J_host [E, C, 6], J_depth [E, C])."""
    gI, R_rel, X_h, X_d, ok = geom.gI, geom.R_rel, geom.X_h, geom.X_d, geom.ok
    fx, fy = K[0, 0], K[1, 1]
    z = torch.clamp(X_d[:, 2], min=1e-6)
    iz = 1.0 / z
    zeros = torch.zeros_like(z)
    Jpi = torch.stack(
        [
            torch.stack([fx * iz, zeros, -fx * X_d[:, 0] * iz * iz], dim=-1),
            torch.stack([zeros, fy * iz, -fy * X_d[:, 1] * iz * iz], dim=-1),
        ],
        dim=-2,
    )  # [E, 2, 3]
    Ju_d = torch.cat([Jpi, -torch.einsum("eij,ejk->eik", Jpi, _skew(X_d))], dim=-1)
    JpiR = torch.einsum("eij,ejk->eik", Jpi, R_rel)
    Ju_h = torch.cat([-JpiR, torch.einsum("eij,ejk->eik", JpiR, _skew(X_h))], dim=-1)
    Ju_z = torch.einsum("eij,ej->ei", JpiR, e_dir)

    okf = ok[:, None, None].to(gI.dtype)
    J_dest = okf * torch.einsum("eci,eij->ecj", gI, Ju_d)
    J_host = okf * torch.einsum("eci,eij->ecj", gI, Ju_h)
    J_depth = okf[..., 0] * torch.einsum("eci,ei->ec", gI, Ju_z)
    return J_dest, J_host, J_depth


def se3_adjoint(T: torch.Tensor) -> torch.Tensor:
    """Adjoint for ``xi = [rho, phi]``: ``Ad_T = [[R, [t]x R], [0, R]]``
    ([..., 4, 4] -> [..., 6, 6])."""
    R = T[..., :3, :3]
    txR = _skew(T[..., :3, 3]) @ R
    top = torch.cat([R, txR], dim=-1)
    bot = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def huber_weight(r_norm: torch.Tensor, delta: float) -> torch.Tensor:
    """IRLS weight of the Huber kernel: 1 inside delta, delta/|r| outside."""
    return torch.where(r_norm <= delta, 1.0, delta / torch.clamp(r_norm, min=1e-12))


def lm_accept(chi2, current, candidate, prior_new, cand_poses, cand_depths) -> torch.Tensor:
    """The LM acceptance test, a 0-d bool on the device: the candidate's
    total energy below ``chi2``, with an edge that leaves validity keeping
    its previous cost in the comparison (so LM cannot lower chi2 by pushing
    points off the image), and only if it is finite. ``current`` and
    ``candidate`` are (r [E, C], w [E], ok [E]) of each state."""
    (r, w, ok), (r2, w2, ok2) = current, candidate
    c_old = w * torch.sum(r * r, dim=-1)
    c_new = w2 * torch.sum(r2 * r2, dim=-1)
    chi2_cmp = torch.sum(torch.where(ok & ~ok2, c_old, c_new)) + prior_new
    finite = (
        torch.isfinite(chi2_cmp)
        & torch.all(torch.isfinite(cand_poses))
        & torch.all(torch.isfinite(cand_depths))
    )
    return torch.where(finite, chi2_cmp, float("inf")) < chi2


def photometric_ba(
    problem: BAProblem,
    num_iters: int = 6,
    huber_delta: float = 0.11,
    init_lambda: float = 1e-4,
    fix_first: bool = True,
    depth_damping: float = 0.0,
    prior_weight: float = 0.0,
    prior_rel: Optional[torch.Tensor] = None,
    num_real: Optional[Union[int, torch.Tensor]] = None,
    prior_anchor: Optional[torch.Tensor] = None,
    estimate_affine: bool = False,
    init_ab: Optional[torch.Tensor] = None,
    affine_prior: float = 10.0,
):
    """Run LM over the window; returns (poses, depths, diagnostics), all
    tensors on the problem's device.

    Diagnostics: ``chi2`` is the accepted total energy (``chi2_photo`` +
    ``chi2_prior``), ``chi2_history`` the total before each iteration,
    ``accepted`` [num_iters] bool, ``lambda`` and ``ab``.

    ``prior_weight`` / ``prior_rel`` / ``num_real`` / ``prior_anchor``: the
    odometry relative-pose prior between consecutive window frames (D3VO
    Eq. 15), residual ``log(T_{i+1} T_i^-1 T_rel_i^-1)``, anchored at the
    relative poses of ``prior_anchor`` (default: the init) unless
    ``prior_rel`` is given; ``num_real`` masks prior edges into padded
    frame slots. ``depth_damping`` is an absolute floor on the depth
    Hessian's diagonal inside the solve (step damping, not an energy term).
    ``estimate_affine`` adds a per-frame brightness gain and bias to the
    frame block (6 -> 8) with a quadratic anchor ``affine_prior`` at
    (1, 0); ``init_ab`` [F, 2] seeds them.

    A candidate is accepted when its total energy is below the current
    one, with an edge that leaves the image keeping its previous cost in
    the comparison, and only if it is finite.
    """
    F = problem.poses.shape[0]
    P = problem.depths.shape[0]
    K = problem.K.float()
    images = _image_stack(problem.images)
    dev = images.device
    poses0 = problem.poses.float()
    depths0 = problem.depths.float()

    # Edge list: every (point, dest frame) pair, masked.
    dest_idx = torch.arange(F, device=dev)[None, :].expand(P, F)
    point_idx = torch.arange(P, device=dev)[:, None].expand(P, F)
    host_idx = problem.host_idx.long()
    edge_mask = problem.obs_mask & (dest_idx != host_idx[:, None])

    e_point = point_idx.reshape(-1)
    e_dest = dest_idx.reshape(-1)
    e_mask = edge_mask.reshape(-1)
    e_host = host_idx[e_point]
    e_weight = problem.weight.float()[e_point]

    e_uv = problem.host_uv.float()[e_point]
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    e_dir = torch.stack(
        [(e_uv[:, 0] - cx) / fx, (e_uv[:, 1] - cy) / fy, torch.ones_like(e_uv[:, 0])],
        dim=-1,
    )
    # Host intensities never move: one fetch for the whole solve.
    I_host_e = bilinear_sample_stack(images, e_host, e_uv)

    if prior_rel is None:
        anchor = poses0 if prior_anchor is None else prior_anchor.float()
        prior_rel = anchor[1:] @ se3_inv(anchor[:-1])
    prior_inv = se3_inv(prior_rel.float())
    if num_real is None:
        p_mask = torch.ones(F - 1, device=dev)
    else:
        p_mask = ((torch.arange(F - 1, device=dev) + 1) < num_real).float()
    pw = prior_weight * p_mask  # [F-1]

    # (a, b) = (1, 0) per frame, made on the device (no host-to-device copy).
    ab_anchor = torch.zeros(F, 2, device=dev)
    ab_anchor[:, 0] = 1.0
    ab0 = ab_anchor.clone() if init_ab is None else init_ab.float()
    D = 8 if estimate_affine else 6

    def prior_eval(poses, ab):
        T_rel = poses[1:] @ se3_inv(poses[:-1])
        r = se3_log(T_rel @ prior_inv)  # [F-1, 6]
        cost = torch.sum(pw * torch.sum(r * r, dim=-1))
        if estimate_affine:
            cost = cost + affine_prior * torch.sum((ab - ab_anchor) ** 2)
        return r, T_rel, cost

    def evaluate(poses, depths, ab):
        r, geom = edges_evaluate(
            poses, depths, e_dest, e_host, e_point, e_dir, I_host_e, images, K,
            ab=ab if estimate_affine else None,
        )
        r_norm = torch.linalg.vector_norm(r, dim=-1)
        w = huber_weight(r_norm, huber_delta) * e_weight * e_mask.float() * geom.ok.float()
        chi2 = torch.sum(w * torch.sum(r * r, dim=-1))
        return r, w, chi2, geom

    # One-hot edge -> slot placement: the assembly is a few dense matmuls.
    frames = torch.arange(F, device=dev)
    onehot_d = (e_dest[:, None] == frames[None, :]).float()
    onehot_h = (e_host[:, None] == frames[None, :]).float()
    onehot_p = (e_point[:, None] == torch.arange(P, device=dev)[None, :]).float()
    idx = torch.arange(F - 1, device=dev)

    def embed(block66):
        """[..., 6, 6] -> [..., D, D] (zero affine rows and columns)."""
        if D == 6:
            return block66
        out = torch.zeros(block66.shape[:-2] + (D, D), device=dev)
        out[..., :6, :6] = block66
        return out

    def embed_vec(v6):
        """[..., 6] -> [..., D] (zero affine entries)."""
        if D == 6:
            return v6
        return torch.cat([v6, torch.zeros(v6.shape[0], D - 6, device=dev)], dim=-1)

    eyeD6 = embed(torch.eye(6, device=dev).expand(F - 1, 6, 6))

    def build_system(r, w, J_dest, J_host, J_depth, r_prior, T_rel, geom, ab):
        if estimate_affine:
            okf = geom.ok[:, None].float()
            ones = okf * torch.ones_like(geom.I_dest)
            J_dest = torch.cat([J_dest, (okf * geom.I_dest)[..., None], ones[..., None]], dim=-1)
            J_host = torch.cat([J_host, (-okf * I_host_e)[..., None], -ones[..., None]], dim=-1)
        J_full = (
            onehot_d[:, None, :, None] * J_dest[:, :, None, :]
            + onehot_h[:, None, :, None] * J_host[:, :, None, :]
        )  # [E, C, F, D]
        wJ_full = J_full * w[:, None, None, None]
        wJz = J_depth * w[:, None]

        EC = J_full.shape[0] * J_full.shape[1]
        A = J_full.reshape(EC, F * D)
        wA = wJ_full.reshape(EC, F * D)
        H_pp = (wA.T @ A).reshape(F, D, F, D).permute(0, 2, 1, 3)

        pd_edge = torch.einsum("ecfi,ec->efi", J_full, wJz).reshape(-1, F * D)
        H_pd = (onehot_p.T @ pd_edge).reshape(P, F, D)
        H_dd = onehot_p.T @ torch.einsum("ec,ec->e", wJz, J_depth)
        b_p = -torch.einsum("ecfi,ec->fi", wJ_full, r)
        b_d = -(onehot_p.T @ torch.einsum("ec,ec->e", wJz, r))

        # Odometry prior: J_{i+1} = I, J_i = -Ad(T_rel); each frame index
        # appears once in each group.
        Ad = se3_adjoint(T_rel)
        AdTAd = torch.einsum("fki,fkj->fij", Ad, Ad)
        AdTr = torch.einsum("fji,fj->fi", Ad, r_prior)
        pwb = pw[:, None, None]
        AdD = embed(Ad)
        H_pp = H_pp.index_put((idx, idx), pwb * embed(AdTAd), accumulate=True)
        H_pp = H_pp.index_put((idx + 1, idx + 1), pwb * eyeD6, accumulate=True)
        H_pp = H_pp.index_put((idx + 1, idx), -pwb * AdD, accumulate=True)
        H_pp = H_pp.index_put((idx, idx + 1), -pwb * AdD.transpose(-1, -2), accumulate=True)
        b_p = b_p.index_put((idx + 1,), embed_vec(-pw[:, None] * r_prior), accumulate=True)
        b_p = b_p.index_put((idx,), embed_vec(pw[:, None] * AdTr), accumulate=True)
        if estimate_affine:
            # Quadratic pull of every (a, b) to (1, 0).
            aff = torch.zeros(D, D, device=dev)
            aff[6, 6] = aff[7, 7] = affine_prior
            H_pp = H_pp + torch.eye(F, device=dev)[:, :, None, None] * aff
            b_p = torch.cat([b_p[:, :6], b_p[:, 6:8] - affine_prior * (ab - ab_anchor)], dim=-1)
        return H_pp, H_pd, H_dd, b_p, b_d

    eyeD = torch.eye(D, device=dev)
    eyeF = torch.eye(F, device=dev)
    n_red = (F - 1) * D if fix_first else F * D
    eye_red = torch.eye(n_red, device=dev)

    def solve(H_pp, H_pd, H_dd, b_p, b_d, lam):
        # LM damping on the diagonal, plus the absolute depth floor.
        H_pp = H_pp + lam * eyeD[None, None] * eyeF[:, :, None, None]
        H_dd_d = H_dd + lam + depth_damping + 1e-10

        # Schur complement onto the poses.
        A = H_pd.reshape(P, F * D)
        Ainv = A / H_dd_d[:, None]
        H_full = H_pp.permute(0, 2, 1, 3).reshape(F * D, F * D)
        H_sc = H_full - A.T @ Ainv
        b_sc = b_p.reshape(F * D) - Ainv.T @ b_d
        if fix_first:
            H_red, b_red = H_sc[D:, D:], b_sc[D:]
        else:
            H_red, b_red = H_sc, b_sc
        L, info = torch.linalg.cholesky_ex(H_red + 1e-8 * eye_red)
        L = torch.where(info == 0, L, float("nan"))
        dx_red = torch.cholesky_solve(b_red[:, None], L)[:, 0]
        if fix_first:
            dx_pose = torch.cat([torch.zeros(D, device=dev), dx_red])
        else:
            dx_pose = dx_red
        dz = (b_d - A @ dx_pose) / H_dd_d
        return dx_pose.reshape(F, D), dz

    def retract(poses, depths, ab, dx, dz):
        new_poses = se3_exp(dx[:, :6]) @ poses
        new_ab = ab + dx[:, 6:8] if estimate_affine else ab
        return new_poses, depths + dz, new_ab

    poses, depths, ab = poses0, depths0, ab0
    lam = torch.full((), init_lambda, device=dev)
    r, w, chi2_photo, geom = evaluate(poses, depths, ab)
    _, _, chi2_prior = prior_eval(poses, ab)
    history, accepted = [], []
    for _ in range(num_iters):
        chi2 = chi2_photo + chi2_prior
        history.append(chi2)
        Jd, Jh, Jz = edges_jacobian(geom, e_dir, K)
        r_pr, T_rel, _ = prior_eval(poses, ab)
        system = build_system(r, w, Jd, Jh, Jz, r_pr, T_rel, geom, ab)
        dx_pose, dz = solve(*system, lam)
        cand_poses, cand_depths, cand_ab = retract(poses, depths, ab, dx_pose, dz)

        r2, w2, chi2_new, geom2 = evaluate(cand_poses, cand_depths, cand_ab)
        _, _, prior_new = prior_eval(cand_poses, cand_ab)
        accept = lm_accept(chi2, (r, w, geom.ok), (r2, w2, geom2.ok), prior_new,
                           cand_poses, cand_depths)
        accepted.append(accept)

        poses = torch.where(accept, cand_poses, poses)
        depths = torch.where(accept, cand_depths, depths)
        ab = torch.where(accept, cand_ab, ab)
        r = torch.where(accept, r2, r)
        w = torch.where(accept, w2, w)
        geom = EdgeGeometry(*(torch.where(accept, a, b) for a, b in zip(geom2, geom)))
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-8, 1e6)
        chi2_photo = torch.where(accept, chi2_new, chi2_photo)
        chi2_prior = torch.where(accept, prior_new, chi2_prior)
    empty = torch.zeros(0, device=dev)
    return poses, depths, {
        "chi2": chi2_photo + chi2_prior,
        "chi2_photo": chi2_photo,
        "chi2_prior": chi2_prior,
        "chi2_history": torch.stack(history) if history else empty,
        "accepted": torch.stack(accepted) if accepted else empty.bool(),
        "lambda": lam,
        "ab": ab,
    }


def _downsample(problem: BAProblem, s: int) -> BAProblem:
    """The problem on ``s``-times box-pooled images, with intrinsics and
    host pixels in the pixel-centre convention ``x' = (x + 0.5)/s - 0.5``."""
    full = _image_stack(problem.images)
    F, H, W, C = full.shape
    images = full[:, : (H // s) * s, : (W // s) * s].reshape(F, H // s, s, W // s, s, C)
    images = images.mean(dim=(2, 4))
    K = problem.K.float().clone()
    K[0, 0] = K[0, 0] / s
    K[1, 1] = K[1, 1] / s
    K[0, 2] = (K[0, 2] + 0.5) / s - 0.5
    K[1, 2] = (K[1, 2] + 0.5) / s - 0.5
    return problem._replace(images=images, K=K, host_uv=(problem.host_uv + 0.5) / s - 0.5)


def photometric_ba_scaled(problem: BAProblem, scale: int = 1, **kwargs):
    """:func:`photometric_ba` on a ``scale``-times box-downsampled problem
    (uint8 images are scaled to [0, 1] before the pooling). Depths, poses,
    the prior and the Huber threshold are scale-invariant."""
    if scale != 1:
        problem = _downsample(problem, scale)
    return photometric_ba(problem, **kwargs)


def photometric_ba_pyramid(
    problem: BAProblem,
    levels: Tuple[int, ...] = (4, 2, 1),
    iters_per_level: Tuple[int, ...] = (4, 4, 6),
    huber_delta: float = 0.11,
    fix_first: bool = True,
    depth_damping: float = 0.0,
    prior_weight: float = 0.0,
    num_real: Optional[Union[int, torch.Tensor]] = None,
    prior_anchor: Optional[torch.Tensor] = None,
    estimate_affine: bool = False,
    affine_prior: float = 10.0,
):
    """Coarse-to-fine LM: solve at each pyramid level, coarsest first,
    carrying poses, depths and (a, b) down. Every level's prior is anchored
    at the original chain. Returns the finest level's (poses, depths,
    diagnostics)."""
    poses, depths = problem.poses, problem.depths
    anchor = problem.poses if prior_anchor is None else prior_anchor
    diag = None
    ab = None
    for s, it in zip(levels, iters_per_level):
        problem = problem._replace(poses=poses, depths=depths)
        poses, depths, diag = photometric_ba_scaled(
            problem, scale=int(s), num_iters=int(it), huber_delta=huber_delta,
            fix_first=fix_first, depth_damping=depth_damping,
            prior_weight=prior_weight, num_real=num_real, prior_anchor=anchor,
            estimate_affine=estimate_affine, init_ab=ab, affine_prior=affine_prior,
        )
        if estimate_affine:
            ab = diag["ab"]
    return poses, depths, diag
