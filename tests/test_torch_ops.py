"""Parity of the PyTorch port's ops with the JAX package, on the CPU.

The same numpy inputs go through both packages. Geometry, warp and loss ops
are fp32 elementwise code in both, so they agree to rounding: atol 1e-5.
The reprojection map (kernel K1's plain version) is held to 2e-6, the
tolerance ``tests/test_pallas.py`` uses for the Pallas kernel. The CUDA
kernel itself is tested against its plain version in
``test_torch_kernels.py``, on the card only.
"""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_visual_slam_tpu import ops as jops
from deep_visual_slam_tpu.data.synthetic import synthetic_vo_batch as jax_vo_batch
from deep_visual_slam_tpu.ops import photometric as jphoto
from deep_visual_slam_tpu.ops.pallas.photometric_pallas import (
    reprojection_loss_fused,
)

import deep_visual_slam_torch
from deep_visual_slam_torch import ops as tops
from deep_visual_slam_torch.data import synthetic_vo_batch
from deep_visual_slam_torch.ops import photometric_cuda

ATOL = 1e-5
REPO = Path(__file__).resolve().parents[1]


def _close(torch_out, jax_out, atol=ATOL):
    np.testing.assert_allclose(
        torch_out.detach().numpy(), np.asarray(jax_out), atol=atol, rtol=0
    )


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def test_se3_parity(rng):
    vec = rng.normal(scale=0.5, size=(5, 3)).astype(np.float32)
    vec[0] = 0.0  # the angle + 1e-7 / safe-norm path at zero rotation
    t = rng.normal(size=(5, 3)).astype(np.float32)
    _close(tops.rotation_from_axisangle(_t(vec)),
           jops.rotation_from_axisangle(jnp.asarray(vec)))
    _close(tops.translation_matrix(_t(t)), jops.translation_matrix(jnp.asarray(t)))
    for invert in (False, True):
        T = tops.transformation_from_parameters(_t(vec), _t(t), invert=invert)
        _close(T, jops.transformation_from_parameters(
            jnp.asarray(vec), jnp.asarray(t), invert=invert))
        _close(tops.invert_se3(T), jops.invert_se3(jnp.asarray(T.numpy())))


def test_camera_and_depth_parity(rng):
    B, H, W = 2, 12, 16
    K = np.asarray(jops.make_intrinsics(20.0, 21.0, 7.5, 5.5))
    _close(tops.make_intrinsics(20.0, 21.0, 7.5, 5.5, device="cpu"), K)
    _close(tops.pixel_grid(H, W, device="cpu"), jops.pixel_grid(H, W))
    Kb = np.broadcast_to(K, (B, 4, 4)).copy()
    inv_K = np.linalg.inv(Kb).astype(np.float32)
    disp = rng.uniform(size=(B, H, W, 1)).astype(np.float32)
    scaled, depth = tops.disp_to_depth(_t(disp), 0.1, 10.0)
    jscaled, jdepth = jops.disp_to_depth(jnp.asarray(disp), 0.1, 10.0)
    _close(scaled, jscaled)
    _close(depth, jdepth, atol=1e-4)  # depths reach 10: 1e-5 relative
    pts = tops.backproject(depth, _t(inv_K))
    _close(pts, jops.backproject(jdepth, jnp.asarray(inv_K)), atol=1e-4)
    _close(tops.backproject(depth[..., 0], _t(inv_K)), jops.backproject(
        jdepth[..., 0], jnp.asarray(inv_K)), atol=1e-4)
    T = tops.transformation_from_parameters(
        _t(rng.normal(scale=0.05, size=(B, 3))), _t(rng.normal(scale=0.1, size=(B, 3)))
    )
    _close(tops.project(pts, _t(Kb), T), jops.project(
        jnp.asarray(pts.numpy()), jnp.asarray(Kb), jnp.asarray(T.numpy())))


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
def test_grid_sample_parity(rng, align_corners, padding_mode):
    image = rng.uniform(size=(2, 10, 14, 3)).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, size=(2, 7, 9, 2)).astype(np.float32)
    _close(
        tops.grid_sample(_t(image), _t(grid), align_corners, padding_mode),
        jops.grid_sample(jnp.asarray(image), jnp.asarray(grid), align_corners,
                         padding_mode),
    )


def test_resize_and_upsample_parity(rng):
    x = rng.uniform(size=(2, 6, 8, 1)).astype(np.float32)
    for h, w in ((6, 8), (12, 16), (48, 64)):
        _close(tops.resize_bilinear(_t(x), h, w), jops.resize_bilinear(
            jnp.asarray(x), h, w))
    _close(tops.upsample_nearest_2x(_t(x)), jops.upsample_nearest_2x(jnp.asarray(x)))


def test_photometric_parity(rng):
    x = rng.uniform(size=(2, 12, 16, 3)).astype(np.float32)
    y = rng.uniform(size=(2, 12, 16, 3)).astype(np.float32)
    disp = rng.uniform(size=(2, 12, 16, 1)).astype(np.float32)
    jx, jy, jd = jnp.asarray(x), jnp.asarray(y), jnp.asarray(disp)
    _close(tops.ssim(_t(x), _t(y)), jphoto.ssim(jx, jy))
    _close(tops.smooth_loss(_t(disp), _t(x)), jphoto.smooth_loss(jd, jx))
    _close(tops.normalized_smooth_loss(_t(disp), _t(x)),
           jphoto.normalized_smooth_loss(jd, jx))


@pytest.mark.parametrize("shape", [(2, 48, 64, 3), (1, 36, 64, 3)])
def test_reprojection_loss_cpu_matches_xla_and_pallas(rng, shape):
    """On CPU tensors the wrapper takes the plain version, which matches
    both the JAX XLA formula and the Pallas kernel in interpret mode."""
    x = rng.uniform(size=shape).astype(np.float32)
    y = rng.uniform(size=shape).astype(np.float32)
    launches = photometric_cuda.reprojection_loss.launches
    out = tops.reprojection_loss(_t(x), _t(y), 0.85)
    assert photometric_cuda.reprojection_loss.launches == launches
    assert out.shape == shape[:3] + (1,) and out.dtype == torch.float32
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    _close(out, jphoto.reprojection_loss(jx, jy, 0.85), atol=2e-6)
    _close(out, reprojection_loss_fused(jx, jy, 0.85, True), atol=2e-6)


def test_synthetic_vo_batch_parity():
    batch, truth = synthetic_vo_batch(3, 2, 24, 32, device="cpu")
    jbatch, jtruth = jax_vo_batch(3, 2, 24, 32)
    for k in jbatch:
        _close(batch[k], jbatch[k], atol=1e-4 if k == "inv_K" else ATOL)
    for k in jtruth:
        _close(truth[k], jtruth[k])


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        deep_visual_slam_torch.resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        synthetic_vo_batch(0, 1, 8, 8)
    assert deep_visual_slam_torch.resolve_device("cpu").type == "cpu"


def test_port_imports_no_jax():
    """A static scan of the port's sources and chip_smoke.py: no import of
    jax, flax, optax or the JAX package anywhere (the interpreter may have
    loaded JAX already, so sys.modules proves nothing), and none of cv2,
    matplotlib or PIL where a module is imported: they are imported inside
    the functions that decode, write video or draw, since the card's
    machine lacks some of them."""
    banned = {"jax", "jaxlib", "flax", "optax", "deep_visual_slam_tpu"}
    host_only = {"cv2", "matplotlib", "PIL"}
    files = sorted((REPO / "deep_visual_slam_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10

    def imports(node, at_import):
        """(module name, runs when the module is imported) of every import."""
        if isinstance(node, ast.Import):
            yield from ((a.name, at_import) for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or "", at_import
        inside_function = isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda))
        for child in ast.iter_child_nodes(node):
            yield from imports(child, at_import and not inside_function)

    for path in files:
        for name, at_import in imports(ast.parse(path.read_text(), str(path)), True):
            root = name.split(".")[0]
            assert root not in banned, f"{path}: imports {name}"
            assert not (at_import and root in host_only), f"{path}: imports {name} at import"
