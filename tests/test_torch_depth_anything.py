"""Depth-Anything-V2 in the port against the JAX package, on the CPU.

The same weights go both ways: a narrow model (width 64, 4 blocks, 2 heads)
from JAX variables through ``depth_anything_from_jax``, and the whole
``vits`` from a reference-named ``state_dict`` (with the ``mask_token`` and
refinenet4's never-run ``resConfUnit1`` that published files carry) through
``convert_depth_anything`` on the JAX side and
``load_depth_anything_state_dict`` on the port's. Depth within atol 1e-4
(in metres, max_depth 20), as ``tests/test_convert_da.py`` holds the JAX
model to the reference, at a non-square grid (56x84, where the position
embeddings are resampled with a different scale on each axis) and at the
native 518x518 (where they are not), plus rtol 1e-5: at 518x518 fp32's
own rounding reaches 1e-4 m, each side landing 1.1e-4 and 1.2e-4 m from
the narrow model's float64 result (1.6e-5 and 1.4e-5 m at 56x84). The
bicubic resize, both fp32 (JAX's taps from float64 matrices in a matmul,
torch's computed in fp32), within rtol 1e-5 and atol 1e-5.

The CLI: JAX's ``predict_depth_anything`` runs bfloat16 on its
accelerator; here its model is built in float32, and the port's CLI with
``--device cpu`` runs float32 too (its plain path), so the two PNGs (16-bit
millimetres, truncated) may differ only where a depth lies within rounding
of a millimetre boundary: equal in at least 99.9% of the pixels and never
more than 1 mm apart. The whole ``vits`` is compiled by JAX once, in the
CLI; its jitted function also gives the float parity.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deep_visual_slam_tpu.models.depth_anything as jda
from deep_visual_slam_tpu.ops.warp import resize_bicubic_torch as jax_resize_bicubic
from deep_visual_slam_tpu.utils.torch_weights import convert_depth_anything

from deep_visual_slam_torch import predict_depth_anything
from deep_visual_slam_torch.models import DepthAnythingV2
from deep_visual_slam_torch.ops.warp import resize_bicubic_torch
from deep_visual_slam_torch.utils.png import write_png16
from deep_visual_slam_torch.utils.pretrained import load_depth_anything_state_dict
from deep_visual_slam_torch.utils.weights import depth_anything_from_jax

torch.set_num_threads(1)

ATOL, RTOL = 1e-4, 1e-5
NARROW = dict(embed_dim=64, depth=4, num_heads=2, layers=(0, 1, 2, 3),
              out_channels=(16, 32, 64, 64), features=16)


def _randomize_ls(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """LayerScale gammas near 1 (their init of 1e-5 would make every block
    nearly the identity) and a nonzero class token."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("gamma"):
                p.copy_(1.0 + 0.1 * torch.randn(p.shape, generator=g))
            elif name.endswith("cls_token"):
                p.copy_(0.02 * torch.randn(p.shape, generator=g))
    return model


def _reference_state_dict(model: DepthAnythingV2, seed: int):
    """The model's weights as a published file holds them: plus a
    ``mask_token`` and refinenet4's ``resConfUnit1``."""
    rng = np.random.default_rng(seed)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    dim = sd["pretrained.cls_token"].shape[-1]
    sd["pretrained.mask_token"] = torch.zeros(1, dim)
    unit = "depth_head.scratch.refinenet4.resConfUnit"
    for k in [k for k in sd if k.startswith(unit + "2.")]:
        sd[k.replace(unit + "2.", unit + "1.")] = torch.from_numpy(
            rng.normal(size=tuple(sd[k].shape)).astype(np.float32))
    return sd


def _cv2_reader(path):
    import cv2

    bgr = cv2.imread(path)
    return None if bgr is None else cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)


@pytest.mark.parametrize("grid", [
    (37, 37, 4, 6, (4 + 0.1) / 37, (6 + 0.1) / 37),     # DINOv2's offset scale
    (37, 37, 34, 46, (34 + 0.1) / 37, (46 + 0.1) / 37),  # 480x640 padded
    (5, 7, 9, 4, None, None),                            # size only
])
def test_resize_bicubic_matches_jax(grid, rng):
    H, W, h, w, sh, sw = grid
    x = rng.normal(size=(2, H, W, 3)).astype(np.float32)
    want = np.asarray(jax_resize_bicubic(jnp.asarray(x), h, w, scale_h=sh, scale_w=sw))
    got = resize_bicubic_torch(torch.from_numpy(x), h, w, scale_h=sh, scale_w=sw).numpy()
    assert got.shape == want.shape == (2, h, w, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _narrow_jax_variables(seed: int):
    """Random JAX variables of the narrow model, shaped by ``eval_shape``
    (nothing compiled), drawn with numpy."""
    model = jda.DepthAnythingV2(encoder="narrow", max_depth=20.0)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 56, 84, 3)))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            return rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        if name in ("scale", "gamma"):
            return 1.0 + 0.1 * rng.normal(size=shape)
        return 0.02 * rng.normal(size=shape)

    tree = jax.tree_util.tree_map_with_path(
        lambda p, l: draw(p, l).astype(np.float32), shapes)
    return model, jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("size", [(56, 84), (518, 518)])
def test_narrow_model_matches_jax(size, monkeypatch):
    monkeypatch.setitem(jda.VIT_CONFIGS, "narrow", NARROW)
    model, variables = _narrow_jax_variables(1)
    port = DepthAnythingV2(config=NARROW)
    port.load_state_dict(depth_anything_from_jax(variables))
    x = np.random.default_rng(2).uniform(size=(1, *size, 3)).astype(np.float32)
    want = np.asarray(jax.jit(model.apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == want.shape == (1, *size)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert np.ptp(want) > 1e-2  # not a constant map


def test_from_jax_inverts_convert():
    """``depth_anything_from_jax`` of ``convert_depth_anything``'s tree is the
    state_dict it started from, the entries never run aside."""
    port = _randomize_ls(DepthAnythingV2("vits"), 3)
    sd = _reference_state_dict(port, 3)
    back = depth_anything_from_jax(convert_depth_anything(
        {k: v.numpy() for k, v in sd.items()}, "vits"))
    assert set(back) == set(port.state_dict())
    for k, v in back.items():
        assert torch.equal(v, sd[k]), k


def test_state_dict_loader_checks_names_and_shapes(tmp_path):
    port = _randomize_ls(DepthAnythingV2(config=NARROW), 4)
    sd = _reference_state_dict(port, 4)
    path = str(tmp_path / "da.pth")
    torch.save({"state_dict": {f"module._orig_mod.{k}": v for k, v in sd.items()}}, path)
    loaded = load_depth_anything_state_dict(path, config=NARROW)
    assert set(loaded) == set(port.state_dict())
    for k, v in loaded.items():
        assert torch.equal(v, sd[k]), k
    bad = dict(sd)
    bad["depth_head.projects.0.weight"] = torch.zeros(3, 3, 1, 1)
    torch.save(bad, path)
    with pytest.raises(RuntimeError, match="size mismatch"):
        load_depth_anything_state_dict(path, config=NARROW)
    del sd["pretrained.norm.bias"]
    torch.save(sd, path)
    with pytest.raises(RuntimeError, match="Missing key"):
        load_depth_anything_state_dict(path, config=NARROW)


@pytest.fixture(scope="module")
def vits_cli_run(tmp_path_factory):
    """A reference-named vits checkpoint, a 50x80 image (padded to 56x84),
    and JAX's CLI run on it with its model in float32; its jitted function
    kept for the float parity."""
    import cv2
    import sys

    from deep_visual_slam_tpu import predict_depth_anything as jax_cli

    root = tmp_path_factory.mktemp("vits")
    torch.manual_seed(5)
    port = _randomize_ls(DepthAnythingV2("vits"), 5)
    ckpt = str(root / "depth_anything_v2_vits.pth")
    torch.save(_reference_state_dict(port, 5), ckpt)
    (root / "imgs").mkdir()
    img = (np.random.default_rng(6).uniform(size=(50, 80, 3)) * 255).astype(np.uint8)
    cv2.imwrite(str(root / "imgs" / "a.png"), img)

    jitted = []
    real_jit, real_model = jax.jit, jda.DepthAnythingV2

    def recording_jit(fn, *args, **kwargs):
        jitted.append(real_jit(fn, *args, **kwargs))
        return jitted[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "jit", recording_jit)
        mp.setattr(jda, "DepthAnythingV2", lambda **kw: real_model(**{**kw, "dtype": jnp.float32}))
        mp.setattr(sys, "argv", ["predict_depth_anything", "--weights", ckpt,
                                 "--encoder", "vits", "--input", str(root / "imgs"),
                                 "--output", str(root / "jax")])
        jax_cli.main()
    return {"root": root, "ckpt": ckpt, "infer": jitted[-1], "port": port,
            "jax_png": cv2.imread(str(root / "jax" / "a_depth.png"), cv2.IMREAD_UNCHANGED)}


def test_vits_from_reference_state_dict_matches_jax(vits_cli_run):
    """The whole vits at 56x84: the port loaded by
    ``load_depth_anything_state_dict``, JAX by ``convert_depth_anything``
    (inside JAX's CLI)."""
    model = DepthAnythingV2("vits")
    model.load_state_dict(load_depth_anything_state_dict(vits_cli_run["ckpt"], "vits"))
    x = np.random.default_rng(7).uniform(size=(1, 56, 84, 3)).astype(np.float32)
    want = np.asarray(vits_cli_run["infer"](jnp.asarray(x)))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert np.ptp(want) > 1e-2


def _png_agreement(got: np.ndarray, want: np.ndarray) -> None:
    assert got.dtype == want.dtype == np.uint16 and got.shape == want.shape == (50, 80)
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999, (diff.max(), (diff == 0).mean())


def test_cli_png_matches_jax_cli(vits_cli_run):
    """The port's CLI on the same image and checkpoint, its PNG decoded by
    cv2, against JAX's; then the ``.npz`` weights that JAX's CLI cached."""
    import cv2

    root = vits_cli_run["root"]
    written = predict_depth_anything.main(
        ["--weights", vits_cli_run["ckpt"], "--encoder", "vits", "--input",
         str(root / "imgs"), "--output", str(root / "port"), "--device", "cpu"],
        read_image=_cv2_reader)
    assert written == [str(root / "port" / "a_depth.png")]
    got = cv2.imread(written[0], cv2.IMREAD_UNCHANGED)
    _png_agreement(got, vits_cli_run["jax_png"])

    npz = str(root / "depth_anything_v2_vits.npz")
    assert os.path.exists(npz)  # JAX's CLI cached its converted variables
    written = predict_depth_anything.main(
        ["--weights", npz, "--input", str(root / "imgs" / "a.png"), "--output",
         str(root / "npz")], read_image=_cv2_reader, device="cpu")
    assert np.array_equal(cv2.imread(written[0], cv2.IMREAD_UNCHANGED), got)


def test_cli_refuses_what_the_port_lacks(tmp_path):
    """An input without images is refused by the parser; without a card
    the default device refuses (no fallback)."""
    args = ["--weights", "x.pth", "--input", str(tmp_path), "--device", "cpu"]
    with pytest.raises(SystemExit):
        predict_depth_anything.main(args)
    if not torch.cuda.is_available():  # no fallback: the default device is CUDA
        with pytest.raises(RuntimeError, match="CUDA"):
            predict_depth_anything.main(args[:4], read_image=_cv2_reader)


def test_png_writer_decodes_as_cv2_writes(tmp_path, rng):
    import cv2

    depth = (rng.uniform(size=(37, 53)) * 20000).astype(np.uint16)
    depth[0, 0], depth[-1, -1] = 0, 65535
    write_png16(str(tmp_path / "port.png"), depth)
    cv2.imwrite(str(tmp_path / "cv2.png"), depth)
    for name in ("port.png", "cv2.png"):
        assert np.array_equal(cv2.imread(str(tmp_path / name), cv2.IMREAD_UNCHANGED), depth)
    with pytest.raises(ValueError, match="uint16"):
        write_png16(str(tmp_path / "x.png"), depth.astype(np.float32))
