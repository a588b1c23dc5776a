"""The frozen reference against the port's CPU path at small sizes. The test
imports both; the reference imports nothing of the port."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import cells, check, inputs
from benchmark.reference import nets

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def _weights(config, seed=3):
    return inputs.draw_weights(config, seed, "cpu")


def _port_models(weights):
    from benchmark.training import _load
    from deep_visual_slam_torch.models import DepthNet, PoseNet

    depth, pose = DepthNet(), PoseNet()
    _load(depth, weights, "depth.")
    _load(pose, weights, "pose.")
    return depth.train(), pose.train()


def test_networks_match_the_port_in_fp32():
    cell = cells.load("vo_train.b16")
    w = _weights(cell.config)
    depth, pose = _port_models(w)
    g = torch.Generator().manual_seed(0)
    image = torch.rand(2, 64, 96, 3, generator=g)
    pairs = torch.rand(4, 64, 96, 6, generator=g)
    ref_disp = nets.depthnet({k[6:]: v for k, v in w.items() if k.startswith("depth.")}, image)
    with torch.no_grad():
        port_disp = depth(image)
        aa, t = pose(pairs)
    for s, d in enumerate(ref_disp):
        assert torch.allclose(d, port_disp[("disp", s)], atol=1e-5), s
    ref_aa, ref_t = nets.posenet({k[5:]: v for k, v in w.items() if k.startswith("pose.")}, pairs)
    assert torch.allclose(ref_aa, aa[:, 0, 0], atol=1e-7)
    assert torch.allclose(ref_t, t[:, 0, 0], atol=1e-7)


def _fp32_numbers(name, seed, auto_mask=True):
    cell = cells.load(name)
    cell.config = dict(cell.config, compute_dtype="float32",
                       loss=dict(cell.config["loss"], auto_mask=auto_mask))
    driver = cells.driver(cell)(cell, seed, torch.device("cpu"), None, 4, 64, 96, 3)
    prog = driver.check_steps()
    ref = driver.reference_reading()
    return prog, ref, check.numbers(prog, ref)


def test_vo_step_matches_the_port_in_fp32():
    """Three VO steps of the port's fp32 CPU path and of the reference. The
    per-pixel minimum (over the identity and warped maps, or without the
    auto-mask over the two warped maps) takes either side where they tie
    within rounding, and the gradient flows through the side taken, so the
    first loss is held tight and the leaf norms within a few thousandths."""
    for auto_mask in (True, False):
        prog, ref, found = _fp32_numbers("vo_train.b16", 7, auto_mask=auto_mask)
        assert abs(prog["losses"][0] - ref["losses"][0]) <= 1e-5 * ref["losses"][0]
        assert found["fwd"] < 1e-5 and found["loss"] < 1e-3 and found["ddisp"] < 5e-3
        assert found["grad"] < 5e-3 and found["change"] < 2e-2


def test_depth_step_matches_the_port_in_fp32():
    _, _, found = _fp32_numbers("depth_train.b64", 5)
    assert found["loss"] < 1e-4 and found["grad"] < 1e-4 and found["change"] < 1e-2
    assert found["ddisp"] < 1e-4


def test_the_control_rounds_to_fp8():
    x = torch.tensor([[[[1.0, 0.3, -0.07, 448.0]]]], requires_grad=True)
    w = torch.ones(1, 1, 1, 1)
    y = nets.FP8().conv(x, w)
    # amax 448 maps to 448: the values are e4m3's own.
    assert torch.equal(y, x.detach().to(torch.float8_e4m3fn).float())
    g = torch.tensor([[[[1.0, 0.3, -0.07, 57344.0]]]])
    y.backward(g)
    assert torch.equal(x.grad, g.to(torch.float8_e5m2).float())
    assert nets.FP32.conv(x, w) is not None and torch.equal(nets.FP32.q(x), x)


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_no_program(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & {"deep_visual_slam_torch", "deep_visual_slam_tpu", "jax", "jaxlib",
                       "flax"}


def test_reference_loads_no_program_module():
    code = ("import sys, benchmark.reference.nets, benchmark.reference.losses, "
            "benchmark.reference.train; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('deep_visual_slam_torch', 'deep_visual_slam_tpu', 'jax', 'jaxlib', 'flax')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"
