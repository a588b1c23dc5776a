"""The frozen reference against the port's CPU path at small sizes. The test
imports both; the reference imports nothing of the port."""

import ast
import hashlib
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from benchmark import cells, check, inputs
from benchmark.reference import nets

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def _weights(cell, seed=3):
    spec = cells.driver(cell).networks(
        SimpleNamespace(config=cell.config, optim=cell.config["optimizer"])).spec
    return inputs.draw_weights(spec, seed, "cpu")


def _port_models(weights):
    from benchmark.training import _load
    from deep_visual_slam_torch.models import DepthNet, PoseNet

    depth, pose = DepthNet(), PoseNet()
    _load(depth, weights, "depth.")
    _load(pose, weights, "pose.")
    return depth.train(), pose.train()


def test_networks_match_the_port_in_fp32():
    cell = cells.load("vo_train.b16")
    w = _weights(cell)
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


@pytest.mark.parametrize("op", ["conv", "conv_transpose", "matmul"])
def test_the_control_rounds_to_fp8(op):
    """Each product of the networks, here one that returns its input,
    rounds its operands and output to e4m3 and the gradient to e5m2."""
    x = torch.tensor([[[[1.0, 0.3, -0.07, 448.0]]]], requires_grad=True)
    w = torch.eye(4) if op == "matmul" else torch.ones(1, 1, 1, 1)
    y = getattr(nets.FP8(), op)(x, w)
    # amax 448 maps to 448: the values are e4m3's own.
    assert torch.equal(y, x.detach().to(torch.float8_e4m3fn).float())
    g = torch.tensor([[[[1.0, 0.3, -0.07, 57344.0]]]])
    y.backward(g)
    assert torch.equal(x.grad, g.to(torch.float8_e5m2).float())
    assert torch.equal(getattr(nets.FP32, op)(x, w), x) and torch.equal(nets.FP32.q(x), x)


# Both cells at 2x64x64 in their own bf16 from seed 2147483659, two threads,
# as the harness before the networks moved into the driver read them: the
# drawn weights' digest (fp32 bytes in draw order), the program's and the
# reference's losses, their leaf norms summed, and the check's numbers.
BEFORE = {
    "vo_train.b16": {
        "digest": "b88d3bda336f8d746593ed1b1fd346c18effd4537b0a88569747b59988d09902",
        "prog_losses": [0.05968949943780899, 0.05248214304447174, 0.044946182519197464],
        "ref_losses": [0.05973473936319351, 0.05228215456008911, 0.04617847502231598],
        "prog_grad": 2.1287781989192274, "ref_grad": 2.0070987203032873,
        "prog_change": 5.587696458027416, "ref_change": 5.6432745668027735,
        "numbers": {"fwd": 0.09459880844515621, "ddisp": 0.11769088418391624,
                    "loss": 0.026685430874947767, "loss1": 0.0007573469955139164,
                    "grad": 0.3120707006893033, "grad_p90": 0.07997571293209152,
                    "grad_median": 0.021721104592091162, "change": 0.13892962494091185,
                    "change_p90": 0.03619480961423078,
                    "change_median": 0.017715357696070536}},
    "depth_train.b64": {
        "digest": "1fc220651fd4333cb18334d13c7ba13efebc2ad2e14cb65bc533c65f87edc1aa",
        "prog_losses": [2.5047576427459717, 1.7845405340194702, 1.556902527809143],
        "ref_losses": [2.50529408454895, 1.772516131401062, 1.5545903444290161],
        "prog_grad": 98.51567114084715, "ref_grad": 99.07035103705364,
        "prog_change": 3.287157529634198, "ref_change": 3.294791988532642,
        "numbers": {"fwd": 0.02586319380109263, "ddisp": 0.004622027946836872,
                    "loss": 0.006783804336327068, "loss1": 0.00021412328647839996,
                    "grad": 0.10242029103408938, "grad_p90": 0.027700169019713724,
                    "grad_median": 0.007976326098128544, "change": 0.0422152572320467,
                    "change_p90": 0.015788805181813616,
                    "change_median": 0.003429757382574606}},
}


@pytest.mark.parametrize("workload", sorted(BEFORE))
def test_the_cells_draw_and_check_as_before(workload):
    cell = cells.load(workload)
    driver = cells.driver(cell)(cell, 2147483659, torch.device("cpu"), None, 2, 64, 64, 3)
    flat = torch.cat([v.reshape(-1) for v in driver.init_weights.values()])
    found = {"digest": hashlib.sha256(flat.numpy().tobytes()).hexdigest()}
    prog = driver.check_steps()
    driver.free()
    ref = driver.reference_reading()
    for side, r in (("prog", prog), ("ref", ref)):
        found[f"{side}_losses"] = r["losses"]
        found[f"{side}_grad"] = sum(r["grad"].values())
        found[f"{side}_change"] = sum(r["change"].values())
    found["numbers"] = check.numbers(prog, ref)
    before = BEFORE[workload]
    assert found["digest"] == before["digest"]
    for key in before:
        if key != "digest":
            assert found[key] == pytest.approx(before[key], rel=1e-6), key


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
