"""The port's ROS2 visualizer without ROS2, on the CPU.

- ``msg_utils`` against the JAX package's: the same bytes from seeded
  colours beyond [0, 1] (the clip) and points, and the same quaternion, bit
  for bit, from rotations that reach each of Shepperd's four branches.
- The node module imports without rclpy (``HAS_RCLPY`` False); ``main``
  raises ``SystemExit`` and the node itself ``RuntimeError``.
- ``frame_payload``, the timer's work, over the synthetic test split at
  64x96 with weights from the JAX package's ``.npz`` files: equal (rtol
  1e-6) to ``predict.infer`` and the world-pose product computed here.
- ``ros2_ws/src/dvs_visualizer_torch`` passes the checks that
  ``tests/test_export_predict.py`` makes of ``dvs_visualizer``, its entry
  point resolving to the port's ``main``.
"""

import ast
import importlib.util
import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from scipy.spatial.transform import Rotation

from deep_visual_slam_tpu.ros2 import msg_utils as jax_msg
from deep_visual_slam_tpu.utils.pretrained import save_variables_npz
from deep_visual_slam_tpu.utils.torch_weights import convert_depthnet, convert_posenet

from deep_visual_slam_torch import predict
from deep_visual_slam_torch.data.loader import VoDataLoader, device_prefetch
from deep_visual_slam_torch.ros2 import msg_utils, visualizer_node
from deep_visual_slam_torch.training.state import init_vo_models
from deep_visual_slam_torch.utils.config import load_config

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "ros2_ws" / "src" / "dvs_visualizer_torch"


def _branch(R):
    """Which of Shepperd's four cases ``R`` takes."""
    if np.trace(R) > 0:
        return 0
    if R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        return 1
    return 2 if R[1, 1] > R[2, 2] else 3


def test_msg_utils_equal_jax_bytes():
    rng = np.random.default_rng(0)
    colors = rng.uniform(-0.5, 1.5, size=(257, 3))
    assert (colors < 0).any() and (colors > 1).any()
    points = rng.normal(size=(257, 3)) * 3.0
    assert msg_utils.pack_rgb_float(colors).tobytes() == \
        jax_msg.pack_rgb_float(colors).tobytes()
    assert msg_utils.pointcloud2_data(points, colors) == jax_msg.pointcloud2_data(points, colors)

    branches = set()
    # Small angles take the trace branch; near half turns about x, y and z
    # take the diagonal ones.
    for axis in (None, 0, 1, 2):
        for _ in range(4):
            if axis is None:
                rotvec = rng.normal(size=3) * 0.5
            else:
                direction = np.eye(3)[axis] + rng.normal(size=3) * 0.1
                rotvec = direction / np.linalg.norm(direction) * rng.uniform(2.8, 3.1)
            R = Rotation.from_rotvec(rotvec).as_matrix()
            branches.add(_branch(R))
            q = msg_utils.rotation_matrix_to_quaternion(R)
            assert q.tobytes() == jax_msg.rotation_matrix_to_quaternion(R).tobytes()
            q_ref = Rotation.from_matrix(R).as_quat()
            assert np.allclose(q, q_ref, atol=1e-6) or np.allclose(q, -q_ref, atol=1e-6)
    assert branches == {0, 1, 2, 3}


def test_node_imports_and_refuses_without_rclpy():
    assert visualizer_node.HAS_RCLPY is False
    with pytest.raises(SystemExit):
        visualizer_node.main()
    with pytest.raises(RuntimeError, match="rclpy"):
        visualizer_node.VisualizerNode()


def _config(root):
    cfg = {"Directory": {"data_dir": str(root / "data")},
           "Dataset": {"redwood": {"mono": False}, "synthetic": {"mono": True, "length": 32}},
           "Train": {"img_h": 64, "img_w": 96, "batch_size": 2, "vis_batch_size": 1,
                     "num_workers": 1, "min_depth": 0.5, "max_depth": 20.0}}
    path = root / "vo.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return load_config(str(path))


def test_frame_payload_matches_predict_infer(tmp_path):
    """The node's networks from JAX ``.npz`` files equal their source, and
    each frame's payload equals ``predict.infer`` with the world pose and
    the cloud computed directly."""
    config = _config(tmp_path)
    t = config["Train"]
    source = init_vo_models(7)
    for model, name, convert in zip(source, ("depth", "pose"), (convert_depthnet,
                                                                convert_posenet)):
        save_variables_npz(str(tmp_path / f"{name}.npz"),
                           convert({k: v.numpy() for k, v in model.state_dict().items()}))
    depth_model, pose_model, report = visualizer_node.load_networks(
        config, str(tmp_path / "depth.npz"), str(tmp_path / "pose.npz"), "cpu")
    assert len(report) == 2
    for got, want in zip((depth_model, pose_model), source):
        for k, v in want.state_dict().items():
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(got.state_dict()[k], v), k
    want_depth, want_pose = source[0].eval(), source[1].eval()

    batches = list(device_prefetch(VoDataLoader(config).test_loader, "cpu"))
    assert len(batches) == 4
    world = want_world = np.eye(4)
    for batch in batches:
        frame = visualizer_node.frame_payload(depth_model, pose_model, batch, world, config)
        points, T = predict.infer(want_depth, want_pose, batch["target_image"],
                                  batch["source_right"], batch["inv_K"], t["min_depth"],
                                  t["max_depth"], torch.float32)
        want_world = want_world @ T[0].numpy().astype(np.float64)
        pts = points[0].numpy()[::4, ::4].reshape(-1, 3)
        want_pts = pts @ want_world[:3, :3].T + want_world[:3, 3]
        cols = batch["target_image"][0].numpy()[::4, ::4].reshape(-1, 3)
        np.testing.assert_allclose(frame["world_T"], want_world, rtol=1e-6, atol=0)
        np.testing.assert_allclose(frame["points"], want_pts, rtol=1e-6, atol=0)
        assert frame["points"].shape == (16 * 24, 3) and frame["point_step"] == 16
        data, step = jax_msg.pointcloud2_data(frame["points"], cols)
        assert frame["data"] == data and step == 16
        np.testing.assert_array_equal(
            frame["quaternion"], jax_msg.rotation_matrix_to_quaternion(frame["world_T"][:3, :3]))
        world = frame["world_T"]
    assert np.abs(world[:3, 3]).max() > 0


def test_ament_package_lints():
    """``dvs_visualizer_torch`` is a well-formed ament_python package beside
    ``dvs_visualizer``: package.xml with build_type ament_python and the
    ROS2 dependencies, the resource-index marker, config.yaml, setup.cfg,
    a setup.py that declares the entry point, and a shim whose ``main`` is
    the port's."""
    root = ET.parse(PACKAGE / "package.xml").getroot()
    assert root.findtext("name") == "dvs_visualizer_torch"
    assert root.find("export/build_type").text == "ament_python"
    deps = [d.text for d in root.findall("depend")]
    for need in ("rclpy", "sensor_msgs", "geometry_msgs", "tf2_ros"):
        assert need in deps
    assert (PACKAGE / "resource" / "dvs_visualizer_torch").exists()
    assert (PACKAGE / "config.yaml").exists() and (PACKAGE / "setup.cfg").exists()
    params = yaml.safe_load((PACKAGE / "config.yaml").read_text())
    assert set(params["vo_visualizer"]["ros__parameters"]) == {
        "config_file", "data_root", "depth_weights", "pose_weights"}
    src = (PACKAGE / "setup.py").read_text()
    ast.parse(src)
    assert "visualizer_node = dvs_visualizer_torch.visualizer_node:main" in src
    spec = importlib.util.spec_from_file_location(
        "dvs_visualizer_torch.visualizer_node",
        PACKAGE / "dvs_visualizer_torch" / "visualizer_node.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main is visualizer_node.main
    assert mod.VisualizerNode is visualizer_node.VisualizerNode
