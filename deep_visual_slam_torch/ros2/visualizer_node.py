"""ROS2 visualizer node: the VO networks' point clouds and TF transforms
(port of ``ros2/visualizer_node.py``, the reference's
``ros2_ws/src/vo_visualizer``).

On a timer, the node takes the next batch of the config's test split
(``VoDataLoader``), runs DepthNet on its target frame and PoseNet on the
pair (target, source_right) as ``predict.infer`` does, composes the world
pose ``world_T = world_T @ T``, and publishes the target's cloud, every
4th pixel in each direction, in the world frame as a ``PointCloud2``
(``vo/pointcloud``, RGB packed into a float field) with a ``map`` ->
``camera`` TF transform. Inside a ROS2 environment::

    ros2 run dvs_visualizer_torch visualizer_node --ros-args \\
        -p config_file:=configs/vo.yaml -p depth_weights:=depth.npz -p pose_weights:=pose.npz

or ``python3 -m deep_visual_slam_torch.ros2.visualizer_node``. Its ROS
parameters: ``config_file`` (YAML config), ``data_root`` (dataset root
override), ``depth_weights`` and ``pose_weights`` (full-network files,
``.pth`` or the JAX package's ``.npz``, through ``apply_vo_pretrained``;
without them the networks keep their seed-0 weights). The networks run
in full fp32, as the JAX node's: :func:`frame_payload` turns off cuDNN's
TF32 convolutions (PyTorch's default) while it runs. They run on the card,
or on the ``device`` given to the constructor.

The module imports without rclpy, and everything but the node itself runs
without it: :func:`frame_payload` is the timer's work for one batch, and
``publish_pointcloud``/``publish_tf`` only wrap its output in messages.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

try:
    import rclpy
    from geometry_msgs.msg import TransformStamped
    from rclpy.node import Node
    from sensor_msgs.msg import PointCloud2, PointField
    from tf2_ros import TransformBroadcaster

    HAS_RCLPY = True
except ImportError:  # importable, not runnable, without ROS2
    HAS_RCLPY = False
    Node = object

from deep_visual_slam_torch.ros2.msg_utils import pointcloud2_data, rotation_matrix_to_quaternion

STRIDE = 4  # the published cloud keeps every STRIDE-th pixel in each direction


@contextlib.contextmanager
def _full_fp32():
    """Convolutions and matmuls in full fp32 inside the block: PyTorch runs
    cuDNN's fp32 convolutions in TF32 by default."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def load_networks(config: Dict, depth_weights: Optional[str] = None,
                  pose_weights: Optional[str] = None, device=None
                  ) -> Tuple[torch.nn.Module, torch.nn.Module, List[str]]:
    """ResNet-18 DepthNet and PoseNet from seed 0, the given weight files
    grafted over them through ``Train.pretrained_weights``; on ``device``
    (``None`` -> CUDA), in eval mode. Returns ``(depth, pose, report)``."""
    from deep_visual_slam_torch import resolve_device
    from deep_visual_slam_torch.training.state import init_vo_models
    from deep_visual_slam_torch.utils.pretrained import apply_vo_pretrained

    device = resolve_device(device)
    depth_model, pose_model = init_vo_models(0)
    report: List[str] = []
    if depth_weights or pose_weights:
        cfg = dict(config)
        cfg["Train"] = dict(config["Train"],
                            pretrained_weights={"depth": depth_weights or None,
                                                "pose": pose_weights or None})
        report = apply_vo_pretrained(depth_model, pose_model, cfg)
    return depth_model.to(device).eval(), pose_model.to(device).eval(), report


def frame_payload(depth_model, pose_model, batch: Dict[str, torch.Tensor], world_T: np.ndarray,
                  config: Dict) -> Dict:
    """The timer's work for the first sample of ``batch`` (tensors on the
    networks' device): ``predict.infer`` in full fp32 (no TF32), the world
    pose ``world_T @ T``, the cloud kept at every ``STRIDE``-th pixel and
    carried into the world by the new pose, its PointCloud2 payload and the
    pose's quaternion. Returns ``{"world_T", "points", "data", "point_step",
    "quaternion"}``."""
    from deep_visual_slam_torch.predict import infer

    t = config["Train"]
    with _full_fp32():
        points, T = infer(depth_model, pose_model, batch["target_image"], batch["source_right"],
                          batch["inv_K"], t["min_depth"], t["max_depth"], torch.float32)
    world_T = world_T @ T[0].cpu().numpy().astype(np.float64)
    pts = points[0, ::STRIDE, ::STRIDE].reshape(-1, 3).cpu().numpy()
    col = batch["target_image"][0, ::STRIDE, ::STRIDE].reshape(-1, 3).cpu().numpy()
    pts_w = pts @ world_T[:3, :3].T + world_T[:3, 3]
    data, point_step = pointcloud2_data(pts_w, col)
    return {"world_T": world_T, "points": pts_w, "data": data, "point_step": point_step,
            "quaternion": rotation_matrix_to_quaternion(world_T[:3, :3])}


class VisualizerNode(Node):
    """Timer-driven VO inference publishing PointCloud2 and TF."""

    def __init__(self, config: Optional[Dict] = None, data_root: Optional[str] = None,
                 period_s: float = 0.2, device=None):
        if not HAS_RCLPY:
            raise RuntimeError("rclpy is not available in this environment")
        super().__init__("vo_visualizer")
        from deep_visual_slam_torch.data.loader import VoDataLoader, device_prefetch
        from deep_visual_slam_torch.utils.config import load_config

        for name in ("config_file", "data_root", "depth_weights", "pose_weights"):
            self.declare_parameter(name, "")
        cfg_file = self.get_parameter("config_file").value or None
        data_root = data_root or self.get_parameter("data_root").value or None
        self.config = config or load_config(cfg_file)
        self.depth_model, self.pose_model, report = load_networks(
            self.config, self.get_parameter("depth_weights").value,
            self.get_parameter("pose_weights").value, device)
        for msg in report:
            self.get_logger().info(msg)
        device = next(self.depth_model.parameters()).device
        loader = VoDataLoader(self.config, root_dir=data_root)
        self._iter = iter(device_prefetch(loader.test_loader, device))
        self.world_T = np.eye(4)

        self.pc_pub = self.create_publisher(PointCloud2, "vo/pointcloud", 2)
        self.tf_broadcaster = TransformBroadcaster(self)
        self.timer = self.create_timer(period_s, self.on_timer)

    def on_timer(self) -> None:
        try:
            batch = next(self._iter)
        except StopIteration:
            self.get_logger().info("sequence finished")
            return
        frame = frame_payload(self.depth_model, self.pose_model, batch, self.world_T,
                              self.config)
        self.world_T = frame["world_T"]
        self.publish_pointcloud(frame)
        self.publish_tf(frame)

    def publish_pointcloud(self, frame: Dict) -> None:
        msg = PointCloud2()
        msg.header.stamp = self.get_clock().now().to_msg()
        msg.header.frame_id = "map"
        msg.height = 1
        msg.width = len(frame["points"])
        msg.fields = [
            PointField(name=n, offset=4 * i, datatype=PointField.FLOAT32, count=1)
            for i, n in enumerate(("x", "y", "z", "rgb"))
        ]
        msg.point_step = frame["point_step"]
        msg.row_step = msg.point_step * msg.width
        msg.is_dense = True
        msg.data = frame["data"]
        self.pc_pub.publish(msg)

    def publish_tf(self, frame: Dict) -> None:
        world_T, q = frame["world_T"], frame["quaternion"]
        msg = TransformStamped()
        msg.header.stamp = self.get_clock().now().to_msg()
        msg.header.frame_id = "map"
        msg.child_frame_id = "camera"
        msg.transform.translation.x = float(world_T[0, 3])
        msg.transform.translation.y = float(world_T[1, 3])
        msg.transform.translation.z = float(world_T[2, 3])
        msg.transform.rotation.x = float(q[0])
        msg.transform.rotation.y = float(q[1])
        msg.transform.rotation.z = float(q[2])
        msg.transform.rotation.w = float(q[3])
        self.tf_broadcaster.sendTransform(msg)


def main(args=None) -> None:
    if not HAS_RCLPY:
        raise SystemExit("rclpy not available: run inside a ROS2 environment")
    rclpy.init(args=args)
    node = VisualizerNode()
    rclpy.spin(node)
    node.destroy_node()
    rclpy.shutdown()


if __name__ == "__main__":
    main()
