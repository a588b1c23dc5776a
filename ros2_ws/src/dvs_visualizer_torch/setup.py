"""Ament-python packaging for the deep_visual_slam_torch ROS2 visualizer.

Resource index, package.xml and config.yaml, the weights found under
``weights/`` at build time (``.pth`` state_dicts or the JAX package's
``.npz`` variable files: the node's ``depth_weights``/``pose_weights``
parameters read both), and the console entry point.

Build inside a ROS2 workspace:  colcon build --packages-select dvs_visualizer_torch
Run:  ros2 run dvs_visualizer_torch visualizer_node \
          --ros-args -p depth_weights:=<share>/weights/depth.npz
"""

from glob import glob

from setuptools import find_packages, setup

package_name = "dvs_visualizer_torch"

setup(
    name=package_name,
    version="0.1.0",
    packages=find_packages(exclude=["test"]),
    data_files=[
        # ament resource index
        (
            "share/ament_index/resource_index/packages",
            ["resource/" + package_name],
        ),
        # package manifest + default node config
        ("share/" + package_name, ["package.xml", "config.yaml"]),
        # model weights, if present at build time
        ("share/" + package_name + "/weights", glob("weights/*.pth") + glob("weights/*.npz")),
    ],
    install_requires=["setuptools", "numpy", "torch"],
    zip_safe=True,
    maintainer="deep_visual_slam_torch",
    maintainer_email="dev@example.com",
    description="VO point-cloud + TF visualizer on the PyTorch/CUDA networks",
    license="MIT",
    tests_require=["pytest"],
    entry_points={
        "console_scripts": [
            "visualizer_node = dvs_visualizer_torch.visualizer_node:main",
        ],
    },
)
