"""Console entry point shim: the node lives in the library package
(``deep_visual_slam_torch.ros2.visualizer_node``), where it is tested
without ROS2; this module re-exports it for the ament entry point."""

from deep_visual_slam_torch.ros2.visualizer_node import (  # noqa: F401
    VisualizerNode,
    main,
)

if __name__ == "__main__":
    main()
