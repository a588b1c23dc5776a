"""dvs_visualizer_torch: ament wrapper around deep_visual_slam_torch.ros2."""
