"""ROS2 integration: the visualizer node (rclpy imported where present)."""
