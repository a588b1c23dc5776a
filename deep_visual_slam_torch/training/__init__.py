"""VO loss and the evaluation step."""

from deep_visual_slam_torch.training.vo_learner import (
    VOLossConfig,
    compute_losses,
    generate_images_pred,
    predict_poses,
    process_batch,
)
from deep_visual_slam_torch.training.steps import make_vo_eval_step

__all__ = [
    "VOLossConfig",
    "compute_losses",
    "generate_images_pred",
    "predict_poses",
    "process_batch",
    "make_vo_eval_step",
]
