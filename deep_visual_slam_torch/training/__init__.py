"""VO loss, the train state, and the train, stereo and eval steps."""

from deep_visual_slam_torch.training.vo_learner import (
    VOLossConfig,
    compute_losses,
    generate_images_pred,
    predict_poses,
    process_batch,
    process_stereo_batch,
)
from deep_visual_slam_torch.training.state import (
    TrainState,
    init_vo_models,
    make_optimizer,
    polynomial_lr,
)
from deep_visual_slam_torch.training.steps import (
    make_stereo_train_step,
    make_vo_eval_step,
    make_vo_train_step,
)

__all__ = [
    "VOLossConfig",
    "compute_losses",
    "generate_images_pred",
    "predict_poses",
    "process_batch",
    "process_stereo_batch",
    "TrainState",
    "init_vo_models",
    "make_optimizer",
    "polynomial_lr",
    "make_stereo_train_step",
    "make_vo_eval_step",
    "make_vo_train_step",
]
