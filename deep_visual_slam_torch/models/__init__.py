"""DepthNet, PoseNet and their ResNet encoder (NCHW inside)."""

from deep_visual_slam_torch.models.resnet import BasicBlock, BottleneckBlock, ResNetEncoder
from deep_visual_slam_torch.models.depthnet import (
    ConvBlock,
    DepthDecoder,
    DepthNet,
    ReflectConv3x3,
)
from deep_visual_slam_torch.models.posenet import PoseNet, TwoEncoderPoseNet

__all__ = [
    "BasicBlock",
    "BottleneckBlock",
    "ResNetEncoder",
    "ConvBlock",
    "DepthDecoder",
    "DepthNet",
    "ReflectConv3x3",
    "PoseNet",
    "TwoEncoderPoseNet",
]
