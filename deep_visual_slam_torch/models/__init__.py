"""DepthNet, PoseNet, their ResNet encoder, RAFT and the flow pose networks
(NCHW inside)."""

from deep_visual_slam_torch.models.resnet import BasicBlock, BottleneckBlock, ResNetEncoder
from deep_visual_slam_torch.models.depthnet import (
    ConvBlock,
    DepthDecoder,
    DepthNet,
    ReflectConv3x3,
)
from deep_visual_slam_torch.models.posenet import PoseNet, TwoEncoderPoseNet
from deep_visual_slam_torch.models.raft import RAFT, BasicRAFT, SmallRAFT
from deep_visual_slam_torch.models.flow_posenet import FlowPoseNet, FlowUpdateModule

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
    "RAFT",
    "BasicRAFT",
    "SmallRAFT",
    "FlowPoseNet",
    "FlowUpdateModule",
]
