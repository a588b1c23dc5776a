"""Synthetic fixtures, snippet datasets, packed shards and the loader."""

from deep_visual_slam_torch.data.base import (
    DepthSampleDataset,
    SnippetDataset,
    color_jitter,
)
from deep_visual_slam_torch.data.loader import (
    ConcatDataset,
    DataLoader,
    VoDataLoader,
    collate,
    device_prefetch,
)
from deep_visual_slam_torch.data.nyu import DepthLoader, nyu_dataset
from deep_visual_slam_torch.data.packed import (
    PackedSnippetDataset,
    list_packed_scenes,
    pack_scene,
)
from deep_visual_slam_torch.data.synthetic import (
    SyntheticStereoDataset,
    SyntheticVoDataset,
    default_intrinsics,
    make_oracle_inits,
    plane_depth,
    smooth_texture,
    synthetic_depth_batch,
    synthetic_multidepth_sequence,
    synthetic_slam_sequence,
    synthetic_stereo_batch,
    synthetic_vo_batch,
)

__all__ = [
    "DepthSampleDataset",
    "SnippetDataset",
    "color_jitter",
    "ConcatDataset",
    "DataLoader",
    "DepthLoader",
    "nyu_dataset",
    "VoDataLoader",
    "collate",
    "device_prefetch",
    "PackedSnippetDataset",
    "list_packed_scenes",
    "pack_scene",
    "SyntheticStereoDataset",
    "SyntheticVoDataset",
    "default_intrinsics",
    "make_oracle_inits",
    "plane_depth",
    "smooth_texture",
    "synthetic_depth_batch",
    "synthetic_multidepth_sequence",
    "synthetic_slam_sequence",
    "synthetic_stereo_batch",
    "synthetic_vo_batch",
]
