"""YAML config, schema-compatible with the reference (copy of the JAX
package's ``utils/config.py``), so the port reads ``configs/vo.yaml``
unchanged, and the run name the trainer files its logs and checkpoints
under."""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Any, Dict

VO_DEFAULTS: Dict[str, Any] = {
    "Directory": {
        "exp_name": "vo-tpu",
        "data_dir": "./data/",
        "log_dir": "./tensorboard",
        "weights": "./weights",
        "results": "./results",
    },
    "Dataset": {
        "custom_data": {"mono": False, "stereo": False},
        "mars_logger": {"mono": False, "stereo": False},
        "irs": {"mono": False, "stereo": False},
        "redwood": {"mono": True, "stereo": False},
        "synthetic": {"mono": False, "stereo": False},
    },
    "Train": {
        "mode": "axisAngle",
        "use_shuffle": True,
        "train_plot_interval": 1000,
        "valid_plot_interval": 100,
        "num_workers": 8,
        "valid_freq": 2,
        "save_freq": 1,
        "vis_batch_size": 1,
        "num_source": 1,
        "num_scale": 4,
        "min_depth": 0.1,
        "max_depth": 10.0,
        "ssim_ratio": 0.85,
        "smoothness_ratio": 0.001,
        "auto_mask": True,
        "img_w": 640,
        "img_h": 480,
        "weight_decay": 0.00001,
        "beta1": 0.9,
        "batch_size": 16,
        "epoch": 31,
        "init_lr": 0.0001,
        "final_lr": 0.00001,
        "pretrained_encoder": None,
        "pretrained_weights": {"depth": None, "pose": None},
        "compute_dtype": "bfloat16",
        "seed": 42,
    },
    "Experiment": {
        "num_devices": None,
    },
}


def _deep_update(base: Dict, override: Dict) -> Dict:
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _deep_update(base[k], v)
        else:
            base[k] = v
    return base


def load_config(path: str | Path | None = None, overrides: Dict | None = None) -> Dict:
    """Load a (possibly partial) YAML config merged over defaults."""
    cfg = copy.deepcopy(VO_DEFAULTS)
    if path is not None:
        import yaml

        with open(path) as f:
            user = yaml.safe_load(f) or {}
        _deep_update(cfg, user)
    if overrides:
        _deep_update(cfg, overrides)
    return cfg


def experiment_name(config: Dict) -> str:
    """The run name: ``<exp_name>_ep<epoch>_bs<batch>_lr<init_lr>_<H>x<W>``."""
    t = config["Train"]
    return (
        f"{config['Directory']['exp_name']}"
        f"_ep{t['epoch']}_bs{t['batch_size']}"
        f"_lr{t['init_lr']}_{t['img_h']}x{t['img_w']}"
    )


def save_config(config: Dict, path: str | Path) -> None:
    import yaml

    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(config, f, sort_keys=False)
