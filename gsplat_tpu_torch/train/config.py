"""Config / flag system (a copy of gsplat_tpu/train/config.py; the port
keeps its own).

Mirrors the reference's reflective argparse groups
(arguments/__init__.py:19-132): ModelParams, PipelineParams,
OptimizationParams with identical defaults, shorthand flags for the
underscore-prefixed fields (-s/-m/-i/-r/-w), and cfg_args persistence so
render/metrics can re-merge a saved training config (get_combined_args,
arguments/__init__.py:112-132).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Any


@dataclasses.dataclass
class ModelConfig:
    """arguments/__init__.py:47-67 (fork fields included)."""

    sh_degree: int = 3
    source_path: str = ""      # shorthand -s
    model_path: str = ""       # shorthand -m
    images: str = "images"     # shorthand -i
    resolution: int = -1       # shorthand -r
    white_background: bool = False  # shorthand -w
    data_device: str = "cuda"
    eval: bool = True
    cap_max: int = 100_000
    max_frame: int = 100
    min_frame: int = 0
    init_pts: int = 100_000
    init_type: str = "random"

    _shorthand = {"source_path", "model_path", "images", "resolution",
                  "white_background"}


@dataclasses.dataclass
class PipelineConfig:
    """arguments/__init__.py:69-74."""

    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    debug: bool = False
    # --- rasterizer knobs (no reference analogue); 64x16 training tiles
    # are the JAX package's default, kept so both bin the same way ---
    tile_x: int = 64
    tile_y: int = 16
    chunk: int = 128
    dup_budget: int = 0  # 0 => auto (scaled from cap_max)

    _shorthand: Any = frozenset()


@dataclasses.dataclass
class OptimizationConfig:
    """arguments/__init__.py:76-110 — identical defaults."""

    iterations: int = 30_010
    genesis_iterations: int = -1
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    rigid_v_lr: float = 1e-4
    rigid_rotvec_lr: float = 1e-4
    rigid_rotcen_lr: float = 1e-4
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 25_000
    densify_grad_threshold: float = 0.0002
    random_background: bool = False
    noise_lr: float = 5e4
    scale_reg: float = 1e-4
    opacity_reg: float = 1e-4

    _shorthand: Any = frozenset()


def add_config_args(parser: argparse.ArgumentParser, cfg) -> None:
    """Register dataclass fields as flags (ParamGroup-style,
    arguments/__init__.py:19-38)."""
    shorthand = getattr(type(cfg), "_shorthand", frozenset())
    for f in dataclasses.fields(cfg):
        if f.name.startswith("_"):
            continue
        names = ["--" + f.name]
        if f.name in shorthand:
            names.append("-" + f.name[0])
        default = getattr(cfg, f.name)
        if f.type in (bool, "bool"):
            parser.add_argument(*names, default=default, action="store_true")
        else:
            parser.add_argument(*names, default=default, type=type(default))


def extract_config(args: argparse.Namespace, cls):
    cfg = cls()
    for f in dataclasses.fields(cfg):
        if f.name.startswith("_"):
            continue
        if hasattr(args, f.name):
            setattr(cfg, f.name, getattr(args, f.name))
    if cls is ModelConfig and cfg.source_path:
        cfg.source_path = os.path.abspath(cfg.source_path)
    return cfg


def save_cfg_args(model_path: str, args: argparse.Namespace) -> None:
    """Persist the run config exactly like train_static.py:157-158."""
    os.makedirs(model_path, exist_ok=True)
    ns = argparse.Namespace(**vars(args))
    with open(os.path.join(model_path, "cfg_args"), "w") as f:
        f.write(str(ns))


def load_combined_args(parser: argparse.ArgumentParser):
    """Merge saved cfg_args with CLI (get_combined_args,
    arguments/__init__.py:112-132)."""
    import sys

    args_cmdline = parser.parse_args(sys.argv[1:])
    cfg_string = "Namespace()"
    try:
        path = os.path.join(args_cmdline.model_path, "cfg_args")
        with open(path) as f:
            cfg_string = f.read()
    except (TypeError, FileNotFoundError):
        pass
    from argparse import Namespace  # noqa: F401 — used by eval below
    args_cfg = eval(cfg_string)  # noqa: S307 — same trust model as reference
    merged = vars(args_cfg).copy()
    for k, v in vars(args_cmdline).items():
        if v is not None:
            merged[k] = v
    return argparse.Namespace(**merged)


def auto_dup_budget(cap_max: int, pipe: PipelineConfig) -> int:
    """Duplicate budget: generous default of 6x capacity, chunk-aligned."""
    if pipe.dup_budget > 0:
        return pipe.dup_budget
    k = max(6 * cap_max, 1 << 16)
    return -(-k // pipe.chunk) * pipe.chunk
