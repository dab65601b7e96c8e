"""Reflection-based config system (reference `Style_3DGS/arguments/__init__.py`).

A copy of ``aip_tpu/config.py`` (which imports no JAX), kept in the port so
that the port imports nothing of the JAX package.

Dataclass-flavored rebuild of ParamGroup: each group's fields become argparse
arguments (a leading underscore in the reference marks a shorthand flag;
here ``shorthand`` fields), defaults ARE the config, and a trained model
persists its merged namespace to ``cfg_args`` which ``get_combined_args``
merges back at render time (reference :101-141 round-trips the Namespace
repr through eval; we use json — same behavior, no eval).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


class ParamGroup:
    """Subclass with class attributes as defaults; call ``add_to_parser`` /
    ``extract``. Attributes listed in ``_shorthand`` also get a one-letter
    flag (reference's underscore convention, arguments/__init__.py:19-45)."""

    _shorthand: dict = {}

    def add_to_parser(self, parser: argparse.ArgumentParser, name: str,
                      fill_none: bool = False):
        group = parser.add_argument_group(name)
        for key, value in self._defaults().items():
            t = type(value)
            flags = [f"--{key}"]
            if key in self._shorthand:
                flags.append(f"-{self._shorthand[key]}")
            v = None if fill_none else value
            if t is bool:
                group.add_argument(*flags, default=v, action="store_true")
            elif t in (list, tuple):
                group.add_argument(*flags, default=v, nargs="+",
                                   type=type(value[0]) if value else str)
            else:
                group.add_argument(*flags, default=v, type=t)

    def _defaults(self) -> dict:
        return {
            k: getattr(self, k)
            for k in dir(self)
            if not k.startswith("_") and not callable(getattr(self, k))
        }

    def extract(self, args: argparse.Namespace):
        out = type(self)()
        for k in self._defaults():
            if hasattr(args, k) and getattr(args, k) is not None:
                setattr(out, k, getattr(args, k))
        return out

    def to_dict(self) -> dict:
        return self._defaults()


class ModelParams(ParamGroup):
    """arguments/__init__.py:47-66 parity."""

    sh_degree = 0
    source_path = ""
    model_path = ""
    images = "images"
    resolution = -1
    white_background = False
    eval = False
    max_hashmap = 19
    rvq_size = 64
    rvq_num = 6
    style_dim = 256
    _shorthand = {"source_path": "s", "model_path": "m", "images": "i",
                  "resolution": "r", "white_background": "w"}

    def extract(self, args):
        g = super().extract(args)
        import os

        g.source_path = os.path.abspath(g.source_path) if g.source_path else g.source_path
        return g


class PipelineParams(ParamGroup):
    """:68-73 parity."""

    convert_SHs_python = False
    compute_cov3D_python = False
    debug = False


class OptimizationParams(ParamGroup):
    """:75-99 parity (defaults identical)."""

    iterations = 30_000
    position_lr_init = 0.00016
    position_lr_final = 0.0000016
    position_lr_delay_mult = 0.01
    position_lr_max_steps = 30_000
    feature_lr = 0.0025
    opacity_lr = 0.05
    scaling_lr = 0.005
    rotation_lr = 0.001
    percent_dense = 0.01
    lambda_dssim = 0.2
    densification_interval = 100
    opacity_reset_interval = 3000
    densify_from_iter = 500
    densify_until_iter = 15_000
    densify_grad_threshold = 0.0002
    mask_prune_iter = 1_000
    rvq_iter = 29_000
    mask_lr = 0.01
    net_lr = 0.01
    net_lr_step = [5_000, 15_000, 25_000]
    lambda_mask = 0.0005


def save_cfg_args(model_path, namespace: argparse.Namespace) -> None:
    """Persist the merged namespace (train.py writes ``cfg_args``)."""
    Path(model_path).mkdir(parents=True, exist_ok=True)
    d = {k: v for k, v in vars(namespace).items()
         if isinstance(v, (int, float, str, bool, list, type(None)))}
    (Path(model_path) / "cfg_args").write_text(json.dumps(d))


def get_combined_args(parser: argparse.ArgumentParser, argv=None) -> argparse.Namespace:
    """Merge CLI args over the model's saved cfg_args (:101-141 parity:
    CLI wins where explicitly given; saved values fill the rest)."""
    args_cmdline = parser.parse_args(argv)
    merged = {}
    model_path = getattr(args_cmdline, "model_path", None)
    if model_path:
        cfg_file = Path(model_path) / "cfg_args"
        if cfg_file.exists():
            merged.update(json.loads(cfg_file.read_text()))
    for k, v in vars(args_cmdline).items():
        if v is not None:
            merged[k] = v
    return argparse.Namespace(**merged)
