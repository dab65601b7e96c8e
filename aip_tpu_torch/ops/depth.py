"""Depth-aware stylisation strength map (port of ``aip_tpu.ops.depth``)."""

from __future__ import annotations

import torch

from aip_tpu_torch.ops.image import resize_bicubic


def compute_stylization_strength_map(
    depth_map: torch.Tensor,
    encoder_size: tuple[int, int],
    offset: float = 0.15,
    prominence: float = 20.0,
) -> torch.Tensor:
    """depth_map: [H, W] proximity. Returns [h, w] in [0, 1-offset]: bicubic
    resize, min-max normalise, mean-centre, sigmoid(prominence * x), clamp.
    A constant map gives zeros (reference test.py:139-143)."""
    p = resize_bicubic(depth_map[:, :, None].float(), encoder_size)[:, :, 0]
    mn, mx = p.min(), p.max()
    varies = mx > mn
    denom = torch.where(varies, mx - mn, torch.ones_like(mx))
    norm = (p - mn) / denom
    norm = norm - norm.mean()
    s = torch.clamp(torch.sigmoid(prominence * norm), max=1.0 - offset)
    return torch.where(varies, s, torch.zeros_like(s))
