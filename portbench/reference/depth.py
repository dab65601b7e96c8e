"""The plain depth-aware AdaIN request (``AdaIN/test.py:52-71``, ``:84-150``,
``:153-247`` with ``use_depth``): the content's proximity from the depth
network (``reference.dpt.proximity``: the hub's transform, the forward,
the bicubic resize back), the stylization strength map, AdaIN blended by
it in feature space, the decode. PyTorch, float32; the VGG and decoder
walks are ``reference.adain``'s. Nothing of the program is used.

Strength map (``compute_stylization_strength_map``, ``:119-150``): the
proximity resized bicubically (``F.interpolate``, align_corners=False) to
the relu4_1 grid, min-max normalised, mean-centred, ``sigmoid(prominence
x)``, clamped to at most 1 - offset; a constant map gives zeros. The
blend: ``feat = AdaIN(content) * (1 - P) + content * P``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import adain as ref_adain
from portbench.reference.adain import precision_flags


def strength_map(proximity: torch.Tensor, size, offset: float, prominence: float):
    """[H, W] proximity -> [h, w] strength in [0, 1 - offset]."""
    p = F.interpolate(proximity.float()[None, None], size=tuple(size), mode="bicubic",
                      align_corners=False)[0, 0]
    mn, mx = p.min(), p.max()
    if not bool(mx > mn):
        return torch.zeros_like(p)
    norm = (p - mn) / (mx - mn)
    return torch.clamp(torch.sigmoid(prominence * (norm - norm.mean())), max=1.0 - offset)


def normalised(proximity: torch.Tensor) -> np.ndarray:
    """The proximity min-max normalised to [0, 1] in float64 (zeros where it
    is constant): the map a depth PNG holds."""
    d = proximity.double().cpu().numpy()
    span = d.max() - d.min()
    return (d - d.min()) / span if span > 0 else np.zeros_like(d)


def stylize_depth(cfg, enc_w, dec_w, content_hwc, s_mean, s_std, proximity, offset,
                  prominence, precision="fp32"):
    """The decoder's HWC float32 output for one content at its working
    size, stylized to (s_mean, s_std) with the strength map of
    ``proximity``."""
    with precision_flags(precision):
        x = content_hwc.permute(2, 0, 1)[None].float()
        f = ref_adain.run_layers(cfg["encoder"], enc_w, x, precision)
        c_mean, c_std = ref_adain.mean_std(f, cfg["eps"])
        t = (f - c_mean) / c_std * s_std + s_mean
        p = strength_map(proximity, f.shape[-2:], offset, prominence)[None, None]
        feat = t * (1.0 - p) + f * p
        return ref_adain.run_layers(cfg["decoder"], dec_w, feat, precision)[0].permute(1, 2, 0)
