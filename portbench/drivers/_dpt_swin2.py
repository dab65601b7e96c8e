"""A seeded DPT-SwinV2 checkpoint in the torch hub's ``DPT_SwinV2_L_384``
layout, built as the configuration's ``assumed`` says: timm's SwinV2 init
drawn on the device from the seed (Linear weights truncated-normal of std
0.02 and biases 0, LayerNorms 1 and 0, ``logit_scale`` log 10, ``q_bias``
and ``v_bias`` 0), every conv PyTorch's default (weights and biases
uniform within 1 / sqrt(fan_in), fan_in = dim 1 x the kernel's taps), and
the last conv's bias set so that the output ReLU passes ``pass_share`` of
the calibration images' pixels. Only learned tensors are written: timm's
recomputed buffers are left out."""

from __future__ import annotations

import math

import torch

from portbench.drivers._dpt import LAST, _fan_in
from portbench.reference import dpt_swin2 as ref


def seeded_state_dict(cfg: dict, seed: int, calibration: torch.Tensor,
                      pass_share: float) -> dict:
    """The checkpoint on ``calibration``'s device ([N, H, W, 3] in [0, 1],
    images of the served size that are not the served contents), tensors
    drawn in the hub's key order from one generator."""
    dev = calibration.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    shapes = ref.state_dict_shapes(cfg)
    sd = {}
    for key, shape in shapes.items():
        t = torch.empty(shape, device=dev)
        name = key.rsplit(".", 1)[-1]
        if name == "logit_scale":
            t.fill_(math.log(10.0))
        elif name == "weight" and len(shape) == 2:                     # a Linear's
            torch.nn.init.trunc_normal_(t, std=0.02, a=-2.0, b=2.0, generator=gen)
        elif len(shape) == 4:
            bound = _fan_in(shape) ** -0.5
            t.uniform_(-bound, bound, generator=gen)
        elif len(shapes.get(key[:-len(name)] + "weight", ())) == 4:     # a conv's bias
            bound = _fan_in(shapes[key[:-len(name)] + "weight"]) ** -0.5
            t.uniform_(-bound, bound, generator=gen)
        elif name == "weight":                                         # a LayerNorm's
            t.fill_(1.0)
        else:                                    # Linear and LayerNorm biases, q_bias, v_bias
            t.zero_()
        sd[key] = t
    sd[f"{LAST}.bias"].zero_()
    pre = []
    with torch.no_grad(), ref.precision_flags("fp32"):
        for img in calibration:
            h, w = img.shape[:2]
            x = img.permute(2, 0, 1)[None]
            x = torch.nn.functional.interpolate(x, size=ref.transform_size(h, w, cfg),
                                                mode="bicubic", align_corners=False)
            pre.append(ref.forward(sd, ((x - ref.MEAN) / ref.STD).contiguous(), cfg,
                                   relu=False).flatten().cpu())
    pre = torch.cat(pre)
    k = min(max(int(round((1.0 - pass_share) * pre.numel())), 1), pre.numel())
    sd[f"{LAST}.bias"].fill_(-torch.kthvalue(pre, k).values.item())
    return sd
