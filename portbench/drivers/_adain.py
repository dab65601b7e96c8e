"""What the AdaIN drivers share: weights and images made from the seed on
the device, and the program's modules filled with those weights."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

LAST_SCALE = 0.25
LAST_BIAS = 0.5


def conv_shapes(layers):
    return [(l[2], l[1], l[3], l[3]) for l in layers if l[0] == "conv"]


def make_weights(cfg: dict, seed: int, device) -> tuple[list, list]:
    """He-normal (OIHW w, b) of the encoder to relu4_1 and of the decoder,
    drawn in one call on ``device`` from ``seed``; zero biases, except the
    decoder's last conv (weights x ``LAST_SCALE``, bias ``LAST_BIAS``)."""
    shapes = conv_shapes(cfg["encoder"]) + conv_shapes(cfg["decoder"])
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(math.prod(s) for s in shapes), generator=gen, device=device)
    weights, at = [], 0
    for s in shapes:
        n = math.prod(s)
        w = flat[at:at + n].view(s) * math.sqrt(2.0 / (s[1] * s[2] * s[3]))
        weights.append((w, torch.zeros(s[0], device=device)))
        at += n
    n_enc = len(conv_shapes(cfg["encoder"]))
    enc, dec = weights[:n_enc], weights[n_enc:]
    w, b = dec[-1]
    dec[-1] = (w * LAST_SCALE, b + LAST_BIAS)
    return enc, dec


def images(seed: int, n: int, h: int, w: int, device, coarse: int = 24) -> torch.Tensor:
    """n smooth random NHWC images in [0, 1]: coarse noise, upsampled
    bicubically, plus fine noise."""
    gen = torch.Generator(device=device).manual_seed(seed)
    low = torch.rand((n, 3, coarse, coarse), generator=gen, device=device)
    img = F.interpolate(low, size=(h, w), mode="bicubic", align_corners=False)
    img = img + 0.05 * torch.randn((n, 3, h, w), generator=gen, device=device)
    return img.clamp(0.0, 1.0).permute(0, 2, 3, 1).contiguous()


def fill(module, weights) -> None:
    """Copy (w, b) pairs into the module's convs in order; convs past the
    list (the encoder's past relu4_1) are zeroed."""
    with torch.no_grad():
        for i, conv in enumerate(module.convs):
            if i < len(weights):
                conv.weight.copy_(weights[i][0])
                conv.bias.copy_(weights[i][1])
            else:
                conv.weight.zero_()
                conv.bias.zero_()


def rel_rms_per_image(out: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Each image's RMS of (out - ref) over ref's RMS, float64; inf where the
    output is not finite or has another shape."""
    if out.shape != ref.shape or not torch.isfinite(out).all():
        return torch.full((ref.shape[0],), float("inf"), dtype=torch.float64)
    d = (out.double() - ref.double()).flatten(1).pow(2).mean(1).sqrt()
    return (d / ref.double().flatten(1).pow(2).mean(1).sqrt()).cpu()
