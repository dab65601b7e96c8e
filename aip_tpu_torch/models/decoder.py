"""AdaIN decoder: mirror of the VGG encoder from relu4_1 back to RGB.
Port of ``aip_tpu.models.decoder`` (reference ``AdaIN/net.py:6-36``).

The last up2x -> conv 64->64 -> ReLU -> conv 64->3 runs as the fused
``decode_tail`` kernel whenever the walk reaches it: on a CUDA tensor that
is always the hand-written kernel, on a CPU tensor its plain version.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from aip_tpu_torch.device import fp32_convs, resolve_device
from aip_tpu_torch.kernels.adain_head import decode_tail
from aip_tpu_torch.models.vgg import _empty_convs, he_normal_

# ('conv', in, out, torch_index) | ('relu',) | ('up',) | ('pad',)
DECODER_LAYERS = (
    ("pad",),
    ("conv", 512, 256, 1),
    ("relu",),
    ("up",),
    ("pad",),
    ("conv", 256, 256, 5),
    ("relu",),
    ("pad",),
    ("conv", 256, 256, 8),
    ("relu",),
    ("pad",),
    ("conv", 256, 256, 11),
    ("relu",),
    ("pad",),
    ("conv", 256, 128, 14),
    ("relu",),
    ("up",),
    ("pad",),
    ("conv", 128, 128, 18),
    ("relu",),
    ("pad",),
    ("conv", 128, 64, 21),
    ("relu",),
    ("up",),
    ("pad",),
    ("conv", 64, 64, 25),
    ("relu",),
    ("pad",),
    ("conv", 64, 3, 28),
)


def conv_specs(layers=DECODER_LAYERS):
    return [l for l in layers if l[0] == "conv"]


class AdaINDecoder(nn.Module):
    """The decoder's 3x3 convs in network order. Weights are uninitialised
    until filled: use ``init_decoder_params`` or ``models.weights``."""

    def __init__(self, device=None):
        super().__init__()
        self.convs = _empty_convs(
            [(cin, cout, 3) for _, cin, cout, _ in conv_specs()], resolve_device(device))

    def forward(self, x, compute_dtype=torch.float32):
        return decoder_apply(self, x, compute_dtype)


def init_decoder_params(seed: int = 1, device=None) -> AdaINDecoder:
    """He-normal random init (fallback when pretrained weights are absent)."""
    dec = AdaINDecoder(device)
    he_normal_(dec.convs, seed)
    return dec


def decoder_apply(params: AdaINDecoder, x: torch.Tensor,
                  compute_dtype=torch.float32) -> torch.Tensor:
    """Decode a [N, h, w, 512] relu4_1-space feature map to [N, 8h, 8w, 3]
    (NHWC, compute dtype). The last upsample and the two convs after it go
    through ``decode_tail``. The convs run under ``fp32_convs`` (no TF32
    for fp32 convs)."""
    with fp32_convs():
        return _decode_layers(params.convs, x, compute_dtype)


def _decode_layers(convs, x, compute_dtype):
    """``decoder_apply``'s walk over ``DECODER_LAYERS``."""
    n_convs = len(convs)
    t = x.permute(0, 3, 1, 2)
    ci = 0
    for layer in DECODER_LAYERS:
        kind = layer[0]
        if kind == "up" and ci == n_convs - 2:
            c2, c1 = convs[ci], convs[ci + 1]
            y = t.to(compute_dtype).permute(0, 2, 3, 1).contiguous()
            return decode_tail(y, c2.weight, c2.bias, c1.weight, c1.bias)
        if kind == "conv":
            t = F.pad(t.to(compute_dtype), (1, 1, 1, 1), mode="reflect")
            conv = convs[ci]
            t = F.conv2d(t, conv.weight.to(compute_dtype), conv.bias.to(compute_dtype))
            ci += 1
        elif kind == "up":
            t = F.interpolate(t, scale_factor=2, mode="nearest")
        elif kind == "relu":
            t = torch.relu(t)
    raise AssertionError("DECODER_LAYERS has no final up2x before its last two convs")
