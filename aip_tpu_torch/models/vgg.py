"""VGG-19 "normalised" encoder (pytorch-AdaIN variant). Port of
``aip_tpu.models.vgg``.

A 1x1 RGB conv, then the VGG-19 conv stack with reflection padding, ReLU
and ceil-mode 2x2 max pools (reference ``AdaIN/net.py:38-92``). AdaIN uses
the slice up to relu4_1.

The head (conv0 .. pool1, the four full-resolution 64-channel stages) goes
through the fused ``encode_head`` kernel whenever no relu1_x tap is asked
for: on a CUDA tensor that is always the hand-written kernel, on a CPU
tensor its plain version. The remaining 3x3 convs are ``F.conv2d``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from aip_tpu_torch.device import resolve_device
from aip_tpu_torch.kernels.adain_head import encode_head

# ('conv', in_ch, out_ch, kernel, torch_index) | ('relu', tap) | ('pool',) | ('pad',)
VGG_LAYERS = (
    ("conv", 3, 3, 1, 0),
    ("pad",),
    ("conv", 3, 64, 3, 2),
    ("relu", "relu1_1"),
    ("pad",),
    ("conv", 64, 64, 3, 5),
    ("relu", "relu1_2"),
    ("pool",),
    ("pad",),
    ("conv", 64, 128, 3, 9),
    ("relu", "relu2_1"),
    ("pad",),
    ("conv", 128, 128, 3, 12),
    ("relu", "relu2_2"),
    ("pool",),
    ("pad",),
    ("conv", 128, 256, 3, 16),
    ("relu", "relu3_1"),
    ("pad",),
    ("conv", 256, 256, 3, 19),
    ("relu", "relu3_2"),
    ("pad",),
    ("conv", 256, 256, 3, 22),
    ("relu", "relu3_3"),
    ("pad",),
    ("conv", 256, 256, 3, 25),
    ("relu", "relu3_4"),
    ("pool",),
    ("pad",),
    ("conv", 256, 512, 3, 29),
    ("relu", "relu4_1"),  # last layer used by AdaIN
    ("pad",),
    ("conv", 512, 512, 3, 32),
    ("relu", "relu4_2"),
    ("pad",),
    ("conv", 512, 512, 3, 35),
    ("relu", "relu4_3"),
    ("pad",),
    ("conv", 512, 512, 3, 38),
    ("relu", "relu4_4"),
    ("pool",),
    ("pad",),
    ("conv", 512, 512, 3, 42),
    ("relu", "relu5_1"),
    ("pad",),
    ("conv", 512, 512, 3, 45),
    ("relu", "relu5_2"),
    ("pad",),
    ("conv", 512, 512, 3, 48),
    ("relu", "relu5_3"),
    ("pad",),
    ("conv", 512, 512, 3, 51),
    ("relu", "relu5_4"),
)

# Intermediate taps for style losses (reference net.py:116-121).
STYLE_TAPS = ("relu1_1", "relu2_1", "relu3_1", "relu4_1")

_POOL1 = VGG_LAYERS.index(("pool",))


def conv_specs(layers=VGG_LAYERS):
    return [l for l in layers if l[0] == "conv"]


def _empty_convs(specs, device) -> nn.ModuleList:
    """Conv2d modules with uninitialised storage on ``device`` (no default
    init pass: callers fill every weight)."""
    convs = nn.ModuleList(
        nn.Conv2d(cin, cout, k, device="meta") for cin, cout, k in specs)
    return convs.to_empty(device=device)


def he_normal_(convs: nn.ModuleList, seed: int) -> None:
    """He-normal weights, zero biases, drawn on the CPU from ``seed`` so the
    same seed gives the same weights on every device."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    with torch.no_grad():
        for conv in convs:
            fan_in = conv.in_channels * conv.kernel_size[0] * conv.kernel_size[1]
            w = torch.randn(conv.weight.shape, generator=gen) * (2.0 / fan_in) ** 0.5
            conv.weight.copy_(w)
            conv.bias.zero_()


class VGGEncoder(nn.Module):
    """The encoder's convs, in network order (``convs[i]`` is the i-th conv
    of ``VGG_LAYERS``). Weights are uninitialised until filled: use
    ``init_vgg_params`` or ``models.weights``."""

    def __init__(self, device=None):
        super().__init__()
        self.convs = _empty_convs(
            [(cin, cout, k) for _, cin, cout, k, _ in conv_specs()], resolve_device(device))

    def forward(self, x, taps=STYLE_TAPS, compute_dtype=torch.float32):
        return vgg_encode_with_intermediate(self, x, taps, compute_dtype)


def init_vgg_params(seed: int = 0, device=None) -> VGGEncoder:
    """He-normal random init (fallback when pretrained weights are absent)."""
    enc = VGGEncoder(device)
    he_normal_(enc.convs, seed)
    return enc


def vgg_encode(params: VGGEncoder, x: torch.Tensor, upto: str = "relu4_1",
               compute_dtype=torch.float32) -> torch.Tensor:
    """Run the encoder up to (and including) the named ReLU tap. NHWC in [0,1]."""
    return vgg_encode_with_intermediate(params, x, (upto,), compute_dtype)[upto]


def _run_layers(convs, t, layers, ci, remaining, compute_dtype):
    """Walk ``layers`` on the NCHW view ``t`` starting at conv ``ci``;
    returns the requested taps as NHWC."""
    out = {}
    pending_pad = False
    for layer in layers:
        kind = layer[0]
        if kind == "conv":
            t = t.to(compute_dtype)
            if pending_pad:
                t = F.pad(t, (1, 1, 1, 1), mode="reflect")
                pending_pad = False
            conv = convs[ci]
            t = F.conv2d(t, conv.weight.to(compute_dtype), conv.bias.to(compute_dtype))
            ci += 1
        elif kind == "pad":
            pending_pad = True
        elif kind == "pool":
            t = F.max_pool2d(t, 2, 2, ceil_mode=True)
        elif kind == "relu":
            t = torch.relu(t)
            if layer[1] in remaining:
                out[layer[1]] = t.permute(0, 2, 3, 1)
                remaining.discard(layer[1])
                if not remaining:
                    return out
    if remaining:
        raise ValueError(f"unknown taps: {remaining}")
    return out


def vgg_encode_with_intermediate(params: VGGEncoder, x: torch.Tensor, taps=STYLE_TAPS,
                                 compute_dtype=torch.float32):
    """Return a dict of the requested ReLU taps (NHWC). Stops at the deepest
    tap. Without a relu1_x tap, conv0 .. pool1 run as one ``encode_head``."""
    remaining = set(taps)
    convs = params.convs
    if not remaining & {"relu1_1", "relu1_2"}:
        c0, c1, c2 = convs[0], convs[1], convs[2]
        h = encode_head(x.to(compute_dtype).contiguous(), c0.weight, c0.bias,
                        c1.weight, c1.bias, c2.weight, c2.bias)
        return _run_layers(convs, h.permute(0, 3, 1, 2), VGG_LAYERS[_POOL1 + 1:], 3,
                           remaining, compute_dtype)
    return _run_layers(convs, x.permute(0, 3, 1, 2), VGG_LAYERS, 0, remaining,
                       compute_dtype)
