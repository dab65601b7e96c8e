"""AdaIN decoder: mirror of the VGG encoder from relu4_1 back to RGB.
Port of ``aip_tpu.models.decoder`` (reference ``AdaIN/net.py:6-36``).

The last up2x -> conv 64->64 -> ReLU -> conv 64->3 runs as the fused
``decode_tail`` kernel whenever the walk reaches it: on a CUDA tensor that
is always the hand-written kernel, on a CPU tensor its plain version. The
other convs run as the encoder's (``models.vgg``): in fp32 where autograd
records nothing, each goes to ``conv3x3_f32``; in bf16 where autograd
records nothing, one ``conv_epilogue`` finishes each (bias, ReLU,
upsample, the next conv's border), elsewhere the PyTorch op chain. A conv
that is not an ``nn.Conv2d`` (the tensor-parallel conv of
``parallel.train``) is called on the padded input, and its decoder takes
the op chain; the tail takes its gathered weight.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from aip_tpu_torch.device import fp32_convs, resolve_device
from aip_tpu_torch.kernels.adain_head import decode_tail
from aip_tpu_torch.kernels.conv_epilogue import conv_epilogue, conv_epilogue_chain
from aip_tpu_torch.models.vgg import (_empty_convs, conv_raw, epilogue_ops, he_normal_,
                                      walk_route)
from aip_tpu_torch.utils.profiling import count, span

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


def walk_conv_shapes(h: int, w: int) -> list[tuple[int, int, int, int]]:
    """(Cin, Cout, H_out, W_out) of each conv that an fp32 no-grad decode
    of an h x w relu4_1 map sends to ``conv3x3_f32``, in walk order: every
    conv before the tail's two."""
    shapes, n_walk = [], len(conv_specs()) - 2
    for layer in DECODER_LAYERS:
        if layer[0] == "conv" and len(shapes) < n_walk:
            shapes.append((layer[1], layer[2], h, w))
        elif layer[0] == "up":
            h, w = 2 * h, 2 * w
    return shapes


def init_decoder_params(seed: int = 1, device=None) -> AdaINDecoder:
    """He-normal random init (fallback when pretrained weights are absent)."""
    dec = AdaINDecoder(device)
    he_normal_(dec.convs, seed)
    return dec


def decoder_apply(params: AdaINDecoder, x: torch.Tensor,
                  compute_dtype=torch.float32) -> torch.Tensor:
    """Decode a [N, h, w, 512] relu4_1-space feature map to [N, 8h, 8w, 3]
    (NHWC, compute dtype). The last upsample and the two convs after it go
    through ``decode_tail``. The other convs run by the walk's
    ``walk_route`` (``models.vgg``). cuDNN's convs run under
    ``fp32_convs`` (no TF32 for fp32 convs). One ``adain.decode`` span,
    device-timed on a card."""
    convs = params.convs
    route = walk_route(x, convs, compute_dtype)
    with span("adain.decode", device=x), fp32_convs():
        return _decode_layers(convs, x, compute_dtype, route)


def _decode_layers(convs, x, compute_dtype, route):
    """``decoder_apply``'s walk over ``DECODER_LAYERS`` on NHWC, each conv's
    output (``conv_raw`` by ``route``) finished by one ``conv_epilogue``
    ("epilogue") or by the op chain (``conv_epilogue_chain``); the conv
    before the tail's upsample is finished without a border and handed to
    ``decode_tail``."""
    fused = route == "epilogue"
    finish = conv_epilogue if fused else conv_epilogue_chain
    n_convs = len(convs)
    t = finish(x.to(compute_dtype).contiguous())     # the leading ("pad",)
    i, ci = 1, 0
    while i < len(DECODER_LAYERS):
        conv = convs[ci]
        if isinstance(conv, nn.Conv2d):
            raw, bias = conv_raw(t, conv, compute_dtype, route)
        else:   # a conv split over devices (parallel.train.ColumnParallelConv), bias added
            raw, bias = conv(t.permute(0, 3, 1, 2), compute_dtype).permute(0, 2, 3, 1), None
        relu, _, resample, border, i = epilogue_ops(DECODER_LAYERS, i)
        ci += 1
        count("models.epilogues", 1)
        if fused:
            count("models.epilogues_fused", 1)
        if resample == "up" and ci == n_convs - 2:
            y = finish(raw, bias, relu, None, False).contiguous()
            c2, c1 = convs[ci], convs[ci + 1]
            return decode_tail(y, c2.weight, c2.bias, c1.weight, c1.bias)
        t = finish(raw, bias, relu, resample, border)
    raise AssertionError("DECODER_LAYERS has no final up2x before its last two convs")
