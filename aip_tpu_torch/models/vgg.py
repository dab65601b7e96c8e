"""VGG-19 "normalised" encoder (pytorch-AdaIN variant). Port of
``aip_tpu.models.vgg``.

A 1x1 RGB conv, then the VGG-19 conv stack with reflection padding, ReLU
and ceil-mode 2x2 max pools (reference ``AdaIN/net.py:38-92``). AdaIN uses
the slice up to relu4_1.

The head (conv0 .. pool1, the four full-resolution 64-channel stages) goes
through the fused ``encode_head`` kernel whenever no relu1_x tap is asked
for: on a CUDA tensor that is always the hand-written kernel, on a CPU
tensor its plain version. The remaining convs run without their bias, on
NHWC activations. In fp32 where autograd records nothing, each 3x3 conv
of widths that are multiples of 64 goes to ``conv3x3_f32`` (the
hand-written fp32-accurate kernel on a card, its plain version, the same
``F.conv2d``, on the CPU), counted in ``models.convs_f32_kernel``; every
other conv is ``F.conv2d`` (cuDNN on a card). In bf16 where autograd
records nothing, one ``conv_epilogue`` finishes each conv's output (bias,
ReLU, pool, the next conv's reflection border, NHWC, for a conv on
channels_last weights); other calls finish it with the same ops as a
PyTorch chain (``conv_epilogue_chain``). Each conv output the walks finish
counts in ``models.epilogues``, each through the epilogue in
``models.epilogues_fused``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from aip_tpu_torch.device import fp32_convs, resolve_device
from aip_tpu_torch.kernels.adain_head import encode_head
from aip_tpu_torch.kernels.conv3x3_f32 import conv3x3_f32, pack_weights, takes
from aip_tpu_torch.kernels.conv_epilogue import conv_epilogue, conv_epilogue_chain
from aip_tpu_torch.utils.profiling import count, span

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
    of ``VGG_LAYERS``): all of them, or the first ``n_convs`` (a checkpoint
    read only as deep as its taps are asked for), past which a walk raises
    ``ValueError``. Weights are uninitialised until filled: use
    ``init_vgg_params`` or ``models.weights``."""

    def __init__(self, device=None, n_convs: int | None = None):
        super().__init__()
        self.convs = _empty_convs(
            [(cin, cout, k) for _, cin, cout, k, _ in conv_specs()[:n_convs]],
            resolve_device(device))

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


def _cached(conv: nn.Conv2d, slot, make):
    """``make(weight, bias)`` of ``conv``'s detached weight and bias, cached
    on the module under ``slot``; the key holds the weight's and the bias's
    data_ptr, _version and device, so an in-place update or a new tensor
    recomputes. An entry holds the tensors it was made from, so their memory
    cannot be reused under the same key while it is cached."""
    weight, bias = conv.weight, conv.bias
    key = tuple((t.data_ptr(), t._version, t.device) for t in (weight, bias))
    cache = conv.__dict__.setdefault("_conv_weights", {})
    hit = cache.get(slot)
    if hit is None or hit[0] != key:
        with torch.no_grad():
            hit = cache[slot] = (key, (weight, bias), make(weight.detach(), bias.detach()))
    return hit[2]


def conv_weights(conv: nn.Conv2d, dtype):
    """(weight in ``dtype``, channels_last; bias in ``dtype``, as fp32) of
    ``conv``, the operands of a conv without its bias and of its epilogue.
    Cached on the module per dtype (``_cached``)."""
    return _cached(conv, dtype, lambda w, b: (
        w.to(dtype).contiguous(memory_format=torch.channels_last), b.to(dtype).float()))


def conv_pack(conv: nn.Conv2d) -> torch.Tensor:
    """``conv``'s weights packed for ``conv3x3_f32`` (``pack_weights``),
    cached on the module (``_cached``)."""
    return _cached(conv, "conv3x3_f32", lambda w, b: pack_weights(w))


def takes_f32_kernel(conv) -> bool:
    """Whether ``conv3x3_f32`` computes ``conv``: an ``nn.Conv2d`` with a
    3x3 kernel, stride 1, no padding, dilation or groups, and widths that
    are multiples of 64 (every walk conv past the head and before the
    tail; not the 1x1 RGB conv nor the 3->64 conv)."""
    return (isinstance(conv, nn.Conv2d) and conv.kernel_size == (3, 3)
            and conv.stride == (1, 1) and conv.padding == (0, 0) and conv.dilation == (1, 1)
            and conv.groups == 1 and takes(conv.in_channels, conv.out_channels))


def conv_raw(t, conv, compute_dtype, route):
    """``conv``'s output on the NHWC ``t`` (bordered where the conv needs
    it), without its bias, as NHWC; and the bias its epilogue adds, by the
    walk's ``route`` (``walk_route``). "kernel" and a conv the kernel takes
    (``takes_f32_kernel``): ``conv3x3_f32`` on the cached pack
    (``conv_pack``), its output NHWC-contiguous on a card. "epilogue": the
    cached channels_last weights (``conv_weights``), so cuDNN reads and
    writes NHWC, and the output NHWC-contiguous, as ``conv_epilogue`` takes
    it. Else the module's own weights, which autograd records (bf16 ones
    channels_last too: cuDNN's bf16 convs are NHWC kernels, and both routes
    then give the same bits), and a view of cuDNN's output."""
    if route == "kernel" and takes_f32_kernel(conv):
        count("models.convs_f32_kernel", 1)
        return conv3x3_f32(t, conv.weight, conv_pack(conv) if t.is_cuda else None), conv.bias
    x = t.permute(0, 3, 1, 2)
    if route == "epilogue":
        w, bias = conv_weights(conv, compute_dtype)
        return F.conv2d(x, w).permute(0, 2, 3, 1).contiguous(), bias
    w = conv.weight.to(compute_dtype)
    if compute_dtype == torch.bfloat16:
        w = w.contiguous(memory_format=torch.channels_last)
    return F.conv2d(x, w).permute(0, 2, 3, 1), conv.bias


def epilogue_ops(layers, i):
    """The ops between the conv at ``layers[i]`` and the next conv (or the
    end): (relu, its tap or None, resample None/"pool"/"up", border, index
    of the next conv)."""
    relu, tap, resample, border = False, None, None, False
    i += 1
    while i < len(layers) and layers[i][0] != "conv":
        kind = layers[i][0]
        if kind == "relu":
            relu, tap = True, (layers[i][1] if len(layers[i]) > 1 else None)
        elif kind in ("pool", "up"):
            resample = kind
        elif kind == "pad":
            border = True
        i += 1
    return relu, tap, resample, border, i


def walk_route(x, convs, compute_dtype) -> str:
    """How a walk of ``convs`` on ``x`` runs each conv, decided once a
    walk. The kernel and the epilogue have no backward, so both want a walk
    that autograd does not record:

    * "kernel", fp32: each conv ``conv3x3_f32`` takes
      (``takes_f32_kernel``) goes to it, the others to cuDNN; every output
      is finished by the op chain (``conv_epilogue_chain``);
    * "epilogue", bf16 on ``nn.Conv2d``s: cuDNN on channels_last weights,
      each output finished by one ``conv_epilogue``;
    * "chain" elsewhere: cuDNN on the module's weights, which autograd
      records, then the op chain."""
    records = torch.is_grad_enabled() and (
        x.requires_grad or any(p.requires_grad for p in convs.parameters()))
    if records:
        return "chain"
    if compute_dtype == torch.float32:
        return "kernel"
    if compute_dtype == torch.bfloat16 and all(isinstance(c, nn.Conv2d) for c in convs):
        return "epilogue"
    return "chain"


def walk_conv_shapes(h: int, w: int) -> list[tuple[int, int, int, int]]:
    """(Cin, Cout, H_out, W_out) of each conv that an fp32 no-grad encode
    of an h x w image to relu4_1 sends to ``conv3x3_f32``, in walk order:
    those past the head, whose ceil-mode pool1 halves h and w."""
    shapes = []
    h, w = -(-h // 2), -(-w // 2)
    for layer in VGG_LAYERS[_POOL1 + 1:]:
        if layer[0] == "conv" and takes(layer[1], layer[2]):
            shapes.append((layer[1], layer[2], h, w))
        elif layer[0] == "pool":
            h, w = -(-h // 2), -(-w // 2)
        elif layer == ("relu", "relu4_1"):
            return shapes
    raise AssertionError("VGG_LAYERS has no relu4_1")


def _run_layers(convs, t, layers, ci, remaining, compute_dtype, route):
    """Walk ``layers`` on the NHWC ``t`` starting at conv ``ci``, each
    conv's output (``conv_raw`` by ``route``) finished by one
    ``conv_epilogue`` ("epilogue") or by the op chain
    (``conv_epilogue_chain``); returns the requested taps as NHWC. Fused, a
    tap followed by a border is the padded buffer's interior."""
    fused = route == "epilogue"
    finish = conv_epilogue if fused else conv_epilogue_chain
    out = {}
    t = t.to(compute_dtype).contiguous()
    i = 0
    if layers[0] == ("pad",):
        t, i = finish(t), 1
    while i < len(layers):
        if ci == len(convs):
            raise ValueError(f"taps {sorted(remaining)} lie past the encoder's "
                             f"{len(convs)} convs")
        raw, bias = conv_raw(t, convs[ci], compute_dtype, route)
        relu, tap, resample, border, i = epilogue_ops(layers, i)
        ci += 1
        count("models.epilogues", 1)
        if fused:
            count("models.epilogues_fused", 1)
        if tap not in remaining:
            t = finish(raw, bias, relu, resample, border)
            continue
        remaining.discard(tap)
        if fused and remaining and resample is None and border:
            t = finish(raw, bias, relu, None, True)
            out[tap] = t[:, 1:-1, 1:-1]
            continue
        out[tap] = finish(raw, bias, relu, None, False)
        if not remaining:
            return out
        t = finish(out[tap], None, False, resample, border)
    if remaining:
        raise ValueError(f"unknown taps: {remaining}")
    return out


def vgg_encode_with_intermediate(params: VGGEncoder, x: torch.Tensor, taps=STYLE_TAPS,
                                 compute_dtype=torch.float32):
    """Return a dict of the requested ReLU taps (NHWC). Stops at the deepest
    tap. Without a relu1_x tap, conv0 .. pool1 run as one ``encode_head``.
    Each conv runs by the walk's ``walk_route``. cuDNN's convs run under
    ``fp32_convs`` (no TF32 for fp32 convs). One ``adain.encode`` span,
    device-timed on a card."""
    remaining = set(taps)
    convs = params.convs
    route = walk_route(x, convs, compute_dtype)
    with span("adain.encode", device=x), fp32_convs():
        if not remaining & {"relu1_1", "relu1_2"}:
            c0, c1, c2 = convs[0], convs[1], convs[2]
            h = encode_head(x.to(compute_dtype).contiguous(), c0.weight, c0.bias,
                            c1.weight, c1.bias, c2.weight, c2.bias)
            return _run_layers(convs, h, VGG_LAYERS[_POOL1 + 1:], 3, remaining,
                               compute_dtype, route)
        return _run_layers(convs, x, VGG_LAYERS, 0, remaining, compute_dtype, route)
