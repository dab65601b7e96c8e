"""MobileNetV2 feature trunk (Sandler et al. 2018), the style-predictor
backbone of the distilled magenta stylizer. Port of
``aip_tpu.models.mobilenet``.

Inference-mode network: every conv + BatchNorm pair is stored folded as
``y = conv(x, w) * scale + shift`` (BatchNorm in eval mode). Weights are
OIHW (``nn.Conv2d`` layout; depthwise ``(C, 1, k, k)``), activations NHWC
at the public functions, as in ``aip_tpu``. ``convert_torch_mobilenet_v2``
takes torchvision's ``mobilenet_v2().state_dict()`` key layout.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from aip_tpu_torch.device import fp32_convs, resolve_device

# Inverted-residual plan (expansion t, out channels c, repeats n, stride s):
# MobileNetV2 paper Table 2 / torchvision `inverted_residual_setting`.
MBV2_CFG = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)
MBV2_FEATURES = 1280


def _block_strides() -> list:
    return [s if i == 0 else 1 for _t, _c, n, s in MBV2_CFG for i in range(n)]


class ConvBN(nn.Module):
    """A conv with its BatchNorm folded in: weight OIHW, scale and shift [C]."""

    def __init__(self, k: int, cin: int, cout: int, groups: int = 1, device=None):
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.empty((cout, cin // groups, k, k), device=device))
        self.scale = nn.Parameter(torch.empty(cout, device=device))
        self.shift = nn.Parameter(torch.empty(cout, device=device))


class MobileNetV2Trunk(nn.Module):
    """stem, the 17 inverted-residual blocks (``expand`` where t != 1,
    ``dw``, ``project``), head. Parameters are uninitialised until filled."""

    def __init__(self, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.stem = ConvBN(3, 3, 32, device=dev)
        blocks = []
        cin = 32
        for t, c, n, _s in MBV2_CFG:
            for _ in range(n):
                hidden = cin * t
                blk = nn.ModuleDict()
                if t != 1:
                    blk["expand"] = ConvBN(1, cin, hidden, device=dev)
                blk["dw"] = ConvBN(3, hidden, hidden, groups=hidden, device=dev)
                blk["project"] = ConvBN(1, hidden, c, device=dev)
                blocks.append(blk)
                cin = c
        self.blocks = nn.ModuleList(blocks)
        self.head = ConvBN(1, cin, MBV2_FEATURES, device=dev)


def mbv2_trunk_skeleton(device=None) -> MobileNetV2Trunk:
    """The trunk's structure with uninitialised storage, for loaders to fill."""
    return MobileNetV2Trunk(device)


def init_mbv2_trunk(generator: torch.Generator, device=None) -> MobileNetV2Trunk:
    """He-normal convs, unit scales, zero shifts, drawn on the CPU from
    ``generator`` so that one seed gives the same trunk on every device."""
    trunk = MobileNetV2Trunk(device)
    with torch.no_grad():
        for cb in _conv_bns(trunk):
            fan_in = cb.weight.shape[1] * cb.weight.shape[2] * cb.weight.shape[3]
            cb.weight.copy_(torch.randn(cb.weight.shape, generator=generator)
                            * (2.0 / fan_in) ** 0.5)
            cb.scale.fill_(1.0)
            cb.shift.zero_()
    return trunk


def _conv_bns(trunk: MobileNetV2Trunk):
    yield trunk.stem
    for blk in trunk.blocks:
        yield from blk.values()
    yield trunk.head


def mbv2_items(trunk: MobileNetV2Trunk):
    """(name, ConvBN) in the npz checkpoint's order: stem, b{i}_{expand,dw,
    project}, head."""
    yield "stem", trunk.stem
    for i, blk in enumerate(trunk.blocks):
        for part in ("expand", "dw", "project"):
            if part in blk:
                yield f"b{i}_{part}", blk[part]
    yield "head", trunk.head


def _conv_bn(x, cb: ConvBN, stride: int = 1, relu6: bool = True):
    """NCHW conv (zero padding (k-1)//2 each side), folded BN, ReLU6."""
    k = cb.weight.shape[-1]
    pad = (k - 1) // 2
    with fp32_convs():
        y = F.conv2d(x, cb.weight, stride=stride, padding=pad, groups=cb.groups)
    y = y * cb.scale[:, None, None] + cb.shift[:, None, None]
    return torch.clamp(y, 0.0, 6.0) if relu6 else y


def mbv2_features(trunk: MobileNetV2Trunk, x: torch.Tensor) -> torch.Tensor:
    """[N, H, W, 3] -> [N, 1280] global-pooled MobileNetV2 features."""
    y = _conv_bn(x.permute(0, 3, 1, 2), trunk.stem, stride=2)
    for blk, stride in zip(trunk.blocks, _block_strides()):
        z = y
        if "expand" in blk:
            z = _conv_bn(z, blk["expand"])
        z = _conv_bn(z, blk["dw"], stride=stride)
        z = _conv_bn(z, blk["project"], relu6=False)
        y = y + z if stride == 1 and y.shape[1] == z.shape[1] else z
    y = _conv_bn(y, trunk.head)
    return y.mean(dim=(2, 3))


def _fold(sd, conv_key: str, bn_key: str, eps: float = 1e-5):
    """torch conv weight + BatchNorm statistics -> (OIHW w, scale, shift)."""
    w = np.asarray(sd[f"{conv_key}.weight"], np.float32)
    gamma = np.asarray(sd[f"{bn_key}.weight"], np.float32)
    beta = np.asarray(sd[f"{bn_key}.bias"], np.float32)
    mean = np.asarray(sd[f"{bn_key}.running_mean"], np.float32)
    var = np.asarray(sd[f"{bn_key}.running_var"], np.float32)
    scale = gamma / np.sqrt(var + eps)
    return w, scale, beta - mean * scale


def _set(cb: ConvBN, w, scale, shift) -> None:
    with torch.no_grad():
        for p, v in ((cb.weight, w), (cb.scale, scale), (cb.shift, shift)):
            p.copy_(torch.from_numpy(np.ascontiguousarray(v, np.float32)))


def convert_torch_mobilenet_v2(sd, device=None) -> MobileNetV2Trunk:
    """torchvision ``mobilenet_v2().state_dict()`` -> a folded trunk on
    ``device``. Only ``features.*`` is read; the classifier is ignored."""
    trunk = MobileNetV2Trunk(device)
    _set(trunk.stem, *_fold(sd, "features.0.0", "features.0.1"))
    idx = 1
    for blk in trunk.blocks:
        base = f"features.{idx}.conv"
        if "expand" in blk:
            _set(blk["expand"], *_fold(sd, f"{base}.0.0", f"{base}.0.1"))
            _set(blk["dw"], *_fold(sd, f"{base}.1.0", f"{base}.1.1"))
            _set(blk["project"], *_fold(sd, f"{base}.2", f"{base}.3"))
        else:
            _set(blk["dw"], *_fold(sd, f"{base}.0.0", f"{base}.0.1"))
            _set(blk["project"], *_fold(sd, f"{base}.1", f"{base}.2"))
        idx += 1
    _set(trunk.head, *_fold(sd, f"features.{idx}.0", f"features.{idx}.1"))
    return trunk
