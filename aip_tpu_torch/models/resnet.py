"""ResNet-50 feature extractor (torchvision layout) for multi-backbone NST.
Port of ``aip_tpu.models.resnet``.

Parity with reference `gui/seven_page.py:123-148` ResNetFeatureExtractor:
stem (conv7x7/2 + BN + ReLU + maxpool3x3/2) -> layer1..layer4 bottleneck
stages with taps after each stage. Inference-only: BatchNorm uses stored
running statistics. Weights convert from a torchvision ``resnet50``
state_dict when provided; deterministic random init otherwise.

Parameters are a ``weights.ParamTree`` with the JAX package's keys (conv
weights OIHW); a stage is as deep as its list of blocks. Activations are
NHWC at the public functions, NCHW inside; the convs run under
``fp32_convs``. ``_bn`` and ``_init_bn`` are shared with DeepLab.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from aip_tpu_torch.device import fp32_convs, resolve_device

# Bottleneck counts and widths per stage (ResNet-50).
STAGES = ((3, 64, 256), (4, 128, 512), (6, 256, 1024), (3, 512, 2048))


def _conv(x, p, stride=1):
    # Symmetric torch padding ((k-1)//2 each side), as torchvision pads.
    k = p["w"].shape[-1]
    pad = (k - 1) // 2
    with fp32_convs():
        return F.conv2d(x, p["w"], stride=stride, padding=pad)


def _bn(x, p, eps=1e-5):
    """Inference BatchNorm on NCHW ``x`` from the node's gamma, beta, mean, var."""
    def c(v):
        return v[:, None, None]

    inv = torch.rsqrt(p["var"] + eps)
    return (x - c(p["mean"])) * c(inv) * c(p["gamma"]) + c(p["beta"])


def _init_conv(gen, kh, kw, cin, cout):
    from aip_tpu_torch.models.weights import he_normal

    return {"w": he_normal(gen, (cout, cin, kh, kw))}


def _init_bn(c):
    return {"gamma": torch.ones(c), "beta": torch.zeros(c),
            "mean": torch.zeros(c), "var": torch.ones(c)}


def _max_pool_stem(x):
    # 3x3/2 max pool with padding 1 (torch stem; the pad is -inf).
    return F.max_pool2d(x, 3, 2, padding=1)


def init_resnet50_params(generator: torch.Generator | None = None, device=None):
    """He-normal convs and identity BatchNorms, drawn on the CPU from
    ``generator`` (seed 0 by default)."""
    from aip_tpu_torch.models.weights import ParamTree

    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    params = {"stem_conv": _init_conv(gen, 7, 7, 3, 64), "stem_bn": _init_bn(64), "stages": []}
    cin = 64
    for blocks, width, out in STAGES:
        stage = []
        for bi in range(blocks):
            block = {
                "conv1": _init_conv(gen, 1, 1, cin if bi == 0 else out, width),
                "bn1": _init_bn(width),
                "conv2": _init_conv(gen, 3, 3, width, width),
                "bn2": _init_bn(width),
                "conv3": _init_conv(gen, 1, 1, width, out),
                "bn3": _init_bn(out),
            }
            if bi == 0:
                block["down_conv"] = _init_conv(gen, 1, 1, cin, out)
                block["down_bn"] = _init_bn(out)
            stage.append(block)
        params["stages"].append(stage)
        cin = out
    return ParamTree(params).to(dev)


def from_jax_params(params, device=None):
    """``aip_tpu``'s ResNet-50 tree (HWIO convs) -> the port's ``ParamTree``."""
    from aip_tpu_torch.models.weights import tree_from_jax

    return tree_from_jax(params, device)


def resnet50_features(params, x01: torch.Tensor) -> dict:
    """ImageNet-normalized NHWC input -> {'layer1'..'layer4'} feature taps (NHWC)."""
    x = _conv(x01.permute(0, 3, 1, 2), params["stem_conv"], stride=2)
    x = _max_pool_stem(torch.relu(_bn(x, params["stem_bn"])))

    feats = {}
    for si, stage in enumerate(params["stages"]):
        stride = 1 if si == 0 else 2
        for bi, block in enumerate(stage):
            identity = x
            s = stride if bi == 0 else 1
            y = torch.relu(_bn(_conv(x, block["conv1"]), block["bn1"]))
            y = torch.relu(_bn(_conv(y, block["conv2"], stride=s), block["bn2"]))
            y = _bn(_conv(y, block["conv3"]), block["bn3"])
            if "down_conv" in block:
                identity = _bn(_conv(x, block["down_conv"], stride=s), block["down_bn"])
            x = torch.relu(y + identity)
        feats[f"layer{si + 1}"] = x.permute(0, 2, 3, 1)
    return feats


def _torch_conv(sd, prefix):
    return np.asarray(sd[f"{prefix}.weight"], np.float32)


def _torch_bn(sd, prefix):
    return {"gamma": np.asarray(sd[f"{prefix}.weight"], np.float32),
            "beta": np.asarray(sd[f"{prefix}.bias"], np.float32),
            "mean": np.asarray(sd[f"{prefix}.running_mean"], np.float32),
            "var": np.asarray(sd[f"{prefix}.running_var"], np.float32)}


def _convert_torch_resnet(sd: dict, device=None):
    """torchvision ``resnet50().state_dict()`` (numpy values) -> the port's tree."""
    from aip_tpu_torch.models.weights import ParamTree

    def conv(prefix):
        return {"w": _torch_conv(sd, prefix)}

    params = {"stem_conv": conv("conv1"), "stem_bn": _torch_bn(sd, "bn1"), "stages": []}
    for si, (blocks, _w, _o) in enumerate(STAGES):
        stage = []
        for bi in range(blocks):
            p = f"layer{si + 1}.{bi}"
            block = {
                "conv1": conv(f"{p}.conv1"), "bn1": _torch_bn(sd, f"{p}.bn1"),
                "conv2": conv(f"{p}.conv2"), "bn2": _torch_bn(sd, f"{p}.bn2"),
                "conv3": conv(f"{p}.conv3"), "bn3": _torch_bn(sd, f"{p}.bn3"),
            }
            if f"{p}.downsample.0.weight" in sd:
                block["down_conv"] = conv(f"{p}.downsample.0")
                block["down_bn"] = _torch_bn(sd, f"{p}.downsample.1")
            stage.append(block)
        params["stages"].append(stage)
    return ParamTree(params).to(resolve_device(device))


def get_resnet50_params(torch_path=None, device=None):
    from aip_tpu_torch.models import weights as weights_mod

    if torch_path is not None and weights_mod._is_real_checkpoint(Path(torch_path)):
        return _convert_torch_resnet(weights_mod._load_torch_state_dict(Path(torch_path)),
                                     device)
    return init_resnet50_params(device=device)
