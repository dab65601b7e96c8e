"""Standard (torchvision-layout) VGG-19 feature extractor for optimization NST.
Port of ``aip_tpu.models.vgg19_std``.

The reference's optimization-NST pipelines use torchvision's ImageNet VGG-19
``features`` stack with taps at conv outputs — `spatial_variation/
StyleTransfer.py:20-29` (indices 0/5/10/19/21/28 = conv1_1, conv2_1, conv3_1,
conv4_1, conv4_2, conv5_1, captured pre-ReLU) and `mixing_texture_gyum/
vgg_model.py` (same taps minus conv4_2). Unlike the AdaIN "normalised" VGG
(``aip_tpu_torch.models.vgg``), this uses zero padding and expects
ImageNet-normalized inputs. ``normalize_imagenet`` and
``denormalize_imagenet`` are shared with the other ImageNet backbones
(DeepLab, ResNet).

Parameters are a list of ``{"w": OIHW, "b": [C]}`` (``weights.ParamTree``
nodes); weights convert from a torchvision state_dict when available,
deterministic random init otherwise. The convs run under ``fp32_convs``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from aip_tpu_torch.device import fp32_convs, resolve_device

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# (name, in_ch, out_ch, torchvision_features_index); pools implied after
# each block.
VGG19_CONVS = (
    ("conv1_1", 3, 64, 0),
    ("conv1_2", 64, 64, 2),
    ("pool", None, None, None),
    ("conv2_1", 64, 128, 5),
    ("conv2_2", 128, 128, 7),
    ("pool", None, None, None),
    ("conv3_1", 128, 256, 10),
    ("conv3_2", 256, 256, 12),
    ("conv3_3", 256, 256, 14),
    ("conv3_4", 256, 256, 16),
    ("pool", None, None, None),
    ("conv4_1", 256, 512, 19),
    ("conv4_2", 512, 512, 21),
    ("conv4_3", 512, 512, 23),
    ("conv4_4", 512, 512, 25),
    ("pool", None, None, None),
    ("conv5_1", 512, 512, 28),
)

NST_STYLE_LAYERS = ("conv1_1", "conv2_1", "conv3_1", "conv4_1", "conv5_1")
NST_CONTENT_LAYER = "conv4_2"


def conv_specs():
    return [l for l in VGG19_CONVS if l[0] != "pool"]


def conv_list(shapes, generator: torch.Generator | None = None, device=None) -> nn.ModuleList:
    """He-normal OIHW convs of ``shapes`` ((cout, cin, kh, kw)) with zero
    biases, drawn on the CPU from ``generator`` (seed 0 by default), as a
    list of ``{"w", "b"}`` nodes on ``device``."""
    from aip_tpu_torch.models.weights import he_normal, tree_module

    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    convs = [{"w": he_normal(gen, s), "b": torch.zeros(s[0])} for s in shapes]
    return tree_module(convs).to(dev)


def init_vgg19_params(generator: torch.Generator | None = None, device=None) -> nn.ModuleList:
    return conv_list([(cout, cin, 3, 3) for _, cin, cout, _ in conv_specs()], generator, device)


def from_jax_params(params, device=None) -> nn.ModuleList:
    """``aip_tpu``'s list of ``{"w": HWIO, "b"}`` -> the port's list."""
    from aip_tpu_torch.models.weights import tree_from_jax

    return tree_from_jax(list(params), device)


def normalize_imagenet(img01: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=img01.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=img01.device)
    return (img01 - mean) / std


def denormalize_imagenet(x: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    return torch.clamp(x * std + mean, 0.0, 1.0)


def extract_features(params, x: torch.Tensor, taps, compute_dtype=torch.float32):
    """x: ImageNet-normalized NHWC. Returns {tap: pre-ReLU conv output} (NHWC).

    Matches the reference's capture points (pre-ReLU, StyleTransfer.py:31-37).
    """
    taps = set(taps)
    out = {}
    ci = 0
    t = x.permute(0, 3, 1, 2)
    with fp32_convs():
        for layer in VGG19_CONVS:
            name = layer[0]
            if name == "pool":
                t = F.max_pool2d(t, 2, 2, ceil_mode=True)
                continue
            p = params[ci]
            ci += 1
            t = F.conv2d(t.to(compute_dtype), p["w"].to(compute_dtype),
                         p["b"].to(compute_dtype), padding=1)
            if name in taps:
                out[name] = t.permute(0, 2, 3, 1)
                if len(out) == len(taps):
                    return out
            t = torch.relu(t)
    return out


def get_vgg19_params(torch_path=None, device=None) -> nn.ModuleList:
    """Pretrained torchvision weights if provided, else deterministic init."""
    from aip_tpu_torch.models import weights as weights_mod

    # torchvision checkpoints key convs as 'features.<idx>.weight'.
    idxs = [f"features.{spec[3]}" for spec in conv_specs()]
    return weights_mod._get_params("vgg19_imagenet", torch_path, idxs, init_vgg19_params,
                                   device, build=from_jax_params)
