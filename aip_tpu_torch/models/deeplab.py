"""DeepLabV3-ResNet101 semantic segmentation (torchvision layout).
Port of ``aip_tpu.models.deeplab``.

The reference extracts the regional-style-transfer background mask with
pretrained torchvision ``deeplabv3_resnet101`` (P(class 0) > 0.5,
`localized_style_transfer.py:171-188`). This module provides the full
architecture — dilated ResNet-101 backbone (output stride 8) + ASPP head —
with a torchvision state_dict converter, so supplying the checkpoint enables
exact parity; ``models.segmenter``'s classical fallback covers the
weightless case.

Parameters are a ``weights.ParamTree`` with the JAX package's keys (conv
weights OIHW). The forward reads its depth from them: a stage is as deep as
its list of blocks. Every conv runs under ``fp32_convs``: PyTorch's default
runs cuDNN's fp32 convs in TF32, which a 100-layer fp32 net would carry
into its logits. The state dict is read with the port's own loader; no
torchvision import.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from aip_tpu_torch.device import fp32_convs, resolve_device
from aip_tpu_torch.models.resnet import (_bn, _init_bn, _max_pool_stem, _torch_bn,
                                         _torch_conv)

# ResNet-101 stages; layer3/layer4 are dilated (stride 1) for output_stride 8.
# (blocks, width, out, first-block stride, dilation, first-block dilation):
# torchvision's _make_layer gives the FIRST block of a dilated stage the
# PREVIOUS stage's dilation (`previous_dilation` in
# torchvision/models/resnet.py) — layer3 block 0 runs at dilation 1 and
# layer4 block 0 at dilation 2, only the remaining blocks use the stage
# dilation.
STAGES = ((3, 64, 256, 1, 1, 1), (4, 128, 512, 2, 1, 1),
          (23, 256, 1024, 1, 2, 1), (3, 512, 2048, 1, 4, 2))
ASPP_RATES = (12, 24, 36)
NUM_CLASSES = 21


def _conv(x, w, stride=1, dilation=1):
    k = w.shape[-1]
    pad = dilation * (k - 1) // 2
    with fp32_convs():
        return F.conv2d(x, w, stride=stride, padding=pad, dilation=dilation)


def _init_w(gen, kh, kw, cin, cout):
    from aip_tpu_torch.models.weights import he_normal

    return he_normal(gen, (cout, cin, kh, kw))


def init_deeplab_params(generator: torch.Generator | None = None, device=None):
    """He-normal convs and identity BatchNorms, drawn on the CPU from
    ``generator`` (seed 0 by default)."""
    from aip_tpu_torch.models.weights import ParamTree

    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    params = {"stem_w": _init_w(gen, 7, 7, 3, 64), "stem_bn": _init_bn(64), "stages": []}
    cin = 64
    for blocks, width, out, _stride, _dil, _fdil in STAGES:
        stage = []
        for bi in range(blocks):
            block = {
                "conv1_w": _init_w(gen, 1, 1, cin if bi == 0 else out, width),
                "bn1": _init_bn(width),
                "conv2_w": _init_w(gen, 3, 3, width, width),
                "bn2": _init_bn(width),
                "conv3_w": _init_w(gen, 1, 1, width, out),
                "bn3": _init_bn(out),
            }
            if bi == 0:
                block["down_w"] = _init_w(gen, 1, 1, cin, out)
                block["down_bn"] = _init_bn(out)
            stage.append(block)
        params["stages"].append(stage)
        cin = out
    # ASPP: 1x1 + three dilated 3x3 + image pooling, project, classifier.
    aspp = {"convs": [_init_w(gen, 1, 1, 2048, 256)], "bns": [_init_bn(256)]}
    for _r in ASPP_RATES:
        aspp["convs"].append(_init_w(gen, 3, 3, 2048, 256))
        aspp["bns"].append(_init_bn(256))
    aspp["pool_w"] = _init_w(gen, 1, 1, 2048, 256)
    aspp["pool_bn"] = _init_bn(256)
    aspp["project_w"] = _init_w(gen, 1, 1, 5 * 256, 256)
    aspp["project_bn"] = _init_bn(256)
    params["aspp"] = aspp
    params["head_w"] = _init_w(gen, 3, 3, 256, 256)
    params["head_bn"] = _init_bn(256)
    params["cls_w"] = _init_w(gen, 1, 1, 256, NUM_CLASSES)
    params["cls_b"] = torch.zeros(NUM_CLASSES)
    return ParamTree(params).to(dev)


def from_jax_params(params, device=None):
    """``aip_tpu``'s DeepLab tree (HWIO convs; any number of blocks a stage)
    -> the port's ``ParamTree``."""
    from aip_tpu_torch.models.weights import tree_from_jax

    return tree_from_jax(params, device)


def deeplab_logits(params, x01: torch.Tensor) -> torch.Tensor:
    """ImageNet-normalized NHWC -> [N, H, W, 21] logits (bilinear-upsampled
    to input resolution, torchvision semantics)."""
    from aip_tpu_torch.ops.image import resize_bilinear

    n, h, w, _ = x01.shape
    x = _conv(x01.permute(0, 3, 1, 2), params["stem_w"], stride=2)
    x = _max_pool_stem(torch.relu(_bn(x, params["stem_bn"])))

    for (_blocks, _wd, _out, stride, dilation, first_dil), stage in zip(
            STAGES, params["stages"]):
        for bi, block in enumerate(stage):
            s = stride if bi == 0 else 1
            dil = first_dil if bi == 0 else dilation
            identity = x
            y = torch.relu(_bn(_conv(x, block["conv1_w"]), block["bn1"]))
            y = torch.relu(_bn(_conv(y, block["conv2_w"], stride=s, dilation=dil),
                               block["bn2"]))
            y = _bn(_conv(y, block["conv3_w"]), block["bn3"])
            if "down_w" in block:
                identity = _bn(_conv(x, block["down_w"], stride=s), block["down_bn"])
            x = torch.relu(y + identity)

    # ASPP.
    a = params["aspp"]
    branches = [torch.relu(_bn(_conv(x, a["convs"][0]), a["bns"][0]))]
    for conv_w, bn, rate in zip(a["convs"][1:], a["bns"][1:], ASPP_RATES):
        branches.append(torch.relu(_bn(_conv(x, conv_w, dilation=rate), bn)))
    pooled = torch.mean(x, dim=(2, 3), keepdim=True)
    pooled = torch.relu(_bn(_conv(pooled, a["pool_w"]), a["pool_bn"]))
    pooled = pooled.expand_as(branches[0])
    y = torch.cat(branches + [pooled], dim=1)
    y = torch.relu(_bn(_conv(y, a["project_w"]), a["project_bn"]))
    y = torch.relu(_bn(_conv(y, params["head_w"]), params["head_bn"]))
    logits = _conv(y, params["cls_w"]) + params["cls_b"][:, None, None]
    return resize_bilinear(logits.permute(0, 2, 3, 1), (h, w))


def make_background_segmenter(params, threshold: float = 0.5):
    """Returns fn(img_hwc_float01) -> [H, W] uint8 background mask on the
    parameters' device, matching extract_foreground_deeplab semantics
    (P(class 0) > threshold)."""
    from aip_tpu_torch.models.vgg19_std import normalize_imagenet

    dev = next(params.parameters()).device

    @torch.no_grad()
    def seg(img):
        x = torch.as_tensor(np.asarray(img, np.float32) if not isinstance(img, torch.Tensor)
                            else img, dtype=torch.float32, device=dev)
        logits = deeplab_logits(params, normalize_imagenet(x)[None])[0]
        probs = torch.softmax(logits, dim=-1)
        return (probs[..., 0] > threshold).to(torch.uint8)

    return seg


def _convert_torch_deeplab(sd: dict, device=None):
    """torchvision ``deeplabv3_resnet101().state_dict()`` (numpy values) ->
    the port's tree. ``aux_classifier.*`` is ignored."""
    from aip_tpu_torch.models.weights import ParamTree

    def w(prefix):
        return _torch_conv(sd, prefix)

    b = "backbone"
    params = {"stem_w": w(f"{b}.conv1"), "stem_bn": _torch_bn(sd, f"{b}.bn1"), "stages": []}
    for si, (blocks, *_rest) in enumerate(STAGES):
        stage = []
        for bi in range(blocks):
            p = f"{b}.layer{si + 1}.{bi}"
            block = {"conv1_w": w(f"{p}.conv1"), "bn1": _torch_bn(sd, f"{p}.bn1"),
                     "conv2_w": w(f"{p}.conv2"), "bn2": _torch_bn(sd, f"{p}.bn2"),
                     "conv3_w": w(f"{p}.conv3"), "bn3": _torch_bn(sd, f"{p}.bn3")}
            if f"{p}.downsample.0.weight" in sd:
                block["down_w"] = w(f"{p}.downsample.0")
                block["down_bn"] = _torch_bn(sd, f"{p}.downsample.1")
            stage.append(block)
        params["stages"].append(stage)
    c = "classifier"
    aspp = {"convs": [], "bns": []}
    for i in range(4):  # 0: 1x1, 1..3: dilated convs
        aspp["convs"].append(w(f"{c}.0.convs.{i}.0"))
        aspp["bns"].append(_torch_bn(sd, f"{c}.0.convs.{i}.1"))
    aspp["pool_w"] = w(f"{c}.0.convs.4.1")
    aspp["pool_bn"] = _torch_bn(sd, f"{c}.0.convs.4.2")
    aspp["project_w"] = w(f"{c}.0.project.0")
    aspp["project_bn"] = _torch_bn(sd, f"{c}.0.project.1")
    params["aspp"] = aspp
    params["head_w"] = w(f"{c}.1")
    params["head_bn"] = _torch_bn(sd, f"{c}.2")
    params["cls_w"] = w(f"{c}.4")
    params["cls_b"] = np.asarray(sd[f"{c}.4.bias"], np.float32)
    return ParamTree(params).to(resolve_device(device))


def get_deeplab_params(torch_path=None, device=None):
    """The torchvision checkpoint at ``torch_path`` if it is a real one, else
    the deterministic init (seed 0)."""
    from aip_tpu_torch.models import weights as weights_mod

    if torch_path is not None and weights_mod._is_real_checkpoint(Path(torch_path)):
        return _convert_torch_deeplab(weights_mod._load_torch_state_dict(Path(torch_path)),
                                      device)
    return init_deeplab_params(device=device)
