"""DenseNet-121 feature extractor (torchvision layout) for multi-backbone NST.
Port of ``aip_tpu.models.densenet``.

Parity with reference `gui/seven_page.py:150-186` DenseNetFeatureExtractor:
stem (conv7x7/2 + BN + ReLU + maxpool3x3/2), dense blocks [6, 12, 24, 16]
with growth 32 and bottleneck width 4x, taps after denseblock1..3 (layer1..3)
and norm5-terminated denseblock4 as layer4. Inference-only BN.

Parameters are a ``weights.ParamTree`` with the JAX package's keys (conv
weights OIHW). The forward reads its depth from them: a block is as long as
its list of layers. Activations are NHWC at the public function, NCHW
inside; every conv runs under ``fp32_convs``. The torchvision state dict is
read with the port's own loader; no torchvision import.
"""

from __future__ import annotations

from pathlib import Path

import torch
import torch.nn.functional as F

from aip_tpu_torch.device import fp32_convs, resolve_device
from aip_tpu_torch.models.resnet import _bn, _init_bn, _max_pool_stem, _torch_bn, _torch_conv

BLOCK_CONFIG = (6, 12, 24, 16)
GROWTH = 32
INIT_FEATURES = 64


def _conv(x, w, stride=1):
    # Symmetric torch padding ((k-1)//2 each side), as torchvision pads.
    k = w.shape[-1]
    with fp32_convs():
        return F.conv2d(x, w, stride=stride, padding=(k - 1) // 2)


def _init_w(gen, kh, kw, cin, cout):
    from aip_tpu_torch.models.weights import he_normal

    return he_normal(gen, (cout, cin, kh, kw))


def init_densenet121_params(generator: torch.Generator | None = None, device=None):
    """He-normal convs and identity BatchNorms, drawn on the CPU from
    ``generator`` (seed 0 by default)."""
    from aip_tpu_torch.models.weights import ParamTree

    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    params = {"stem_w": _init_w(gen, 7, 7, 3, INIT_FEATURES),
              "stem_bn": _init_bn(INIT_FEATURES), "blocks": [], "transitions": []}
    c = INIT_FEATURES
    for bi, n_layers in enumerate(BLOCK_CONFIG):
        block = []
        for li in range(n_layers):
            cin = c + li * GROWTH
            block.append({"bn1": _init_bn(cin), "w1": _init_w(gen, 1, 1, cin, 4 * GROWTH),
                          "bn2": _init_bn(4 * GROWTH),
                          "w2": _init_w(gen, 3, 3, 4 * GROWTH, GROWTH)})
        params["blocks"].append(block)
        c = c + n_layers * GROWTH
        if bi < 3:
            params["transitions"].append({"bn": _init_bn(c), "w": _init_w(gen, 1, 1, c, c // 2)})
            c = c // 2
    params["norm5"] = _init_bn(c)
    return ParamTree(params).to(dev)


def from_jax_params(params, device=None):
    """``aip_tpu``'s DenseNet tree (HWIO convs; any number of layers a
    block) -> the port's ``ParamTree``."""
    from aip_tpu_torch.models.weights import tree_from_jax

    return tree_from_jax(params, device)


def _dense_block(x, block):
    for layer in block:
        y = _conv(torch.relu(_bn(x, layer["bn1"])), layer["w1"])
        y = _conv(torch.relu(_bn(y, layer["bn2"])), layer["w2"])
        x = torch.cat([x, y], dim=1)
    return x


def densenet121_features(params, x01: torch.Tensor) -> dict:
    """ImageNet-normalized NHWC -> {'layer1'..'layer4'} taps (NHWC)
    (seven_page.py:160-186 tap points)."""
    x = _conv(x01.permute(0, 3, 1, 2), params["stem_w"], stride=2)
    x = _max_pool_stem(torch.relu(_bn(x, params["stem_bn"])))
    feats = {}
    for bi, block in enumerate(params["blocks"]):
        x = _dense_block(x, block)
        if bi < 3:
            feats[f"layer{bi + 1}"] = x.permute(0, 2, 3, 1)
            t = params["transitions"][bi]
            x = F.avg_pool2d(_conv(torch.relu(_bn(x, t["bn"])), t["w"]), 2, 2)
    feats["layer4"] = _bn(x, params["norm5"]).permute(0, 2, 3, 1)
    return feats


def _convert_torch_densenet(sd: dict, device=None):
    """torchvision ``densenet121().state_dict()`` (numpy values) -> the
    port's tree. ``classifier.*`` is ignored."""
    from aip_tpu_torch.models.weights import ParamTree

    params = {"stem_w": _torch_conv(sd, "features.conv0"),
              "stem_bn": _torch_bn(sd, "features.norm0"), "blocks": [], "transitions": []}
    for bi, n_layers in enumerate(BLOCK_CONFIG):
        block = []
        for li in range(n_layers):
            p = f"features.denseblock{bi + 1}.denselayer{li + 1}"
            block.append({"bn1": _torch_bn(sd, f"{p}.norm1"), "w1": _torch_conv(sd, f"{p}.conv1"),
                          "bn2": _torch_bn(sd, f"{p}.norm2"), "w2": _torch_conv(sd, f"{p}.conv2")})
        params["blocks"].append(block)
        if bi < 3:
            t = f"features.transition{bi + 1}"
            params["transitions"].append({"bn": _torch_bn(sd, f"{t}.norm"),
                                          "w": _torch_conv(sd, f"{t}.conv")})
    params["norm5"] = _torch_bn(sd, "features.norm5")
    return ParamTree(params).to(resolve_device(device))


def get_densenet121_params(torch_path=None, device=None):
    from aip_tpu_torch.models import weights as weights_mod

    if torch_path is not None and weights_mod._is_real_checkpoint(Path(torch_path)):
        return _convert_torch_densenet(weights_mod._load_torch_state_dict(Path(torch_path)),
                                       device)
    return init_densenet121_params(device=device)
