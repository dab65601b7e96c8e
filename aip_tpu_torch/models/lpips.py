"""LPIPS perceptual distance (reference `lpipsPyTorch/` port).
Port of ``aip_tpu.models.lpips``.

Architecture parity with `lpipsPyTorch/modules/lpips.py` + `networks.py`:
normalize inputs by ImageNet-ish scaling vector, extract VGG16 (or AlexNet,
SqueezeNet-1.1) relu slices, unit-normalize each feature map along
channels, weight squared differences with the learned 1x1 "lin" layers,
average spatially, sum over layers.

The pretrained lin weights (richzhang GitHub, `modules/utils.py:11-30`)
cannot be fetched here; without them ``lpips`` falls back to uniform lin
weights — still a valid perceptual feature distance, just not calibrated to
human judgments. Provide the checkpoint (or the npz cache in the port's
weights directory, ``$AIP_TPU_WEIGHTS``) to get exact LPIPS.

Extractor parameters are ``weights.ParamTree`` nodes with the JAX package's
layout (VGG16 and AlexNet: a list of ``{"w": OIHW, "b"}``; SqueezeNet:
``{"stem", "fires"}``). Activations are NHWC at ``lpips``, NCHW inside; the
convs run under ``fp32_convs``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from aip_tpu_torch.device import fp32_convs, resolve_device

# VGG16 conv plan with relu tap points used by LPIPS (relu1_2, 2_2, 3_3,
# 4_3, 5_3), torchvision features indices for weight conversion.
VGG16_CONVS = (
    ("conv1_1", 3, 64, 0), ("conv1_2", 64, 64, 2), ("tap", "relu1_2"), ("pool",),
    ("conv2_1", 64, 128, 5), ("conv2_2", 128, 128, 7), ("tap", "relu2_2"), ("pool",),
    ("conv3_1", 128, 256, 10), ("conv3_2", 256, 256, 12), ("conv3_3", 256, 256, 14),
    ("tap", "relu3_3"), ("pool",),
    ("conv4_1", 256, 512, 17), ("conv4_2", 512, 512, 19), ("conv4_3", 512, 512, 21),
    ("tap", "relu4_3"), ("pool",),
    ("conv5_1", 512, 512, 24), ("conv5_2", 512, 512, 26), ("conv5_3", 512, 512, 28),
    ("tap", "relu5_3"),
)
LPIPS_CHANNELS = (64, 128, 256, 512, 512)

# LPIPS input scaling (richzhang's shift/scale constants).
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def conv_specs():
    return [l for l in VGG16_CONVS if l[0].startswith("conv")]


def init_vgg16_params(generator: torch.Generator | None = None, device=None):
    from aip_tpu_torch.models.vgg19_std import conv_list

    return conv_list([(cout, cin, 3, 3) for _, cin, cout, _ in conv_specs()], generator, device)


def from_jax_params(params, device=None):
    """An ``aip_tpu`` extractor's parameters (any of the three nets; HWIO
    convs) -> the port's tree on ``device``."""
    from aip_tpu_torch.models.weights import tree_from_jax

    return tree_from_jax(params if isinstance(params, dict) else list(params), device)


def get_vgg16_params(torch_path=None, device=None):
    from aip_tpu_torch.models import weights as weights_mod

    idxs = [f"features.{spec[3]}" for spec in conv_specs()]
    return weights_mod._get_params("vgg16_imagenet", torch_path, idxs, init_vgg16_params,
                                   device, build=from_jax_params)


def _conv(x, p, stride=1, pad=1):
    with fp32_convs():
        return F.conv2d(x, p["w"], p["b"], stride=stride, padding=pad)


def _extract(params, x):
    feats = []
    ci = 0
    for layer in VGG16_CONVS:
        kind = layer[0]
        if kind == "pool":
            x = F.max_pool2d(x, 2, 2, ceil_mode=True)
        elif kind == "tap":
            feats.append(x)
        else:
            x = torch.relu(_conv(x, params[ci]))
            ci += 1
    return feats


def _max_pool_3x3s2(x, ceil_mode=False):
    """torch MaxPool2d(3, 2) / (3, 2, ceil_mode=True) on NCHW. With
    ceil_mode the JAX package pads the right and bottom edges with -inf by
    (-(n - 3)) % 2, which is torch's ceil rule for a 3x3/2 window."""
    return F.max_pool2d(x, 3, 2, ceil_mode=ceil_mode)


# ---------------------------------------------------------------------------
# AlexNet extractor (lpipsPyTorch/modules/networks.py:49-60; torchvision
# alexnet features; taps relu1..relu5).
# ---------------------------------------------------------------------------

ALEX_CONVS = (
    # (name, cin, cout, kernel, stride, pad, torchvision features index)
    ("conv1", 3, 64, 11, 4, 2, 0),
    ("conv2", 64, 192, 5, 1, 2, 3),
    ("conv3", 192, 384, 3, 1, 1, 6),
    ("conv4", 384, 256, 3, 1, 1, 8),
    ("conv5", 256, 256, 3, 1, 1, 10),
)
ALEX_CHANNELS = (64, 192, 384, 256, 256)


def init_alexnet_params(generator: torch.Generator | None = None, device=None):
    from aip_tpu_torch.models.vgg19_std import conv_list

    return conv_list([(cout, cin, k, k) for _, cin, cout, k, _s, _p, _i in ALEX_CONVS],
                     generator, device)


def get_alexnet_params(torch_path=None, device=None):
    from aip_tpu_torch.models import weights as weights_mod

    idxs = [f"features.{spec[6]}" for spec in ALEX_CONVS]
    return weights_mod._get_params("alexnet_imagenet", torch_path, idxs, init_alexnet_params,
                                   device, build=from_jax_params)


def _extract_alex(params, x):
    feats = []
    for i, (_n, _ci, _co, _k, s, p, _ti) in enumerate(ALEX_CONVS):
        x = torch.relu(_conv(x, params[i], stride=s, pad=p))
        feats.append(x)
        if i in (0, 1):  # maxpool after relu1 / relu2
            x = _max_pool_3x3s2(x)
    return feats


# ---------------------------------------------------------------------------
# SqueezeNet-1.1 extractor (networks.py:12-47; 7 taps).
# ---------------------------------------------------------------------------

# Fire modules of squeezenet1_1 features: (features idx, squeeze, expand).
SQUEEZE_FIRES = (
    (3, 16, 64), (4, 16, 64),
    (6, 32, 128), (7, 32, 128),
    (9, 48, 192), (10, 48, 192), (11, 64, 256), (12, 64, 256),
)
SQUEEZE_CHANNELS = (64, 128, 256, 384, 384, 512, 512)
# Taps after features indices (relu1, fire2, fire4, fire6, fire7, fire8, fire9
# in lpips' slicing of squeezenet1_1).
_SQUEEZE_TAP_AFTER = (1, 4, 7, 9, 10, 11, 12)


def init_squeezenet_params(generator: torch.Generator | None = None, device=None):
    from aip_tpu_torch.models.weights import ParamTree, he_normal

    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)

    def lin(kh, cin, cout):
        return {"w": he_normal(gen, (cout, cin, kh, kh)), "b": torch.zeros(cout)}

    params = {"stem": lin(3, 3, 64)}
    cin = 64
    fires = []
    for _idx, sq, ex in SQUEEZE_FIRES:
        fires.append({"squeeze": lin(1, cin, sq), "e1": lin(1, sq, ex), "e3": lin(3, sq, ex)})
        cin = 2 * ex
    params["fires"] = fires
    return ParamTree(params).to(dev)


def get_squeezenet_params(torch_path=None, device=None):
    from aip_tpu_torch.models import weights as weights_mod

    dev = resolve_device(device)
    cache = weights_mod.DEFAULT_WEIGHTS_DIR / "squeezenet_fires.npz"
    if cache.is_file():
        with np.load(cache) as d:
            params = {"stem": {"w": d["stem_w"], "b": d["stem_b"]}, "fires": [
                {k: {"w": d[f"f{i}_{k}_w"], "b": d[f"f{i}_{k}_b"]}
                 for k in ("squeeze", "e1", "e3")}
                for i in range(len(SQUEEZE_FIRES))]}
        return from_jax_params(params, dev)
    if torch_path is not None and weights_mod._is_real_checkpoint(Path(torch_path)):
        return _convert_torch_squeezenet(weights_mod._load_torch_state_dict(Path(torch_path)),
                                         dev)
    return init_squeezenet_params(device=dev)


def _convert_torch_squeezenet(sd: dict, device=None):
    """torchvision ``squeezenet1_1().state_dict()`` (numpy values) -> the
    port's tree."""
    from aip_tpu_torch.models.weights import ParamTree

    def conv(stem):
        return {"w": np.asarray(sd[f"{stem}.weight"], np.float32),
                "b": np.asarray(sd[f"{stem}.bias"], np.float32)}

    params = {"stem": conv("features.0"), "fires": []}
    for idx, _sq, _ex in SQUEEZE_FIRES:
        params["fires"].append({
            "squeeze": conv(f"features.{idx}.squeeze"),
            "e1": conv(f"features.{idx}.expand1x1"),
            "e3": conv(f"features.{idx}.expand3x3"),
        })
    return ParamTree(params).to(resolve_device(device))


def _extract_squeeze(params, x):
    feats = []
    x = torch.relu(_conv(x, params["stem"], stride=2, pad=0))
    feats.append(x)  # after features.1
    fi = 0
    for fidx in range(2, 13):
        if fidx in (2, 5, 8):
            x = _max_pool_3x3s2(x, ceil_mode=True)
            continue
        f = params["fires"][fi]
        fi += 1
        s = torch.relu(_conv(x, f["squeeze"], pad=0))
        x = torch.cat([torch.relu(_conv(s, f["e1"], pad=0)),
                       torch.relu(_conv(s, f["e3"], pad=1))], dim=1)
        if fidx in _SQUEEZE_TAP_AFTER:
            feats.append(x)
    return feats


_EXTRACTORS = {"vgg": _extract, "alex": _extract_alex, "squeeze": _extract_squeeze}
NET_CHANNELS = {"vgg": LPIPS_CHANNELS, "alex": ALEX_CHANNELS,
                "squeeze": SQUEEZE_CHANNELS}


def lpips(img1: torch.Tensor, img2: torch.Tensor, vgg_params, lin_weights=None,
          net: str = "vgg") -> torch.Tensor:
    """Perceptual distance between NHWC images in [0, 1]. Returns [N].

    ``net`` selects the feature extractor ('vgg' | 'alex' | 'squeeze' —
    the three backbones of `lpipsPyTorch/modules/networks.py:12-96`);
    ``vgg_params`` holds that extractor's parameters, ``lin_weights`` a
    list of [C] tensors (one per tap) or None (the uniform mean).
    """
    shift = torch.tensor(_SHIFT, dtype=torch.float32, device=img1.device)
    scale = torch.tensor(_SCALE, dtype=torch.float32, device=img1.device)

    def norm_input(x):
        return ((x * 2.0 - 1.0 - shift) / scale).permute(0, 3, 1, 2)

    extract = _EXTRACTORS[net]
    f1 = extract(vgg_params, norm_input(img1))
    f2 = extract(vgg_params, norm_input(img2))
    total = 0.0
    for li, (a, b) in enumerate(zip(f1, f2)):
        a = a / torch.clamp(torch.linalg.vector_norm(a, dim=1, keepdim=True), min=1e-10)
        b = b / torch.clamp(torch.linalg.vector_norm(b, dim=1, keepdim=True), min=1e-10)
        d = (a - b) ** 2
        if lin_weights is not None:
            d = d * lin_weights[li][None, :, None, None]
            total = total + torch.sum(torch.mean(d, dim=(2, 3)), dim=-1)
        else:
            total = total + torch.mean(d, dim=(1, 2, 3))
    return total


def get_extractor_params(net: str = "vgg", torch_path=None, device=None):
    """Parameters for an lpips(net=...) call."""
    if net == "vgg":
        return get_vgg16_params(torch_path, device)
    if net == "alex":
        return get_alexnet_params(torch_path, device)
    if net == "squeeze":
        return get_squeezenet_params(torch_path, device)
    raise ValueError(f"unknown LPIPS net {net!r}")


def get_lin_weights(net: str = "vgg", torch_path=None, device=None):
    """Learned per-channel "lin" weights (richzhang checkpoints,
    `lpipsPyTorch/modules/utils.py:11-30`), or None when unavailable.

    Returns a list of [C] tensors on ``device`` converted from the torch
    state_dict keys ``lin{i}.model.1.weight`` of shape [1, C, 1, 1], cached
    as ``lpips_lin_<net>.npz`` in the port's weights directory. A None
    return means `lpips()` falls back to the UNIFORM per-channel mean —
    scores are self-consistent but NOT comparable to published LPIPS values;
    callers should surface that (see gs/metrics_cli.py `lpips_weights`).
    """
    from aip_tpu_torch.models import weights as weights_mod

    dev = resolve_device(device)
    cache = weights_mod.DEFAULT_WEIGHTS_DIR / f"lpips_lin_{net}.npz"
    if cache.is_file():
        with np.load(cache) as d:
            lins = [d[f"l{i}"] for i in range(len(d.files))]
        return [torch.from_numpy(np.asarray(w, np.float32)).to(dev) for w in lins]
    if torch_path is not None and weights_mod._is_real_checkpoint(Path(torch_path)):
        sd = weights_mod._load_torch_state_dict(Path(torch_path))
        lins = []
        for i in range(len(NET_CHANNELS[net])):
            key = next(k for k in (f"lin{i}.model.1.weight", f"lin.{i}.model.1.weight")
                       if k in sd)
            lins.append(np.asarray(sd[key], np.float32).reshape(-1))
        cache.parent.mkdir(parents=True, exist_ok=True)
        np.savez(cache, **{f"l{i}": w for i, w in enumerate(lins)})
        return [torch.from_numpy(w).to(dev) for w in lins]
    return None
