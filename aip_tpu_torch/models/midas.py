"""MiDaS-small monocular depth estimation (torch-hub ``MiDaS_small``). Port
of ``aip_tpu.models.midas``.

The reference's depth-aware stylization calls torch.hub MiDaS_small
(``AdaIN/test.py:84-116``). ``MidasNet`` is the full ``MidasNet_small``
architecture: an EfficientNet-Lite3 encoder (timm ``tf_efficientnet_lite3``:
MBConv stages, TF-SAME padding on the stride-2 convs, depthwise convs, BN
with eps 1e-3, ReLU6, taps after stages 1/2/4/6) and the expand-mode
feature-fusion decoder (scratch projections to 64/128/256/512, residual
conv units, halving 1x1 out-convs, ``align_corners=True`` 2x upsampling)
with the output head. Its parameter and buffer names are the hub's
``MidasNet_small`` keys, so a hub ``midas_v21_small_256.pt`` state dict
loads with ``load_state_dict(strict=True)``.

Without a checkpoint the weights come from ``init_midas_params``, a seeded
init drawn from a ``torch.Generator`` with the JAX package's distributions
(other numbers than its ``PRNGKey(0)``; ``from_jax_params`` carries the JAX
tree across). Input ``[N, H, W, 3]`` in [0, 1], H and W multiples of 32
(the estimator resizes to 256^2); output ``[N, H, W]`` inverse depth
(proximity, larger = closer). Convs run under ``device.fp32_convs``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from aip_tpu_torch.device import fp32_convs, resolve_device
from aip_tpu_torch.utils.profiling import count

# EfficientNet-Lite3 (width 1.2, depth 1.4): per-stage
# (expand, channels, repeats, stride, kernel).
_STAGES = (
    (1, 24, 1, 1, 3),
    (6, 32, 3, 2, 3),
    (6, 48, 3, 2, 5),
    (6, 96, 5, 2, 3),
    (6, 136, 5, 1, 5),
    (6, 232, 6, 2, 5),
    (6, 384, 1, 1, 3),
)
_STEM = 32
# MidasNet_small's taps (midas/blocks.py _make_efficientnet_backbone):
# layer1 = stem + blocks[0:2], layer2 = blocks[2:3], layer3 = blocks[3:5],
# layer4 = blocks[5:9]: 32 / 48 / 136 / 384 channels at strides 4/8/16/32.
_TAP_CHANNELS = (32, 48, 136, 384)
# Decoder widths with blocks={'expand': True}: features1..4 = 64/128/256/512.
_FEATURES = (64, 128, 256, 512)
_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)
WORK_SIZE = 256  # the hub's small_transform working size


def _conv(x, w, stride=1, groups=1, bias=None):
    """Conv of NCHW x with torch-symmetric padding (stride 1, odd k) or
    TF-SAME padding (stride 2, timm ``Conv2dSame``; H and W are even here,
    so the total k - stride splits low then high)."""
    k = w.shape[-1]
    if stride == 1:
        p = (k - 1) // 2
        pads = (p, p, p, p)
    else:
        total = max(k - stride, 0)
        lo, hi = total // 2, total - total // 2
        pads = (lo, hi, lo, hi)
    return F.conv2d(F.pad(x, pads), w, bias, stride=stride, groups=groups)


def _bn(x, bn: nn.BatchNorm2d):
    """Inference batch norm with the running statistics, whatever the mode."""
    return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias, False, 0.0,
                        bn.eps)


def _conv_module(cin, cout, k, groups=1, bias=False):
    return nn.Conv2d(cin, cout, k, groups=groups, bias=bias)


def _bn_module(c):
    return nn.BatchNorm2d(c, eps=1e-3)


class _DepthwiseSeparable(nn.Module):
    """timm DepthwiseSeparableConv (expand ratio 1): conv_dw/bn1, conv_pw/bn2."""

    def __init__(self, cin, cout, k, stride):
        super().__init__()
        self.stride = stride
        self.conv_dw = _conv_module(cin, cin, k, groups=cin)
        self.bn1 = _bn_module(cin)
        self.conv_pw = _conv_module(cin, cout, 1)
        self.bn2 = _bn_module(cout)

    def forward(self, x):
        y = F.relu6(_bn(_conv(x, self.conv_dw.weight, self.stride, x.shape[1]), self.bn1))
        return _bn(_conv(y, self.conv_pw.weight), self.bn2)


class _InvertedResidual(nn.Module):
    """timm InvertedResidual: conv_pw/bn1 (expansion), conv_dw/bn2,
    conv_pwl/bn3 (linear projection)."""

    def __init__(self, cin, cout, k, stride, expand):
        super().__init__()
        mid = cin * expand
        self.stride = stride
        self.conv_pw = _conv_module(cin, mid, 1)
        self.bn1 = _bn_module(mid)
        self.conv_dw = _conv_module(mid, mid, k, groups=mid)
        self.bn2 = _bn_module(mid)
        self.conv_pwl = _conv_module(mid, cout, 1)
        self.bn3 = _bn_module(cout)

    def forward(self, x):
        y = F.relu6(_bn(_conv(x, self.conv_pw.weight), self.bn1))
        y = F.relu6(_bn(_conv(y, self.conv_dw.weight, self.stride, y.shape[1]), self.bn2))
        return _bn(_conv(y, self.conv_pwl.weight), self.bn3)


class _Stage(nn.Sequential):
    """One EfficientNet stage; blocks after the first add their input."""

    def forward(self, x):
        for r, block in enumerate(self):
            y = block(x)
            x = x + y if r > 0 else y
        return x


class _ResidualConvUnit(nn.Module):
    """ResidualConvUnit_custom: relu -> conv -> relu -> conv -> + x."""

    def __init__(self, feat):
        super().__init__()
        self.conv1 = _conv_module(feat, feat, 3, bias=True)
        self.conv2 = _conv_module(feat, feat, 3, bias=True)

    def forward(self, x):
        y = _conv(torch.relu(x), self.conv1.weight, bias=self.conv1.bias)
        y = _conv(torch.relu(y), self.conv2.weight, bias=self.conv2.bias)
        return x + y


class _FeatureFusion(nn.Module):
    """FeatureFusionBlock_custom: (+ resConfUnit1(skip)), resConfUnit2,
    2x bilinear (align_corners=True), 1x1 out conv."""

    def __init__(self, feat, expand):
        super().__init__()
        self.out_conv = _conv_module(feat, feat // 2 if expand else feat, 1, bias=True)
        self.resConfUnit1 = _ResidualConvUnit(feat)
        self.resConfUnit2 = _ResidualConvUnit(feat)

    def forward(self, y, skip=None):
        if skip is not None:
            y = y + self.resConfUnit1(skip)
        y = self.resConfUnit2(y)
        y = F.interpolate(y, scale_factor=2, mode="bilinear", align_corners=True)
        return _conv(y, self.out_conv.weight, bias=self.out_conv.bias)


class MidasNet(nn.Module):
    """Hub ``MidasNet_small(features=64, backbone="efficientnet_lite3",
    blocks={'expand': True})`` with the hub's key layout; ``forward`` takes
    NHWC in [0, 1] and returns [N, H, W] inverse depth. Weights are whatever
    the constructor drew until filled: use ``init_midas_params``,
    ``from_jax_params`` or ``load_state_dict``."""

    def __init__(self):
        super().__init__()
        stages, cin = [], _STEM
        for expand, cout, repeats, stride, k in _STAGES:
            blocks = []
            for r in range(repeats):
                s = stride if r == 0 else 1
                blocks.append(_DepthwiseSeparable(cin, cout, k, s) if expand == 1
                              else _InvertedResidual(cin, cout, k, s, expand))
                cin = cout
            stages.append(_Stage(*blocks))
        self.pretrained = nn.Module()
        self.pretrained.layer1 = nn.Sequential(
            _conv_module(3, _STEM, 3), _bn_module(_STEM), nn.ReLU6(), stages[0], stages[1])
        self.pretrained.layer2 = nn.Sequential(stages[2])
        self.pretrained.layer3 = nn.Sequential(stages[3], stages[4])
        self.pretrained.layer4 = nn.Sequential(stages[5], stages[6])

        self.scratch = nn.Module()
        for i, (c, f) in enumerate(zip(_TAP_CHANNELS, _FEATURES)):
            setattr(self.scratch, f"layer{i + 1}_rn", _conv_module(c, f, 3))
        for i, f in enumerate(_FEATURES):
            setattr(self.scratch, f"refinenet{i + 1}", _FeatureFusion(f, expand=i > 0))
        # Hub indices: 0 conv 64->32, 1 Interpolate(x2), 2 conv 32->32, 3
        # ReLU, 4 conv 32->1, 5 ReLU, 6 Identity.
        self.scratch.output_conv = nn.Sequential(
            _conv_module(64, 32, 3, bias=True), nn.Identity(), _conv_module(32, 32, 3, bias=True),
            nn.ReLU(), _conv_module(32, 1, 1, bias=True), nn.ReLU(), nn.Identity())
        self.eval()

    def _taps(self, x):
        l1 = self.pretrained.layer1
        x = F.relu6(_bn(_conv(x, l1[0].weight, stride=2), l1[1]))  # the stem
        taps = []
        for layer in (l1[3:], self.pretrained.layer2, self.pretrained.layer3,
                      self.pretrained.layer4):
            for stage in layer:
                x = stage(x)
            taps.append(x)
        return taps

    def forward(self, x01: torch.Tensor) -> torch.Tensor:
        mean = torch.tensor(_MEAN, dtype=x01.dtype, device=x01.device)
        std = torch.tensor(_STD, dtype=x01.dtype, device=x01.device)
        x = ((x01 - mean) / std).permute(0, 3, 1, 2)
        sc = self.scratch
        with fp32_convs():
            taps = self._taps(x)
            rn = [_conv(t, getattr(sc, f"layer{i + 1}_rn").weight) for i, t in enumerate(taps)]
            y = sc.refinenet4(rn[3])
            y = sc.refinenet3(y, rn[2])
            y = sc.refinenet2(y, rn[1])
            y = sc.refinenet1(y, rn[0])
            head = sc.output_conv
            y = _conv(y, head[0].weight, bias=head[0].bias)
            y = F.interpolate(y, scale_factor=2, mode="bilinear", align_corners=False)
            y = torch.relu(_conv(y, head[2].weight, bias=head[2].bias))
            y = torch.relu(_conv(y, head[4].weight, bias=head[4].bias))
        return y[:, 0]


def midas_inverse_depth(params: MidasNet, x01: torch.Tensor) -> torch.Tensor:
    """[N, H, W, 3] in [0,1] -> [N, H, W] inverse depth (proximity)."""
    return params(x01)


def _bn_keys(prefix, tree, out):
    out[f"{prefix}.weight"] = tree["gamma"]
    out[f"{prefix}.bias"] = tree["beta"]
    out[f"{prefix}.running_mean"] = tree["mean"]
    out[f"{prefix}.running_var"] = tree["var"]
    out[f"{prefix}.num_batches_tracked"] = np.zeros((), np.int64)


# Encoder stage index -> hub key prefix (pretrained.layerN wraps effnet.blocks
# slices; Sequential indices shift layer1 by the stem's three modules).
_STAGE_PREFIX = (
    "pretrained.layer1.3", "pretrained.layer1.4",
    "pretrained.layer2.0",
    "pretrained.layer3.0", "pretrained.layer3.1",
    "pretrained.layer4.0", "pretrained.layer4.1",
)


def _hub_state_dict(tree) -> dict:
    """``init_midas_params``'s tree (HWIO convs, numpy or JAX arrays) as a
    hub-layout state dict (OIHW, numpy): the inverse of the JAX package's
    ``_convert_torch_midas``."""
    def w(a):
        return np.ascontiguousarray(np.transpose(np.asarray(a, np.float32), (3, 2, 0, 1)))

    def v(a):
        return np.asarray(a, np.float32)

    tree = _numpy_tree(tree)
    sd = {"pretrained.layer1.0.weight": w(tree["stem_w"])}
    _bn_keys("pretrained.layer1.1", tree["stem_bn"], sd)
    for si, stage in enumerate(tree["stages"]):
        for r, b in enumerate(stage):
            p = f"{_STAGE_PREFIX[si]}.{r}"
            if b["expand"] is None:
                names = (("conv_dw", "bn1", "dw"), ("conv_pw", "bn2", "pw"))
            else:
                sd[f"{p}.conv_pw.weight"] = w(b["expand"]["w"])
                _bn_keys(f"{p}.bn1", b["expand"]["bn"], sd)
                names = (("conv_dw", "bn2", "dw"), ("conv_pwl", "bn3", "pw"))
            for conv, bn, key in names:
                sd[f"{p}.{conv}.weight"] = w(b[f"{key}_w"])
                _bn_keys(f"{p}.{bn}", b[f"{key}_bn"], sd)
    for i, a in enumerate(tree["scratch_rn"]):
        sd[f"scratch.layer{i + 1}_rn.weight"] = w(a)
    for i, r in enumerate(tree["refine"]):
        p = f"scratch.refinenet{i + 1}"
        for unit, key in (("resConfUnit1", "rcu1"), ("resConfUnit2", "rcu2")):
            for j in (1, 2):
                sd[f"{p}.{unit}.conv{j}.weight"] = w(r[key][f"w{j}"])
                sd[f"{p}.{unit}.conv{j}.bias"] = v(r[key][f"b{j}"])
        sd[f"{p}.out_conv.weight"] = w(r["out_w"])
        sd[f"{p}.out_conv.bias"] = v(r["out_b"])
    for i, j in ((1, 0), (2, 2), (3, 4)):
        sd[f"scratch.output_conv.{j}.weight"] = w(tree[f"head_w{i}"])
        sd[f"scratch.output_conv.{j}.bias"] = v(tree[f"head_b{i}"])
    return sd


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy_tree(v) for v in tree]
    if tree is None or isinstance(tree, (bool, int)):
        return tree
    return np.asarray(tree)


def _from_state_dict(state_dict: dict, device) -> MidasNet:
    """A ``MidasNet`` on ``device`` holding ``state_dict`` (strict)."""
    net = MidasNet()
    net.load_state_dict({k: torch.as_tensor(np.array(a)) for k, a in state_dict.items()},
                        strict=True)
    return net.to(resolve_device(device)).requires_grad_(False)


def from_jax_params(params, device=None) -> MidasNet:
    """The JAX package's ``init_midas_params`` tree (HWIO convs, BN as
    gamma/beta/mean/var; numpy or JAX arrays) as a ``MidasNet`` on
    ``device``."""
    return _from_state_dict(_hub_state_dict(params), device)


def _he(generator, shape):
    fan_in = int(np.prod(shape[1:]))
    return torch.randn(shape, generator=generator) * (2.0 / fan_in) ** 0.5


@torch.no_grad()
def init_midas_params(generator: torch.Generator | None = None, device=None) -> MidasNet:
    """Random init drawn on the CPU from ``generator`` (seed 0 when None),
    with the JAX package's distributions: He-normal convs (fan-in k*k*cin,
    k*k for the depthwise convs), zero biases, BN gamma 1, beta 0, mean 0,
    var 1."""
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    dev = resolve_device(device)
    net = MidasNet()
    for m in net.modules():
        if isinstance(m, nn.Conv2d):
            m.weight.copy_(_he(gen, m.weight.shape))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    return net.to(dev).requires_grad_(False)


def _to_image(img, device: torch.device) -> torch.Tensor:
    """HWC float [0,1] or uint8, numpy or tensor -> float32 HWC RGB on
    ``device``. A tensor on another device raises: nothing is moved
    quietly."""
    if isinstance(img, torch.Tensor):
        if img.device != device:
            raise ValueError(f"the MiDaS estimator's weights are on {device}, the image on "
                             f"{img.device}; move one of them")
        x = img
    else:
        x = torch.from_numpy(np.ascontiguousarray(img)).to(device)
    if x.dtype == torch.uint8:
        x = x.float() / 255.0
    if x.ndim == 2:
        x = torch.stack([x] * 3, dim=-1)
    if x.shape[-1] == 4:
        x = x[..., :3]
    return x.float()


def make_depth_estimator(params: MidasNet):
    """fn(img HWC [0,1] or uint8, numpy or tensor) -> [H, W] proximity on the
    weights' device, for ``models.depthnet.register_depth_model``: the hub's
    normalisation, 256^2 bicubic in and out. Counter ``depth.network_calls``
    (under a profiler): the estimates that ran the network."""
    from aip_tpu_torch.ops.image import resize_bicubic

    device = next(params.parameters()).device

    @torch.no_grad()
    def depth(img):
        x = _to_image(img, device)
        h, w = x.shape[0], x.shape[1]
        pred = params(resize_bicubic(x[None], (WORK_SIZE, WORK_SIZE)))
        count("depth.network_calls", 1)
        # Hub post-processing: bicubic upsample back to the input size.
        return resize_bicubic(pred[0][:, :, None], (h, w))[:, :, 0]

    return depth


def get_midas_params(torch_path=None, device=None) -> MidasNet:
    """A hub ``midas_v21_small_256.pt`` state dict (a real checkpoint, read
    with ``weights_only``), else ``init_midas_params`` from seed 0."""
    from aip_tpu_torch.models import weights as weights_mod

    if torch_path is not None and weights_mod._is_real_checkpoint(Path(torch_path)):
        return _from_state_dict(weights_mod._load_torch_state_dict(Path(torch_path)), device)
    return init_midas_params(device=device)


def use_midas(torch_path, device=None) -> None:
    """Install MiDaS-small (a hub checkpoint, or the seeded init) as THE
    depth estimator of every depth-aware pipeline, in place of the classical
    proxy (reference ``AdaIN/test.py:84-116``). ``register_depth_model(None)``
    puts the classical proxy back."""
    from aip_tpu_torch.models.depthnet import register_depth_model

    register_depth_model(make_depth_estimator(get_midas_params(torch_path, device)))
