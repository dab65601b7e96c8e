"""Magenta-style arbitrary-image-stylization network (feed-forward). Port
of ``aip_tpu.models.magenta``: the Ghiasi et al. 2017 design of the TF-Hub
module the reference's fast video path loads (`video/utils.py:14,108-154`).

* ``StyleTransformer``: 9x9-32 / 3x3s2-64 / 3x3s2-128 contract, 5 residual
  blocks, nearest-upsample expand, 9x9-3 head with a sigmoid, mirror
  padding, conditional instance norm (CIN) after every non-output conv.
* ``StylePredictor``: a trunk (``"compact"``, four strided 3x3 convs, or
  ``"mobilenet_v2"``, :mod:`aip_tpu_torch.models.mobilenet`), the 100-d
  bottleneck and one (gamma, beta) head per CIN site.

``MagentaParams`` pairs the two modules. Weights are OIHW inside the
modules; ``load_magenta_npz`` / ``save_magenta_npz`` read and write
``aip_tpu``'s npz layout (HWIO, the same keys), which makes them the weight
bridge between the packages: the committed
``docs/examples/magenta/magenta_distilled.npz`` loads in both. Activations
are NHWC in [0, 1] at the public functions. Every function that builds
parameters takes ``device=None``, which means CUDA.
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from aip_tpu_torch.device import fp32_convs, resolve_device
from aip_tpu_torch.models import mobilenet as mbv2

BOTTLENECK = 100

# Transformer conv plan: (name, kernel, stride, out_ch).
_CONTRACT = (("c1", 9, 1, 32), ("c2", 3, 2, 64), ("c3", 3, 2, 128))
_N_RESIDUAL = 5
_EXPAND = (("u1", 3, 1, 64), ("u2", 3, 1, 32))
_PREDICTOR_TRUNK = ((3, 2, 32), (3, 2, 64), (3, 2, 128), (3, 2, 192))

DISTILLED_NPZ = (Path(__file__).resolve().parents[2] / "docs" / "examples" / "magenta"
                 / "magenta_distilled.npz")


def _cin_channels() -> list[tuple[str, int]]:
    """Ordered (layer name, channels) of every CIN site."""
    sites = [(n, c) for n, _k, _s, c in _CONTRACT]
    for r in range(_N_RESIDUAL):
        sites += [(f"r{r}a", 128), (f"r{r}b", 128)]
    sites += [(n, c) for n, _k, _s, c in _EXPAND]
    return sites


def _transform_convs() -> list[tuple[str, int, int, int]]:
    """(name, kernel, in, out) of every transformer conv, in network order."""
    convs, cin = [], 3
    for name, k, _s, cout in _CONTRACT:
        convs.append((name, k, cin, cout))
        cin = cout
    for r in range(_N_RESIDUAL):
        convs += [(f"r{r}a", 3, 128, 128), (f"r{r}b", 3, 128, 128)]
    for name, k, _s, cout in _EXPAND:
        convs.append((name, k, cin, cout))
        cin = cout
    convs.append(("out", 9, cin, 3))
    return convs


def _empty(*shape, device):
    return nn.Parameter(torch.empty(shape, device=device))


class StyleTransformer(nn.Module):
    """The transformer's conv weights (OIHW, no biases) and the head's bias."""

    def __init__(self, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.convs = nn.ParameterDict(
            {name: _empty(cout, cin, k, k, device=dev) for name, k, cin, cout in _transform_convs()})
        self.out_b = _empty(3, device=dev)


class StylePredictor(nn.Module):
    """A style trunk, the bottleneck ([C, 100] weight, as ``aip_tpu`` keeps
    it) and the CIN heads (``{site}_{gamma,beta}_{w,b}``)."""

    def __init__(self, trunk: str = "compact", device=None):
        super().__init__()
        if trunk not in ("compact", "mobilenet_v2"):
            raise ValueError(f"unknown predictor trunk {trunk!r}")
        dev = resolve_device(device)
        self.trunk = nn.ParameterList()
        self.mbv2 = None
        if trunk == "mobilenet_v2":
            self.mbv2 = mbv2.MobileNetV2Trunk(dev)
            pc = mbv2.MBV2_FEATURES
        else:
            pc = 3
            for k, _s, cout in _PREDICTOR_TRUNK:
                self.trunk.append(_empty(cout, pc, k, k, device=dev))
                pc = cout
        self.bottleneck_w = _empty(pc, BOTTLENECK, device=dev)
        self.bottleneck_b = _empty(BOTTLENECK, device=dev)
        heads = {}
        for name, c in _cin_channels():
            for kind in ("gamma", "beta"):
                heads[f"{name}_{kind}_w"] = _empty(BOTTLENECK, c, device=dev)
                heads[f"{name}_{kind}_b"] = _empty(c, device=dev)
        self.heads = nn.ParameterDict(heads)


class MagentaParams(NamedTuple):
    transform: StyleTransformer
    predictor: StylePredictor


def _he(shape, fan_in, generator):
    return torch.randn(shape, generator=generator) * (2.0 / fan_in) ** 0.5


@torch.no_grad()
def init_magenta_params(generator: torch.Generator | None = None,
                        predictor_trunk: str = "compact", device=None) -> MagentaParams:
    """Random init drawn on the CPU from ``generator`` (seed 0 when None):
    He-normal convs, zero head bias, bottleneck N(0, 1/C), CIN heads
    N(0, 0.01) with gamma biases 1 and beta biases 0. ``aip_tpu`` draws from
    ``jax.random``; the same seed gives other weights (share them through
    ``save_magenta_npz`` / ``load_magenta_npz``)."""
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    dev = resolve_device(device)
    t = StyleTransformer(dev)
    for name, k, cin, _cout in _transform_convs():
        w = t.convs[name]
        w.copy_(_he(w.shape, k * k * cin, gen))
    t.out_b.zero_()
    p = StylePredictor(predictor_trunk, dev)
    if p.mbv2 is not None:
        p.mbv2 = mbv2.init_mbv2_trunk(gen, dev)
    for w in p.trunk:
        w.copy_(_he(w.shape, w.shape[1] * w.shape[2] * w.shape[3], gen))
    pc = p.bottleneck_w.shape[0]
    p.bottleneck_w.copy_(torch.randn(p.bottleneck_w.shape, generator=gen) * (1.0 / pc) ** 0.5)
    p.bottleneck_b.zero_()
    for name, _c in _cin_channels():
        for kind, bias in (("gamma", 1.0), ("beta", 0.0)):
            w = p.heads[f"{name}_{kind}_w"]
            w.copy_(torch.randn(w.shape, generator=gen) * 0.01)
            p.heads[f"{name}_{kind}_b"].fill_(bias)
    return MagentaParams(t, p)


def _mirror_conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Reflect-pad by (k-1)//2, then a VALID conv. NCHW, w OIHW."""
    p = (w.shape[-1] - 1) // 2
    with fp32_convs():
        return F.conv2d(F.pad(x, (p, p, p, p), mode="reflect"), w, stride=stride)


def _cin(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-5):
    """Conditional instance norm of NCHW x with [N, C] gamma and beta; the
    biased variance, as ``jnp.var``."""
    mu = x.mean(dim=(2, 3), keepdim=True)
    var = x.var(dim=(2, 3), keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + eps) * gamma[:, :, None, None] + beta[:, :, None, None]


def predict_style(params: MagentaParams, style: torch.Tensor) -> dict:
    """[N, H, W, 3] style image(s) -> {site: (gamma [N, C], beta [N, C])}."""
    p = params.predictor
    if p.mbv2 is not None:
        feats = mbv2.mbv2_features(p.mbv2, style)
    else:
        x = style.permute(0, 3, 1, 2)
        for w in p.trunk:
            x = torch.relu(_mirror_conv(x, w, stride=2))
        feats = x.mean(dim=(2, 3))
    emb = feats @ p.bottleneck_w + p.bottleneck_b
    h = p.heads
    return {name: (emb @ h[f"{name}_gamma_w"] + h[f"{name}_gamma_b"],
                   emb @ h[f"{name}_beta_w"] + h[f"{name}_beta_b"])
            for name, _c in _cin_channels()}


def transform(params: MagentaParams, content: torch.Tensor, cin_params: dict) -> torch.Tensor:
    """[N, H, W, 3] content in [0, 1] and predicted CIN parameters ->
    stylized [N, H, W, 3] in [0, 1]. H and W must be multiples of 4."""
    w = params.transform.convs

    def block(x, name, stride):
        g, b = cin_params[name]
        return _cin(_mirror_conv(x, w[name], stride=stride), g, b)

    x = content.permute(0, 3, 1, 2)
    for name, _k, s, _c in _CONTRACT:
        x = torch.relu(block(x, name, s))
    for r in range(_N_RESIDUAL):
        y = torch.relu(block(x, f"r{r}a", 1))
        x = x + block(y, f"r{r}b", 1)
    for name, _k, _s, _c in _EXPAND:
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        x = torch.relu(block(x, name, 1))
    x = _mirror_conv(x, w["out"]) + params.transform.out_b[:, None, None]
    return torch.sigmoid(x).permute(0, 2, 3, 1)


def stylize(params: MagentaParams, content: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
    """The hub module's call: content [N, H, W, 3], style [H', W', 3] or
    [1, H', W', 3], both in [0, 1] -> stylized [N, H, W, 3]."""
    if style.ndim == 3:
        style = style[None]
    n = content.shape[0]
    cin_params = {k: (g.expand(n, -1), b.expand(n, -1))
                  for k, (g, b) in predict_style(params, style).items()}
    return transform(params, content, cin_params)


def _params_device(params: MagentaParams) -> torch.device:
    return params.transform.out_b.device


def make_fast_stylizer(params: MagentaParams | None = None, device=None):
    """fn(frames [N, H, W, 3], style [H, W, 3]) -> [N, H, W, 3] float32 on
    the parameters' device, for ``pipelines.video.register_fast_stylizer``.
    Without ``params``: ``init_magenta_params`` from seed 0 on ``device``."""
    if params is None:
        params = init_magenta_params(device=device)
    dev = _params_device(params)

    @torch.no_grad()
    def stylizer(frames, style):
        return stylize(params, torch.as_tensor(frames, dtype=torch.float32, device=dev),
                       torch.as_tensor(style, dtype=torch.float32, device=dev))

    return stylizer


def use_magenta_stylizer(params: MagentaParams | None = None, device=None) -> None:
    """Install the magenta-equivalent network as the video fast path
    (reference `video/utils.py:108-154`)."""
    from aip_tpu_torch.pipelines.video import register_fast_stylizer

    register_fast_stylizer(make_fast_stylizer(params, device))


def load_mbv2_trunk_from_torch(params: MagentaParams, state_dict) -> MagentaParams:
    """Swap a torchvision-layout MobileNetV2 ``state_dict`` into a
    ``"mobilenet_v2"`` predictor (in place; the bottleneck and CIN heads are
    untouched). Returns ``params``."""
    if params.predictor.mbv2 is None:
        raise ValueError("params were not built with predictor_trunk='mobilenet_v2'")
    params.predictor.mbv2 = mbv2.convert_torch_mobilenet_v2(state_dict, _params_device(params))
    return params


def _hwio(w: torch.Tensor) -> np.ndarray:
    return w.detach().permute(2, 3, 1, 0).cpu().numpy()


def _oihw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(3, 2, 0, 1)))


def save_magenta_npz(params: MagentaParams, path) -> None:
    """Write ``aip_tpu``'s npz layout: HWIO convs, ``t_*`` transformer,
    ``p_trunk_*`` / ``mb_*`` trunk, ``p_bottleneck_*``, ``h_*`` heads."""
    t, p = params
    flat = {f"t_{k}": _hwio(v) for k, v in t.convs.items()}
    flat["t_out_b"] = t.out_b.detach().cpu().numpy()
    for i, w in enumerate(p.trunk):
        flat[f"p_trunk_{i}"] = _hwio(w)
    if p.mbv2 is not None:
        flat["p_trunk_type"] = np.asarray("mobilenet_v2")
        for name, cb in mbv2.mbv2_items(p.mbv2):
            flat[f"mb_{name}_w"] = _hwio(cb.weight)
            flat[f"mb_{name}_scale"] = cb.scale.detach().cpu().numpy()
            flat[f"mb_{name}_shift"] = cb.shift.detach().cpu().numpy()
    flat["p_bottleneck_w"] = p.bottleneck_w.detach().cpu().numpy()
    flat["p_bottleneck_b"] = p.bottleneck_b.detach().cpu().numpy()
    for k, v in p.heads.items():
        flat[f"h_{k}"] = v.detach().cpu().numpy()
    np.savez(str(path), **flat)


@torch.no_grad()
def load_magenta_npz(path, device=None) -> MagentaParams:
    """Read an npz written by either package's ``save_magenta_npz`` onto
    ``device``."""
    dev = resolve_device(device)
    with np.load(str(path)) as d:
        files = set(d.files)
        is_mbv2 = "p_trunk_type" in files and str(d["p_trunk_type"]) == "mobilenet_v2"
        t = StyleTransformer(dev)
        for name, param in t.convs.items():
            param.copy_(_oihw(d[f"t_{name}"]))
        t.out_b.copy_(torch.from_numpy(np.asarray(d["t_out_b"], np.float32)))
        p = StylePredictor("mobilenet_v2" if is_mbv2 else "compact", dev)
        n_trunk = sum(1 for k in files
                      if k.startswith("p_trunk_") and k[len("p_trunk_"):].isdigit())
        if n_trunk != len(p.trunk):
            raise ValueError(f"{path}: {n_trunk} compact trunk convs, expected {len(p.trunk)}")
        for i, param in enumerate(p.trunk):
            param.copy_(_oihw(d[f"p_trunk_{i}"]))
        if is_mbv2:
            for name, cb in mbv2.mbv2_items(p.mbv2):
                cb.weight.copy_(_oihw(d[f"mb_{name}_w"]))
                cb.scale.copy_(torch.from_numpy(np.asarray(d[f"mb_{name}_scale"], np.float32)))
                cb.shift.copy_(torch.from_numpy(np.asarray(d[f"mb_{name}_shift"], np.float32)))
        p.bottleneck_w.copy_(torch.from_numpy(np.asarray(d["p_bottleneck_w"], np.float32)))
        p.bottleneck_b.copy_(torch.from_numpy(np.asarray(d["p_bottleneck_b"], np.float32)))
        for k, param in p.heads.items():
            param.copy_(torch.from_numpy(np.asarray(d[f"h_{k}"], np.float32)))
    return MagentaParams(t, p)
