"""Swin-T feature extractor (shifted-window transformer) for the style mixer.
Port of ``aip_tpu.models.swin``.

Completes the reference's backbone list (`gui/seven_page.py:189-229`
SwinFeatureExtractor, torchvision ``swin_t``): patch-embed 4x4 -> stages
[2, 2, 6, 2] of window attention (window 7, heads [3, 6, 12, 24], shifted in
odd blocks, relative position bias) with patch merging between stages. The
extractor returns the final [H/32, W/32, 768] map under the ``"swin"`` key
(the tap seven_page uses) plus per-stage taps.

Parameters are a ``weights.ParamTree`` with the JAX package's keys: the
patch-embed conv OIHW, the linear layers [in, out] (``x @ w + b``). The
attention is written out with plain ops as in the JAX package (``q @ k^T *
d^-1/2`` + bias + shift mask, softmax, ``@ v``), not
``F.scaled_dot_product_attention``, whose fused paths sum in another order.
The JAX package's rules are kept: padding to window multiples, no shift
along an axis that fits in one window, PatchMerging's h-offset-first concat
order, exact-erf GELU. The patch-embed conv runs under ``fp32_convs``.
Weights convert from a torchvision ``swin_t`` state dict when provided;
deterministic random init otherwise.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from aip_tpu_torch.device import fp32_convs, resolve_device

DEPTHS = (2, 2, 6, 2)
HEADS = (3, 6, 12, 24)
EMBED = 96
WINDOW = 7
MLP_RATIO = 4


def _ln(x, p, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["g"] + p["b"]


def _init_ln(c):
    return {"g": torch.ones(c), "b": torch.zeros(c)}


def _init_lin(gen, i, o):
    return {"w": torch.randn(i, o, generator=gen) * (i ** -0.5), "b": torch.zeros(o)}


def _rel_index(window):
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window),
                                  indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0) + (window - 1)
    return rel[..., 0] * (2 * window - 1) + rel[..., 1]  # [window^2, window^2]


_REL_IDX = torch.from_numpy(_rel_index(WINDOW))


def init_swin_t_params(generator: torch.Generator | None = None, device=None):
    """The JAX package's init (normal linears at i^-1/2, bias tables and the
    patch conv at 0.02, identity LayerNorms), drawn on the CPU from
    ``generator`` (seed 0 by default)."""
    from aip_tpu_torch.models.weights import ParamTree

    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    params = {"patch_w": torch.randn(EMBED, 3, 4, 4, generator=gen) * 0.02,
              "patch_b": torch.zeros(EMBED), "patch_ln": _init_ln(EMBED), "stages": []}
    dim = EMBED
    for si, depth in enumerate(DEPTHS):
        blocks = []
        for _ in range(depth):
            blocks.append({
                "ln1": _init_ln(dim),
                "qkv": _init_lin(gen, dim, 3 * dim),
                "proj": _init_lin(gen, dim, dim),
                "bias_table": torch.randn((2 * WINDOW - 1) ** 2, HEADS[si], generator=gen) * 0.02,
                "ln2": _init_ln(dim),
                "fc1": _init_lin(gen, dim, MLP_RATIO * dim),
                "fc2": _init_lin(gen, MLP_RATIO * dim, dim),
            })
        stage = {"blocks": blocks}
        if si < 3:
            stage["merge_ln"] = _init_ln(4 * dim)
            stage["merge_w"] = _init_lin(gen, 4 * dim, 2 * dim)
            dim *= 2
        params["stages"].append(stage)
    params["final_ln"] = _init_ln(dim)
    return ParamTree(params).to(dev)


def from_jax_params(params, device=None):
    """``aip_tpu``'s Swin-T tree (HWIO patch conv, [in, out] linears) -> the
    port's ``ParamTree``."""
    from aip_tpu_torch.models.weights import tree_from_jax

    return tree_from_jax(params, device)


def _window_partition(x, sh, sw, window=WINDOW):
    """[N, H, W, C] -> [N*nW, window^2, C]; (sh, sw) is the cyclic shift."""
    n, h, w, c = x.shape
    if sh or sw:
        x = torch.roll(x, (-sh, -sw), dims=(1, 2))
    nh, nw = h // window, w // window
    xw = x.reshape(n, nh, window, nw, window, c).permute(0, 1, 3, 2, 4, 5)
    return xw.reshape(n * nh * nw, window * window, c), (n, nh, nw)


def _window_reverse(xw, dims, h, w, c, sh, sw, window=WINDOW):
    n, nh, nw = dims
    x = xw.reshape(n, nh, nw, window, window, c).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(n, h, w, c)
    if sh or sw:
        x = torch.roll(x, (sh, sw), dims=(1, 2))
    return x


def _shift_mask(h, w, sh, sw, device, window=WINDOW):
    """Attention mask for shifted windows (cross-boundary pairs masked).
    Per-axis: an unshifted axis contributes no region boundaries."""
    def regions(n, s):
        ids = np.zeros(n)
        if s:
            ids[-window:-s] = 1
            ids[-s:] = 2
        return ids

    img = regions(h, sh)[:, None] * 3 + regions(w, sw)[None, :]
    nh, nw = h // window, w // window
    win = img.reshape(nh, window, nw, window).transpose(0, 2, 1, 3).reshape(-1, window * window)
    mask = (win[:, :, None] != win[:, None, :]) * -100.0  # [nW, window^2, window^2]
    return torch.tensor(mask, dtype=torch.float32, device=device)


def _block(x, p, heads, shift):
    n, h0, w0, c = x.shape
    # Pad to window multiples (torchvision pads the same way).
    ph = (-h0) % WINDOW
    pw = (-w0) % WINDOW
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    n, h, w, c = x.shape
    # torchvision shifted_window_attention: no shift along an axis whose
    # padded extent fits in one window.
    sh = WINDOW // 2 if (shift and h > WINDOW) else 0
    sw = WINDOW // 2 if (shift and w > WINDOW) else 0
    head_dim = c // heads
    shortcut = x
    yw, dims = _window_partition(_ln(x, p["ln1"]), sh, sw)
    nw_total, t, _ = yw.shape

    qkv = yw @ p["qkv"]["w"] + p["qkv"]["b"]
    qkv = qkv.reshape(nw_total, t, 3, heads, head_dim).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]  # [nW, heads, 49, hd]
    attn = (q @ k.transpose(-1, -2)) * (head_dim ** -0.5)
    bias = p["bias_table"][_REL_IDX.to(x.device)]  # [49, 49, heads]
    attn = attn + bias.permute(2, 0, 1)[None]
    if sh or sw:
        m = _shift_mask(h, w, sh, sw, x.device)  # [nW_per_img, 49, 49]
        attn = attn.reshape(dims[0], -1, heads, t, t) + m[None, :, None]
        attn = attn.reshape(nw_total, heads, t, t)
    attn = torch.softmax(attn, dim=-1)
    out = (attn @ v).permute(0, 2, 1, 3).reshape(nw_total, t, c)
    out = out @ p["proj"]["w"] + p["proj"]["b"]
    x = shortcut + _window_reverse(out, dims, h, w, c, sh, sw)

    # torchvision's nn.GELU is the exact erf form.
    y = F.gelu(_ln(x, p["ln2"]) @ p["fc1"]["w"] + p["fc1"]["b"], approximate="none")
    out = x + (y @ p["fc2"]["w"] + p["fc2"]["b"])
    if ph or pw:
        out = out[:, :h0, :w0, :]
    return out


def swin_t_features(params, x01: torch.Tensor) -> dict:
    """ImageNet-normalized NHWC -> feature taps {'layer1'..'layer4', 'swin'}
    with 'swin' = the final-norm [H/32, W/32, 768] map (seven_page's tap)."""
    with fp32_convs():
        x = F.conv2d(x01.permute(0, 3, 1, 2), params["patch_w"], stride=4)
    x = _ln(x.permute(0, 2, 3, 1) + params["patch_b"], params["patch_ln"])

    feats = {}
    for si, stage in enumerate(params["stages"]):
        for bi, block in enumerate(stage["blocks"]):
            x = _block(x, block, HEADS[si], shift=bi % 2 == 1)
        feats[f"layer{si + 1}"] = x
        if "merge_w" in stage:
            n, h, w, c = x.shape
            if h % 2 or w % 2:
                x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
            # torchvision PatchMerging concat order: (h+0,w+0), (h+1,w+0),
            # (h+0,w+1), (h+1,w+1) — the h offset varies first.
            x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                           x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
            x = _ln(x, stage["merge_ln"]) @ stage["merge_w"]["w"] + stage["merge_w"]["b"]
    feats["swin"] = _ln(x, params["final_ln"])
    return feats


def _convert_torch_swin(sd: dict, device=None):
    """torchvision ``swin_t().state_dict()`` (numpy values; features.{0,1,3,
    5,7} = patch embed + stages, features.{2,4,6} = patch merges) -> the
    port's tree."""
    from aip_tpu_torch.models.weights import ParamTree

    def arr(key):
        return np.asarray(sd[key], np.float32)

    def lin(prefix):
        w = arr(f"{prefix}.weight").T
        # PatchMerging's reduction Linear is bias-free in torchvision.
        b = arr(f"{prefix}.bias") if f"{prefix}.bias" in sd else np.zeros(w.shape[1], np.float32)
        return {"w": np.ascontiguousarray(w), "b": b}

    def ln(prefix):
        return {"g": arr(f"{prefix}.weight"), "b": arr(f"{prefix}.bias")}

    params = {"patch_w": arr("features.0.0.weight"), "patch_b": arr("features.0.0.bias"),
              "patch_ln": ln("features.0.2"), "stages": []}
    for si, depth in enumerate(DEPTHS):
        blocks = []
        for bi in range(depth):
            p = f"features.{2 * si + 1}.{bi}"
            blocks.append({"ln1": ln(f"{p}.norm1"), "qkv": lin(f"{p}.attn.qkv"),
                           "proj": lin(f"{p}.attn.proj"),
                           "bias_table": arr(f"{p}.attn.relative_position_bias_table"),
                           "ln2": ln(f"{p}.norm2"), "fc1": lin(f"{p}.mlp.0"),
                           "fc2": lin(f"{p}.mlp.3")})
        stage = {"blocks": blocks}
        if si < 3:
            m = f"features.{2 * si + 2}"
            stage["merge_ln"] = ln(f"{m}.norm")
            stage["merge_w"] = lin(f"{m}.reduction")
        params["stages"].append(stage)
    params["final_ln"] = ln("norm")
    return ParamTree(params).to(resolve_device(device))


def get_swin_t_params(torch_path=None, device=None):
    from aip_tpu_torch.models import weights as weights_mod

    if torch_path is not None and weights_mod._is_real_checkpoint(Path(torch_path)):
        return _convert_torch_swin(weights_mod._load_torch_state_dict(Path(torch_path)), device)
    return init_swin_t_params(device=device)
