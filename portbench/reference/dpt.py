"""Plain DPT-Large (Ranftl, Bochkovskiy and Koltun 2021, arXiv:2103.13413) as
the ``intel-isl/MiDaS`` torch hub's ``DPT_Large`` runs it
(``midas/dpt_depth.py``, ``midas/vit.py``, ``midas/blocks.py``; timm's
``vit_large_patch16_384``), read straight from a hub-layout state dict, in
float32. No kernel, cache or package of the program is used.

* ViT-L/16 (``forward_flex``): the 16x16/16 patch conv, the class token in
  front, the 24x24 position grid resized bilinearly (align_corners=False)
  to the input's grid with the class token's position kept
  (``_resize_pos_embed``), pre-LN blocks (LayerNorm, heads of width 64
  from one qkv Linear, ``(q @ k^T) * d^-1/2``, softmax, ``@ v``, the
  projection; LayerNorm, Linear, exact GELU, Linear), the residual adds.
* The tokens after the hooked blocks; each through ``ProjectReadout``
  (patch tokens concatenated with the class token, Linear, GELU),
  transposed and unflattened to the grid, the 1x1 conv, then hook 1's
  4x4/4 and hook 2's 2x2/2 transposed convs and hook 4's 3x3/2 conv.
* ``scratch.layer{1..4}_rn`` (3x3, no bias); ``FeatureFusionBlock_custom``
  (bn off, expand off): ``x + rcu1(skip)`` where there is a skip, rcu2,
  2x bilinear with align_corners, the 1x1 out conv, each residual unit
  ``x + conv2(relu(conv1(relu(x))))``; the head: 3x3, 2x bilinear with
  align_corners, 3x3, ReLU, 1x1, ReLU.
* The hub's ``dpt_transform``: the sides scaled by the one of 384 / H and
  384 / W that lies nearer 1 and rounded (half to even) to multiples of 32
  (``Resize(..., resize_method="minimal")``), bicubic; (x - 0.5) / 0.5;
  the prediction resized bicubically back to the image's size.

Departures from the hub, each where the program departs too:

* both resizes are ``F.interpolate``'s bicubic (align_corners=False,
  a = -0.75, edges clamped) where the hub resizes the input with cv2's
  INTER_CUBIC (the same kernel and centres) in float64;
* the input is the float32 image / 255, not float64;
* timm's final LayerNorm and classifier are not run: the hub's forward
  discards their output (the hooks read the blocks');
* a side that rounds to no multiple of 32 becomes one multiple (the hub's
  would be 0 and fail).

``precision``: ``"fp32"`` with TF32 off in cuDNN and matmuls (the
reference), ``"tf32"`` with it on (the control of an fp32 cell).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.adain import precision_flags

MEAN = 0.5
STD = 0.5
PATCH_W = "pretrained.model.patch_embed.proj.weight"


def state_dict_shapes(cfg: dict) -> dict:
    """The hub's ``DPT_Large`` state dict as {key: shape} at the
    configuration's sizes (timm's ``vit_large_patch16_384`` with its
    classifier of 1000 classes, DPT's reassemble, scratch and head)."""
    h, p, f = cfg["hidden_size"], cfg["patch_size"], cfg["features"]
    m, widths, hf = cfg["intermediate_size"], cfg["reassemble_widths"], cfg["head_features"]
    v = "pretrained.model"
    out = {f"{v}.cls_token": (1, 1, h), f"{v}.pos_embed": (1, 1 + cfg["pos_grid"] ** 2, h),
           f"{v}.patch_embed.proj.weight": (h, 3, p, p), f"{v}.patch_embed.proj.bias": (h,)}
    for i in range(cfg["num_hidden_layers"]):
        b = f"{v}.blocks.{i}"
        for name, shape in (("norm1", (h,)), ("norm2", (h,))):
            out[f"{b}.{name}.weight"] = out[f"{b}.{name}.bias"] = shape
        for name, (o, n_in) in (("attn.qkv", (3 * h, h)), ("attn.proj", (h, h)),
                                ("mlp.fc1", (m, h)), ("mlp.fc2", (h, m))):
            out[f"{b}.{name}.weight"], out[f"{b}.{name}.bias"] = (o, n_in), (o,)
    out[f"{v}.norm.weight"] = out[f"{v}.norm.bias"] = (h,)
    out[f"{v}.head.weight"], out[f"{v}.head.bias"] = (1000, h), (1000,)
    resample_k = {0: 4, 1: 2, 3: 3}     # ConvTranspose 4/4, ConvTranspose 2/2, Conv 3/2
    for k, w in enumerate(widths):
        a = f"pretrained.act_postprocess{k + 1}"
        out[f"{a}.0.project.0.weight"], out[f"{a}.0.project.0.bias"] = (h, 2 * h), (h,)
        out[f"{a}.3.weight"], out[f"{a}.3.bias"] = (w, h, 1, 1), (w,)
        if k in resample_k:
            out[f"{a}.4.weight"], out[f"{a}.4.bias"] = (w, w, resample_k[k], resample_k[k]), (w,)
    for k, w in enumerate(widths):
        out[f"scratch.layer{k + 1}_rn.weight"] = (f, w, 3, 3)
    for k in range(1, 5):
        r = f"scratch.refinenet{k}"
        for unit in ("resConfUnit1", "resConfUnit2"):
            for j in (1, 2):
                out[f"{r}.{unit}.conv{j}.weight"] = (f, f, 3, 3)
                out[f"{r}.{unit}.conv{j}.bias"] = (f,)
        out[f"{r}.out_conv.weight"], out[f"{r}.out_conv.bias"] = (f, f, 1, 1), (f,)
    for idx, (o, i, k) in ((0, (f // 2, f, 3)), (2, (hf, f // 2, 3)), (4, (1, hf, 1))):
        out[f"scratch.output_conv.{idx}.weight"] = (o, i, k, k)
        out[f"scratch.output_conv.{idx}.bias"] = (o,)
    return out


def transform_size(h: int, w: int, net_size: int = 384, multiple: int = 32) -> tuple[int, int]:
    """``Resize(384, 384, keep_aspect_ratio=True, ensure_multiple_of=32,
    resize_method="minimal")``'s (height, width)."""
    scale_h, scale_w = net_size / h, net_size / w
    if abs(1 - scale_w) < abs(1 - scale_h):
        scale_h = scale_w
    else:
        scale_w = scale_h
    return (max(multiple, int(np.round(scale_h * h / multiple)) * multiple),
            max(multiple, int(np.round(scale_w * w / multiple)) * multiple))


def _linear(sd, prefix, x):
    return F.linear(x, sd[f"{prefix}.weight"], sd[f"{prefix}.bias"])


def _layer_norm(sd, prefix, x, eps):
    return F.layer_norm(x, x.shape[-1:], sd[f"{prefix}.weight"], sd[f"{prefix}.bias"], eps)


def _conv(sd, prefix, x, stride=1, padding=0):
    return F.conv2d(x, sd[f"{prefix}.weight"], sd.get(f"{prefix}.bias"), stride=stride,
                    padding=padding)


def block(sd, i, x, heads, eps):
    """timm's pre-LN ViT block ``i`` on tokens [N, T, C]."""
    b = f"pretrained.model.blocks.{i}"
    n, t, c = x.shape
    qkv = _linear(sd, f"{b}.attn.qkv", _layer_norm(sd, f"{b}.norm1", x, eps))
    qkv = qkv.reshape(n, t, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    attn = torch.softmax((q @ k.transpose(-2, -1)) * (c // heads) ** -0.5, dim=-1)
    x = x + _linear(sd, f"{b}.attn.proj", (attn @ v).transpose(1, 2).reshape(n, t, c))
    y = F.gelu(_linear(sd, f"{b}.mlp.fc1", _layer_norm(sd, f"{b}.norm2", x, eps)))
    return x + _linear(sd, f"{b}.mlp.fc2", y)


def embed(sd, x):
    """Tokens [N, 1 + gh * gw, C] of normalised NCHW ``x``."""
    v = "pretrained.model"
    n, _, h, w = x.shape
    p = sd[PATCH_W].shape[-1]
    gh, gw = h // p, w // p
    t = _conv(sd, f"{v}.patch_embed.proj", x, stride=p).flatten(2).transpose(1, 2)
    t = torch.cat([sd[f"{v}.cls_token"].expand(n, -1, -1), t], dim=1)
    pos = sd[f"{v}.pos_embed"]
    g = math.isqrt(pos.shape[1] - 1)
    grid = pos[0, 1:].reshape(1, g, g, -1).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, size=(gh, gw), mode="bilinear", align_corners=False)
    return t + torch.cat([pos[:, :1], grid.permute(0, 2, 3, 1).reshape(1, gh * gw, -1)], dim=1)


def reassemble(sd, k, tokens, gh, gw):
    a = f"pretrained.act_postprocess{k + 1}"
    patches = tokens[:, 1:]
    y = F.gelu(_linear(sd, f"{a}.0.project.0",
                       torch.cat([patches, tokens[:, :1].expand_as(patches)], dim=-1)))
    y = y.transpose(1, 2).reshape(y.shape[0], -1, gh, gw).contiguous()
    y = _conv(sd, f"{a}.3", y)
    w = sd.get(f"{a}.4.weight")
    if w is not None and k in (0, 1):
        y = F.conv_transpose2d(y, w, sd[f"{a}.4.bias"], stride=w.shape[-1])
    elif w is not None:
        y = _conv(sd, f"{a}.4", y, stride=2, padding=1)
    return y


def _rcu(sd, prefix, x):
    y = _conv(sd, f"{prefix}.conv1", torch.relu(x), padding=1)
    return x + _conv(sd, f"{prefix}.conv2", torch.relu(y), padding=1)


def fusion(sd, k, x, skip=None):
    r = f"scratch.refinenet{k}"
    if skip is not None:
        x = x + _rcu(sd, f"{r}.resConfUnit1", skip)
    x = _rcu(sd, f"{r}.resConfUnit2", x)
    x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)
    return _conv(sd, f"{r}.out_conv", x)


def forward(sd, x, cfg, relu=True):
    """Inverse depth [N, H, W] of normalised NCHW ``x`` (H, W multiples of
    32), float32 in the flags the caller set; ``relu=False`` stops before
    the final ReLU."""
    p = sd[PATCH_W].shape[-1]
    gh, gw = x.shape[-2] // p, x.shape[-1] // p
    t = embed(sd, x)
    taps = []
    for i in range(max(cfg["hooks"]) + 1):
        t = block(sd, i, t, cfg["num_attention_heads"], cfg["layer_norm_eps"])
        if i in cfg["hooks"]:
            taps.append(t)
    rn = [_conv(sd, f"scratch.layer{k + 1}_rn", reassemble(sd, k, tap, gh, gw), padding=1)
          for k, tap in enumerate(taps)]
    y = fusion(sd, 4, rn[3])
    for k in (3, 2, 1):
        y = fusion(sd, k, y, rn[k - 1])
    y = _conv(sd, "scratch.output_conv.0", y, padding=1)
    y = F.interpolate(y, scale_factor=2, mode="bilinear", align_corners=True)
    y = _conv(sd, "scratch.output_conv.4", torch.relu(_conv(sd, "scratch.output_conv.2", y,
                                                             padding=1)))
    return (torch.relu(y) if relu else y)[:, 0]


@torch.no_grad()
def proximity(sd, img01_hwc: torch.Tensor, cfg, precision: str = "fp32") -> torch.Tensor:
    """The hub's depth call on one HWC float32 image in [0, 1]: the
    transform, the forward, the bicubic resize back; [H, W] float32."""
    h, w = img01_hwc.shape[:2]
    size = transform_size(h, w, cfg["net_size"], cfg["multiple_of"])
    with precision_flags(precision):
        x = img01_hwc.float().permute(2, 0, 1)[None]
        x = F.interpolate(x, size=size, mode="bicubic", align_corners=False)
        pred = forward(sd, ((x - MEAN) / STD).contiguous(), cfg)
        return F.interpolate(pred[:, None], size=(h, w), mode="bicubic",
                             align_corners=False)[0, 0]
