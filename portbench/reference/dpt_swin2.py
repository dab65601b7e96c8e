"""Plain DPT-SwinV2-L-384 (MiDaS v3.1; Birkl, Wofk and Müller 2023,
arXiv:2307.14460) as the ``intel-isl/MiDaS`` torch hub's
``DPT_SwinV2_L_384`` runs it (``midas/dpt_depth.py``,
``midas/backbones/swin2.py``, ``midas/backbones/swin_common.py``,
``midas/blocks.py``; timm 0.6's ``swinv2_large_window12to24_192to384_22kft1k``,
Liu et al. 2022, arXiv:2111.09883), read straight from a hub-layout state
dict, in float32. No kernel, cache or package of the program is used; the
decoder's pieces are ``reference/dpt.py``'s.

* SwinV2 (``forward_features``): the 4x4/4 patch conv, LayerNorm; per
  stage, res-post-norm blocks: the window (clamped to the grid, no shift
  then) cyclically shifted by half a window in odd blocks, partitioned;
  qkv without bias plus ``q_bias``, zeros and ``v_bias``; cosine attention
  ``normalize(q) @ normalize(k)^T`` times ``exp(min(logit_scale, log
  100))``, plus ``16 sigmoid`` of ``cpb_mlp`` over the log-spaced
  relative-coordinate table gathered by the relative index, plus the shift
  mask (-100 between regions), softmax, ``@ v``, the projection; the
  windows reversed and unshifted; ``x + LN(attn)``, ``x + LN(mlp)`` (exact
  GELU); after stages 1-3 PatchMerging (the (0,0), (1,0), (0,1), (1,1)
  neighbours concatenated, ``reduction``, ``norm``). The position bias is
  computed in every block call, as timm does.
* The outputs of ``layers[i].blocks[hooks[i]]``, transposed and
  unflattened to the stage's grid (``act_postprocess1..4``).
* ``scratch.layer{1..4}_rn`` and the decoder: ``reference/dpt.py``'s
  ``_conv``, ``fusion`` and the head as its ``forward`` runs them (each
  fusion upsampling by 2, which at 384^2 is the hub's ``size=``).
* The hub's ``swin384_transform``: ``Resize(384, 384,
  keep_aspect_ratio=False, ensure_multiple_of=32, resize_method="minimal")``
  (every image to 384 x 384), bicubic; (x - 0.5) / 0.5; the prediction
  resized bicubically back to the image's size.

Departures from the hub, each where the program departs too:

* both resizes are ``F.interpolate``'s bicubic (align_corners=False,
  a = -0.75, edges clamped) where the hub resizes the input with cv2's
  INTER_CUBIC (the same kernel and centres) in float64;
* the input is the float32 image / 255, not float64;
* timm's final LayerNorm and classifier are not run: the hub's forward
  discards their output (the hooks read the blocks');
* timm 0.6's buffers (``relative_coords_table``,
  ``relative_position_index``, ``k_bias``, ``attn_mask``) are computed
  here, not read from the state dict.

``precision``: ``"fp32"`` with TF32 off in cuDNN and matmuls (the
reference), ``"tf32"`` with it on (the control of an fp32 cell).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.adain import precision_flags
from portbench.reference.dpt import _conv, fusion

MEAN = 0.5
STD = 0.5
M = "pretrained.model"


def widths(cfg: dict) -> list[int]:
    return [cfg["embed_dim"] * 2 ** i for i in range(len(cfg["depths"]))]


def grids(cfg: dict) -> list[int]:
    g = cfg["net_size"] // cfg["patch_size"]
    return [g // 2 ** i for i in range(len(cfg["depths"]))]


def windowing(cfg: dict, i: int, j: int) -> tuple[int, int]:
    """(window, shift) of block ``j`` of stage ``i``: timm's window clamped
    to the grid, and no shift where it covers the grid."""
    g, ws = grids(cfg)[i], cfg["window_size"]
    w = min(ws, g)
    return w, (ws // 2 if j % 2 == 1 and g > w else 0)


def state_dict_shapes(cfg: dict) -> dict:
    """The hub's ``DPT_SwinV2_L_384`` state dict's learned tensors as {key:
    shape} at the configuration's sizes, in timm 0.6's order (timm's
    classifier of ``num_classes``, DPT's scratch and head)."""
    e, p, f, hf = cfg["embed_dim"], cfg["patch_size"], cfg["features"], cfg["head_features"]
    dims, hidden = widths(cfg), cfg["cpb_hidden"]
    out = {f"{M}.patch_embed.proj.weight": (e, 3, p, p), f"{M}.patch_embed.proj.bias": (e,),
           f"{M}.patch_embed.norm.weight": (e,), f"{M}.patch_embed.norm.bias": (e,)}
    for i, (depth, heads, c) in enumerate(zip(cfg["depths"], cfg["num_heads"], dims)):
        m = cfg["mlp_ratio"] * c
        for j in range(depth):
            b = f"{M}.layers.{i}.blocks.{j}"
            out[f"{b}.attn.logit_scale"] = (heads, 1, 1)
            out[f"{b}.attn.q_bias"] = out[f"{b}.attn.v_bias"] = (c,)
            out[f"{b}.attn.cpb_mlp.0.weight"] = (hidden, 2)
            out[f"{b}.attn.cpb_mlp.0.bias"] = (hidden,)
            out[f"{b}.attn.cpb_mlp.2.weight"] = (heads, hidden)
            out[f"{b}.attn.qkv.weight"] = (3 * c, c)
            out[f"{b}.attn.proj.weight"], out[f"{b}.attn.proj.bias"] = (c, c), (c,)
            out[f"{b}.norm1.weight"] = out[f"{b}.norm1.bias"] = (c,)
            out[f"{b}.mlp.fc1.weight"], out[f"{b}.mlp.fc1.bias"] = (m, c), (m,)
            out[f"{b}.mlp.fc2.weight"], out[f"{b}.mlp.fc2.bias"] = (c, m), (c,)
            out[f"{b}.norm2.weight"] = out[f"{b}.norm2.bias"] = (c,)
        if i < len(dims) - 1:
            d = f"{M}.layers.{i}.downsample"
            out[f"{d}.reduction.weight"] = (2 * c, 4 * c)
            out[f"{d}.norm.weight"] = out[f"{d}.norm.bias"] = (2 * c,)
    out[f"{M}.norm.weight"] = out[f"{M}.norm.bias"] = (dims[-1],)
    out[f"{M}.head.weight"] = (cfg["num_classes"], dims[-1])
    out[f"{M}.head.bias"] = (cfg["num_classes"],)
    for k, w in enumerate(dims):
        out[f"scratch.layer{k + 1}_rn.weight"] = (f, w, 3, 3)
    for k in range(1, 5):
        r = f"scratch.refinenet{k}"
        out[f"{r}.out_conv.weight"], out[f"{r}.out_conv.bias"] = (f, f, 1, 1), (f,)
        for unit in ("resConfUnit1", "resConfUnit2"):
            for j in (1, 2):
                out[f"{r}.{unit}.conv{j}.weight"] = (f, f, 3, 3)
                out[f"{r}.{unit}.conv{j}.bias"] = (f,)
    for idx, (o, i, k) in ((0, (f // 2, f, 3)), (2, (hf, f // 2, 3)), (4, (1, hf, 1))):
        out[f"scratch.output_conv.{idx}.weight"] = (o, i, k, k)
        out[f"scratch.output_conv.{idx}.bias"] = (o,)
    return out


def transform_size(h: int, w: int, cfg: dict) -> tuple[int, int]:
    """``Resize(384, 384, keep_aspect_ratio=False, ensure_multiple_of=32,
    resize_method="minimal")``'s (height, width): each side scaled to
    ``net_size`` on its own, then rounded to a multiple."""
    m, n = cfg["multiple_of"], cfg["net_size"]
    return (int(round(n / h * h / m)) * m, int(round(n / w * w / m)) * m)


def coords_table(window: int, pretrained_window: int) -> torch.Tensor:
    r = torch.arange(-(window - 1), window, dtype=torch.float32)
    t = torch.stack(torch.meshgrid([r, r], indexing="ij")).permute(1, 2, 0).contiguous()[None]
    t = t / (pretrained_window - 1) * 8
    return torch.sign(t) * torch.log2(torch.abs(t) + 1.0) / math.log2(8)


def position_index(window: int) -> torch.Tensor:
    c = torch.stack(torch.meshgrid([torch.arange(window)] * 2, indexing="ij")).flatten(1)
    rel = (c[:, :, None] - c[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)


def shift_mask(grid: int, window: int, shift: int) -> torch.Tensor:
    """timm's ``attn_mask`` [nW, w^2, w^2]: the grid's three bands a side
    numbered, partitioned into windows, -100 where two tokens' bands
    differ."""
    img = torch.zeros(1, grid, grid, 1)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[:, hs, ws, :] = cnt
            cnt += 1
    win = partition(img, window).view(-1, window * window)
    mask = win[:, None, :] - win[:, :, None]
    return mask.masked_fill(mask != 0, -100.0).masked_fill(mask == 0, 0.0)


def partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """[B, H, W, C] -> [B * nW, w, w, C] (timm's ``window_partition``)."""
    b, h, w, c = x.shape
    x = x.view(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, window, window, c)


def reverse(windows: torch.Tensor, window: int, h: int, w: int) -> torch.Tensor:
    c = windows.shape[-1]
    x = windows.view(-1, h // window, w // window, window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, h, w, c)


def _ln(sd, prefix, x, eps):
    return F.layer_norm(x, x.shape[-1:], sd[f"{prefix}.weight"], sd[f"{prefix}.bias"], eps)


def attention(sd, prefix, x, heads, window, pretrained_window, mask):
    """timm 0.6's SwinV2 ``WindowAttention`` on windows [B_, w^2, C]."""
    b, n, c = x.shape
    q_bias, v_bias = sd[f"{prefix}.q_bias"], sd[f"{prefix}.v_bias"]
    bias = torch.cat((q_bias, torch.zeros_like(v_bias), v_bias))
    qkv = F.linear(x, sd[f"{prefix}.qkv.weight"], bias)
    q, k, v = qkv.reshape(b, n, 3, heads, -1).permute(2, 0, 3, 1, 4).unbind(0)
    attn = F.normalize(q, dim=-1) @ F.normalize(k, dim=-1).transpose(-2, -1)
    attn = attn * torch.clamp(sd[f"{prefix}.logit_scale"], max=math.log(1.0 / 0.01)).exp()
    table = coords_table(window, pretrained_window).to(x.device)
    hidden = torch.relu(F.linear(table, sd[f"{prefix}.cpb_mlp.0.weight"],
                                 sd[f"{prefix}.cpb_mlp.0.bias"]))
    bias_table = F.linear(hidden, sd[f"{prefix}.cpb_mlp.2.weight"]).view(-1, heads)
    rel = bias_table[position_index(window).to(x.device).view(-1)].view(n, n, -1)
    attn = attn + (16 * torch.sigmoid(rel.permute(2, 0, 1).contiguous()))[None]
    if mask is not None:
        nw = mask.shape[0]
        attn = (attn.view(b // nw, nw, heads, n, n) + mask[None, :, None]).view(-1, heads, n, n)
    attn = torch.softmax(attn, dim=-1)
    return F.linear((attn @ v).transpose(1, 2).reshape(b, n, c), sd[f"{prefix}.proj.weight"],
                    sd[f"{prefix}.proj.bias"])


def block(sd, cfg, i, j, x):
    """Block ``j`` of stage ``i`` on tokens [B, L, C]."""
    b_ = f"{M}.layers.{i}.blocks.{j}"
    g, eps = grids(cfg)[i], cfg["layer_norm_eps"]
    window, shift = windowing(cfg, i, j)
    b, length, c = x.shape
    y = x.view(b, g, g, c)
    if shift:
        y = torch.roll(y, shifts=(-shift, -shift), dims=(1, 2))
    y = partition(y, window).view(-1, window * window, c)
    mask = shift_mask(g, window, shift).to(x.device) if shift else None
    y = attention(sd, f"{b_}.attn", y, cfg["num_heads"][i], window,
                  cfg["pretrained_window_sizes"][i], mask)
    y = reverse(y.view(-1, window, window, c), window, g, g)
    if shift:
        y = torch.roll(y, shifts=(shift, shift), dims=(1, 2))
    x = x + _ln(sd, f"{b_}.norm1", y.reshape(b, length, c), eps)
    h = F.gelu(F.linear(x, sd[f"{b_}.mlp.fc1.weight"], sd[f"{b_}.mlp.fc1.bias"]))
    h = F.linear(h, sd[f"{b_}.mlp.fc2.weight"], sd[f"{b_}.mlp.fc2.bias"])
    return x + _ln(sd, f"{b_}.norm2", h, eps)


def merge(sd, cfg, i, x):
    """PatchMerging after stage ``i``."""
    g = grids(cfg)[i]
    b, _, c = x.shape
    x = x.view(b, g, g, c)
    x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
    d = f"{M}.layers.{i}.downsample"
    x = F.linear(x.view(b, -1, 4 * c), sd[f"{d}.reduction.weight"])
    return _ln(sd, f"{d}.norm", x, cfg["layer_norm_eps"])


def encoder(sd, x, cfg) -> list[torch.Tensor]:
    """The four NCHW maps of normalised NCHW ``x`` (``net_size`` square)."""
    t = F.conv2d(x, sd[f"{M}.patch_embed.proj.weight"], sd[f"{M}.patch_embed.proj.bias"],
                 stride=cfg["patch_size"])
    t = _ln(sd, f"{M}.patch_embed.norm", t.flatten(2).transpose(1, 2), cfg["layer_norm_eps"])
    maps = []
    for i, depth in enumerate(cfg["depths"]):
        for j in range(depth):
            t = block(sd, cfg, i, j, t)
            if j == cfg["hooks"][i]:
                g = grids(cfg)[i]
                maps.append(t.transpose(1, 2).unflatten(2, (g, g)))
        if i < len(cfg["depths"]) - 1:
            t = merge(sd, cfg, i, t)
    return maps


def forward(sd, x, cfg, relu=True):
    """Inverse depth [N, H, W] of normalised NCHW ``x`` (``net_size``
    square), float32 in the flags the caller set; ``relu=False`` stops
    before the final ReLU."""
    rn = [_conv(sd, f"scratch.layer{k + 1}_rn", y, padding=1)
          for k, y in enumerate(encoder(sd, x, cfg))]
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
    with precision_flags(precision):
        x = img01_hwc.float().permute(2, 0, 1)[None]
        x = F.interpolate(x, size=transform_size(h, w, cfg), mode="bicubic", align_corners=False)
        pred = forward(sd, ((x - MEAN) / STD).contiguous(), cfg)
        return F.interpolate(pred[:, None], size=(h, w), mode="bicubic",
                             align_corners=False)[0, 0]
