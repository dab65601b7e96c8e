"""DPT-Large (MiDaS v3.0) monocular depth estimation: the torch hub's
``intel-isl/MiDaS`` ``DPT_Large`` (Ranftl, Bochkovskiy and Koltun, "Vision
Transformers for Dense Prediction", arXiv:2103.13413;
``dpt_large-midas-2f21e586.pt``), the hub's highest-accuracy depth model
under the API that ``MiDaS_small`` (``models.midas``) shares.

* Encoder: ViT-L/16 in timm's ``vit_large_patch16_384`` layout: a 16x16
  stride-16 patch conv from 3 to 1024 channels, a class token prepended,
  the learned 24x24 position grid resized bilinearly to the input's grid
  (DPT's ``_resize_pos_embed``; the class token's position kept), then 24
  pre-LN blocks: LayerNorm (eps 1e-6), 16-head self-attention of head
  width 64 with a qkv bias, LayerNorm, an MLP of 4096 with exact GELU.
* Reassemble: the tokens after blocks 5, 11, 17 and 23 (0-based); each
  patch token concatenated with the class token, ``Linear(2048, 1024)``
  and GELU (readout "project"), unflattened to the grid, a 1x1 conv to
  256, 512, 1024 and 1024 channels, then a 4x4/4 transposed conv, a 2x2/2
  transposed conv, nothing, and a 3x3/2 conv.
* Decoder: ``scratch.layer{1..4}_rn`` (3x3 to 256, no bias), the four
  fusion blocks of ``models.midas`` (bn off, ``expand=False``,
  ``align_corners=True``) and the head: 3x3 256->128, 2x bilinear
  (align_corners), 3x3 128->32, ReLU, 1x1 to 1, ReLU (``non_negative``).

Parameter and buffer names are the hub's state dict's, so a hub ``.pt``
loads with ``load_state_dict(strict=True)`` (``dpt_from_state_dict``, read
with ``weights_only``). timm's final ``norm`` and classifier ``head`` are
held and never run: the hooks read the blocks' outputs, and the hub's
forward discards what the final norm gives. Every conv runs under
``fp32_convs`` and every matmul under ``fp32_matmuls`` (TF32 off). The
attention is written out as timm computes it (``(q @ k^T) * d^-1/2``,
softmax, ``@ v``), not ``F.scaled_dot_product_attention``, whose fused fp32
kernels may multiply on the tensor cores at a lower precision.

Input ``[N, H, W, 3]`` in [0, 1] with H and W multiples of 32 (the
estimator resizes to them as the hub's ``dpt_transform`` does); output
``[N, H, W]`` inverse depth (proximity, larger = closer).

Spans (``utils.profiling``, recorded under a profiler only):
``dpt.forward`` over ``dpt.embed`` (normalise, patch conv, class token,
positions), ``dpt.encoder`` (the blocks), ``dpt.reassemble`` (readouts,
the four reassemble chains, ``layer*_rn``), ``dpt.fusion`` (the four
fusion blocks) and ``dpt.head``; on a card ``dpt.forward`` and
``dpt.encoder`` also time their device work with CUDA events. Counter
``dpt.tokens``: tokens a forward (class tokens included).
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from aip_tpu_torch.device import fp32_convs, fp32_matmuls, resolve_device
from aip_tpu_torch.models.midas import _FeatureFusion, _to_image
from aip_tpu_torch.utils.profiling import count, span

MEAN = 0.5
STD = 0.5
CALIBRATION_HW = (192, 256)   # the seeded init's calibration image
PASS_SHARE = 0.9              # of its pixels the output ReLU passes


@dataclasses.dataclass(frozen=True)
class DPTConfig:
    """The sizes of a DPT with a ViT encoder; the defaults are DPT-Large's.
    Field names follow the benchmark's configuration file."""

    patch_size: int = 16
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    layer_norm_eps: float = 1e-6
    pos_grid: int = 24                     # 384 / 16: the trained position grid
    hooks: tuple = (5, 11, 17, 23)
    reassemble_widths: tuple = (256, 512, 1024, 1024)
    features: int = 256
    head_features: int = 32
    num_classes: int = 1000                # timm's classifier, held, never run
    net_size: int = 384
    multiple_of: int = 32
    keep_aspect_ratio: bool = True


DPT_LARGE = DPTConfig()


class _Attention(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, n, c = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.heads, c // self.heads).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = (q @ k.transpose(-2, -1)) * (c // self.heads) ** -0.5
        x = (attn.softmax(dim=-1) @ v).transpose(1, 2).reshape(b, n, c)
        return self.proj(x)


class _Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class _Block(nn.Module):
    """timm's pre-LN ViT block."""

    def __init__(self, cfg: DPTConfig):
        super().__init__()
        self.norm1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.attn = _Attention(cfg.hidden_size, cfg.num_attention_heads)
        self.norm2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = _Mlp(cfg.hidden_size, cfg.intermediate_size)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class _ViT(nn.Module):
    """timm ``VisionTransformer``'s parameters: ``patch_embed.proj``,
    ``cls_token``, ``pos_embed``, ``blocks``, ``norm``, ``head``."""

    def __init__(self, cfg: DPTConfig):
        super().__init__()
        h = cfg.hidden_size
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, h, cfg.patch_size, stride=cfg.patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, h))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + cfg.pos_grid ** 2, h))
        self.blocks = nn.ModuleList(_Block(cfg) for _ in range(cfg.num_hidden_layers))
        self.norm = nn.LayerNorm(h, eps=cfg.layer_norm_eps)
        self.head = nn.Linear(h, cfg.num_classes)


class _Readout(nn.Module):
    """DPT's ``ProjectReadout``: [patch tokens, class token] -> Linear, GELU."""

    def __init__(self, dim):
        super().__init__()
        self.project = nn.Sequential(nn.Linear(2 * dim, dim), nn.GELU())

    def forward(self, x):
        tokens = x[:, 1:]
        return self.project(torch.cat([tokens, x[:, :1].expand_as(tokens)], dim=-1))


def _postprocess(k: int, dim: int, width: int) -> nn.Sequential:
    """``act_postprocess{k + 1}``: 0 the readout, 1-2 the hub's Transpose and
    Unflatten (no parameters), 3 the 1x1 conv, 4 the resampling (none for
    the third hook)."""
    mods = [_Readout(dim), nn.Identity(), nn.Identity(), nn.Conv2d(dim, width, 1)]
    if k == 0:
        mods.append(nn.ConvTranspose2d(width, width, 4, stride=4))
    elif k == 1:
        mods.append(nn.ConvTranspose2d(width, width, 2, stride=2))
    elif k == 3:
        mods.append(nn.Conv2d(width, width, 3, stride=2, padding=1))
    return nn.Sequential(*mods)


def resize_pos_embed(pos_embed: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    """DPT's ``_resize_pos_embed``: the square position grid resized
    bilinearly (align_corners=False) to ``gh`` x ``gw``, the class token's
    position kept in front. [1, 1 + g^2, C] -> [1, 1 + gh * gw, C]."""
    tok, grid = pos_embed[:, :1], pos_embed[0, 1:]
    g = int(math.isqrt(grid.shape[0]))
    grid = grid.reshape(1, g, g, -1).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, size=(gh, gw), mode="bilinear", align_corners=False)
    return torch.cat([tok, grid.permute(0, 2, 3, 1).reshape(1, gh * gw, -1)], dim=1)


def make_scratch(in_widths, features: int, head_features: int) -> nn.Module:
    """The hub's ``scratch``, the decoder every DPT here shares:
    ``layer{1..4}_rn`` (3x3 from ``in_widths`` to ``features``, no bias), the
    fusion blocks ``refinenet1..4`` and the ``non_negative`` head
    ``output_conv``."""
    sc = nn.Module()
    for k, width in enumerate(in_widths):
        setattr(sc, f"layer{k + 1}_rn", nn.Conv2d(width, features, 3, padding=1, bias=False))
    for k in range(4):
        setattr(sc, f"refinenet{k + 1}", _FeatureFusion(features, expand=False))
    # Hub indices: 0 conv f -> f/2, 1 Interpolate(x2, align_corners), 2
    # conv f/2 -> 32, 3 ReLU, 4 conv 32 -> 1, 5 ReLU, 6 Identity.
    sc.output_conv = nn.Sequential(
        nn.Conv2d(features, features // 2, 3, padding=1), nn.Identity(),
        nn.Conv2d(features // 2, head_features, 3, padding=1), nn.ReLU(),
        nn.Conv2d(head_features, 1, 1), nn.ReLU(), nn.Identity())
    return sc


class DPTBase(nn.Module):
    """The hub's ``DPT.forward``, which every encoder here feeds: the
    encoder subclass gives ``_tokens`` (the ``dpt.tokens`` count),
    ``_embed``, ``_encode`` (the hooked taps) and ``_reassemble`` (four NCHW
    maps at strides 4, 8, 16 and 32 of the input); ``scratch``
    (``make_scratch``) decodes them."""

    def _head0(self, conv, y):
        """The head's first conv (``features`` -> half, 3x3) on the last
        fusion block's output."""
        return conv(y)

    def forward(self, x01: torch.Tensor, relu: bool = True) -> torch.Tensor:
        """[N, H, W, 3] in [0, 1] -> [N, H, W] inverse depth; ``relu=False``
        gives the last conv's output before the final ReLU (the seeded
        init's calibration reads it)."""
        sc = self.scratch
        n, hgt, wid, _ = x01.shape
        with span("dpt.forward", device=x01), fp32_convs(), fp32_matmuls():
            count("dpt.tokens", self._tokens(n, hgt, wid))
            with span("dpt.embed"):
                t = self._embed(x01)
            with span("dpt.encoder", device=x01):
                taps = self._encode(t, x01)
            with span("dpt.reassemble"):
                rn = [getattr(sc, f"layer{k + 1}_rn")(y)
                      for k, y in enumerate(self._reassemble(taps, hgt, wid))]
            with span("dpt.fusion"):
                y = sc.refinenet4(rn[3])
                y = sc.refinenet3(y, rn[2])
                y = sc.refinenet2(y, rn[1])
                y = sc.refinenet1(y, rn[0])
            with span("dpt.head"):
                head = sc.output_conv
                y = self._head0(head[0], y)
                y = F.interpolate(y, scale_factor=2, mode="bilinear", align_corners=True)
                y = head[4](torch.relu(head[2](y)))
                if relu:
                    y = torch.relu(y)
        return y[:, 0]


class DPT(DPTBase):
    """Hub ``DPTDepthModel(backbone="vitl16_384", non_negative=True)`` with
    the hub's key layout (``config`` sets the sizes; the default is
    DPT-Large). Weights are whatever the constructor drew until filled: use
    ``init_dpt_params`` or ``dpt_from_state_dict``."""

    def __init__(self, config: DPTConfig = DPT_LARGE):
        super().__init__()
        self.config = cfg = config
        h = cfg.hidden_size
        self.pretrained = nn.Module()
        self.pretrained.model = _ViT(cfg)
        for k, width in enumerate(cfg.reassemble_widths):
            setattr(self.pretrained, f"act_postprocess{k + 1}", _postprocess(k, h, width))
        self.scratch = make_scratch(cfg.reassemble_widths, cfg.features, cfg.head_features)
        self.eval()

    def _tokens(self, n, hgt, wid):
        p = self.config.patch_size
        return n * (1 + (hgt // p) * (wid // p))

    def _embed(self, x01):
        vit, p = self.pretrained.model, self.config.patch_size
        n, hgt, wid, _ = x01.shape
        # NCHW-contiguous: cuDNN's fp32 convs on a permuted NHWC view take
        # a slow direct kernel (models/deeplab.py).
        x = ((x01 - MEAN) / STD).permute(0, 3, 1, 2).contiguous()
        t = vit.patch_embed.proj(x).flatten(2).transpose(1, 2)
        t = torch.cat([vit.cls_token.expand(n, -1, -1), t], dim=1)
        return t + resize_pos_embed(vit.pos_embed, hgt // p, wid // p)

    def _encode(self, t, x01):
        hooks, taps = self.config.hooks, []
        for i, block in enumerate(self.pretrained.model.blocks[:max(hooks) + 1]):
            t = block(t)
            if i in hooks:
                taps.append(t)
        return taps

    def _reassemble(self, taps, hgt, wid):
        gh, gw = hgt // self.config.patch_size, wid // self.config.patch_size
        out = []
        for k, tokens in enumerate(taps):
            post = getattr(self.pretrained, f"act_postprocess{k + 1}")
            y = post[0](tokens)
            y = y.transpose(1, 2).reshape(y.shape[0], y.shape[2], gh, gw).contiguous()
            for mod in post[3:]:
                y = mod(y)
            out.append(y)
        return out


def transform_size(h: int, w: int, config: DPTConfig = DPT_LARGE) -> tuple[int, int]:
    """The hub's ``Resize(384, 384, keep_aspect_ratio=...,
    ensure_multiple_of=32, resize_method="minimal")``: with
    ``config.keep_aspect_ratio`` the one scale of the two sides' that lies
    nearer 1, else each side's own (a square ``net_size`` input); each side
    then rounded (half to even) to a multiple of 32, never below one
    multiple."""
    m = config.multiple_of
    scale_h, scale_w = config.net_size / h, config.net_size / w
    if config.keep_aspect_ratio:
        scale_h = scale_w = scale_w if abs(1 - scale_w) < abs(1 - scale_h) else scale_h
    return tuple(max(m, int(np.round(scale * s / m)) * m)
                 for scale, s in ((scale_h, h), (scale_w, w)))


def make_depth_estimator(net: DPTBase):
    """fn(img HWC [0,1] or uint8, numpy or tensor) -> [H, W] proximity on the
    weights' device: the hub's transform of ``net`` (``dpt_transform`` or
    ``swin384_transform``: bicubic to ``transform_size``, mean and std 0.5)
    and its post-processing (bicubic back to the input's size). The resizes
    are ``ops.image.resize_bicubic`` (``F.interpolate``'s bicubic, a=-0.75)
    where the hub resizes the input with cv2's INTER_CUBIC (the same kernel
    and centres, in float64)."""
    from aip_tpu_torch.ops.image import resize_bicubic

    device = next(net.parameters()).device

    @torch.no_grad()
    def depth(img):
        x = _to_image(img, device)
        h, w = x.shape[0], x.shape[1]
        with fp32_matmuls():
            pred = net(resize_bicubic(x[None], transform_size(h, w, net.config)))
            count("depth.network_calls", 1)
            return resize_bicubic(pred[0][:, :, None], (h, w))[:, :, 0]

    return depth


def dpt_from_state_dict(state_dict: dict, device=None, config: DPTConfig | None = None) -> DPT:
    """A ``DPT`` on ``device`` holding a hub-layout state dict (strict). The
    module is built on the meta device and takes the arrays as they are,
    so nothing is drawn or copied on the host."""
    with torch.device("meta"):
        net = DPT(config or DPT_LARGE)
    net.load_state_dict({k: torch.from_numpy(np.asarray(a)) for k, a in state_dict.items()},
                        strict=True, assign=True)
    return net.to(resolve_device(device)).requires_grad_(False)


def calibration_image(generator: torch.Generator, hw=CALIBRATION_HW) -> torch.Tensor:
    """A smooth seeded [1, H, W, 3] image in [0, 1] at ``hw``: 6 x 8 uniform
    noise resized bicubically, plus fine noise."""
    low = torch.rand((1, 3, 6, 8), generator=generator)
    img = F.interpolate(low, size=tuple(hw), mode="bicubic", align_corners=False)
    img = img + 0.05 * torch.randn((1, 3, *hw), generator=generator)
    return img.clamp(0.0, 1.0).permute(0, 2, 3, 1).contiguous()


@torch.no_grad()
def calibrate_last_bias(net: DPTBase, img: torch.Tensor) -> DPTBase:
    """Set the last conv's bias so that the output ReLU passes
    ``PASS_SHARE`` of ``img``'s pixels: without it a seeded network's
    proximity is flat over large regions and the strength map says
    nothing."""
    last = net.scratch.output_conv[4]
    last.bias.zero_()
    pre = net(img.to(last.bias.device), relu=False).flatten()
    k = max(1, int(round((1.0 - PASS_SHARE) * pre.numel())))
    last.bias.fill_(-torch.kthvalue(pre.cpu(), k).values.item())
    return net


@torch.no_grad()
def draw_dpt_params(generator: torch.Generator, config: DPTConfig | None = None) -> DPT:
    """A DPT on the CPU drawn from ``generator`` with timm's ViT init:
    Linear weights truncated-normal of std 0.02 and biases 0, LayerNorm 1
    and 0, ``pos_embed`` std 0.02, ``cls_token`` std 1e-6; convs (transposed
    ones too) PyTorch's defaults (kaiming-uniform with a = sqrt(5), bias
    uniform within 1 / sqrt(fan_in))."""
    with torch.device("meta"):
        net = DPT(config or DPT_LARGE)
    net.to_empty(device="cpu")
    for m in net.modules():
        if isinstance(m, nn.Linear):
            nn.init.trunc_normal_(m.weight, std=0.02, a=-2.0, b=2.0, generator=generator)
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
        elif isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5), generator=generator)
            if m.bias is not None:
                fan_in = nn.init._calculate_fan_in_and_fan_out(m.weight)[0]
                nn.init.uniform_(m.bias, -fan_in ** -0.5, fan_in ** -0.5, generator=generator)
    vit = net.pretrained.model
    nn.init.trunc_normal_(vit.pos_embed, std=0.02, a=-2.0, b=2.0, generator=generator)
    nn.init.normal_(vit.cls_token, std=1e-6, generator=generator)
    return net.requires_grad_(False)


@torch.no_grad()
def init_dpt_params(generator: torch.Generator | None = None, device=None,
                    config: DPTConfig | None = None) -> DPT:
    """``draw_dpt_params`` from ``generator`` (seed 0 when None), moved to
    ``device``; then ``calibrate_last_bias`` on the generator's next
    ``calibration_image``."""
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    net = draw_dpt_params(gen, config).to(resolve_device(device))
    return calibrate_last_bias(net, calibration_image(gen))


def get_dpt_params(torch_path=None, device=None, config: DPTConfig | None = None) -> DPT:
    """A hub ``dpt_large-midas-2f21e586.pt`` state dict (read with
    ``weights_only``), else ``init_dpt_params`` from seed 0. A path that is
    no real checkpoint (missing, or a git-LFS pointer) raises."""
    from aip_tpu_torch.models import weights as weights_mod

    if torch_path is None:
        return init_dpt_params(device=device, config=config)
    path = Path(torch_path)
    if not weights_mod._is_real_checkpoint(path):
        raise FileNotFoundError(f"no DPT checkpoint at {path} (missing, or a git-LFS pointer)")
    return dpt_from_state_dict(weights_mod._load_torch_state_dict(path), device, config)
