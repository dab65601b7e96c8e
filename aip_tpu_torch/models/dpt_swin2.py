"""DPT-SwinV2-L-384 (MiDaS v3.1) monocular depth estimation: the torch hub's
``intel-isl/MiDaS`` ``DPT_SwinV2_L_384`` (Birkl, Wofk and Müller, "MiDaS
v3.1 - A Model Zoo for Robust Monocular Relative Depth Estimation",
arXiv:2307.14460; MiDaS ``model_type`` ``dpt_swin2_large_384``, checkpoint
``dpt_swin2_large_384.pt``), the v3.1 encoder that shares no block with
DPT-Large's ViT-L and all of its decoder (``models.dpt.make_scratch``).

* Encoder: timm 0.6's ``swinv2_large_window12to24_192to384_22kft1k``
  (Liu et al., "Swin Transformer V2", arXiv:2111.09883): a 4x4 stride-4
  patch conv from 3 to 192 channels and a LayerNorm (no absolute position
  embedding); stages of depths (2, 2, 18, 2), widths 192/384/768/1536,
  heads 6/12/24/48 of width 32, window 24 (clamped to a smaller grid, with
  no shift then), ``pretrained_window_sizes`` (12, 12, 12, 6). Each block
  is res-post-norm, ``x + LN(attn(x))`` then ``x + LN(mlp(x))`` (MLP 4x,
  exact GELU, LayerNorm eps 1e-5), and attends within windows, shifted by
  half a window in odd blocks of a stage whose grid exceeds the window.
  The attention is cosine attention: ``qkv`` without bias plus ``q_bias``
  and ``v_bias`` (k's bias zero); ``normalize(q) @ normalize(k)^T`` times
  ``exp(clamp(logit_scale, max=log 100))``; plus the continuous position
  bias, ``16 sigmoid(cpb_mlp(table))`` gathered by the relative index (the
  table the log-spaced relative coordinates scaled by the pretrained
  window less 1, times 8, ``sign log2(|t| + 1) / log2 8``); plus the shift
  mask (-100 across a region boundary); softmax, ``@ v``, the projection.
  PatchMerging after stages 1-3: the 2x2 neighbours concatenated in timm's
  order ((0, 0), (1, 0), (0, 1), (1, 1) as (h, w) offsets), ``reduction``
  (4C -> 2C, no bias), then ``norm``.
* Taps: the outputs of ``layers[i].blocks[hooks[i]]`` (hooks (1, 1, 17, 1):
  each stage's last block, before its merge), transposed and unflattened
  to 96^2, 48^2, 24^2 and 12^2 maps; no readout, no resampling.
* Decoder: DPT-Large's (``scratch.layer{1..4}_rn`` from the four widths to
  256, the four fusion blocks, the ``non_negative`` head), each fusion
  block upsampling by 2, which at 384^2 is the hub's ``size=`` the next
  map's size.

Parameter names are the hub's state dict's, so a hub ``.pt`` loads with
``strict=True`` (``dpt_swin2_from_state_dict``, read with ``weights_only``).
timm 0.6 may also save buffers that depend on no weight
(``attn.relative_coords_table``, ``attn.relative_position_index``, the
shifted blocks' ``attn_mask``): the loader recomputes
them, checks a checkpoint's copies against them and raises on a mismatch,
and drops them. The position bias, the logit scale and the shift mask
depend on no input, so ``prepare`` computes them once the weights are set
(by the same fp32 operations timm runs each forward) and holds them as
buffers that are not saved. timm's final ``norm`` and classifier ``head``
are held and never run (the hooks read the blocks', and the hub's forward
discards the rest). Every conv runs under ``fp32_convs``, every matmul
under ``fp32_matmuls`` (TF32 off), but for the head's first conv, which on
a card takes the port's fp32 3x3 conv kernel (``_head0``); the attention is
written out with plain products as timm computes it, not
``F.scaled_dot_product_attention``.

Input ``[N, net_size, net_size, 3]`` in [0, 1] (timm's model takes only
its ``img_size``; the estimator resizes every image to it, as the hub's
``swin384_transform`` does, without keeping the aspect ratio); output
``[N, H, W]`` inverse depth (proximity, larger = closer).

Spans (``utils.profiling``, under a profiler only): ``models.dpt``'s
``dpt.forward``, ``dpt.embed`` (normalise, patch conv, LayerNorm),
``dpt.encoder`` (the stages), ``dpt.reassemble`` (the transposes and
``layer*_rn``), ``dpt.fusion``, ``dpt.head``; inside ``dpt.encoder``,
``swin2.windowed`` (the stages of more than one window, with their merges)
and ``swin2.global`` (the stages of one window over the whole grid), each
timed with CUDA events on a card. Counters ``dpt.tokens`` (stage 1's patch
tokens) and ``swin2.windows`` (windows attended, summed over blocks: 60 a
384^2 image).
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from aip_tpu_torch.device import fp32_matmuls, resolve_device
from aip_tpu_torch.kernels.conv3x3_f32 import conv3x3_f32
from aip_tpu_torch.models import swin
from aip_tpu_torch.models.dpt import (MEAN, STD, DPTBase, _Mlp, calibrate_last_bias,
                                      calibration_image, make_scratch)
from aip_tpu_torch.models.vgg import conv_pack
from aip_tpu_torch.utils.profiling import count, span

LOGIT_SCALE_MAX = math.log(100.0)    # timm: clamp(logit_scale, max=log(1 / 0.01))
# timm 0.6 buffers a checkpoint may hold, recomputed here (attn_mask is the
# block's, the rest the attention's).
RECOMPUTED = ("relative_coords_table", "relative_position_index", "attn_mask")
TABLE_TOL = 1e-6                     # the float32 log-spaced table, an ulp or so


@dataclasses.dataclass(frozen=True)
class Swin2DPTConfig:
    """The sizes of a DPT with a SwinV2 encoder; the defaults are
    DPT-SwinV2-L-384's. Field names follow the benchmark's configuration
    file."""

    patch_size: int = 4
    embed_dim: int = 192
    depths: tuple = (2, 2, 18, 2)
    num_heads: tuple = (6, 12, 24, 48)
    window_size: int = 24
    pretrained_window_sizes: tuple = (12, 12, 12, 6)
    mlp_ratio: int = 4
    layer_norm_eps: float = 1e-5
    cpb_hidden: int = 512
    hooks: tuple = (1, 1, 17, 1)
    features: int = 256
    head_features: int = 32
    num_classes: int = 1000                # timm's classifier, held, never run
    net_size: int = 384
    multiple_of: int = 32
    keep_aspect_ratio: bool = False

    @property
    def widths(self) -> tuple:
        return tuple(self.embed_dim * 2 ** i for i in range(len(self.depths)))

    @property
    def grids(self) -> tuple:
        """Each stage's token grid side at ``net_size``."""
        g = self.net_size // self.patch_size
        return tuple(g // 2 ** i for i in range(len(self.depths)))


DPT_SWIN2_L_384 = Swin2DPTConfig()


def relative_coords_table(window: int, pretrained_window: int) -> torch.Tensor:
    """timm's ``relative_coords_table`` [1, 2w - 1, 2w - 1, 2], float32: the
    relative coordinates over (pretrained window - 1), times 8, then
    ``sign(t) log2(|t| + 1) / log2(8)``."""
    r = torch.arange(-(window - 1), window, dtype=torch.float32)
    table = torch.stack(torch.meshgrid([r, r], indexing="ij")).permute(1, 2, 0).contiguous()[None]
    table = table / (pretrained_window - 1) * 8
    return torch.sign(table) * torch.log2(torch.abs(table) + 1.0) / math.log2(8)


class _WindowAttention(nn.Module):
    """timm 0.6's SwinV2 ``WindowAttention`` (see the module docstring)."""

    def __init__(self, dim, heads, window, pretrained_window, cpb_hidden):
        super().__init__()
        self.heads, self.window, self.pretrained_window = heads, window, pretrained_window
        self.logit_scale = nn.Parameter(torch.log(10 * torch.ones(heads, 1, 1)))
        self.cpb_mlp = nn.Sequential(nn.Linear(2, cpb_hidden), nn.ReLU(),
                                     nn.Linear(cpb_hidden, heads, bias=False))
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.v_bias = nn.Parameter(torch.zeros(dim))
        self.proj = nn.Linear(dim, dim)

    @torch.no_grad()
    def prepare(self):
        """The position bias [heads, w^2, w^2] and the logit scale
        [heads, 1, 1], from the weights as they are, as buffers not saved."""
        dev = self.logit_scale.device
        table = relative_coords_table(self.window, self.pretrained_window).to(dev)
        index = torch.from_numpy(swin._rel_index(self.window)).to(dev)
        n = self.window ** 2
        with fp32_matmuls():
            bias = self.cpb_mlp(table).view(-1, self.heads)[index.view(-1)].view(n, n, -1)
        self.register_buffer("pos_bias", 16 * torch.sigmoid(bias.permute(2, 0, 1).contiguous()),
                             persistent=False)
        self.register_buffer("scale", torch.clamp(self.logit_scale, max=LOGIT_SCALE_MAX).exp(),
                             persistent=False)

    def forward(self, x, mask=None):
        b, n, c = x.shape
        bias = torch.cat([self.q_bias, torch.zeros_like(self.q_bias), self.v_bias])
        qkv = F.linear(x, self.qkv.weight, bias).reshape(b, n, 3, self.heads, -1)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        attn = F.normalize(q, dim=-1) @ F.normalize(k, dim=-1).transpose(-2, -1)
        attn = attn * self.scale
        attn = attn + self.pos_bias[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.view(b // nw, nw, self.heads, n, n) + mask[None, :, None]
            attn = attn.view(-1, self.heads, n, n)
        x = (attn.softmax(dim=-1) @ v).transpose(1, 2).reshape(b, n, c)
        return self.proj(x)


class _Block(nn.Module):
    """timm 0.6's SwinV2 ``SwinTransformerBlock`` on a ``grid`` x ``grid``
    token map: the window clamped to the grid, no shift where it covers
    it."""

    def __init__(self, cfg: Swin2DPTConfig, dim, heads, grid, shifted, pretrained_window):
        super().__init__()
        self.grid = grid
        self.window = min(cfg.window_size, grid)
        self.shift = cfg.window_size // 2 if shifted and grid > self.window else 0
        self.windows = (grid // self.window) ** 2
        self.attn = _WindowAttention(dim, heads, self.window, pretrained_window, cfg.cpb_hidden)
        self.norm1 = nn.LayerNorm(dim, eps=cfg.layer_norm_eps)
        self.mlp = _Mlp(dim, cfg.mlp_ratio * dim)
        self.norm2 = nn.LayerNorm(dim, eps=cfg.layer_norm_eps)

    def prepare(self):
        self.attn.prepare()
        mask = None
        if self.shift:
            mask = swin._shift_mask(self.grid, self.grid, self.shift, self.shift,
                                    self.attn.logit_scale.device, self.window)
        self.register_buffer("shift_mask", mask, persistent=False)

    def forward(self, x):
        n, length, c = x.shape
        g, w, s = self.grid, self.window, self.shift
        xw, dims = swin._window_partition(x.view(n, g, g, c), s, s, w)
        y = self.attn(xw, self.shift_mask)
        y = swin._window_reverse(y, dims, g, g, c, s, s, w).reshape(n, length, c)
        x = x + self.norm1(y)
        return x + self.norm2(self.mlp(x))


class _PatchMerging(nn.Module):
    """timm 0.6's SwinV2 ``PatchMerging``: 2x2 neighbours concatenated,
    ``reduction`` (no bias), then ``norm``."""

    def __init__(self, dim, eps):
        super().__init__()
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(2 * dim, eps=eps)

    def forward(self, x, grid):
        n, _, c = x.shape
        x = x.view(n, grid, grid, c)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      dim=-1)
        return self.norm(self.reduction(x.view(n, -1, 4 * c)))


class _Stage(nn.Module):
    """timm 0.6's SwinV2 ``BasicLayer``: ``blocks``, then ``downsample``
    (none after the last stage)."""

    def __init__(self, cfg: Swin2DPTConfig, i: int):
        super().__init__()
        dim, grid = cfg.widths[i], cfg.grids[i]
        self.grid = grid
        self.blocks = nn.ModuleList(
            _Block(cfg, dim, cfg.num_heads[i], grid, j % 2 == 1, cfg.pretrained_window_sizes[i])
            for j in range(cfg.depths[i]))
        if i < len(cfg.depths) - 1:
            self.downsample = _PatchMerging(dim, cfg.layer_norm_eps)


class _SwinV2(nn.Module):
    """timm 0.6 ``SwinTransformerV2``'s parameters: ``patch_embed.{proj,
    norm}``, ``layers``, ``norm``, ``head``."""

    def __init__(self, cfg: Swin2DPTConfig):
        super().__init__()
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, cfg.embed_dim, cfg.patch_size, stride=cfg.patch_size)
        self.patch_embed.norm = nn.LayerNorm(cfg.embed_dim, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(_Stage(cfg, i) for i in range(len(cfg.depths)))
        self.norm = nn.LayerNorm(cfg.widths[-1], eps=cfg.layer_norm_eps)
        self.head = nn.Linear(cfg.widths[-1], cfg.num_classes)


class DPTSwin2(DPTBase):
    """Hub ``DPTDepthModel(backbone="swin2l24_384", non_negative=True)`` with
    the hub's key layout (``config`` sets the sizes; the default is
    DPT-SwinV2-L-384). Weights are whatever the constructor drew until
    filled: use ``init_dpt_swin2_params`` or ``dpt_swin2_from_state_dict``,
    which call ``prepare``."""

    def __init__(self, config: Swin2DPTConfig = DPT_SWIN2_L_384):
        super().__init__()
        self.config = cfg = config
        self.pretrained = nn.Module()
        self.pretrained.model = _SwinV2(cfg)
        self.scratch = make_scratch(cfg.widths, cfg.features, cfg.head_features)
        self.eval()

    def blocks(self):
        return [b for stage in self.pretrained.model.layers for b in stage.blocks]

    def prepare(self) -> DPTSwin2:
        """Compute each block's position bias, logit scale and shift mask
        from the weights on their device (call again after changing them)."""
        for block in self.blocks():
            block.prepare()
        return self

    def recomputed_buffers(self) -> dict:
        """{key: tensor on the CPU} of the timm 0.6 buffers a hub checkpoint
        may hold, as timm computes them."""
        out = {}
        for i, stage in enumerate(self.pretrained.model.layers):
            for j, b in enumerate(stage.blocks):
                key = f"pretrained.model.layers.{i}.blocks.{j}"
                w = b.window
                out[f"{key}.attn.relative_coords_table"] = relative_coords_table(
                    w, b.attn.pretrained_window)
                out[f"{key}.attn.relative_position_index"] = torch.from_numpy(swin._rel_index(w))
                if b.shift:
                    out[f"{key}.attn_mask"] = swin._shift_mask(b.grid, b.grid, b.shift, b.shift,
                                                               "cpu", w)
        return out

    def _tokens(self, n, hgt, wid):
        p = self.config.patch_size
        return n * (hgt // p) * (wid // p)

    def _embed(self, x01):
        size = self.config.net_size
        if tuple(x01.shape[1:3]) != (size, size):
            raise ValueError(f"DPT-SwinV2 takes {size} x {size} inputs (timm's img_size), not "
                             f"{tuple(x01.shape[1:3])}")
        pe = self.pretrained.model.patch_embed
        x = ((x01 - MEAN) / STD).permute(0, 3, 1, 2).contiguous()
        return pe.norm(pe.proj(x).flatten(2).transpose(1, 2))

    def _encode(self, t, x01):
        stages, hooks = self.pretrained.model.layers, self.config.hooks
        windowed = sum(stage.blocks[0].windows > 1 for stage in stages)
        taps = []
        for name, part in (("swin2.windowed", range(windowed)),
                           ("swin2.global", range(windowed, len(stages)))):
            with span(name, device=x01):
                for i in part:
                    stage = stages[i]
                    for j, block in enumerate(stage.blocks):
                        count("swin2.windows", t.shape[0] * block.windows)
                        t = block(t)
                        if j == hooks[i]:
                            taps.append(t)
                    if hasattr(stage, "downsample"):
                        t = stage.downsample(t, stage.grid)
        return taps

    def _head0(self, conv, y):
        """The head's first conv, 256 -> 128 3x3 at 192^2: on a card the
        port's fp32 3x3 conv (``kernels.conv3x3_f32``: three TF32 products,
        fp32-accurate) on the zero-bordered NHWC map, where cuDNN's fp32
        heuristic picks at this one shape an FFT conv of ~33,000 launches
        (a forward took 270 ms with it on an H100, 22 ms without); on the
        CPU its plain version, ``F.conv2d``. The bias is added after."""
        x = F.pad(y, (1, 1, 1, 1)).permute(0, 2, 3, 1)
        out = conv3x3_f32(x, conv.weight, conv_pack(conv) if x.is_cuda else None)
        return (out + conv.bias).permute(0, 3, 1, 2).contiguous()

    def _reassemble(self, taps, hgt, wid):
        return [tap.transpose(1, 2).reshape(tap.shape[0], tap.shape[2], g, g).contiguous()
                for tap, g in zip(taps, self.config.grids)]


def dpt_swin2_from_state_dict(state_dict: dict, device=None,
                              config: Swin2DPTConfig | None = None) -> DPTSwin2:
    """A ``DPTSwin2`` on ``device`` holding a hub-layout state dict (strict),
    prepared. The module is built on the meta device and takes the arrays
    as they are. The recomputed timm buffers a checkpoint may hold are
    checked against their recomputed values (the table within
    ``TABLE_TOL``, the rest exactly) and dropped; one that differs, or has
    no counterpart here, raises."""
    with torch.device("meta"):
        net = DPTSwin2(config or DPT_SWIN2_L_384)
    want = net.recomputed_buffers()
    sd = {}
    for key, a in state_dict.items():
        t = torch.from_numpy(np.asarray(a))
        if key.rsplit(".", 1)[-1] not in RECOMPUTED:
            sd[key] = t
            continue
        ref = want.get(key)
        tol = TABLE_TOL if key.endswith("relative_coords_table") else 0.0
        if ref is None or t.shape != ref.shape or not bool(
                ((t.double() - ref.double()).abs() <= tol).all()):
            raise ValueError(f"the checkpoint's {key} is not timm's recomputed buffer")
    net.load_state_dict(sd, strict=True, assign=True)
    return net.to(resolve_device(device)).requires_grad_(False).prepare()


@torch.no_grad()
def draw_dpt_swin2_params(generator: torch.Generator,
                          config: Swin2DPTConfig | None = None) -> DPTSwin2:
    """A DPTSwin2 on the CPU drawn from ``generator`` with timm's SwinV2
    init, not prepared: Linear weights truncated-normal of std 0.02 and
    biases 0, LayerNorm 1 and 0 (timm's ``_init_respostnorm`` zeroes the
    blocks' norms, which makes every block the identity: a trained
    network's are not), ``logit_scale`` log 10, ``q_bias`` and ``v_bias`` 0;
    convs PyTorch's defaults (kaiming-uniform with a = sqrt(5), bias uniform
    within 1 / sqrt(fan_in))."""
    with torch.device("meta"):
        net = DPTSwin2(config or DPT_SWIN2_L_384)
    net.to_empty(device="cpu")
    for m in net.modules():
        if isinstance(m, nn.Linear):
            nn.init.trunc_normal_(m.weight, std=0.02, a=-2.0, b=2.0, generator=generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.Conv2d):
            nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5), generator=generator)
            if m.bias is not None:
                fan_in = nn.init._calculate_fan_in_and_fan_out(m.weight)[0]
                nn.init.uniform_(m.bias, -fan_in ** -0.5, fan_in ** -0.5, generator=generator)
        elif isinstance(m, _WindowAttention):
            m.logit_scale.fill_(math.log(10.0))
            nn.init.zeros_(m.q_bias)
            nn.init.zeros_(m.v_bias)
    return net.requires_grad_(False)


@torch.no_grad()
def init_dpt_swin2_params(generator: torch.Generator | None = None, device=None,
                          config: Swin2DPTConfig | None = None) -> DPTSwin2:
    """``draw_dpt_swin2_params`` from ``generator`` (seed 0 when None), moved
    to ``device`` and prepared; then ``calibrate_last_bias`` on the
    generator's next ``calibration_image`` at the network's input size."""
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    cfg = config or DPT_SWIN2_L_384
    net = draw_dpt_swin2_params(gen, cfg).to(resolve_device(device)).prepare()
    return calibrate_last_bias(net, calibration_image(gen, (cfg.net_size, cfg.net_size)))


def get_dpt_swin2_params(torch_path=None, device=None,
                         config: Swin2DPTConfig | None = None) -> DPTSwin2:
    """A hub ``dpt_swin2_large_384.pt`` state dict (read with
    ``weights_only``), else ``init_dpt_swin2_params`` from seed 0. A path
    that is no real checkpoint (missing, or a git-LFS pointer) raises."""
    from aip_tpu_torch.models import weights as weights_mod

    if torch_path is None:
        return init_dpt_swin2_params(device=device, config=config)
    path = Path(torch_path)
    if not weights_mod._is_real_checkpoint(path):
        raise FileNotFoundError(f"no DPT-SwinV2 checkpoint at {path} (missing, or a git-LFS "
                                "pointer)")
    return dpt_swin2_from_state_dict(weights_mod._load_torch_state_dict(path), device, config)
