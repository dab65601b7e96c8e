"""Optimization-based neural style transfer (Gram-matrix NST). Port of
``aip_tpu.pipelines.nst``.

Covers three reference surfaces with one engine:
* `spatial_variation/StyleTransfer.py` — single-style NST (conv4_2 content,
  conv1_1..conv5_1 style grams, Adam lr=0.003, 800 steps, style 1e5) plus
  the color-coded-mask spatial blending of `gui/eight_page.py:68-132`;
* `mixing_texture_gyum/` — multi-style weighted Gram mixing
  (`style_mixer.py`, `neural_style_transfer.py`: 2000 steps, style 1e6);
* `gui/seven_page.py` — backbone-pluggable NST with palette post-processing
  (``pipelines.style_mixer``).

The JAX package runs optax's Adam inside one ``lax.scan``; here the loop is
Python over autograd steps, and the update is optax's Adam written out
(``gs.train.adam_update``: the same moments, bias corrections and eps 1e-8),
not ``torch.optim.Adam``, which rounds differently. Multiple styles enter as
a stacked tensor with a weight vector.

TF32: ``vgg19_std.extract_features`` holds its forward convs in fp32
(``fp32_convs``), but autograd launches the backward convs later, at the
gradient call, where PyTorch's default (``cudnn.allow_tf32`` True) would run
them in TF32; so the gradient is taken inside ``fp32_convs`` too. Every
entry point takes ``device=None`` (CUDA; raises without it).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from aip_tpu_torch.device import check_module_device, fp32_convs, resolve_device
from aip_tpu_torch.gs.train import AdamState, adam_update
from aip_tpu_torch.models import vgg19_std as backbone
from aip_tpu_torch.ops.gram import gram_matrix
from aip_tpu_torch.ops.image import (center_crop, resize_bicubic, resize_nearest,
                                     resize_smaller_edge)
from aip_tpu_torch.ops.metrics import _gaussian_window

ADAM_EPS = 1e-8  # optax.adam's default


def _style_grams(params, styles: torch.Tensor, style_layers):
    """[S, H, W, 3] normalized styles -> {layer: [S, C, C]}."""
    feats = backbone.extract_features(params, styles, style_layers)
    return {k: gram_matrix(v) for k, v in feats.items()}


def nst_targets(params, content01, styles01, style_mix_weights,
                style_layers=backbone.NST_STYLE_LAYERS,
                content_layer=backbone.NST_CONTENT_LAYER):
    """The fixed side of the loss: the normalized content image, its
    ``content_layer`` features, the styles' Gram matrices and the
    normalized mixing weights."""
    x_c = backbone.normalize_imagenet(content01)
    with torch.no_grad():
        content_feat = backbone.extract_features(params, x_c, (content_layer,))[content_layer]
        grams = _style_grams(params, backbone.normalize_imagenet(styles01), style_layers)
    wts = style_mix_weights.to(torch.float32)
    return x_c, content_feat, grams, wts / torch.sum(wts)


def nst_loss_and_grad(params, img, content_feat, grams, wts, style_weight: float = 1e5,
                      content_weight: float = 1.0, style_layers=backbone.NST_STYLE_LAYERS,
                      content_layer=backbone.NST_CONTENT_LAYER):
    """One step's loss and its gradient with respect to the normalized image
    ``img`` [1, H, W, 3], forward and backward convs in fp32."""
    img = img.detach().requires_grad_(True)
    with fp32_convs(), torch.enable_grad():
        feats = backbone.extract_features(params, img, tuple(style_layers) + (content_layer,))
        c_loss = torch.mean((feats[content_layer] - content_feat) ** 2)
        s_loss = 0.0
        for layer in style_layers:
            g = gram_matrix(feats[layer])  # [1, C, C]
            # MSE to each style's gram, weighted (style_mixer.py:38-52).
            per_style = torch.mean((g - grams[layer]) ** 2, dim=(1, 2))  # [S]
            s_loss = s_loss + torch.sum(wts * per_style)
        loss = content_weight * c_loss + style_weight * s_loss
        (grad,) = torch.autograd.grad(loss, img)
    return loss.detach(), grad


def adam_descent(img: torch.Tensor, grad_fn, num_steps: int, lr: float) -> torch.Tensor:
    """``num_steps`` steps of ``optax.adam(lr)`` on one tensor from zero
    moments; ``grad_fn(img)`` gives the gradient."""
    zeros = torch.zeros_like(img)
    state = AdamState(torch.zeros((), dtype=torch.int32, device=img.device), {"img": zeros},
                      {"img": zeros})
    for _ in range(num_steps):
        new, state = adam_update({"img": img}, {"img": grad_fn(img)}, state, {"img": lr},
                                 eps=ADAM_EPS)
        img = new["img"]
    return img


def nst_optimize(
    params,
    content01: torch.Tensor,
    styles01: torch.Tensor,
    style_mix_weights: torch.Tensor,
    num_steps: int = 800,
    lr: float = 0.003,
    style_weight: float = 1e5,
    content_weight: float = 1.0,
    style_layers: tuple = backbone.NST_STYLE_LAYERS,
    content_layer: str = backbone.NST_CONTENT_LAYER,
    device=None,
) -> torch.Tensor:
    """Optimize an image to match content features + (weighted) style grams.

    content01: [1, H, W, 3] in [0,1]; styles01: [S, Hs, Ws, 3];
    style_mix_weights: [S] (normalized internally, style_mixer.py:33-52).
    Returns the stylized image [1, H, W, 3] in [0,1].
    """
    dev = resolve_device(device)
    check_module_device(params, dev)
    content01, styles01, style_mix_weights = (
        torch.as_tensor(t).to(dev) for t in (content01, styles01, style_mix_weights))
    img, content_feat, grams, wts = nst_targets(params, content01, styles01, style_mix_weights,
                                                style_layers, content_layer)
    img = adam_descent(img, lambda x: nst_loss_and_grad(
        params, x, content_feat, grams, wts, style_weight, content_weight, style_layers,
        content_layer)[1], num_steps, lr)
    return backbone.denormalize_imagenet(img)


def run_style_transfer(
    content,
    style,
    max_dim: int = 1024,
    style_weight: float = 1e5,
    content_weight: float = 1.0,
    num_steps: int = 800,
    lr: float = 0.003,
    params=None,
    device=None,
) -> torch.Tensor:
    """Single-style NST, StyleTransfer-class parity (spatial_variation).

    content/style: HWC float [0,1] arrays (or PIL/paths via _to_array).
    Returns HWC [0,1] at the content's (possibly max_dim-capped) size.
    """
    from aip_tpu_torch.pipelines.adain_infer import _to_array

    dev = resolve_device(device)
    if params is None:
        params = backbone.get_vgg19_params(device=dev)
    c = torch.from_numpy(_to_array(content)).to(dev)
    s = torch.from_numpy(_to_array(style)).to(dev)

    def cap(img):
        h, w, _ = img.shape
        if max(h, w) > max_dim:
            r = max_dim / max(h, w)
            img = resize_bicubic(img, (int(h * r), int(w * r)))
        return img

    out = nst_optimize(
        params, cap(c)[None], cap(s)[None], torch.ones(1, device=dev),
        num_steps=num_steps, lr=lr,
        style_weight=style_weight, content_weight=content_weight, device=dev,
    )
    return out[0]


def mix_styles(
    content,
    styles_and_weights: Sequence[tuple],
    num_steps: int = 2000,
    lr: float = 0.01,
    style_weight: float = 1e6,
    content_weight: float = 1.0,
    size: int = 256,
    params=None,
    device=None,
) -> torch.Tensor:
    """Multi-style Gram mixing (mixing_texture_gyum parity).

    styles_and_weights: [(image, weight), ...]. All images resized to
    ``size`` on the smaller edge then center-cropped to ``size``.
    """
    from aip_tpu_torch.pipelines.adain_infer import _to_array

    dev = resolve_device(device)
    if params is None:
        params = backbone.get_vgg19_params(device=dev)

    def square(img):
        return center_crop(resize_smaller_edge(torch.from_numpy(_to_array(img)).to(dev), size),
                           size)

    styles = torch.stack([square(s) for s, _ in styles_and_weights])
    wts = torch.tensor([float(w) for _, w in styles_and_weights], dtype=torch.float32,
                       device=dev)
    out = nst_optimize(
        params, square(content)[None], styles, wts,
        num_steps=num_steps, lr=lr,
        style_weight=style_weight, content_weight=content_weight, device=dev,
    )
    return out[0]


def color_mask(mask_rgb01: torch.Tensor, color01, feather: int = 5) -> torch.Tensor:
    """Feathered binary mask for an exact RGB color (eight_page.py:103-108)."""
    color = torch.tensor(color01, dtype=torch.float32, device=mask_rgb01.device)
    m = torch.all(torch.abs(mask_rgb01 - color) < (0.5 / 255.0), dim=-1).to(torch.float32)
    if feather > 0:
        k = 2 * feather + 1
        win = torch.from_numpy(_gaussian_window(k, 0.3 * ((k - 1) * 0.5 - 1) + 0.8)).to(m.device)
        mp = F.pad(m[None, None], (feather, feather, feather, feather), mode="replicate")
        with fp32_convs():
            m = F.conv2d(mp, win[None, None])[0, 0]
    return m


def spatially_varying_style_transfer(
    content,
    style1,
    style2,
    style3,
    mask,
    feather: int = 5,
    params=None,
    device=None,
    **nst_kwargs,
) -> torch.Tensor:
    """Three full-image stylizations blended by an R/G/B color-coded mask.

    Parity: gui/eight_page.py:68-132 spatial_pipeline (red -> style1,
    green -> style2, blue -> style3; sequential over-compositing with
    Gaussian-feathered masks). Returns HWC [0,1].
    """
    from aip_tpu_torch.pipelines.adain_infer import _to_array

    dev = resolve_device(device)
    if params is None:
        params = backbone.get_vgg19_params(device=dev)
    content_np = _to_array(content)
    h, w, _ = content_np.shape

    styled = [resize_bicubic(run_style_transfer(content_np, s, params=params, device=dev,
                                                **nst_kwargs), (h, w))
              for s in (style1, style2, style3)]

    mask01 = torch.from_numpy(_to_array(mask)).to(dev)
    if tuple(mask01.shape[:2]) != (h, w):
        mask01 = resize_nearest(mask01, (h, w))

    final = torch.zeros_like(styled[0])
    for styled_img, color in zip(styled, ((1.0, 0, 0), (0, 1.0, 0), (0, 0, 1.0))):
        m = color_mask(mask01, color, feather)[..., None]
        final = m * styled_img + (1.0 - m) * final
    return torch.clamp(final, 0.0, 1.0)
