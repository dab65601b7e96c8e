"""2D AdaIN stylisation pipeline. Port of ``aip_tpu.pipelines.adain_infer``.

Parity with the reference ``AdaIN/test.py``:

* ``stylize_simple`` (:74-81): alpha-blended AdaIN;
* ``stylize_depth`` (:52-71): depth-aware blend with the strength map P,
  ``feat = AdaIN * (1 - P) + content_f * P``;
* ``adain_inference`` (:153-247): the IO wrapper (smaller-edge resize,
  optional CORAL colour preservation, depth path, binary-mask composite,
  image save); returns the output path;
* ``get_style_embeddings`` (:27-49): relu4_1 features of a style image.

Tensors are NHWC in [0, 1]. Convs run in ``compute_dtype`` (bf16 by
default on the batched paths, fp32 on the reference-parity IO wrapper);
AdaIN statistics are fp32. Every function here takes ``device=None``,
which means CUDA, and raises when CUDA is absent. PIL is imported only
inside the IO helpers.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from aip_tpu_torch.device import check_module_device, resolve_device
from aip_tpu_torch.models import weights as weights_mod
from aip_tpu_torch.models.decoder import decoder_apply
from aip_tpu_torch.models.vgg import vgg_encode
from aip_tpu_torch.ops.adain import adain, calc_mean_std, coral
from aip_tpu_torch.ops.depth import compute_stylization_strength_map
from aip_tpu_torch.ops.image import (center_crop, resize_bilinear, resize_nearest,
                                     resize_smaller_edge, smaller_edge_size)


def _place(device, modules=(), tensors=()):
    """Resolve ``device``, check the modules lie there, move the tensors."""
    dev = resolve_device(device)
    for m in modules:
        check_module_device(m, dev)
    return dev, [torch.as_tensor(t).to(dev) for t in tensors]


def _decode(dec, feat, compute_dtype):
    return decoder_apply(dec, feat.to(compute_dtype), compute_dtype).float()


# ---------------------------------------------------------------------------
# Compute cores (batched NHWC)
# ---------------------------------------------------------------------------

@torch.no_grad()
def stylize_simple(vgg_params, dec_params, content, style, alpha: float = 0.5,
                   compute_dtype=torch.bfloat16, device=None) -> torch.Tensor:
    """AdaIN stylisation, alpha-blended in feature space (test.py:74-81)."""
    _, (content, style) = _place(device, (vgg_params, dec_params), (content, style))
    content_f = vgg_encode(vgg_params, content, "relu4_1", compute_dtype)
    style_f = vgg_encode(vgg_params, style, "relu4_1", compute_dtype)
    feat = adain(content_f, style_f).float() * alpha + content_f.float() * (1.0 - alpha)
    return _decode(dec_params, feat, compute_dtype)


@torch.no_grad()
def stylize_depth(vgg_params, dec_params, content, style, depth_map,
                  offset: float = 0.15, prominence: float = 20.0,
                  compute_dtype=torch.bfloat16, device=None) -> torch.Tensor:
    """Depth-aware AdaIN (test.py:52-71): close regions keep more content.
    ``depth_map`` is an [H, W] proximity map of the single content image."""
    _, (content, style, depth_map) = _place(
        device, (vgg_params, dec_params), (content, style, depth_map))
    content_f = vgg_encode(vgg_params, content, "relu4_1", compute_dtype)
    style_f = vgg_encode(vgg_params, style, "relu4_1", compute_dtype)
    p = compute_stylization_strength_map(
        depth_map, (content_f.shape[1], content_f.shape[2]), offset, prominence)
    p = p[None, :, :, None]
    feat = adain(content_f, style_f).float() * (1.0 - p) + content_f.float() * p
    return _decode(dec_params, feat, compute_dtype)


@torch.no_grad()
def style_embedding(vgg_params, style, compute_dtype=torch.bfloat16,
                    device=None) -> torch.Tensor:
    """relu4_1 feature map of a style image (test.py:27-49), fp32."""
    _, (style,) = _place(device, (vgg_params,), (style,))
    return vgg_encode(vgg_params, style, "relu4_1", compute_dtype).float()


@torch.no_grad()
def precompute_style_stats(vgg_params, style, compute_dtype=torch.bfloat16, device=None):
    """Encode a style image once and reduce it to AdaIN's (mean, std), each
    [N, 1, 1, 512] fp32: a fixed style then costs no encoder pass per call."""
    _, (style,) = _place(device, (vgg_params,), (style,))
    return calc_mean_std(vgg_encode(vgg_params, style, "relu4_1", compute_dtype))


@torch.no_grad()
def stylize_with_stats(vgg_params, dec_params, content, style_mean, style_std,
                       alpha: float = 0.5, compute_dtype=torch.bfloat16,
                       device=None) -> torch.Tensor:
    """Serving path: content encode -> renormalise to the cached style
    statistics -> decode. No style encode."""
    _, (content, style_mean, style_std) = _place(
        device, (vgg_params, dec_params), (content, style_mean, style_std))
    content_f = vgg_encode(vgg_params, content, "relu4_1", compute_dtype)
    c_mean, c_std = calc_mean_std(content_f)
    x = content_f.float()
    feat = (x - c_mean) / c_std * style_std + style_mean
    feat = feat * alpha + x * (1.0 - alpha)
    return _decode(dec_params, feat, compute_dtype)


@torch.no_grad()
def stylize_batch_with_stats(vgg_params, dec_params, content, style_mean, style_std,
                             masks=None, alpha: float = 0.5,
                             compute_dtype=torch.bfloat16, device=None) -> torch.Tensor:
    """Batched serving path with ``adain_inference``'s composite: the decoder
    returns 8*floor(H/8) rows when H % 8 != 0, so the output is resized back
    to the content size before the binary-mask composite (test.py:222-236).
    ``masks``: [N, H, W, 1] at the content size, or None."""
    dev, (content,) = _place(device, (), (content,))
    out = stylize_with_stats(vgg_params, dec_params, content, style_mean, style_std,
                             alpha=alpha, compute_dtype=compute_dtype, device=dev)
    target_hw = (content.shape[1], content.shape[2])
    if tuple(out.shape[1:3]) != target_hw:
        out = resize_bilinear(out, target_hw)
    if masks is not None:
        masks = torch.as_tensor(masks).to(dev)
        out = content * (1.0 - masks) + out * masks
    return out


@torch.no_grad()
def stylize_interpolated(vgg_params, dec_params, content, styles, interpolation_weights,
                         alpha: float = 1.0, compute_dtype=torch.bfloat16,
                         device=None) -> torch.Tensor:
    """Blend the AdaIN features of S styles (test_video.py:30-46).
    content [1, H, W, 3]; styles [S, Hs, Ws, 3]; weights [S]."""
    _, (content, styles, weights) = _place(
        device, (vgg_params, dec_params), (content, styles, interpolation_weights))
    content_f = vgg_encode(vgg_params, content, "relu4_1", compute_dtype)
    style_f = vgg_encode(vgg_params, styles, "relu4_1", compute_dtype)
    content_rep = content_f.expand((styles.shape[0],) + tuple(content_f.shape[1:]))
    base = adain(content_rep, style_f).float()
    w = weights.float() / weights.float().sum()
    feat = (base * w[:, None, None, None]).sum(dim=0, keepdim=True)
    feat = feat * alpha + content_f.float() * (1.0 - alpha)
    return _decode(dec_params, feat, compute_dtype)


# ---------------------------------------------------------------------------
# Host-side IO wrapper (PIL in, image file out)
# ---------------------------------------------------------------------------

def _to_pil(img):
    """PIL image (or path / uint8 array) -> PIL; float arrays -> None."""
    from PIL import Image

    if isinstance(img, (str, Path)):
        return Image.open(str(img))
    if isinstance(img, Image.Image):
        return img
    if isinstance(img, np.ndarray) and img.dtype == np.uint8:
        return Image.fromarray(img)
    return None


def _to_array(img) -> np.ndarray:
    """PIL image, path, ndarray or tensor -> float32 HWC in [0,1], alpha
    dropped. Float arrays and tensors never touch PIL."""
    if isinstance(img, torch.Tensor):
        img = img.detach().cpu().numpy()
    elif not isinstance(img, np.ndarray) or img.dtype == np.uint8:
        img = np.asarray(_to_pil(img))
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    if img.shape[-1] == 4:  # drop alpha (reference test.py:46-47)
        img = img[..., :3]
    return np.ascontiguousarray(img, dtype=np.float32)


def _test_transform(img, size: int, crop: bool, device) -> torch.Tensor:
    """Parity with reference ``test.py:16-24`` test_transform.

    PIL / uint8 / path inputs resize through PIL itself (torchvision's
    ``Resize`` on a PIL image is ``PIL.Image.resize(..., BILINEAR)``), so
    that path is bit-exact with the reference. Float arrays and tensors
    use the antialiased-bilinear tensor op.
    """
    if isinstance(img, torch.Tensor):
        x = img.to(device)
    elif isinstance(img, np.ndarray) and img.dtype != np.uint8:
        x = torch.from_numpy(_to_array(img)).to(device)
    else:
        from PIL import Image

        pil = _to_pil(img)
        if size != 0:
            oh, ow = smaller_edge_size(pil.size[1], pil.size[0], size)
            pil = pil.resize((ow, oh), Image.BILINEAR)
        if crop:
            w, h = pil.size
            left, top = max(0, (w - size) // 2), max(0, (h - size) // 2)
            pil = pil.crop((left, top, left + size, top + size))
        return torch.from_numpy(_to_array(pil)).to(device)
    if size != 0:
        x = resize_smaller_edge(x, size)
    if crop:
        x = center_crop(x, size)
    return x


def save_image(arr, path) -> None:
    """Clamp to [0,1] and save (torchvision save_image: round half away)."""
    from PIL import Image

    a = arr.detach().float().cpu().numpy() if isinstance(arr, torch.Tensor) else np.asarray(arr)
    if a.ndim == 4:
        a = a[0]
    a = np.clip(a, 0.0, 1.0)
    a8 = np.clip(np.floor(a * 255.0 + 0.5), 0, 255).astype(np.uint8)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(a8).save(str(path))


def get_style_embeddings(style_img, style_size: int = 512, crop: bool = False,
                         vgg_params=None, compute_dtype=torch.float32,
                         device=None) -> torch.Tensor:
    """relu4_1 features of a style image, [1, h, w, 512] fp32 (test.py:27-49)."""
    dev = resolve_device(device)
    if vgg_params is None:
        vgg_params = weights_mod.get_vgg_params(device=dev)
    style = _test_transform(style_img, style_size, crop, dev)[None]
    return style_embedding(vgg_params, style, compute_dtype=compute_dtype, device=dev)


def adain_inference(
    content_img,
    style_img,
    vgg_str=None,
    decoder_str=None,
    depth_offset: float = 0.5,
    depth_prominence: float = 20.0,
    content_size: int = 512,
    style_size: int = 512,
    alpha: float = 0.5,
    crop: bool = False,
    save_ext: str = ".jpg",
    output: str = "output",
    file_name: str = "test",
    preserve_color: bool = False,
    content_mask=None,
    use_depth: bool = False,
    depth_fn=None,
    compute_dtype=torch.float32,
    device=None,
) -> Path:
    """Full 2D stylisation entry point (reference ``test.py:153-247``).

    ``depth_fn(img_hwc_float) -> [H, W]`` injects a depth estimator; the
    default is ``models.depthnet.estimate_proximity`` on ``device``.
    fp32 by default: this is the reference-parity surface (BASELINE.md
    budgets 1e-3 mean abs pixel error). Returns the saved output path.
    """
    dev = resolve_device(device)
    vgg_params = weights_mod.get_vgg_params(vgg_str, device=dev)
    dec_params = weights_mod.get_decoder_params(decoder_str, device=dev)

    content_np = _to_array(content_img)
    content = _test_transform(content_img, content_size, crop, dev)
    style = _test_transform(style_img, style_size, crop, dev)
    if preserve_color:
        style = coral(style, content)
    content_b = content[None]
    style_b = style[None]

    if use_depth:
        if depth_fn is None:
            from aip_tpu_torch.models.depthnet import estimate_proximity

            depth_map = estimate_proximity(torch.from_numpy(content_np).to(dev))
        else:
            depth_map = torch.as_tensor(np.asarray(depth_fn(content_np)), device=dev)
        out = stylize_depth(vgg_params, dec_params, content_b, style_b, depth_map,
                            offset=float(depth_offset), prominence=float(depth_prominence),
                            compute_dtype=compute_dtype, device=dev)
    else:
        out = stylize_simple(vgg_params, dec_params, content_b, style_b,
                             alpha=float(alpha), compute_dtype=compute_dtype, device=dev)

    if content_mask is not None:
        # Reference test.py:222-236: nearest-resized binary mask composite.
        mask_np = np.asarray(content_mask, dtype=np.float32)
        if mask_np.ndim == 3 and mask_np.shape[0] == 1 and mask_np.shape[-1] != 1:
            mask_np = np.moveaxis(mask_np, 0, -1)  # reference passes [1, H, W]
        if mask_np.ndim == 2:
            mask_np = mask_np[:, :, None]
        target_hw = (content_b.shape[1], content_b.shape[2])
        mask = resize_nearest(torch.from_numpy(np.ascontiguousarray(mask_np)).to(dev)[None],
                              target_hw)
        out = resize_bilinear(out, target_hw)
        out = content_b * (1.0 - mask) + out * mask

    output_path = Path(output) / f"{file_name}{save_ext}"
    save_image(out, output_path)
    return output_path
