"""2D AdaIN stylisation pipeline. Port of ``aip_tpu.pipelines.adain_infer``.

Parity with the reference ``AdaIN/test.py``:

* ``stylize_simple`` (:74-81): alpha-blended AdaIN;
* ``stylize_depth`` (:52-71): depth-aware blend with the strength map P,
  ``feat = AdaIN * (1 - P) + content_f * P``;
* ``adain_inference`` (:153-247): the IO wrapper (smaller-edge resize,
  optional CORAL colour preservation, depth path, binary-mask composite,
  image save); returns the output path;
* ``get_style_embeddings`` (:27-49): relu4_1 features of a style image.

The depth-aware path's network is the caller's choice: ``depth_model=None``
keeps the ``depth_fn``, registered-estimator, classical-proxy order;
``"midas_small"`` (``models.midas``, the reference's ``--use_depth``
network, :84-116), ``"dpt_large"`` (``models.dpt``, the hub's
``DPT_Large``) or ``"dpt_swin2_large_384"`` (``models.dpt_swin2``, the
hub's ``DPT_SwinV2_L_384``) is built from ``depth_weights`` (a hub state
dict; None is the seeded init) once a process and kept on its device
(``depth_network``).

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
from aip_tpu_torch.kernels import png_filter
from aip_tpu_torch.models import weights as weights_mod
from aip_tpu_torch.models.decoder import decoder_apply
from aip_tpu_torch.models.vgg import vgg_encode
from aip_tpu_torch.ops.adain import adain, calc_mean_std, coral
from aip_tpu_torch.ops.depth import compute_stylization_strength_map
from aip_tpu_torch.ops.image import (center_crop, resize_bilinear, resize_nearest,
                                     resize_smaller_edge, smaller_edge_size)
from aip_tpu_torch.utils import png as png_writer
from aip_tpu_torch.utils.profiling import count, span

DEPTH_MODELS = ("midas_small", "dpt_large", "dpt_swin2_large_384")
PNG_LEVEL = 6           # zlib level of save_image's PNGs (PIL's default)
DEPTH_PNG_LEVEL = 1     # and of save_depth_png's

# (model, resolved checkpoint path or None, device) -> ((file size, mtime
# ns) or None, depth estimator, load ms): the network stays on its device
# across calls, as a server keeps it; the load's milliseconds are its
# ``adain.depth_load``.
_DEPTH = {}


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


def _depth_input(img, device):
    """The full-size content for a learned depth network: a decoded 8-bit
    PIL image goes to ``device`` as it is and is divided by 255 there,
    grey spread to three channels and alpha dropped, the same float32
    numbers as ``_to_array`` on the host (IEEE division rounds alike; the
    divisor is a tensor on ``device``, as a host scalar would make the card
    multiply by its reciprocal instead). Anything else is ``_to_array``'s."""
    from PIL import Image

    a = np.asarray(img) if isinstance(img, Image.Image) else None
    if a is None or a.dtype != np.uint8:
        return _to_array(img if a is None else a)
    x = torch.tensor(a, device=device).float() / torch.tensor(255.0, device=device)
    if x.ndim == 2:
        x = torch.stack([x] * 3, dim=-1)
    if x.shape[-1] == 4:
        x = x[..., :3]
    return x.contiguous()


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
    """Clamp to [0,1] and save (torchvision save_image: round half away).

    A CUDA tensor of an 8-bit grey, RGB or RGBA image is quantised on the
    card (``kernels.png_filter``); for a PNG its scanlines are filtered
    there too and ``utils.png`` deflates them at zlib level 6 (PIL's
    default), so the host fetches and deflates only the filtered rows. A
    host array or CPU tensor, and any other shape, is quantised by the
    same rule in numpy and encoded by PIL, as is every other file type.
    The copy of a tensor to the host is an ``adain.fetch`` span. Counters:
    ``io.png_writes`` (PNGs written) and ``io.png_card_filtered`` (those
    filtered on the card)."""
    from PIL import Image

    path = Path(path)
    a = arr.detach() if isinstance(arr, torch.Tensor) else np.asarray(arr)
    if a.ndim == 4:
        a = a[0]
    shape = tuple(a.shape)
    png = path.suffix.lower() == ".png"
    on_card = isinstance(a, torch.Tensor) and a.is_cuda and png_filter.takes(shape)
    if isinstance(a, torch.Tensor):
        with span("adain.fetch"):
            a = (png_filter.png_rows8(a, filtered=png) if on_card else a.float()).cpu().numpy()
    if not on_card:
        a = png_filter.quantise8(a)
    path.parent.mkdir(parents=True, exist_ok=True)
    if png:
        count("io.png_writes", 1)
        count("io.png_card_filtered", int(on_card))
    if on_card and png:
        png_writer.write(path, a, 8, png_filter.channels(shape), PNG_LEVEL)
    else:
        Image.fromarray(a.reshape(shape)).save(str(path))


def get_style_embeddings(style_img, style_size: int = 512, crop: bool = False,
                         vgg_params=None, compute_dtype=torch.float32,
                         device=None) -> torch.Tensor:
    """relu4_1 features of a style image, [1, h, w, 512] fp32 (test.py:27-49)."""
    dev = resolve_device(device)
    if vgg_params is None:
        vgg_params = weights_mod.get_vgg_params(device=dev)
    style = _test_transform(style_img, style_size, crop, dev)[None]
    return style_embedding(vgg_params, style, compute_dtype=compute_dtype, device=dev)


def depth_network(depth_model: str, depth_weights=None, device=None):
    """The depth estimator of ``depth_model`` (one of ``DEPTH_MODELS``) on
    ``device``: fn(img HWC) -> [H, W] proximity. Built once a process from
    ``depth_weights`` (a hub state dict; None is the model's seeded init): a
    later call with the same file (path, size and mtime) on the same device
    reads nothing. A path that is no real checkpoint raises."""
    from aip_tpu_torch.models import dpt, dpt_swin2, midas

    if depth_model not in DEPTH_MODELS:
        raise ValueError(f"depth_model must be one of {DEPTH_MODELS}, not {depth_model!r}")
    dev = resolve_device(device)
    path, stamp = None, None
    if depth_weights is not None:
        path = Path(depth_weights).resolve()
        if not weights_mod._is_real_checkpoint(path):
            raise FileNotFoundError(f"no {depth_model} checkpoint at {path} (missing, or a "
                                    "git-LFS pointer)")
        stat = path.stat()
        stamp = (stat.st_size, stat.st_mtime_ns)
    key = (depth_model, str(path) if path else None, str(dev))
    cached = _DEPTH.get(key)
    if cached is None or cached[0] != stamp:
        with span("adain.depth_load", timed=True) as load:
            if depth_model == "dpt_large":
                fn = dpt.make_depth_estimator(dpt.get_dpt_params(path, dev))
            elif depth_model == "dpt_swin2_large_384":
                fn = dpt.make_depth_estimator(dpt_swin2.get_dpt_swin2_params(path, dev))
            else:
                fn = midas.make_depth_estimator(midas.get_midas_params(path, dev))
        cached = _DEPTH[key] = (stamp, fn, load.ms())
    return cached[1]


def save_depth_png(depth_map, path) -> None:
    """The [H, W] proximity min-max normalised to [0, 1] (a constant map
    gives zeros) and written as a 16-bit grey PNG, rounded half up: a CUDA
    map quantised and filtered on the card (``kernels.png_filter.png_rows16``)
    and deflated by ``utils.png``, a CPU one quantised in numpy
    (``quantise16``) and encoded by PIL. zlib level 1: a 1024x768 map
    encodes in a third of the default level's time (6), 3 % larger.
    Counted as ``save_image`` counts a PNG."""
    from PIL import Image

    d = depth_map.detach()
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    count("io.png_writes", 1)
    count("io.png_card_filtered", int(d.is_cuda))
    if d.is_cuda:
        png_writer.write(path, png_filter.png_rows16(d).cpu().numpy(), 16, 1, DEPTH_PNG_LEVEL)
    else:
        Image.fromarray(png_filter.quantise16(d.double().numpy())).save(
            str(path), compress_level=DEPTH_PNG_LEVEL)


@span("adain.request")
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
    depth_model=None,
    depth_weights=None,
    save_depth: bool = False,
) -> Path:
    """Full 2D stylisation entry point (reference ``test.py:153-247``).

    ``depth_fn(img_hwc_float) -> [H, W]`` injects a depth estimator; the
    default is ``models.depthnet.estimate_proximity`` on ``device``.
    ``depth_model`` (one of ``DEPTH_MODELS``, with ``depth_weights``) names
    a learned network instead (``depth_network``).
    ``save_depth`` also writes ``<file_name>_depth.png``: the proximity at
    the content's full size, min-max normalised, as 16-bit grey.
    fp32 by default: this is the reference-parity surface (BASELINE.md
    budgets 1e-3 mean abs pixel error). Returns the saved output path.

    One ``adain.request`` span over ``adain.weights`` (both networks' load),
    ``adain.load`` (decode, resize and upload of content and style),
    ``adain.stylize`` (the device work; in it ``adain.depth``, the depth
    estimate: transform, forward and resize back) and ``adain.save`` (its
    ``adain.fetch``, the wait for the output, then the encode and write;
    the depth PNG's too). Counter ``depth.calls``: depth estimates.
    """
    if depth_model is not None and depth_fn is not None:
        raise ValueError("pass depth_fn or depth_model, not both")
    if (depth_model is not None or save_depth) and not use_depth:
        raise ValueError("depth_model and save_depth need use_depth=True")
    dev = resolve_device(device)
    if depth_model is not None:
        depth_fn = depth_network(depth_model, depth_weights, dev)
    with span("adain.weights"):
        vgg_params = weights_mod.get_vgg_params(vgg_str, device=dev)
        dec_params = weights_mod.get_decoder_params(decoder_str, device=dev)
    with span("adain.load"):
        # The full-size float content only feeds the depth estimate (on the
        # card for a learned network). A path is decoded once:
        # _test_transform resizes the same PIL image.
        if use_depth and isinstance(content_img, (str, Path)):
            content_img = _to_pil(content_img)
        content_full = None
        if use_depth:
            content_full = (_depth_input(content_img, dev) if depth_model is not None
                            else _to_array(content_img))
        content = _test_transform(content_img, content_size, crop, dev)
        style = _test_transform(style_img, style_size, crop, dev)
    with span("adain.stylize"):
        if preserve_color:
            style = coral(style, content)
        content_b = content[None]
        style_b = style[None]

        if use_depth:
            count("depth.calls", 1)
            with span("adain.depth"):
                if depth_fn is None:
                    from aip_tpu_torch.models.depthnet import estimate_proximity

                    depth_map = estimate_proximity(torch.from_numpy(content_full).to(dev))
                else:
                    depth_map = depth_fn(content_full)
                    if not isinstance(depth_map, torch.Tensor):
                        depth_map = np.asarray(depth_map)
                    depth_map = torch.as_tensor(depth_map, device=dev)
            out = stylize_depth(vgg_params, dec_params, content_b, style_b, depth_map,
                                offset=float(depth_offset),
                                prominence=float(depth_prominence),
                                compute_dtype=compute_dtype, device=dev)
        else:
            out = stylize_simple(vgg_params, dec_params, content_b, style_b,
                                 alpha=float(alpha), compute_dtype=compute_dtype,
                                 device=dev)

        if content_mask is not None:
            # Reference test.py:222-236: nearest-resized binary mask composite.
            mask_np = np.asarray(content_mask, dtype=np.float32)
            if mask_np.ndim == 3 and mask_np.shape[0] == 1 and mask_np.shape[-1] != 1:
                mask_np = np.moveaxis(mask_np, 0, -1)  # reference passes [1, H, W]
            if mask_np.ndim == 2:
                mask_np = mask_np[:, :, None]
            target_hw = (content_b.shape[1], content_b.shape[2])
            mask = resize_nearest(
                torch.from_numpy(np.ascontiguousarray(mask_np)).to(dev)[None], target_hw)
            out = resize_bilinear(out, target_hw)
            out = content_b * (1.0 - mask) + out * mask

    output_path = Path(output) / f"{file_name}{save_ext}"
    with span("adain.save"):
        save_image(out, output_path)
        if save_depth:
            save_depth_png(depth_map, Path(output) / f"{file_name}_depth.png")
    return output_path
