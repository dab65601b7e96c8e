"""Regional (semantic) style transfer: stylize background, harmonize foreground.
Port of ``aip_tpu.pipelines.localized``.

Parity with reference `Style_3DGS/localized_style_transfer.py:191-245`
``run_localized_style_transfer``:
1. background mask from segmentation (class-0 prob > 0.5);
2. AdaIN-stylize *only the background* (mask composite, alpha=1);
3. harmonize the untouched foreground's colors to the stylized background via
   Reinhard-lab PCA(1) + CDF matching (``composite_localized``);
4. composite and save ``localized_style_transfer_result.jpg``.

Segmentation is pluggable: ``segmenter="classical"`` (the default) is
``models.segmenter``'s border-colour estimator, or the model a caller put
there with ``register_segmenter``; ``segmenter="deeplab"`` is the
reference's DeepLabV3-ResNet101 (``models.deeplab``) from a torchvision
``deeplabv3_resnet101`` state dict, ``deeplab_weights``, loaded once a
process and kept on the device (``deeplab_params``); a ``segment_fn``
replaces both. ``device=None`` means CUDA, and raises when CUDA is absent.

Spans (``utils.profiling``, under a profiler): ``localized.request`` over
``localized.segment`` (DeepLab's upload, forward, softmax, threshold and
mask download), the stylize call's own ``adain.*`` spans,
``localized.harmonize`` (``composite_localized``) and ``localized.save``;
counters ``localized.pixels`` and ``localized.background_px``. The one-time
``localized.segmenter_load`` is timed outside a profiler too.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
import torch

from aip_tpu_torch.device import resolve_device
from aip_tpu_torch.models import deeplab as deeplab_mod
from aip_tpu_torch.models import weights as weights_mod
from aip_tpu_torch.models.segmenter import extract_background_mask
from aip_tpu_torch.ops.color import harmonize_foreground
from aip_tpu_torch.ops.image import resize_nearest
from aip_tpu_torch.pipelines.adain_infer import _to_array, adain_inference, save_image
from aip_tpu_torch.utils.profiling import count, span

RESULT_NAME = "localized_style_transfer_result.jpg"
MASK_NAME = "localized_style_transfer_mask.png"
SEGMENTERS = ("classical", "deeplab")

# (resolved checkpoint path, device) -> ((file size, mtime ns), params, load
# ms): the converted network stays on its device across calls, as a server
# keeps it; the load's milliseconds are its ``localized.segmenter_load``.
_DEEPLAB = {}


def _numpy(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def composite_localized(content_np: np.ndarray, stylized_np: np.ndarray,
                        background_mask: np.ndarray, device=None) -> np.ndarray:
    """The array part of the pipeline: the content image, the stylized image
    and the [H, W] {0,1} background mask in, the combined float32 HWC image
    out (before the JPEG save). The stylized image is brought to the mask's
    size (nearest, reference :222-229) when it is at the working resolution."""
    dev = resolve_device(device)
    if stylized_np.shape[:2] != background_mask.shape:
        stylized_np = _numpy(resize_nearest(torch.from_numpy(
            np.ascontiguousarray(stylized_np)), background_mask.shape))
    if content_np.shape[:2] != background_mask.shape:
        raise ValueError("mask/content shape mismatch")

    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    bg = on_dev(background_mask)
    fg = 1.0 - bg
    foreground = on_dev(content_np) * fg[..., None]
    background = on_dev(stylized_np) * bg[..., None]

    adjusted_fg = harmonize_foreground(
        foreground, background,
        # Non-black pixels only, as in reference :134-138.
        (foreground.sum(-1) > 0) & (fg > 0),
        (background.sum(-1) > 0) & (bg > 0),
    )
    return _numpy(adjusted_fg * fg[..., None] + background)


def deeplab_params(deeplab_weights, device=None):
    """DeepLabV3-ResNet101 from a torchvision ``deeplabv3_resnet101`` state
    dict on ``device``, converted once a process: a later call with the
    same file (path, size and mtime) on the same device reads nothing.
    Raises without a real checkpoint, where the seeded init would give an
    empty mask."""
    dev = resolve_device(device)
    if deeplab_weights is None:
        raise ValueError("segmenter='deeplab' needs deeplab_weights, a torchvision "
                         "deeplabv3_resnet101 state dict")
    path = Path(deeplab_weights).resolve()
    if not weights_mod._is_real_checkpoint(path):
        raise FileNotFoundError(f"no DeepLab checkpoint at {path} (missing, or a git-LFS "
                                "pointer): segmenter='deeplab' needs the trained weights")
    stat = path.stat()
    stamp = (stat.st_size, stat.st_mtime_ns)
    key = (str(path), str(dev))
    cached = _DEEPLAB.get(key)
    if cached is None or cached[0] != stamp:
        with span("localized.segmenter_load", timed=True) as load:
            params = deeplab_mod._convert_torch_deeplab(
                weights_mod._load_torch_state_dict(path), dev)
        cached = _DEEPLAB[key] = (stamp, params, load.ms())
    return cached[1]


def run_localized_style_transfer(
    content_img_path,
    style_img_path,
    output_path: str = "output",
    file_name: str = "test",
    use_depth: bool = False,
    depth_offset: float = 0.5,
    depth_prominence: float = 20.0,
    segment_fn=None,
    device=None,
    segmenter: str = "classical",
    deeplab_weights=None,
    save_mask: bool = False,
) -> str:
    """Returns the saved result path (reference :191-245). ``segmenter``:
    ``"classical"`` or ``"deeplab"`` (with ``deeplab_weights``, a torchvision
    checkpoint); ``save_mask`` also writes the [H, W] background mask as an
    8-bit PNG (255 background) beside the result."""
    if segmenter not in SEGMENTERS:
        raise ValueError(f"segmenter must be one of {SEGMENTERS}, not {segmenter!r}")
    if segment_fn is not None and segmenter != "classical":
        raise ValueError("pass segment_fn or segmenter='deeplab', not both")
    dev = resolve_device(device)
    with span("localized.request"):
        if segmenter == "deeplab":
            segment_fn = deeplab_mod.make_background_segmenter(
                deeplab_params(deeplab_weights, dev))
        elif segment_fn is None:
            segment_fn = functools.partial(extract_background_mask, device=dev)
        content_np = _to_array(content_img_path)

        with span("localized.segment"):
            background_mask = _numpy(segment_fn(content_np))  # [H, W] {0,1}
        count("localized.pixels", background_mask.size)
        count("localized.background_px", int(np.count_nonzero(background_mask)))

        stylized_path = adain_inference(
            content_img=content_img_path,
            style_img=style_img_path,
            content_mask=background_mask[None],
            output=output_path,
            file_name=file_name,
            use_depth=use_depth,
            depth_offset=depth_offset,
            depth_prominence=depth_prominence,
            alpha=1.0,
            device=dev,
        )
        with span("localized.harmonize"):
            combined = composite_localized(content_np, _to_array(stylized_path),
                                           background_mask, device=dev)
        save_path = Path(output_path) / RESULT_NAME
        with span("localized.save"):
            save_image(combined, save_path)
            if save_mask:
                from PIL import Image

                Image.fromarray((background_mask > 0).astype(np.uint8) * 255).save(
                    str(Path(output_path) / MASK_NAME))
    return str(save_path)
