"""Regional (semantic) style transfer: stylize background, harmonize foreground.
Port of ``aip_tpu.pipelines.localized``.

Parity with reference `Style_3DGS/localized_style_transfer.py:191-245`
``run_localized_style_transfer``:
1. background mask from segmentation (class-0 prob > 0.5);
2. AdaIN-stylize *only the background* (mask composite, alpha=1);
3. harmonize the untouched foreground's colors to the stylized background via
   Reinhard-lab PCA(1) + CDF matching (``composite_localized``);
4. composite and save ``localized_style_transfer_result.jpg``.

Segmentation is pluggable (``models.segmenter``). ``device=None`` means
CUDA, and raises when CUDA is absent.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
import torch

from aip_tpu_torch.device import resolve_device
from aip_tpu_torch.models.segmenter import extract_background_mask
from aip_tpu_torch.ops.color import harmonize_foreground
from aip_tpu_torch.ops.image import resize_nearest
from aip_tpu_torch.pipelines.adain_infer import _to_array, adain_inference, save_image


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
) -> str:
    """Returns the saved result path (reference :191-245)."""
    dev = resolve_device(device)
    content_np = _to_array(content_img_path)

    if segment_fn is None:
        segment_fn = functools.partial(extract_background_mask, device=dev)
    background_mask = _numpy(segment_fn(content_np))  # [H, W] {0,1}

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
    combined = composite_localized(content_np, _to_array(stylized_path), background_mask,
                                   device=dev)
    save_path = Path(output_path) / "localized_style_transfer_result.jpg"
    save_image(combined, save_path)
    return str(save_path)
