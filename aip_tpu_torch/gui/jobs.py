"""The GUI pages' pipeline calls, one plain function per page and mode.

Each function is the body of one ``run_pipeline`` of
``aip_tpu/gui/pages.py``: it takes the page's values and ``device``, calls
the port's pipeline with the arguments the JAX page passes (plus
``device`` where the pipeline takes one), and returns what the JAX page
returns: a file path, or an HWC array on the host (a tensor the port
returns on the card is copied back with ``.detach().cpu().numpy()``).

| function | JAX page method |
|---|---|
| ``adain_image`` | ``AdainPage.run_pipeline``, modes simple and depth-aware |
| ``adain_3dgs`` | ``AdainPage.run_pipeline``, mode "3DGS scene" |
| ``pixelize_image`` | ``PixelArtPage.run_pipeline``, mode Pixelize |
| ``depixelize_image`` | ``PixelArtPage.run_pipeline``, mode Depixelize |
| ``stylize_video`` | ``VideoPage.run_pipeline`` |
| ``regional`` | ``SemanticPage.run_pipeline`` |
| ``depth_image`` | ``DepthPage.run_pipeline`` |
| ``mix`` | ``MixPage.run_pipeline`` |
| ``style_mixer`` | ``StyleMixerPage.run_pipeline`` |
| ``spatial`` | ``SpatialPage.run_pipeline`` |

The pipelines are imported when a function is called, as the JAX pages
import them, so importing this module is cheap and needs no pygame; the
pages (``gui.pages``) call these functions on a worker thread.
"""

from __future__ import annotations

import tempfile
from pathlib import Path

import numpy as np


def _host(out) -> np.ndarray:
    return out.detach().cpu().numpy()


def adain_image(content_path, style_path, *, alpha: float, depth_offset: float,
                depth_prominence: float, use_depth: bool, device):
    """AdaIN, simple or depth-aware. Returns the saved image's path."""
    from aip_tpu_torch.pipelines.adain_infer import adain_inference

    return adain_inference(
        content_path, style_path, alpha=alpha, depth_offset=depth_offset,
        depth_prominence=depth_prominence, use_depth=use_depth,
        output="output", file_name="gui_adain", device=device,
    )


def adain_3dgs(content_path, style_path, *, device):
    """Train a stylized 3DGS scene (``content_path`` is the scene directory,
    or a file in it) and render it. Returns the orbit GIF's path."""
    from aip_tpu_torch.gs.pipeline import run_3dgs_rendering, run_3dgs_training

    scene_dir = str(Path(content_path).parent
                    if Path(content_path).is_file() else content_path)
    model = run_3dgs_training(scene_dir, style_path, model_path="output/gui_3dgs",
                              device=device)
    return run_3dgs_rendering(style_path, model, device=device)


def pixelize_image(content_path, palette_hex, *, downsample: float, grayscale: bool,
                   brightness: float, contrast: float, method: str, device) -> np.ndarray:
    """Pixelize to a Lospec palette (its hex colours). Returns uint8 HWC."""
    from aip_tpu_torch.pipelines.pixel_art import hex_palette_to_rgb, pixelize

    return pixelize(
        content_path, downsampling_factor=int(downsample), grayscale=grayscale,
        brightness=brightness, contrast=contrast,
        palette=hex_palette_to_rgb(palette_hex), method=method, device=device,
    )


def depixelize_image(content_path) -> np.ndarray:
    """Depixelize a sprite (host code; the pipeline takes no device)."""
    from aip_tpu_torch.pipelines.pixel_art import depixelize

    return depixelize(content_path)


def stylize_video(content_path, style_path, *, flow_method: str, fast: bool, alpha: float,
                  offset: float, cancel_flag, device) -> str:
    """Split a video into frames, stylize them (AdaIN with depth, or the
    fast stylizer), and write an mp4. Returns its path."""
    from aip_tpu_torch.pipelines.video import (
        apply_style_transfer,
        apply_style_transfer_ada,
        frames_to_video,
        video_to_frames,
    )

    tmp = Path(tempfile.mkdtemp(prefix="aip_gui_video_"))
    video_to_frames(content_path, tmp / "frames")
    if fast:
        apply_style_transfer(
            tmp / "frames", style_path, tmp / "styled", alpha=alpha,
            cancel_flag=cancel_flag, flow_method=flow_method, device=device,
        )
    else:
        apply_style_transfer_ada(
            tmp / "frames", style_path, tmp / "styled", alpha=alpha, offset=offset,
            cancel_flag=cancel_flag, flow_method=flow_method, device=device,
        )
    out = tmp / "out.mp4"
    frames_to_video(tmp / "styled", out)
    return str(out)


def regional(content_path, style_path, *, device):
    """Regional style transfer. Returns the saved image's path."""
    from aip_tpu_torch.pipelines.localized import run_localized_style_transfer

    return run_localized_style_transfer(
        content_path, style_path, output_path="output", file_name="gui_regional",
        device=device,
    )


def depth_image(content_path, style_path, *, depth_offset: float, depth_prominence: float,
                device):
    """Depth-aware AdaIN at alpha's default. Returns the saved image's path."""
    from aip_tpu_torch.pipelines.adain_infer import adain_inference

    return adain_inference(
        content_path, style_path, use_depth=True, depth_offset=depth_offset,
        depth_prominence=depth_prominence, output="output", file_name="gui_depth",
        device=device,
    )


def mix(content_path, style_path, style2_path, *, weight: float, device) -> np.ndarray:
    """Two-style Gram mixing, 300 steps at 256 px (the second style falls
    back to the first). Returns HWC [0, 1] float32."""
    from aip_tpu_torch.pipelines.nst import mix_styles

    out = mix_styles(
        content_path,
        [(style_path, weight), (style2_path or style_path, 1 - weight)],
        num_steps=300, size=256, device=device,
    )
    return _host(out)


def style_mixer(content_path, style_path, *, model: str, palette_name: str,
                palette_intensity: float, device) -> np.ndarray:
    """NST on one backbone, 300 iterations, then the palette. Returns HWC
    [0, 1] float32."""
    from aip_tpu_torch.pipelines.style_mixer import stylize_with_palette

    out = stylize_with_palette(
        content_path, style_path, model=model, palette_name=palette_name,
        palette_intensity=palette_intensity, iterations=300, device=device,
    )
    return _host(out)


def spatial(content_path, style_path, style2_path, style3_path, mask_path, *,
            device) -> np.ndarray:
    """Three styles under an RGB mask, 300 steps at max_dim 512 (missing
    styles fall back to the first). Returns HWC [0, 1] float32."""
    from aip_tpu_torch.pipelines.nst import spatially_varying_style_transfer

    out = spatially_varying_style_transfer(
        content_path, style_path, style2_path or style_path, style3_path or style_path,
        mask_path, num_steps=300, max_dim=512, device=device,
    )
    return _host(out)
