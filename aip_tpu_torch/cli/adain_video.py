"""Standalone AdaIN video CLI (reference `AdaIN/test_video.py`), port of
``aip_tpu.cli.adain_video`` with ``--device``: stylize a content video with
a style image, a style video (one style frame per content frame), or
several style images blended with interpolation weights. Frame by frame,
no temporal blending; the frames live in a temporary directory that is
removed at the end. mp4 decode and encode need cv2.

    python -m aip_tpu_torch.cli.adain_video --content_video in.mp4 --style_path s.jpg
"""

import argparse
import tempfile
from pathlib import Path


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--content_video", type=str, required=True,
                        help="File path to the content video")
    parser.add_argument("--style_path", type=str, nargs="+", required=True,
                        help="Style image(s), or a style video")
    parser.add_argument("--style_interpolation_weights", type=float, nargs="*", default=None)
    parser.add_argument("--content_size", type=int, default=512)
    parser.add_argument("--style_size", type=int, default=512)
    parser.add_argument("--alpha", type=float, default=1.0)
    parser.add_argument("--output", type=str, default="output/adain_video.mp4")
    parser.add_argument("--fps", type=int, default=20)
    parser.add_argument("--device", type=str, default=None,
                        help="Torch device (default: cuda; raises without CUDA).")
    args = parser.parse_args(argv)

    from aip_tpu_torch.device import resolve_device
    from aip_tpu_torch.pipelines.video import frames_to_video

    dev = resolve_device(args.device)
    with tempfile.TemporaryDirectory(prefix="aip_adain_video_") as tmp:
        _write_styled_frames(args, Path(tmp), dev)
        Path(args.output).parent.mkdir(parents=True, exist_ok=True)
        frames_to_video(Path(tmp) / "styled", args.output, fps=args.fps)
    print(f"Stylized video saved to {args.output}")
    return args.output


def _write_styled_frames(args, tmp: Path, dev) -> None:
    """Decode the content video into ``tmp/frames`` and write each frame's
    stylization to ``tmp/styled`` (8-bit, truncated as ``aip_tpu``)."""
    import numpy as np
    import torch
    from PIL import Image

    from aip_tpu_torch.models import weights as weights_mod
    from aip_tpu_torch.ops.image import resize_smaller_edge
    from aip_tpu_torch.pipelines.adain_infer import (_to_array, stylize_interpolated,
                                                     stylize_simple)
    from aip_tpu_torch.pipelines.video import video_to_frames

    vgg_params = weights_mod.get_vgg_params(device=dev)
    dec_params = weights_mod.get_decoder_params(device=dev)

    def load(path, size):
        return resize_smaller_edge(torch.from_numpy(_to_array(path)).to(dev), size)

    frame_paths = video_to_frames(args.content_video, tmp / "frames")
    style_is_video = (len(args.style_path) == 1
                      and args.style_path[0].lower().endswith((".mp4", ".avi", ".mov")))
    if style_is_video:
        style_frames = [load(p, args.style_size)[None]
                        for p in video_to_frames(args.style_path[0], tmp / "style_frames")]
    else:
        styles = torch.stack([load(p, args.style_size) for p in args.style_path])
        weights = torch.tensor(args.style_interpolation_weights or [1.0] * styles.shape[0],
                               dtype=torch.float32)

    (tmp / "styled").mkdir(exist_ok=True)
    for i, fp in enumerate(frame_paths):
        content = load(fp, args.content_size)[None]
        if style_is_video:
            style = style_frames[min(i, len(style_frames) - 1)]
            out = stylize_simple(vgg_params, dec_params, content, style, alpha=args.alpha,
                                 device=dev)
        elif styles.shape[0] > 1:
            out = stylize_interpolated(vgg_params, dec_params, content, styles, weights,
                                       alpha=args.alpha, device=dev)
        else:
            out = stylize_simple(vgg_params, dec_params, content, styles[:1], alpha=args.alpha,
                                 device=dev)
        img = (np.clip(out[0].float().cpu().numpy(), 0, 1) * 255).astype(np.uint8)
        Image.fromarray(img).save(tmp / "styled" / fp.name)


if __name__ == "__main__":
    main()
