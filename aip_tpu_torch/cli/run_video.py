"""Video style transfer CLI (reference `test_video_st.py` and
`video/utils.py:407-425` run_style_transfer), port of
``aip_tpu.cli.run_video`` with ``--device``. Frames are stylized at
256 x 256, as the reference does.

    python -m aip_tpu_torch.cli.run_video --video in.mp4 --styles STYLE_DIR
    python -m aip_tpu_torch.cli.run_video --video in.mp4 --fast_stylizer --style s.jpg

Two differences from ``aip_tpu``'s CLI: the fast-stylizer branch returns
the output path (``aip_tpu``'s returns None), and ``--fast_stylizer``
without a value resolves the committed checkpoint against the repository,
not the working directory. ``--flow`` picks the flow on both paths.
mp4 decode and encode need cv2.
"""

import argparse

from aip_tpu_torch.models.magenta import DISTILLED_NPZ


def main(argv=None):
    parser = argparse.ArgumentParser(description="Video style transfer with temporal consistency.")
    parser.add_argument("--video", type=str, default="input/videos/sample.mp4")
    parser.add_argument("--styles", type=str, default="input/videos/styles/",
                        help="Directory of style images (switched across the video).")
    parser.add_argument("--output", type=str, default="video/outputs/stylized_video_manual.mp4")
    parser.add_argument("--frames_dir", type=str, default="input/videos/content_frames/")
    parser.add_argument("--styled_dir", type=str, default="input/videos/styled_frames/")
    parser.add_argument("--offset", type=float, default=0.30)
    parser.add_argument("--prominence", type=float, default=20.0)
    parser.add_argument("--fps", type=int, default=20)
    parser.add_argument(
        "--fast_stylizer", nargs="?", const=str(DISTILLED_NPZ), default=None, metavar="NPZ",
        help="Use the distilled feed-forward stylizer (the reference's magenta fast path, "
             "video/utils.py:108-154) with a single --style image instead of the AdaIN "
             "multi-style path. Optional value: a magenta npz checkpoint (default: the "
             "repository's docs/examples/magenta/magenta_distilled.npz).")
    parser.add_argument("--style", type=str, default=None,
                        help="Single style image (fast-stylizer path).")
    parser.add_argument("--flow", type=str, default="tvl1", choices=("tvl1", "farneback", "lk"))
    parser.add_argument("--device", type=str, default=None,
                        help="Torch device (default: cuda; raises without CUDA).")
    args = parser.parse_args(argv)

    from aip_tpu_torch.device import resolve_device
    from aip_tpu_torch.pipelines import video

    dev = resolve_device(args.device)
    if args.fast_stylizer:
        from aip_tpu_torch.models.magenta import load_magenta_npz, use_magenta_stylizer

        if args.style is None:
            parser.error("--fast_stylizer needs --style <image>")
        use_magenta_stylizer(load_magenta_npz(args.fast_stylizer, device=dev))
        video.clear_frames(args.frames_dir)
        video.clear_frames(args.styled_dir)
        video.video_to_frames(args.video, args.frames_dir)
        video.apply_style_transfer(args.frames_dir, args.style, args.styled_dir,
                                   target_resolution=(256, 256), flow_method=args.flow,
                                   device=dev)
        video.frames_to_video(args.styled_dir, args.output, fps=args.fps)
        out = str(args.output)
    else:
        out = video.run_style_transfer(
            selected_video=args.video, styles_dir=args.styles, content_dir=args.frames_dir,
            styled_dir=args.styled_dir, output_video=args.output, offset=args.offset,
            prominence=args.prominence, fps=args.fps, flow_method=args.flow, device=dev)
    print(f"Stylized video saved to {out}")
    return out


if __name__ == "__main__":
    main()
