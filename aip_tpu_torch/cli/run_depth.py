"""AdaIN stylisation CLI (reference ``AdaIN/run_depth.py:17-55`` arguments,
plus ``--device`` and the depth network's flags). ``python -m
aip_tpu_torch.cli.run_depth --content c.jpg --style s.jpg [--use_depth
[--depth_model midas_small|dpt_large|dpt_swin2_large_384]
[--depth_weights hub.pt]
[--save_depth]] [--device cuda|cpu]``."""

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Stylize an image using AdaIN style transfer."
    )
    parser.add_argument("--content", type=str, required=True, help="Path to the content image.")
    parser.add_argument("--style", type=str, required=True, help="Path to the style image.")
    parser.add_argument("--output", type=str, default="output", help="Output directory.")
    parser.add_argument("--file_name", type=str, default="stylized",
                        help="Output file name without extension.")
    parser.add_argument("--depth_offset", type=float, default=0.15,
                        help="Depth offset for depth-aware style transfer.")
    parser.add_argument("--depth_prominence", type=float, default=20,
                        help="Depth prominence factor.")
    parser.add_argument("--use_depth", action="store_true",
                        help="Enable depth-aware stylization.")
    parser.add_argument("--depth_model", type=str, default=None,
                        choices=("midas_small", "dpt_large", "dpt_swin2_large_384"),
                        help="Learned depth network (default: the classical proxy).")
    parser.add_argument("--depth_weights", type=str, default=None,
                        help="The depth network's hub state dict (default: seeded init).")
    parser.add_argument("--save_depth", action="store_true",
                        help="Also write <file_name>_depth.png (16-bit proximity).")
    parser.add_argument("--alpha", type=float, default=0.5,
                        help="Content/style blend factor.")
    parser.add_argument("--preserve_color", action="store_true",
                        help="CORAL-match style colors to the content.")
    parser.add_argument("--device", type=str, default=None,
                        help="Torch device (default: cuda; raises without CUDA).")
    args = parser.parse_args(argv)

    from aip_tpu_torch.pipelines.adain_infer import adain_inference

    path = adain_inference(
        content_img=args.content,
        style_img=args.style,
        depth_offset=args.depth_offset,
        depth_prominence=args.depth_prominence,
        output=args.output,
        file_name=args.file_name,
        use_depth=args.use_depth,
        depth_model=args.depth_model,
        depth_weights=args.depth_weights,
        save_depth=args.save_depth,
        alpha=args.alpha,
        preserve_color=args.preserve_color,
        device=args.device,
    )
    print(f"Image saved to {path}")
    return path


if __name__ == "__main__":
    main()
