"""Regional style transfer CLI (reference `run_semantic_segm.py:17-44`
arguments, plus ``--device``). ``python -m aip_tpu_torch.cli.run_semantic_segm
--content c.jpg --style s.jpg [--use_depth] [--device cuda|cpu]``."""

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Run localized style transfer with background segmentation."
    )
    parser.add_argument("--content", type=str, required=True, help="Path to the content image.")
    parser.add_argument("--style", type=str, required=True, help="Path to the style image.")
    parser.add_argument("--output", type=str, default="output", help="Output directory.")
    parser.add_argument("--file_name", type=str, default="stylized",
                        help="Output file name without extension.")
    parser.add_argument("--use_depth", action="store_true",
                        help="Enable depth-aware stylization.")
    parser.add_argument("--device", type=str, default=None,
                        help="Torch device (default: cuda; raises without CUDA).")
    args = parser.parse_args(argv)

    from aip_tpu_torch.pipelines.localized import run_localized_style_transfer

    path = run_localized_style_transfer(
        content_img_path=args.content,
        style_img_path=args.style,
        output_path=args.output,
        file_name=args.file_name,
        use_depth=args.use_depth,
        device=args.device,
    )
    print(f"Result saved to {path}")
    return path


if __name__ == "__main__":
    main()
