"""Depth-parameter sweep harness (reference `main.py:8-45` parity, plus
``--device``): stylize one image over a grid of depth offsets/prominences
and save a side-by-side comparison figure. matplotlib is imported only
after the stylizations. ``python -m aip_tpu_torch.cli.sweep_depth
--content c.jpg --style s.jpg [--prominences 10 20] [--device cuda|cpu]``."""

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description="Depth-aware stylization parameter sweep.")
    parser.add_argument("--content", type=str, required=True)
    parser.add_argument("--style", type=str, required=True)
    parser.add_argument("--output", type=str, default="output")
    parser.add_argument("--offsets", type=float, nargs="+",
                        default=[0, 0.3, 0.5, 0.7, 1])
    parser.add_argument("--prominences", type=float, nargs="+", default=None,
                        help="Sweep prominence instead of offset (offset fixed at 0).")
    parser.add_argument("--device", type=str, default=None,
                        help="Torch device (default: cuda; raises without CUDA).")
    args = parser.parse_args(argv)

    from pathlib import Path

    from aip_tpu_torch.pipelines.adain_infer import adain_inference

    image_paths = []
    labels = []
    if args.prominences is not None:
        for p in args.prominences:
            image_paths.append(adain_inference(
                content_img=args.content, style_img=args.style,
                file_name=f"sweep_{p}_0", depth_prominence=p, depth_offset=0,
                use_depth=True, output=args.output, device=args.device))
            labels.append(f"prominence: {p}")
    else:
        for off in args.offsets:
            image_paths.append(adain_inference(
                content_img=args.content, style_img=args.style,
                file_name=f"sweep_20_{off}", depth_prominence=20,
                depth_offset=off, use_depth=True, output=args.output, device=args.device))
            labels.append(f"depth offset: {off}")

    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt
    from PIL import Image

    fig, axes = plt.subplots(1, len(image_paths), figsize=(4 * len(image_paths), 5))
    if len(image_paths) == 1:
        axes = [axes]
    for ax, path, label in zip(axes, image_paths, labels):
        ax.imshow(Image.open(path))
        ax.axis("off")
        ax.set_title(label)
    plt.tight_layout()
    out = Path(args.output) / "depth_values_comparison.png"
    plt.savefig(out)
    plt.close(fig)
    print(f"Comparison saved to {out}")
    return str(out)


if __name__ == "__main__":
    main()
