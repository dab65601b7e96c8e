"""Palette pixelization CLI (reference `gui/second_page.py` Pixelize window
controls as flags, plus ``--device``). ``python -m
aip_tpu_torch.cli.run_pixelize --input img.png --palette pico-8 --method
Floyd-Steinberg [--device cuda|cpu]``."""

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description="Pixelize an image against a Lospec palette.")
    parser.add_argument("--input", type=str, required=True)
    parser.add_argument("--output", type=str, default="output/pixelized.png")
    parser.add_argument("--palette", type=str, default="pico-8",
                        help="Named palette from assets/lospec-palettes.json.")
    parser.add_argument("--method", type=str, default="RGB",
                        choices=["RGB", "LAB", "Floyd-Steinberg", "kd-tree"])
    parser.add_argument("--downsample", type=int, default=1)
    parser.add_argument("--grayscale", action="store_true")
    parser.add_argument("--brightness", type=float, default=0.0)
    parser.add_argument("--contrast", type=float, default=0.0)
    parser.add_argument("--device", type=str, default=None,
                        help="Torch device (default: cuda; raises without CUDA).")
    args = parser.parse_args(argv)

    from pathlib import Path

    from PIL import Image

    from aip_tpu_torch.pipelines.pixel_art import (
        hex_palette_to_rgb, load_lospec_palettes, pixelize,
    )

    palettes = load_lospec_palettes()
    if args.palette not in palettes:
        raise SystemExit(f"Unknown palette '{args.palette}'. Available: {sorted(palettes)}")
    pal = hex_palette_to_rgb(palettes[args.palette])
    out = pixelize(
        args.input, downsampling_factor=args.downsample, grayscale=args.grayscale,
        brightness=args.brightness, contrast=args.contrast,
        palette=pal, method=args.method, device=args.device,
    )
    Path(args.output).parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(out).save(args.output)
    print(f"Pixelized output: {args.output}")
    return args.output


if __name__ == "__main__":
    main()
