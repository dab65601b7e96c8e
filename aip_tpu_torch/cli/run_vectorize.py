"""Pixel-art depixelization CLI (reference `pixel_art/utils.py:331-361`,
plus ``--device``). ``python -m aip_tpu_torch.cli.run_vectorize --input
sprite.png --output out/vectorized [--device cuda|cpu]``.

The depixelizer runs on the host in both packages; ``--device`` is resolved
as in every port CLI (the default, CUDA, raises without a card), so one
command line drives every pixel-art CLI."""

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description="Depixelize (vectorize) a pixel-art sprite.")
    parser.add_argument("--input", type=str, default="input/pixel_art/smw_dolphin_input.png")
    parser.add_argument("--output", type=str, default="pixel_art/outputs/vectorized_output")
    parser.add_argument("--scale", type=int, default=10)
    parser.add_argument("--device", type=str, default=None,
                        help="Torch device (default: cuda; raises without CUDA).")
    args = parser.parse_args(argv)

    from aip_tpu_torch.device import resolve_device
    from aip_tpu_torch.pipelines.pixel_art import vectorization

    resolve_device(args.device)
    out = vectorization(args.input, args.output, args.scale)
    print(f"Vectorized output: {out}")
    return out


if __name__ == "__main__":
    main()
