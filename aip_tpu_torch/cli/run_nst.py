"""Optimization NST CLI: single style, multi-style mixing, or spatial
variation (reference `mixing_texture_gyum/main.py`, `spatial_variation/` +
`gui/eight_page.py`), plus ``--device``. ``python -m aip_tpu_torch.cli.run_nst
--content c.png --style s.png [--steps 800] [--device cuda|cpu]``."""

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description="Gram-matrix optimization style transfer.")
    parser.add_argument("--content", type=str, required=True)
    parser.add_argument("--style", type=str, nargs="+", required=True,
                        help="One or more style images (multi-style mixes them).")
    parser.add_argument("--weights", type=float, nargs="*", default=None,
                        help="Per-style mixing weights (default uniform).")
    parser.add_argument("--mask", type=str, default=None,
                        help="R/G/B color-coded mask for spatial variation (needs exactly 3 styles).")
    parser.add_argument("--output", type=str, default="output/nst.png")
    parser.add_argument("--steps", type=int, default=800)
    parser.add_argument("--lr", type=float, default=0.003)
    parser.add_argument("--style_weight", type=float, default=1e5)
    parser.add_argument("--max_dim", type=int, default=1024)
    parser.add_argument("--device", type=str, default=None,
                        help="Torch device (default: cuda; raises without CUDA).")
    args = parser.parse_args(argv)

    from pathlib import Path

    import numpy as np
    from PIL import Image

    from aip_tpu_torch.pipelines import nst

    if args.mask is not None:
        if len(args.style) != 3:
            raise SystemExit("--mask requires exactly 3 styles (R/G/B regions).")
        out = nst.spatially_varying_style_transfer(
            args.content, *args.style, args.mask,
            num_steps=args.steps, lr=args.lr, style_weight=args.style_weight,
            max_dim=args.max_dim, device=args.device,
        )
    elif len(args.style) > 1:
        wts = args.weights or [1.0] * len(args.style)
        out = nst.mix_styles(
            args.content, list(zip(args.style, wts)),
            num_steps=args.steps, lr=args.lr, style_weight=args.style_weight,
            device=args.device,
        )
    else:
        out = nst.run_style_transfer(
            args.content, args.style[0],
            num_steps=args.steps, lr=args.lr, style_weight=args.style_weight,
            max_dim=args.max_dim, device=args.device,
        )

    Path(args.output).parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray((np.clip(out.cpu().numpy(), 0, 1) * 255).astype(np.uint8)).save(args.output)
    print(f"NST output: {args.output}")
    return args.output


if __name__ == "__main__":
    main()
