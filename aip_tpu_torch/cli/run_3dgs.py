"""Stylized 3DGS train + render CLI (reference ``run_3dgs.py:18-44``).

Port of ``aip_tpu/cli/run_3dgs.py``: ``run_3dgs_training`` then
``run_3dgs_rendering`` of the saved model. ``--device`` picks the card
(default) or ``cpu``; ``--views_per_step`` above 1, ``--mesh_dp`` above 1
and ``--gaussian_shard`` are the multi-GPU slice and raise.

    python -m aip_tpu_torch.cli.run_3dgs --content SCENE --style STYLE.png
"""

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train and render a stylized 3DGS scene.")
    parser.add_argument("--content", type=str, required=True,
                        help="Scene directory (COLMAP sparse/ or transforms_train.json).")
    parser.add_argument("--style", type=str, required=True, help="Path to the style image.")
    parser.add_argument("--output", type=str, default="output", help="Output directory.")
    parser.add_argument("--use_depth", action="store_true",
                        help="Enable depth-aware stylization of the guide images.")
    parser.add_argument("--iterations", type=int, default=15000)
    parser.add_argument("--freeze_iters", type=int, default=7000)
    parser.add_argument("--views_per_step", type=int, default=1)
    parser.add_argument("--mesh_dp", type=int, default=0)
    parser.add_argument("--gaussian_shard", action="store_true")
    parser.add_argument("-r", "--resolution", type=int, default=-1,
                        help="Camera downscale (reference -r rule: -1 native with >1.6K "
                             "auto-rescale; 2/4/8 divide).")
    parser.add_argument("--fit_train_selection", action="store_true",
                        help="Fit the pair-sort giant handling to the initial scene so "
                             "training renders never truncate giants.")
    parser.add_argument("--capacity", type=int, default=1 << 17)
    parser.add_argument("--log2_hashmap", type=int, default=19)
    parser.add_argument("--img_size", type=int, default=512,
                        help="Working size of the AdaIN style guides.")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA card).")
    args = parser.parse_args(argv)

    from aip_tpu_torch.gs.pipeline import run_3dgs_rendering, run_3dgs_training

    model_path = run_3dgs_training(
        args.content, args.style, model_path=args.output, iterations=args.iterations,
        freeze_iters=args.freeze_iters, use_depth=args.use_depth, depth_offset=0.5,
        depth_prominence=20, views_per_step=args.views_per_step, mesh_dp=args.mesh_dp,
        gaussian_shard=args.gaussian_shard, fit_train_selection=args.fit_train_selection,
        resolution=args.resolution, capacity=args.capacity, log2_hashmap=args.log2_hashmap,
        img_size=args.img_size, device=args.device)
    gif = run_3dgs_rendering(args.style, model_path, mesh_dp=args.mesh_dp, device=args.device)
    print(f"Render GIF: {gif}")
    return gif


if __name__ == "__main__":
    main()
