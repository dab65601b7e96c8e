"""Batch evaluation harness over standard benchmark scene sets.
Port of ``aip_tpu.gs.full_eval``.

Parity with reference `Style_3DGS/full_eval.py`: drives train -> render ->
metrics over the Mip-NeRF360 / Tanks&Temples / DeepBlending scene lists —
as direct function calls rather than ``os.system`` shell-outs.

As in the JAX package and the reference, the render step writes
``<model>/renders/*.png`` while ``evaluate`` reads
``<model>/test/<method>/{renders,gt}``, so the metrics step returns
``{model: {}}`` for a scene that was only trained and rendered.
``device=None`` means CUDA.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from aip_tpu_torch.device import resolve_device

MIPNERF360_OUTDOOR = ["bicycle", "flowers", "garden", "stump", "treehill"]
MIPNERF360_INDOOR = ["room", "counter", "kitchen", "bonsai"]
TANKS_AND_TEMPLES = ["truck", "train"]
DEEP_BLENDING = ["drjohnson", "playroom"]


def run_full_eval(
    style_image,
    output_path="./eval",
    mipnerf360=None,
    tanksandtemples=None,
    deepblending=None,
    skip_training=False,
    skip_rendering=False,
    skip_metrics=False,
    iterations: int = 15_000,
    freeze_iters: int = 7_000,
    views_per_step: int = 1,
    mesh_dp: int = 0,
    gaussian_shard: bool = False,
    device=None,
):
    from aip_tpu_torch.gs import pipeline
    from aip_tpu_torch.gs.metrics_cli import evaluate

    dev = resolve_device(device)
    scene_sources = []
    if mipnerf360:
        for s in MIPNERF360_OUTDOOR + MIPNERF360_INDOOR:
            scene_sources.append((s, str(Path(mipnerf360) / s)))
    if tanksandtemples:
        for s in TANKS_AND_TEMPLES:
            scene_sources.append((s, str(Path(tanksandtemples) / s)))
    if deepblending:
        for s in DEEP_BLENDING:
            scene_sources.append((s, str(Path(deepblending) / s)))

    model_paths = []
    for scene, source in scene_sources:
        model_path = str(Path(output_path) / scene)
        model_paths.append(model_path)
        if not skip_training:
            pipeline.run_3dgs_training(source, style_image, model_path=model_path,
                                       iterations=iterations, freeze_iters=freeze_iters,
                                       views_per_step=views_per_step, mesh_dp=mesh_dp,
                                       gaussian_shard=gaussian_shard, device=dev)
        if not skip_rendering:
            pipeline.run_3dgs_rendering(style_image, model_path, mesh_dp=mesh_dp, device=dev)
    if not skip_metrics:
        return evaluate(model_paths, device=dev)
    return {}


def main(argv=None):
    parser = argparse.ArgumentParser(description="Full evaluation script parameters")
    parser.add_argument("--style", required=True)
    parser.add_argument("--skip_training", action="store_true")
    parser.add_argument("--skip_rendering", action="store_true")
    parser.add_argument("--skip_metrics", action="store_true")
    parser.add_argument("--output_path", default="./eval")
    parser.add_argument("--mipnerf360", "-m360", type=str, default=None)
    parser.add_argument("--tanksandtemples", "-tat", type=str, default=None)
    parser.add_argument("--deepblending", "-db", type=str, default=None)
    parser.add_argument("--views_per_step", type=int, default=1)
    parser.add_argument("--mesh_dp", type=int, default=0)
    parser.add_argument("--gaussian_shard", action="store_true")
    parser.add_argument("--device", type=str, default=None,
                        help="Torch device (default: cuda; raises without CUDA).")
    args = parser.parse_args(argv)
    out = run_full_eval(
        args.style, args.output_path, args.mipnerf360, args.tanksandtemples,
        args.deepblending, args.skip_training, args.skip_rendering,
        args.skip_metrics, views_per_step=args.views_per_step,
        mesh_dp=args.mesh_dp, gaussian_shard=args.gaussian_shard, device=args.device,
    )
    print(out)
    return out


if __name__ == "__main__":
    main()
