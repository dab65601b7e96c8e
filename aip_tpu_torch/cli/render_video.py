"""Novel-view video rendering CLI (reference ``Style_3DGS/render_video.py``
argument surface: ellipse video, circular orbit, gaussian-jittered views).

Port of ``aip_tpu/cli/render_video.py``, plus ``--device`` (the CUDA card
by default, ``cpu`` for the plain path). ``--mesh_dp N`` above 1 renders
the ellipse video with the Gaussians split over N devices (N cards, or N
repeated CPU devices with ``--device cpu``).

    python -m aip_tpu_torch.cli.render_video -m MODEL_DIR --video --n_frames 120
"""

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description="Render novel-view videos of a trained scene.")
    parser.add_argument("--model_path", "-m", required=True)
    parser.add_argument("--style", type=str, default=None)
    parser.add_argument("--video", action="store_true", help="Ellipse-path video")
    parser.add_argument("--circular", action="store_true", help="Circular orbit frames")
    parser.add_argument("--gaussians", action="store_true", help="Jittered-view sweep")
    parser.add_argument("--radius", type=float, default=0.5)
    parser.add_argument("--n_frames", type=int, default=600)
    parser.add_argument("--std", type=float, default=0.03)
    parser.add_argument("--mean", type=float, default=0.0)
    parser.add_argument("--fps", type=int, default=30)
    parser.add_argument("--mesh_dp", type=int, default=0,
                        help="Gaussian-sharded rendering over the first N cards.")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA card).")
    args = parser.parse_args(argv)

    from aip_tpu_torch.gs import render_video as rv

    outputs = []
    if args.video or not (args.circular or args.gaussians):
        outputs.append(rv.render_video(args.model_path, args.style, n_frames=args.n_frames,
                                       fps=args.fps, mesh_dp=args.mesh_dp, device=args.device))
    if args.circular:
        outputs.append(rv.render_circular_video(args.model_path, args.style, radius=args.radius,
                                                n_frames=min(args.n_frames, 240),
                                                device=args.device))
    if args.gaussians:
        outputs.append(rv.gaussian_render(args.model_path, args.style, mean=args.mean,
                                          std=args.std, device=args.device))
    for o in outputs:
        print(o)
    return outputs


if __name__ == "__main__":
    main()
