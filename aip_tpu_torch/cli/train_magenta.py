"""Fast-stylizer distillation CLI (the arguments of ``aip_tpu.cli.
train_magenta``, plus ``--device``). ``python -m aip_tpu_torch.cli.
train_magenta --content_dir C --style_dir S [--max_iter 40000] [--device
cuda|cpu]``.

Trains the magenta-equivalent feed-forward stylizer (``models/magenta.py``)
by distilling the AdaIN teacher (``models/magenta_train.py``) and writes it
in the JAX package's npz layout. Data plumbing mirrors the AdaIN trainer
(reference ``AdaIN/train.py:58-136``). ``--mesh_dp > 1`` is the multi-GPU
slice of the port (ROADMAP queue 1 item 9) and raises.
"""

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--content_dir", type=str, required=True,
                        help="Directory path to a batch of content images")
    parser.add_argument("--style_dir", type=str, required=True,
                        help="Directory path to a batch of style images")
    parser.add_argument("--save_path", default="./experiments/magenta.npz")
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--lr_decay", type=float, default=5e-5)
    parser.add_argument("--max_iter", type=int, default=40000)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--crop", type=int, default=256)
    parser.add_argument("--lambda_feat", type=float, default=0.1)
    parser.add_argument("--predictor_trunk", default="compact",
                        choices=("compact", "mobilenet_v2"))
    parser.add_argument("--save_model_interval", type=int, default=10000)
    parser.add_argument("--mesh_dp", type=int, default=0,
                        help="Data-parallel over the first N devices.")
    parser.add_argument("--device", type=str, default=None,
                        help="Torch device (default: cuda; raises without CUDA).")
    args = parser.parse_args(argv)

    if args.mesh_dp > 1:
        raise NotImplementedError("--mesh_dp > 1 is the multi-GPU slice of the port "
                                  "(ROADMAP queue 1 item 9)")

    from pathlib import Path

    from aip_tpu_torch.models.magenta_train import train_magenta_distill

    Path(args.save_path).parent.mkdir(parents=True, exist_ok=True)
    _, loss = train_magenta_distill(
        args.content_dir, args.style_dir, steps=args.max_iter,
        batch_size=args.batch_size, crop=args.crop, lr=args.lr,
        lr_decay=args.lr_decay, lambda_feat=args.lambda_feat,
        predictor_trunk=args.predictor_trunk, save_path=args.save_path,
        save_every=args.save_model_interval, device=args.device,
    )
    print(f"final loss {loss:.5f}; saved to {args.save_path}")
    return args.save_path


if __name__ == "__main__":
    main()
