"""AdaIN decoder trainer CLI (reference ``AdaIN/train.py:58-136`` arguments,
plus ``--device``). ``python -m aip_tpu_torch.cli.train_adain --content_dir
C --style_dir S [--max_iter 160000] [--device cuda|cpu]``.

Trains the decoder against the frozen normalised-VGG encoder with the
reference's loss and schedule on a (dp, tp) mesh of every card of the
device's kind (``parallel.mesh.make_mesh``, as the JAX CLI builds it; on one
card or the CPU a (1, 1) mesh). Every 100 iterations it
appends a record to ``<log_dir>/train_log.jsonl``; every
``--save_model_interval`` iterations, and at the last, it writes
``<save_dir>/decoder_iter_N.npz`` in the JAX package's layout (HWIO), which
``aip_tpu.models.weights.load_params_npz`` reads. The decoder starts from
``init_decoder_params(0)``, drawn from a ``torch.Generator``.
"""

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--content_dir", type=str, required=True,
                        help="Directory path to a batch of content images")
    parser.add_argument("--style_dir", type=str, required=True,
                        help="Directory path to a batch of style images")
    parser.add_argument("--vgg", type=str, default=None,
                        help="Optional torch vgg_normalised.pth to convert")
    parser.add_argument("--save_dir", default="./experiments")
    parser.add_argument("--log_dir", default="./logs")
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--lr_decay", type=float, default=5e-5)
    parser.add_argument("--max_iter", type=int, default=160000)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--style_weight", type=float, default=10.0)
    parser.add_argument("--content_weight", type=float, default=1.0)
    parser.add_argument("--n_threads", type=int, default=16)
    parser.add_argument("--save_model_interval", type=int, default=10000)
    parser.add_argument("--crop", type=int, default=256)
    parser.add_argument("--device", type=str, default=None,
                        help="Torch device (default: cuda; raises without CUDA).")
    args = parser.parse_args(argv)

    import json
    from pathlib import Path

    import torch

    from aip_tpu_torch.data.images import FlatFolderDataset, infinite_batches
    from aip_tpu_torch.device import resolve_device
    from aip_tpu_torch.models import decoder as dec_mod
    from aip_tpu_torch.models import weights as weights_mod
    from aip_tpu_torch.parallel import train as ptrain
    from aip_tpu_torch.parallel.mesh import local_devices, make_mesh

    dev = resolve_device(args.device)
    save_dir = Path(args.save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    log_path = Path(args.log_dir) / "train_log.jsonl"
    log_path.parent.mkdir(parents=True, exist_ok=True)

    vgg_params = weights_mod.get_vgg_params(args.vgg, device=dev)
    dec_params = dec_mod.init_decoder_params(0, device=dev)

    mesh = make_mesh(local_devices(dev), ("dp", "tp"))
    optimizer = ptrain.make_optimizer(args.lr, args.lr_decay)
    vgg_params, state = ptrain.shard_train_setup(mesh, vgg_params, dec_params, optimizer)
    step = ptrain.compile_train_step(
        mesh, optimizer, vgg_params,
        style_weight=args.style_weight, content_weight=args.content_weight,
    )

    content_ds = FlatFolderDataset(args.content_dir)
    style_ds = FlatFolderDataset(args.style_dir)
    content_iter = infinite_batches(content_ds, args.batch_size, seed=0, crop=args.crop,
                                    num_workers=args.n_threads)
    style_iter = infinite_batches(style_ds, args.batch_size, seed=1, crop=args.crop,
                                  num_workers=args.n_threads)

    with open(log_path, "a") as log:
        for i in range(args.max_iter):
            content = torch.from_numpy(next(content_iter)).to(dev)
            style = torch.from_numpy(next(style_iter)).to(dev)
            state, metrics = step(state, content, style)
            if (i + 1) % 100 == 0:
                rec = {"iter": i + 1,
                       "loss_content": float(metrics["loss_content"]) * args.content_weight,
                       "loss_style": float(metrics["loss_style"]) * args.style_weight}
                log.write(json.dumps(rec) + "\n")
                log.flush()
            if (i + 1) % args.save_model_interval == 0 or (i + 1) == args.max_iter:
                weights_mod.save_params_npz(weights_mod.hwio_params(state.params),
                                            save_dir / f"decoder_iter_{i + 1}.npz")
    return str(save_dir)


if __name__ == "__main__":
    main()
