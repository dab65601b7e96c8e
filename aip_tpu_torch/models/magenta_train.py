"""Distillation trainer for the magenta-style fast stylizer. Port of
``aip_tpu.models.magenta_train``.

The reference's fast video path loads a pretrained TF-Hub module
(``video/utils.py:14``); the JAX package trains the equivalent instead: the
AdaIN pipeline is the teacher and the magenta transformer + predictor
(``models/magenta.py``) learns to reproduce its stylizations. Loss per
(content batch, style):

    student = magenta(params, content, style)
    teacher = AdaIN(content, style, alpha=1), clipped to [0, 1], no gradient
    L = ||student - teacher||^2 + lambda_feat * ||phi(student) - phi(teacher)||^2

with phi the frozen VGG's relu4_1 features: on a CUDA tensor the student's
encode runs the fused head kernel with a gradient (its backward recomputes
through cuDNN convs). A step runs its forward and backward inside
``device.fp32_convs``.

The teacher runs in fp32, so that the whole step is fp32 (the fp32 head
and tail kernels); the JAX package's teacher is ``stylize_simple`` at its
default, bf16 (a recorded difference, ROADMAP queue 3). ``params=``
resumes from weights only, with fresh Adam moments and the schedule
restarted, as the JAX package does.
"""

from __future__ import annotations

from pathlib import Path

import torch

from aip_tpu_torch.device import check_module_device, fp32_convs, resolve_device
from aip_tpu_torch.models import magenta as M


def _named(params: M.MagentaParams) -> list[tuple[str, torch.nn.Parameter]]:
    return ([(f"transform.{k}", p) for k, p in params.transform.named_parameters()]
            + [(f"predictor.{k}", p) for k, p in params.predictor.named_parameters()])


def distill_loss(params, vgg_params, dec_params, content, style,
                 lambda_feat: float = 0.1):
    """Scalar distillation loss for a content batch against ONE style.

    content [N, H, W, 3]; style [Hs, Ws, 3]; both float in [0, 1], on the
    models' device.
    """
    from aip_tpu_torch.models.vgg import vgg_encode
    from aip_tpu_torch.pipelines.adain_infer import stylize_simple

    teacher = stylize_simple(vgg_params, dec_params, content, style[None], alpha=1.0,
                             compute_dtype=torch.float32, device=content.device)
    teacher = torch.clamp(teacher, 0.0, 1.0)
    # The decoder emits 8*floor(H/8) rows; train at sizes where they agree.
    if teacher.shape != content.shape:
        raise ValueError(f"the teacher's shape {tuple(teacher.shape)} differs from the "
                         f"content's {tuple(content.shape)}: crop to a multiple of 8")
    student = M.stylize(params, content, style)
    pix = torch.mean((student - teacher) ** 2)
    f_s = vgg_encode(vgg_params, student, "relu4_1", torch.float32)
    with torch.no_grad():
        f_t = vgg_encode(vgg_params, teacher, "relu4_1", torch.float32)
    feat = torch.mean((f_s - f_t) ** 2)
    return pix + lambda_feat * feat


def distill_loss_and_grads(params, vgg_params, dec_params, content, style,
                           lambda_feat: float = 0.1):
    """A distillation step's forward and backward: ``distill_loss`` and its
    gradient to every stylizer parameter, both inside ``fp32_convs``.
    Returns (loss, {name: gradient})."""
    names, leaves = zip(*_named(params))
    with fp32_convs():
        loss = distill_loss(params, vgg_params, dec_params, content, style,
                            lambda_feat=lambda_feat)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), dict(zip(names, grads))


def make_distill_step(optimizer, vgg_params, dec_params, lambda_feat: float = 0.1,
                      devices=None):
    """``step(params, opt_state, content, style) -> (params, opt_state,
    loss)``; ``params`` is updated in place. The VGG and the decoder are
    frozen. ``devices`` (a mesh axis's devices, in shard order) splits the
    content batch over them: each shard's loss and gradients on its own
    copies of the stylizer, the VGG and the decoder, the mean of the
    shards' losses and gradients (summed to the home device in shard order)
    for the update, the updated stylizer copied back to the others."""
    from aip_tpu_torch.parallel.sharding import (broadcast_parameters, mean_of,
                                                 replicate_module, split)

    vgg_params.requires_grad_(False)
    dec_params.requires_grad_(False)
    if devices is not None:
        vggs = replicate_module(vgg_params, devices)
        decs = replicate_module(dec_params, devices)
    replicas = {}

    def step(params, opt_state, content, style):
        named = _named(params)
        if devices is None:
            loss, grads = distill_loss_and_grads(params, vgg_params, dec_params, content, style,
                                                 lambda_feat)
        else:
            if replicas.get("of") is not params:
                replicas.clear()
                copies = [replicate_module(m, devices) for m in params]
                replicas.update(of=params, params=[M.MagentaParams(*c) for c in zip(*copies)])
            home = named[0][1].device
            results = [distill_loss_and_grads(p, v, d, c, style.to(c.device), lambda_feat)
                       for p, v, d, c in zip(replicas["params"], vggs, decs,
                                             split(content, devices).parts)]
            loss = mean_of([r[0] for r in results], home)
            grads = {k: mean_of([r[1][k] for r in results], home) for k, _ in named}
        new, opt_state = optimizer.update(grads, opt_state, {k: p.detach() for k, p in named})
        with torch.no_grad():
            for name, p in named:
                p.copy_(new[name])
        if devices is not None:
            for module, copies in zip(params, zip(*replicas["params"])):
                broadcast_parameters(module, copies)
        return params, opt_state, loss

    return step


def train_magenta_distill(
    content_dir,
    style_dir,
    steps: int = 40_000,
    batch_size: int = 8,
    crop: int = 256,
    lr: float = 1e-3,
    lr_decay: float = 5e-5,
    lambda_feat: float = 0.1,
    predictor_trunk: str = "compact",
    save_path=None,
    save_every: int = 10_000,
    seed: int = 0,
    log_every: int = 100,
    params: "M.MagentaParams | None" = None,
    mesh=None,
    mesh_axis: str = "dp",
    device=None,
):
    """Train the fast stylizer by distilling the AdaIN teacher.

    Mirrors the AdaIN trainer's data plumbing (``cli/train_adain.py`` /
    reference ``AdaIN/train.py:58-136``): flat content/style folders, random
    resize+crop, inverse-time lr decay. ``mesh`` (a ``parallel.mesh.Mesh``,
    or a device or list of devices as a (dp,) mesh) shards the content
    batch over ``mesh_axis``; the models live on its home device. Returns
    (params, last_loss).
    """
    from aip_tpu_torch.data.images import FlatFolderDataset, infinite_batches
    from aip_tpu_torch.models import weights as weights_mod
    from aip_tpu_torch.parallel.train import as_mesh, make_optimizer

    devices = None
    if mesh is None:
        dev = resolve_device(device)
    else:
        mesh = as_mesh(mesh)
        dev = resolve_device(mesh.home)
        devices = mesh.axis_devices(mesh_axis)
    vgg_params = weights_mod.get_vgg_params(device=dev)
    dec_params = weights_mod.get_decoder_params(device=dev)
    if params is None:
        params = M.init_magenta_params(torch.Generator().manual_seed(seed),
                                       predictor_trunk=predictor_trunk, device=dev)
    for module in params:
        check_module_device(module, dev)

    optimizer = make_optimizer(lr, lr_decay)  # reference inverse-linear decay
    opt_state = optimizer.init({k: p.detach() for k, p in _named(params)})
    step = make_distill_step(optimizer, vgg_params, dec_params, lambda_feat=lambda_feat,
                             devices=devices)

    content_ds = FlatFolderDataset(content_dir)
    style_ds = FlatFolderDataset(style_dir)
    content_it = infinite_batches(content_ds, batch_size, seed=seed, crop=crop)
    style_it = infinite_batches(style_ds, 1, seed=seed + 1, crop=crop)

    loss = float("nan")
    for it in range(1, steps + 1):
        content = torch.from_numpy(next(content_it)).to(dev)
        style = torch.from_numpy(next(style_it)[0]).to(dev)
        params, opt_state, loss = step(params, opt_state, content, style)
        if log_every and it % log_every == 0:
            print(f"distill iter {it}: loss={float(loss):.5f}")
        if save_path is not None and (it % save_every == 0 or it == steps):
            M.save_magenta_npz(params, Path(save_path))
    return params, float(loss)
