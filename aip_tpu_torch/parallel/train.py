"""AdaIN decoder training. Port of ``aip_tpu.parallel.train``.

Trains the decoder against a frozen VGG encoder with the reference's loss
(``Style_3DGS/AdaIN/net.py:139-152`` forward: content loss
``MSE(enc(g_t), t)`` plus style loss ``sum_i MSE(mean_i) + MSE(std_i)``
over relu1_1..relu4_1, weighted 1.0 / 10.0 per ``AdaIN/train.py:24-25,
121-123``) and the reference's optimizer schedule (Adam, lr 1e-4 with
``lr / (1 + 5e-5 * iter)`` decay, ``AdaIN/train.py:51-55,100``).

Adam is written out (``gs.train.adam_update``) with optax's conventions:
b1 0.9, b2 0.999, eps 1e-8 outside the square root, the schedule read at
the count before the increment (the first update uses ``lr``), bias
correction at count + 1. A step runs its forward and its backward inside
``device.fp32_convs``: the backward of the fused head and tail recomputes
through cuDNN convs, which PyTorch's default flags would run in TF32.

One device only: ``shard_train_setup`` and ``compile_train_step`` keep the
JAX package's names, place the state and return the step; a mesh of more
than one device raises (ROADMAP queue 1 item 9).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from aip_tpu_torch.device import fp32_convs, resolve_device
from aip_tpu_torch.gs.train import AdamState, adam_init, adam_update
from aip_tpu_torch.models.decoder import decoder_apply
from aip_tpu_torch.models.vgg import STYLE_TAPS, vgg_encode_with_intermediate
from aip_tpu_torch.ops.adain import adain, style_loss_terms

ADAM_EPS = 1e-8  # optax.adam's default


class TrainState(NamedTuple):
    params: torch.nn.Module   # the decoder, updated in place by each step
    opt_state: AdamState
    step: int


class Optimizer(NamedTuple):
    """``optax.adam(lambda count: lr / (1 + lr_decay * count))``."""
    lr: float
    lr_decay: float

    def schedule(self, count: torch.Tensor) -> torch.Tensor:
        """The learning rate at optimiser count ``count`` (float32, as optax
        evaluates it)."""
        return torch.tensor(self.lr, dtype=torch.float32) / (
            1.0 + self.lr_decay * count.to(torch.float32))

    def init(self, params: dict) -> AdamState:
        return adam_init(params)

    def update(self, grads: dict, state: AdamState, params: dict):
        """(new params, new state): one Adam step at ``schedule(count)``."""
        lr = self.schedule(state.count)
        return adam_update(params, grads, state, dict.fromkeys(params, lr), eps=ADAM_EPS)


def make_optimizer(lr: float = 1e-4, lr_decay: float = 5e-5) -> Optimizer:
    """Adam with the reference's inverse-linear decay (train.py:51-55)."""
    return Optimizer(lr, lr_decay)


def _trainable(module: torch.nn.Module) -> dict:
    return {k: p.detach() for k, p in module.named_parameters()}


def init_train_state(dec_params: torch.nn.Module, optimizer: Optimizer) -> TrainState:
    return TrainState(dec_params, optimizer.init(_trainable(dec_params)), 0)


def adain_train_loss(
    dec_params,
    vgg_params,
    content: torch.Tensor,
    style: torch.Tensor,
    style_weight: float = 10.0,
    content_weight: float = 1.0,
    compute_dtype=torch.float32,
    style_taps=STYLE_TAPS,
):
    """Reference Net.forward semantics (net.py:139-152), alpha=1. Returns
    (loss, (loss_content, loss_style)), float32 (float64 when computed in
    float64). The content encode asks for relu4_1 alone, so it runs the
    fused head; the style and g_t encodes ask for relu1_1 and take the layer
    path; the decoder's tail is the fused tail. ``style_taps`` picks the
    style terms (the reference's four by default; the card's checks take
    relu1_1 alone, a term that reaches no max pool)."""
    acc = torch.promote_types(compute_dtype, torch.float32)
    taps = tuple(dict.fromkeys((*style_taps, "relu4_1")))
    style_feats = vgg_encode_with_intermediate(vgg_params, style, taps, compute_dtype)
    content_feat = vgg_encode_with_intermediate(vgg_params, content, ("relu4_1",),
                                                compute_dtype)["relu4_1"]
    t = adain(content_feat, style_feats["relu4_1"]).to(compute_dtype)
    g_t = decoder_apply(dec_params, t, compute_dtype)
    g_t_feats = vgg_encode_with_intermediate(vgg_params, g_t, taps, compute_dtype)

    loss_c = torch.mean((g_t_feats["relu4_1"].to(acc) - t.to(acc)) ** 2)
    loss_s = torch.zeros((), dtype=acc, device=content.device)
    for tap in style_taps:
        loss_s = loss_s + style_loss_terms(g_t_feats[tap], style_feats[tap])
    return content_weight * loss_c + style_weight * loss_s, (loss_c, loss_s)


def train_loss_and_grads(dec_params, vgg_params, content, style, style_weight: float = 10.0,
                         content_weight: float = 1.0, compute_dtype=torch.float32,
                         style_taps=STYLE_TAPS):
    """A train step's forward and backward: ``adain_train_loss`` and its
    gradient to every decoder parameter, both inside ``fp32_convs``.
    Returns (loss, (loss_content, loss_style), {name: gradient})."""
    names, leaves = zip(*dec_params.named_parameters())
    with fp32_convs():
        loss, aux = adain_train_loss(dec_params, vgg_params, content, style, style_weight,
                                     content_weight, compute_dtype, style_taps)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tuple(a.detach() for a in aux), dict(zip(names, grads))


def make_train_step(optimizer: Optimizer, vgg_params, compute_dtype=torch.float32,
                    style_weight: float = 10.0, content_weight: float = 1.0):
    """The train step: ``step(state, content, style) -> (state, metrics)``.
    The VGG is frozen (its parameters stop requiring gradients); the
    decoder's parameters are updated in place."""
    vgg_params.requires_grad_(False)

    def step(state: TrainState, content: torch.Tensor, style: torch.Tensor):
        dec = state.params
        loss, (lc, ls), grads = train_loss_and_grads(dec, vgg_params, content, style,
                                                     style_weight, content_weight,
                                                     compute_dtype)
        lr = optimizer.schedule(state.opt_state.count)
        new, opt_state = optimizer.update(grads, state.opt_state, _trainable(dec))
        with torch.no_grad():
            for name, p in dec.named_parameters():
                p.copy_(new[name])
        return TrainState(dec, opt_state, state.step + 1), {
            "loss": loss, "loss_content": lc, "loss_style": ls, "lr": lr}

    return step


def single_device(mesh) -> torch.device:
    """The one device of ``mesh`` (a device, a name or a sequence of them;
    None means CUDA). More than one raises."""
    devices = list(mesh) if isinstance(mesh, (list, tuple)) else [mesh]
    if len(devices) > 1:
        raise NotImplementedError(
            f"a mesh of {len(devices)} devices is the multi-GPU slice of the port "
            "(ROADMAP queue 1 item 9)")
    return resolve_device(devices[0])


def shard_train_setup(mesh, vgg_params, dec_params, optimizer: Optimizer):
    """Place the frozen VGG and the decoder on the mesh's one device and
    build the train state. Returns (vgg_params, state)."""
    dev = single_device(mesh)
    vgg_params = vgg_params.to(dev).requires_grad_(False)
    return vgg_params, init_train_state(dec_params.to(dev), optimizer)


def compile_train_step(mesh, optimizer: Optimizer, vgg_params, batch_shape=None,
                       compute_dtype=torch.float32,
                       style_weight: float = 10.0, content_weight: float = 1.0):
    """The step of ``make_train_step`` for the mesh's one device (eager: no
    compilation)."""
    single_device(mesh)
    return make_train_step(optimizer, vgg_params, compute_dtype, style_weight,
                           content_weight)
