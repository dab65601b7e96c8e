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

On a mesh (``parallel.mesh``; a device or a list of devices is a (dp,)
mesh), ``shard_train_setup`` and ``compile_train_step`` give the JAX
package's sharded step:

* data parallelism over ``dp``: the batch is split over the dp devices,
  each with its own copy of the frozen VGG and of the decoder; each shard
  computes its loss and gradients, the loss is the mean over the shards
  (of equal size) and the gradients are summed to the home device in shard
  order and divided, which is the gradient of the whole batch's mean loss;
  Adam updates the home copy and the updated parameters are copied back to
  the others;
* tensor parallelism over ``tp``: every decoder conv with at least 64
  output channels that tp divides becomes a ``ColumnParallelConv``, its
  output channels split over the tp devices (slice t on the mesh's device
  (row, t)); each slice's conv runs on its device and the outputs are
  concatenated (the all-gather XLA inserts before a consumer that needs
  every channel). ``decode_tail``'s 64-channel conv takes the gathered
  weight. Adam is elementwise, so updating the slices one by one is the
  update of the whole weight, and the split survives every step.
"""

from __future__ import annotations

import copy
from typing import NamedTuple

import torch
import torch.nn.functional as F

from aip_tpu_torch.device import fp32_convs
from aip_tpu_torch.gs.train import AdamState, adam_init, adam_update
from aip_tpu_torch.models.decoder import decoder_apply
from aip_tpu_torch.models.vgg import STYLE_TAPS, vgg_encode_with_intermediate
from aip_tpu_torch.ops.adain import adain, style_loss_terms
from aip_tpu_torch.parallel.mesh import Mesh, canonical, make_mesh
from aip_tpu_torch.parallel.sharding import (Sharded, broadcast_parameters, mean_of,
                                             replicate_module, split)

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
                    style_weight: float = 10.0, content_weight: float = 1.0,
                    style_taps=STYLE_TAPS):
    """The train step: ``step(state, content, style) -> (state, metrics)``.
    The VGG is frozen (its parameters stop requiring gradients); the
    decoder's parameters are updated in place. ``style_taps`` as in
    ``adain_train_loss``."""
    vgg_params.requires_grad_(False)

    def step(state: TrainState, content: torch.Tensor, style: torch.Tensor):
        dec = state.params
        loss, (lc, ls), grads = train_loss_and_grads(dec, vgg_params, content, style,
                                                     style_weight, content_weight,
                                                     compute_dtype, style_taps)
        lr = optimizer.schedule(state.opt_state.count)
        new, opt_state = optimizer.update(grads, state.opt_state, _trainable(dec))
        with torch.no_grad():
            for name, p in dec.named_parameters():
                p.copy_(new[name])
        return TrainState(dec, opt_state, state.step + 1), {
            "loss": loss, "loss_content": lc, "loss_style": ls, "lr": lr}

    return step


class ColumnParallelConv(torch.nn.Module):
    """A 3x3 conv whose output channels are split over devices: slice t of
    the weight and bias on ``devices[t]``. ``weight`` and ``bias`` are the
    gathered tensors on the first device; calling it on a padded NCHW
    input runs each slice's conv on its device and concatenates the
    channels on the input's device."""

    def __init__(self, conv: torch.nn.Module, devices):
        super().__init__()
        self.devices = [canonical(d) for d in devices]
        n = len(self.devices)
        self.weight_shards = torch.nn.ParameterList(
            torch.nn.Parameter(w.detach().to(d).clone())
            for w, d in zip(torch.chunk(conv.weight, n, 0), self.devices))
        self.bias_shards = torch.nn.ParameterList(
            torch.nn.Parameter(b.detach().to(d).clone())
            for b, d in zip(torch.chunk(conv.bias, n, 0), self.devices))

    @property
    def weight(self) -> torch.Tensor:
        return torch.cat([w.to(self.devices[0]) for w in self.weight_shards])

    @property
    def bias(self) -> torch.Tensor:
        return torch.cat([b.to(self.devices[0]) for b in self.bias_shards])

    def forward(self, t: torch.Tensor, compute_dtype=torch.float32) -> torch.Tensor:
        return torch.cat([F.conv2d(t.to(d), w.to(compute_dtype), b.to(compute_dtype)).to(t.device)
                          for w, b, d in zip(self.weight_shards, self.bias_shards, self.devices)],
                         dim=1)

    def placed(self, devices) -> "ColumnParallelConv":
        """A copy with slice t on ``devices[t]``."""
        out = copy.deepcopy(self)
        out.devices = [canonical(d) for d in devices]
        for ps in (out.weight_shards, out.bias_shards):
            for p, d in zip(ps, out.devices):
                p.data = p.data.to(d)
        return out


def as_mesh(mesh) -> Mesh:
    """A Mesh as it is; a device, a name or a list of them as a (dp,)
    mesh."""
    if isinstance(mesh, Mesh):
        return mesh
    devices = list(mesh) if isinstance(mesh, (list, tuple)) else [mesh]
    return make_mesh(devices, axis_names=("dp",), shape=(len(devices),))


def _rows(mesh: Mesh) -> list:
    """Per dp index, the devices of its tp group (one device on a mesh
    without a tp axis)."""
    if mesh.axis_names not in (("dp",), ("dp", "tp")):
        raise ValueError(f"the AdaIN step takes a (dp,) or (dp, tp) mesh, got {mesh.axis_names}")
    return [list(row) for row in mesh.devices.reshape(mesh.shape["dp"], -1)]


def tensor_parallel_decoder(dec: torch.nn.Module, devices) -> torch.nn.Module:
    """The decoder with every conv that ``conv_param_sharding`` splits (O >=
    64, len(devices) divides O) made a ``ColumnParallelConv`` over
    ``devices``, the others on ``devices[0]``. Returns ``dec``, changed."""
    tp = len(devices)
    dec = dec.to(devices[0])
    if tp > 1:
        for i, conv in enumerate(dec.convs):
            o = conv.weight.shape[0]
            if o >= 64 and o % tp == 0:
                dec.convs[i] = ColumnParallelConv(conv, devices)
    return dec


def _placed_decoder(dec: torch.nn.Module, devices) -> torch.nn.Module:
    """A copy of a (tensor-parallel) decoder for another row of the mesh:
    split convs' slices on ``devices``, the rest on ``devices[0]``."""
    if [canonical(d) for d in devices] == _tp_of(dec):
        return dec
    out = copy.deepcopy(dec)
    for i, conv in enumerate(out.convs):
        out.convs[i] = (conv.placed(devices) if isinstance(conv, ColumnParallelConv)
                        else conv.to(devices[0]))
    return out


def _tp_of(dec) -> list:
    """The devices of a decoder's split convs (its first parameter's device
    when none is split)."""
    for conv in dec.convs:
        if isinstance(conv, ColumnParallelConv):
            return conv.devices
    return [canonical(next(dec.parameters()).device)]


def shard_train_setup(mesh, vgg_params, dec_params, optimizer: Optimizer):
    """Place the state on the mesh: the frozen VGG and the decoder on its
    home device, the decoder's wide convs split over ``tp`` (a mesh with a
    tp axis of more than one device). Returns (vgg_params, state)."""
    mesh = as_mesh(mesh)
    vgg_params = vgg_params.to(mesh.home).requires_grad_(False)
    dec = tensor_parallel_decoder(dec_params, _rows(mesh)[0])
    return vgg_params, init_train_state(dec, optimizer)


def compile_train_step(mesh, optimizer: Optimizer, vgg_params, batch_shape=None,
                       compute_dtype=torch.float32,
                       style_weight: float = 10.0, content_weight: float = 1.0,
                       style_taps=STYLE_TAPS):
    """The train step on the mesh (eager: no compilation). On a mesh of one
    device, ``make_train_step``. Otherwise the content and style batches
    (tensors, or ``Sharded`` from ``parallel.sharding.shard_batch``) are
    split over ``dp``, each row of the mesh runs its shard on its own
    copies of the VGG and the decoder, and the mean loss's gradient updates
    the home copy (module docstring)."""
    mesh = as_mesh(mesh)
    if mesh.size == 1:
        return make_train_step(optimizer, vgg_params, compute_dtype, style_weight,
                               content_weight, style_taps)
    vgg_params.requires_grad_(False)
    rows = _rows(mesh)
    row_home = [r[0] for r in rows]
    vggs = replicate_module(vgg_params, row_home)
    replicas = {}

    def step(state: TrainState, content, style):
        dec = state.params
        if replicas.get("of") is not dec:
            replicas.clear()
            replicas.update(of=dec, decs=[_placed_decoder(dec, r) for r in rows])
        home = row_home[0]
        shards = [x.parts if isinstance(x, Sharded) else split(x, row_home).parts
                  for x in (content, style)]
        results = [train_loss_and_grads(d, v, c, s, style_weight, content_weight, compute_dtype,
                                        style_taps)
                   for d, v, c, s in zip(replicas["decs"], vggs, *shards)]
        loss = mean_of([r[0] for r in results], home)
        lc = mean_of([r[1][0] for r in results], home)
        ls = mean_of([r[1][1] for r in results], home)
        params = _trainable(dec)
        grads = {k: mean_of([r[2][k] for r in results], p.device) for k, p in params.items()}
        lr = optimizer.schedule(state.opt_state.count)
        new, opt_state = optimizer.update(grads, state.opt_state, params)
        with torch.no_grad():
            for name, p in dec.named_parameters():
                p.copy_(new[name])
        broadcast_parameters(dec, replicas["decs"])
        return TrainState(dec, opt_state, state.step + 1), {
            "loss": loss, "loss_content": lc, "loss_style": ls, "lr": lr}

    return step
