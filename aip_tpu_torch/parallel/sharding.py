"""Placement rules and the collectives of the port's meshes. Port of
``aip_tpu.parallel.sharding``.

Conventions (the JAX package's):

* activations are NHWC: batch over ``dp``, channels over ``tp``;
* conv kernels split their output channels over ``tp`` (column-parallel)
  when there are at least 64 of them and ``tp`` divides them; everything
  else is replicated.

``replicated``, ``batch_sharding`` and ``conv_param_sharding`` return
``Sharding(mesh, spec)``: ``spec`` names, per tensor dimension, the mesh
axis it is split over (or None), as a ``PartitionSpec`` does.

The collectives XLA inserts are tensor moves in a fixed shard order here:
``split`` slices a tensor over an axis's devices, ``gather`` concatenates
the parts on one device (an all-gather), ``mean_of`` sums ``.to(home)``
copies in shard order and divides (a psum over shards of equal size).
Autograd through ``.to()`` and ``torch.cat`` sums a replicated leaf's
gradient over its per-device copies, the psum of ``shard_map``'s transpose.
"""

from __future__ import annotations

import copy
from typing import NamedTuple

import torch

from aip_tpu_torch.parallel.mesh import canonical


class Sharding(NamedTuple):
    """A placement on ``mesh``: ``spec[i]`` is the mesh axis dimension i is
    split over, or None (an empty spec: replicated)."""
    mesh: object
    spec: tuple


def replicated(mesh) -> Sharding:
    return Sharding(mesh, ())


def batch_sharding(mesh, dp_axis: str = "dp") -> Sharding:
    """NHWC activation: batch sharded over dp, rest replicated."""
    return Sharding(mesh, (dp_axis, None, None, None))


def _conv_spec(mesh, shape, out_dim: int, tp_size: int, tp_axis: str) -> Sharding:
    o = shape[out_dim]
    if o >= 64 and o % tp_size == 0:
        spec = [None] * len(shape)
        spec[out_dim] = tp_axis
        return Sharding(mesh, tuple(spec))
    return Sharding(mesh, ())


def conv_param_sharding(mesh, params, tp_axis: str = "tp"):
    """Placement of conv params. ``params`` is the JAX layout, a list of
    {'w': HWIO, 'b': [O]} (anything with a ``shape``), or a module of
    ``nn.Conv2d``s (``.convs``, OIHW): the same list of {'w': Sharding,
    'b': Sharding} with the output dimension split over ``tp_axis`` where
    O >= 64 and tp divides O."""
    tp_size = mesh.shape[tp_axis]
    if isinstance(params, torch.nn.Module):
        return [{"w": _conv_spec(mesh, tuple(c.weight.shape), 0, tp_size, tp_axis),
                 "b": _conv_spec(mesh, tuple(c.weight.shape[:1]), 0, tp_size, tp_axis)}
                for c in params.convs]
    return [{k: _conv_spec(mesh, tuple(v.shape), len(v.shape) - 1, tp_size, tp_axis)
             for k, v in p.items()} for p in params]


# ---------------------------------------------------------------------------
# Splits, gathers and sums
# ---------------------------------------------------------------------------

class Sharded(NamedTuple):
    """A value split over devices: ``parts[i]`` lies on ``devices[i]``, in
    shard order."""
    parts: tuple
    devices: tuple


def split(x: torch.Tensor, devices, dim: int = 0) -> Sharded:
    """``x`` cut into ``len(devices)`` equal parts along ``dim``, part i
    moved to ``devices[i]``. A size the count does not divide raises."""
    n = len(devices)
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of size {x.shape[dim]} does not split over "
                         f"{n} devices")
    return Sharded(tuple(p.to(d) for p, d in zip(torch.chunk(x, n, dim), devices)),
                   tuple(devices))


def shard_batch(mesh, x: torch.Tensor, axis: str = "dp") -> Sharded:
    """A batch's leading dimension split over ``axis``
    (``jax.device_put(x, batch_sharding(mesh))``)."""
    return split(x, mesh.axis_devices(axis))


def gather(parts, device, dim: int = 0) -> torch.Tensor:
    """The parts, in order, concatenated on ``device`` (an all-gather)."""
    if isinstance(parts, Sharded):
        parts = parts.parts
    return torch.cat([p.to(device) for p in parts], dim=dim)


def mean_of(values, device) -> torch.Tensor:
    """The mean of per-shard values on ``device``: their ``.to(device)``
    copies summed in shard order, over their count."""
    total = values[0].to(device)
    for v in values[1:]:
        total = total + v.to(device)
    return total / len(values)


def replicate_module(module: torch.nn.Module, devices) -> list:
    """One copy of ``module`` per device, in order: the module itself where
    a device is its own, else a deep copy moved there (made once per
    distinct device)."""
    copies = {canonical(next(module.parameters()).device): module}
    for d in map(canonical, devices):
        if d not in copies:
            copies[d] = copy.deepcopy(module).to(d)
    return [copies[canonical(d)] for d in devices]


@torch.no_grad()
def broadcast_parameters(module: torch.nn.Module, replicas) -> None:
    """Copy ``module``'s parameters into every other replica (after an
    update on the home copy)."""
    src = dict(module.named_parameters())
    for r in replicas:
        if r is not module:
            for name, p in r.named_parameters():
                p.copy_(src[name])
