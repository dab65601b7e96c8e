"""Device meshes. Port of ``aip_tpu.parallel.mesh``.

A mesh in the port is a grid of ``torch.device``s held by one process, as
the JAX package's ``Mesh`` is a grid of the local devices of one
controller: a numpy object array of devices with named axes. Devices may
repeat: a mesh of eight ``cpu`` devices mirrors the JAX tests' 8-device
virtual CPU mesh, and a mesh of ``[cuda:0, cuda:0]`` runs every split,
gather and reduction of a sharded path on one card. The collectives XLA
inserts are tensor moves in a fixed shard order (``parallel.sharding``).
"""

from __future__ import annotations

import math
from collections import OrderedDict

import numpy as np
import torch

from aip_tpu_torch.device import resolve_device


def canonical(device) -> torch.device:
    """``device`` as a ``torch.device`` with its index (``cuda`` is the
    current card), so that equal devices compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A grid of devices with named axes (``jax.sharding.Mesh``'s
    ``devices``, ``axis_names``, ``shape`` and ``size``). The first device
    is the mesh's home: replicated values live there between steps."""

    def __init__(self, devices, axis_names):
        flat = [canonical(d) for d in np.asarray(devices, dtype=object).reshape(-1)]
        shape = np.shape(np.asarray(devices, dtype=object))
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"{len(axis_names)} axis names for a device grid of shape {shape}")
        grid = np.empty(len(flat), dtype=object)
        grid[:] = flat
        self.devices = grid.reshape(shape)
        self.axis_names = axis_names

    @property
    def shape(self) -> OrderedDict:
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def home(self) -> torch.device:
        return self.devices.flat[0]

    def axis_devices(self, axis: str) -> list:
        """The devices along ``axis``, every other axis at index 0: the
        devices a value sharded over ``axis`` (and replicated over the
        rest) is split across, in shard order."""
        i = self.axis_names.index(axis)
        index = [0] * self.devices.ndim
        index[i] = slice(None)
        return list(self.devices[tuple(index)])

    def __repr__(self) -> str:
        return f"Mesh({dict(self.shape)}, {[str(d) for d in self.devices.flat]})"


def local_devices(device=None) -> list:
    """The devices a call on ``device`` may spread over: every CUDA card
    for a CUDA device (``None`` means CUDA), the one device otherwise."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def best_grid(n: int, n_axes: int = 2) -> tuple[int, ...]:
    """Factor ``n`` devices into a near-square grid (dp-major)."""
    if n_axes == 1:
        return (n,)
    a = int(math.sqrt(n))
    while n % a:
        a -= 1
    return (n // a, a)


def make_mesh(devices=None, axis_names=("dp", "tp"), shape=None) -> Mesh:
    """A Mesh over the given devices (default: every CUDA card).

    With the default two axes, devices factor into a near-square (dp, tp)
    grid; pass ``shape`` to override (e.g. ``(n, 1)`` for pure data
    parallelism). A shape that does not hold the devices raises."""
    if devices is None:
        devices = local_devices()
    devices = list(devices)
    n = len(devices)
    if shape is None:
        shape = best_grid(n, len(axis_names))
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    grid = np.empty(n, dtype=object)
    grid[:] = [canonical(d) for d in devices]
    return Mesh(grid.reshape(shape), axis_names)


def make_dp_mesh(n: int, device=None) -> "Mesh | None":
    """(dp,) mesh over ``cuda:0 ... cuda:n-1``, or None for n <= 1: the
    constructor behind every ``--mesh_dp`` flag. Fewer cards than ``n``
    raise ``ValueError`` (no smaller mesh is built). ``device="cpu"`` gives
    ``n`` repeated CPU devices (the CPU's stand-in for several cards)."""
    if not n or n <= 1:
        return None
    dev = resolve_device(device)
    if dev.type == "cuda":
        devices = local_devices(dev)
        if len(devices) < n:
            raise ValueError(f"a dp mesh of {n} devices needs {n} CUDA cards, "
                             f"{len(devices)} are visible")
        devices = devices[:n]
    else:
        devices = [dev] * n
    return make_mesh(devices, axis_names=("dp",), shape=(n,))
