"""Carry a Gaussian scene across from the JAX package's arrays.

``from_jax_arrays`` takes ``aip_tpu``'s ``GaussianState`` and
``ColorFieldParams`` as dicts of numpy arrays (``state._asdict()`` with
each value passed through ``np.asarray``) and returns the port's, on
``device``. Field names and layouts are the same in both packages, so the
arrays move as they are: float32 stays float32, the active mask stays bool.
"""

from __future__ import annotations

import numpy as np
import torch

from aip_tpu_torch.device import resolve_device
from aip_tpu_torch.gs.colorfield import ColorFieldParams
from aip_tpu_torch.gs.gaussians import GaussianState


def _tensor(x, device):
    arr = np.ascontiguousarray(np.asarray(x))
    return torch.from_numpy(arr.copy()).to(device)


def from_jax_arrays(state_np: dict, field_np: dict | None, device=None):
    """(GaussianState, ColorFieldParams or None) from dicts of numpy arrays
    keyed by the JAX package's field names. ``device=None`` means CUDA."""
    dev = resolve_device(device)
    state = GaussianState(**{k: _tensor(state_np[k], dev) for k in GaussianState._fields})
    if field_np is None:
        return state, None
    field = ColorFieldParams(**{
        k: None if field_np.get(k) is None else _tensor(field_np[k], dev)
        for k in ColorFieldParams._fields})
    return state, field
