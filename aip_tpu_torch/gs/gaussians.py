"""Gaussian parameter state: the inference part.

Port of ``aip_tpu/gs/gaussians.py``: the fixed-capacity state with its
``active`` mask (``GaussianState`` :34) and the activations
(``get_scaling`` / ``get_opacity`` / ``get_rotation`` :54-66). Tensors keep
the JAX layouts ([C, 3] means, [C, 1] logits, [C] mask). Densification,
pruning and ``create_from_pcd`` belong to the training slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class GaussianState(NamedTuple):
    xyz: torch.Tensor        # [C, 3]
    scaling: torch.Tensor    # [C, 3] log-scale
    rotation: torch.Tensor   # [C, 4] unnormalized quaternion
    opacity: torch.Tensor    # [C, 1] logit
    mask: torch.Tensor       # [C, 1] learnable gate logits
    active: torch.Tensor     # [C] bool
    max_radii2d: torch.Tensor    # [C]
    xyz_grad_accum: torch.Tensor  # [C, 1]
    denom: torch.Tensor      # [C, 1]

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def n_active(self) -> torch.Tensor:
        return self.active.sum()

    def to(self, device) -> "GaussianState":
        return GaussianState(*(t.to(device) for t in self))


def get_scaling(state: GaussianState) -> torch.Tensor:
    return torch.exp(state.scaling)


def get_opacity(state: GaussianState) -> torch.Tensor:
    return torch.sigmoid(state.opacity)


def get_rotation(state: GaussianState) -> torch.Tensor:
    return state.rotation / torch.linalg.norm(state.rotation, dim=-1, keepdim=True)
