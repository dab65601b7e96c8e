"""Quaternion utilities for Gaussian splatting.

Port of ``aip_tpu/ops/quaternion.py`` (reference
``Style_3DGS/utils/general_utils.py``): the rotation matrix of a
normalised quaternion, the scale-rotation factor L = R diag(s), the 3D
covariance L L^T, its upper-triangle packing and the inverse sigmoid.
"""

from __future__ import annotations

import torch


def build_rotation(q: torch.Tensor) -> torch.Tensor:
    """[N, 4] (w, x, y, z) quaternions -> [N, 3, 3] rotation matrices.

    Normalizes first (general_utils.py:78-99).
    """
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    r, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    R = torch.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y),
            2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x),
            2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return R.reshape(-1, 3, 3)


def build_scaling_rotation(s: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """[N, 3] scales + [N, 4] quats -> L = R @ diag(s), [N, 3, 3]."""
    return build_rotation(q) * s[:, None, :]


def covariance_from_scaling_rotation(s: torch.Tensor, q: torch.Tensor,
                                     scaling_modifier: float = 1.0) -> torch.Tensor:
    """Per-Gaussian 3D covariance Sigma = L L^T, L = R diag(s·mod). [N, 3, 3]."""
    L = build_scaling_rotation(s * scaling_modifier, q)
    return L @ L.transpose(-1, -2)


def strip_symmetric(sym: torch.Tensor) -> torch.Tensor:
    """[N, 3, 3] symmetric -> [N, 6] upper-triangular packing
    (general_utils.py:64-77 ordering: 00, 01, 02, 11, 12, 22)."""
    return torch.stack([sym[:, 0, 0], sym[:, 0, 1], sym[:, 0, 2], sym[:, 1, 1], sym[:, 1, 2],
                        sym[:, 2, 2]], dim=-1)


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """general_utils.py:18."""
    return torch.log(x / (1.0 - x))
