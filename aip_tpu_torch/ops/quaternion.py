"""Quaternion utilities for Gaussian splatting.

Port of ``aip_tpu/ops/quaternion.py`` (reference
``Style_3DGS/utils/general_utils.py``): the inference part, the rotation
matrix of a normalised quaternion and the inverse sigmoid.
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


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """general_utils.py:18."""
    return torch.log(x / (1.0 - x))
