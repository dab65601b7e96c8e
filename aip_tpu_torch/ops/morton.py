"""Morton (Z-order) encoding for spatial sorting of Gaussians.

Port of ``aip_tpu/ops/morton.py`` (reference ``utils/general_utils.py:
136-150`` and the sort at ``scene/gaussian_model.py:687-699``): 21 bits per
axis interleaved into a 63-bit code. ``morton_encode_np`` is the host copy.
``morton_argsort`` builds the same code in int64 (it stays below 2^63, so
signed order is the code's order) and sorts it stably, which is the order
of the JAX package's lexicographic (hi, lo) two-key sort.
"""

from __future__ import annotations

import numpy as np
import torch


def _split_by_3_u64(a: np.ndarray) -> np.ndarray:
    x = a.astype(np.uint64) & np.uint64(0x1FFFFF)
    x = (x | x << np.uint64(32)) & np.uint64(0x1F00000000FFFF)
    x = (x | x << np.uint64(16)) & np.uint64(0x1F0000FF0000FF)
    x = (x | x << np.uint64(8)) & np.uint64(0x100F00F00F00F00F)
    x = (x | x << np.uint64(4)) & np.uint64(0x10C30C30C30C30C3)
    x = (x | x << np.uint64(2)) & np.uint64(0x1249249249249249)
    return x


def morton_encode_np(pos_int: np.ndarray) -> np.ndarray:
    """[N, 3] integer grid coords (<2^21) -> [N] uint64 Morton codes (host)."""
    x, y, z = pos_int[:, 0], pos_int[:, 1], pos_int[:, 2]
    return (_split_by_3_u64(x) | _split_by_3_u64(y) << np.uint64(1)
            | _split_by_3_u64(z) << np.uint64(2))


_MASKS = ((32, 0x1F00000000FFFF), (16, 0x1F0000FF0000FF), (8, 0x100F00F00F00F00F),
          (4, 0x10C30C30C30C30C3), (2, 0x1249249249249249))


def _split_by_3(a: torch.Tensor) -> torch.Tensor:
    x = a.to(torch.int64) & 0x1FFFFF
    for shift, mask in _MASKS:
        x = (x | (x << shift)) & mask
    return x


def morton_encode(pos_int: torch.Tensor) -> torch.Tensor:
    """[N, 3] int grid coords (<2^21) -> [N] int64 Morton codes."""
    return (_split_by_3(pos_int[:, 0]) | (_split_by_3(pos_int[:, 1]) << 1)
            | (_split_by_3(pos_int[:, 2]) << 2))


def morton_argsort(positions: torch.Tensor, lower: torch.Tensor, upper: torch.Tensor) -> torch.Tensor:
    """Sort order of [N, 3] float positions along the Z-curve: quantise to a
    2^21 grid within [lower, upper] (gaussian_model.py:691-695), then a
    stable sort by code."""
    scale = (2.0 ** 21 - 1.0) / torch.clamp(upper - lower, min=1e-12)
    grid = torch.clamp((positions - lower) * scale, 0, 2.0 ** 21 - 1).to(torch.int64)
    return torch.sort(morton_encode(grid), stable=True).indices
