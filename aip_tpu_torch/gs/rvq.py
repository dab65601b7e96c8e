"""Residual vector quantization: the decode side.

Port of ``aip_tpu/gs/rvq.py``'s ``RVQState`` and ``decode``: codebooks are
a [Q, S, D] tensor and a reconstruction is the sum of one codeword per
quantizer, added in quantizer order (so the sums round as the JAX
package's do). Quantize and the codebook update belong to the training
slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class RVQState(NamedTuple):
    codebooks: torch.Tensor  # [Q, S, D]


def decode(state: RVQState, indices: torch.Tensor) -> torch.Tensor:
    """[N, Q] indices -> [N, D] reconstruction."""
    out = torch.zeros((), dtype=state.codebooks.dtype, device=state.codebooks.device)
    for q in range(state.codebooks.shape[0]):
        out = out + state.codebooks[q][indices[:, q]]
    return out
