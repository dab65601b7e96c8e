"""k-nearest-neighbour distances for Gaussian scale initialisation.

Port of ``aip_tpu/ops/knn.py`` (the reference's ``distCUDA2``, used once at
``scene/gaussian_model.py:175``): each point's mean squared distance to its
3 nearest neighbours, self excluded, clamped below at 1e-7. Blocked brute
force: rows are taken ``block_size`` at a time against every point
(|a - b|^2 = |a|^2 + |b|^2 - 2 a.b), so 100k points never build an N^2
matrix.
"""

from __future__ import annotations

import torch


@torch.no_grad()
def mean_knn_sq_dist(points: torch.Tensor, k: int = 3, block_size: int = 4096) -> torch.Tensor:
    """[N, 3] points -> [N] mean squared distance to the k nearest neighbours."""
    x = points.to(torch.float32)
    n = x.shape[0]
    sq = torch.sum(x * x, dim=-1)
    out = torch.empty(n, dtype=torch.float32, device=x.device)
    for s in range(0, n, block_size):
        a = x[s:s + block_size]
        d2 = sq[s:s + block_size, None] + sq[None, :] - 2.0 * (a @ x.T)
        d2 = torch.clamp(d2, min=0.0)
        rows = torch.arange(a.shape[0], device=x.device)
        d2[rows, s + rows] = torch.inf   # self
        out[s:s + block_size] = torch.topk(d2, k, dim=1, largest=False).values.mean(dim=1)
    return torch.clamp(out, min=1e-7)
