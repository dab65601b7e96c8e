"""Residual vector quantization for Gaussian scale/rotation compression.

Port of ``aip_tpu/gs/rvq.py`` (the reference's ``ResidualVQ``,
``scene/gaussian_model.py:70-71``): codebooks are a [Q, S, D] tensor;
``quantize`` runs the residual cascade with a straight-through gradient,
``kmeans_init`` seeds codebooks from data, ``update_codebooks`` takes one
masked means step, ``decode`` sums one codeword per quantizer in quantizer
order (so the sums round as the JAX package's do).

``kmeans_init``'s random start is ``starts[q]`` (row indices, one array per
quantizer) when given, else drawn from a ``torch.Generator``; the JAX
package draws it with ``jax.random.choice``, so tests hand both the same
rows. The generator is a host one, so the card and the CPU draw the same
rows.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class RVQState(NamedTuple):
    codebooks: torch.Tensor  # [Q, S, D]


def _nearest(x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """[N, D] x [S, D] -> [N] nearest codeword indices (first on ties)."""
    d2 = (torch.sum(x * x, 1, keepdim=True) - 2 * x @ codebook.T
          + torch.sum(codebook * codebook, 1)[None])
    return torch.argmin(d2, dim=1)


@torch.no_grad()
def kmeans_init(data: torch.Tensor, num_quantizers: int, codebook_size: int, iters: int = 1,
                generator: torch.Generator | None = None, starts=None) -> RVQState:
    """Seed each quantizer's codebook with k-means on the residuals."""
    residual = data
    books = []
    for q in range(num_quantizers):
        n = residual.shape[0]
        if starts is not None:
            idx = torch.as_tensor(starts[q], dtype=torch.long, device=data.device)
        elif n < codebook_size:
            idx = torch.randint(n, (codebook_size,), generator=generator).to(data.device)
        else:
            idx = torch.randperm(n, generator=generator)[:codebook_size].to(data.device)
        cb = residual[idx]
        for _ in range(iters):
            one_hot = torch.nn.functional.one_hot(_nearest(residual, cb), codebook_size
                                                  ).to(residual.dtype)
            counts = one_hot.sum(0)
            sums = one_hot.T @ residual
            cb = torch.where(counts[:, None] > 0, sums / torch.clamp(counts[:, None], min=1), cb)
        residual = residual - cb[_nearest(residual, cb)]
        books.append(cb)
    return RVQState(torch.stack(books))


def quantize(state: RVQState, x: torch.Tensor):
    """Residual quantize [N, D]. Returns (x_q with straight-through grad,
    indices [N, Q])."""
    residual = x
    out = torch.zeros_like(x)
    idxs = []
    for q in range(state.codebooks.shape[0]):
        cb = state.codebooks[q]
        assign = _nearest(residual.detach(), cb)
        chosen = cb[assign]
        out = out + chosen
        residual = residual - chosen
        idxs.append(assign)
    x_q = x + (out - x).detach()
    return x_q, torch.stack(idxs, dim=1)


@torch.no_grad()
def update_codebooks(state: RVQState, x: torch.Tensor, mask: torch.Tensor | None = None,
                     lr: float = 0.1) -> RVQState:
    """Pull each codeword toward the mean of its assigned residuals;
    ``mask`` ([N]) excludes rows (inactive slots) from the means."""
    w = torch.ones(x.shape[0], dtype=x.dtype, device=x.device) if mask is None \
        else mask.to(x.dtype)
    residual = x
    new_books = []
    for q in range(state.codebooks.shape[0]):
        cb = state.codebooks[q]
        assign = _nearest(residual, cb)
        one_hot = torch.nn.functional.one_hot(assign, cb.shape[0]).to(x.dtype) * w[:, None]
        counts = one_hot.sum(0)
        means = one_hot.T @ residual / torch.clamp(counts[:, None], min=1)
        new_books.append(torch.where(counts[:, None] > 0, cb + lr * (means - cb), cb))
        residual = residual - cb[assign]
    return RVQState(torch.stack(new_books))


def decode(state: RVQState, indices: torch.Tensor) -> torch.Tensor:
    """[N, Q] indices -> [N, D] reconstruction."""
    out = torch.zeros((), dtype=state.codebooks.dtype, device=state.codebooks.device)
    for q in range(state.codebooks.shape[0]):
        out = out + state.codebooks[q][indices[:, q]]
    return out
