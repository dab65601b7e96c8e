"""Hash-grid table gradient: the wrapper of kernel C and its plain version.

Port of ``aip_tpu/ops/pallas/hashgrad.py``'s ``hash_grad_pallas`` (the
colour field's table gradient for tables of 2^16 rows and more). The CUDA
kernel is ``aip_tpu_torch/csrc/hashgrad.cu`` (its header note says what
bounds it and how it is laid out). Here:

* ``hash_grad(x01, g_out, table_shape)``: dL/dtables [L, T, F] of
  ``hash_encode(tables, x01)`` for the upstream gradient g_out [N, L*F].
  On a CUDA tensor it launches the kernel (which recomputes each corner's
  index and weight from x01, and writes every entry of the table itself:
  the table comes from ``torch.empty``) or raises; on a CPU tensor it runs
  the plain version. ``launch_counts()`` counts its launches.
* ``hash_grad_reference``: the plain version, ``_encode_terms``'s indices
  and weights and one ``index_add_`` into the flattened [L*T, F] table.
* ``level_table(l, t)``: the per-level (res, dense, rows) of ``_levels`` as
  the kernel's int array, built once per (L, T).

Both accumulate in float32. The JAX package's MXU backward rounds every
contribution to bf16 before its float32 sums (a stated difference; the
tests hold the plain version to JAX's float32 autodiff of ``hash_encode``
tightly and to ``hash_encode_mxu`` at a bf16 tolerance).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from aip_tpu_torch.kernels._build import (add_count, bind, check, launch, read_counts,
                                           reset_counts)


@functools.cache
def _lib() -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    return bind("hashgrad", aip_hash_grad=[p, p, p, p, p, i, i, i, i, p])


def _levels(n_levels: int, table_cap: int):
    """(res, dense, effective rows) per level, as ``_corner_index`` picks
    them. The colour field's module is imported here, at call time: it
    imports this one."""
    from aip_tpu_torch.gs.colorfield import level_resolutions, level_table_sizes_for_cap

    sizes = level_table_sizes_for_cap(table_cap, n_levels)
    return [(res, int(-(-((res + 1) ** 3) // 8) * 8 <= table_cap), size)
            for res, size in zip(level_resolutions(n_levels), sizes)]


@functools.cache
def level_table(n_levels: int, table_cap: int):
    """``_levels`` flattened into the kernel's ctypes int array, built once
    per (L, T)."""
    flat = [v for spec in _levels(n_levels, table_cap) for v in spec]
    return (ctypes.c_int * len(flat))(*flat)


SYNC_WORDS = 33       # the kernel's per-level arrival counters and its exit count
_sync: dict[tuple[int, int], torch.Tensor] = {}


def _sync_words(device, stream: int) -> torch.Tensor:
    """The kernel's counters for launches on ``stream``: zero when made, and
    every launch leaves them zero. One array a stream, so that launches on
    two streams never share one."""
    key = (device.index, stream)
    words = _sync.get(key)
    if words is None:
        words = _sync[key] = torch.zeros(SYNC_WORDS, dtype=torch.int32, device=device)
    return words


def hash_grad_reference(x01: torch.Tensor, g_out: torch.Tensor, table_shape) -> torch.Tensor:
    """Plain table gradient: [N, 3] positions in [0, 1] and g_out [N, L*F]
    -> [L, T, F] float32, by one index_add_ of every (point, level, corner)
    contribution w * g."""
    from aip_tpu_torch.gs.colorfield import _encode_terms

    l, t, f = table_shape
    n = x01.shape[0]
    idx, w = _encode_terms(table_shape, x01)                      # [N, L, 8]
    vals = w[..., None] * g_out.reshape(n, l, 1, f).to(torch.float32)
    grad = torch.zeros((l * t, f), dtype=torch.float32, device=x01.device)
    grad.index_add_(0, idx.reshape(-1), vals.reshape(-1, f))
    return grad.reshape(l, t, f)


def hash_grad(x01: torch.Tensor, g_out: torch.Tensor, table_shape) -> torch.Tensor:
    """Kernel C (replaces ``hash_grad_pallas``): dL/dtables [L, T, F]
    float32 for positions x01 [N, 3] and upstream gradient g_out [N, L*F]."""
    if x01.device.type == "cpu":
        return hash_grad_reference(x01, g_out, table_shape)
    l, t, f = (int(s) for s in table_shape)
    n = x01.shape[0]
    check(x01, "x01", torch.float32, (n, 3), align=4)
    # g_out is read as one vector a (point, level).
    check(g_out, "g_out", torch.float32, (n, l * f), x01.device, align=16)
    if t & (t - 1) or t <= 0 or f not in (1, 2, 4) or not 0 < l <= SYNC_WORDS - 1:
        raise ValueError(f"the kernel takes 1 to {SYNC_WORDS - 1} levels of a power-of-two "
                         f"table and 1, 2 or 4 features, got {(l, t, f)}")
    grad = torch.empty((l, t, f), dtype=torch.float32, device=x01.device)
    sync = _sync_words(x01.device, torch.cuda.current_stream(x01.device).cuda_stream)
    launch(_lib().aip_hash_grad, x01.device, x01, g_out, grad, level_table(l, t), sync, n, l, t,
           f)
    add_count("hash_grad")
    return grad


def reset_launch_counts() -> None:
    reset_counts("hash_grad")


def launch_counts() -> dict[str, int]:
    return read_counts("hash_grad")
