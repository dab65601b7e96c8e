"""Macro-block Gaussian compositors: wrappers and plain versions.

Port of ``aip_tpu/ops/pallas/composite.py``'s two compositors on the
inference render path. The CUDA kernels are in
``aip_tpu_torch/csrc/composite.cu`` (its header note says what bounds them
on the H100 and how they are laid out). Here:

* ``composite_macro_mxu_seg`` (replaces ``composite_macro_mxu_seg_pallas``)
  and ``composite_macro_mxu`` (replaces ``composite_macro_mxu_pallas``):
  for a CUDA tensor each launches its kernel or raises; for a CPU tensor
  it runs its plain version. Each counts its launches in ``.launches``.
* ``composite_macro_mxu_reference``: the windowed composite in plain
  torch, ``composite_raw_blocks``'s math (transmittance as
  ``exp(cumsum(log1p(-alpha)))``), over chunks of blocks so the
  ``[chunk, Kc, P]`` intermediates stay within ``chunk_bytes``. The
  background is weighted by the transmittance at the kernels' early exit
  (the first 64-row group start at which every pixel has T <= 1e-4), as
  the TPU kernels weight it where they skip saturated groups;
* ``composite_macro_mxu_seg_reference``: gathers each segment into a
  window and calls the windowed reference;
* ``walked_rows``: the rows the kernels walk before their early exit, as
  the plain version counts them (the work behind the kernels' bound).

Rows are ``[mx, my, conic a, b, c, log(opacity), r, g, b, pad x7]``
(``gs.rasterizer.pack_raw_table``). Outputs are ``[M, 3, 1, bs*bs]``
planes, pixel (y, x) of block m at ``[m, c, 0, y * bs + x]``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from aip_tpu_torch.kernels._build import library

GROUP = 64            # rows per early-exit check, as in the kernels
BLOCK_SIZES = (16, 32, 64)
T_CUTOFF = 1e-4


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = library("composite")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.aip_composite_segment.argtypes = [p, p, p, p, p, i, i, ctypes.c_longlong, i, i, p]
    lib.aip_composite_window.argtypes = [p, p, p, p, i, i, i, i, p]
    lib.aip_composite_segment.restype = ctypes.c_int
    lib.aip_composite_window.restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------------------
# Plain versions (the CPU path, and what the kernels are held against)
# ---------------------------------------------------------------------------

def _composite_chunk(raw, counts, bg, bids, bs, mtw):
    """Windowed composite of one chunk of blocks. Returns ([B, 3, P] planes,
    [B] rows walked up to the kernels' group-level early exit)."""
    dev = raw.device
    b, kc, _ = raw.shape
    yy = torch.arange(bs, dtype=torch.float32, device=dev)
    py_l, px_l = torch.meshgrid(yy, yy, indexing="ij")
    px = ((bids % mtw) * bs).float()[:, None] + px_l.reshape(-1)[None, :]   # [B, P]
    py = ((bids // mtw) * bs).float()[:, None] + py_l.reshape(-1)[None, :]
    dx = px[:, None, :] - raw[..., 0:1]                                     # [B, K, P]
    dy = py[:, None, :] - raw[..., 1:2]
    power = (-0.5 * (raw[..., 2:3] * dx * dx + raw[..., 4:5] * dy * dy)
             - raw[..., 3:4] * dx * dy + raw[..., 5:6])
    del dx, dy
    alpha = torch.clamp(torch.exp(torch.clamp(power, max=0.0)), max=0.99)
    del power
    slot_ok = torch.arange(kc, device=dev)[None, :] < counts[:, None]
    alpha = torch.where(slot_ok[:, :, None] & (alpha >= 1.0 / 255.0), alpha,
                        torch.zeros((), device=dev))
    log_t = torch.cumsum(torch.log1p(-alpha), dim=1)
    t_exc = torch.exp(torch.cat([torch.zeros_like(log_t[:, :1]), log_t[:, :-1]], dim=1))
    contrib = torch.where(t_exc > T_CUTOFF, alpha * t_exc, torch.zeros((), device=dev))
    del alpha, t_exc
    rgb = torch.einsum("bkp,bkc->bcp", contrib, raw[..., 6:9])
    del contrib
    # First row after which every pixel has T <= cutoff; the kernels test at
    # group starts, so they walk up to the next multiple of GROUP.
    saturated = torch.exp(log_t).amax(dim=2) <= T_CUTOFF                    # [B, K]
    first_sat = torch.where(saturated.any(dim=1), saturated.float().argmax(dim=1),
                            torch.full((b,), kc, device=dev, dtype=torch.long))
    walked = torch.minimum(counts.long().clamp(max=kc), ((first_sat + GROUP) // GROUP) * GROUP)
    # The background sees the transmittance where the kernels stop: rows past
    # the early exit contribute nothing (every T_exc <= cutoff there) but
    # would still dim T below 1e-4.
    last = (walked - 1).clamp(min=0)[:, None, None].expand(b, 1, log_t.shape[2])
    t_final = torch.where(walked[:, None] > 0, torch.exp(log_t.gather(1, last)[:, 0]),
                          torch.ones((), device=dev))                        # [B, P]
    planes = rgb + t_final[:, None, :] * bg[None, :, None]
    return planes, walked


def _windowed(raw, counts, bg_color, bs, mtw, block0, chunk_bytes):
    nb, kc, _ = raw.shape
    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=raw.device)
    per_block = max(1, kc * bs * bs * 4 * 8)  # ~8 live [K, P] float32 tensors
    chunk = max(1, chunk_bytes // per_block)
    planes, walked = [], []
    for c0 in range(0, nb, chunk):
        bids = block0 + torch.arange(c0, min(nb, c0 + chunk), device=raw.device)
        p, w = _composite_chunk(raw[c0:c0 + chunk].float(), counts[c0:c0 + chunk], bg, bids,
                                bs, mtw)
        planes.append(p)
        walked.append(w)
    if not planes:
        return (torch.zeros((0, 3, 1, bs * bs), device=raw.device),
                torch.zeros(0, dtype=torch.long, device=raw.device))
    return torch.cat(planes)[:, :, None, :], torch.cat(walked)


def composite_macro_mxu_reference(raw, counts, bg_color, bs: int, mtw: int, block0: int = 0,
                                  chunk_bytes: int = 1 << 31):
    """Plain windowed composite: raw [M, Kc, 16] + counts [M] -> [M, 3, 1,
    bs*bs]. ``block0`` offsets the block ids (a strip of blocks)."""
    return _windowed(raw, counts, bg_color, bs, mtw, block0, chunk_bytes)[0]


def _segment_window(raw_sorted, starts, counts, kc):
    """Each block's segment as a [M, kc, 16] window (rows past count are
    never composited)."""
    slot = starts.long()[:, None] + torch.arange(kc, device=raw_sorted.device)[None, :]
    slot = torch.clamp(slot, max=max(raw_sorted.shape[0] - 1, 0))
    return raw_sorted[slot]


def composite_macro_mxu_seg_reference(raw_sorted, starts, counts, bg_color, n_blocks: int,
                                      kc: int, bs: int, mtw: int, chunk_bytes: int = 1 << 31):
    """Plain segment composite: rows [starts[b], starts[b] + counts[b]) of
    raw_sorted [S, 16], counts clipped to kc -> [n_blocks, 3, 1, bs*bs]."""
    assert starts.shape[0] == n_blocks
    window = _segment_window(raw_sorted, starts, counts, kc)
    return composite_macro_mxu_reference(window, counts, bg_color, bs, mtw,
                                         chunk_bytes=chunk_bytes)


def walked_rows(raw, counts, bg_color, bs: int, mtw: int, chunk_bytes: int = 1 << 31) -> int:
    """Rows of a window [M, Kc, 16] that the kernels walk: per block, its
    count, or fewer when every pixel's transmittance falls to 1e-4 first
    (counted at the kernels' 64-row group granularity). Times bs^2, it is
    the (row, pixel) pairs the kernels evaluate."""
    return int(_windowed(raw, counts, bg_color, bs, mtw, 0, chunk_bytes)[1].sum())


# ---------------------------------------------------------------------------
# Kernel launches (CUDA tensors only)
# ---------------------------------------------------------------------------

def _check(t, name, dtype, ndim, device=None):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, the table on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: the kernel takes {dtype}, got {t.dtype}")
    if t.ndim != ndim or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {ndim}-d tensor, got {tuple(t.shape)}")


def _check_common(table, counts, bg, n_blocks, bs):
    _check(table, "raw", torch.float32, table.ndim)
    if table.shape[-1] != 16 or table.data_ptr() % 16:
        raise ValueError(f"raw rows must be 16 float32 wide and 16-byte aligned, "
                         f"got {tuple(table.shape)}")
    _check(counts, "counts", torch.int32, 1, table.device)
    _check(bg, "bg_color", torch.float32, 1, table.device)
    if counts.shape[0] != n_blocks or bg.shape[0] != 3:
        raise ValueError(f"counts must be [{n_blocks}] and bg_color [3], got "
                         f"{tuple(counts.shape)} and {tuple(bg.shape)}")
    if bs not in BLOCK_SIZES:
        raise ValueError(f"the kernels take macro blocks of {BLOCK_SIZES} px, got bs={bs}")


def _launch(fn, device, args):
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed to launch: CUDA error {err}")


def _bg(bg_color, device):
    return torch.as_tensor(bg_color, dtype=torch.float32, device=device).contiguous()


def composite_macro_mxu_seg(raw_sorted, starts, counts, bg_color, n_blocks: int, kc: int,
                            bs: int, mtw: int):
    """Segment-walk compositor (replaces ``composite_macro_mxu_seg_pallas``).
    raw_sorted [S, 16] float32 in (block, depth) order; starts, counts [M]
    int32 (counts clipped to kc). Returns [M, 3, 1, bs*bs] float32."""
    if raw_sorted.device.type == "cpu":
        return composite_macro_mxu_seg_reference(raw_sorted, starts, counts, bg_color,
                                                 n_blocks, kc, bs, mtw)
    bg = _bg(bg_color, raw_sorted.device)
    _check_common(raw_sorted, counts, bg, n_blocks, bs)
    if raw_sorted.ndim != 2:
        raise ValueError(f"raw_sorted must be [S, 16], got {tuple(raw_sorted.shape)}")
    _check(starts, "starts", torch.int32, 1, raw_sorted.device)
    if starts.shape[0] != n_blocks:
        raise ValueError(f"starts must be [{n_blocks}], got {tuple(starts.shape)}")
    out = torch.empty((n_blocks, 3, 1, bs * bs), dtype=torch.float32, device=raw_sorted.device)
    if n_blocks:
        _launch(_lib().aip_composite_segment, raw_sorted.device,
                (raw_sorted.data_ptr(), starts.data_ptr(), counts.data_ptr(), bg.data_ptr(),
                 out.data_ptr(), n_blocks, kc, raw_sorted.shape[0], bs, mtw))
        composite_macro_mxu_seg.launches += 1
    return out


def composite_macro_mxu(raw, counts, bg_color, bs: int, mtw: int):
    """Windowed compositor (replaces ``composite_macro_mxu_pallas``). raw
    [M, Kc, 16] float32 gathered rows, counts [M] int32 (valid rows are a
    prefix). Returns [M, 3, 1, bs*bs] float32."""
    if raw.device.type == "cpu":
        return composite_macro_mxu_reference(raw, counts, bg_color, bs, mtw)
    bg = _bg(bg_color, raw.device)
    n_blocks = raw.shape[0]
    _check_common(raw, counts, bg, n_blocks, bs)
    if raw.ndim != 3:
        raise ValueError(f"raw must be [M, Kc, 16], got {tuple(raw.shape)}")
    out = torch.empty((n_blocks, 3, 1, bs * bs), dtype=torch.float32, device=raw.device)
    if n_blocks:
        _launch(_lib().aip_composite_window, raw.device,
                (raw.data_ptr(), counts.data_ptr(), bg.data_ptr(), out.data_ptr(), n_blocks,
                 raw.shape[1], bs, mtw))
        composite_macro_mxu.launches += 1
    return out


composite_macro_mxu_seg.launches = 0
composite_macro_mxu.launches = 0


def reset_launch_counts() -> None:
    composite_macro_mxu_seg.launches = 0
    composite_macro_mxu.launches = 0


def launch_counts() -> dict[str, int]:
    return {"composite_macro_mxu_seg": composite_macro_mxu_seg.launches,
            "composite_macro_mxu": composite_macro_mxu.launches}
