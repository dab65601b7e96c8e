"""Gaussian compositors of the inference render: wrappers and plain versions.

Port of the five compositors of ``aip_tpu/ops/pallas/composite.py``. The
CUDA kernels are in ``aip_tpu_torch/csrc/composite.cu`` (the two macro-block
walks on packed rows) and ``aip_tpu_torch/csrc/composite_walk.cu`` (the
per-tile walk, the fused macro-to-tile walk and the coefficient walk); the
header note of each says what bounds its kernels on the H100 and how they
are laid out. Every wrapper launches its kernel for a CUDA tensor or
raises, runs its plain version for a CPU tensor, and counts its launches
(``launch_counts()``). Here:

* ``composite_macro_mxu_seg`` (replaces ``composite_macro_mxu_seg_pallas``)
  and ``composite_macro_mxu`` (replaces ``composite_macro_mxu_pallas``), the
  JAX package's signatures on gathered rows; and their indexed entries,
  ``composite_macro_mxu_seg_indexed`` (the packed table ``[N, 16]`` with
  the selection's ``gid_s``, starts and counts) and
  ``composite_macro_mxu_indexed`` (the table with ``macro_idx`` ``[M,
  Kc]``), which the rasterizer calls: on the card the kernel reads the rows
  through the index, on the CPU they gather and call the wrappers above.
  All four launch the one kernel of ``csrc/composite.cu``, counted under
  the first two names; ``layout=(sh, p)`` picks its sub-tile height and
  pixels a thread among ``LAYOUTS`` (a sweep);
* ``sub_tile_live``: the kernel's cull, per (row, 16 x sh sub-tile), and
  ``composite_macro_walk_reference``: the kernel's walk emulated in plain
  torch, sequential transmittance, the group-start exit, with or without
  the cull (``torch.equal`` either way where the cull is exact);
* ``composite_macro_mxu_reference``: the windowed composite in plain
  torch, ``composite_raw_blocks``'s math (transmittance as
  ``exp(cumsum(log1p(-alpha)))``), over chunks of blocks so the
  ``[chunk, Kc, P]`` intermediates stay within ``chunk_bytes``. The
  background is weighted by the transmittance at the kernels' early exit
  (the first 64-row group start at which every pixel has T <= 1e-4), as
  the TPU kernels weight it where they skip saturated groups;
* ``composite_macro_mxu_seg_reference``: gathers each segment into a
  window and calls the windowed reference;
* ``walked_rows`` and ``live_pairs``: the rows the kernels walk before
  their early exit, and among them the (row, pixel) pairs with alpha >=
  1/255, as the plain version counts them (the work behind the kernel's
  dense and live bounds);
* ``composite_tiles`` (replaces ``composite_tiles_pallas``) and
  ``composite_from_macro`` (replaces ``composite_from_macro_pallas``): the
  per-tile front-to-back walk of the TPU kernels' shared body
  (``_make_kernel``) over gathered slots, of the tile's own ``[T, K]`` list
  or of its macro block's ``[M, Kc]`` list. No early exit: the
  transmittance keeps falling after 1e-4 and weights the background, as in
  the JAX package. Plain versions ``composite_tiles_reference`` and
  ``composite_from_macro_reference``, both kernel A's plain forward
  (``composite_ad_fwd_reference``) without its final transmittance. Both
  kernels walk, per tile, only the slots kernel A's cull keeps
  (``live_slots``): ``tiles_live`` and ``from_macro_live`` name them,
  ``composite_tiles_culled_reference`` and
  ``composite_from_macro_culled_reference`` emulate the culled walks, and
  ``tiles_work`` and ``from_macro_work`` count the pairs behind the
  bounds;
* ``composite_macro_blocks`` (replaces ``composite_macro_blocks_pallas``):
  per macro block, the walk on quadratic coefficients ``[c0, cx, cy, cxx,
  cyy, cxy, opacity, 0]`` in block-local pixel coordinates, evaluated left
  to right as the TPU kernel does, bounded by the block's count and left
  at the first 32-row group start where no pixel of the block has T >
  1e-4. Plain version ``composite_macro_blocks_reference``; the kernel's
  cull per (row, 16 x 16 sub-tile), ``blocks_sub_tile_live``, its walk
  emulated, ``composite_macro_blocks_culled_reference``, and the pairs
  behind its bounds, ``blocks_work``.

``composite_tiles`` and ``composite_macro_blocks`` take a private
``_dense`` argument: on the card, the kernel's twin with the cull off,
which walks every pair (the card's checks hold the two to the same bits).

The plain walks repeat the kernels' float32 operations one by one in the
same order, so on the card the two agree bit for bit.

Rows of the packed walks are ``[mx, my, conic a, b, c, log(opacity), r, g,
b, pad x7]`` (``gs.rasterizer.pack_raw_table``). Macro-block outputs are
``[M, 3, 1, bs*bs]`` planes, pixel (y, x) of block m at ``[m, c, 0, y * bs
+ x]``; per-tile outputs are ``[T, 3, 16, 16]``, tile t's origin at ((t %
tile_w) * 16, (t // tile_w) * 16).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from aip_tpu_torch.kernels._build import (add_count, bind, check, launch, read_counts,
                                           reset_counts)
from aip_tpu_torch.kernels.composite_ad import (
    EXP_MARGIN, LN_ALPHA_MIN, TILE, _pixels, box_visible, composite_ad_fwd_culled_reference,
    composite_ad_fwd_reference, live_slots, pack)

GROUP = 64            # rows per early-exit check, as in the kernels
BLOCK_SIZES = (16, 32, 64)
SUB_W = 16            # sub-tile width of the macro-block kernel's cull
# (sub-tile height, pixels a thread) the kernel is built for, per block
# size; the first is the default (the sweep in PERF.md).
LAYOUTS = {16: ((16, 4),), 32: ((16, 4),),
           64: ((16, 4), (16, 2), (16, 8), (8, 2), (8, 4), (32, 2), (32, 4))}
DEFAULT_LAYOUT = (16, 4)
T_CUTOFF = 1e-4
WALK_GROUP = 32       # composite_macro_blocks' rows per early-exit test
MAX_MACRO = 32         # the largest macro block, in tiles a side, the fused kernel takes
COEFF_MARGIN = 8 * 2.0 ** -24   # of S, the coefficient cull's float32 rounding (csrc/cull.cuh)


@functools.cache
def _lib() -> ctypes.CDLL:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return bind("composite",
                aip_composite_macro=[p, ll, p, ll, p, p, p, p, i, i, i, i, i, i, ll, p])


@functools.cache
def _walk_lib() -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    return bind("composite_walk", aip_composite_tiles=[p, p, p, p, p, p, p, i, i, i, i, p],
                aip_composite_from_macro=[p, p, p, p, p, p, p, i, i, i, i, i, p],
                aip_composite_macro_blocks=[p, p, p, p, p, i, i, i, i, p])


# ---------------------------------------------------------------------------
# Plain versions (the CPU path, and what the kernels are held against)
# ---------------------------------------------------------------------------

def _composite_chunk(raw, counts, bg, bids, bs, mtw):
    """Windowed composite of one chunk of blocks. Returns ([B, 3, P] planes,
    [B] rows walked up to the kernels' group-level early exit)."""
    return _chunk_walk(raw, counts, bg, bids, bs, mtw)[:2]


def _chunk_walk(raw, counts, bg, bids, bs, mtw):
    """``_composite_chunk``, and [B] pairs of the walked rows and the
    block's pixels with alpha >= 1/255."""
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
    live_per_row = (alpha > 0).sum(dim=2)                                   # [B, K]
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
    in_walk = torch.arange(kc, device=dev)[None, :] < walked[:, None]
    return planes, walked, (live_per_row * in_walk).sum(dim=1)


def _windowed(raw, counts, bg_color, bs, mtw, block0, chunk_bytes):
    nb, kc, _ = raw.shape
    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=raw.device)
    per_block = max(1, kc * bs * bs * 4 * 8)  # ~8 live [K, P] float32 tensors
    chunk = max(1, chunk_bytes // per_block)
    planes, walked, live = [], [], []
    for c0 in range(0, nb, chunk):
        bids = block0 + torch.arange(c0, min(nb, c0 + chunk), device=raw.device)
        p, w, n = _chunk_walk(raw[c0:c0 + chunk].float(), counts[c0:c0 + chunk], bg, bids,
                              bs, mtw)
        planes.append(p)
        walked.append(w)
        live.append(n)
    if not planes:
        empty = torch.zeros(0, dtype=torch.long, device=raw.device)
        return torch.zeros((0, 3, 1, bs * bs), device=raw.device), empty, empty
    return torch.cat(planes)[:, :, None, :], torch.cat(walked), torch.cat(live)


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


def live_pairs(raw, counts, bg_color, bs: int, mtw: int, chunk_bytes: int = 1 << 31) -> int:
    """(row, pixel) pairs of the rows ``walked_rows`` counts at which alpha
    >= 1/255, as the plain version evaluates them: the work a walk that
    skipped every other pair would still do (the kernel's live bound)."""
    return int(_windowed(raw, counts, bg_color, bs, mtw, 0, chunk_bytes)[2].sum())


# ---------------------------------------------------------------------------
# The macro-block kernel's cull and walk, emulated in plain torch
# ---------------------------------------------------------------------------

def macro_layout(bs: int, sh: int, p: int) -> dict:
    """The kernel's layout for macro blocks of bs px, sub-tiles of 16 x sh
    and p pixels a thread (``csrc/composite.cu``, ``Layout``): threads a
    block, blocks a macro block (its cluster), sub-tiles a block and warps a
    sub-tile. Raises ValueError for a layout the kernel is not built for."""
    if bs not in LAYOUTS or (sh, p) not in LAYOUTS[bs]:
        raise ValueError(f"the macro-block kernel takes (sh, p) in {LAYOUTS.get(bs, ())} for "
                         f"bs={bs} (block sizes {BLOCK_SIZES}), got ({sh}, {p})")
    block_pixels = min(256 * p, bs * bs)
    return {"threads": block_pixels // p, "cluster": bs * bs // block_pixels,
            "sub_tiles_per_block": block_pixels // (SUB_W * sh), "warps_per_sub_tile": sh // (2 * p)}


def sub_tile_live(window, counts, bs: int, mtw: int, sh: int = DEFAULT_LAYOUT[0],
                  block0: int = 0):
    """[M, Kc, (bs / 16) (bs / sh)] bool: the rows the kernel keeps for each
    16 x sh sub-tile of each block (sub-tiles in raster order): a row inside
    its block's count stays unless ``box_visible`` (the test of
    ``csrc/cull.cuh``, ln_op the row's log(opacity)) proves alpha < 1/255 at
    every pixel of the sub-tile."""
    m, kc, _ = window.shape
    dev = window.device
    d = window.to(torch.float64)
    cols = bs // SUB_W
    s = torch.arange(cols * (bs // sh), device=dev)
    bids = block0 + torch.arange(m, device=dev)
    x0 = (((bids % mtw) * bs)[:, None] + (s % cols)[None, :] * SUB_W).to(torch.float64)
    y0 = (((bids // mtw) * bs)[:, None] + (s // cols)[None, :] * sh).to(torch.float64)
    mx, my, a, b, c, lo = (d[..., i, None] for i in range(6))
    visible = box_visible(mx, my, a, b, c, lo, x0[:, None, :], y0[:, None, :], SUB_W, sh)
    in_count = torch.arange(kc, device=dev)[None, :] < counts.long().clamp(max=kc)[:, None]
    return visible & in_count[..., None]


def composite_macro_walk_reference(window, counts, bg_color, bs: int, mtw: int,
                                   sh: int | None = None, block0: int = 0):
    """The macro-block kernel's walk in plain torch: per pixel, rows front
    to back with the transmittance as a running float32 product (the plain
    version's per-pixel expressions otherwise), alpha below 1/255 skipped,
    colour added while T > 1e-4; at every 64-row group start of a block's
    list the block stops when none of its pixels has T > 1e-4. With ``sh``
    each sub-tile of 16 x sh pixels walks only its live rows
    (``sub_tile_live``); without, every row. window [M, Kc, 16], counts [M]
    -> [M, 3, 1, bs*bs]."""
    m, kc, _ = window.shape
    dev = window.device
    raw = window.float()
    counts = counts.long().clamp(0, kc)
    flat = torch.arange(bs * bs, device=dev)
    bids = block0 + torch.arange(m, device=dev)
    px = ((bids % mtw) * bs)[:, None].float() + (flat % bs).float()[None, :]
    py = ((bids // mtw) * bs)[:, None].float() + (flat // bs).float()[None, :]
    live = None
    if sh is not None:
        sub_of = (flat // bs // sh) * (bs // SUB_W) + (flat % bs) // SUB_W          # [P]
        live = sub_tile_live(window, counts, bs, mtw, sh, block0)[:, :, sub_of]    # [M, Kc, P]
    zero = torch.zeros((), device=dev)
    trans = torch.ones((m, bs * bs), device=dev)
    acc = torch.zeros((m, 3, bs * bs), device=dev)
    active = torch.ones(m, dtype=torch.bool, device=dev)
    for r in range(int(counts.max()) if m else 0):
        if r % GROUP == 0:
            active = active & (trans > T_CUTOFF).any(dim=1)
            if not bool((active & (r < counts)).any()):
                break
        row = raw[:, r]
        dx = px - row[:, 0:1]
        dy = py - row[:, 1:2]
        power = (-0.5 * (row[:, 2:3] * dx * dx + row[:, 4:5] * dy * dy)
                 - row[:, 3:4] * dx * dy + row[:, 5:6])
        alpha = torch.clamp(torch.exp(torch.clamp(power, max=0.0)), max=0.99)
        take = (active & (r < counts))[:, None] & (alpha >= 1.0 / 255.0)
        if live is not None:
            take = take & live[:, r]
        w = torch.where(take & (trans > T_CUTOFF), alpha * trans, zero)
        acc = torch.where(w[:, None] > 0, acc + w[:, None] * row[:, 6:9, None], acc)
        trans = torch.where(take, trans * (1.0 - alpha), trans)
    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=dev)
    return (acc + trans[:, None] * bg[None, :, None])[:, :, None, :]


def valid_ends(valid):
    """One past the last valid slot of each row of ``valid`` [R, K] (0 for
    a row with none), int32 [R]. Slots past it have alpha 0 and change
    nothing, so a walk may stop there exactly."""
    r, k = valid.shape
    if k == 0:
        return torch.zeros(r, dtype=torch.int32, device=valid.device)
    pos = torch.arange(1, k + 1, dtype=torch.int32, device=valid.device)
    return torch.where(valid > 0, pos, torch.zeros((), dtype=torch.int32,
                                                   device=valid.device)).amax(1)


def composite_tiles_reference(g_mean, g_conic, g_color, g_op, slot_valid, bg_color,
                              tile_w: int):
    """Plain per-tile walk: mean [T, K, 2], conic [T, K, 3], colour [T, K,
    3], opacity [T, K], valid [T, K] -> [T, 3, 16, 16]. The TPU kernels'
    walk is kernel A's forward without its final transmittance, so this is
    ``composite_ad_fwd_reference`` over the slots up to the last valid one
    (later slots have alpha 0 and change nothing)."""
    n = int(valid_ends(slot_valid).max()) if g_mean.shape[0] else 0
    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=g_mean.device)
    cols = [t[:, :n].float() for t in (g_mean, g_conic, g_color, g_op[..., None],
                                        slot_valid[..., None])]
    return composite_ad_fwd_reference(*cols, bg, tile_w)[0]


def macro_of_tile(n_tiles: int, tile_w: int, macro: int, macro_tile_w: int, device=None):
    """The macro block of each 16 px tile, as the TPU kernel's index map
    (``composite_from_macro_pallas``'s ``macro_of``)."""
    i = torch.arange(n_tiles, device=device)
    return (i // tile_w // macro) * macro_tile_w + (i % tile_w) // macro


def composite_from_macro_reference(g_mean, g_conic, g_color, g_op, slot_valid, bg_color,
                                   n_tiles: int, tile_w: int, macro: int, macro_tile_w: int):
    """Plain fused walk: each of the n_tiles tiles walks its macro block's
    list, mean [M, Kc, 2], conic [M, Kc, 3], colour [M, Kc, 3], opacity [M,
    Kc], valid [M, Kc] -> [n_tiles, 3, 16, 16]: the per-tile walk on the
    rows gathered by ``macro_of_tile``."""
    rows = macro_of_tile(n_tiles, tile_w, macro, macro_tile_w, g_mean.device)
    n = int(valid_ends(slot_valid).max()) if g_mean.shape[0] else 0
    gathered = [t[:, :n][rows] for t in (g_mean, g_conic, g_color, g_op, slot_valid)]
    return composite_tiles_reference(*gathered, bg_color, tile_w)


def _macro_gathered(g_mean, g_conic, g_color, g_op, slot_valid, n_tiles, tile_w, macro,
                    macro_tile_w):
    """Each tile's macro-block list up to the last valid slot of any list,
    packed as kernel A's rows: ([T, n, 9], valid [T, n, 1])."""
    rows = macro_of_tile(n_tiles, tile_w, macro, macro_tile_w, g_mean.device)
    n = int(valid_ends(slot_valid).max()) if g_mean.shape[0] else 0
    g = pack(*(t[:, :n][rows].float() for t in (g_mean, g_conic, g_color, g_op[..., None])))
    return g, slot_valid[:, :n][rows][..., None].float()


def from_macro_live(g_mean, g_conic, g_color, g_op, slot_valid, n_tiles: int, tile_w: int,
                    macro: int, macro_tile_w: int):
    """[T, n] bool: the slots of each tile's macro-block list that the fused
    walk's kernel keeps for the tile (``live_slots``; n: one past the last
    valid slot of any list)."""
    return live_slots(*_macro_gathered(g_mean, g_conic, g_color, g_op, slot_valid, n_tiles,
                                       tile_w, macro, macro_tile_w), tile_w)


def composite_from_macro_culled_reference(g_mean, g_conic, g_color, g_op, slot_valid, bg_color,
                                          n_tiles: int, tile_w: int, macro: int,
                                          macro_tile_w: int):
    """The fused walk's kernel in plain torch: each tile walks, in list
    order, the slots of its macro block's list that the float64 cull keeps
    for its 16 x 16 pixel centres (``from_macro_live``), the per-pixel
    arithmetic the plain version's: kernel A's culled forward on the
    gathered lists. Where the cull is exact this equals
    ``composite_from_macro_reference`` (``torch.equal``)."""
    g, valid = _macro_gathered(g_mean, g_conic, g_color, g_op, slot_valid, n_tiles, tile_w,
                               macro, macro_tile_w)
    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=g_mean.device)
    return composite_ad_fwd_culled_reference(g, valid, bg, tile_w)[0]


def from_macro_work(g_mean, g_conic, g_color, g_op, slot_valid, n_tiles: int, tile_w: int,
                    macro: int, macro_tile_w: int, tiles_per_chunk: int = 64):
    """(walked, kept, visible) (slot, pixel) pairs of one fused-walk call,
    counted over chunks of tiles: each tile's list up to that list's last
    valid slot, at every pixel (the dense pairs); the pairs of the slots the
    cull keeps for each tile (what the kernel evaluates,
    ``from_macro_live``); and the pairs with a valid slot and alpha >=
    1/255, by the plain version's float32 expressions (the live pairs)."""
    rows_all = macro_of_tile(n_tiles, tile_w, macro, macro_tile_w, g_mean.device)
    return _slot_work((g_mean, g_conic, g_color, g_op, slot_valid), rows_all, tile_w,
                      tiles_per_chunk)


def _slot_work(arrays, rows_all, tile_w, tiles_per_chunk):
    """``from_macro_work`` and ``tiles_work``: tile t walks list
    ``rows_all[t]`` of the slot arrays."""
    g_mean, g_conic, g_color, g_op, slot_valid = arrays
    n_tiles = rows_all.shape[0]
    ends = valid_ends(slot_valid).long()
    walked = int(ends[rows_all].sum()) * TILE * TILE if n_tiles else 0
    n = int(ends.max()) if ends.numel() else 0
    kept = visible = 0
    for t0 in range(0, n_tiles, tiles_per_chunk):
        t = torch.arange(t0, min(n_tiles, t0 + tiles_per_chunk), device=g_mean.device)
        rows = rows_all[t]
        g = pack(*(a[:, :n][rows].float() for a in (g_mean, g_conic, g_color, g_op[..., None])))
        valid = slot_valid[:, :n][rows][..., None].float()
        kept += int(live_slots(g, valid, tile_w, tiles=t).sum()) * TILE * TILE
        px, py = (x[t].float()[:, None, :] for x in _pixels(n_tiles, tile_w, g.device))
        dx = px - g[..., 0:1]
        dy = py - g[..., 1:2]
        power = -0.5 * (g[..., 2:3] * dx * dx + g[..., 4:5] * dy * dy) - g[..., 3:4] * dx * dy
        del dx, dy
        alpha = torch.clamp(g[..., 8:9] * torch.exp(torch.clamp(power, max=0.0)), max=0.99)
        visible += int(((alpha >= 1.0 / 255.0) & (valid > 0)).sum())
    return walked, kept, visible


def tiles_live(g_mean, g_conic, g_color, g_op, slot_valid, tile_w: int):
    """[T, K] bool: the slots of each tile's own list that the per-tile
    walk's kernel keeps (``live_slots``, kernel A's cull)."""
    return live_slots(pack(g_mean.float(), g_conic.float(), g_color.float(),
                           g_op.float()[..., None]), slot_valid.float()[..., None], tile_w)


def composite_tiles_culled_reference(g_mean, g_conic, g_color, g_op, slot_valid, bg_color,
                                     tile_w: int):
    """The per-tile walk's kernel in plain torch: each tile walks, in list
    order, the slots of its list that the cull keeps (``tiles_live``), the
    per-pixel arithmetic the plain version's: kernel A's culled forward.
    Where the cull is exact this equals ``composite_tiles_reference``
    (``torch.equal``)."""
    g = pack(g_mean.float(), g_conic.float(), g_color.float(), g_op.float()[..., None])
    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=g_mean.device)
    return composite_ad_fwd_culled_reference(g, slot_valid.float()[..., None], bg, tile_w)[0]


def tiles_work(g_mean, g_conic, g_color, g_op, slot_valid, tile_w: int,
               tiles_per_chunk: int = 256):
    """(walked, kept, visible) (slot, pixel) pairs of one per-tile walk, as
    ``from_macro_work`` counts them, each tile on its own list."""
    rows_all = torch.arange(g_mean.shape[0], device=g_mean.device)
    return _slot_work((g_mean, g_conic, g_color, g_op, slot_valid), rows_all, tile_w,
                      tiles_per_chunk)


def composite_macro_blocks_reference(coeff, colors, counts, bg_color, bs: int):
    """Plain coefficient walk: coeff [M, Kc, 8] (``[c0, cx, cy, cxx, cyy,
    cxy, opacity, 0]`` in block-local pixel coordinates), colours [M, Kc, 4]
    (rgb, pad), counts [M] (valid rows are a prefix, clipped to Kc) ->
    [M, 3, 1, bs*bs]. Rows are walked in groups of 32; a block stops at the
    first group start where none of its bs*bs pixels has T > 1e-4."""
    return _macro_blocks_walk(coeff, colors, counts, bg_color, bs)[0]


def blocks_walked_rows(coeff, colors, counts, bs: int) -> int:
    """Rows the coefficient walk evaluates, summed over blocks: each block's
    count, or fewer when it leaves at a group start (the work behind the
    kernel's bound, bs^2 pixels a row)."""
    return int(_macro_blocks_walk(coeff, colors, counts, (0.0, 0.0, 0.0), bs)[1].sum())


def blocks_sub_tile_live(coeff, counts, bs: int, blocks_per_chunk: int = 32):
    """[M, Kc, (bs / 16)^2] bool: the rows the coefficient walk's kernel
    keeps for each 16 x 16 sub-tile of each block (sub-tiles in raster
    order), the twin of ``aip_cull::coeff_terms`` and
    ``coeff_proved_invisible`` (``csrc/cull.cuh``): the same float64
    expressions in the same order. A row inside its block's count stays
    when a coefficient or its opacity is not finite, or when its quadratic
    is not concave; it goes when its opacity is <= 0; otherwise it stays
    unless ln op + Q_max + 8 u S + 1e-6 < ln(float(1/255)) over the
    sub-tile's box of pixel centres (Q_max the exact maximum of the row's
    quadratic, S the box's largest sum of its terms' sizes)."""
    m, kc, _ = coeff.shape
    cols = bs // TILE
    s = torch.arange(cols * cols, device=coeff.device)
    xa = ((s % cols) * TILE).to(torch.float64)
    ya = ((s // cols) * TILE).to(torch.float64)
    xb, yb = xa + (TILE - 1.0), ya + (TILE - 1.0)
    in_count = torch.arange(kc, device=coeff.device)[None, :] < counts.long().clamp(0, kc)[:, None]
    out = []
    for b0 in range(0, m, blocks_per_chunk):
        cf = coeff[b0:b0 + blocks_per_chunk, :, :7].float()
        finite = torch.isfinite(cf).all(-1)
        op = cf[..., 6]
        c0, cx, cy, cxx, cyy, cxy = (cf[..., i].double()[..., None] for i in range(6))
        d = (4.0 * cxx) * cyy - cxy * cxy
        concave = ((cxx < 0) & (cyy < 0) & (d > 0))[..., 0]
        keep_out = ~finite | ((op > 0) & ~concave)
        test = finite & (op > 0) & concave

        def q(x, y):
            return ((((c0 + cx * x) + cy * y) + (cxx * x) * x) + (cyy * y) * y) + (cxy * x) * y

        xs = (cxy * cy - (2.0 * cyy) * cx) / d
        ys = (cxy * cx - (2.0 * cxx) * cy) / d
        hx, hy = -0.5 / cxx, -0.5 / cyy
        q_max = torch.fmax(
            torch.fmax(q(xa, torch.clamp((cy + cxy * xa) * hy, ya, yb)),
                       q(xb, torch.clamp((cy + cxy * xb) * hy, ya, yb))),
            torch.fmax(q(torch.clamp((cx + cxy * ya) * hx, xa, xb), ya),
                       q(torch.clamp((cx + cxy * yb) * hx, xa, xb), yb)))
        inside = (xa <= xs) & (xs <= xb) & (ya <= ys) & (ys <= yb)
        q_max = torch.where(inside, q(xs, ys), q_max)
        size = (((((c0.abs() + cx.abs() * xb) + cy.abs() * yb) + (cxx.abs() * xb) * xb)
                 + (cyy.abs() * yb) * yb) + (cxy.abs() * xb) * yb)
        bound = ((torch.log(op.double())[..., None] + q_max) + COEFF_MARGIN * size) + EXP_MARGIN
        out.append(keep_out[..., None] | (test[..., None] & ~(bound < LN_ALPHA_MIN)))
    keep = torch.cat(out) if out else torch.zeros((0, kc, cols * cols), dtype=torch.bool,
                                                   device=coeff.device)
    return keep & in_count[..., None]


def composite_macro_blocks_culled_reference(coeff, colors, counts, bg_color, bs: int):
    """The coefficient walk's kernel in plain torch: each 16 x 16 sub-tile
    walks only the rows the cull keeps for it (``blocks_sub_tile_live``),
    the exit and the per-pixel arithmetic the plain version's. Where the
    cull is exact this equals ``composite_macro_blocks_reference``
    (``torch.equal``)."""
    keep = blocks_sub_tile_live(coeff, counts, bs)
    return _macro_blocks_walk(coeff, colors, counts, bg_color, bs, keep)[0]


def blocks_work(coeff, colors, counts, bs: int) -> dict:
    """The coefficient walk's work on one call, in (row, pixel) pairs: the
    rows each block walks up to its exit at every pixel (the dense pairs),
    those the cull keeps for each pixel's sub-tile (what the kernel
    evaluates) and those with alpha >= 1/255 (the live pairs)."""
    keep = blocks_sub_tile_live(coeff, counts, bs)
    _, walked, live, kept = _macro_blocks_walk(coeff, colors, counts, (0.0, 0.0, 0.0), bs, keep)
    rows = int(walked.sum())
    return {"walked_rows": rows, "dense_pairs": rows * bs * bs, "kept_pairs": int(kept.sum()),
            "live_pairs": int(live.sum())}


def _macro_blocks_walk(coeff, colors, counts, bg_color, bs, keep=None):
    """The coefficient walk: ([M, 3, 1, bs*bs] planes, [M] rows walked,
    [M] walked pairs with alpha >= 1/255, [M] walked pairs the cull keeps).
    With ``keep`` ([M, Kc, sub-tiles], ``blocks_sub_tile_live``) a pixel
    takes only the rows kept for its sub-tile."""
    m, kc, _ = coeff.shape
    dev = coeff.device
    flat = torch.arange(bs * bs, device=dev)
    px = (flat % bs).float()[None]
    py = (flat // bs).float()[None]
    sub_of = (flat // bs // TILE) * (bs // TILE) + (flat % bs) // TILE
    bxx, byy, bxy = px * px, py * py, px * py
    counts = counts.long().clamp(0, kc)
    walked = torch.zeros_like(counts)
    live_pairs = torch.zeros_like(counts)
    kept_pairs = torch.zeros_like(counts)
    zero = torch.zeros((), device=dev)
    trans = torch.ones((m, bs * bs), device=dev)
    r, g, b = torch.zeros_like(trans), torch.zeros_like(trans), torch.zeros_like(trans)
    for g0 in range(0, int(counts.max()) if m else 0, WALK_GROUP):
        live = (g0 < counts) & (trans.amax(1) > T_CUTOFF)
        if not bool(live.any()):   # neither test can become true again
            break
        walked += torch.where(live, torch.clamp(counts - g0, max=WALK_GROUP), 0)
        for i in range(g0, min(g0 + WALK_GROUP, kc)):
            ok = (live & (i < counts))[:, None]
            if keep is not None:
                kept_i = ok & keep[:, i, sub_of]
                kept_pairs += kept_i.sum(1)
                ok = kept_i
            c = coeff[:, i].float()
            power = (c[:, 0:1] + c[:, 1:2] * px + c[:, 2:3] * py + c[:, 3:4] * bxx
                     + c[:, 4:5] * byy + c[:, 5:6] * bxy)
            alpha = torch.clamp(c[:, 6:7] * torch.exp(torch.clamp(power, max=0.0)), max=0.99)
            alpha = torch.where(ok & (alpha >= 1.0 / 255.0), alpha, zero)
            live_pairs += (alpha > 0).sum(1)
            contrib = torch.where(trans > T_CUTOFF, alpha * trans, zero)
            col = colors[:, i].float()
            r = r + contrib * col[:, 0:1]
            g = g + contrib * col[:, 1:2]
            b = b + contrib * col[:, 2:3]
            trans = trans * (1.0 - alpha)
    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=dev)
    out = torch.stack([r + trans * bg[0], g + trans * bg[1], b + trans * bg[2]], dim=1)
    return out[:, :, None, :], walked, live_pairs, kept_pairs


# ---------------------------------------------------------------------------
# Kernel launches (CUDA tensors only)
# ---------------------------------------------------------------------------

def _check_common(table, ndim, counts, bg, n_blocks, bs, layout):
    """The macro-block kernel's inputs: ``table`` of ``ndim`` dimensions,
    rows of 16 float32, 16-byte aligned; counts [n_blocks] and bg [3]."""
    check(table, "raw", torch.float32, (None,) * (ndim - 1) + (16,), align=16)
    check(counts, "counts", torch.int32, (n_blocks,), table.device)
    check(bg, "bg_color", torch.float32, (3,), table.device)
    if bs not in BLOCK_SIZES:
        raise ValueError(f"the kernels take macro blocks of {BLOCK_SIZES} px, got bs={bs}")
    macro_layout(bs, *layout)


def _bg(bg_color, device):
    return torch.as_tensor(bg_color, dtype=torch.float32, device=device).contiguous()


def _launch_macro(table, index, starts, counts, bg, n_blocks, kc, bs, mtw, layout, block0=0):
    """One launch of the macro-block kernel: table [N, 16] (or a window
    [M, Kc, 16], walked as its N = M Kc rows), index [L] int32 or None,
    starts [M] int32 or None (the window); launch block b is image block
    block0 + b."""
    dev = table.device
    out = torch.empty((n_blocks, 3, 1, bs * bs), dtype=torch.float32, device=dev)
    if n_blocks:
        launch(_lib().aip_composite_macro, dev, table, table.numel() // 16, index,
               0 if index is None else index.numel(), starts, counts, bg, out, n_blocks, kc, bs,
               mtw, *layout, int(block0))
    return out


def composite_macro_mxu_seg(raw_sorted, starts, counts, bg_color, n_blocks: int, kc: int,
                            bs: int, mtw: int, layout=DEFAULT_LAYOUT):
    """Segment-walk compositor (replaces ``composite_macro_mxu_seg_pallas``).
    raw_sorted [S, 16] float32 in (block, depth) order; starts, counts [M]
    int32 (counts clipped to kc). Returns [M, 3, 1, bs*bs] float32."""
    if raw_sorted.device.type == "cpu":
        return composite_macro_mxu_seg_reference(raw_sorted, starts, counts, bg_color,
                                                 n_blocks, kc, bs, mtw)
    bg = _bg(bg_color, raw_sorted.device)
    _check_common(raw_sorted, 2, counts, bg, n_blocks, bs, layout)
    check(starts, "starts", torch.int32, (n_blocks,), raw_sorted.device)
    out = _launch_macro(raw_sorted, None, starts, counts, bg, n_blocks, kc, bs, mtw, layout)
    if n_blocks:
        add_count("composite_macro_mxu_seg")
    return out


def composite_macro_mxu(raw, counts, bg_color, bs: int, mtw: int, layout=DEFAULT_LAYOUT,
                        block0: int = 0):
    """Windowed compositor (replaces ``composite_macro_mxu_pallas``). raw
    [M, Kc, 16] float32 gathered rows, counts [M] int32 (valid rows are a
    prefix). Row m of the window is image block ``block0 + m`` (a strip of
    blocks, as the sharded renderer composites them). Returns [M, 3, 1,
    bs*bs] float32."""
    if raw.device.type == "cpu":
        return composite_macro_mxu_reference(raw, counts, bg_color, bs, mtw, block0=block0)
    if block0 < 0:
        raise ValueError(f"block0 must be >= 0, got {block0}")
    bg = _bg(bg_color, raw.device)
    n_blocks = raw.shape[0]
    _check_common(raw, 3, counts, bg, n_blocks, bs, layout)
    out = _launch_macro(raw, None, None, counts, bg, n_blocks, raw.shape[1], bs, mtw, layout,
                        block0)
    if n_blocks:
        add_count("composite_macro_mxu")
    return out


def composite_macro_mxu_seg_indexed(table, gid_s, starts, counts, bg_color, n_blocks: int,
                                    kc: int, bs: int, mtw: int, layout=DEFAULT_LAYOUT):
    """The segment walk through the selection's index: block b walks rows
    table[gid_s[i]] for i in [starts[b], starts[b] + counts[b]), counts
    clipped to kc. table [N, 16] float32 (``pack_raw_table``), gid_s [S],
    starts, counts [M] int32. On a CPU tensor: ``composite_macro_mxu_seg``
    on the gathered ``table[gid_s]``. Returns [M, 3, 1, bs*bs] float32;
    counted as a launch of ``composite_macro_mxu_seg``."""
    if table.device.type == "cpu":
        return composite_macro_mxu_seg(table[gid_s.long()], starts, counts, bg_color,
                                       n_blocks=n_blocks, kc=kc, bs=bs, mtw=mtw)
    bg = _bg(bg_color, table.device)
    _check_common(table, 2, counts, bg, n_blocks, bs, layout)
    check(gid_s, "gid_s", torch.int32, 1, table.device)
    check(starts, "starts", torch.int32, (n_blocks,), table.device)
    out = _launch_macro(table, gid_s, starts, counts, bg, n_blocks, kc, bs, mtw, layout)
    if n_blocks:
        add_count("composite_macro_mxu_seg")
    return out


def composite_macro_mxu_indexed(table, macro_idx, counts, bg_color, bs: int, mtw: int,
                                layout=DEFAULT_LAYOUT):
    """The windowed walk through the selection's index: block b walks rows
    table[macro_idx[b, i]] for i < counts[b] (valid slots are a prefix, -1
    past it). table [N, 16] float32, macro_idx [M, Kc] and counts [M]
    int32. On a CPU tensor: ``composite_macro_mxu`` on the gathered
    ``table[max(macro_idx, 0)]``. Returns [M, 3, 1, bs*bs] float32; counted
    as a launch of ``composite_macro_mxu``."""
    if table.device.type == "cpu":
        return composite_macro_mxu(table[torch.clamp(macro_idx, min=0).long()], counts,
                                   bg_color, bs=bs, mtw=mtw)
    bg = _bg(bg_color, table.device)
    n_blocks = macro_idx.shape[0]
    _check_common(table, 2, counts, bg, n_blocks, bs, layout)
    check(macro_idx, "macro_idx", torch.int32, 2, table.device)
    out = _launch_macro(table, macro_idx, None, counts, bg, n_blocks, macro_idx.shape[1], bs,
                        mtw, layout)
    if n_blocks:
        add_count("composite_macro_mxu")
    return out


def _check_slots(g_mean, g_conic, g_color, g_op, slot_valid, bg):
    """The gathered slot arrays of the per-tile walks: float32, contiguous,
    on one card, [R, K, 2/3/3] and [R, K]. Returns (R, K)."""
    rows, k = g_mean.shape[:2]
    for t, name, shape in ((g_mean, "mean", (rows, k, 2)), (g_conic, "conic", (rows, k, 3)),
                           (g_color, "color", (rows, k, 3)), (g_op, "opacity", (rows, k)),
                           (slot_valid, "valid", (rows, k))):
        check(t, name, torch.float32, shape, g_mean.device)
    check(bg, "bg_color", torch.float32, (3,), g_mean.device)
    return rows, k


def composite_tiles(g_mean, g_conic, g_color, g_op, slot_valid, bg_color, tile_w: int,
                    _dense: bool = False):
    """Per-tile walk (replaces ``composite_tiles_pallas``): each tile walks
    its own K gathered slots. mean [T, K, 2], conic [T, K, 3], colour [T, K,
    3], opacity [T, K], valid [T, K] (1.0 where the slot holds a Gaussian),
    all float32. Returns [T, 3, 16, 16] float32. On the card the kernel
    walks, per tile, the slots its cull keeps."""
    if g_mean.device.type == "cpu":
        return composite_tiles_reference(g_mean, g_conic, g_color, g_op, slot_valid, bg_color,
                                         tile_w)
    dev = g_mean.device
    bg = _bg(bg_color, dev)
    n_tiles, k = _check_slots(g_mean, g_conic, g_color, g_op, slot_valid, bg)
    out = torch.empty((n_tiles, 3, TILE, TILE), dtype=torch.float32, device=dev)
    if n_tiles:
        launch(_walk_lib().aip_composite_tiles, dev, g_mean, g_conic, g_color, g_op, slot_valid,
               bg, out, n_tiles, k, tile_w, int(_dense))
        add_count("composite_tiles")
    return out


def composite_from_macro(g_mean, g_conic, g_color, g_op, slot_valid, bg_color, n_tiles: int,
                         tile_w: int, macro: int, macro_tile_w: int):
    """Fused macro-to-tile walk (replaces ``composite_from_macro_pallas``):
    each of the n_tiles 16 px tiles walks its macro block's depth-sorted
    list (``macro_of_tile``). mean [M, Kc, 2], conic [M, Kc, 3], colour [M,
    Kc, 3], opacity [M, Kc], valid [M, Kc], all float32. Returns [n_tiles,
    3, 16, 16] float32. On the card the kernel stages each macro block's
    list once for its tiles and walks, per tile, the slots its cull
    keeps."""
    if g_mean.device.type == "cpu":
        return composite_from_macro_reference(g_mean, g_conic, g_color, g_op, slot_valid,
                                              bg_color, n_tiles, tile_w, macro, macro_tile_w)
    dev = g_mean.device
    bg = _bg(bg_color, dev)
    n_blocks, kc = _check_slots(g_mean, g_conic, g_color, g_op, slot_valid, bg)
    if not (1 <= macro <= MAX_MACRO and tile_w >= 1 and macro_tile_w >= 1 and n_tiles >= 0):
        raise ValueError(f"the fused walk's kernel takes macro blocks of 1 to {MAX_MACRO} tiles "
                         f"a side and positive grid widths, got macro={macro}, "
                         f"tile_w={tile_w}, macro_tile_w={macro_tile_w}")
    if n_tiles and int(macro_of_tile(n_tiles, tile_w, macro, macro_tile_w).max()) >= n_blocks:
        raise ValueError(f"{n_tiles} tiles of a {tile_w}-tile row in macro blocks of {macro} "
                         f"(a {macro_tile_w}-block row) need more than {n_blocks} blocks")
    out = torch.empty((n_tiles, 3, TILE, TILE), dtype=torch.float32, device=dev)
    if n_tiles:
        launch(_walk_lib().aip_composite_from_macro, dev, g_mean, g_conic, g_color, g_op,
               slot_valid, bg, out, n_tiles, kc, tile_w, macro, macro_tile_w)
        add_count("composite_from_macro")
    return out


def composite_macro_blocks(coeff, colors, counts, bg_color, bs: int, _dense: bool = False):
    """Coefficient walk (replaces ``composite_macro_blocks_pallas``): coeff
    [M, Kc, 8] and colours [M, Kc, 4] float32, counts [M] int32 (valid rows
    are a prefix). Returns [M, 3, 1, bs*bs] float32. The kernel takes macro
    blocks of 16, 32 and 64 px (macro 1, 2 and 4) and walks, per 16 x 16
    sub-tile, the rows its cull keeps."""
    if coeff.device.type == "cpu":
        return composite_macro_blocks_reference(coeff, colors, counts, bg_color, bs)
    dev = coeff.device
    bg = _bg(bg_color, dev)
    if bs not in BLOCK_SIZES:
        raise ValueError(f"the coefficient walk kernel takes macro blocks of {BLOCK_SIZES} px, "
                         f"got bs={bs} (macro {bs // TILE}); the plain version takes any size "
                         f"on a CPU tensor")
    n_blocks, kc = coeff.shape[:2]
    check(coeff, "coeff", torch.float32, (n_blocks, kc, 8), dev, align=16)
    check(colors, "colors", torch.float32, (n_blocks, kc, 4), dev, align=16)
    check(counts, "counts", torch.int32, (n_blocks,), dev)
    check(bg, "bg_color", torch.float32, (3,), dev)
    out = torch.empty((n_blocks, 3, 1, bs * bs), dtype=torch.float32, device=dev)
    if n_blocks:
        launch(_walk_lib().aip_composite_macro_blocks, dev, coeff, colors, counts, bg, out,
               n_blocks, kc, bs, int(_dense))
        add_count("composite_macro_blocks")
    return out


_NAMES = ("composite_macro_mxu_seg", "composite_macro_mxu", "composite_tiles",
          "composite_from_macro", "composite_macro_blocks")


def reset_launch_counts() -> None:
    reset_counts(*_NAMES)


def launch_counts() -> dict[str, int]:
    return read_counts(*_NAMES)
