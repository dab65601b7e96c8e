"""Differentiable per-tile compositor: wrappers of kernels A and B, their
plain versions, the emulation of the kernels' walks and the autograd
Function.

Port of ``aip_tpu/ops/pallas/composite_ad.py`` (``composite_tiles_ad``, a
``jax.custom_vjp`` over two Pallas kernels). The CUDA kernels are in
``aip_tpu_torch/csrc/composite_ad.cu`` (its header note gives the gradient
identities, what bounds the kernels, the cull and how they are laid out).
Here:

* ``composite_ad_fwd_packed`` (kernel A, replaces ``_pallas_fwd``) and
  ``composite_ad_bwd_packed`` (kernel B, replaces ``_pallas_bwd``) on the
  packed per-tile rows [T, K, 9] (mean x, y, conic a, b, c, colour r, g, b,
  opacity), the rasterizer's gather: for a CUDA tensor each launches its
  kernel or raises; for a CPU tensor it runs its plain version. B returns
  one [T, K, 9] gradient. ``launch_counts()`` counts the launches.
  ``composite_ad_fwd`` / ``composite_ad_bwd`` take the four arrays apart,
  as the JAX kernels do, and pack them (the tests' form).
* ``composite_ad_fwd_reference`` / ``composite_ad_bwd_reference``: the same
  walks in plain torch, vectorised over tiles and pixels with a Python loop
  over the K slots (front to back, then back to front with the suffix
  accumulators).
* ``live_slots``: the kernels' cull, a conservative proof per (tile, slot)
  that alpha < 1/255 at every pixel of the tile; and
  ``composite_ad_fwd_culled_reference`` /
  ``composite_ad_bwd_culled_reference``: the kernels' walks emulated in
  plain torch (each tile's live list only; B's sums per thread of P pixels,
  then the warp's butterfly, then across warps; B's one suffix division).
* ``composite_tiles_ad_packed``: the ``torch.autograd.Function`` the
  rasterizer calls on its packed gather, returning [T, 3, 16, 16] and, in
  the backward, one [T, K, 9] gradient; ``composite_tiles_ad`` keeps the
  JAX package's signature (four arrays).

Inputs are the gathered per-tile arrays: mean [T, K, 2], conic [T, K, 3],
colour [T, K, 3], opacity [T, K, 1] (packed: [T, K, 9] in that order),
valid [T, K, 1] (1.0 where the slot holds a Gaussian), bg [3]; tile t's
origin is ((t % tile_w) * 16, (t // tile_w) * 16).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from aip_tpu_torch.kernels._build import library

TILE = 16
SLOT = 9                      # packed row: mean 2, conic 3, colour 3, opacity 1
MAX_SMEM = 227 * 1024         # dynamic shared memory a block may take on the H100
PIXELS_PER_THREAD = (1, 2, 4, 8)
FWD_P = 2                     # P of each kernel (the sweep in PERF.md)
BWD_P = 2
# The cull's threshold and margin (csrc/composite_ad.cu, header note).
ALPHA_MIN = float(torch.tensor(1.0 / 255.0, dtype=torch.float32))
ROUNDING_MARGIN = 16 * 2.0 ** -24   # of rho q / 2: more than twice the power's rounding
EXP_MARGIN = 1e-6                   # expf's 2 ulp and the opacity product, as log
LN_ALPHA_MIN = math.log(ALPHA_MIN)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = library("composite_ad")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.aip_composite_ad_fwd.argtypes = [p, p, p, p, p, i, i, i, i, p]
    lib.aip_composite_ad_bwd.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
    lib.aip_composite_ad_smem.argtypes = [i, i, i]
    for fn in (lib.aip_composite_ad_fwd, lib.aip_composite_ad_bwd, lib.aip_composite_ad_smem):
        fn.restype = ctypes.c_int
    return lib


def pack(mean, conic, color, op):
    """The packed rows [T, K, 9] of the four gathered arrays."""
    return torch.cat([mean, conic, color, op], dim=-1)


def _unpack(g):
    return g[..., 0:2], g[..., 2:5], g[..., 5:8], g[..., 8:9]


# ---------------------------------------------------------------------------
# Plain versions (the CPU path, and what the kernels are held against)
# ---------------------------------------------------------------------------

def _pixels(n_tiles: int, tile_w: int, device):
    """Pixel centres (px, py) of every tile, each [T, 256], pixel p at
    row p // 16, column p % 16."""
    t = torch.arange(n_tiles, device=device)
    p = torch.arange(TILE * TILE, device=device)
    px = ((t % tile_w) * TILE)[:, None] + (p % TILE)[None, :]
    py = ((t // tile_w) * TILE)[:, None] + (p // TILE)[None, :]
    return px.to(torch.float32), py.to(torch.float32)


def _alpha_terms(mean, conic, op, valid, k, px, py):
    """Slot k at every pixel: (alpha, raw, live, dx, dy, power), [T, 256]."""
    dx = px - mean[:, k, 0:1]
    dy = py - mean[:, k, 1:2]
    power = -0.5 * (conic[:, k, 0:1] * dx * dx + conic[:, k, 2:3] * dy * dy) \
        - conic[:, k, 1:2] * dx * dy
    raw = op[:, k, 0:1] * torch.exp(torch.clamp(power, max=0.0))
    alpha = torch.clamp(raw, max=0.99)
    live = (valid[:, k, 0:1] > 0) & (alpha >= 1.0 / 255.0)
    alpha = torch.where(live, alpha, torch.zeros((), dtype=alpha.dtype, device=alpha.device))
    return alpha, raw, live, dx, dy, power


def composite_ad_fwd_reference(mean, conic, color, op, valid, bg, tile_w: int):
    """Plain forward: (out [T, 3, 16, 16], t_final [T, 16, 16])."""
    n_tiles, k, _ = mean.shape
    px, py = _pixels(n_tiles, tile_w, mean.device)
    px, py = px.to(mean.dtype), py.to(mean.dtype)
    trans = torch.ones_like(px)
    acc = torch.zeros((n_tiles, 3, TILE * TILE), dtype=mean.dtype, device=mean.device)
    for i in range(k):
        alpha = _alpha_terms(mean, conic, op, valid, i, px, py)[0]
        w = torch.where(trans > 1e-4, alpha * trans, torch.zeros_like(trans))
        acc = acc + w[:, None, :] * color[:, i, :, None]
        trans = trans * (1.0 - alpha)
    out = acc + trans[:, None, :] * bg.to(mean.dtype)[None, :, None]
    return out.reshape(n_tiles, 3, TILE, TILE), trans.reshape(n_tiles, TILE, TILE)


def composite_ad_bwd_reference(mean, conic, color, op, valid, bg, t_final, g_out, tile_w: int):
    """Plain backward: (d mean [T, K, 2], d conic [T, K, 3], d colour
    [T, K, 3], d opacity [T, K, 1]), the reverse walk of the JAX kernel."""
    n_tiles, k, _ = mean.shape
    px, py = _pixels(n_tiles, tile_w, mean.device)
    px, py = px.to(mean.dtype), py.to(mean.dtype)
    g = g_out.reshape(n_tiles, 3, TILE * TILE)
    tf = t_final.reshape(n_tiles, TILE * TILE)
    bg_t = tf[:, None, :] * bg.to(mean.dtype)[None, :, None]           # [T, 3, P]
    t_after = tf
    s = torch.zeros_like(g)
    zero = torch.zeros((), dtype=mean.dtype, device=mean.device)
    grads = torch.zeros((n_tiles, k, 9), dtype=mean.dtype, device=mean.device)
    for i in range(k - 1, -1, -1):
        alpha, raw, live_f, dx, dy, power = _alpha_terms(mean, conic, op, valid, i, px, py)
        one_m = 1.0 - alpha
        t_exc = t_after / one_m
        live = t_exc > 1e-4
        w = torch.where(live, alpha * t_exc, zero)
        c = color[:, i, :, None]                                        # [T, 3, 1]
        dalpha = (g * (t_exc[:, None, :] * c - (s + bg_t) / one_m[:, None, :])).sum(1)
        dalpha = torch.where(live, dalpha, zero)
        d_raw = torch.where(live_f & (raw < 0.99), dalpha, zero)
        opk = op[:, i, 0:1]
        exp_pow = torch.where(opk != 0, raw / torch.where(opk != 0, opk, 1.0), zero)
        d_power = torch.where(power < 0, d_raw * raw, zero)
        ca, cb, cc = conic[:, i, 0:1], conic[:, i, 1:2], conic[:, i, 2:3]
        grads[:, i] = torch.stack([
            (d_power * (ca * dx + cb * dy)).sum(1),
            (d_power * (cc * dy + cb * dx)).sum(1),
            (d_power * (-0.5 * dx * dx)).sum(1),
            (d_power * (-dx * dy)).sum(1),
            (d_power * (-0.5 * dy * dy)).sum(1),
            (g[:, 0] * w).sum(1), (g[:, 1] * w).sum(1), (g[:, 2] * w).sum(1),
            (d_raw * exp_pow).sum(1),
        ], dim=1)
        s = s + w[:, None, :] * c
        t_after = t_exc
    return grads[..., 0:2], grads[..., 2:5], grads[..., 5:8], grads[..., 8:9]




# ---------------------------------------------------------------------------
# The kernels' walks, emulated in plain torch
# ---------------------------------------------------------------------------

def margin_factor(a, b, c):
    """1 - 16 u rho of each conic (float64), NaN where it is not positive
    definite; rho = 1 + 2 |b| / lambda_min bounds (a X^2 + c Y^2 + 2 |b X
    Y|) / q everywhere (``csrc/cull.cuh``, ``margin_factor``)."""
    det = a * c - b * b
    half_d = 0.5 * (a - c)
    l_max = 0.5 * (a + c) + torch.sqrt(half_d * half_d + b * b)
    rho = 1.0 + (2.0 * b.abs()) / (det / l_max)
    factor = 1.0 - ROUNDING_MARGIN * rho
    return torch.where((a > 0) & (c > 0) & (det > 0), factor,
                       torch.full_like(factor, math.nan))


def box_visible(mx, my, a, b, c, ln_op, x0, y0, w: int, h: int):
    """False where a test in float64 proves alpha < 1/255 at every pixel
    centre of the box [x0, x0 + w - 1] x [y0, y0 + h - 1] for the Gaussian
    at (mx, my) with conic (a, b, c) and log opacity ln_op (all float64,
    broadcast together): the least q = a X^2 + 2 b X Y + c Y^2 over the box
    (X, Y from the mean; the exact minimum of a convex quadratic, on the
    box's edges unless the mean is inside) against the power's bound, with a
    margin for a kernel's float32 rounding of the power, in proportion to q,
    and 1e-6 for expf's error (``csrc/cull.cuh``, ``aip_cull``: the same
    expressions in the same order). A conic that is not positive definite
    is never culled."""
    xa, xb = x0 - mx, (x0 + (w - 1)) - mx
    ya, yb = y0 - my, (y0 + (h - 1)) - my
    sx, sy = -b / c, -b / a

    def q(x, y):
        return ((a * x) * x + 2.0 * ((b * x) * y)) + (c * y) * y

    q_min = torch.minimum(
        torch.minimum(q(xa, torch.clamp(sx * xa, ya, yb)), q(xb, torch.clamp(sx * xb, ya, yb))),
        torch.minimum(q(torch.clamp(sy * ya, xa, xb), ya), q(torch.clamp(sy * yb, xa, xb), yb)))
    inside = (xa <= 0) & (xb >= 0) & (ya <= 0) & (yb >= 0)
    q_min = torch.where(inside, torch.zeros_like(q_min), q_min)
    bound = (ln_op - (0.5 * q_min) * margin_factor(a, b, c)) + EXP_MARGIN
    return ~(bound < LN_ALPHA_MIN)


def live_slots(g, valid, tile_w: int, tiles=None):
    """[T, K] bool: the slots each tile's walk keeps, as kernels A and B
    (and the fused walk) decide while staging a tile. A slot goes when it
    is invalid, when its opacity is <= 0, or when ``box_visible`` proves
    alpha < 1/255 at every pixel of the tile (ln_op = ln(opacity): the
    kernels' power has no opacity term). Every other slot stays, so a
    culled slot has alpha 0 at every pixel and skipping it is exact.
    ``tiles``: the tile id of each row of g (by default 0 .. T - 1)."""
    d = g.to(torch.float64)
    mx, my, a, b, c, op = (d[..., i] for i in (0, 1, 2, 3, 4, 8))
    t = torch.arange(g.shape[0], device=g.device) if tiles is None else tiles
    x0 = ((t % tile_w) * TILE).to(torch.float64)[:, None]
    y0 = ((t // tile_w) * TILE).to(torch.float64)[:, None]
    visible = box_visible(mx, my, a, b, c, torch.log(op), x0, y0, TILE, TILE)
    return (valid[..., 0] > 0) & (op > 0) & visible


def _live_order(keep):
    """Each tile's live list: the kept slots first, in their order, then
    the rest; and the list's length. [T, K] int64, [T]."""
    order = torch.sort((~keep).to(torch.int8), dim=1, stable=True).indices
    return order, keep.sum(1)


def _row_terms(r, px, py):
    """One staged row r [T, 9] at every pixel: (alpha, raw, live, dx, dy,
    power), [T, 256], the plain version's expressions in its order."""
    dx = px - r[:, 0:1]
    dy = py - r[:, 1:2]
    power = -0.5 * (r[:, 2:3] * dx * dx + r[:, 4:5] * dy * dy) - r[:, 3:4] * dx * dy
    raw = r[:, 8:9] * torch.exp(torch.clamp(power, max=0.0))
    alpha = torch.clamp(raw, max=0.99)
    live = alpha >= 1.0 / 255.0
    alpha = torch.where(live, alpha, torch.zeros((), dtype=alpha.dtype, device=alpha.device))
    return alpha, raw, live, dx, dy, power


def _thread_sums(v, p: int):
    """Per-pixel terms v [T, n, 256] (pixel row * 16 + column) summed as
    kernel B sums them: thread j of a tile holds column j % 16, rows
    (j // 16) * P + i for i < P, and adds its P values in that order; each
    warp's butterfly (xor 16, 8, 4, 2, 1) sums its 32 threads; the warps'
    sums are added in warp order. Returns [T, n]."""
    n_tiles, n = v.shape[:2]
    x = v.reshape(n_tiles, n, TILE // p, p, TILE).permute(0, 1, 2, 4, 3)
    x = x.reshape(n_tiles, n, TILE * TILE // p, p)
    acc = x[..., 0]
    for i in range(1, p):
        acc = acc + x[..., i]
    acc = acc.reshape(n_tiles, n, -1, 32)
    lane = torch.arange(32, device=v.device)
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[..., lane ^ off]
    tot = acc[..., 0, 0]
    for w in range(1, acc.shape[2]):
        tot = tot + acc[..., w, 0]
    return tot


def composite_ad_fwd_culled_reference(g, valid, bg, tile_w: int):
    """Kernel A's walk in plain torch: each tile walks its live list
    (``live_slots``) only. A pixel's walk is its own, so P does not enter;
    the per-pixel arithmetic is the plain version's. (out [T, 3, 16, 16],
    t_final [T, 16, 16]), equal to ``composite_ad_fwd_reference``."""
    n_tiles = g.shape[0]
    order, n_live = _live_order(live_slots(g, valid, tile_w))
    rows = torch.gather(g, 1, order[..., None].expand(-1, -1, SLOT))
    px, py = (x.to(g.dtype) for x in _pixels(n_tiles, tile_w, g.device))
    trans = torch.ones_like(px)
    acc = torch.zeros((n_tiles, 3, TILE * TILE), dtype=g.dtype, device=g.device)
    for j in range(int(n_live.max()) if n_tiles else 0):
        on = (n_live > j)[:, None]
        r = rows[:, j]
        alpha = _row_terms(r, px, py)[0]
        w = torch.where(trans > 1e-4, alpha * trans, torch.zeros_like(trans))
        acc = torch.where(on[:, None], acc + w[:, None, :] * r[:, 5:8, None], acc)
        trans = torch.where(on, trans * (1.0 - alpha), trans)
    out = acc + trans[:, None, :] * bg.to(g.dtype)[None, :, None]
    return out.reshape(n_tiles, 3, TILE, TILE), trans.reshape(n_tiles, TILE, TILE)


def composite_ad_bwd_culled_reference(g, valid, bg, t_final, g_out, tile_w: int, p: int = BWD_P):
    """Kernel B's walk in plain torch: each tile's live list back to front,
    the suffix term's one division (sum over c of g_c (S_c + T_final bg_c),
    over 1 - alpha, where the plain version divides each channel), the
    sums per thread of P pixels, per warp and across warps
    (``_thread_sums``), zero for every slot not walked. Returns the packed
    gradient [T, K, 9]."""
    n_tiles, k, _ = g.shape
    order, n_live = _live_order(live_slots(g, valid, tile_w))
    rows = torch.gather(g, 1, order[..., None].expand(-1, -1, SLOT))
    px, py = (x.to(g.dtype) for x in _pixels(n_tiles, tile_w, g.device))
    gq = g_out.reshape(n_tiles, 3, TILE * TILE)
    tf = t_final.reshape(n_tiles, TILE * TILE)
    bg_t = tf[:, None, :] * bg.to(g.dtype)[None, :, None]
    t_after = tf
    s = torch.zeros_like(gq)
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    walked = torch.zeros((n_tiles, k, SLOT), dtype=g.dtype, device=g.device)
    for j in range((int(n_live.max()) if n_tiles else 0) - 1, -1, -1):
        on = n_live > j
        r = rows[:, j]
        alpha, raw, live_f, dx, dy, power = _row_terms(r, px, py)
        one_m = 1.0 - alpha
        t_exc = t_after / one_m
        live = t_exc > 1e-4
        w = torch.where(live, alpha * t_exc, zero)
        c = r[:, 5:8, None]
        tc = t_exc[:, None, :] * c
        num = gq * (s + bg_t)
        dalpha = (gq[:, 0] * tc[:, 0] + gq[:, 1] * tc[:, 1]) + gq[:, 2] * tc[:, 2] \
            - ((num[:, 0] + num[:, 1]) + num[:, 2]) / one_m
        dalpha = torch.where(live, dalpha, zero)
        d_raw = torch.where(live_f & (raw < 0.99), dalpha, zero)
        opk = r[:, 8:9]
        exp_pow = torch.where(opk != 0, raw / torch.where(opk != 0, opk, 1.0), zero)
        d_power = torch.where(power < 0, d_raw * raw, zero)
        ca, cb, cc = r[:, 2:3], r[:, 3:4], r[:, 4:5]
        v = torch.stack([
            d_power * (ca * dx + cb * dy),
            d_power * (cc * dy + cb * dx),
            d_power * (-0.5 * dx * dx),
            d_power * (-dx * dy),
            d_power * (-0.5 * dy * dy),
            gq[:, 0] * w, gq[:, 1] * w, gq[:, 2] * w,
            d_raw * exp_pow,
        ], dim=1)
        walked[:, j] = torch.where(on[:, None], _thread_sums(v, p), zero)
        s = torch.where(on[:, None, None], s + w[:, None, :] * c, s)
        t_after = torch.where(on[:, None], t_exc, t_after)
    return torch.zeros_like(walked).scatter(1, order[..., None].expand(-1, -1, SLOT), walked)


# ---------------------------------------------------------------------------
# Kernel launches (CUDA tensors only)
# ---------------------------------------------------------------------------

_LAUNCHES = {"composite_ad_fwd": 0, "composite_ad_bwd": 0}


def _check(t, name, shape, device):
    if t.device != device:
        raise ValueError(f"{name} must be on {device}, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: the kernels take float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {tuple(shape)} tensor, "
                         f"got {tuple(t.shape)}")


def _check_inputs(g, valid, bg, p, backward):
    if g.device.type != "cuda":
        raise ValueError(f"the kernels run on a CUDA or a CPU tensor, got {g.device}")
    if g.ndim != 3:
        raise ValueError(f"g must be [T, K, {SLOT}], got {tuple(g.shape)}")
    n_tiles, k = g.shape[0], g.shape[1]
    _check(g, "g", (n_tiles, k, SLOT), g.device)
    _check(valid, "valid", (n_tiles, k, 1), g.device)
    _check(bg, "bg", (3,), g.device)
    if p not in PIXELS_PER_THREAD:
        raise ValueError(f"P = {p}: the kernels are built for P in {PIXELS_PER_THREAD}")
    smem = _lib().aip_composite_ad_smem(k, p, int(backward))
    if smem > MAX_SMEM:
        raise ValueError(f"K={k} slots exceed kernel {'B' if backward else 'A'}'s shared "
                         f"memory at P={p} ({smem} > {MAX_SMEM} bytes)")
    return n_tiles, k


def _launch(fn, device, args):
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed to launch: CUDA error {err}")


def composite_ad_fwd_packed(g, valid, bg, tile_w: int, p: int = FWD_P):
    """Kernel A on the packed rows g [T, K, 9]: (out [T, 3, 16, 16],
    t_final [T, 16, 16]). ``p``: pixels a thread (the sweep)."""
    if g.device.type == "cpu":
        return composite_ad_fwd_reference(*_unpack(g), valid, bg, tile_w)
    n_tiles, k = _check_inputs(g, valid, bg, p, backward=False)
    out = torch.empty((n_tiles, 3, TILE, TILE), dtype=torch.float32, device=g.device)
    t_final = torch.empty((n_tiles, TILE, TILE), dtype=torch.float32, device=g.device)
    if n_tiles:
        _launch(_lib().aip_composite_ad_fwd, g.device,
                (g.data_ptr(), valid.data_ptr(), bg.data_ptr(), out.data_ptr(),
                 t_final.data_ptr(), n_tiles, k, tile_w, p))
        _LAUNCHES["composite_ad_fwd"] += 1
    return out, t_final


def composite_ad_bwd_packed(g, valid, bg, t_final, g_out, tile_w: int, p: int = BWD_P):
    """Kernel B on the packed rows g [T, K, 9]: the packed gradient
    [T, K, 9] (0 for every slot the walk did not take)."""
    if g.device.type == "cpu":
        return torch.cat(composite_ad_bwd_reference(*_unpack(g), valid, bg, t_final, g_out,
                                                    tile_w), dim=-1)
    n_tiles, k = _check_inputs(g, valid, bg, p, backward=True)
    _check(t_final, "t_final", (n_tiles, TILE, TILE), g.device)
    _check(g_out, "g_out", (n_tiles, 3, TILE, TILE), g.device)
    d_g = torch.empty((n_tiles, k, SLOT), dtype=torch.float32, device=g.device)
    if n_tiles:
        _launch(_lib().aip_composite_ad_bwd, g.device,
                (g.data_ptr(), valid.data_ptr(), bg.data_ptr(), t_final.data_ptr(),
                 g_out.data_ptr(), d_g.data_ptr(), n_tiles, k, tile_w, p))
        _LAUNCHES["composite_ad_bwd"] += 1
    return d_g


def composite_ad_fwd(mean, conic, color, op, valid, bg, tile_w: int):
    """Kernel A on the four arrays (packed first on the card):
    (out [T, 3, 16, 16], t_final [T, 16, 16])."""
    if mean.device.type == "cpu":
        return composite_ad_fwd_reference(mean, conic, color, op, valid, bg, tile_w)
    return composite_ad_fwd_packed(pack(mean, conic, color, op), valid, bg, tile_w)


def composite_ad_bwd(mean, conic, color, op, valid, bg, t_final, g_out, tile_w: int):
    """Kernel B on the four arrays: (d mean [T, K, 2], d conic [T, K, 3],
    d colour [T, K, 3], d opacity [T, K, 1])."""
    if mean.device.type == "cpu":
        return composite_ad_bwd_reference(mean, conic, color, op, valid, bg, t_final, g_out,
                                          tile_w)
    return _unpack(composite_ad_bwd_packed(pack(mean, conic, color, op), valid, bg, t_final,
                                           g_out, tile_w))


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def launch_counts() -> dict[str, int]:
    return dict(_LAUNCHES)


class _CompositeTilesAD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, valid, bg, tile_w):
        out, t_final = composite_ad_fwd_packed(g, valid, bg, tile_w)
        ctx.save_for_backward(g, valid, bg, t_final)
        ctx.tile_w = tile_w
        return out

    @staticmethod
    def backward(ctx, g_out):
        g, valid, bg, t_final = ctx.saved_tensors
        d_g = composite_ad_bwd_packed(g, valid, bg, t_final, g_out.contiguous(), ctx.tile_w)
        return d_g, None, None, None


def composite_tiles_ad_packed(g, g_valid, tile_w: int, bg):
    """Differentiable streamed compositing of the packed gather g
    [T, K, 9] (contiguous on the card: the kernels read it where it lies);
    returns [T, 3, 16, 16]. The gradient reaches g as one [T, K, 9] array
    (none reaches valid or bg), as in the JAX package."""
    bg = torch.as_tensor(bg, dtype=g.dtype, device=g.device).reshape(3)
    return _CompositeTilesAD.apply(g, g_valid, bg, tile_w)


def composite_tiles_ad(g_mean, g_conic, g_color, g_op, g_valid, tile_w: int, bg):
    """The JAX package's signature: the four gathered arrays ([T, K, .]),
    packed, through ``composite_tiles_ad_packed``."""
    return composite_tiles_ad_packed(pack(g_mean, g_conic, g_color, g_op), g_valid, tile_w, bg)
