"""Differentiable per-tile compositor: wrappers of kernels A and B, their
plain versions and the autograd Function.

Port of ``aip_tpu/ops/pallas/composite_ad.py`` (``composite_tiles_ad``, a
``jax.custom_vjp`` over two Pallas kernels). The CUDA kernels are in
``aip_tpu_torch/csrc/composite_ad.cu`` (its header note gives the gradient
identities, what bounds the kernels and how they are laid out). Here:

* ``composite_ad_fwd`` (kernel A, replaces ``_pallas_fwd``) and
  ``composite_ad_bwd`` (kernel B, replaces ``_pallas_bwd``): for a CUDA
  tensor each launches its kernel or raises; for a CPU tensor it runs its
  plain version. Each counts its launches in ``.launches``.
* ``composite_ad_fwd_reference`` / ``composite_ad_bwd_reference``: the same
  walks in plain torch, vectorised over tiles and pixels with a Python loop
  over the K slots (front to back, then back to front with the suffix
  accumulators).
* ``composite_tiles_ad``: the ``torch.autograd.Function`` the rasterizer
  calls on the gathered per-tile arrays; returns [T, 3, 16, 16].

Inputs are the gathered per-tile arrays: mean [T, K, 2], conic [T, K, 3],
colour [T, K, 3], opacity [T, K, 1], valid [T, K, 1] (1.0 where the slot
holds a Gaussian), bg [3]; tile t's origin is ((t % tile_w) * 16,
(t // tile_w) * 16).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from aip_tpu_torch.kernels._build import library

TILE = 16
MAX_SMEM = 227 * 1024


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = library("composite_ad")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.aip_composite_ad_fwd.argtypes = [p, p, p, p, p, p, p, p, i, i, i, p]
    lib.aip_composite_ad_bwd.argtypes = [p, p, p, p, p, p, p, p, p, p, p, p, i, i, i, p]
    lib.aip_composite_ad_fwd.restype = ctypes.c_int
    lib.aip_composite_ad_bwd.restype = ctypes.c_int
    return lib


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
# Kernel launches (CUDA tensors only)
# ---------------------------------------------------------------------------

def _check(t, name, shape):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: the kernels take float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {tuple(shape)} tensor, "
                         f"got {tuple(t.shape)}")


def _check_inputs(mean, conic, color, op, valid, bg):
    n_tiles, k = mean.shape[0], mean.shape[1]
    for t, name, w in ((mean, "mean", 2), (conic, "conic", 3), (color, "color", 3),
                       (op, "opacity", 1), (valid, "valid", 1)):
        _check(t, name, (n_tiles, k, w))
    _check(bg, "bg", (3,))
    if k * (10 + 8 * 9) * 4 > MAX_SMEM:
        raise ValueError(f"K={k} slots exceed the kernels' shared memory")
    return n_tiles, k


def _launch(fn, device, args):
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed to launch: CUDA error {err}")


def composite_ad_fwd(mean, conic, color, op, valid, bg, tile_w: int):
    """Kernel A: (out [T, 3, 16, 16], t_final [T, 16, 16])."""
    if mean.device.type == "cpu":
        return composite_ad_fwd_reference(mean, conic, color, op, valid, bg, tile_w)
    n_tiles, k = _check_inputs(mean, conic, color, op, valid, bg)
    out = torch.empty((n_tiles, 3, TILE, TILE), dtype=torch.float32, device=mean.device)
    t_final = torch.empty((n_tiles, TILE, TILE), dtype=torch.float32, device=mean.device)
    if n_tiles:
        _launch(_lib().aip_composite_ad_fwd, mean.device,
                (mean.data_ptr(), conic.data_ptr(), color.data_ptr(), op.data_ptr(),
                 valid.data_ptr(), bg.data_ptr(), out.data_ptr(), t_final.data_ptr(),
                 n_tiles, k, tile_w))
        composite_ad_fwd.launches += 1
    return out, t_final


def composite_ad_bwd(mean, conic, color, op, valid, bg, t_final, g_out, tile_w: int):
    """Kernel B: (d mean [T, K, 2], d conic [T, K, 3], d colour [T, K, 3],
    d opacity [T, K, 1])."""
    if mean.device.type == "cpu":
        return composite_ad_bwd_reference(mean, conic, color, op, valid, bg, t_final, g_out,
                                          tile_w)
    n_tiles, k = _check_inputs(mean, conic, color, op, valid, bg)
    _check(t_final, "t_final", (n_tiles, TILE, TILE))
    _check(g_out, "g_out", (n_tiles, 3, TILE, TILE))
    dev = mean.device
    outs = [torch.empty((n_tiles, k, w), dtype=torch.float32, device=dev) for w in (2, 3, 3, 1)]
    if n_tiles:
        _launch(_lib().aip_composite_ad_bwd, dev,
                (mean.data_ptr(), conic.data_ptr(), color.data_ptr(), op.data_ptr(),
                 valid.data_ptr(), bg.data_ptr(), t_final.data_ptr(), g_out.data_ptr(),
                 *(o.data_ptr() for o in outs), n_tiles, k, tile_w))
        composite_ad_bwd.launches += 1
    return tuple(outs)


composite_ad_fwd.launches = 0
composite_ad_bwd.launches = 0


def reset_launch_counts() -> None:
    composite_ad_fwd.launches = 0
    composite_ad_bwd.launches = 0


def launch_counts() -> dict[str, int]:
    return {"composite_ad_fwd": composite_ad_fwd.launches,
            "composite_ad_bwd": composite_ad_bwd.launches}


class _CompositeTilesAD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mean, conic, color, op, valid, bg, tile_w):
        args = [t.contiguous() for t in (mean, conic, color, op, valid, bg)]
        out, t_final = composite_ad_fwd(*args, tile_w)
        ctx.save_for_backward(*args, t_final)
        ctx.tile_w = tile_w
        return out

    @staticmethod
    def backward(ctx, g_out):
        *args, t_final = ctx.saved_tensors
        d_mean, d_conic, d_color, d_op = composite_ad_bwd(*args, t_final, g_out.contiguous(),
                                                          ctx.tile_w)
        return d_mean, d_conic, d_color, d_op, None, None, None


def composite_tiles_ad(g_mean, g_conic, g_color, g_op, g_valid, tile_w: int, bg):
    """Differentiable streamed compositing of the gathered per-tile arrays
    ([T, K, .]); returns [T, 3, 16, 16]. Gradients flow to mean, conic,
    colour and opacity (none to valid or bg), as in the JAX package."""
    bg = torch.as_tensor(bg, dtype=g_mean.dtype, device=g_mean.device).reshape(3)
    return _CompositeTilesAD.apply(g_mean, g_conic, g_color, g_op, g_valid, bg, tile_w)
