"""TV-L1 primal-dual inner loop: the wrapper of the CUDA kernel and its
plain version.

Port of ``aip_tpu/ops/pallas/tvl1.py``'s ``tvl1_inner_pallas``: ``iters``
Zach-Pock-Bischof iterations for every frame pair of a batch, each a
thresholding step on the linearised data term, the backward divergence of
the dual fields, the forward gradient with a Neumann edge and the dual
update. The CUDA kernel is ``aip_tpu_torch/csrc/tvl1.cu`` (its header note
says what bounds it and how it is laid out). Here:

* ``tvl1_inner(rho_c, i1wx, i1wy, grad2, u1, u2, p, iters, l_t, theta,
  taut) -> (u1, u2, (p11, p12, p21, p22))``, every array [B, H, W]
  float32. On a CUDA tensor it launches the kernel or raises; on a CPU
  tensor it runs the plain version. The form follows the frame (``form``):
  up to ``FRAME_SIDE`` x ``FRAME_SIDE`` the whole frame stays on chip for
  all ``iters`` iterations (one launch), above it the tile form runs k
  iterations a launch on ``TILE_SIDE``-pixel regions, each a tile with a
  k-pixel halo. ``launch_counts()`` counts the kernel launches,
  ``iteration_counts()`` the iterations run on the kernel.
* ``tvl1_inner_reference``: the same loop in PyTorch ops, written from
  ``ops/pallas/tvl1.py:50-94`` expression for expression, so that the
  kernel (which rounds every product and sum on its own, no fused
  multiply-add) can match it to the last bit.
* ``tvl1_inner_tiled_reference``: the kernel's decomposition in plain
  PyTorch (regions with a halo, edge rules by global coordinates, rounds of
  ``k`` iterations); the design's executable specification. It equals
  ``tvl1_inner_reference`` to the bit; nothing on the main path calls it.
* ``_grad_fwd`` / ``_div``: the two stencils on batched [B, H, W] fields,
  with the Pallas kernel's edge rules. ``aip_tpu_torch.ops.flow`` uses them
  too; for H, W >= 2 they equal ``aip_tpu.ops.flow``'s roll-based forms.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from aip_tpu_torch.kernels._build import (add_count, bind, check, launch, read_counts,
                                           reset_counts)

FRAME_SIDE = 64      # frames up to this side run whole on chip, one launch a call
TILE_SIDE = 64       # the tile form's region side, halo included
TILE_KS = (4, 8, 12, 16)  # the iterations a launch the tile form is built for
# A launch's loads and stores cost about as much as 1.5 iterations of its
# region (the k sweep on the H100, PERF.md).
TILE_LOAD_ITERS = 1.5


@functools.cache
def _lib() -> ctypes.CDLL:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # 10 inputs, 6 outputs, 6 scratch fields; B, H, W, iters, k; l_t, theta,
    # taut; the stream.
    return bind("tvl1", aip_tvl1_inner=[p] * 22 + [i] * 5 + [f] * 3 + [p])


def _grad_fwd(x: torch.Tensor):
    """Forward differences of [B, H, W], zero at the far edge (Neumann)."""
    gx = torch.cat([x[:, :, 1:] - x[:, :, :-1], torch.zeros_like(x[:, :, :1])], dim=2)
    gy = torch.cat([x[:, 1:, :] - x[:, :-1, :], torch.zeros_like(x[:, :1, :])], dim=1)
    return gx, gy


def _div(px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """Backward divergence of [B, H, W], the negative adjoint of
    ``_grad_fwd``: ``px[0]`` at the first column, ``-px[W-2]`` at the last."""
    dx = torch.cat([px[:, :, :1], px[:, :, 1:-1] - px[:, :, :-2], -px[:, :, -2:-1]], dim=2)
    dy = torch.cat([py[:, :1, :], py[:, 1:-1, :] - py[:, :-2, :], -py[:, -2:-1, :]], dim=1)
    return dx + dy


def _iterate(consts, state, iters, l_t, theta, taut, div):
    """``iters`` Jacobi iterations, each reading only the previous one's
    fields, with the divergence ``div``. consts (rho_c, i1wx, i1wy, grad2),
    state (u1, u2, p11, p12, p21, p22)."""
    rho_c, i1wx, i1wy, grad2 = consts
    u1, u2, p11, p12, p21, p22 = state
    safe = torch.clamp(grad2, min=1e-8)
    for _ in range(iters):
        rho = rho_c + i1wx * u1 + i1wy * u2
        mask_lo = rho < -l_t * grad2
        mask_hi = rho > l_t * grad2
        d1 = torch.where(mask_lo, l_t * i1wx,
                         torch.where(mask_hi, -l_t * i1wx, -rho * i1wx / safe))
        d2 = torch.where(mask_lo, l_t * i1wy,
                         torch.where(mask_hi, -l_t * i1wy, -rho * i1wy / safe))
        v1 = u1 + d1
        v2 = u2 + d2
        u1 = v1 + theta * div(p11, p12)
        u2 = v2 + theta * div(p21, p22)
        u1x, u1y = _grad_fwd(u1)
        u2x, u2y = _grad_fwd(u2)
        n1 = 1.0 + taut * torch.sqrt(u1x * u1x + u1y * u1y)
        n2 = 1.0 + taut * torch.sqrt(u2x * u2x + u2y * u2y)
        p11, p12 = (p11 + taut * u1x) / n1, (p12 + taut * u1y) / n1
        p21, p22 = (p21 + taut * u2x) / n2, (p22 + taut * u2y) / n2
    return u1, u2, p11, p12, p21, p22


def tvl1_inner_reference(rho_c, i1wx, i1wy, grad2, u1, u2, p, iters: int, l_t: float,
                         theta: float, taut: float):
    """The plain loop: ``iters`` Jacobi iterations, each reading only the
    previous iteration's fields. Returns (u1, u2, (p11, p12, p21, p22))."""
    u1, u2, *p = _iterate((rho_c, i1wx, i1wy, grad2), (u1, u2, *p), iters, l_t, theta, taut,
                          _div)
    return u1, u2, tuple(p)


def _backward_diff(x: torch.Tensor, dim: int, last: bool) -> torch.Tensor:
    """One axis of the divergence on a region: x[i] - x[i-1] inside,
    ``-x[n-2]`` where the region's last slice is the image's last
    (``last``). The first slice keeps x[0], the image's rule there; on a cut
    first edge that value is not valid, and the region's shrinking valid
    part never reads it."""
    n = x.shape[dim]
    if n == 1:
        return x
    inner = x.narrow(dim, 1, n - 1) - x.narrow(dim, 0, n - 1)
    if last:
        inner = torch.cat([inner.narrow(dim, 0, n - 2), -x.narrow(dim, n - 2, 1)], dim)
    return torch.cat([x.narrow(dim, 0, 1), inner], dim)


def tvl1_inner_tiled_reference(rho_c, i1wx, i1wy, grad2, u1, u2, p, iters: int, l_t: float,
                               theta: float, taut: float, tile, k: int,
                               halo: int | None = None):
    """The tile form's decomposition in plain PyTorch: ceil(iters / k)
    rounds (the last runs what remains); in each, every ``tile`` (an int or
    (height, width)) of the frame runs the round's iterations on itself plus
    ``halo`` pixels a side (``k`` by default), cut at the image, with the
    edge rules of the image's edges only, and keeps its own pixels. With
    ``halo >= k`` it equals ``tvl1_inner_reference`` to the bit; a tile that
    covers the frame with k = iters is the whole-frame form."""
    halo = k if halo is None else halo
    th, tw = (tile, tile) if isinstance(tile, int) else tile
    if th < 1 or tw < 1 or k < 1 or halo < 0:
        raise ValueError(f"tile {tile}, k {k} and halo {halo} must be positive")
    _, h, w = rho_c.shape
    consts = (rho_c, i1wx, i1wy, grad2)
    state = (u1, u2, *p)
    for start in range(0, iters, k):
        n = min(k, iters - start)
        new = tuple(torch.empty_like(f) for f in state)
        for y0 in range(0, h, th):
            for x0 in range(0, w, tw):
                ya, yb = max(y0 - halo, 0), min(y0 + th + halo, h)
                xa, xb = max(x0 - halo, 0), min(x0 + tw + halo, w)
                y1, x1 = min(y0 + th, h), min(x0 + tw, w)

                def div(px, py, last_x=xb == w, last_y=yb == h):
                    return _backward_diff(px, 2, last_x) + _backward_diff(py, 1, last_y)

                out = _iterate(tuple(f[:, ya:yb, xa:xb] for f in consts),
                               tuple(f[:, ya:yb, xa:xb] for f in state), n, l_t, theta, taut,
                               div)
                for f, o in zip(new, out):
                    f[:, y0:y1, x0:x1] = o[:, y0 - ya:y1 - ya, x0 - xa:x1 - xa]
        state = new
    u1, u2, *p = state
    return u1, u2, tuple(p)


def form(h: int, w: int) -> int:
    """The kernel's iterations a launch for an H x W frame: 0 for the
    whole-frame form, else the tile form's k with the least work an
    iteration: regions x (k + TILE_LOAD_ITERS) / k, a region of TILE_SIDE^2
    for each (TILE_SIDE - 2k)^2 tile (4 at 256^2, 8 at 128^2)."""
    if h <= FRAME_SIDE and w <= FRAME_SIDE:
        return 0

    def work(k):
        tile = TILE_SIDE - 2 * k
        return -(-h // tile) * -(-w // tile) * (k + TILE_LOAD_ITERS) / k

    return min(TILE_KS, key=work)


def launches_per_call(h: int, w: int, iters: int, k: int | None = None) -> int:
    """Kernel launches of one call on an H x W frame (iters 0 copies)."""
    k = form(h, w) if k is None else k
    return 0 if iters == 0 else 1 if k == 0 else -(-iters // k)


def tvl1_inner(rho_c, i1wx, i1wy, grad2, u1, u2, p, iters: int, l_t: float, theta: float,
               taut: float):
    """``iters`` primal-dual iterations for every frame pair of the batch
    (replaces ``tvl1_inner_pallas``). All ten arrays [B, H, W] float32.
    Returns new (u1, u2, (p11, p12, p21, p22)); the inputs are not written."""
    if rho_c.device.type == "cpu":
        return tvl1_inner_reference(rho_c, i1wx, i1wy, grad2, u1, u2, p, iters, l_t, theta,
                                    taut)
    return _launch(rho_c, i1wx, i1wy, grad2, u1, u2, p, iters, l_t, theta, taut)


def _launch(rho_c, i1wx, i1wy, grad2, u1, u2, p, iters, l_t, theta, taut, k=None):
    """The kernel on CUDA tensors, in the form ``k`` (``form(H, W)`` by
    default; 0 whole frame, else one of TILE_KS)."""
    if rho_c.ndim != 3:
        raise ValueError(f"rho_c must be [B, H, W], got {tuple(rho_c.shape)}")
    shape = tuple(rho_c.shape)
    b, h, w = shape
    if len(p) != 4:
        raise ValueError(f"p must hold four dual fields, got {len(p)}")
    if b > 65535 or min(shape) < 1 or iters < 0:
        raise ValueError(f"the kernel takes 1 <= B <= 65535, H, W >= 1 and iters >= 0, got "
                         f"{shape}, iters {iters}")
    k = form(h, w) if k is None else k
    if not (k in TILE_KS or (k == 0 and h <= FRAME_SIDE and w <= FRAME_SIDE)):
        raise ValueError(f"k = {k}: the kernel runs k in {TILE_KS}, or 0 on a frame up to "
                         f"{FRAME_SIDE}^2, got {h}x{w}")
    ins = (rho_c, i1wx, i1wy, grad2, u1, u2, *p)
    for name, t in zip(("rho_c", "i1wx", "i1wy", "grad2", "u1", "u2", "p11", "p12", "p21",
                        "p22"), ins):
        check(t, name, torch.float32, shape, rho_c.device)
    launches = launches_per_call(h, w, iters, k)
    outs = torch.empty((6, b, h, w), dtype=torch.float32, device=rho_c.device)
    scratch = torch.empty_like(outs) if launches > 1 else outs
    launch(_lib().aip_tvl1_inner, rho_c.device, *ins, *outs, *scratch, b, h, w, iters, k, l_t,
           theta, taut)
    add_count("tvl1", launches)
    add_count("tvl1.iterations", iters)
    return outs[0], outs[1], tuple(outs[2:])


def reset_launch_counts() -> None:
    reset_counts("tvl1", "tvl1.iterations")


def launch_counts() -> dict[str, int]:
    return read_counts("tvl1")


def iteration_counts() -> dict[str, int]:
    return {"tvl1": read_counts("tvl1.iterations")["tvl1.iterations"]}
