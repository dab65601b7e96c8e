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
  float32. On a CUDA tensor it launches the kernel (one C call runs the
  ``iters`` iterations as ``iters`` launches on the stream) or raises; on a
  CPU tensor it runs the plain version. ``tvl1_inner.launches`` counts the
  kernel launches, ``iters`` a call.
* ``tvl1_inner_reference``: the same loop in PyTorch ops, written from
  ``ops/pallas/tvl1.py:50-94`` expression for expression, so that the
  kernel (which rounds every product and sum on its own, no fused
  multiply-add) can match it to the last bit.
* ``_grad_fwd`` / ``_div``: the two stencils on batched [B, H, W] fields,
  with the Pallas kernel's edge rules. ``aip_tpu_torch.ops.flow`` uses them
  too; for H, W >= 2 they equal ``aip_tpu.ops.flow``'s roll-based forms.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from aip_tpu_torch.kernels._build import library


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = library("tvl1")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # 10 inputs, 6 outputs, 6 scratch fields; B, H, W, iters; l_t, theta,
    # taut; the stream.
    lib.aip_tvl1_inner.argtypes = [p] * 22 + [i] * 4 + [f] * 3 + [p]
    lib.aip_tvl1_inner.restype = ctypes.c_int
    return lib


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


def tvl1_inner_reference(rho_c, i1wx, i1wy, grad2, u1, u2, p, iters: int, l_t: float,
                         theta: float, taut: float):
    """The plain loop: ``iters`` Jacobi iterations, each reading only the
    previous iteration's fields. Returns (u1, u2, (p11, p12, p21, p22))."""
    p11, p12, p21, p22 = p
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
        u1 = v1 + theta * _div(p11, p12)
        u2 = v2 + theta * _div(p21, p22)
        u1x, u1y = _grad_fwd(u1)
        u2x, u2y = _grad_fwd(u2)
        n1 = 1.0 + taut * torch.sqrt(u1x * u1x + u1y * u1y)
        n2 = 1.0 + taut * torch.sqrt(u2x * u2x + u2y * u2y)
        p11, p12 = (p11 + taut * u1x) / n1, (p12 + taut * u1y) / n1
        p21, p22 = (p21 + taut * u2x) / n2, (p22 + taut * u2y) / n2
    return u1, u2, (p11, p12, p21, p22)


def _check(t, name, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, rho_c on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: the kernel takes float32, got {t.dtype}")
    if tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {shape} tensor, got {tuple(t.shape)}")


def tvl1_inner(rho_c, i1wx, i1wy, grad2, u1, u2, p, iters: int, l_t: float, theta: float,
               taut: float):
    """``iters`` primal-dual iterations for every frame pair of the batch
    (replaces ``tvl1_inner_pallas``). All ten arrays [B, H, W] float32.
    Returns new (u1, u2, (p11, p12, p21, p22)); the inputs are not written."""
    if rho_c.device.type == "cpu":
        return tvl1_inner_reference(rho_c, i1wx, i1wy, grad2, u1, u2, p, iters, l_t, theta,
                                    taut)
    if rho_c.device.type != "cuda":
        raise ValueError(f"tvl1_inner runs on a CUDA or a CPU tensor, got {rho_c.device}")
    if rho_c.ndim != 3:
        raise ValueError(f"rho_c must be [B, H, W], got {tuple(rho_c.shape)}")
    shape = tuple(rho_c.shape)
    b, h, w = shape
    if len(p) != 4:
        raise ValueError(f"p must hold four dual fields, got {len(p)}")
    if b > 65535 or min(shape) < 1 or iters < 0:
        raise ValueError(f"the kernel takes 1 <= B <= 65535, H, W >= 1 and iters >= 0, got "
                         f"{shape}, iters {iters}")
    ins = (rho_c, i1wx, i1wy, grad2, u1, u2, *p)
    for name, t in zip(("rho_c", "i1wx", "i1wy", "grad2", "u1", "u2", "p11", "p12", "p21",
                        "p22"), ins):
        _check(t, name, shape, rho_c.device)
    outs = torch.empty((6, b, h, w), dtype=torch.float32, device=rho_c.device)
    scratch = torch.empty_like(outs) if iters > 1 else outs
    with torch.cuda.device(rho_c.device):
        stream = torch.cuda.current_stream(rho_c.device).cuda_stream
        err = _lib().aip_tvl1_inner(*(t.data_ptr() for t in ins),
                                    *(o.data_ptr() for o in outs),
                                    *(s.data_ptr() for s in scratch),
                                    b, h, w, iters, l_t, theta, taut, stream)
    if err != 0:
        raise RuntimeError(f"aip_tvl1_inner failed to launch: CUDA error {err}")
    tvl1_inner.launches += iters
    return outs[0], outs[1], tuple(outs[2:])


tvl1_inner.launches = 0


def reset_launch_counts() -> None:
    tvl1_inner.launches = 0


def launch_counts() -> dict[str, int]:
    return {"tvl1": tvl1_inner.launches}
