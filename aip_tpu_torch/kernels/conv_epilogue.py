"""The conv epilogue between the VGG encoder's and the decoder's 3x3 convs:
wrapper and plain version.

``csrc/conv_epilogue.cu`` replaces no Pallas kernel (the JAX package
leaves this chain to XLA's fusion). It takes a raw conv output [N, H, W, C]
(NHWC-contiguous, bias not added) and, in one pass, adds the bias, applies
ReLU, then a 2x2 ceil-mode max pool or a nearest 2x upsample, then writes
the 1-pixel reflection border: [N, Ho+2, Wo+2, C], NHWC-contiguous, the next
``F.conv2d(..., padding=0)``'s input as a channels_last view. Without the
border it writes [N, Ho, Wo, C]. It is forward-only: the model walks call it
only where autograd records nothing.

* ``conv_epilogue``: for a CUDA tensor the kernel (bf16 only: the walks
  send fp32 to the op chain, and any other dtype raises), for a CPU tensor
  the plain version. ``launch_counts()`` counts its launches.
* ``conv_epilogue_reference``: the plain version, the kernel's arithmetic
  and per-pixel index maps in PyTorch ops. The bias is added in fp32 and
  rounded to the dtype once, where PyTorch's own add of a conv bias rounds;
  ReLU, max and copies are exact, so it equals the op chain bit for bit.
* ``conv_epilogue_chain``: the op chain itself (add, ReLU,
  ``max_pool2d(ceil_mode=True)`` or nearest ``interpolate``, reflect
  ``F.pad``), differentiable: the walks' route where autograd records.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from aip_tpu_torch.kernels._build import (add_count, bind, check, launch, read_counts,
                                           reset_counts)

RESAMPLE = {None: 0, "pool": 1, "up": 2}


@functools.cache
def _lib() -> ctypes.CDLL:
    return bind("conv_epilogue",
                aip_conv_epilogue=[ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p])


def output_size(h: int, w: int, resample=None) -> tuple[int, int]:
    """(Ho, Wo) of ``resample`` on an H x W map, before the border."""
    if resample == "pool":
        return (h + 1) // 2, (w + 1) // 2
    if resample == "up":
        return 2 * h, 2 * w
    return h, w


def _check(raw, bias, resample, border):
    if raw.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"raw: the epilogue takes float32 or bfloat16, got {raw.dtype}")
    if raw.ndim != 4 or min(raw.shape) < 1:
        raise ValueError(f"raw must be a non-empty [N, H, W, C], got {tuple(raw.shape)}")
    if resample not in RESAMPLE:
        raise ValueError(f"resample must be one of {list(RESAMPLE)}, got {resample!r}")
    if bias is not None and (bias.dtype != torch.float32 or tuple(bias.shape) != raw.shape[-1:]):
        raise ValueError(f"bias must be float32 [{raw.shape[-1]}], got {bias.dtype} "
                         f"{tuple(bias.shape)}")
    ho, wo = output_size(raw.shape[1], raw.shape[2], resample)
    if border and (ho < 2 or wo < 2):
        raise ValueError(f"a reflection border needs a map of at least 2x2, got {ho}x{wo}")
    return ho, wo


def _reflect(n: int, device) -> torch.Tensor:
    """The kernel's source index of each of n + 2 bordered positions."""
    i = torch.arange(-1, n + 1, device=device)
    return torch.where(i < 0, -i, torch.where(i >= n, 2 * n - 2 - i, i))


def _sources(n: int, n_out: int, resample, border: bool, device) -> list[torch.Tensor]:
    """Per output position along one axis, its source indices in the input:
    two for a pool window (the second clamped to the edge: a repeated
    candidate leaves the max as it is), one otherwise."""
    pos = _reflect(n_out, device) if border else torch.arange(n_out, device=device)
    if resample == "pool":
        return [2 * pos, torch.clamp(2 * pos + 1, max=n - 1)]
    return [pos // 2] if resample == "up" else [pos]


def conv_epilogue_reference(raw, bias=None, relu=False, resample=None, border=True):
    """The plain version of ``conv_epilogue`` (same arguments, same result)."""
    ho, wo = _check(raw, bias, resample, border)
    y = raw
    if bias is not None:
        y = (y.float() + bias).to(raw.dtype)
    if relu:
        y = torch.relu(y)
    out = None
    for rows in _sources(raw.shape[1], ho, resample, border, raw.device):
        for cols in _sources(raw.shape[2], wo, resample, border, raw.device):
            g = y.index_select(1, rows).index_select(2, cols)
            out = g if out is None else torch.maximum(out, g)
    return out.contiguous()


def conv_epilogue_chain(raw, bias=None, relu=False, resample=None, border=True):
    """The PyTorch op chain that ``conv_epilogue`` replaces (same
    arguments and values), with a backward: on the NHWC ``raw`` in its own
    memory layout, the bias added in raw's dtype, ReLU, ceil-mode max pool
    or nearest upsample, reflect pad. Returns an NHWC view."""
    t = raw.permute(0, 3, 1, 2)
    if bias is not None:
        t = t + bias.to(raw.dtype)[:, None, None]
    if relu:
        t = torch.relu(t)
    if resample == "pool":
        t = F.max_pool2d(t, 2, 2, ceil_mode=True)
    elif resample == "up":
        t = F.interpolate(t, scale_factor=2, mode="nearest")
    if border:
        t = F.pad(t, (1, 1, 1, 1), mode="reflect")
    return t.permute(0, 2, 3, 1)


def _conv_epilogue_cuda(raw, bias, relu, resample, border):
    ho, wo = _check(raw, bias, resample, border)
    check(raw, "raw", torch.bfloat16, 4)
    if bias is not None:
        check(bias, "bias", torch.float32, 1, raw.device)
    n, h, w, c = raw.shape
    pad = 2 if border else 0
    out = torch.empty((n, ho + pad, wo + pad, c), dtype=raw.dtype, device=raw.device)
    launch(_lib().aip_conv_epilogue, raw.device, raw, bias, out, n, h, w, c, int(relu),
           RESAMPLE[resample], int(border))
    add_count("conv_epilogue")
    return out


def conv_epilogue(raw, bias=None, relu=False, resample=None, border=True):
    """Bias, ReLU, pool or upsample and the reflection border of a raw conv
    output, in one pass. raw: [N, H, W, C], the conv's output without its
    bias, bf16 (on the CPU fp32 too); bias: fp32 [C] or None, the value the
    network adds (rounded to bf16 first in a bf16 network); resample: None,
    "pool" (2x2, ceil mode) or "up" (nearest 2x); border: write the 1-pixel
    reflection border (the map after resampling at least 2x2). Returns
    [N, Ho(+2), Wo(+2), C] NHWC-contiguous in raw's dtype. No backward:
    raises where autograd would record the call."""
    if torch.is_grad_enabled() and (raw.requires_grad
                                    or (bias is not None and bias.requires_grad)):
        raise ValueError("conv_epilogue has no backward; call it where autograd records "
                         "nothing")
    if raw.device.type == "cpu":
        return conv_epilogue_reference(raw, bias, relu, resample, border)
    return _conv_epilogue_cuda(raw, bias, relu, resample, border)


def reset_launch_counts() -> None:
    reset_counts("conv_epilogue")


def launch_counts() -> dict[str, int]:
    return read_counts("conv_epilogue")
