"""Fused AdaIN encoder head and decoder tail: wrappers, plain versions, VJPs.

Port of ``aip_tpu/ops/pallas/adain_head.py``. The CUDA kernels are in
``aip_tpu_torch/csrc/adain_head.cu`` (its header note says what bounds them
on the H100 and how they are laid out). Here:

* ``encode_head`` / ``decode_tail``: ``torch.autograd.Function``s. For a
  CUDA tensor the forward launches the kernel (fp32 or bf16, else it
  raises); for a CPU tensor it runs the plain version. The backward
  recomputes through the plain version, as the JAX custom VJPs recompute
  through the XLA layer chain (models/vgg.py:175, models/decoder.py:114).
* ``encode_head_reference`` / ``decode_tail_reference``: the layer chain in
  PyTorch ops, equal to ``_head_xla`` (models/vgg.py:143) and ``_tail_xla``
  (models/decoder.py:79).
* ``fold_rgb_conv``: folds the 1x1 RGB conv into the 3->64 conv.

Tensors are NHWC; conv weights are OIHW (``nn.Conv2d`` layout).
Each wrapper counts its kernel launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from aip_tpu_torch.kernels._build import library

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = library("adain_head")
    for fn in (lib.aip_encode_head, lib.aip_decode_tail):
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------------------
# Plain versions (the CPU path, and what the kernels are held against)
# ---------------------------------------------------------------------------

def _conv(x, w, b):
    """VALID conv of an NCHW view with OIHW weights, in x's dtype."""
    return F.conv2d(x, w.to(x.dtype), b.to(x.dtype))


def _reflect(x):
    return F.pad(x, (1, 1, 1, 1), mode="reflect")


def encode_head_reference(x, w0, b0, w1, b1, w2, b2):
    """[B,H,W,3] -> [B,ceil(H/2),ceil(W/2),64] in x's dtype: conv 1x1 ->
    reflect-pad -> conv 3->64 -> ReLU -> reflect-pad -> conv 64->64 -> ReLU
    -> 2x2 ceil-mode max pool."""
    h = _conv(x.permute(0, 3, 1, 2), w0, b0)
    h = torch.relu(_conv(_reflect(h), w1, b1))
    h = torch.relu(_conv(_reflect(h), w2, b2))
    return F.max_pool2d(h, 2, 2, ceil_mode=True).permute(0, 2, 3, 1)


def decode_tail_reference(y, w2, b2, w1, b1):
    """[B,h,w,64] -> [B,2h,2w,3] in y's dtype: nearest up2x -> reflect-pad
    -> conv 64->64 -> ReLU -> reflect-pad -> conv 64->3."""
    u = F.interpolate(y.permute(0, 3, 1, 2), scale_factor=2, mode="nearest")
    z = torch.relu(_conv(_reflect(u), w2, b2))
    return _conv(_reflect(z), w1, b1).permute(0, 2, 3, 1)


def fold_rgb_conv(w0, b0, w1, b1):
    """Fold the 1x1 RGB conv (OIHW [3,3,1,1]) into the 3->64 conv (OIHW
    [64,3,3,3]); the pointwise product commutes with reflection padding.
    Returns (OIHW [64,3,3,3], [64])."""
    m0 = w0[:, :, 0, 0]                                  # [j (out), i (in)]
    w_eff = torch.einsum("kjhw,ji->kihw", w1, m0)
    b_eff = b1 + torch.einsum("kjhw,j->k", w1, b0)
    return w_eff, b_eff


# ---------------------------------------------------------------------------
# Kernel launches (CUDA tensors only)
# ---------------------------------------------------------------------------

def _check_input(t, name, channels):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: the kernel takes float32 or bfloat16, got {t.dtype}")
    if t.ndim != 4 or t.shape[-1] != channels:
        raise ValueError(f"{name} must be [B, H, W, {channels}], got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous NHWC")
    if t.shape[0] > 65535:
        raise ValueError(f"{name}: batch {t.shape[0]} exceeds the grid's 65535")


def _check_weights(device, **shapes):
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, the input on {device}")


def _weight(t, dtype):
    """Weights in the compute dtype's precision, handed to the kernel as fp32."""
    return t.detach().to(dtype).float()


def _launch(fn, x, out, args, sizes):
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), *(a.data_ptr() for a in args), out.data_ptr(),
                 *sizes, _DTYPE_CODE[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed to launch: CUDA error {err}")


def _encode_head_cuda(x, w0, b0, w1, b1, w2, b2):
    _check_input(x, "x", 3)
    bsz, h, w, _ = x.shape
    if h < 2 or w < 2:
        raise ValueError(f"encode_head needs H, W >= 2 for reflection, got {h}x{w}")
    _check_weights(x.device, w0=(w0, (3, 3, 1, 1)), b0=(b0, (3,)),
                   w1=(w1, (64, 3, 3, 3)), b1=(b1, (64,)),
                   w2=(w2, (64, 64, 3, 3)), b2=(b2, (64,)))
    cd = x.dtype
    w_eff, b_eff = fold_rgb_conv(_weight(w0, cd), _weight(b0, cd),
                                 _weight(w1, cd), _weight(b1, cd))
    args = (w_eff.permute(2, 3, 1, 0).contiguous(), b_eff.contiguous(),
            _weight(w2, cd).permute(2, 3, 1, 0).contiguous(), _weight(b2, cd))
    out = torch.empty((bsz, (h + 1) // 2, (w + 1) // 2, 64), dtype=cd, device=x.device)
    _launch(_lib().aip_encode_head, x, out, args, (bsz, h, w))
    encode_head.launches += 1
    return out


def _decode_tail_cuda(y, w2, b2, w1, b1):
    _check_input(y, "y", 64)
    bsz, h, w, _ = y.shape
    if h < 1 or w < 1:
        raise ValueError(f"decode_tail needs a non-empty input, got {h}x{w}")
    _check_weights(y.device, w2=(w2, (64, 64, 3, 3)), b2=(b2, (64,)),
                   w1=(w1, (3, 64, 3, 3)), b1=(b1, (3,)))
    cd = y.dtype
    args = (_weight(w2, cd).permute(2, 3, 1, 0).contiguous(), _weight(b2, cd),
            F.pad(_weight(w1, cd).permute(2, 3, 1, 0), (0, 1)).contiguous(),
            F.pad(_weight(b1, cd), (0, 1)))
    out = torch.empty((bsz, 2 * h, 2 * w, 3), dtype=cd, device=y.device)
    _launch(_lib().aip_decode_tail, y, out, args, (bsz, h, w))
    decode_tail.launches += 1
    return out


# ---------------------------------------------------------------------------
# Autograd wrappers
# ---------------------------------------------------------------------------

def _recompute_grads(ctx, plain, grad_out):
    """Gradients of ``plain`` at the saved inputs, for those that need one."""
    need = [i for i, n in enumerate(ctx.needs_input_grad) if n]
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(i in need)
                  for i, t in enumerate(ctx.saved_tensors)]
        out = plain(*leaves)
        grads = torch.autograd.grad(out, [leaves[i] for i in need], grad_out)
    result = [None] * len(leaves)
    for i, g in zip(need, grads):
        result[i] = g
    return tuple(result)


class _EncodeHead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w0, b0, w1, b1, w2, b2):
        ctx.save_for_backward(x, w0, b0, w1, b1, w2, b2)
        if x.device.type == "cpu":
            return encode_head_reference(x, w0, b0, w1, b1, w2, b2)
        return _encode_head_cuda(x, w0, b0, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, grad_out):
        return _recompute_grads(ctx, encode_head_reference, grad_out)


class _DecodeTail(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, w2, b2, w1, b1):
        ctx.save_for_backward(y, w2, b2, w1, b1)
        if y.device.type == "cpu":
            return decode_tail_reference(y, w2, b2, w1, b1)
        return _decode_tail_cuda(y, w2, b2, w1, b1)

    @staticmethod
    def backward(ctx, grad_out):
        return _recompute_grads(ctx, decode_tail_reference, grad_out)


def encode_head(x, w0, b0, w1, b1, w2, b2):
    """Fused encoder head (replaces ``encode_head_pallas``). x: [B,H,W,3]
    NHWC in the compute dtype, H and W >= 2 (any parity); weights OIHW.
    Returns pooled relu1_2, [B,ceil(H/2),ceil(W/2),64], in x's dtype."""
    return _EncodeHead.apply(x, w0, b0, w1, b1, w2, b2)


def decode_tail(y, w2, b2, w1, b1):
    """Fused decoder tail (replaces ``decode_tail_pallas``). y: [B,h,w,64]
    NHWC in the compute dtype; weights OIHW. Returns [B,2h,2w,3] in y's
    dtype, with no final activation."""
    return _DecodeTail.apply(y, w2, b2, w1, b1)


encode_head.launches = 0
decode_tail.launches = 0


def reset_launch_counts() -> None:
    encode_head.launches = 0
    decode_tail.launches = 0


def launch_counts() -> dict[str, int]:
    return {"encode_head": encode_head.launches, "decode_tail": decode_tail.launches}
