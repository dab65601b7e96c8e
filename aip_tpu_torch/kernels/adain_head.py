"""Fused AdaIN encoder head and decoder tail: wrappers, plain versions, VJPs.

Port of ``aip_tpu/ops/pallas/adain_head.py``. Two routes of CUDA kernels,
chosen by the input's dtype (the header notes say what bounds each on the
H100 and how it is laid out):

* bf16: ``csrc/adain_head_tc.cu``, tensor-core implicit GEMMs with the
  TPU kernel's bf16 rounding points, on weights packed once and cached
  (``packed_weights``);
* fp32: ``csrc/adain_head.cu``, tensor-core implicit GEMMs with three TF32
  products a multiply-add (fp32-accurate), on weights split into TF32 hi
  and lo parts on the host, packed once and cached (``packed_weights``).

Here:

* ``encode_head`` / ``decode_tail``: ``torch.autograd.Function``s. For a
  CUDA tensor the forward launches the kernel of its dtype's route (any
  other dtype raises); for a CPU tensor it runs the plain version of that
  route. The backward recomputes through ``encode_head_reference`` /
  ``decode_tail_reference``, as the JAX custom VJPs recompute through the
  XLA layer chain (models/vgg.py:175, models/decoder.py:114).
* ``encode_head_reference`` / ``decode_tail_reference``: the layer chain in
  PyTorch ops, equal to ``_head_xla`` (models/vgg.py:143) and ``_tail_xla``
  (models/decoder.py:79); the fp32 kernels' plain versions.
* ``encode_head_bf16_reference`` / ``decode_tail_bf16_reference``: fp32
  convs on bf16-rounded inputs and weights, rounded where
  ``encode_head_pallas`` / ``decode_tail_pallas`` round in bf16; the
  bf16 kernels' plain versions.
* ``fold_rgb_conv``: folds the 1x1 RGB conv into the 3->64 conv.
* ``tf32_round``: fp32 rounded to TF32 as ``cvt.rna.tf32.f32`` rounds.

Tensors are NHWC; conv weights are OIHW (``nn.Conv2d`` layout).
``launch_counts()`` counts each wrapper's kernel launches and
``route_launch_counts()`` each route's.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch
import torch.nn.functional as F

from aip_tpu_torch.kernels._build import (add_count, bind, check, launch, read_counts,
                                           reset_counts)

# Input, four packed weight arrays, output; B, H, W; the stream.
_SIGNATURE = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_NAMES = ("encode_head", "decode_tail")
_ROUTES = ("bf16", "fp32")


@functools.cache
def _lib() -> ctypes.CDLL:
    return bind("adain_head", aip_encode_head=_SIGNATURE, aip_decode_tail=_SIGNATURE)


@functools.cache
def _lib_tc() -> ctypes.CDLL:
    return bind("adain_head_tc", aip_encode_head_tc=_SIGNATURE, aip_decode_tail_tc=_SIGNATURE)


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


def _bf16(t):
    """t rounded to bf16, as fp32."""
    return t.to(torch.bfloat16).float()


def _fold_bf16(w0, b0, w1, b1):
    """The folded conv1 in bf16 (models/vgg.py folds in the compute dtype):
    the fold of the bf16-rounded weights, computed in fp32 and rounded to
    bf16."""
    w_eff, b_eff = fold_rgb_conv(_bf16(w0), _bf16(b0), _bf16(w1), _bf16(b1))
    return _bf16(w_eff), _bf16(b_eff)


def encode_head_bf16_reference(x, w0, b0, w1, b1, w2, b2):
    """The head with ``encode_head_pallas``'s bf16 rounding points: fp32
    convs on bf16-rounded x and weights (conv1 folded, then rounded), fp32
    biases, relu1_1 rounded to bf16, the result in x's dtype (rounded to
    bf16 only when x is bf16)."""
    w_eff, b_eff = _fold_bf16(w0, b0, w1, b1)
    h = _bf16(x).permute(0, 3, 1, 2)
    h = _bf16(torch.relu(F.conv2d(_reflect(h), w_eff, b_eff)))
    h = torch.relu(F.conv2d(_reflect(h), _bf16(w2), b2.float()))
    return F.max_pool2d(h, 2, 2, ceil_mode=True).permute(0, 2, 3, 1).to(x.dtype)


def decode_tail_bf16_reference(y, w2, b2, w1, b1):
    """The tail with ``decode_tail_pallas``'s bf16 rounding points: fp32
    convs on bf16-rounded y and weights, fp32 biases, relu(z) rounded to
    bf16, the result in y's dtype (rounded to bf16 only when y is bf16)."""
    u = F.interpolate(_bf16(y).permute(0, 3, 1, 2), scale_factor=2, mode="nearest")
    z = _bf16(torch.relu(F.conv2d(_reflect(u), _bf16(w2), b2.float())))
    return F.conv2d(_reflect(z), _bf16(w1), b1.float()).permute(0, 2, 3, 1).to(y.dtype)


# ---------------------------------------------------------------------------
# Weights packed for the tensor-core kernels (plain torch, any device)
# ---------------------------------------------------------------------------

def _b_fragments(wk):
    """[N, K] -> [K/16, N/8, 32, 4] bf16: the B operand of mma.m16n8k16 in
    the order each lane holds it. Lane l of n-tile j at k-step s holds
    column n = 8j + l//4 at rows k = 16s + 2(l%4) + (0, 1, 8, 9)."""
    lane = torch.arange(32, device=wk.device)
    kofs = 2 * (lane % 4)[:, None] + torch.tensor([0, 1, 8, 9], device=wk.device)
    n = (8 * torch.arange(wk.shape[0] // 8, device=wk.device)[None, :, None, None]
         + (lane // 4)[None, None, :, None])
    k = 16 * torch.arange(wk.shape[1] // 16, device=wk.device)[:, None, None, None] + kofs
    return wk.to(torch.bfloat16)[n, k].contiguous()


def _pack_w2(w2):
    """OIHW [64,64,3,3] -> bf16 [9 taps][64 out][8 chunks][8 in]: the 64->64
    conv's B operand in its shared-memory order, input-channel chunk c of
    output n stored at position c ^ (n % 8): per tap a K-major 64x64 tile in
    the 128-byte swizzle that wgmma's descriptor reads."""
    w = w2.to(torch.bfloat16).permute(2, 3, 0, 1).reshape(9, 64, 8, 8)
    n = torch.arange(64, device=w2.device)[:, None]
    return w[:, n, torch.arange(8, device=w2.device)[None, :] ^ (n % 8)].contiguous()


def pack_encode_head(w0, b0, w1, b1, w2, b2):
    """(conv1 B fragments [2,8,32,4] bf16 of the folded weights, k = (dy*3
    + dx)*3 + ci padded 27 -> 32; folded bias [64] fp32; w2 packed; b2 [64]
    fp32)."""
    w_eff, b_eff = _fold_bf16(w0, b0, w1, b1)
    wk = F.pad(w_eff.permute(0, 2, 3, 1).reshape(64, 27), (0, 5))
    return _b_fragments(wk), b_eff.contiguous(), _pack_w2(w2), b2.float().contiguous()


def pack_decode_tail(w2, b2, w1, b1):
    """(w2 packed; b2 [64] fp32; the 64->3 conv's B fragments [36,1,32,4]
    bf16, k = (dy*3 + dx)*64 + ci, outputs padded 3 -> 8; b1 [3] fp32)."""
    wk = F.pad(w1.permute(0, 2, 3, 1).reshape(3, 576), (0, 0, 0, 5))
    return _pack_w2(w2), b2.float().contiguous(), _b_fragments(wk), b1.float().contiguous()


def tf32_round(t):
    """fp32 ``t`` rounded to TF32 (10 mantissa bits), half away from zero,
    as ``cvt.rna.tf32.f32`` rounds: integer operations on the bits, so the
    result is the same on every device. Returns fp32."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _pack_w2_fp32(w2):
    """OIHW [64,64,3,3] -> fp32 [9 taps][hi, lo][2 K-blocks][64 out][8
    chunks][4 in]: w2 split into TF32 parts, hi = tf32(w), lo = tf32(w -
    hi); per tap, part and 32 input channels a K-major 64x32 B tile, the
    chunk c of output n stored at position c ^ (n % 8) (the 128-byte swizzle
    wgmma's descriptor reads); 32 KB a tap."""
    w = w2.float().permute(2, 3, 0, 1).reshape(9, 64, 2, 8, 4).permute(0, 2, 1, 3, 4)
    hi = tf32_round(w)
    lo = tf32_round(w - hi)
    n = torch.arange(64, device=w2.device)[:, None]
    c = torch.arange(8, device=w2.device)[None, :] ^ (n % 8)
    return torch.stack([hi[:, :, n, c], lo[:, :, n, c]], 1).contiguous()


def _tf32_b_fragments(wk):
    """[64 N, 32 K] fp32 -> [4 k-steps, 8 n-tiles, 32 lanes, 4]: the B operand
    of mma.m16n8k8.tf32 split into TF32 parts, lane l of n-tile j at k-step s
    holding (hi b0, hi b1, lo b0, lo b1), b0 at row k = 8s + l%4 and b1 at
    k = 8s + l%4 + 4, both in column n = 8j + l//4."""
    lane = torch.arange(32, device=wk.device)
    n = 8 * torch.arange(8, device=wk.device)[None, :, None] + (lane // 4)[None, None, :]
    k = 8 * torch.arange(4, device=wk.device)[:, None, None] + (lane % 4)[None, None, :]
    hi = tf32_round(wk)
    lo = tf32_round(wk - hi)
    return torch.stack([hi[n, k], hi[n, k + 4], lo[n, k], lo[n, k + 4]], -1).contiguous()


def pack_encode_head_fp32(w0, b0, w1, b1, w2, b2):
    """(conv1's B fragments [4,8,32,4] of the folded weights, k = (dy*3 +
    dx)*3 + ci padded 27 -> 32; folded bias [64]; w2 packed by
    ``_pack_w2_fp32``; b2 [64]), folded in fp32."""
    w_eff, b_eff = fold_rgb_conv(w0.float(), b0.float(), w1.float(), b1.float())
    wk = F.pad(w_eff.permute(0, 2, 3, 1).reshape(64, 27), (0, 5))
    return (_tf32_b_fragments(wk), b_eff.contiguous(), _pack_w2_fp32(w2),
            b2.float().contiguous())


def pack_decode_tail_fp32(w2, b2, w1, b1):
    """(w2 packed; b2 [64]; the 64->3 conv as fp32 [9 taps][16 chunks of 4
    in][3 out][4 in]; b1 padded to [4])."""
    w1p = w1.float().permute(2, 3, 1, 0).reshape(9, 16, 4, 3).permute(0, 1, 3, 2)
    return (_pack_w2_fp32(w2), b2.float().contiguous(), w1p.contiguous(),
            F.pad(b1.float(), (0, 1)).contiguous())


_PACKERS = {"encode_head": pack_encode_head, "decode_tail": pack_decode_tail,
            "encode_head_fp32": pack_encode_head_fp32, "decode_tail_fp32": pack_decode_tail_fp32}
_packed: collections.OrderedDict = collections.OrderedDict()
_PACKED_MAX = 8


def packed_weights(kind, *weights):
    """``_PACKERS[kind](*weights)``, packed once per state of the weights.
    The key holds each weight's data_ptr, _version, shape, dtype and
    device, so an in-place update repacks and an unchanged module does not.
    An entry holds its weights, so their memory cannot be reused under the
    same key while it is cached; the newest ``_PACKED_MAX`` entries stay."""
    key = (kind,) + tuple((t.data_ptr(), t._version, tuple(t.shape), t.dtype, t.device)
                          for t in weights)
    hit = _packed.get(key)
    if hit is not None:
        _packed.move_to_end(key)
        return hit[1]
    with torch.no_grad():
        packed = _PACKERS[kind](*(t.detach() for t in weights))
    _packed[key] = (weights, packed)
    if len(_packed) > _PACKED_MAX:
        _packed.popitem(last=False)
    return packed


# ---------------------------------------------------------------------------
# Kernel launches (CUDA tensors only)
# ---------------------------------------------------------------------------

def _check_weights(device, **shapes):
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, the input on {device}")


def _launch(name, x, out, weights):
    """One launch of ``name``'s kernel of x's route on the weights packed
    for it; counted under the name and the route."""
    if x.dtype == torch.bfloat16:
        route, fn, kind = "bf16", getattr(_lib_tc(), f"aip_{name}_tc"), name
    else:
        route, fn, kind = "fp32", getattr(_lib(), f"aip_{name}"), f"{name}_fp32"
    launch(fn, x.device, x, *packed_weights(kind, *weights), out, *x.shape[:3])
    add_count(f"{name}.{route}")
    return out


def _encode_head_cuda(x, w0, b0, w1, b1, w2, b2):
    check(x, "x", (torch.float32, torch.bfloat16), (None, None, None, 3))
    bsz, h, w, _ = x.shape
    if h < 2 or w < 2:
        raise ValueError(f"encode_head needs H, W >= 2 for reflection, got {h}x{w}")
    _check_weights(x.device, w0=(w0, (3, 3, 1, 1)), b0=(b0, (3,)),
                   w1=(w1, (64, 3, 3, 3)), b1=(b1, (64,)),
                   w2=(w2, (64, 64, 3, 3)), b2=(b2, (64,)))
    out = torch.empty((bsz, (h + 1) // 2, (w + 1) // 2, 64), dtype=x.dtype, device=x.device)
    return _launch("encode_head", x, out, (w0, b0, w1, b1, w2, b2))


def _decode_tail_cuda(y, w2, b2, w1, b1):
    check(y, "y", (torch.float32, torch.bfloat16), (None, None, None, 64))
    bsz, h, w, _ = y.shape
    if h < 1 or w < 1:
        raise ValueError(f"decode_tail needs a non-empty input, got {h}x{w}")
    _check_weights(y.device, w2=(w2, (64, 64, 3, 3)), b2=(b2, (64,)),
                   w1=(w1, (3, 64, 3, 3)), b1=(b1, (3,)))
    out = torch.empty((bsz, 2 * h, 2 * w, 3), dtype=y.dtype, device=y.device)
    return _launch("decode_tail", y, out, (w2, b2, w1, b1))


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
            plain = (encode_head_bf16_reference if x.dtype == torch.bfloat16
                     else encode_head_reference)
            return plain(x, w0, b0, w1, b1, w2, b2)
        return _encode_head_cuda(x, w0, b0, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, grad_out):
        return _recompute_grads(ctx, encode_head_reference, grad_out)


class _DecodeTail(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, w2, b2, w1, b1):
        ctx.save_for_backward(y, w2, b2, w1, b1)
        if y.device.type == "cpu":
            plain = (decode_tail_bf16_reference if y.dtype == torch.bfloat16
                     else decode_tail_reference)
            return plain(y, w2, b2, w1, b1)
        return _decode_tail_cuda(y, w2, b2, w1, b1)

    @staticmethod
    def backward(ctx, grad_out):
        return _recompute_grads(ctx, decode_tail_reference, grad_out)


def encode_head(x, w0, b0, w1, b1, w2, b2):
    """Fused encoder head (replaces ``encode_head_pallas``). x: [B,H,W,3]
    NHWC in the compute dtype (bf16: the bf16 route; fp32: the three-TF32
    route), H and W >= 2 (any parity); weights OIHW. Returns
    pooled relu1_2, [B,ceil(H/2),ceil(W/2),64], in x's dtype."""
    return _EncodeHead.apply(x, w0, b0, w1, b1, w2, b2)


def decode_tail(y, w2, b2, w1, b1):
    """Fused decoder tail (replaces ``decode_tail_pallas``). y: [B,h,w,64]
    NHWC in the compute dtype (routes as ``encode_head``); weights OIHW.
    Returns [B,2h,2w,3] in y's dtype, with no final activation."""
    return _DecodeTail.apply(y, w2, b2, w1, b1)


def reset_launch_counts() -> None:
    """Sets every count to 0, those of ``route_launch_counts`` too."""
    reset_counts(*(f"{name}.{route}" for name in _NAMES for route in _ROUTES))


def launch_counts() -> dict[str, int]:
    """Kernel launches of each wrapper, both routes."""
    routes = route_launch_counts()
    return {name: sum(routes[route][name] for route in _ROUTES) for name in _NAMES}


def route_launch_counts() -> dict[str, dict[str, int]]:
    """Launches of each route, ``{"bf16": {wrapper: n}, "fp32": {wrapper:
    n}}``: the bf16 kernels of ``csrc/adain_head_tc.cu`` and the fp32 ones
    of ``csrc/adain_head.cu``."""
    return {route: {name: read_counts(f"{name}.{route}")[f"{name}.{route}"] for name in _NAMES}
            for route in _ROUTES}
