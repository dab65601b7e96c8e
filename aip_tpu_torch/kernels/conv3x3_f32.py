"""The fp32 3x3 conv of the VGG and decoder walks: wrapper, weight pack,
tile choice and plain version.

``csrc/conv3x3_f32.cu`` replaces no Pallas kernel (the JAX package leaves
these convs to XLA). It computes an unpadded 3x3 conv of an fp32 NHWC
input that carries its reflection border, [N, H+2, W+2, Cin] ->
[N, H, W, Cout] without the bias, with three TF32 products a multiply-add
on the tensor cores (fp32-accurate), for Cin and Cout multiples of 64. The
walks' op chain (``conv_epilogue_chain``) then adds the bias, ReLU, pool
or upsample and the next border. It is forward-only: the walks call it only
where autograd records nothing (``models.vgg.takes_f32_kernel``).

* ``conv3x3_f32``: for a CUDA tensor the kernel, for a CPU tensor the plain
  version. ``launch_counts()`` counts its launches.
* ``conv3x3_f32_reference``: the plain version, the ``F.conv2d`` call the
  walks made before the kernel, on the same tensors (so the CPU's numbers
  are those of that call, bit for bit).
* ``pack_weights``: OIHW weights split into TF32 hi and lo parts in the
  order the kernel streams them; the walks cache one pack a module
  (``models.vgg.conv_pack``).
* ``tile_rows``: the tile the kernel takes for a shape.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from aip_tpu_torch.kernels._build import (add_count, bind, check, launch, read_counts,
                                           reset_counts)
from aip_tpu_torch.kernels.adain_head import tf32_round

# x, packed weights, out; B, H, W, Cin, Cout, m64 tiles a warpgroup; the stream.
_SIGNATURE = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


@functools.cache
def _lib() -> ctypes.CDLL:
    return bind("conv3x3_f32", aip_conv3x3_f32=_SIGNATURE)


def takes(cin: int, cout: int) -> bool:
    """Whether the kernel computes a conv of these widths."""
    return cin > 0 and cout > 0 and cin % 64 == 0 and cout % 64 == 0


def pack_weights(weight: torch.Tensor) -> torch.Tensor:
    """OIHW [Cout, Cin, 3, 3] -> fp32 [Cout/64][Cin/64][9 taps][2 halves of
    32 input channels][hi, lo][64 out][8 chunks][4 in]: the weights split
    into TF32 parts, hi = tf32(w), lo = tf32(w - hi); per (Cout slice, Cin
    chunk, tap, half) and part a K-major 64 x 32 tile, the chunk c of output
    n stored at position c ^ (n % 8) (the 128-byte swizzle wgmma's
    descriptor reads); 16 KB a (tap, half)."""
    cout, cin = weight.shape[:2]
    w = weight.float().permute(2, 3, 0, 1).reshape(9, cout // 64, 64, cin // 64, 2, 8, 4)
    w = w.permute(1, 3, 0, 4, 2, 5, 6)                  # [slice, chunk, tap, half, out, c, 4]
    hi = tf32_round(w)
    lo = tf32_round(w - hi)
    n = torch.arange(64, device=weight.device)[:, None]
    c = torch.arange(8, device=weight.device)[None, :] ^ (n % 8)
    return torch.stack([hi[..., n, c, :], lo[..., n, c, :]], 4).contiguous()


# A 128-pixel item's time over a 256-pixel one's of the same Cin, 0.61-0.64
# on an H100 (scripts/bench_conv3x3_f32.py): the smaller tile reads its
# weights for half the pixels.
_SMALL_TILE_COST = 0.64


def tile_rows(b: int, h: int, w: int, cout: int, sms: int) -> int:
    """The kernel's tile height for an output of b x h x w x cout on a card
    of ``sms`` SMs: 16 rows (256 pixels a block), or 8 (128 pixels) where
    the finer grid's waves of items over the SMs take less time, as for
    small grids at batch 1."""
    def waves(rows):
        items = b * -(-h // rows) * -(-w // 16) * (cout // 64)
        return -(-items // sms)

    return 8 if waves(8) * _SMALL_TILE_COST < waves(16) else 16


def conv3x3_f32_reference(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The plain version: ``F.conv2d`` of the NHWC ``x`` (bordered) with
    the OIHW ``weight`` in x's dtype, no bias, as an NHWC view."""
    return F.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype)).permute(0, 2, 3, 1)


def _conv3x3_f32_cuda(x, weight, packed):
    check(x, "x", torch.float32, 4, align=16)
    bsz, hb, wb, cin = x.shape
    cout = weight.shape[0]
    if tuple(weight.shape) != (cout, cin, 3, 3) or not takes(cin, cout):
        raise ValueError(f"the kernel takes 3x3 OIHW weights [Cout, {cin}, 3, 3] with Cin and "
                         f"Cout multiples of 64, got {tuple(weight.shape)}")
    if hb < 3 or wb < 3:
        raise ValueError(f"x must carry a 1-pixel border around at least 1x1, got {hb}x{wb}")
    if packed is None:
        packed = pack_weights(weight.detach())
    check(packed, "packed", torch.float32, (cout // 64, cin // 64, 9, 2, 2, 64, 8, 4),
          x.device, 16)
    h, w = hb - 2, wb - 2
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    out = torch.empty((bsz, h, w, cout), dtype=x.dtype, device=x.device)
    launch(_lib().aip_conv3x3_f32, x.device, x, packed, out, bsz, h, w, cin, cout,
           tile_rows(bsz, h, w, cout, sms) // 8)
    add_count("conv3x3_f32")
    return out


def conv3x3_f32(x: torch.Tensor, weight: torch.Tensor, packed=None) -> torch.Tensor:
    """The unpadded 3x3 conv of x [N, H+2, W+2, Cin] (NHWC, fp32, the input
    with its border) with the OIHW ``weight``, without bias: [N, H, W,
    Cout] NHWC. A CUDA tensor takes the kernel (on its NHWC-contiguous copy
    where x is a view; ``packed``: ``pack_weights(weight)``, packed here
    where None), a CPU tensor the plain version. No backward: raises where
    autograd would record the call."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        raise ValueError("conv3x3_f32 has no backward; call it where autograd records nothing")
    if x.device.type == "cpu":
        return conv3x3_f32_reference(x, weight)
    return _conv3x3_f32_cuda(x.contiguous(), weight, packed)


def reset_launch_counts() -> None:
    reset_counts("conv3x3_f32")


def launch_counts() -> dict[str, int]:
    return read_counts("conv3x3_f32")
