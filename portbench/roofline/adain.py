"""Operations and bytes of the AdaIN networks, from the configuration's
layer lists and the input's shape.

``conv_flops`` walks a layer list (``["pad"]``, ``["conv", cin, cout, k]``,
``["relu"]``, ``["pool"]``, ``["up"]``) from an input size and counts 2 x
the multiply-adds of every conv at its output size. ``head_work`` and
``tail_work`` are frozen copies of ``chip_smoke.py``'s ``_head_work`` and
``_tail_work``: the fused encoder head (the 1x1 RGB conv folded into the
3->64 conv, then 64->64, then the pool) and decoder tail (up 2x, 64->64,
64->3), each input read once, each output written once, fp32 weights read
once.
"""

from __future__ import annotations

import math


def conv_flops(layers, h: int, w: int, batch: int = 1) -> tuple[float, tuple[int, int]]:
    """(FLOPs, output (h, w)) of ``layers`` on a [batch, h, w, C] input."""
    flops = 0.0
    for layer in layers:
        kind = layer[0]
        if kind == "pad":
            h, w = h + 2, w + 2
        elif kind == "conv":
            _, cin, cout, k = layer
            h, w = h - k + 1, w - k + 1
            flops += 2.0 * batch * h * w * cin * cout * k * k
        elif kind == "pool":
            h, w = math.ceil(h / 2), math.ceil(w / 2)
        elif kind == "up":
            h, w = 2 * h, 2 * w
    return flops, (h, w)


def stylize_flops(cfg: dict, h: int, w: int, batch: int = 1) -> float:
    """Content encode to relu4_1 and decode, at [batch, h, w, 3]."""
    enc, (fh, fw) = conv_flops(cfg["encoder"], h, w, batch)
    dec, _ = conv_flops(cfg["decoder"], fh, fw, batch)
    return enc + dec


def encode_flops(cfg: dict, h: int, w: int, batch: int = 1) -> float:
    return conv_flops(cfg["encoder"], h, w, batch)[0]


def head_work(b: int, h: int, w: int, itemsize: int) -> tuple[float, float]:
    """(FLOPs, bytes) of the encoder head on [b, h, w, 3]."""
    flops = 2 * b * h * w * (64 * 27 + 64 * 576)
    nbytes = (b * h * w * 3 * itemsize + b * math.ceil(h / 2) * math.ceil(w / 2) * 64 * itemsize
              + 4 * (9 + 3 + 27 * 64 + 64 + 576 * 64 + 64))
    return flops, nbytes


def tail_work(b: int, h: int, w: int, itemsize: int) -> tuple[float, float]:
    """(FLOPs, bytes) of the decoder tail on [b, h, w, 64] (output 2h x 2w)."""
    flops = 2 * b * (2 * h) * (2 * w) * (64 * 576 + 3 * 576)
    nbytes = (b * h * w * 64 * itemsize + b * 4 * h * w * 3 * itemsize
              + 4 * (576 * 64 + 64 + 576 * 3 + 3))
    return flops, nbytes
