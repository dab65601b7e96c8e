"""Operations and bytes of DeepLabV3-ResNet101's forward, from the
configuration (``blocks``, ``widths``, ``expansion``, ``aspp_width``,
``num_classes``) and the input's size.

``convs`` lists every conv as the forward runs it, with its input and
output sizes. FLOPs are 2 x the multiply-adds of the convs, the ASPP's
pooling conv on its 1 x 1 map, as ``chip_smoke.py``'s ``_deeplab_flops``
counts them (no BatchNorm, ReLU, pool or upsample). Bytes are each conv's
float32 input, weights and output once. The bound is the larger of the
FLOPs at the CUDA cores' float32 peak and the bytes at the memory's: the
forward runs in fp32 with TF32 off.
"""

from __future__ import annotations

from portbench.roofline import peaks

FIRST_STRIDES = (1, 2, 1, 1)   # layer3 and layer4 are dilated, not strided


def _out(n: int, stride: int) -> int:
    return (n - 1) // stride + 1


def convs(cfg: dict, h: int, w: int) -> list[tuple]:
    """(cin, cout, k, in_hw, out_hw) of every conv, in network order."""
    out = []

    def conv(cin, cout, k, hw, stride=1):
        o = (_out(hw[0], stride), _out(hw[1], stride))
        out.append((cin, cout, k, hw, o))
        return o

    stem = cfg["stem_width"]
    hw = conv(3, stem, 7, (h, w), 2)
    hw = (_out(hw[0], 2), _out(hw[1], 2))          # the 3x3/2 max pool
    cin = stem
    for n, width, stride in zip(cfg["blocks"], cfg["widths"], FIRST_STRIDES):
        cout = width * cfg["expansion"]
        for bi in range(n):
            s = stride if bi == 0 else 1
            block_in = cin if bi == 0 else cout
            conv(block_in, width, 1, hw)
            if bi == 0:
                conv(block_in, cout, 1, hw, s)
            hw2 = conv(width, width, 3, hw, s)
            conv(width, cout, 1, hw2)
            hw = hw2
        cin = cout
    a = cfg["aspp_width"]
    for k in (1,) + (3,) * len(cfg["aspp_rates"]):
        conv(cin, a, k, hw)
    conv(cin, a, 1, (1, 1))                         # the image pooling branch
    conv(a * (len(cfg["aspp_rates"]) + 2), a, 1, hw)
    conv(a, a, 3, hw)
    conv(a, cfg["num_classes"], 1, hw)
    return out


def flops(cfg: dict, h: int, w: int) -> float:
    return float(sum(2 * o[0] * o[1] * cin * cout * k * k for cin, cout, k, _i, o in convs(cfg, h, w)))


def nbytes(cfg: dict, h: int, w: int) -> float:
    return float(sum(4 * (i[0] * i[1] * cin + cin * cout * k * k + o[0] * o[1] * cout)
                     for cin, cout, k, i, o in convs(cfg, h, w)))


def work(cfg: dict, h: int, w: int) -> dict:
    f, b = flops(cfg, h, w), nbytes(cfg, h, w)
    return {"deeplab_flops": f, "deeplab_bytes": b,
            "deeplab_bound_s": peaks.bound_s(f, b, peaks.FP32_FLOPS)}
