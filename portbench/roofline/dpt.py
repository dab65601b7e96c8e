"""Operations and bytes of DPT's forward, from the configuration
(``patch_size``, ``hidden_size``, ``num_hidden_layers``, ``hooks``,
``intermediate_size``, ``reassemble_widths``, ``features``,
``head_features``) and the network's input size (after the transform).

``ops`` lists every matmul and conv as the forward runs it: the patch
conv; in each block up to the last hook the qkv, ``q @ k^T``,
``attn @ v``, projection and the two MLP Linears; each hook's readout
Linear, 1x1 conv and resampling (transposed convs counted at their input
pixels x kernel taps); ``layer*_rn``; the fusion blocks' residual-unit
and out convs; the head's three convs. FLOPs are 2 x their multiply-adds
(no LayerNorm, softmax, GELU, bias, add or resize). Bytes are each one's
float32 inputs, weights and output once. The bound is the larger of the
FLOPs at the CUDA cores' float32 peak and the bytes at the memory's: the
forward runs in fp32 with TF32 off.
"""

from __future__ import annotations

from portbench.roofline import peaks


def ops(cfg: dict, h: int, w: int) -> list[tuple[str, int, int, int]]:
    """(name, multiply-adds, input elements, output elements) with weights
    counted in the inputs, in network order, for one [h, w] image."""
    c, m, f = cfg["hidden_size"], cfg["intermediate_size"], cfg["features"]
    p, widths, hf = cfg["patch_size"], cfg["reassemble_widths"], cfg["head_features"]
    gh, gw = h // p, w // p
    g = gh * gw
    t = 1 + g
    out = [("patch", g * c * 3 * p * p, 3 * h * w + c * 3 * p * p, g * c)]
    d = c // cfg["num_attention_heads"]
    heads = cfg["num_attention_heads"]
    for i in range(max(cfg["hooks"]) + 1):
        out += [(f"b{i}.qkv", t * c * 3 * c, t * c + 3 * c * c, 3 * t * c),
                (f"b{i}.qk", heads * t * t * d, 2 * t * c, heads * t * t),
                (f"b{i}.av", heads * t * t * d, heads * t * t + t * c, t * c),
                (f"b{i}.proj", t * c * c, t * c + c * c, t * c),
                (f"b{i}.fc1", t * c * m, t * c + c * m, t * m),
                (f"b{i}.fc2", t * m * c, t * m + m * c, t * c)]

    def conv(name, cin, cout, k, in_px, out_px):
        out.append((name, out_px * cin * cout * k * k, in_px * cin + cout * cin * k * k,
                    out_px * cout))

    res = [(4 * gh, 4 * gw), (2 * gh, 2 * gw), (gh, gw), ((gh + 1) // 2, (gw + 1) // 2)]
    for k, wk in enumerate(widths):
        out.append((f"r{k}.readout", g * 2 * c * c, g * 2 * c + 2 * c * c, g * c))
        conv(f"r{k}.1x1", c, wk, 1, g, g)
        rh, rw = res[k]
        if k in (0, 1):     # transposed: each input pixel feeds k x k outputs
            s = 4 if k == 0 else 2
            out.append((f"r{k}.up", g * wk * wk * s * s, g * wk + wk * wk * s * s, rh * rw * wk))
        elif k == 3:
            conv(f"r{k}.down", wk, wk, 3, g, rh * rw)
        conv(f"rn{k}", wk, f, 3, rh * rw, rh * rw)
    for k in (3, 2, 1, 0):    # refinenet4 .. refinenet1
        rh, rw = res[k]
        units = 2 if k == 3 else 4
        for u in range(units):
            conv(f"fuse{k}.{u}", f, f, 3, rh * rw, rh * rw)
        conv(f"fuse{k}.out", f, f, 1, 4 * rh * rw, 4 * rh * rw)
    hh, hw = 8 * gh, 8 * gw
    conv("head0", f, f // 2, 3, hh * hw, hh * hw)
    conv("head2", f // 2, hf, 3, h * w, h * w)
    conv("head4", hf, 1, 1, h * w, h * w)
    return out


def flops(cfg: dict, h: int, w: int) -> float:
    return float(sum(2 * macs for _n, macs, _i, _o in ops(cfg, h, w)))


def nbytes(cfg: dict, h: int, w: int) -> float:
    return float(sum(4 * (i + o) for _n, _m, i, o in ops(cfg, h, w)))


def work(cfg: dict, h: int, w: int) -> dict:
    f, b = flops(cfg, h, w), nbytes(cfg, h, w)
    return {"dpt_flops": f, "dpt_bytes": b, "dpt_bound_s": peaks.bound_s(f, b, peaks.FP32_FLOPS)}
