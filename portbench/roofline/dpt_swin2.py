"""Operations and bytes of DPT-SwinV2's forward, from the configuration
(``patch_size``, ``embed_dim``, ``depths``, ``num_heads``, ``window_size``,
``mlp_ratio``, ``features``, ``head_features``, ``net_size``: the network
takes only ``net_size`` squared).

``ops`` lists, in network order, every matmul and conv the forward runs
(the patch conv; in each block the qkv Linear, ``q @ k^T``, ``attn @ v``,
the projection and the two MLP Linears; each PatchMerging's reduction;
``layer*_rn``; the fusion blocks' residual-unit and out convs; the head's
three convs) and the passes over each block's attention scores [windows,
heads, w^2, w^2] that the plain attention makes between its two products:
the logit scale, the position bias (reading its [heads, w^2, w^2] table),
the shift mask where the block is shifted (reading its [windows, w^2, w^2]
mask) and the softmax, each reading the scores and writing them once. The
position bias's MLP depends on no input and is not counted. FLOPs are 2 x
the products' multiply-adds (no LayerNorm, normalisation, softmax, GELU,
bias, add, roll or resize). Bytes are each product's or pass's float32
inputs, weights and output once. The bound is the larger of the FLOPs at
the CUDA cores' float32 peak and the bytes at the memory's: the forward
runs in fp32 with TF32 off.
"""

from __future__ import annotations

from portbench.roofline import peaks


def _stages(cfg: dict):
    """(width, grid, heads, depth) of each stage."""
    g = cfg["net_size"] // cfg["patch_size"]
    for i, (depth, heads) in enumerate(zip(cfg["depths"], cfg["num_heads"])):
        yield cfg["embed_dim"] * 2 ** i, g // 2 ** i, heads, depth


def ops(cfg: dict) -> list[tuple[str, int, int, int]]:
    """(name, multiply-adds, input elements, output elements) with weights
    counted in the inputs, for one image."""
    n, p, e = cfg["net_size"], cfg["patch_size"], cfg["embed_dim"]
    f, hf, ws = cfg["features"], cfg["head_features"], cfg["window_size"]
    g0 = n // p
    out = [("patch", g0 * g0 * e * 3 * p * p, 3 * n * n + e * 3 * p * p, g0 * g0 * e)]
    stages = list(_stages(cfg))
    for i, (c, g, heads, depth) in enumerate(stages):
        t, m, d = g * g, cfg["mlp_ratio"] * c, c // heads
        w = min(ws, g)
        nw, a = (g // w) ** 2, w * w
        s = nw * heads * a * a
        for j in range(depth):
            b = f"s{i}.b{j}"
            out += [(f"{b}.qkv", t * c * 3 * c, t * c + 3 * c * c, 3 * t * c),
                    (f"{b}.qk", nw * heads * a * a * d, 2 * t * c, s),
                    (f"{b}.scale", 0, s + heads, s),
                    (f"{b}.bias", 0, s + heads * a * a, s)]
            if j % 2 == 1 and g > w:
                out.append((f"{b}.mask", 0, s + nw * a * a, s))
            out += [(f"{b}.softmax", 0, s, s),
                    (f"{b}.av", nw * heads * a * a * d, s + t * c, t * c),
                    (f"{b}.proj", t * c * c, t * c + c * c, t * c),
                    (f"{b}.fc1", t * c * m, t * c + c * m, t * m),
                    (f"{b}.fc2", t * m * c, t * m + m * c, t * c)]
        if i < len(stages) - 1:
            q = t // 4
            out.append((f"s{i}.merge", q * 4 * c * 2 * c, t * c + 8 * c * c, q * 2 * c))

    def conv(name, cin, cout, k, in_px, out_px):
        out.append((name, out_px * cin * cout * k * k, in_px * cin + cout * cin * k * k,
                    out_px * cout))

    for k, (c, g, _h, _d) in enumerate(stages):
        conv(f"rn{k}", c, f, 3, g * g, g * g)
    for k in (3, 2, 1, 0):    # refinenet4 .. refinenet1
        g = stages[k][1]
        for u in range(2 if k == 3 else 4):
            conv(f"fuse{k}.{u}", f, f, 3, g * g, g * g)
        conv(f"fuse{k}.out", f, f, 1, 4 * g * g, 4 * g * g)
    conv("head0", f, f // 2, 3, (n // 2) ** 2, (n // 2) ** 2)
    conv("head2", f // 2, hf, 3, n * n, n * n)
    conv("head4", hf, 1, 1, n * n, n * n)
    return out


def flops(cfg: dict) -> float:
    return float(sum(2 * macs for _n, macs, _i, _o in ops(cfg)))


def nbytes(cfg: dict) -> float:
    return float(sum(4 * (i + o) for _n, _m, i, o in ops(cfg)))


def work(cfg: dict) -> dict:
    f, b = flops(cfg), nbytes(cfg)
    return {"dpt_swin2_flops": f, "dpt_swin2_bytes": b,
            "dpt_swin2_bound_s": peaks.bound_s(f, b, peaks.FP32_FLOPS)}
