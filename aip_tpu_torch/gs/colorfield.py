"""Neural colour field: multires hash grid + style-conditioned MLP -> SH.

Port of ``aip_tpu/gs/colorfield.py`` (reference
``scene/gaussian_model.py:74-104``, tiny-cuda-nn's HashGrid + MLP): 16
levels x 2 features over the contracted position, concatenated with the
L2-normalised style embedding, through a 64-wide two-hidden-layer ReLU MLP
to 48 outputs = deg-3 SH coefficients [16, 3] per Gaussian.

The hash is the JAX package's uint32 spatial hash (primes 1, 2654435761,
805459861, wrap-around products). Here the products are int64 and the
result is masked with ``table_size - 1``; the table size is a power of
two, so the low bits equal the wrapped uint32's. Levels whose dense grid
fits the table are indexed densely (tcnn parity).

Training: positions are stop-gradient (the renderer detaches xyz before the
encoder). Tables below 2^16 rows take PyTorch's autograd of
``hash_encode`` (the JAX package's scatter autodiff); larger ones take
``hash_encode_mxu``, whose backward is kernel C,
``kernels.hashgrad.hash_grad`` (the JAX package's ``hash_encode_mxu``
:245-352 and its Pallas one-hot-matmul kernel). ``init_colorfield`` draws
its tables and weights from a ``torch.Generator``: the same distributions as
the JAX package, not its bits; tests carry JAX-initialised fields across.
``hash_encode_sg`` is the JAX package's sort-based table gradient (sort,
cumsum, binary search), in plain PyTorch: deterministic, and timed beside
kernel C as a yardstick.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from aip_tpu_torch.kernels import hashgrad as KH

N_LEVELS = 16
N_FEATURES = 2
LOG2_HASHMAP = 19
BASE_RES = 16
PER_LEVEL_SCALE = 1.447

_PRIMES = (1, 2654435761, 805459861)


class ColorFieldParams(NamedTuple):
    hash_tables: torch.Tensor  # [L, T, F]
    mlp_w1: torch.Tensor
    mlp_b1: torch.Tensor
    mlp_w2: torch.Tensor
    mlp_b2: torch.Tensor
    mlp_w3: torch.Tensor
    mlp_b3: torch.Tensor
    style_w: torch.Tensor | None  # [512, style_dim]
    style_b: torch.Tensor | None

    def to(self, device) -> "ColorFieldParams":
        return ColorFieldParams(*(None if t is None else t.to(device) for t in self))


def init_colorfield(seed: int = 0, style_dim: int | None = 256,
                    log2_hashmap: int = LOG2_HASHMAP, device=None) -> ColorFieldParams:
    """Tables uniform in [-1e-4, 1e-4], He-normal MLP and style weights,
    zero biases (``aip_tpu.gs.colorfield.init_colorfield``'s distributions),
    from ``torch.Generator().manual_seed(seed)``, on ``device``."""
    gen = torch.Generator().manual_seed(seed)
    t = 2 ** log2_hashmap
    tables = (torch.rand((N_LEVELS, t, N_FEATURES), generator=gen) * 2 - 1) * 1e-4
    n_in = N_LEVELS * N_FEATURES + (style_dim or 0)

    def lin(i, o):
        return torch.randn((i, o), generator=gen) * (2.0 / i) ** 0.5

    params = ColorFieldParams(
        hash_tables=tables,
        mlp_w1=lin(n_in, 64), mlp_b1=torch.zeros(64),
        mlp_w2=lin(64, 64), mlp_b2=torch.zeros(64),
        mlp_w3=lin(64, 48), mlp_b3=torch.zeros(48),
        style_w=lin(512, style_dim) if style_dim else None,
        style_b=torch.zeros(style_dim) if style_dim else None)
    return params.to(device) if device is not None else params


def level_resolutions(n_levels: int = N_LEVELS):
    return [int(BASE_RES * PER_LEVEL_SCALE**l) for l in range(n_levels)]


def level_table_sizes(log2_hashmap: int = LOG2_HASHMAP, n_levels: int = N_LEVELS):
    """Effective entries per level: levels whose dense grid ((res+1)^3
    corners, 8-aligned) fits under the hashmap budget are stored dense;
    larger levels hash into 2^log2_hashmap entries."""
    return level_table_sizes_for_cap(2 ** log2_hashmap, n_levels)


def level_table_sizes_for_cap(table_cap: int, n_levels: int = N_LEVELS):
    sizes = []
    for res in level_resolutions(n_levels):
        dense8 = -(-((res + 1) ** 3) // 8) * 8
        sizes.append(dense8 if dense8 <= table_cap else table_cap)
    return sizes


def contract_to_unisphere(x: torch.Tensor, aabb=(-1.0, -1.0, -1.0, 1.0, 1.0, 1.0),
                          eps: float = 1e-6) -> torch.Tensor:
    """Mip-NeRF-360 scene contraction (gaussian_model.py:662-685 parity):
    R^3 -> [0, 1]^3, linear inside the aabb, 2 - 1/|x| outside."""
    aabb = torch.as_tensor(aabb, dtype=x.dtype, device=x.device)
    lo, hi = aabb[:3], aabb[3:]
    y = (x - lo) / (hi - lo) * 2.0 - 1.0
    mag = torch.linalg.norm(y, dim=-1, keepdim=True)
    mag = torch.clamp(mag, min=eps)
    contracted = (2.0 - 1.0 / mag) * (y / mag)
    y = torch.where(mag > 1.0, contracted, y)
    return y / 4.0 + 0.5


def _hash_corner(ix, iy, iz, table_size: int) -> torch.Tensor:
    """Spatial hash of int64 corner coords; equal to the uint32 wrap-around
    hash masked to a power-of-two ``table_size``."""
    h = (ix * _PRIMES[0]) ^ (iy * _PRIMES[1]) ^ (iz * _PRIMES[2])
    return h & (table_size - 1)


def _corner_index(p0i, ox, oy, oz, res: int, table_cap: int) -> torch.Tensor:
    """Per-level corner -> table row: dense linear indexing when the
    (res+1)^3 grid (8-aligned) fits the table, else the spatial hash.
    Dense corner coords clamp to res."""
    if -(-((res + 1) ** 3) // 8) * 8 <= table_cap:
        ix = torch.clamp(p0i[:, 0] + ox, max=res)
        iy = torch.clamp(p0i[:, 1] + oy, max=res)
        iz = torch.clamp(p0i[:, 2] + oz, max=res)
        return ix + (res + 1) * (iy + (res + 1) * iz)
    return _hash_corner(p0i[:, 0] + ox, p0i[:, 1] + oy, p0i[:, 2] + oz, table_cap)


def hash_encode(tables: torch.Tensor, x01: torch.Tensor) -> torch.Tensor:
    """[N, 3] positions in [0,1] -> [N, L*F] multires features."""
    feats = []
    for lvl, res in enumerate(level_resolutions(tables.shape[0])):
        pos = x01 * res
        p0 = torch.floor(pos)
        frac = pos - p0
        p0i = p0.to(torch.int64)
        level_feats = 0.0
        for corner in range(8):
            ox, oy, oz = corner & 1, (corner >> 1) & 1, (corner >> 2) & 1
            idx = _corner_index(p0i, ox, oy, oz, res, tables.shape[1])
            wx = frac[:, 0] if ox else (1.0 - frac[:, 0])
            wy = frac[:, 1] if oy else (1.0 - frac[:, 1])
            wz = frac[:, 2] if oz else (1.0 - frac[:, 2])
            weight = (wx * wy * wz)[:, None]
            level_feats = level_feats + weight * tables[lvl][idx]
        feats.append(level_feats)
    return torch.cat(feats, dim=1)


def _encode_terms(tables_shape, x01: torch.Tensor):
    """Each (point, level, corner)'s table row and trilinear weight:
    (idx [N, L, 8] int64 with the level offset l * T folded in, w [N, L, 8])."""
    l, t, _f = tables_shape
    idx_levels, w_levels = [], []
    for lvl, res in enumerate(level_resolutions(l)):
        pos = x01 * res
        p0 = torch.floor(pos)
        frac = pos - p0
        p0i = p0.to(torch.int64)
        idx_c, w_c = [], []
        for corner in range(8):
            ox, oy, oz = corner & 1, (corner >> 1) & 1, (corner >> 2) & 1
            wx = frac[:, 0] if ox else (1.0 - frac[:, 0])
            wy = frac[:, 1] if oy else (1.0 - frac[:, 1])
            wz = frac[:, 2] if oz else (1.0 - frac[:, 2])
            idx_c.append(_corner_index(p0i, ox, oy, oz, res, t) + lvl * t)
            w_c.append(wx * wy * wz)
        idx_levels.append(torch.stack(idx_c, 1))
        w_levels.append(torch.stack(w_c, 1))
    return torch.stack(idx_levels, 1), torch.stack(w_levels, 1)


class _HashEncodeMXU(torch.autograd.Function):
    """hash_encode with the table gradient of kernel C; positions get no
    gradient."""

    @staticmethod
    def forward(ctx, tables, x01):
        ctx.save_for_backward(x01)
        ctx.table_shape = tuple(tables.shape)
        return hash_encode(tables, x01)

    @staticmethod
    def backward(ctx, g_out):
        (x01,) = ctx.saved_tensors
        g = g_out.contiguous().to(torch.float32)
        if g.data_ptr() % 16:   # the kernel reads a point's F features as one vector
            g = g.clone()
        grad = KH.hash_grad(x01.contiguous(), g, ctx.table_shape)
        return grad.to(g_out.dtype), None


def hash_encode_mxu(tables: torch.Tensor, x01: torch.Tensor) -> torch.Tensor:
    """``hash_encode`` whose table gradient is kernel C (``hash_grad``); x01
    is stop-gradient."""
    return _HashEncodeMXU.apply(tables, x01.detach())


def sorted_table_grad(x01: torch.Tensor, g_out: torch.Tensor, table_shape) -> torch.Tensor:
    """dL/dtables [L, T, F] of ``hash_encode`` for the upstream gradient
    g_out [N, L*F], as segment sums: every (point, level, corner)
    contribution sorted by its row (a stable sort), a running float32 sum,
    and each row's sum as the difference of the running sums at its
    segment's ends (two binary searches). The JAX package's
    ``_hash_encode_sg_bwd``; no atomics, so the same bits on every run."""
    l, t, f = table_shape
    n = x01.shape[0]
    idx, w = _encode_terms(table_shape, x01)                           # [N, L, 8]
    vals = (w[..., None] * g_out.reshape(n, l, 1, f)).reshape(-1, f)
    sorted_idx, order = torch.sort(idx.reshape(-1), stable=True)
    # [F, M + 1]: each feature's running sum along its own row (a scan along
    # the innermost dimension).
    csum = torch.cumsum(torch.cat([torch.zeros((1, f), dtype=vals.dtype, device=vals.device),
                                   vals[order]]).T.contiguous(), dim=1)
    rows = torch.arange(l * t, dtype=sorted_idx.dtype, device=sorted_idx.device)
    lo = torch.searchsorted(sorted_idx, rows, right=False)
    hi = torch.searchsorted(sorted_idx, rows, right=True)
    return (csum[:, hi] - csum[:, lo]).T.reshape(l, t, f)


class _HashEncodeSG(torch.autograd.Function):
    """hash_encode with the sort-based table gradient; positions get no
    gradient."""

    @staticmethod
    def forward(ctx, tables, x01):
        ctx.save_for_backward(x01)
        ctx.table_shape = tuple(tables.shape)
        return hash_encode(tables, x01)

    @staticmethod
    def backward(ctx, g_out):
        (x01,) = ctx.saved_tensors
        return sorted_table_grad(x01, g_out, ctx.table_shape), None


def hash_encode_sg(tables: torch.Tensor, x01: torch.Tensor) -> torch.Tensor:
    """``hash_encode`` whose table gradient is ``sorted_table_grad`` (the JAX
    package's ``hash_encode_sg``, in plain PyTorch); x01 is stop-gradient.
    A yardstick beside kernel C, not on the training path."""
    return _HashEncodeSG.apply(tables, x01.detach())


def style_embedding(params: ColorFieldParams, style_f: torch.Tensor) -> torch.Tensor:
    """Pooled VGG style feature [1, 512] -> normalized [1, style_dim]
    (renderer :91-96: Linear then L2-normalize)."""
    e = style_f @ params.style_w + params.style_b
    return e / torch.linalg.norm(e, dim=1, keepdim=True)


def precompute_features(params: ColorFieldParams, xyz: torch.Tensor) -> torch.Tensor:
    """Cache the hash-grid features for a fixed Gaussian set
    (gaussian_model.precompute parity, :653-656)."""
    return hash_encode(params.hash_tables, contract_to_unisphere(xyz.detach()))


def predict_sh(params: ColorFieldParams, xyz: torch.Tensor,
               style_f: torch.Tensor | None = None,
               precomputed_enc: torch.Tensor | None = None) -> torch.Tensor:
    """[N, 3] world positions (+ optional [1, 512] style) -> [N, 16, 3] SH:
    contract -> hash encode -> concat(normalized style embedding) -> MLP.
    ``precomputed_enc`` skips the encoding. Tables of 2^16 rows and more
    take ``hash_encode_mxu`` (kernel C in the backward), as in the JAX
    package."""
    if precomputed_enc is None:
        x01 = contract_to_unisphere(xyz.detach())
        if params.hash_tables.shape[1] >= (1 << 16):
            enc = hash_encode_mxu(params.hash_tables, x01)
        else:
            enc = hash_encode(params.hash_tables, x01)
    else:
        enc = precomputed_enc
    if params.style_w is not None:
        if style_f is None:
            # A style-conditioned field queried without a style conditions
            # on a zero embedding, as the JAX package does.
            emb = torch.zeros((1, params.style_w.shape[1]), dtype=enc.dtype, device=enc.device)
        else:
            emb = style_embedding(params, style_f)
        enc = torch.cat([enc, emb.expand(enc.shape[0], emb.shape[1])], dim=1)
    h = torch.relu(enc @ params.mlp_w1 + params.mlp_b1)
    h = torch.relu(h @ params.mlp_w2 + params.mlp_b2)
    out = h @ params.mlp_w3 + params.mlp_b3
    return out.reshape(-1, 16, 3)
