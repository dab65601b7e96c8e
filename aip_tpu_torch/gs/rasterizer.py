"""3D Gaussian tile rasterizer: projection, selection, composite.

Port of ``aip_tpu/gs/rasterizer.py`` (reference ``diff-gaussian-
rasterization``): EWA projection with the 0.3 px low-pass and 3-sigma
radius, the opacity-aware selection extent, and two renderers:

* ``rasterize`` (:786), differentiable: per-16-px-tile top-K selection
  (``select_per_tile``, or ``select_per_tile_hierarchical`` when
  ``settings.macro > 1``; selection sees stop-gradient depths, radii and
  opacities, as at :816-821), then the composite. On a CUDA tensor the
  composite is always ``kernels.composite_ad.composite_tiles_ad`` (kernel A
  forward, kernel B backward), the way the reference's CUDA rasterizer
  streams; on a CPU tensor ``ad_backend="xla"`` takes the dense
  ``[tiles, K, 256]`` autograd of ``composite_tiles`` and ``"pallas"`` the
  Function's plain versions. ``screenspace_offset`` is added to the
  projected means so callers read dL/d mean2d from its gradient;
* ``rasterize_matmul`` (:1055), inference: (block, depth) pair-sort
  selection into macro blocks (``select_macro_pairsort``), then either the
  plain ``composite_raw_blocks`` (backend ``"matmul"``) or one of the two
  hand-written CUDA compositors of ``kernels/composite.py`` (backend
  ``"mxu"``): the segment walk when the pair table is small enough, else
  the windowed walk, by the JAX package's own static rule.

Selection order is the selection: the pair sort is ``torch.sort(...,
stable=True)`` on the same packed int32 key the JAX package sorts with the
stable ``lax.sort``, pairs are emitted in the same flattened order, and
depth quantisation is float32 arithmetic truncated toward zero, so equal
quantised depths composite in the same order in both packages. Top-k
merges are stable sorts (ties to the lower index, as ``lax.top_k``).

``rasterize_matmul`` names its stages for ``torch.profiler`` with
``record_function`` spans: ``gs.project``, ``gs.select`` (pair emission
and sort), ``gs.gather`` (packed-table gather) and ``gs.composite`` (the
compositor kernel); ``rasterize`` uses the same four names.
``chip_smoke.py``'s breakdowns read them.

``composite_backend="pallas"``, ``rasterize_fused`` and ``rasterize_fast``
raise ``NotImplementedError``: they come with slice 2b of the port
(ROADMAP queue 1), with the other three compositor kernels.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.profiler import record_function

from aip_tpu_torch.kernels import composite as K
from aip_tpu_torch.kernels import composite_ad as KAD

TILE = 16

_NEXT_SLICE = ("comes with slice 2b of the port (the per-tile and macro-walk inference "
               "compositor kernels; ROADMAP queue 1)")


class RasterSettings(NamedTuple):
    """Static rasterization parameters (``aip_tpu`` field for field; see
    its docstring for each one's meaning)."""

    image_height: int
    image_width: int
    max_per_tile: int = 128
    chunk: int = 4096
    macro: int = 1
    macro_capacity: int = 1024
    remat_composite: bool = True
    ad_backend: str = "xla"
    select_backend: str = "pairsort"
    dup_span: int = 3
    giant_capacity: int = 128
    giant_pool: int = 16384
    giant_backend: str = "merge"
    giant_span: int = 8
    giant_pool_full: int = 1024
    giant_tiers: tuple = ()
    composite_backend: str = "matmul"
    opacity_cull: bool = True


def _scalar(x, ref: torch.Tensor) -> torch.Tensor:
    """A camera float as a float32 scalar tensor, so the projection runs in
    float32 as the JAX package's traced operands do."""
    return torch.as_tensor(x, dtype=torch.float32, device=ref.device)


def project_gaussians(means3d, scales, rotations, viewmatrix, projmatrix,
                      tanfovx, tanfovy, settings: RasterSettings,
                      scale_modifier: float = 1.0):
    """EWA projection of N Gaussians to screen space.

    viewmatrix/projmatrix are stored transposed (row-vector convention).
    Returns (means2d [N,2], depths [N], conics [N,3], radii [N], valid [N]).
    """
    w, h = settings.image_width, settings.image_height
    tanfovx = _scalar(tanfovx, means3d)
    tanfovy = _scalar(tanfovy, means3d)
    viewmatrix = viewmatrix.to(torch.float32)
    projmatrix = projmatrix.to(torch.float32)
    fx = w / (2.0 * tanfovx)
    fy = h / (2.0 * tanfovy)

    m0, m1, m2 = means3d[:, 0], means3d[:, 1], means3d[:, 2]

    def xform(mat, j):
        return m0 * mat[0, j] + m1 * mat[1, j] + m2 * mat[2, j] + mat[3, j]

    pv0 = xform(viewmatrix, 0)
    pv1 = xform(viewmatrix, 1)
    tz = xform(viewmatrix, 2)
    in_frustum = tz > 0.2

    p_w = 1.0 / (xform(projmatrix, 3) + 1e-7)
    ndc_x = xform(projmatrix, 0) * p_w
    ndc_y = xform(projmatrix, 1) * p_w
    mean2d = torch.stack(
        [((ndc_x + 1.0) * w - 1.0) * 0.5, ((ndc_y + 1.0) * h - 1.0) * 0.5], dim=1)

    tzs = torch.clamp(tz, min=1e-6)
    limx = 1.3 * tanfovx
    limy = 1.3 * tanfovy
    txtz = torch.clamp(pv0 / tzs, -limx, limx)
    tytz = torch.clamp(pv1 / tzs, -limy, limy)

    q = rotations / torch.linalg.norm(rotations, dim=-1, keepdim=True)
    qr, qx, qy, qz = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    s0 = scales[:, 0] * scale_modifier
    s1 = scales[:, 1] * scale_modifier
    s2 = scales[:, 2] * scale_modifier
    l00 = (1 - 2 * (qy * qy + qz * qz)) * s0
    l01 = (2 * (qx * qy - qr * qz)) * s1
    l02 = (2 * (qx * qz + qr * qy)) * s2
    l10 = (2 * (qx * qy + qr * qz)) * s0
    l11 = (1 - 2 * (qx * qx + qz * qz)) * s1
    l12 = (2 * (qy * qz - qr * qx)) * s2
    l20 = (2 * (qx * qz - qr * qy)) * s0
    l21 = (2 * (qy * qz + qr * qx)) * s1
    l22 = (1 - 2 * (qx * qx + qy * qy)) * s2
    s00 = l00 * l00 + l01 * l01 + l02 * l02
    s01 = l00 * l10 + l01 * l11 + l02 * l12
    s02 = l00 * l20 + l01 * l21 + l02 * l22
    s11 = l10 * l10 + l11 * l11 + l12 * l12
    s12 = l10 * l20 + l11 * l21 + l12 * l22
    s22 = l20 * l20 + l21 * l21 + l22 * l22

    j00 = fx / tzs
    j02 = -fx * txtz / tzs
    j11 = fy / tzs
    j12 = -fy * tytz / tzs
    w3 = viewmatrix[:3, :3]
    t00 = j00 * w3[0, 0] + j02 * w3[0, 2]
    t01 = j00 * w3[1, 0] + j02 * w3[1, 2]
    t02 = j00 * w3[2, 0] + j02 * w3[2, 2]
    t10 = j11 * w3[0, 1] + j12 * w3[0, 2]
    t11 = j11 * w3[1, 1] + j12 * w3[1, 2]
    t12 = j11 * w3[2, 1] + j12 * w3[2, 2]

    u0 = s00 * t00 + s01 * t01 + s02 * t02
    u1 = s01 * t00 + s11 * t01 + s12 * t02
    u2 = s02 * t00 + s12 * t01 + s22 * t02
    a = t00 * u0 + t01 * u1 + t02 * u2 + 0.3
    b = t10 * u0 + t11 * u1 + t12 * u2
    v0 = s00 * t10 + s01 * t11 + s02 * t12
    v1 = s01 * t10 + s11 * t11 + s12 * t12
    v2 = s02 * t10 + s12 * t11 + s22 * t12
    c = t10 * v0 + t11 * v1 + t12 * v2 + 0.3
    det = a * c - b * b
    det_safe = torch.where(det > 0, det, torch.ones_like(det))
    conic = torch.stack([c / det_safe, -b / det_safe, a / det_safe], dim=1)

    mid = 0.5 * (a + c)
    lambda1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lambda1))
    valid = in_frustum & (det > 0)
    radius = torch.where(valid, radius, torch.zeros_like(radius))
    return mean2d, tz, conic, radius, valid


def _tile_grid(settings: RasterSettings):
    return math.ceil(settings.image_height / TILE), math.ceil(settings.image_width / TILE)


def _topk_smallest(keys, ids, k: int):
    """The k smallest ``keys`` per row, ties to the lower column: a stable
    ascending sort, which is what ``lax.top_k`` of the negated keys picks."""
    d, pos = torch.sort(keys, dim=1, stable=True)
    return d[:, :k], torch.gather(ids, 1, pos[:, :k])


def select_per_tile(mean2d, depths, radii, valid, settings: RasterSettings):
    """Per-tile K-nearest-by-depth candidates, merged chunk by chunk as the
    JAX package's scan does. Returns (idx [tiles, K], depth [tiles, K]),
    front to back; empty slots are (-1, +inf)."""
    th, tw = _tile_grid(settings)
    n_tiles = th * tw
    k = settings.max_per_tile
    n = mean2d.shape[0]
    chunk = settings.chunk
    dev = mean2d.device

    tiles = torch.arange(n_tiles, device=dev)
    tile_x0 = ((tiles % tw) * TILE)[:, None]
    tile_y0 = ((tiles // tw) * TILE)[:, None]
    best_d = torch.full((n_tiles, k), math.inf, device=dev)
    best_i = torch.full((n_tiles, k), -1, dtype=torch.int32, device=dev)
    for sl in range(0, n, chunk):
        m = mean2d[sl:sl + chunk]
        d = depths[sl:sl + chunk]
        r = radii[sl:sl + chunk]
        v = valid[sl:sl + chunk]
        ox = (m[None, :, 0] + r[None, :] >= tile_x0) & (m[None, :, 0] - r[None, :] < tile_x0 + TILE)
        oy = (m[None, :, 1] + r[None, :] >= tile_y0) & (m[None, :, 1] - r[None, :] < tile_y0 + TILE)
        hit = ox & oy & v[None, :] & (r[None, :] > 0)
        key = torch.where(hit, d[None, :], torch.full_like(hit, math.inf, dtype=d.dtype))
        ids = torch.arange(sl, sl + m.shape[0], dtype=torch.int32, device=dev)
        cand_d = torch.cat([best_d, key], dim=1)
        cand_i = torch.cat([best_i, ids.expand(n_tiles, -1)], dim=1)
        best_d, best_i = _topk_smallest(cand_d, cand_i, k)
        best_i = torch.where(torch.isinf(best_d), torch.full_like(best_i, -1), best_i)
    return best_i, best_d


def composite_tiles(sel_idx, sel_depth, mean2d, conics, colors, opacities,
                    bg_color, settings: RasterSettings):
    """Front-to-back alpha compositing of the per-tile candidate lists, as
    dense [tiles, K, 256] tensors. Returns the [H, W, 3] image."""
    th, tw = _tile_grid(settings)
    n_tiles = th * tw
    dev = mean2d.device

    slot_valid = sel_idx >= 0
    safe_idx = torch.clamp(sel_idx, min=0).long()
    g_mean = mean2d[safe_idx]                    # [T, K, 2]
    g_conic = conics[safe_idx]
    g_color = colors[safe_idx]
    g_op = opacities[safe_idx]

    px = torch.arange(TILE, dtype=torch.float32, device=dev)
    pyy, pxx = torch.meshgrid(px, px, indexing="ij")
    local = torch.stack([pxx.reshape(-1), pyy.reshape(-1)], dim=1)  # [P, 2] (x, y)
    tiles = torch.arange(n_tiles, device=dev)
    origin = torch.stack([((tiles % tw) * TILE).float(), ((tiles // tw) * TILE).float()], dim=1)
    pix = local[None, :, :] + origin[:, None, :]                    # [T, P, 2]

    dx = pix[:, None, :, 0] - g_mean[:, :, None, 0]                 # [T, K, P]
    dy = pix[:, None, :, 1] - g_mean[:, :, None, 1]
    power = -0.5 * (g_conic[:, :, None, 0] * dx * dx + g_conic[:, :, None, 2] * dy * dy) \
        - g_conic[:, :, None, 1] * dx * dy
    power = torch.clamp(power, max=0.0)
    alpha = torch.clamp(g_op[:, :, None] * torch.exp(power), max=0.99)
    alpha = torch.where(slot_valid[:, :, None], alpha, torch.zeros_like(alpha))
    alpha = torch.where(alpha < (1.0 / 255.0), torch.zeros_like(alpha), alpha)

    t_inclusive = torch.cumprod(1.0 - alpha, dim=1)
    t_exclusive = torch.cat([torch.ones_like(t_inclusive[:, :1]), t_inclusive[:, :-1]], dim=1)
    contrib = torch.where(t_exclusive > 1e-4, alpha * t_exclusive, torch.zeros_like(alpha))
    rgb = torch.einsum("tkp,tkc->tpc", contrib, g_color)
    rgb = rgb + t_inclusive[:, -1, :, None] * bg_color[None, None, :]

    img = rgb.reshape(th, tw, TILE, TILE, 3).permute(0, 2, 1, 3, 4)
    img = img.reshape(th * TILE, tw * TILE, 3)
    return img[: settings.image_height, : settings.image_width]


def select_macro_pairsort(mean2d, depths, radii, valid, mth, mtw,
                          settings: RasterSettings, segments: bool = False):
    """Macro-block candidate selection by a (block, depth) pair sort.

    Each Gaussian whose bounding rect spans at most dup_span x dup_span
    macro blocks emits one (block, depth, id) pair per overlapped block;
    wider ("giant") Gaussians emit through the super-grid merge
    (``giant_backend="merge"``) or from depth-compacted pools
    (``"direct"``). One stable sort orders every pair by (block, depth).

    ``segments=True`` returns (gid_s [S], starts [M], counts [M]): the
    sorted pair ids and each block's row range, counts clipped to
    macro_capacity. Otherwise returns (idx [M, Kc], depth [M, Kc]) front to
    back, empty slots (-1, +inf).
    """
    m = settings.macro
    bs = m * TILE
    kc = settings.macro_capacity
    d_span = settings.dup_span
    if settings.giant_backend == "merge" and settings.giant_capacity <= 0:
        raise ValueError(
            "select_macro_pairsort needs giant_capacity > 0: Gaussians "
            "wider than dup_span macro blocks are recovered only through "
            "the super-grid giant pass, so 0 would silently drop them. "
            "Use select_backend='merge' for an uncapped selection.")
    if settings.giant_backend == "direct" and settings.giant_pool_full <= 0:
        raise ValueError(
            "giant_backend='direct' needs giant_pool_full > 0: splats "
            "spanning more than giant_span blocks are emitted only from "
            "the full-grid pool, so 0 would silently drop them.")
    n_blocks = mth * mtw
    n = mean2d.shape[0]
    dev = mean2d.device
    i32 = torch.int32

    blk_bits = max(1, math.ceil(math.log2(n_blocks + 2)))
    dq_bits = 31 - blk_bits
    packed = dq_bits >= 16

    mx, my = mean2d[:, 0], mean2d[:, 1]
    x0 = torch.floor((mx - radii) / bs).to(i32)
    x1 = torch.floor((mx + radii) / bs).to(i32)
    y0 = torch.floor((my - radii) / bs).to(i32)
    y1 = torch.floor((my + radii) / bs).to(i32)
    alive = valid & (radii > 0)
    normal = alive & (x1 - x0 < d_span) & (y1 - y0 < d_span)
    giant = alive & ~normal

    # Emission order [D, D, N] (duplicate slots lead), as the JAX package
    # flattens it: equal keys keep this order through the stable sort.
    offs = torch.arange(d_span, dtype=i32, device=dev)
    bxs = offs[:, None] + x0[None, :]
    bys = offs[:, None] + y0[None, :]
    okx = (bxs >= 0) & (bxs < mtw) & (bxs <= x1[None, :])
    oky = (bys >= 0) & (bys < mth) & (bys <= y1[None, :])
    ok = oky[:, None, :] & okx[None, :, :] & normal[None, None, :]
    blk = bys[:, None, :] * mtw + bxs[None, :, :]
    blk = torch.where(ok, blk, torch.full_like(blk, n_blocks))

    gid = torch.arange(n, dtype=i32, device=dev).expand(ok.shape).reshape(-1)
    blk = blk.reshape(-1)
    blk_parts, gid_parts = [blk], [gid]

    if packed:
        inf = torch.full_like(depths, math.inf)
        dmin = torch.where(alive, depths, inf).min()
        dmax = torch.where(alive, depths, -inf).max()
        # float32 scale and product, truncated toward zero, then clipped
        # as integers: a float clip would round into the block bits. The
        # pre-clamp only keeps the float->int conversion defined for
        # splats that are never emitted.
        dscale = ((1 << dq_bits) - 64) / torch.clamp(dmax - dmin, min=1e-12)
        dqf = torch.clamp((depths - dmin) * dscale, min=0.0, max=float(1 << 30))
        dq = torch.clamp(dqf.to(i32), 0, (1 << dq_bits) - 1)
        dq_parts = [torch.where(ok, dq[None, None, :], torch.zeros((), dtype=i32, device=dev))
                    .reshape(-1)]

    kg = settings.giant_capacity
    if settings.giant_backend == "direct":
        gx0 = torch.clamp(x0, 0, mtw - 1)
        gx1 = torch.clamp(x1, 0, mtw - 1)
        gy0 = torch.clamp(y0, 0, mth - 1)
        gy1 = torch.clamp(y1, 0, mth - 1)
        spn = settings.giant_span

        def emit(sel_mask, pool, span_y, span_x, anchored):
            pool = min(pool, n)
            key = torch.where(sel_mask, depths, torch.full_like(depths, math.inf))
            pidx = torch.sort(key, stable=True).indices[:pool]
            pv = sel_mask[pidx]
            ax0, ax1 = gx0[pidx], gx1[pidx]
            ay0, ay1 = gy0[pidx], gy1[pidx]
            ox = torch.arange(span_x, dtype=i32, device=dev)
            oy = torch.arange(span_y, dtype=i32, device=dev)
            if anchored:
                bx = ox[:, None] + ax0[None, :]
                by = oy[:, None] + ay0[None, :]
                okx2 = bx <= ax1[None, :]
                oky2 = by <= ay1[None, :]
            else:
                bx = ox[:, None].expand(span_x, pool)
                by = oy[:, None].expand(span_y, pool)
                okx2 = (bx >= ax0[None, :]) & (bx <= ax1[None, :])
                oky2 = (by >= ay0[None, :]) & (by <= ay1[None, :])
            ok2 = oky2[:, None, :] & okx2[None, :, :] & pv[None, None, :]
            b = by[:, None, :] * mtw + bx[None, :, :]
            b = torch.where(ok2, b, torch.full_like(b, n_blocks))
            blk_parts.append(b.reshape(-1))
            gid_parts.append(pidx.to(i32).expand(ok2.shape).reshape(-1))
            if packed:
                dq_parts.append(torch.where(ok2, dq[pidx][None, None, :],
                                            torch.zeros((), dtype=i32, device=dev)).reshape(-1))

        tiers = settings.giant_tiers or ((spn, settings.giant_pool),)
        taken = torch.zeros_like(giant)
        for t_span, t_pool in tiers:
            fits = giant & ~taken & (gx1 - gx0 < t_span) & (gy1 - gy0 < t_span)
            emit(fits, t_pool, t_span, t_span, True)
            taken = taken | fits
        emit(giant & ~taken, settings.giant_pool_full, mth, mtw, False)
    elif kg > 0:
        # Coarse super grid (clipped rects always fit) -> extra
        # (block, giant) pairs appended to the same sort.
        sb = max(1, math.ceil(max(mth, mtw) / 4))
        sth = math.ceil(mth / sb)
        stw = math.ceil(mtw / sb)
        super_settings = RasterSettings(image_height=sth * TILE, image_width=stw * TILE,
                                        max_per_tile=kg, chunk=n)
        scale = m * sb
        pool = min(settings.giant_pool, n)
        if pool * 16 <= n:
            gkey = torch.where(giant, depths, torch.full_like(depths, math.inf))
            pidx = torch.sort(gkey, stable=True).indices[:pool]
            sup_sel, _ = select_per_tile(mean2d[pidx] / scale, depths[pidx], radii[pidx] / scale,
                                         giant[pidx], super_settings._replace(chunk=pool))
            sup_idx = torch.where(sup_sel >= 0, pidx[torch.clamp(sup_sel, min=0).long()].to(i32),
                                  torch.full_like(sup_sel, -1))
        else:
            sup_idx, _ = select_per_tile(mean2d / scale, depths, radii / scale, giant,
                                         super_settings)

        bids = torch.arange(n_blocks, device=dev)
        rows = bids // mtw
        cols = bids % mtw
        sup_of_block = (rows // sb) * stw + (cols // sb)
        sup_safe = torch.clamp(sup_idx, min=0).long()       # [S, kg]
        cand = sup_idx[sup_of_block]                        # [n_blocks, kg]
        cmx = mx[sup_safe][sup_of_block]
        cmy = my[sup_safe][sup_of_block]
        cr = radii[sup_safe][sup_of_block]
        bx0 = (cols * bs).to(mean2d.dtype)[:, None]
        by0 = (rows * bs).to(mean2d.dtype)[:, None]
        hit = ((cmx + cr >= bx0) & (cmx - cr < bx0 + bs)
               & (cmy + cr >= by0) & (cmy - cr < by0 + bs) & (cand >= 0))
        safe = torch.clamp(cand, min=0)
        gblk = torch.where(hit, bids.to(i32)[:, None], torch.full_like(cand, n_blocks))
        blk_parts.append(gblk.reshape(-1))
        gid_parts.append(safe.to(i32).reshape(-1))
        if packed:
            sdq = dq[sup_safe][sup_of_block]
            dq_parts.append(torch.where(hit, sdq, torch.zeros_like(sdq)).reshape(-1))

    blk = torch.cat(blk_parts)
    gid = torch.cat(gid_parts)
    if packed:
        key = (blk << dq_bits) | torch.cat(dq_parts)
        key_s, perm = torch.sort(key, stable=True)
        gid_s = gid[perm]
        blk_s = key_s >> dq_bits
    else:
        # Lexicographic (block, depth) with the emission order breaking
        # ties: stable sort by depth, then stable sort by block.
        p1 = torch.sort(depths[gid.long()], stable=True).indices
        p2 = torch.sort(blk[p1], stable=True).indices
        perm = p1[p2]
        blk_s, gid_s = blk[perm], gid[perm]
    arange_b = torch.arange(n_blocks + 1, dtype=blk_s.dtype, device=dev)
    starts = torch.searchsorted(blk_s, arange_b[:-1], right=False)
    ends = torch.searchsorted(blk_s, arange_b[1:], right=False)
    if segments:
        assert gid_s.shape[0] == _pairsort_slots(n, settings, mth, mtw), (
            gid_s.shape[0], _pairsort_slots(n, settings, mth, mtw))
        counts = torch.clamp(ends - starts, max=kc).to(i32)
        return gid_s, starts.to(i32), counts
    slot = starts[:, None] + torch.arange(kc, device=dev)[None, :]
    in_seg = slot < ends[:, None]
    slot = torch.clamp(slot, max=gid_s.shape[0] - 1)
    sel_i = torch.where(in_seg, gid_s[slot], torch.full_like(gid_s[slot], -1))
    sel_d = torch.where(in_seg, depths[torch.clamp(sel_i, min=0).long()],
                        torch.full(sel_i.shape, math.inf, device=dev))
    return sel_i, sel_d


def _macro_select(mean2d, depths, radii, valid, settings: RasterSettings, mth, mtw):
    """Dispatch macro-block binning to the configured backend."""
    if settings.select_backend == "pairsort":
        return select_macro_pairsort(mean2d, depths, radii, valid, mth, mtw, settings)
    m = settings.macro
    macro_settings = RasterSettings(image_height=mth * TILE, image_width=mtw * TILE,
                                    max_per_tile=settings.macro_capacity, chunk=settings.chunk)
    return select_per_tile(mean2d / m, depths, radii / m, valid, macro_settings)


def selection_radii(radii, opacities):
    """Opacity-aware candidate extent: shrink the 3-sigma radius to the
    alpha >= 1/255 isoline, ``ceil(r * sqrt(clip(q_cut / 9, 0, 1)))`` with
    ``q_cut = 2 ln(255 opacity)``. Exact for images: the composite zeroes
    every alpha below 1/255."""
    q_cut = 2.0 * torch.log(255.0 * torch.clamp(opacities, min=1e-12))
    s = torch.sqrt(torch.clamp(q_cut / 9.0, 0.0, 1.0))
    return torch.ceil(radii * s.detach())


def cull_radii(radii, opacities, settings: RasterSettings):
    """The opacity-aware footprint when ``settings.opacity_cull``."""
    if settings.opacity_cull:
        return selection_radii(radii, opacities)
    return radii


def select_per_tile_hierarchical(mean2d, depths, radii, valid, settings: RasterSettings):
    """Two-level candidate selection (:642): macro blocks of (macro x
    macro) tiles get their Kc candidates (``_macro_select``: pair sort or
    chunked merge), then each 16 px tile keeps the K nearest of its block's
    candidates that overlap it (a stable sort: ties to the lower candidate
    slot, as ``lax.top_k``). Returns (idx [tiles, K], depth [tiles, K])
    like ``select_per_tile``."""
    th, tw = _tile_grid(settings)
    k = settings.max_per_tile
    m = settings.macro
    kc = settings.macro_capacity
    mth, mtw = math.ceil(th / m), math.ceil(tw / m)
    macro_idx, _ = _macro_select(mean2d, depths, radii, valid, settings, mth, mtw)
    kc = macro_idx.shape[1]
    dev = mean2d.device

    n_tiles = th * tw
    mb = macro_idx.shape[0]
    cvalid_b = macro_idx >= 0
    safe_b = torch.clamp(macro_idx, min=0).long()
    cm_b = mean2d[safe_b]                                   # [MB, Kc, 2]
    cr_b = radii[safe_b]
    cd_b = torch.where(cvalid_b, depths[safe_b], torch.full_like(cr_b, math.inf))

    bidx = torch.arange(mb, device=dev)
    bx0 = (bidx % mtw) * (m * TILE)
    by0 = (bidx // mtw) * (m * TILE)
    sub = torch.arange(m * m, device=dev)
    tx0 = (bx0[:, None] + (sub % m)[None, :] * TILE).to(torch.float32)
    ty0 = (by0[:, None] + (sub // m)[None, :] * TILE).to(torch.float32)
    ox = ((cm_b[..., 0:1] + cr_b[..., None] >= tx0[:, None, :])
          & (cm_b[..., 0:1] - cr_b[..., None] < tx0[:, None, :] + TILE))
    oy = ((cm_b[..., 1:2] + cr_b[..., None] >= ty0[:, None, :])
          & (cm_b[..., 1:2] - cr_b[..., None] < ty0[:, None, :] + TILE))
    hit = ox & oy & (cvalid_b & (cr_b > 0))[..., None]      # [MB, Kc, m*m]
    key = torch.where(hit, cd_b[..., None], torch.full_like(cd_b[..., None], math.inf))
    key_t = key.permute(0, 2, 1).reshape(mb * m * m, kc)
    cand_rep = torch.repeat_interleave(macro_idx, m * m, dim=0)     # [MB*m*m, Kc]
    if kc < k:   # fewer candidates than slots: pad with empty ones
        key_t = torch.cat([key_t, torch.full((key_t.shape[0], k - kc), math.inf, device=dev)], 1)
        cand_rep = torch.cat([cand_rep, torch.full((cand_rep.shape[0], k - kc), -1,
                                                   dtype=cand_rep.dtype, device=dev)], 1)
    sel_d_b, sel_i_b = _topk_smallest(key_t, cand_rep, k)
    sel_i_b = torch.where(torch.isinf(sel_d_b), torch.full_like(sel_i_b, -1), sel_i_b)

    # (block, tile-in-block) -> global tile order; sub-tiles hanging over
    # the grid edge are dropped.
    gy = (torch.arange(mb) // mtw)[:, None] * m + (torch.arange(m * m) // m)[None, :]
    gx = (torch.arange(mb) % mtw)[:, None] * m + (torch.arange(m * m) % m)[None, :]
    gt = torch.where((gy < th) & (gx < tw), gy * tw + gx, torch.full_like(gy, n_tiles))
    order = torch.sort(gt.reshape(-1), stable=True).indices[:n_tiles].to(dev)
    return sel_i_b[order], sel_d_b[order]


def _select(mean2d, depths, radii, valid, settings: RasterSettings, opacities=None):
    if opacities is not None:
        radii = cull_radii(radii, opacities, settings)
    if settings.macro > 1:
        return select_per_tile_hierarchical(mean2d, depths, radii, valid, settings)
    return select_per_tile(mean2d, depths, radii, valid, settings)


def _tiles_to_image(tiles, settings: RasterSettings):
    """[T, 3, 16, 16] tiles -> [H, W, 3]."""
    th, tw = _tile_grid(settings)
    img = tiles.reshape(th, tw, 3, TILE, TILE).permute(0, 3, 1, 4, 2)
    return img.reshape(th * TILE, tw * TILE, 3)[: settings.image_height, : settings.image_width]


def rasterize(means3d, scales, rotations, opacities, colors, viewmatrix, projmatrix,
              bg_color, settings: RasterSettings, tanfovx=1.0, tanfovy=1.0,
              scale_modifier=1.0, screenspace_offset=None):
    """Project + per-tile select + composite, differentiable in means3d,
    scales, rotations, opacities, colours and ``screenspace_offset`` ([N, 2],
    added to the projected means). Returns (image [H, W, 3], radii [N])."""
    if settings.ad_backend not in ("xla", "pallas"):
        raise ValueError(f"unknown ad_backend {settings.ad_backend!r}")
    with record_function("gs.project"):
        mean2d, depths, conics, radii, valid = project_gaussians(
            means3d, scales, rotations, viewmatrix, projmatrix, tanfovx, tanfovy,
            settings, scale_modifier)
        if screenspace_offset is not None:
            mean2d = mean2d + screenspace_offset
    # Invisible splats (pruned or inactive slots arrive with opacity 0) must
    # not take candidate capacity; selection sees no gradient.
    with record_function("gs.select"), torch.no_grad():
        op_sg = opacities.detach()
        valid_sel = valid & (op_sg > (1.0 / 255.0))
        sel_idx, sel_depth = _select(mean2d.detach(), depths.detach(), radii.detach(),
                                     valid_sel, settings, opacities=op_sg)
    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=means3d.device)
    if means3d.device.type == "cuda" or settings.ad_backend == "pallas":
        _, tw = _tile_grid(settings)
        n_tiles, k = sel_idx.shape
        with record_function("gs.gather"):
            # One packed gather through index_select, whose backward is a
            # single index_add_ of the [T*K, 9] cotangent rows (atomics on
            # the card); the backward of advanced indexing would sort the
            # duplicate indices of each of four gathers instead.
            flat = torch.clamp(sel_idx, min=0).reshape(-1).long()
            slot_valid = (sel_idx >= 0).to(torch.float32)[:, :, None]
            table = torch.cat([mean2d, conics, colors, opacities[:, None]], dim=1)
            g = torch.index_select(table, 0, flat).reshape(n_tiles, k, 9)
        with record_function("gs.composite"):
            tiles = KAD.composite_tiles_ad(g[..., 0:2], g[..., 2:5], g[..., 5:8], g[..., 8:9],
                                           slot_valid, tw, bg)
        return _tiles_to_image(tiles, settings), radii
    with record_function("gs.composite"):
        img = composite_tiles(sel_idx, sel_depth, mean2d, conics, colors, opacities, bg,
                              settings)
    return img, radii


def pack_raw_table(mean2d, conics, opacities, colors):
    """The packed per-Gaussian row every raw-consuming composite reads:
    [mean2d(2), conic(3), log-opacity(1), rgb(3), pad(7)] = 16 float32."""
    n = mean2d.shape[0]
    logop = torch.log(torch.clamp(opacities, min=1e-30))
    return torch.cat([mean2d, conics, logop[:, None], colors,
                      torch.zeros((n, 7), dtype=mean2d.dtype, device=mean2d.device)], dim=1)


def composite_raw_blocks(raw, counts, bg_color, bs: int, mtw: int, block0=0):
    """Per-macro-block compositing of packed candidate rows, in plain torch:
    [B', Kc, 16] rows + [B'] valid counts (a prefix) -> [B', bs*bs, 3].
    The plain version the compositor kernels are held against
    (``kernels.composite.composite_macro_mxu_reference``)."""
    planes = K.composite_macro_mxu_reference(raw, counts, bg_color, bs, mtw, block0=block0)
    return planes[:, :, 0, :].permute(0, 2, 1)


def _planes_to_image(planes, mth, mtw, bs):
    """[M, 3, 1, bs*bs] planes -> [mth*bs, mtw*bs, 3]."""
    img = planes.reshape(mth, mtw, 3, bs, bs).permute(0, 3, 1, 4, 2)
    return img.reshape(mth * bs, mtw * bs, 3)


def _composite_macro_matmul(macro_idx, mean2d, conics, colors, opacities, bg_color, m, mth, mtw):
    """Macro-block compositing through the plain ``composite_raw_blocks``."""
    bs = m * TILE
    table = pack_raw_table(mean2d, conics, opacities, colors)
    raw = table[torch.clamp(macro_idx, min=0).long()]
    counts = (macro_idx >= 0).sum(dim=1).to(torch.int32)
    planes = K.composite_macro_mxu_reference(raw, counts, bg_color, bs, mtw)
    return _planes_to_image(planes, mth, mtw, bs)


def _composite_macro_mxu(macro_idx, mean2d, conics, colors, opacities, bg_color, m, mth, mtw):
    """Windowed composite: one [M, Kc, 16] gather of the packed table, then
    the windowed compositor (kernel on a CUDA tensor). Valid slots are a
    prefix of each block's depth-sorted list."""
    bs = m * TILE
    with record_function("gs.gather"):
        table = pack_raw_table(mean2d, conics, opacities, colors)
        raw = table[torch.clamp(macro_idx, min=0).long()]     # [M, Kc, 16]
        counts = (macro_idx >= 0).sum(dim=1).to(torch.int32)
    with record_function("gs.composite"):
        planes = K.composite_macro_mxu(raw, counts, bg_color, bs=bs, mtw=mtw)
    return _planes_to_image(planes, mth, mtw, bs)


# Seg-vs-windowed crossover, kept as the JAX package's static dispatch rule
# so that both packages take the same branch for a configuration: the
# segment path while the pair table has at most 3x the windowed volume
# (blocks x capacity) of rows, else the windowed path. Not re-tuned for
# this card.
_SEG_SLOT_RATIO = 3.0


def _pairsort_slots(n: int, settings: RasterSettings, mth: int, mtw: int) -> int:
    """Static emission slot count of select_macro_pairsort."""
    s = n * settings.dup_span * settings.dup_span
    n_blocks = mth * mtw
    if settings.giant_backend == "direct":
        tiers = settings.giant_tiers or ((settings.giant_span, settings.giant_pool),)
        for t_span, t_pool in tiers:
            s += min(t_pool, n) * t_span * t_span
        s += min(settings.giant_pool_full, n) * n_blocks
    elif settings.giant_capacity > 0:
        s += n_blocks * settings.giant_capacity
    return s


def _composite_macro_mxu_seg(gid_s, starts, counts, mean2d, conics, colors, opacities,
                             bg_color, m, mth, mtw, kc):
    """Segment composite: the packed table gathered once in pair-sort order
    ([S, 16], contiguous per block); the segment compositor walks each
    block's [start, start+count) rows."""
    bs = m * TILE
    with record_function("gs.gather"):
        table = pack_raw_table(mean2d, conics, opacities, colors)
        raw_sorted = table[gid_s.long()]
    with record_function("gs.composite"):
        planes = K.composite_macro_mxu_seg(raw_sorted, starts, counts, bg_color,
                                           n_blocks=mth * mtw, kc=kc, bs=bs, mtw=mtw)
    return _planes_to_image(planes, mth, mtw, bs)


def uses_segment_path(n: int, settings: RasterSettings) -> bool:
    """Whether ``rasterize_matmul`` takes the segment compositor for ``n``
    Gaussians at these settings (a static rule, as in the JAX package)."""
    th, tw = _tile_grid(settings)
    mth, mtw = math.ceil(th / settings.macro), math.ceil(tw / settings.macro)
    return (settings.composite_backend == "mxu" and settings.select_backend == "pairsort"
            and _pairsort_slots(n, settings, mth, mtw)
            <= _SEG_SLOT_RATIO * mth * mtw * settings.macro_capacity)


@torch.no_grad()
def rasterize_matmul(means3d, scales, rotations, opacities, colors, viewmatrix, projmatrix,
                     bg_color, settings: RasterSettings, tanfovx=1.0, tanfovy=1.0,
                     scale_modifier=1.0):
    """Inference rasterization with macro-block compositing. Requires
    settings.macro > 1. Backend ``"mxu"`` runs the CUDA compositors on CUDA
    tensors (their plain versions on CPU tensors); ``"matmul"`` runs the
    plain composite everywhere. Returns (image [H, W, 3], radii [N])."""
    assert settings.macro > 1, "rasterize_matmul requires hierarchical settings"
    if settings.composite_backend not in ("mxu", "matmul"):
        raise NotImplementedError(
            f"composite_backend={settings.composite_backend!r} {_NEXT_SLICE}")
    with record_function("gs.project"):
        mean2d, depths, conics, radii, valid = project_gaussians(
            means3d, scales, rotations, viewmatrix, projmatrix, tanfovx, tanfovy,
            settings, scale_modifier)
        opacities = opacities.to(torch.float32)
        valid = valid & (opacities > (1.0 / 255.0))
        radii_sel = cull_radii(radii, opacities, settings)
    th, tw = _tile_grid(settings)
    m = settings.macro
    mth = math.ceil(th / m)
    mtw = math.ceil(tw / m)
    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=means3d.device)
    if uses_segment_path(means3d.shape[0], settings):
        with record_function("gs.select"):
            gid_s, starts, counts = select_macro_pairsort(
                mean2d, depths, radii_sel, valid, mth, mtw, settings, segments=True)
        img = _composite_macro_mxu_seg(gid_s, starts, counts, mean2d, conics, colors,
                                       opacities, bg, m, mth, mtw, settings.macro_capacity)
        return img[: settings.image_height, : settings.image_width], radii
    with record_function("gs.select"):
        macro_idx, _ = _macro_select(mean2d, depths, radii_sel, valid, settings, mth, mtw)
    composite = _composite_macro_mxu if settings.composite_backend == "mxu" \
        else _composite_macro_matmul
    img = composite(macro_idx, mean2d, conics, colors, opacities, bg, m, mth, mtw)
    return img[: settings.image_height, : settings.image_width], radii


def rasterize_fused(*args, **kwargs):
    raise NotImplementedError(f"rasterize_fused (composite_from_macro) {_NEXT_SLICE}")


def rasterize_fast(*args, **kwargs):
    raise NotImplementedError(f"rasterize_fast (composite_tiles kernel) {_NEXT_SLICE}")
