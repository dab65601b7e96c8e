"""Plain stylized Compact-3DGS inference frame in PyTorch (float32, TF32
off unless asked), written from the published method and the
configuration's stated settings. No kernel, cache or package of the
program is used.

A frame of one view:

* colour field (Compact-3DGS's hash grid and MLP, with the repo's style
  conditioning): the positions contracted to the unit sphere (Mip-NeRF
  360), 16 levels x 2 features of a multires hash grid (tiny-cuda-nn's
  resolutions ``floor(16 * 1.447^l)``; a level whose (res+1)^3 corner grid,
  rounded up to 8, fits its table is indexed densely, a larger one by the
  spatial hash with primes 1, 2654435761, 805459861), trilinear weights,
  concatenated with the L2-normalised linear style embedding, through a
  64-wide two-hidden-layer ReLU MLP to degree-3 SH, evaluated along the
  view direction (+0.5, clamped at 0);
* EWA projection (the 0.3 px low-pass, the 3-sigma radius, the 1.3 x fov
  clamp, the near plane at 0.2);
* selection with no capacity: a splat takes part where it is in front, its
  conic is positive and its opacity reaches 1/255; its extent is the
  3-sigma radius shrunk to the alpha = 1/255 isoline; every 16 px tile
  keeps every splat that reaches it, ordered by exact depth, ties to the
  lower index;
* front-to-back compositing per tile, alpha = min(0.99, o exp(-q/2)),
  alphas under 1/255 dropped, a splat counted while the transmittance
  before it is above 1e-4, the background behind the product of all.
"""

from __future__ import annotations

import torch

TILE = 16
PRIMES = (1, 2654435761, 805459861)
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658, 0.3731763325901154,
         -0.4570457994644658, 1.445305721320277, -0.5900435899266435)


# --- colour field -------------------------------------------------------------

def contract(x):
    lo, hi = -1.0, 1.0
    y = (x - lo) / (hi - lo) * 2.0 - 1.0
    mag = torch.linalg.norm(y, dim=-1, keepdim=True).clamp(min=1e-6)
    y = torch.where(mag > 1.0, (2.0 - 1.0 / mag) * (y / mag), y)
    return y / 4.0 + 0.5


def level_resolutions(levels, base, scale):
    return [int(base * scale ** l) for l in range(levels)]


def hash_features(tables, x01, base, scale):
    """[N, 3] in [0, 1] -> [N, L * F]."""
    n_levels, t = tables.shape[:2]
    feats = []
    for lvl, res in enumerate(level_resolutions(n_levels, base, scale)):
        pos = x01 * res
        p0 = torch.floor(pos)
        frac = pos - p0
        p0 = p0.to(torch.int64)
        dense = -(-((res + 1) ** 3) // 8) * 8 <= t
        acc = 0.0
        for c in range(8):
            o = (c & 1, (c >> 1) & 1, (c >> 2) & 1)
            if dense:
                i = [torch.clamp(p0[:, a] + o[a], max=res) for a in range(3)]
                idx = i[0] + (res + 1) * (i[1] + (res + 1) * i[2])
            else:
                i = [p0[:, a] + o[a] for a in range(3)]
                idx = ((i[0] * PRIMES[0]) ^ (i[1] * PRIMES[1]) ^ (i[2] * PRIMES[2])) & (t - 1)
            w = 1.0
            for a in range(3):
                w = w * (frac[:, a] if o[a] else 1.0 - frac[:, a])
            acc = acc + w[:, None] * tables[lvl][idx]
        feats.append(acc)
    return torch.cat(feats, dim=1)


def sh_coefficients(p, xyz, style_f, cfg):
    """[N, 16, 3] SH of every slot."""
    enc = hash_features(p["hash_tables"], contract(xyz.detach()), cfg["hash_base_resolution"],
                        cfg["hash_per_level_scale"])
    e = style_f @ p["style_w"] + p["style_b"]
    e = e / torch.linalg.norm(e, dim=1, keepdim=True)
    h = torch.cat([enc, e.expand(enc.shape[0], -1)], dim=1)
    h = torch.relu(h @ p["mlp_w1"] + p["mlp_b1"])
    h = torch.relu(h @ p["mlp_w2"] + p["mlp_b2"])
    return (h @ p["mlp_w3"] + p["mlp_b3"]).reshape(-1, 16, 3)


def sh_to_rgb(sh, d):
    """Degree-3 SH [N, 16, 3] along unit directions [N, 3], + 0.5, >= 0."""
    x, y, z = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
    basis = [torch.full_like(x, SH_C0), -SH_C1 * y, SH_C1 * z, -SH_C1 * x,
             SH_C2[0] * xy, SH_C2[1] * yz, SH_C2[2] * (2 * zz - xx - yy), SH_C2[3] * xz,
             SH_C2[4] * (xx - yy),
             SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * xy * z, SH_C3[2] * y * (4 * zz - xx - yy),
             SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy), SH_C3[4] * x * (4 * zz - xx - yy),
             SH_C3[5] * z * (xx - yy), SH_C3[6] * x * (xx - 3 * yy)]
    rgb = sum(b * sh[:, i, :] for i, b in enumerate(basis))
    return torch.clamp(rgb + 0.5, min=0.0)


# --- projection, selection, compositing ------------------------------------------

def project(xyz, scales, quat, cam):
    """EWA projection. ``cam``: world_view and full_proj (row-vector form,
    4 x 4), tanfovx, tanfovy, height, width. Returns (mean2d, depth, conic,
    radius, valid)."""
    h, w = cam["height"], cam["width"]
    tx, ty = cam["tanfovx"], cam["tanfovy"]
    vm, pm = cam["world_view"], cam["full_proj"]
    hom = torch.cat([xyz, torch.ones_like(xyz[:, :1])], dim=1)
    pv = hom @ vm
    pp = hom @ pm
    tz = pv[:, 2]
    p_w = 1.0 / (pp[:, 3] + 1e-7)
    mean2d = torch.stack([((pp[:, 0] * p_w + 1.0) * w - 1.0) * 0.5,
                          ((pp[:, 1] * p_w + 1.0) * h - 1.0) * 0.5], dim=1)
    tzs = tz.clamp(min=1e-6)
    txtz = (pv[:, 0] / tzs).clamp(-1.3 * tx, 1.3 * tx)
    tytz = (pv[:, 1] / tzs).clamp(-1.3 * ty, 1.3 * ty)
    fx, fy = w / (2.0 * tx), h / (2.0 * ty)
    q = quat / torch.linalg.norm(quat, dim=-1, keepdim=True)
    r, qx, qy, qz = q.unbind(1)
    rot = torch.stack([
        torch.stack([1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - r * qz), 2 * (qx * qz + r * qy)], 1),
        torch.stack([2 * (qx * qy + r * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - r * qx)], 1),
        torch.stack([2 * (qx * qz - r * qy), 2 * (qy * qz + r * qx), 1 - 2 * (qx * qx + qy * qy)], 1),
    ], 1)
    m = rot * scales[:, None, :]
    sigma = m @ m.transpose(1, 2)
    zero = torch.zeros_like(tzs)
    jac = torch.stack([torch.stack([fx / tzs, zero, -fx * txtz / tzs], 1),
                       torch.stack([zero, fy / tzs, -fy * tytz / tzs], 1)], 1)
    t = jac @ vm[:3, :3].T[None]
    cov = t @ sigma @ t.transpose(1, 2)
    a = cov[:, 0, 0] + 0.3
    b = cov[:, 0, 1]
    c = cov[:, 1, 1] + 0.3
    det = a * c - b * b
    det_safe = torch.where(det > 0, det, torch.ones_like(det))
    conic = torch.stack([c / det_safe, -b / det_safe, a / det_safe], dim=1)
    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam))
    valid = (tz > 0.2) & (det > 0)
    return mean2d, tz, conic, torch.where(valid, radius, torch.zeros_like(radius)), valid


def _tiles_rgb(sel, tiles, tw, mean2d, conic, colors, opacity, bg):
    """Each listed tile's [256, 3] pixels from its slots ``sel`` [T, K]
    (-1 empty), and the pairs that add to them."""
    dev = mean2d.device
    valid = sel >= 0
    s = sel.clamp(min=0)
    gm, gc, gcol, gop = mean2d[s], conic[s], colors[s], opacity[s]
    p = torch.arange(TILE, dtype=torch.float32, device=dev)
    py, px = torch.meshgrid(p, p, indexing="ij")
    ox = ((tiles % tw) * TILE).float()[:, None] + px.reshape(1, -1)
    oy = ((tiles // tw) * TILE).float()[:, None] + py.reshape(1, -1)
    dx = ox[:, None, :] - gm[:, :, None, 0]
    dy = oy[:, None, :] - gm[:, :, None, 1]
    power = (-0.5 * (gc[:, :, None, 0] * dx * dx + gc[:, :, None, 2] * dy * dy)
             - gc[:, :, None, 1] * dx * dy).clamp(max=0.0)
    alpha = torch.clamp(gop[:, :, None] * torch.exp(power), max=0.99)
    alpha = torch.where(valid[:, :, None] & (alpha >= 1.0 / 255.0), alpha,
                        torch.zeros_like(alpha))
    t_in = torch.cumprod(1.0 - alpha, dim=1)
    t_ex = torch.cat([torch.ones_like(t_in[:, :1]), t_in[:, :-1]], dim=1)
    weight = torch.where(t_ex > 1e-4, alpha * t_ex, torch.zeros_like(alpha))
    rgb = torch.einsum("tkp,tkc->tpc", weight, gcol) + t_in[:, -1, :, None] * bg
    return rgb, int((weight > 0).sum())


def _to_image(rgb, h, w):
    th, tw = -(-h // TILE), -(-w // TILE)
    img = rgb.reshape(th, tw, TILE, TILE, 3).permute(0, 2, 1, 3, 4)
    return img.reshape(th * TILE, tw * TILE, 3)[:h, :w]


def _pairs(mean2d, r, alive, cell, ny, nx):
    """(cell index, splat) for every cell of a ``cell`` px grid that a
    splat's square [m - r, m + r] reaches."""
    ids = torch.nonzero(alive).flatten()
    mx, my, rr = mean2d[ids, 0], mean2d[ids, 1], r[ids]
    x0 = torch.floor((mx - rr) / cell).long().clamp(min=0)
    x1 = torch.floor((mx + rr) / cell).long().clamp(max=nx - 1)
    y0 = torch.floor((my - rr) / cell).long().clamp(min=0)
    y1 = torch.floor((my + rr) / cell).long().clamp(max=ny - 1)
    wx, wy = (x1 - x0 + 1).clamp(min=0), (y1 - y0 + 1).clamp(min=0)
    cnt = wx * wy
    who = torch.repeat_interleave(torch.arange(len(ids), device=ids.device), cnt)
    local = torch.arange(len(who), device=ids.device) - (torch.cumsum(cnt, 0) - cnt)[who]
    cx = x0[who] + local % wx[who]
    cy = y0[who] + local // wx[who]
    return cy * nx + cx, ids[who]


@torch.no_grad()
def render_inference(leaves, active, cam, style_f, bg, cfg, chunk=256):
    """An inference frame with no selection capacity: every splat that
    reaches a tile, front to back. Returns (image, live pairs, the
    (64 px block, splat) pairs a macro-block walk reads)."""
    opacity = torch.where(active, torch.sigmoid(leaves["opacity"])[:, 0],
                          torch.zeros_like(leaves["opacity"][:, 0]))
    sh = sh_coefficients(leaves, leaves["xyz"], style_f, cfg)
    d = leaves["xyz"] - cam["campos"][None]
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True).clamp(min=1e-8)
    colors = sh_to_rgb(sh, d)
    mean2d, depth, conic, radius, valid = project(leaves["xyz"], torch.exp(leaves["scaling"]),
                                                  leaves["rotation"], cam)
    h, w = cam["height"], cam["width"]
    th, tw = -(-h // TILE), -(-w // TILE)
    q_cut = 2.0 * torch.log(255.0 * opacity.clamp(min=1e-12))
    r = torch.ceil(radius * torch.sqrt(torch.clamp(q_cut / 9.0, 0.0, 1.0)))
    alive = valid & (opacity > 1.0 / 255.0) & (r > 0)
    bs = int(cfg["macro"]) * TILE
    blocks, _ = _pairs(mean2d, r, alive, bs, -(-h // bs), -(-w // bs))
    tile, who = _pairs(mean2d, r, alive, TILE, th, tw)
    order = torch.argsort(depth[who], stable=True)
    tile, who = tile[order], who[order]
    order = torch.argsort(tile, stable=True)
    tile, who = tile[order], who[order]
    counts = torch.bincount(tile, minlength=th * tw)
    rank = torch.arange(len(tile), device=tile.device) - (torch.cumsum(counts, 0) - counts)[tile]
    sel = torch.full((th * tw, max(int(counts.max()), 1)), -1, dtype=torch.long,
                     device=tile.device)
    sel[tile, rank] = who
    rgbs, live = [], 0
    for t0 in range(0, th * tw, chunk):
        tiles = torch.arange(t0, min(t0 + chunk, th * tw), device=tile.device)
        k = max(int(counts[tiles].max()), 1)
        rgb, n = _tiles_rgb(sel[tiles, :k], tiles, tw, mean2d, conic, colors, opacity, bg)
        rgbs.append(rgb)
        live += n
    return _to_image(torch.cat(rgbs), h, w), live, len(blocks)
