"""Farneback dense optical flow (polynomial expansion) on batched frames.
Port of ``aip_tpu.ops.farneback``, itself a from-the-paper implementation
(Farneback 2003) that follows OpenCV's algorithmic choices
(``cv2.calcOpticalFlowFarneback(g1, g2, None, 0.5, 5, 15, 3, 7, 1.5, 0)``,
the reference's ``video/utils.py:79-81``):

* polynomial expansion: a Gaussian-weighted least-squares quadratic fit
  over a (2n+1)^2 window, as six separable correlations and four scalars
  of the inverted 6x6 Gram matrix;
* displacement update: ``A = (A1 + warp(A2)) / 2``,
  ``db = (b1 - warp(b2)) / 2 + A d``, ``G = A^T A`` and ``h = A db`` box
  averaged over ``winsize``, a 2x2 solve per pixel with OpenCV's ``+1e-3``
  determinant damping, matrices recomputed between iterations;
* OpenCV's 5-px border damping ramp on the update matrices;
* a pyramid of Gaussian-presmoothed bilinear resizes of the original frames.

Fields are [B, H, W] or [B, H, W, C]; every frame pair of a call runs as
one batch. Plain PyTorch: ``aip_tpu`` has no Pallas kernel here.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from aip_tpu_torch.device import fp32_convs
from aip_tpu_torch.ops.flow import _batched
from aip_tpu_torch.ops.image import resize_bilinear


@functools.cache
def _prepare_gaussian(n: int, sigma: float):
    """OpenCV FarnebackPrepareGaussian: the weight kernels and the four
    independent entries of the inverted basis Gram matrix."""
    if sigma < 1e-6:
        sigma = n * 0.3
    k = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(k * k) / (2.0 * sigma * sigma))
    g /= g.sum()
    xg = k * g
    xxg = k * k * g
    gram = np.zeros((6, 6))
    for y in k.astype(int):
        for x in k.astype(int):
            wgt = g[y + n] * g[x + n]
            basis = np.array([1.0, x, y, x * x, y * y, x * y])
            gram += wgt * np.outer(basis, basis)
    inv = np.linalg.inv(gram)
    return g, xg, xxg, float(inv[1, 1]), float(inv[0, 3]), float(inv[3, 3]), float(inv[5, 5])


def _corr1d(x: torch.Tensor, kernel: np.ndarray, axis: int) -> torch.Tensor:
    """Correlation of [B, H, W] along axis 1 (rows) or 2 (columns) with a
    replicated border; kernel ordered k = -n..n."""
    n = len(kernel) // 2
    k = torch.from_numpy(np.asarray(kernel, np.float32)).to(device=x.device, dtype=x.dtype)
    if axis == 1:
        xp = F.pad(x[:, None], (0, 0, n, n), mode="replicate")
        kern = k.view(1, 1, -1, 1)
    else:
        xp = F.pad(x[:, None], (n, n, 0, 0), mode="replicate")
        kern = k.view(1, 1, 1, -1)
    with fp32_convs():
        return F.conv2d(xp, kern)[:, 0]


def poly_expansion(img: torch.Tensor, n: int, sigma: float) -> torch.Tensor:
    """[B, H, W] -> [B, H, W, 5] per-pixel quadratic fit (b1, b2, a11, a22,
    2*a12), OpenCV's channel convention."""
    g, xg, xxg, ig11, ig03, ig33, ig55 = _prepare_gaussian(n, sigma)
    v0 = _corr1d(img, g, 1)
    v1 = _corr1d(img, xg, 1)
    v2 = _corr1d(img, xxg, 1)
    p1 = _corr1d(v0, g, 2)
    px = _corr1d(v0, xg, 2)
    py = _corr1d(v1, g, 2)
    pxx = _corr1d(v0, xxg, 2)
    pyy = _corr1d(v2, g, 2)
    pxy = _corr1d(v1, xg, 2)
    b1 = ig11 * px
    b2 = ig11 * py
    a11 = ig33 * pxx + ig03 * p1
    a22 = ig33 * pyy + ig03 * p1
    axy = ig55 * pxy
    return torch.stack([b1, b2, a11, a22, axy], dim=-1)


def _border_scale(h: int, w: int) -> np.ndarray:
    """OpenCV's 5-px border damping ramp for the update matrices."""
    ramp = np.array([0.14, 0.14, 0.4472, 0.4472, 0.4472], np.float32)
    sy = np.ones(h, np.float32)
    sx = np.ones(w, np.float32)
    m = min(5, (h + 1) // 2)
    sy[:m] = ramp[:m]
    sy[h - m:] = ramp[:m][::-1]
    m = min(5, (w + 1) // 2)
    sx[:m] = ramp[:m]
    sx[w - m:] = ramp[:m][::-1]
    return sy[:, None] * sx[None, :]


def _bilinear5(r: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of the [B, H, W, 5] expansion at (ys, xs), clamped."""
    h, w = r.shape[1], r.shape[2]
    ys = torch.clamp(ys, 0.0, h - 1.0)
    xs = torch.clamp(xs, 0.0, w - 1.0)
    y0 = torch.clamp(torch.floor(ys), 0, h - 2).long()
    x0 = torch.clamp(torch.floor(xs), 0, w - 2).long()
    fy = (ys - y0)[..., None]
    fx = (xs - x0)[..., None]
    b = torch.arange(r.shape[0], device=r.device).view(-1, 1, 1)
    v00 = r[b, y0, x0]
    v01 = r[b, y0, x0 + 1]
    v10 = r[b, y0 + 1, x0]
    v11 = r[b, y0 + 1, x0 + 1]
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    return top * (1 - fy) + bot * fy


def _update_matrices(r0, r1, flow, border) -> torch.Tensor:
    """FarnebackUpdateMatrices: [B, H, W, 5] (g11, g12, g22, h1, h2)."""
    b, h, w = flow.shape[:3]
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=flow.device),
                            torch.arange(w, dtype=torch.float32, device=flow.device),
                            indexing="ij")
    dx = flow[..., 0]
    dy = flow[..., 1]
    r1w = _bilinear5(r1, ys + dy, xs + dx)
    r4 = (r0[..., 2] + r1w[..., 2]) * 0.5
    r5 = (r0[..., 3] + r1w[..., 3]) * 0.5
    r6 = (r0[..., 4] + r1w[..., 4]) * 0.25   # the channel stores 2*a12
    r2 = (r0[..., 0] - r1w[..., 0]) * 0.5 + r4 * dx + r6 * dy
    r3 = (r0[..., 1] - r1w[..., 1]) * 0.5 + r6 * dx + r5 * dy
    r2, r3, r4, r5, r6 = (t * border for t in (r2, r3, r4, r5, r6))
    return torch.stack([
        r4 * r4 + r6 * r6,        # g11
        (r4 + r5) * r6,           # g12
        r5 * r5 + r6 * r6,        # g22
        r4 * r2 + r6 * r3,        # h1
        r6 * r2 + r5 * r3,        # h2
    ], dim=-1)


def _box_blur(m: torch.Tensor, winsize: int) -> torch.Tensor:
    """Normalised box filter over [B, H, W, C] with a replicated border."""
    n = winsize // 2
    ones = np.ones(2 * n + 1, np.float32) / (2 * n + 1)
    b, h, w, c = m.shape
    flat = m.permute(0, 3, 1, 2).reshape(b * c, h, w)
    out = _corr1d(_corr1d(flat, ones, 1), ones, 2)
    return out.reshape(b, c, h, w).permute(0, 2, 3, 1)


def _solve_flow(m: torch.Tensor) -> torch.Tensor:
    g11, g12, g22, h1, h2 = m.unbind(-1)
    idet = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    return torch.stack([(g22 * h1 - g12 * h2) * idet, (g11 * h2 - g12 * h1) * idet], dim=-1)


def _gaussian_blur(x: torch.Tensor, sigma: float) -> torch.Tensor:
    if sigma <= 0:
        return x
    # OpenCV: smooth_sz = round(sigma*5) | 1, at least 3.
    sz = max(int(round(sigma * 5)) | 1, 3)
    n = sz // 2
    k = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(k * k) / (2.0 * sigma * sigma))
    g /= g.sum()
    return _corr1d(_corr1d(x, g, 1), g, 2)


def _resize_field(x: torch.Tensor, size) -> torch.Tensor:
    return resize_bilinear(x[..., None], size)[..., 0]


@torch.no_grad()
def estimate_flow_farneback(frame1: torch.Tensor, frame2: torch.Tensor, pyr_scale: float = 0.5,
                            levels: int = 5, winsize: int = 15, iterations: int = 3,
                            poly_n: int = 7, poly_sigma: float = 1.5) -> torch.Tensor:
    """Dense flow frame1 -> frame2: [B, H, W, 3] (or [H, W, 3]) -> [B, H, W, 2]
    (or [H, W, 2]), (dx, dy). Defaults are the reference's cv2 call."""
    float_in = frame1.dtype.is_floating_point
    g0, g1, squeeze = _batched(frame1, frame2)
    if float_in:
        # cv2 works on 0..255 grays; its +1e-3 damping is tuned for that range.
        g0 = g0 * 255.0
        g1 = g1 * 255.0
    h, w = g0.shape[1:]
    # OpenCV's level clamp: stop before a level side drops under 32 px.
    n_levels = 0
    scale = 1.0
    for _ in range(levels):
        if min(h, w) * scale * pyr_scale < 32:
            break
        scale *= pyr_scale
        n_levels += 1

    flow = None
    for k in range(n_levels, -1, -1):
        scale = pyr_scale ** k
        lh, lw = int(round(h * scale)), int(round(w * scale))
        sigma = (1.0 / scale - 1.0) * 0.5
        i0 = _resize_field(_gaussian_blur(g0, sigma), (lh, lw))
        i1 = _resize_field(_gaussian_blur(g1, sigma), (lh, lw))
        if flow is None:
            flow = torch.zeros((g0.shape[0], lh, lw, 2), dtype=torch.float32, device=g0.device)
        else:
            flow = resize_bilinear(flow, (lh, lw)) * (1.0 / pyr_scale)
        r0 = poly_expansion(i0, poly_n, poly_sigma)
        r1 = poly_expansion(i1, poly_n, poly_sigma)
        border = torch.from_numpy(_border_scale(lh, lw)).to(g0.device)
        m = _update_matrices(r0, r1, flow, border)
        for i in range(iterations):
            flow = _solve_flow(_box_blur(m, winsize))
            if i < iterations - 1:
                m = _update_matrices(r0, r1, flow, border)
    return flow[0] if squeeze else flow
