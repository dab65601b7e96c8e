"""Dense optical flow and image warping on batched frames. Port of
``aip_tpu.ops.flow``.

The estimators (pyramidal Lucas-Kanade ``estimate_flow``, Zach-Pock-Bischof
TV-L1 ``estimate_flow_tvl1``, and Farneback through ``FLOW_METHODS``) take
frame batches [B, H, W, 3] in [0, 1] (or one [H, W, 3] frame) and return
flows [B, H, W, 2] (dx, dy) from frame1 to frame2, in
cv2.calcOpticalFlowFarneback's convention: frame1(x) = frame2(x + flow).
Fields inside are batched [B, H, W]; every frame pair of a call goes
through each pyramid level and warp as one batch (``aip_tpu`` maps the
pairs in chunks of 32 to work around a TPU gather fault).

TV-L1's inner loop is ``kernels.tvl1.tvl1_inner``: the hand-written CUDA
kernel on a CUDA tensor, its plain version on a CPU tensor.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# _grad_fwd and _div are aip_tpu.ops.flow's stencils too (equal to its
# roll-based forms for H, W >= 2); they live beside the kernel's plain version.
from aip_tpu_torch.device import fp32_convs
from aip_tpu_torch.kernels.tvl1 import _div, _grad_fwd, tvl1_inner  # noqa: F401
from aip_tpu_torch.ops.image import resize_bilinear


def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    """ITU-R BT.601 luma (cv2.COLOR_RGB2GRAY parity). [..., 3] -> [...]."""
    return 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]


def _conv2_same(x: torch.Tensor, k: np.ndarray) -> torch.Tensor:
    """Single-channel 2D cross-correlation of [B, H, W] with edge padding."""
    kh, kw = k.shape
    xp = F.pad(x[:, None], (kw // 2, kw // 2, kh // 2, kh // 2), mode="replicate")
    kern = torch.from_numpy(np.ascontiguousarray(k, np.float32)).to(x.device)
    with fp32_convs():
        return F.conv2d(xp, kern[None, None])[:, 0]


_GAUSS5 = (np.outer([1, 4, 6, 4, 1], [1, 4, 6, 4, 1]) / 256.0).astype(np.float32)
_KX = np.array([[-0.5, 0.0, 0.5]], np.float32)


def _downsample2(x: torch.Tensor) -> torch.Tensor:
    return _conv2_same(x, _GAUSS5)[:, ::2, ::2]


def _reflect_coords(ys, xs, h, w):
    def reflect(i, n):
        # cv2 BORDER_REFLECT duplicates the edge: indices ...2,1,0,0,1,2...
        # torch.remainder keeps jnp.mod's sign rule (torch.fmod would not).
        i = torch.abs(i)
        period = 2.0 * n
        i = torch.remainder(i, period)
        return torch.where(i > n - 1, period - 1 - i, i)

    return reflect(ys, h), reflect(xs, w)


def bilinear_sample(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Sample img [B, H, W] or [B, H, W, C] at float coordinates ys, xs
    [B, h, w] with a reflected border (cv2.remap INTER_LINEAR /
    BORDER_REFLECT parity). Returns [B, h, w] or [B, h, w, C].

    ``aip_tpu``'s TV-L1 warp samples its stacked [H, W, 3] fields with
    ``bilinear_sample_patch``, a TPU gather layout with the same values; the
    port samples the stacked fields with this one function."""
    h, w = img.shape[1], img.shape[2]
    chan = img.ndim == ys.ndim + 1
    yr, xr = _reflect_coords(ys, xs, h, w)
    y0 = torch.clamp(torch.floor(yr), 0, h - 1)
    x0 = torch.clamp(torch.floor(xr), 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    fy, fx = yr - y0, xr - x0
    if chan:
        fy, fx = fy[..., None], fx[..., None]
    b = torch.arange(img.shape[0], device=img.device).view(-1, *([1] * (ys.ndim - 1)))
    y0i, y1i, x0i, x1i = (t.long() for t in (y0, y1, x0, x1))
    v00 = img[b, y0i, x0i]
    v01 = img[b, y0i, x1i]
    v10 = img[b, y1i, x0i]
    v11 = img[b, y1i, x1i]
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    return top * (1 - fy) + bot * fy


def _grid(b: int, h: int, w: int, device):
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    return ys.expand(b, h, w), xs.expand(b, h, w)


def warp_image(image: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward-warp ``image`` [B, H, W, C] by ``flow`` [B, H, W, 2] (dx, dy),
    cv2.remap parity (reference ``video/utils.py:89-105``)."""
    ys, xs = _grid(image.shape[0], image.shape[1], image.shape[2], image.device)
    return bilinear_sample(image, ys + flow[..., 1], xs + flow[..., 0])


def blend_images(stylized: torch.Tensor, warped: torch.Tensor, alpha: float) -> torch.Tensor:
    """``video/utils.py:223-229`` parity: alpha*stylized + (1-alpha)*warped."""
    return torch.clamp(alpha * stylized + (1.0 - alpha) * warped, 0.0, 1.0)


def _batched(frame1, frame2):
    """[B, H, W, 3] pairs as float32 grays [B, H, W]; a single [H, W, 3]
    pair gets a batch of one (``squeeze`` says to drop it again)."""
    squeeze = frame1.ndim == 3
    if squeeze:
        frame1, frame2 = frame1[None], frame2[None]
    return rgb_to_gray(frame1.float()), rgb_to_gray(frame2.float()), squeeze


def _pyramid(g: torch.Tensor, levels: int) -> list:
    pyr = [g]
    for _ in range(levels - 1):
        pyr.append(_downsample2(pyr[-1]))
    return pyr


def _upsample_flow(flow: torch.Tensor, size) -> torch.Tensor:
    return resize_bilinear(flow, size) * 2.0


def _lk_refine(i0: torch.Tensor, i1: torch.Tensor, flow: torch.Tensor, win: int = 7,
               iters: int = 3) -> torch.Tensor:
    """Iterative dense Lucas-Kanade at one pyramid level: [B, H, W] grays,
    flow [B, H, W, 2]."""
    b, h, w = i0.shape
    box = np.ones((win, win), np.float32)
    ix = _conv2_same(i0, _KX)
    iy = _conv2_same(i0, _KX.T)
    ixx = _conv2_same(ix * ix, box)
    ixy = _conv2_same(ix * iy, box)
    iyy = _conv2_same(iy * iy, box)
    det = ixx * iyy - ixy * ixy
    # Scale-aware Tikhonov floor, as aip_tpu.
    eps = 1e-6 * (1.0 + ixx + iyy) ** 2 + 1e-12
    inv00 = iyy / (det + eps)
    inv01 = -ixy / (det + eps)
    inv11 = ixx / (det + eps)
    good = det > 1e-9
    ys, xs = _grid(b, h, w, i0.device)
    for _ in range(iters):
        i1w = bilinear_sample(i1, ys + flow[..., 1], xs + flow[..., 0])
        it = i1w - i0
        bx = _conv2_same(ix * it, box)
        by = _conv2_same(iy * it, box)
        du = -(inv00 * bx + inv01 * by)
        dv = -(inv01 * bx + inv11 * by)
        upd = torch.stack([torch.where(good, du, 0.0), torch.where(good, dv, 0.0)], dim=-1)
        flow = flow + torch.clamp(upd, -1.5, 1.5)
    return flow


@torch.no_grad()
def estimate_flow(frame1: torch.Tensor, frame2: torch.Tensor, levels: int = 4, win: int = 9,
                  iters: int = 6) -> torch.Tensor:
    """Coarse-to-fine pyramidal Lucas-Kanade flow frame1 -> frame2:
    [B, H, W, 3] (or [H, W, 3]) in [0, 1] -> [B, H, W, 2] (or [H, W, 2])."""
    g0, g1, squeeze = _batched(frame1, frame2)
    pyr0, pyr1 = _pyramid(g0, levels), _pyramid(g1, levels)
    flow = torch.zeros((*pyr0[-1].shape, 2), dtype=torch.float32, device=g0.device)
    for lvl in range(levels - 1, -1, -1):
        flow = _lk_refine(pyr0[lvl], pyr1[lvl], flow, win, iters)
        if lvl > 0:
            flow = _upsample_flow(flow, tuple(pyr0[lvl - 1].shape[1:]))
    return flow[0] if squeeze else flow


# ---------------------------------------------------------------------------
# TV-L1 (Zach-Pock-Bischof), the reference's DualTVL1 default
# (`video/utils.py:75-86`). Per warp, a pointwise thresholding step on the
# linearised data term and a Chambolle dual ascent for the TV prior; the
# inner loop is one tvl1_inner call per (level, warp).
# ---------------------------------------------------------------------------

def _tvl1_level(i0, i1, flow, warps, iters, lam, theta, tau):
    """One pyramid level for [B, H, W] grays from the flow [B, H, W, 2]."""
    b, h, w = i0.shape
    ys, xs = _grid(b, h, w, i0.device)
    fields = torch.stack([i1, _conv2_same(i1, _KX), _conv2_same(i1, _KX.T)], dim=-1)
    l_t = lam * theta
    taut = tau / theta
    u1, u2 = flow[..., 0].contiguous(), flow[..., 1].contiguous()
    zeros = torch.zeros_like(i0)
    p = (zeros, zeros, zeros, zeros)
    for _ in range(warps):
        sampled = bilinear_sample(fields, ys + u2, xs + u1)
        i1w = sampled[..., 0]
        i1wx = sampled[..., 1].contiguous()
        i1wy = sampled[..., 2].contiguous()
        grad2 = i1wx * i1wx + i1wy * i1wy
        rho_c = i1w - i1wx * u1 - i1wy * u2 - i0
        u1, u2, p = tvl1_inner(rho_c, i1wx, i1wy, grad2, u1, u2, p, iters, l_t, theta, taut)
    return torch.stack([u1, u2], dim=-1)


@torch.no_grad()
def estimate_flow_tvl1(frame1: torch.Tensor, frame2: torch.Tensor, levels: int = 4,
                       warps: int = 5, iters: int = 300, lam: float = 0.15, theta: float = 0.3,
                       tau: float = 0.25) -> torch.Tensor:
    """DualTVL1-style dense flow frame1 -> frame2: [B, H, W, 3] (or
    [H, W, 3]) in [0, 1] -> [B, H, W, 2] (or [H, W, 2]). cv2 DualTVL1's
    defaults (lambda 0.15, theta 0.3, tau 0.25, 5 warps, 300 iterations),
    fixed trip counts, no median filter, as ``aip_tpu``."""
    g0, g1, squeeze = _batched(frame1, frame2)
    pyr0, pyr1 = _pyramid(g0, levels), _pyramid(g1, levels)
    flow = torch.zeros((*pyr0[-1].shape, 2), dtype=torch.float32, device=g0.device)
    for lvl in range(levels - 1, -1, -1):
        flow = _tvl1_level(pyr0[lvl], pyr1[lvl], flow, warps, iters, lam, theta, tau)
        if lvl > 0:
            flow = _upsample_flow(flow, tuple(pyr0[lvl - 1].shape[1:]))
    return flow[0] if squeeze else flow


def _farneback(frame1, frame2, **kw):
    from aip_tpu_torch.ops.farneback import estimate_flow_farneback

    return estimate_flow_farneback(frame1, frame2, **kw)


FLOW_METHODS = {"lk": estimate_flow, "tvl1": estimate_flow_tvl1, "farneback": _farneback}


def estimate_flow_method(frame1, frame2, method: str = "farneback", **kw):
    """Dispatch on the flow algorithm (`video/utils.py:75-86`'s
    Farneback-vs-DualTVL1 switch, plus pyramidal LK)."""
    return FLOW_METHODS[method](frame1, frame2, **kw)
