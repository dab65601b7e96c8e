"""Image quality metrics: L1 / L2 / MSE / PSNR / SSIM.

Port of ``aip_tpu/ops/metrics.py`` (reference ``utils/image_utils.py:14-19``
and ``utils/loss_utils.py:17-63``): NHWC float images in [0, 1]; SSIM with
an 11x11 Gaussian window (sigma 1.5), zero padding at the borders,
C1 = 0.01^2, C2 = 0.03^2.

The 2D window is the outer product of a normalised 1D Gaussian, so the
depthwise filter is applied as two banded-matrix products, one along H and
one along W (zero padding is the band's truncation at the edges). A float32
matrix product runs in full float32 on the card by default, where a float32
convolution goes through cuDNN in TF32; SSIM's variance terms are the
cancelling E[x^2] - E[x]^2 and need the full precision (the JAX package
forces ``precision=HIGHEST`` for the same reason).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def l1_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(x - y))


def l2_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean((x - y) ** 2)


def mse(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Per-image MSE: [N, H, W, C] -> [N, 1]."""
    d = (img1 - img2).reshape(img1.shape[0], -1)
    return torch.mean(d ** 2, dim=1, keepdim=True)


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Per-image PSNR (data range 1.0): [N, H, W, C] -> [N, 1]."""
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse(img1, img2)))


@functools.lru_cache(maxsize=8)
def _gaussian_1d(window_size: int, sigma: float) -> np.ndarray:
    """The normalised 1D factor of the JAX package's 2D window."""
    x = np.arange(window_size, dtype=np.float64)
    g = np.exp(-((x - window_size // 2) ** 2) / (2.0 * sigma ** 2))
    return g / g.sum()


@functools.lru_cache(maxsize=16)
def _band_matrix(n: int, window_size: int, sigma: float) -> np.ndarray:
    """[n, n] matrix M with (M @ v)[i] = sum_k g[k] v[i + k - r], zero
    outside [0, n): the 1D filter with zero padding."""
    g = _gaussian_1d(window_size, sigma)
    r = window_size // 2
    m = np.zeros((n, n), np.float64)
    for k in range(window_size):
        off = k - r
        i = np.arange(max(0, -off), min(n, n - off))
        m[i, i + off] = g[k]
    return m.astype(np.float32)


def _filter(x: torch.Tensor, mh: torch.Tensor, mw: torch.Tensor) -> torch.Tensor:
    """Zero-padded separable Gaussian filter of [N, H, W, C]."""
    t = torch.einsum("ij,njwc->niwc", mh, x)
    return torch.einsum("kw,nhwc->nhkc", mw, t)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM over the batch, 3DGS-style (zero padding at borders)."""
    if img1.ndim == 3:
        img1, img2 = img1[None], img2[None]
    x = img1.to(torch.float32)
    y = img2.to(torch.float32)
    h, w = x.shape[1], x.shape[2]
    mh = torch.from_numpy(_band_matrix(h, window_size, sigma)).to(x.device)
    mw = torch.from_numpy(_band_matrix(w, window_size, sigma)).to(x.device)

    mu1 = _filter(x, mh, mw)
    mu2 = _filter(y, mh, mw)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _filter(x * x, mh, mw) - mu1_sq
    sigma2_sq = _filter(y * y, mh, mw) - mu2_sq
    sigma12 = _filter(x * y, mh, mw) - mu12

    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu12 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return torch.mean(ssim_map)
