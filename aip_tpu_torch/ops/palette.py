"""Palette quantization for the pixel-art pipeline. Port of
``aip_tpu.ops.palette``.

Parity targets in `gui/second_page.py`:
* `_recolor_image` (:208-217) — nearest palette color by RGB distance, true
  distances (the reference subtracts two uint8 arrays, which wraps around;
  its kd-tree variant `:220-240` is overflow-free, and both agree here);
* `_recolor_image_LAB` (:242-264) — nearest by CIELAB distance (OpenCV 8-bit
  LAB convention);
* `_recolor_image_floyd` (:266-298) — Floyd-Steinberg error diffusion
  (7/16, 3/16, 5/16, 1/16) with nearest-RGB quantization;
* `_adjust_brightness_and_contrast` (:199-206) — additive brightness and a
  tan contrast curve.

The functions take tensors and run where the tensors lie. Palettes are
Lospec's, at most 16 colours, so the nearest-colour search is one [N, P]
distance product and an argmin (the first index on ties, as ``jnp.argmin``).
RGB distances are integers below 2^24 in float32, so ``recolor_rgb`` is exact
in any summation order; the LAB path rounds (no ``torch.cbrt``: the cube root
is a power, an ulp or two from ``jnp.cbrt``), so a near-tie can pick the other
colour.

Floyd-Steinberg is serial in pixel order, but pixel (y, x) depends only on
pixels with a smaller t = 2y + x: its left neighbour (t - 1) and the three
above it (t - 3, t - 2, t - 1). So an anti-diagonal wavefront quantizes
every pixel of one t at once, 2(H - 1) + W steps in all, and adds in the
JAX package's scan order: the error from above is ((e(x-1)/16 + e(x)*5/16) +
e(x+1)*3/16), the pixel (pix + above) + e_left*7/16, the distance (d0^2 +
d1^2) + d2^2, each operation rounded on its own (no fused multiply-add), on
the CPU and on the card alike. That equals the scan as written bit for bit.
XLA's CPU backend fuses some of those multiply-adds when it compiles the
scan, so at a rare near-tie the JAX package picks the other colour and the
dithering after it differs (one of 60 random 192x256 images with 16 random
colours; ROADMAP queue 3).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def adjust_brightness_contrast(img01: torch.Tensor, brightness: float,
                               contrast: float) -> torch.Tensor:
    """second_page.py:199-206 parity; img in [0,1]."""
    x = img01.to(torch.float32)
    if brightness != 0:
        x = x + brightness
    if contrast != 0:
        factor = float(np.tan((0.5 + contrast) * np.pi / 4))
        x = (x - 0.5) * factor + 0.5
    return torch.clamp(x, 0.0, 1.0)


def _nearest_indices(pixels: torch.Tensor, palette: torch.Tensor) -> torch.Tensor:
    """[N, 3] x [P, 3] -> [N] argmin of squared distance (matmul form; the
    per-row |x|^2 is constant and omitted)."""
    p2 = torch.sum(palette * palette, dim=-1)
    cross = pixels @ palette.T
    d2 = p2[None, :] - 2.0 * cross
    return torch.argmin(d2, dim=-1)


def recolor_rgb(img_u8: torch.Tensor, palette_u8: torch.Tensor) -> torch.Tensor:
    """Nearest palette color in RGB. [H, W, 3] uint8 + [P, 3] uint8."""
    h, w, _ = img_u8.shape
    idx = _nearest_indices(img_u8.reshape(-1, 3).to(torch.float32),
                           palette_u8.to(torch.float32))
    return palette_u8[idx].reshape(h, w, 3)


# OpenCV 8-bit CIELAB conversion (D65), for _recolor_image_LAB parity.
_RGB_TO_XYZ = ((0.412453, 0.357580, 0.180423),
               (0.212671, 0.715160, 0.072169),
               (0.019334, 0.119193, 0.950227))
WHITE_D65 = (0.950456, 1.0, 1.088754)


def _srgb_to_xyz(rgb01: torch.Tensor) -> torch.Tensor:
    r = rgb01
    lin = torch.where(r > 0.04045, ((r + 0.055) / 1.055) ** 2.4, r / 12.92)
    m = torch.tensor(_RGB_TO_XYZ, dtype=torch.float32, device=r.device)
    return lin @ m.T


def _lab_f(t: torch.Tensor) -> torch.Tensor:
    """CIELAB's f: the cube root above 0.008856 (a power on |t|: torch has
    no cbrt), the linear segment below."""
    return torch.where(t > 0.008856, torch.abs(t) ** (1.0 / 3.0), 7.787 * t + 16.0 / 116.0)


def xyz_to_lab(xyz: torch.Tensor) -> torch.Tensor:
    """XYZ -> float CIELAB (L in [0, 100], a and b signed), D65 white."""
    t = xyz / torch.tensor(WHITE_D65, dtype=torch.float32, device=xyz.device)
    f = _lab_f(t)
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    L = torch.where(t[..., 1] > 0.008856, 116.0 * fy - 16.0, 903.3 * t[..., 1])
    return torch.stack([L, 500.0 * (fx - fy), 200.0 * (fy - fz)], dim=-1)


def rgb_to_cielab_u8(rgb_u8: torch.Tensor) -> torch.Tensor:
    """uint8 RGB -> OpenCV-convention 8-bit CIELAB (L*255/100, a+128, b+128)."""
    lab = xyz_to_lab(_srgb_to_xyz(rgb_u8.to(torch.float32) / 255.0))
    L, a, b = lab[..., 0], lab[..., 1], lab[..., 2]
    return torch.stack([L * 255.0 / 100.0, a + 128.0, b + 128.0], dim=-1)


def recolor_lab(img_u8: torch.Tensor, palette_u8: torch.Tensor) -> torch.Tensor:
    """Nearest palette color by CIELAB distance (second_page.py:242-264)."""
    h, w, _ = img_u8.shape
    img_lab = rgb_to_cielab_u8(img_u8).reshape(-1, 3)
    pal_lab = rgb_to_cielab_u8(palette_u8)
    idx = _nearest_indices(img_lab, pal_lab)
    return palette_u8[idx].reshape(h, w, 3)


@functools.lru_cache(maxsize=16)
def _wavefront(h: int, w: int) -> tuple[np.ndarray, np.ndarray, tuple[int, ...]]:
    """The pixels of each anti-diagonal t = 2y + x, t = 0 .. 2(h-1) + w-1:
    rows and columns concatenated over t, and each step's pixel count."""
    ys, xs, counts = [], [], []
    for t in range(2 * (h - 1) + w):
        y = np.arange(max(0, (t - w + 2) // 2), min(h - 1, t // 2) + 1)
        ys.append(y)
        xs.append(t - 2 * y)
        counts.append(len(y))
    return np.concatenate(ys), np.concatenate(xs), tuple(counts)


def wavefront_steps(h: int, w: int) -> int:
    """Vectorised steps Floyd-Steinberg takes on an h x w image."""
    return len(_wavefront(h, w)[2])


def floyd_steinberg(img_u8: torch.Tensor, palette_u8: torch.Tensor) -> torch.Tensor:
    """Floyd-Steinberg dithering to a palette (second_page.py:266-298), one
    anti-diagonal of pixels a step, equal to the JAX package's row-by-row
    scan. [H, W, 3] uint8 + [P, 3] uint8 -> [H, W, 3] uint8."""
    h, w, _ = img_u8.shape
    dev = img_u8.device
    pal = palette_u8.to(torch.float32)
    img = img_u8.to(torch.float32)
    ys_np, xs_np, counts = _wavefront(h, w)
    ys_all = torch.from_numpy(ys_np).to(dev).split(counts)
    xs_all = torch.from_numpy(xs_np).to(dev).split(counts)
    # err[y + 1, x + 1] is pixel (y, x)'s quantization error; row 0 and
    # columns 0 and w + 1 stay zero, the missing neighbours at the borders.
    err = torch.zeros(h + 1, w + 2, 3, device=dev)
    out = torch.empty(h, w, 3, device=dev)
    for ys, xs in zip(ys_all, xs_all):
        above = (err[ys, xs] * (1.0 / 16.0) + err[ys, xs + 1] * (5.0 / 16.0)) \
            + err[ys, xs + 2] * (3.0 / 16.0)
        pix = (img[ys, xs] + above) + err[ys + 1, xs] * (7.0 / 16.0)
        d = pal[None] - pix[:, None]
        d = d * d
        d2 = (d[..., 0] + d[..., 1]) + d[..., 2]
        new = pal[torch.argmin(d2, dim=1)]
        err[ys + 1, xs + 1] = pix - new
        out[ys, xs] = new
    return torch.clamp(out, 0, 255).to(torch.uint8)
