"""Image resize / pad / crop ops with torch-reference semantics (NHWC).

Port of ``aip_tpu.ops.image``. Three resize semantics are kept apart, as
in the reference:

* torchvision ``Resize(size)``: antialiased bilinear on the smaller edge;
* ``F.interpolate(mode='bilinear'|'bicubic', align_corners=False)``:
  half-pixel centres, no antialias;
* ``F.interpolate(mode='nearest')``: the legacy ``floor(dst * in / out)``
  index rule, computed in float32 as ATen does.

The bilinear and bicubic resizes are two dense products with resampling
matrices built in float64 on the host and applied in full float32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from aip_tpu_torch.device import fp32_convs


# ---------------------------------------------------------------------------
# Resize weight matrices (host-side numpy, cached per shape)
# ---------------------------------------------------------------------------

def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys cubic convolution kernel; a=-0.75 matches torch's bicubic."""
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    return np.where(
        ax <= 1.0,
        (a + 2.0) * ax3 - (a + 3.0) * ax2 + 1.0,
        np.where(ax < 2.0, a * ax3 - 5.0 * a * ax2 + 8.0 * a * ax - 4.0 * a, 0.0),
    )


@functools.lru_cache(maxsize=256)
def _bicubic_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Dense [n_out, n_in] resampling matrix for align_corners=False bicubic."""
    scale = n_in / n_out
    i = np.arange(n_out, dtype=np.float64)
    x = (i + 0.5) * scale - 0.5
    x0 = np.floor(x)
    t = x - x0
    mat = np.zeros((n_out, n_in), dtype=np.float32)
    for k in range(-1, 3):
        w = _cubic_kernel(t - k)
        idx = np.clip(x0.astype(np.int64) + k, 0, n_in - 1)
        np.add.at(mat, (np.arange(n_out), idx), w.astype(np.float32))
    return mat


@functools.lru_cache(maxsize=256)
def _bilinear_matrix(n_in: int, n_out: int, antialias: bool) -> np.ndarray:
    """Dense [n_out, n_in] matrix for align_corners=False (antialiased) linear."""
    scale = n_in / n_out
    support = max(scale, 1.0) if antialias else 1.0
    i = np.arange(n_out, dtype=np.float64)
    x = (i + 0.5) * scale - 0.5
    lo = np.floor(x - support).astype(np.int64)
    taps = int(np.ceil(2 * support)) + 2
    mat = np.zeros((n_out, n_in), dtype=np.float64)
    for k in range(taps):
        idx = lo + k
        d = (x - idx) / (support if antialias else 1.0)
        w = np.maximum(0.0, 1.0 - np.abs(d))
        np.add.at(mat, (np.arange(n_out), np.clip(idx, 0, n_in - 1)), w)
    mat /= mat.sum(axis=1, keepdims=True)
    return mat.astype(np.float32)


@functools.lru_cache(maxsize=256)
def _bilinear_matrix_ac(n_in: int, n_out: int) -> np.ndarray:
    """Dense [n_out, n_in] matrix for ``align_corners=True`` bilinear."""
    i = np.arange(n_out, dtype=np.float64)
    x = i * ((n_in - 1) / (n_out - 1)) if n_out > 1 else np.zeros(1)
    x0 = np.clip(np.floor(x).astype(np.int64), 0, n_in - 1)
    x1 = np.clip(x0 + 1, 0, n_in - 1)
    t = x - x0
    mat = np.zeros((n_out, n_in), dtype=np.float64)
    np.add.at(mat, (np.arange(n_out), x0), 1.0 - t)
    np.add.at(mat, (np.arange(n_out), x1), t)
    return mat.astype(np.float32)


def _apply_separable(x: torch.Tensor, mh: np.ndarray, mw: np.ndarray) -> torch.Tensor:
    """Apply per-axis resize matrices to NHWC as two full-float32 products."""
    wh = torch.from_numpy(mh).to(x.device)
    ww = torch.from_numpy(mw).to(x.device)
    y = x.float()
    y = torch.einsum("oh,nhwc->nowc", wh, y)
    y = torch.einsum("ow,nhwc->nhoc", ww, y)
    return y.to(x.dtype)


def _ensure_nhwc(x: torch.Tensor):
    if x.ndim == 3:
        return x[None], True
    return x, False


def resize_bicubic(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """``F.interpolate(mode='bicubic', align_corners=False)`` parity
    (a=-0.75, border-clamped). NHWC or HWC."""
    x, squeeze = _ensure_nhwc(x)
    out = _apply_separable(x, _bicubic_matrix(x.shape[1], size[0]),
                           _bicubic_matrix(x.shape[2], size[1]))
    return out[0] if squeeze else out


def resize_bilinear(x: torch.Tensor, size: tuple[int, int], antialias: bool = False,
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize: ``F.interpolate(mode='bilinear')`` parity
    (antialias=False), torchvision/PIL ``Resize`` parity (antialias=True),
    or torch's ``align_corners=True`` rule. NHWC or HWC."""
    x, squeeze = _ensure_nhwc(x)
    h, w = x.shape[1], x.shape[2]
    if align_corners:
        mh, mw = _bilinear_matrix_ac(h, size[0]), _bilinear_matrix_ac(w, size[1])
    else:
        mh = _bilinear_matrix(h, size[0], antialias)
        mw = _bilinear_matrix(w, size[1], antialias)
    out = _apply_separable(x, mh, mw)
    return out[0] if squeeze else out


def _nearest_src_idx(n_in: int, n_out: int) -> np.ndarray:
    # float32 on purpose: ATen computes floorf(dst * (float)in / out), and
    # exact-integer products (341 * 400/682 = 200) land one source pixel
    # differently under float64.
    scale = np.float32(n_in) / np.float32(n_out)
    i = np.floor(np.arange(n_out, dtype=np.float32) * scale)
    return np.minimum(i.astype(np.int64), n_in - 1)


def resize_nearest(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Nearest resize with torch's legacy rule ``src = floor(dst*in/out)``."""
    x, squeeze = _ensure_nhwc(x)
    ih = torch.from_numpy(_nearest_src_idx(x.shape[1], size[0])).to(x.device)
    iw = torch.from_numpy(_nearest_src_idx(x.shape[2], size[1])).to(x.device)
    out = x.index_select(1, ih).index_select(2, iw)
    return out[0] if squeeze else out


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """``nn.Upsample(scale_factor=2, mode='nearest')`` on NHWC."""
    n, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c).reshape(n, 2 * h, 2 * w, c)


def smaller_edge_size(h: int, w: int, size: int) -> tuple[int, int]:
    """torchvision ``Resize(int)`` output size; the long edge is TRUNCATED."""
    if h <= w:
        return size, max(1, int(size * w / h))
    return max(1, int(size * h / w)), size


def resize_smaller_edge(x: torch.Tensor, size: int) -> torch.Tensor:
    """torchvision ``Resize(size)``: smaller edge to ``size``, antialiased."""
    x, squeeze = _ensure_nhwc(x)
    oh, ow = smaller_edge_size(x.shape[1], x.shape[2], size)
    out = resize_bilinear(x, (oh, ow), antialias=True)
    return out[0] if squeeze else out


def center_crop(x: torch.Tensor, size: int) -> torch.Tensor:
    """torchvision ``CenterCrop(size)`` on NHWC/HWC."""
    x, squeeze = _ensure_nhwc(x)
    top = max(0, (x.shape[1] - size) // 2)
    left = max(0, (x.shape[2] - size) // 2)
    out = x[:, top:top + size, left:left + size, :]
    return out[0] if squeeze else out


# ---------------------------------------------------------------------------
# Padding / pooling
# ---------------------------------------------------------------------------

def reflection_pad_2d(x: torch.Tensor, pad: int = 1) -> torch.Tensor:
    """``ReflectionPad2d`` on NHWC (reflect without repeating the edge)."""
    y = F.pad(x.permute(0, 3, 1, 2), (pad, pad, pad, pad), mode="reflect")
    return y.permute(0, 2, 3, 1)


def reflect_conv3x3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None
                    ) -> torch.Tensor:
    """3x3 stride-1 conv over a reflection-padded NHWC input without making
    the padded copy. ``w`` is OIHW ``[Cout, Cin, 3, 3]`` (``nn.Conv2d``).

    The JAX package's form (``aip_tpu/ops/image.py:218-283``): a zero-padded
    SAME conv is exact in the interior, and the taps the zero pad dropped on
    the 1-px border are added back as four strip convolutions. With
    reflection x[-1] == x[1] and x[h] == x[h-2]:

    * output row 0 misses the kernel-row-0 taps, which read input row 1
      (reflected along the width at the corners): a width-wise 3-tap conv of
      row 1 against ``w[..., 0, :]``; row h-1 likewise reads row h-2
      against ``w[..., 2, :]``;
    * output column 0 misses the kernel-column-0 taps of the rows inside
      the image (the corners are in the row strips): a height-wise 3-tap conv
      of column 1 with zero row padding; column wd-1 likewise.

    The strips are added into the output's border rows and columns in place
    (eager PyTorch has no fusion to make full-size padded strips free). The
    convs run under ``fp32_convs``."""
    n, h, wd, c = x.shape
    t = x.permute(0, 3, 1, 2)
    with fp32_convs():
        y = F.conv2d(t, w, padding=1)
        top = F.conv2d(F.pad(t[:, :, 1:2], (1, 1, 0, 0), mode="reflect"), w[:, :, 0:1])
        bot = F.conv2d(F.pad(t[:, :, h - 2:h - 1], (1, 1, 0, 0), mode="reflect"),
                       w[:, :, 2:3])
        lef = F.conv2d(t[:, :, :, 1:2], w[:, :, :, 0:1], padding=(1, 0))
        rig = F.conv2d(t[:, :, :, wd - 2:wd - 1], w[:, :, :, 2:3], padding=(1, 0))
    y[:, :, 0:1] += top
    y[:, :, h - 1:h] += bot
    y[:, :, :, 0:1] += lef
    y[:, :, :, wd - 1:wd] += rig
    if b is not None:
        y = y + b[:, None, None]
    return y.permute(0, 2, 3, 1)


def max_pool_2x2_ceil(x: torch.Tensor) -> torch.Tensor:
    """``MaxPool2d(2, 2, ceil_mode=True)`` on NHWC (odd sizes keep the
    partial last window)."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2, ceil_mode=True)
    return y.permute(0, 2, 3, 1)
