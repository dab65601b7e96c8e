"""Monocular proximity estimation for depth-aware stylisation. Port of
``aip_tpu.models.depthnet``.

``estimate_proximity`` is the classical fallback (smoothed gradient energy
plus a vertical position prior); ``register_depth_model`` installs a
learned estimator in its place.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from aip_tpu_torch.device import resolve_device

_REGISTERED = None


def register_depth_model(fn) -> None:
    """Install a learned depth estimator: fn(img_hwc_float01) -> [H, W]."""
    global _REGISTERED
    _REGISTERED = fn


def _window_sum(p: torch.Tensor, k: int, dim: int) -> torch.Tensor:
    """out[j] = p[j] + ... + p[j + k - 1] along ``dim``, in a fixed order:
    sums of 2^m neighbours by doubling, then the blocks of k's set bits from
    the lowest. Plain adds of slices, so the card and the CPU round alike,
    in about 2 log2(k) operations."""
    n = p.shape[dim] - k + 1
    acc, off, size, block = None, 0, 1, p
    while k:
        if k & 1:
            part = block.narrow(dim, off, n)
            acc = part if acc is None else acc + part
            off += size
        k >>= 1
        if k:
            m = block.shape[dim] - size
            block = block.narrow(dim, 0, m) + block.narrow(dim, size, m)
            size *= 2
    return acc


def _box_blur(x: torch.Tensor, k: int) -> torch.Tensor:
    """Separable k-tap box blur of [H, W] with edge padding. No convolution:
    cuDNN picks a conv's algorithm per call site and state, and the proxy
    divides by the blur's range, which magnifies any difference in rounding
    (a card test once read 2.24e-5 from the CPU against its 1e-5 gate)."""
    pad = k // 2
    y = F.pad(x[None, None], (pad, pad, pad, pad), mode="replicate")[0, 0]
    y = _window_sum(y * (1.0 / k), k, 1)
    return _window_sum(y * (1.0 / k), k, 0)


def _proximity_core(img: torch.Tensor) -> torch.Tensor:
    lum = 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
    h, w = lum.shape
    # Sharpness cue: local gradient energy, smoothed.
    gx = torch.diff(lum, dim=1, append=lum[:, -1:])
    gy = torch.diff(lum, dim=0, append=lum[-1:, :])
    grad = torch.sqrt(gx * gx + gy * gy)
    sharp = _box_blur(grad, max(3, min(h, w) // 16 * 2 + 1))
    sharp = (sharp - sharp.min()) / (sharp.max() - sharp.min() + 1e-8)
    # Vertical prior: near content sits low in the frame.
    vert = torch.linspace(0.0, 1.0, h, device=img.device)[:, None].expand(h, w)
    return 0.6 * sharp + 0.4 * vert


def estimate_proximity(img, device=None) -> torch.Tensor:
    """img: HWC float [0,1] or uint8 (numpy or tensor) -> [H, W] proximity
    (big = close). A tensor stays on its device; a numpy array goes to
    ``device`` (None means CUDA)."""
    if _REGISTERED is not None:
        return _REGISTERED(img)
    if isinstance(img, torch.Tensor):
        x = img
    else:
        x = torch.from_numpy(np.ascontiguousarray(img)).to(resolve_device(device))
    if x.dtype == torch.uint8:
        x = x.float() / 255.0
    if x.ndim == 2:
        x = torch.stack([x] * 3, dim=-1)
    if x.shape[-1] == 4:
        x = x[..., :3]
    return _proximity_core(x.float())
