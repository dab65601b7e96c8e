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

from aip_tpu_torch.device import fp32_convs, resolve_device

_REGISTERED = None


def register_depth_model(fn) -> None:
    """Install a learned depth estimator: fn(img_hwc_float01) -> [H, W]."""
    global _REGISTERED
    _REGISTERED = fn


def _box_blur(x: torch.Tensor, k: int) -> torch.Tensor:
    """Separable k-tap box blur of [H, W] with edge padding."""
    pad = k // 2
    y = F.pad(x[None, None], (pad, pad, pad, pad), mode="replicate")
    kernel = torch.full((1, 1, 1, k), 1.0 / k, dtype=torch.float32, device=x.device)
    with fp32_convs():
        y = F.conv2d(y, kernel)
        y = F.conv2d(y, kernel.transpose(2, 3))
    return y[0, 0]


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
