"""Foreground/background segmentation for regional style transfer.
Port of ``aip_tpu.models.segmenter``.

The reference uses torchvision's pretrained DeepLabV3-ResNet101 and takes
"background" = P(class 0) > 0.5 (`localized_style_transfer.py:171-188`).
Those weights can't ship here, so this module mirrors the depthnet pattern:

* ``extract_background_mask`` — default classical estimator: border-seeded
  color model. Border pixels are presumed background; each pixel's
  background probability falls with Mahalanobis distance to the border color
  distribution (``background_probability``).
* ``register_segmenter`` — hook for a learned model (same contract: returns
  a [H, W] {0,1} background mask), e.g. ``deeplab.make_background_segmenter``.

The mask is the step ``background_probability > threshold``: a card and a
CPU can differ only at pixels whose probability lies within rounding of the
threshold.
"""

from __future__ import annotations

import numpy as np
import torch

from aip_tpu_torch.device import resolve_device

_REGISTERED = None


def register_segmenter(fn) -> None:
    """fn(img_hwc_float01) -> [H, W] background mask in {0,1}."""
    global _REGISTERED
    _REGISTERED = fn


def background_probability(img: torch.Tensor) -> torch.Tensor:
    """[H, W, 3] float RGB -> [H, W] background probability from the border
    colour model (a band of max(2, min(h, w) // 16) px)."""
    h, w, _ = img.shape
    bw = max(2, min(h, w) // 16)

    mask = torch.zeros((h, w), dtype=torch.float32, device=img.device)
    mask[:bw, :] = 1.0
    mask[-bw:, :] = 1.0
    mask[:, :bw] = 1.0
    mask[:, -bw:] = 1.0

    flat = img.reshape(-1, 3).to(torch.float32)
    wgt = mask.reshape(-1)
    n = torch.sum(wgt)
    mean = torch.sum(flat * wgt[:, None], dim=0) / n
    xc = (flat - mean) * wgt[:, None]
    cov = (xc.T @ xc) / n + 1e-4 * torch.eye(3, device=img.device)
    prec = torch.linalg.inv(cov)

    d = flat - mean
    maha = torch.einsum("ni,ij,nj->n", d, prec, d)
    return torch.exp(-0.5 * maha / 4.0).reshape(h, w)


def _as_image(img, device) -> torch.Tensor:
    """HWC float [0,1] or uint8 (array or tensor) -> float32 RGB on ``device``."""
    x = img if isinstance(img, torch.Tensor) else torch.from_numpy(np.asarray(img))
    x = x.to(device)
    if x.dtype == torch.uint8:
        x = x.to(torch.float32) / 255.0
    if x.shape[-1] == 4:
        x = x[..., :3]
    return x.to(torch.float32)


def extract_background_mask(img, threshold: float = 0.5, device=None):
    """img: HWC float [0,1] (or uint8) -> [H, W] uint8 background mask.
    ``device=None`` means CUDA. A registered segmenter gets ``img`` as it
    came; the classical estimator runs on ``device``."""
    dev = resolve_device(device)
    if _REGISTERED is not None:
        return _REGISTERED(img)
    x = _as_image(img, dev)
    return (background_probability(x) > threshold).to(torch.uint8)
