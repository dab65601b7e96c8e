"""Gram matrices for optimization-based neural style transfer. Port of
``aip_tpu.ops.gram``.

Parity with `mixing_texture_gyum/style_mixer.py:4-10` and
`spatial_variation/StyleTransfer.py:39-43`: G = F F^T / (C*H*W) for a
[B, C, HW] flattening. NHWC here; one batched product. It stays float32 on
the card: ``torch.backends.cuda.matmul.allow_tf32`` is False unless a
caller sets it.
"""

from __future__ import annotations

import torch


def gram_matrix(feat: torch.Tensor) -> torch.Tensor:
    """[N, H, W, C] -> [N, C, C] normalized Gram matrix, in float32 (float64
    features stay float64)."""
    n, h, w, c = feat.shape
    x = feat.reshape(n, h * w, c).to(torch.promote_types(feat.dtype, torch.float32))
    g = torch.einsum("npc,npd->ncd", x, x)
    return g / (c * h * w)
