"""Image files as the reference reads them (torchvision's ``Resize(int)``
on a PIL image, as AdaIN's ``test.py`` does: the smaller edge to ``size``,
the long edge truncated, PIL's bilinear filter)."""

from __future__ import annotations

import numpy as np
import torch


def smaller_edge_size(h: int, w: int, size: int) -> tuple[int, int]:
    if h <= w:
        return size, max(1, int(size * w / h))
    return max(1, int(size * h / w)), size


def load_uint8(path) -> np.ndarray:
    from PIL import Image

    with Image.open(str(path)) as im:
        return np.asarray(im.convert("RGB"))


def load_resized(path, size: int) -> torch.Tensor:
    """HWC float32 in [0, 1]."""
    from PIL import Image

    with Image.open(str(path)) as im:
        im = im.convert("RGB")
        h, w = smaller_edge_size(im.size[1], im.size[0], size)
        im = im.resize((w, h), Image.BILINEAR)
        return torch.from_numpy(np.asarray(im).astype(np.float32) / 255.0)
