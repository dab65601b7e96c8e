"""The PNG writer's card half: quantise an image and filter its scanlines.
Wrapper and plain versions.

``csrc/png_filter.cu`` replaces no Pallas kernel (the JAX package writes its
images through PIL on the host). In one launch, one block a row, it
quantises an image as ``save_image`` or ``save_depth_png`` rounds it and
picks each row's PNG filter, so the host fetches the filtered scanlines
(a quarter of the fp32 image's bytes) and only deflates them
(``utils.png``).

* ``png_rows8``: an image [H, W] or [H, W, C] (C 3 or 4) -> [H, 1 + W*C]
  uint8 filtered rows (``filtered=False``: [H, W*C], the quantised bytes
  alone). A CUDA tensor takes the kernel (on its fp32 copy), a CPU tensor
  the plain version (``quantise8`` of its fp32 copy, then ``filter_rows``).
* ``png_rows16``: a map [H, W] -> [H, 1 + 2W] filtered rows of its
  min-max normalised 16-bit big-endian samples; the min and max are taken
  on the map's device. The kernel reads an fp32 map (or a float64 one) as
  it is and widens each sample to float64 in registers.
* ``quantise8``, ``quantise16``, ``filter_rows``: the plain versions, numpy
  on the host. ``quantise8`` and ``quantise16`` are the rules the two
  writers applied in numpy before the kernel; the kernel repeats their
  rounding step for step. The filter choice is integer arithmetic on the
  quantised bytes, so the kernel's rows equal ``filter_rows``' byte for byte.
* ``takes``: the image shapes the writer handles (8-bit grey, RGB, RGBA);
  ``channels``: an image shape's channels.

``launch_counts()`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from aip_tpu_torch.kernels._build import (add_count, bind, check, launch, read_counts,
                                           reset_counts)

MAX_ROW_BYTES = 1 << 24     # the kernel's cost sums stay below 2^31


@functools.cache
def _lib() -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    return bind("png_filter", aip_png_filter_u8=[p, p, i, i, i, i, p],
                aip_png_filter_u16=[p, p, p, i, i, i, p])


def takes(shape) -> bool:
    """Whether an image of ``shape`` is 8-bit grey ([H, W]), RGB or RGBA
    ([H, W, 3 or 4]) of at least one pixel: what the writer encodes."""
    shape = tuple(shape)
    if len(shape) not in (2, 3) or (len(shape) == 3 and shape[2] not in (3, 4)):
        return False
    return min(shape[:2]) >= 1 and shape[1] * channels(shape) < MAX_ROW_BYTES


def quantise8(a: np.ndarray) -> np.ndarray:
    """Clip to [0, 1] and round half up to uint8 (torchvision's
    ``save_image``), in ``a``'s own float type."""
    a = np.clip(a, 0.0, 1.0)
    return np.clip(np.floor(a * 255.0 + 0.5), 0, 255).astype(np.uint8)


def quantise16(d: np.ndarray) -> np.ndarray:
    """A map min-max normalised to [0, 1] in float64 (a constant map gives
    zeros) and rounded half up to uint16."""
    d = np.asarray(d, np.float64)
    extent = d.max() - d.min()
    norm = (d - d.min()) / extent if extent > 0 else np.zeros_like(d)
    return np.floor(norm * 65535.0 + 0.5).astype(np.uint16)


def filter_rows(raw: np.ndarray, bpp: int) -> np.ndarray:
    """PNG's filtered scanlines of ``raw`` [H, L] uint8 (L a whole number of
    ``bpp``-byte pixels): [H, 1 + L], each row its filter type and the row
    filtered by it. The type has the smallest sum of |byte as a signed
    char| of the five, the lowest type on a tie (libpng's heuristic); the
    neighbours outside the image are 0."""
    h, n = raw.shape
    x = raw.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    cand = (np.stack([x, x - a, x - b, x - ((a + b) >> 1), x - paeth]) & 0xFF).astype(np.uint8)
    cost = np.abs(cand.view(np.int8).astype(np.int32)).sum(axis=2)      # [5, H]
    best = cost.argmin(axis=0)
    out = np.empty((h, n + 1), np.uint8)
    out[:, 0] = best
    out[:, 1:] = cand[best, np.arange(h)]
    return out


def channels(shape) -> int:
    """The channels of an image of ``shape``: [H, W] is grey."""
    return shape[2] if len(shape) == 3 else 1


def png_rows8(x: torch.Tensor, filtered: bool = True) -> torch.Tensor:
    """The 8-bit image ``x`` ([H, W] or [H, W, C], C 3 or 4; any float
    type, taken as fp32) quantised as ``quantise8`` rounds it, as PNG's
    filtered rows [H, 1 + W*C] uint8, or with ``filtered=False`` the
    quantised bytes [H, W*C]. On ``x``'s device: the kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    if not takes(x.shape):
        raise ValueError(f"png_rows8 takes [H, W] or [H, W, 3 or 4], got {tuple(x.shape)}")
    h, w, bpp = x.shape[0], x.shape[1], channels(x.shape)
    x = x.detach().float()
    if x.device.type == "cpu":
        raw = quantise8(x.numpy()).reshape(h, w * bpp)
        return torch.from_numpy(filter_rows(raw, bpp) if filtered else raw)
    x = x.contiguous()
    check(x, "x", torch.float32, x.ndim)
    out = torch.empty((h, w * bpp + int(filtered)), dtype=torch.uint8, device=x.device)
    launch(_lib().aip_png_filter_u8, x.device, x, out, h, w * bpp, bpp, int(filtered))
    add_count("png_filter")
    return out


def png_rows16(d: torch.Tensor) -> torch.Tensor:
    """The map ``d`` [H, W] (any float type, taken as float64) quantised as
    ``quantise16`` rounds it, as PNG's filtered rows of 16-bit big-endian
    samples [H, 1 + 2W] uint8. On ``d``'s device: the kernel for a CUDA
    tensor (min and max taken there, on the map in its own type; a type
    narrower than fp32 read as fp32, which widens it exactly), the plain
    version for a CPU tensor."""
    if d.ndim != 2 or min(d.shape) < 1 or 2 * d.shape[1] >= MAX_ROW_BYTES:
        raise ValueError(f"png_rows16 takes a non-empty [H, W] map, got {tuple(d.shape)}")
    h, w = d.shape
    d = d.detach()
    if d.device.type == "cpu":
        q = quantise16(d.double().numpy())
        q = np.ascontiguousarray(q, ">u2").view(np.uint8).reshape(h, 2 * w)
        return torch.from_numpy(filter_rows(q, 2))
    f64 = d.dtype == torch.float64
    d = (d if f64 else d.float()).contiguous()
    check(d, "d", (torch.float32, torch.float64), 2)
    minmax = torch.stack(torch.aminmax(d))
    out = torch.empty((h, 2 * w + 1), dtype=torch.uint8, device=d.device)
    launch(_lib().aip_png_filter_u16, d.device, d, minmax, out, h, w, int(f64))
    add_count("png_filter")
    return out


def reset_launch_counts() -> None:
    reset_counts("png_filter")


def launch_counts() -> dict[str, int]:
    return read_counts("png_filter")
