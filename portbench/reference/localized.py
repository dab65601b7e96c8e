"""Plain regional style transfer (``Style_3DGS/localized_style_transfer.py``
:92-245): the background (P(class 0) > 0.5) stylized by AdaIN at alpha 1
with the mask composite, written as a JPEG and read back, then the
foreground's colours harmonized to the stylized background and the two
composited. PyTorch for the networks (``reference.adain``,
``reference.deeplab``), NumPy in float64 for the colour steps. Nothing of
the program is used.

Colour steps (``:12-168``): Reinhard's log-LMS "lab"; a 1-component PCA of
each region's non-black lab pixels; the foreground's projections pushed
through Q_background(CDF_foreground(.)); the inverse PCA; lab back to RGB,
clipped to [0, 1].

Departures from the reference, each the rebuild's rule the program keeps:

* both quantile functions are sampled at ``K`` = 1024 evenly spaced ranks
  (linear between order statistics) where the reference resamples to the
  foreground's length;
* the interpolation is ``jnp.interp``'s (the left value on a flat step of
  the grid), not ``np.interp``'s;
* the PCA component is signed so that its largest-magnitude entry is
  positive (scikit-learn's ``svd_flip`` on the component).
"""

from __future__ import annotations

import io

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import adain as ref_adain

K = 1024
RGB_TO_LMS = np.array([[0.3811, 0.5783, 0.0402], [0.1967, 0.7244, 0.0782],
                       [0.0241, 0.1288, 0.8444]])
LMS_TO_LAB = (np.diag([1 / np.sqrt(3), 1 / np.sqrt(6), 1 / np.sqrt(2)])
              @ np.array([[1, 1, 1], [1, 1, -2], [1, -1, 0]]))
LAB_TO_LMS = np.linalg.inv(LMS_TO_LAB)
LMS_TO_RGB = np.linalg.inv(RGB_TO_LMS)


def jpeg_round_trip(u8: np.ndarray) -> np.ndarray:
    """An HWC uint8 image through PIL's JPEG at its defaults (quality 75),
    as ``save_image`` writes a ``.jpg``, and back."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(u8).save(buf, format="JPEG")
    buf.seek(0)
    with Image.open(buf) as im:
        return np.asarray(im.convert("RGB"))


def nearest(x_hwc: torch.Tensor, size) -> torch.Tensor:
    """``F.interpolate(mode="nearest")`` on an HWC (or HW) tensor."""
    squeeze = x_hwc.ndim == 2
    x = x_hwc[..., None] if squeeze else x_hwc
    y = F.interpolate(x.permute(2, 0, 1)[None].float(), size=tuple(size), mode="nearest")
    y = y[0].permute(1, 2, 0)
    return y[..., 0] if squeeze else y


def stylize_masked(cfg, enc_w, dec_w, content, s_mean, s_std, mask, precision="fp32"):
    """AdaIN's IO wrapper with a mask (``test.py:222-236``), alpha 1: the
    content at its working size [h, w, 3], the decoder's output resized
    bilinearly to it, composited over the content where the full-size
    [H, W] mask, resized nearest, is 1. The 8-bit image it writes."""
    h, w = content.shape[:2]
    out = ref_adain.stylize(cfg, enc_w, dec_w, content[None], s_mean, s_std, 1.0, precision)
    out = F.interpolate(out.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                        align_corners=False)[0].permute(1, 2, 0)
    m = nearest(mask.to(content.device).float(), (h, w))[..., None]
    out = content * (1.0 - m) + out * m
    return ref_adain.to_uint8(out).cpu().numpy()


def rgb_to_lab(rgb):
    lms = np.maximum(rgb @ RGB_TO_LMS.T, 1e-6)
    return np.log10(lms) @ LMS_TO_LAB.T


def lab_to_rgb(lab):
    return np.clip((10.0 ** (lab @ LAB_TO_LMS.T)) @ LMS_TO_RGB.T, 0.0, 1.0)


def pca1(x, valid):
    """Mean and first component of the valid rows, the component's
    largest-magnitude entry positive."""
    pts = x[valid]
    mean = pts.mean(axis=0)
    xc = pts - mean
    _vals, vecs = np.linalg.eigh(xc.T @ xc / len(pts))
    comp = vecs[:, -1]
    return mean, comp * np.sign(comp[np.argmax(np.abs(comp))])


def quantiles(values):
    """The sorted values' quantile function at K evenly spaced ranks."""
    s = np.sort(values)
    pos = np.linspace(0.0, 1.0, K) * (len(s) - 1)
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, len(s) - 1)
    frac = pos - lo
    return s[lo] * (1.0 - frac) + s[hi] * frac


def interp(x, xp, fp):
    """Piecewise-linear interpolation, ``jnp.interp``'s rule: the left
    value on a flat step, the end values outside."""
    i = np.clip(np.searchsorted(xp, x, side="right"), 1, len(xp) - 1)
    dx = xp[i] - xp[i - 1]
    flat = dx == 0
    f = np.where(flat, fp[i - 1], fp[i - 1] + (x - xp[i - 1]) / np.where(flat, 1.0, dx)
                 * (fp[i] - fp[i - 1]))
    f = np.where(x < xp[0], fp[0], f)
    return np.where(x > xp[-1], fp[-1], f)


def harmonize(content_u8: np.ndarray, stylized_u8: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """The composite (``:191-245``): ``content_u8`` and the [H, W] {0, 1}
    background ``mask`` at full size, ``stylized_u8`` (the JPEG read back)
    at its working size, resized nearest to the mask. Float64 HWC."""
    hgt, wid = mask.shape
    stylized = nearest(torch.from_numpy(stylized_u8.astype(np.float32) / 255.0),
                       (hgt, wid)).numpy().astype(np.float64)
    content = content_u8.astype(np.float32).astype(np.float64) / 255.0
    bg = mask.astype(np.float64)[..., None]
    fg = 1.0 - bg
    foreground = (content * fg).reshape(-1, 3)
    background = (stylized * bg).reshape(-1, 3)
    fg_valid = (foreground.sum(-1) > 0) & (fg.reshape(-1) > 0)
    bg_valid = (background.sum(-1) > 0) & (bg.reshape(-1) > 0)
    fg_lab, bg_lab = rgb_to_lab(foreground), rgb_to_lab(background)
    fg_mean, fg_comp = pca1(fg_lab, fg_valid)
    bg_mean, bg_comp = pca1(bg_lab, bg_valid)
    fg_proj = (fg_lab - fg_mean) @ fg_comp
    bg_proj = (bg_lab - bg_mean) @ bg_comp
    matched = interp(fg_proj, quantiles(fg_proj[fg_valid]), quantiles(bg_proj[bg_valid]))
    adjusted = lab_to_rgb(fg_mean + matched[:, None] * fg_comp[None, :])
    out_fg = np.where(fg_valid[:, None], adjusted, foreground)
    return (out_fg * fg.reshape(-1, 1) + background).reshape(hgt, wid, 3)


def result(content_u8, stylized_u8, mask) -> np.ndarray:
    """The result JPEG as read back: the composite rounded half up to 8
    bits (``save_image``) through PIL's JPEG."""
    out = np.clip(harmonize(content_u8, stylized_u8, mask), 0.0, 1.0)
    return jpeg_round_trip(np.clip(np.floor(out * 255.0 + 0.5), 0, 255).astype(np.uint8))
