"""Color-space transforms and distribution matching (Reinhard lab, PCA, CDF).
Port of ``aip_tpu.ops.color``.

Parity targets in `Style_3DGS/localized_style_transfer.py`:
* RGB_TO_LMS / LMS_TO_LAB matrices (:12-19),
* rgb_to_lab / lab_to_rgb (:22-89) — log-LMS "lab" space (Reinhard et al.),
* apply_pca (:92-96) — 1-component PCA of lab pixels,
* match_cdf (:99-125) — sort + interpolation quantile matching.

As in the JAX package, masked pixel sets (foreground/background) are weight
vectors, and quantile functions are resampled onto a fixed K-point grid, so
every shape is static. Two rules are the JAX package's, copied exactly:
``_interp`` is ``jnp.interp`` (which differs from ``np.interp`` where the
grid repeats a value) and ``_linspace`` is ``jnp.linspace`` in float32.
"""

from __future__ import annotations

import numpy as np
import torch

# Reinhard's transform matrices (localized_style_transfer.py:12-19).
RGB_TO_LMS = np.array(
    [[0.3811, 0.5783, 0.0402], [0.1967, 0.7244, 0.0782], [0.0241, 0.1288, 0.8444]]
)
LMS_TO_LAB = np.array(
    [[1 / np.sqrt(3), 0, 0], [0, 1 / np.sqrt(6), 0], [0, 0, 1 / np.sqrt(2)]]
) @ np.array([[1, 1, 1], [1, 1, -2], [1, -1, 0]])
LAB_TO_LMS = np.linalg.inv(LMS_TO_LAB)
LMS_TO_RGB = np.linalg.inv(RGB_TO_LMS)


def _mat(m: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(m.T, dtype=torch.float32, device=like.device)


def rgb_to_lab(rgb01: torch.Tensor) -> torch.Tensor:
    """[..., 3] RGB in [0,1] -> Reinhard lab (log-LMS decorrelated)."""
    x = rgb01.to(torch.float32)
    lms = torch.clamp(x @ _mat(RGB_TO_LMS, x), min=1e-6)
    return torch.log10(lms) @ _mat(LMS_TO_LAB, x)


def lab_to_rgb(lab: torch.Tensor) -> torch.Tensor:
    """Reinhard lab -> [..., 3] RGB in [0,1] (clipped)."""
    log_lms = lab.to(torch.float32) @ _mat(LAB_TO_LMS, lab)
    rgb = torch.pow(10.0, log_lms) @ _mat(LMS_TO_RGB, lab)
    return torch.clamp(rgb, 0.0, 1.0)


def weighted_pca1(x: torch.Tensor, w: torch.Tensor):
    """1-component weighted PCA of [N, D] points with weights [N] in {0,1}.

    Returns (projection [N], mean [D], component [D]). Matches sklearn
    PCA(n_components=1) fit on the w==1 subset: the eigenvector of the
    largest eigenvalue (``eigh`` sorts ascending), signed so that its
    largest-magnitude entry is positive.
    """
    w = w.to(torch.float32)
    n = torch.clamp(torch.sum(w), min=1.0)
    mean = torch.sum(x * w[:, None], dim=0) / n
    xc = (x - mean) * w[:, None]
    cov = (xc.T @ xc) / n
    _evals, evecs = torch.linalg.eigh(cov)
    comp = evecs[:, -1]
    comp = comp * torch.sign(comp[torch.argmax(torch.abs(comp))])
    proj = (x - mean) @ comp
    return proj, mean, comp


def _linspace(k: int, device) -> torch.Tensor:
    """``jnp.linspace(0.0, 1.0, k)`` in float32: iota / (k - 1), which XLA
    computes as iota times the float32 reciprocal, then 1."""
    if k == 1:
        return torch.zeros(1, dtype=torch.float32, device=device)
    inv = torch.tensor(1.0, dtype=torch.float32) / (k - 1)
    step = torch.arange(k - 1, dtype=torch.float32, device=device) * inv.to(device)
    return torch.cat([step, torch.ones(1, dtype=torch.float32, device=device)])


def masked_quantile_grid(values: torch.Tensor, w: torch.Tensor, k: int = 1024) -> torch.Tensor:
    """Sample the quantile function of the w==1 subset of ``values`` at k
    uniform positions. Static-shape replacement for "sort the valid pixels".
    """
    big = torch.finfo(torch.float32).max
    keyed = torch.where(w > 0, values.to(torch.float32),
                        torch.full_like(values, big, dtype=torch.float32))
    s = torch.sort(keyed).values
    n = torch.clamp(torch.sum(w > 0), min=1)
    pos = _linspace(k, values.device) * (n - 1).to(torch.float32)
    lo = torch.floor(pos).to(torch.int64)
    hi = torch.minimum(lo + 1, n - 1)
    frac = pos - lo.to(torch.float32)
    return s[lo] * (1.0 - frac) + s[hi] * frac


def _interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp(x, xp, fp)``: i = clip(searchsorted(xp, x, right), 1,
    n - 1); the left value where |dx| <= spacing(eps); fp[0] below xp[0]
    and fp[-1] above xp[-1]."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, fp[i - 1], fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def masked_cdf_match(
    target: torch.Tensor,
    target_w: torch.Tensor,
    source: torch.Tensor,
    source_w: torch.Tensor,
    k: int = 1024,
) -> torch.Tensor:
    """Map ``target`` values so their (masked) CDF matches ``source``'s.

    Parity with reference match_cdf (:99-125): both quantile functions are
    resampled to a common length, then each target value is pushed through
    Q_source(CDF_target(.)) by piecewise-linear interpolation.
    """
    t_grid = masked_quantile_grid(target, target_w, k)
    s_grid = masked_quantile_grid(source, source_w, k)
    return _interp(target.to(torch.float32), t_grid, s_grid)


def harmonize_foreground(
    fg_rgb01: torch.Tensor,
    bg_rgb01: torch.Tensor,
    fg_mask: torch.Tensor,
    bg_mask: torch.Tensor,
    k: int = 1024,
) -> torch.Tensor:
    """Recolor fg pixels so their dominant-color distribution matches bg's.

    Full-parity pipeline of ``color_transfer_foreground``
    (localized_style_transfer.py:128-168): lab -> PCA(1) per region ->
    CDF-match fg projection to bg's -> inverse PCA -> RGB. Inputs are HWC
    RGB [0,1] with [H, W] {0,1} masks, all on one device; returns the
    recolored fg image (only fg_mask pixels changed).
    """
    h, w, _ = fg_rgb01.shape
    fgm = fg_mask.reshape(-1).to(torch.float32)
    bgm = bg_mask.reshape(-1).to(torch.float32)
    fg_lab = rgb_to_lab(fg_rgb01.reshape(-1, 3))
    bg_lab = rgb_to_lab(bg_rgb01.reshape(-1, 3))

    fg_proj, fg_mean, fg_comp = weighted_pca1(fg_lab, fgm)
    bg_proj, _, _ = weighted_pca1(bg_lab, bgm)

    matched = masked_cdf_match(fg_proj, fgm, bg_proj, bgm, k)
    adjusted_rgb = lab_to_rgb(fg_mean + matched[:, None] * fg_comp[None, :])

    out = torch.where(fgm[:, None] > 0, adjusted_rgb, fg_rgb01.reshape(-1, 3).to(torch.float32))
    return out.reshape(h, w, 3)
