"""Adaptive instance normalisation and CORAL colour transfer.

Port of ``aip_tpu.ops.adain`` (reference ``AdaIN/function.py``). NHWC;
statistics are float32 whatever the feature dtype (float64 stays float64).
"""

from __future__ import annotations

import torch


def _stat_dtype(t: torch.Tensor) -> torch.dtype:
    """float32, or t's dtype where that is wider."""
    return torch.promote_types(t.dtype, torch.float32)


def calc_mean_std(feat: torch.Tensor, eps: float = 1e-5):
    """Per-(batch, channel) spatial mean and std of an NHWC feature map.

    Unbiased variance over H*W (torch ``.var`` default), ``eps`` added
    before the square root. Returns ``(mean, std)``, each ``[N, 1, 1, C]``
    float32 (float64 for a float64 map).
    """
    n, h, w, c = feat.shape
    x = feat.to(_stat_dtype(feat))
    mean = x.mean(dim=(1, 2), keepdim=True)
    var = ((x - mean) ** 2).sum(dim=(1, 2), keepdim=True) / max(h * w - 1, 1)
    return mean, torch.sqrt(var + eps)


def adain(content_feat: torch.Tensor, style_feat: torch.Tensor,
          eps: float = 1e-5) -> torch.Tensor:
    """Renormalise content features to the style's per-channel mean/std."""
    c_mean, c_std = calc_mean_std(content_feat, eps)
    s_mean, s_std = calc_mean_std(style_feat, eps)
    out = (content_feat.to(c_mean.dtype) - c_mean) / c_std * s_std + s_mean
    return out.to(content_feat.dtype)


def _mat_sqrt(x: torch.Tensor) -> torch.Tensor:
    """Symmetric-PSD matrix square root via SVD (reference function.py:36-38)."""
    u, s, vt = torch.linalg.svd(x)
    return (u * torch.sqrt(s)[None, :]) @ vt


def coral(source: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """CORAL: recolour HWC ``source`` with ``target``'s channel covariance."""
    def flat_stats(img):
        f = img.float().reshape(-1, 3).T  # [3, HW]
        mean = f.mean(dim=1, keepdim=True)
        n = f.shape[1]
        std = torch.sqrt(((f - mean) ** 2).sum(dim=1, keepdim=True) / max(n - 1, 1))
        return f, mean, std

    src_f, src_mean, src_std = flat_stats(source)
    tgt_f, tgt_mean, tgt_std = flat_stats(target)
    src_norm = (src_f - src_mean) / src_std
    tgt_norm = (tgt_f - tgt_mean) / tgt_std
    eye = torch.eye(3, dtype=torch.float32, device=source.device)
    src_cov = src_norm @ src_norm.T + eye
    tgt_cov = tgt_norm @ tgt_norm.T + eye
    transfer = _mat_sqrt(tgt_cov) @ (torch.linalg.inv(_mat_sqrt(src_cov)) @ src_norm)
    out = transfer * tgt_std + tgt_mean
    return out.T.reshape(source.shape).to(source.dtype)


def style_loss_terms(input_feat: torch.Tensor, target_feat: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """MSE between the per-channel (mean, std) of two NHWC feature maps."""
    i_mean, i_std = calc_mean_std(input_feat, eps)
    t_mean, t_std = calc_mean_std(target_feat, eps)
    return ((i_mean - t_mean) ** 2).mean() + ((i_std - t_std) ** 2).mean()
