"""Plain AdaIN (Huang & Belongie 2017; naoto0804/pytorch-AdaIN ``net.py``,
``function.py``, ``test.py``) in PyTorch, from the configuration's layer
lists. No kernel, cache or package of the program is used.

``precision`` names how each conv computes:

* ``"fp32"``: float32 with TF32 off in cuDNN and matmuls (the reference);
* ``"tf32"``: TF32 on (the control of an fp32 cell);
* ``"bf16"``: each conv's input and weight rounded to bfloat16, then
  float32 with TF32 off: the error a plain bf16 computation makes, which a
  bf16 cell's check takes as its unit;
* ``"fp8"``: each conv's input and weight rounded to float8 e4m3 with one
  scale a tensor (amax / 448), then float32 (the control of a bf16 cell).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


@contextlib.contextmanager
def precision_flags(precision: str):
    """TF32 on for ``"tf32"``, off otherwise; the old flags come back."""
    old = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    tf32 = precision == "tf32"
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """t rounded to e4m3 under one scale (amax / 448), back in float32."""
    amax = t.abs().amax().clamp(min=1e-30)
    scale = amax / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _conv(x, w, b, precision):
    if precision == "fp8":
        x, w = fp8_round(x), fp8_round(w)
    elif precision == "bf16":
        x, w = x.to(torch.bfloat16).float(), w.to(torch.bfloat16).float()
    return F.conv2d(x, w, b)


def run_layers(layers, weights, x, precision):
    """Walk a layer list on NCHW ``x``; ``weights`` is the convs' (OIHW w,
    b) in order."""
    i = 0
    for layer in layers:
        kind = layer[0]
        if kind == "pad":
            x = F.pad(x, (1, 1, 1, 1), mode="reflect")
        elif kind == "conv":
            w, b = weights[i]
            x = _conv(x, w, b, precision)
            i += 1
        elif kind == "relu":
            x = torch.relu(x)
        elif kind == "pool":
            x = F.max_pool2d(x, 2, 2, ceil_mode=True)
        elif kind == "up":
            x = F.interpolate(x, scale_factor=2, mode="nearest")
    return x


def mean_std(feat, eps):
    """Per-(image, channel) mean and std over space (unbiased variance,
    ``eps`` inside the root), NCHW -> [N, C, 1, 1] each."""
    n, c = feat.shape[:2]
    flat = feat.reshape(n, c, -1)
    var = flat.var(dim=2, unbiased=True) + eps
    return flat.mean(dim=2).reshape(n, c, 1, 1), var.sqrt().reshape(n, c, 1, 1)


def encode(cfg, enc_w, x_nhwc, precision="fp32"):
    with precision_flags(precision):
        return run_layers(cfg["encoder"], enc_w, x_nhwc.permute(0, 3, 1, 2).float(), precision)


def style_stats(cfg, enc_w, style_nhwc, precision="fp32"):
    return mean_std(encode(cfg, enc_w, style_nhwc, precision), cfg["eps"])


def stylize(cfg, enc_w, dec_w, content_nhwc, s_mean, s_std, alpha, precision="fp32",
            block=4):
    """AdaIN to (s_mean, s_std), blended with the content features by
    ``alpha``, decoded; NHWC float32 out, ``block`` images at a time."""
    outs = []
    with precision_flags(precision):
        for i in range(0, content_nhwc.shape[0], block):
            x = content_nhwc[i:i + block].permute(0, 3, 1, 2).float()
            f = run_layers(cfg["encoder"], enc_w, x, precision)
            c_mean, c_std = mean_std(f, cfg["eps"])
            t = (f - c_mean) / c_std * s_std + s_mean
            t = alpha * t + (1 - alpha) * f
            outs.append(run_layers(cfg["decoder"], dec_w, t, precision).permute(0, 2, 3, 1))
    return torch.cat(outs)


def to_uint8(img_hwc: torch.Tensor):
    """Clamp to [0, 1] and round half up to 8 bits, as torchvision's
    ``save_image`` (``test.py``) does."""
    a = img_hwc.clamp(0.0, 1.0)
    return torch.floor(a * 255.0 + 0.5).clamp(0, 255).to(torch.uint8)
