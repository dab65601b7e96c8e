"""A seeded DeepLabV3-ResNet101 checkpoint in torchvision's layout, built
as the configuration's ``assumed`` says: He-normal convs drawn from the
seed, each BatchNorm's statistics measured in network order on calibration
images, the residual branches' last gamma small, class 0's bias set for a
background share."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference import deeplab as ref


def conv_shapes(cfg: dict) -> list[tuple[str, tuple]]:
    """(state-dict prefix, OIHW shape) of every conv, in network order."""
    out = [("backbone.conv1", (cfg["stem_width"], 3, 7, 7))]
    cin = cfg["stem_width"]
    for si, (n, width) in enumerate(zip(cfg["blocks"], cfg["widths"])):
        cout = width * cfg["expansion"]
        for bi in range(n):
            p = f"backbone.layer{si + 1}.{bi}"
            block_in = cin if bi == 0 else cout
            out += [(f"{p}.conv1", (width, block_in, 1, 1)), (f"{p}.conv2", (width, width, 3, 3)),
                    (f"{p}.conv3", (cout, width, 1, 1))]
            if bi == 0:
                out.append((f"{p}.downsample.0", (cout, block_in, 1, 1)))
        cin = cout
    a, c = cfg["aspp_width"], "classifier.0"
    out += [(f"{c}.convs.0.0", (a, cin, 1, 1))]
    out += [(f"{c}.convs.{i}.0", (a, cin, 3, 3)) for i in range(1, len(cfg["aspp_rates"]) + 1)]
    out += [(f"{c}.convs.4.1", (a, cin, 1, 1)),
            (f"{c}.project.0", (a, a * (len(cfg["aspp_rates"]) + 2), 1, 1)),
            ("classifier.1", (a, a, 3, 3)), ("classifier.4", (cfg["num_classes"], a, 1, 1))]
    return out


def seeded_state_dict(cfg: dict, seed: int, calibration: torch.Tensor,
                      background_share: float, residual_gamma: float) -> dict:
    """The checkpoint on ``calibration``'s device ([N, H, W, 3] in [0, 1]):
    convs He-normal from ``seed``; BatchNorms beta 0 and gamma 1, but
    ``residual_gamma`` on each residual branch's last (``bn3``), with the
    running mean and biased variance of their input over the calibration
    batch, measured in network order (each on the outputs of the layers
    already measured; the image-pooling branch's over its conv's pixels);
    the classifier's bias 0 except class 0's, set so that P(class 0) > 0.5
    on ``background_share`` of the calibration pixels."""
    dev = calibration.device
    shapes = conv_shapes(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    flat = torch.randn(sum(math.prod(s) for _, s in shapes), generator=gen, device=dev)
    sd, at = {}, 0
    for prefix, s in shapes:
        n = math.prod(s)
        sd[f"{prefix}.weight"] = flat[at:at + n].view(s) * math.sqrt(2.0 / math.prod(s[1:]))
        at += n
    del flat
    sd["classifier.4.bias"] = torch.zeros(cfg["num_classes"], device=dev)

    def measure(sd_, prefix, x):
        if f"{prefix}.running_mean" not in sd_:
            _set_bn(sd_, prefix, x.mean(dim=(0, 2, 3)), x.var(dim=(0, 2, 3), unbiased=False),
                    residual_gamma if prefix.endswith(".bn3") else 1.0)
        return ref.batch_norm(sd_, prefix, x)

    x = torch.cat([ref.normalise(img) for img in calibration])
    with torch.no_grad(), ref.precision_flags("fp32"):
        y = ref.backbone(sd, x, bn=measure)
        # The image-pooling branch sees one pooled vector an image, too few
        # to estimate a spread: its BatchNorm takes its conv's statistics
        # over the calibration maps' pixels (the same mean; the pixels'
        # spread), so one image's context does not swing every pixel.
        pix = F.conv2d(y, sd["classifier.0.convs.4.1.weight"])
        _set_bn(sd, "classifier.0.convs.4.2", pix.mean(dim=(0, 2, 3)),
                pix.var(dim=(0, 2, 3), unbiased=False))
        del pix
        logits = ref.head(sd, y, x.shape[-2:], bn=measure)
    # P(class 0) > 0.5 where logit_0 + b > logsumexp(the others): b is the
    # share-quantile of their difference.
    gap = (torch.logsumexp(logits[:, 1:], dim=1) - logits[:, 0]).flatten()
    k = min(max(int(round(background_share * gap.numel())), 1), gap.numel())
    sd["classifier.4.bias"][0] = torch.kthvalue(gap.cpu(), k).values.item() + 1e-6
    return sd


def _set_bn(sd, prefix, mean, var, gamma=1.0):
    """A BatchNorm of beta 0 and ``gamma`` with these running statistics."""
    c = mean.numel()
    sd.update({f"{prefix}.weight": torch.full((c,), gamma, device=mean.device),
               f"{prefix}.bias": torch.zeros(c, device=mean.device),
               f"{prefix}.running_mean": mean, f"{prefix}.running_var": var,
               f"{prefix}.num_batches_tracked": torch.tensor(0, device=mean.device)})
