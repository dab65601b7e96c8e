"""Plain DeepLabV3-ResNet101 (Chen et al. 2017, arXiv:1706.05587) in
torchvision's ``deeplabv3_resnet101`` layout, read straight from its state
dict. No kernel, cache or package of the program is used.

* Backbone: a ResNet-101 of bottlenecks (stride on the 3x3 conv), its last
  two stages dilated for output stride 8 by torchvision's rule: a dilated
  stage's first block runs at the previous stage's dilation (layer3 block 0
  at 1, layer4 block 0 at 2), the rest at the stage's (2 and 4). A stage is
  as deep as the blocks the state dict holds (torchvision's 3, 4, 23, 3).
* Head: ASPP (a 1x1 branch, 3x3 branches at dilations 12, 24, 36, image
  pooling), the 1280 -> 256 project, a 3x3 conv and the 1x1 classifier; the
  logits upsampled bilinearly (``align_corners=False``) to the input.
* BatchNorm in inference form (running statistics, eps 1e-5); dropout is
  the identity at inference.

Departures from torchvision's module: the auxiliary classifier is not run
(the segmentation reads only ``out``); ``bn`` lets a caller replace each
BatchNorm (the benchmark's seeded checkpoint measures the statistics with
it).

``precision``: ``"fp32"`` with TF32 off in cuDNN and matmuls (the
reference), ``"tf32"`` with it on (the control of an fp32 cell).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.adain import precision_flags

# (width, out channels, first-block stride, dilation, first-block dilation)
STAGES = ((64, 256, 1, 1, 1), (128, 512, 2, 1, 1), (256, 1024, 1, 2, 1),
          (512, 2048, 1, 4, 2))
ASPP_RATES = (12, 24, 36)
BN_EPS = 1e-5
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def blocks(sd) -> list[int]:
    """Bottlenecks a stage in the state dict."""
    out = []
    for si in range(len(STAGES)):
        n = 0
        while f"backbone.layer{si + 1}.{n}.conv1.weight" in sd:
            n += 1
        out.append(n)
    return out


def batch_norm(sd, prefix, x):
    return F.batch_norm(x, sd[f"{prefix}.running_mean"], sd[f"{prefix}.running_var"],
                        sd[f"{prefix}.weight"], sd[f"{prefix}.bias"], training=False,
                        eps=BN_EPS)


def conv(sd, prefix, x, stride=1, dilation=1):
    w = sd[f"{prefix}.weight"]
    k = w.shape[-1]
    return F.conv2d(x, w, sd.get(f"{prefix}.bias"), stride=stride,
                    padding=dilation * (k - 1) // 2, dilation=dilation)


def backbone(sd, x, bn=batch_norm):
    """The dilated ResNet-101's features [N, 2048, H/8, W/8] of ImageNet-
    normalised NCHW ``x``. ``bn(sd, prefix, x)`` is each BatchNorm, in
    network order."""
    b = "backbone"
    y = torch.relu(bn(sd, f"{b}.bn1", conv(sd, f"{b}.conv1", x, stride=2)))
    y = F.max_pool2d(y, 3, 2, padding=1)
    for si, n in enumerate(blocks(sd)):
        _width, _out, stride, dilation, first_dilation = STAGES[si]
        for bi in range(n):
            p = f"{b}.layer{si + 1}.{bi}"
            s, d = (stride, first_dilation) if bi == 0 else (1, dilation)
            z = torch.relu(bn(sd, f"{p}.bn1", conv(sd, f"{p}.conv1", y)))
            z = torch.relu(bn(sd, f"{p}.bn2", conv(sd, f"{p}.conv2", z, stride=s, dilation=d)))
            z = bn(sd, f"{p}.bn3", conv(sd, f"{p}.conv3", z))
            if f"{p}.downsample.0.weight" in sd:
                y = bn(sd, f"{p}.downsample.1", conv(sd, f"{p}.downsample.0", y, stride=s))
            y = torch.relu(z + y)
    return y


def head(sd, y, size, bn=batch_norm):
    """ASPP, the 3x3 conv and the classifier on the backbone's features,
    the logits upsampled to ``size`` (H, W)."""
    c = "classifier.0"
    branches = [torch.relu(bn(sd, f"{c}.convs.0.1", conv(sd, f"{c}.convs.0.0", y)))]
    for i, rate in enumerate(ASPP_RATES, start=1):
        branches.append(torch.relu(bn(sd, f"{c}.convs.{i}.1",
                                      conv(sd, f"{c}.convs.{i}.0", y, dilation=rate))))
    pooled = F.adaptive_avg_pool2d(y, 1)
    pooled = torch.relu(bn(sd, f"{c}.convs.4.2", conv(sd, f"{c}.convs.4.1", pooled)))
    branches.append(F.interpolate(pooled, size=y.shape[-2:], mode="bilinear",
                                  align_corners=False))
    z = torch.relu(bn(sd, f"{c}.project.1", conv(sd, f"{c}.project.0", torch.cat(branches, 1))))
    z = torch.relu(bn(sd, "classifier.2", conv(sd, "classifier.1", z)))
    logits = conv(sd, "classifier.4", z)
    return F.interpolate(logits, size=tuple(size), mode="bilinear", align_corners=False)


def forward(sd, x):
    """Logits [N, 21, H, W] of ImageNet-normalised NCHW ``x``, float32 in
    the flags the caller set."""
    return head(sd, backbone(sd, x), x.shape[-2:])


def normalise(img01_hwc: torch.Tensor) -> torch.Tensor:
    """HWC float32 in [0, 1] -> [1, 3, H, W] NCHW-contiguous, torchvision's
    ``Normalize``."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=img01_hwc.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=img01_hwc.device)
    return ((img01_hwc - mean) / std).permute(2, 0, 1)[None].contiguous()


@torch.no_grad()
def background_probability(sd, img01_hwc: torch.Tensor, precision: str = "fp32"):
    """P(class 0) [H, W] of one image, float32 (the reference's background
    is this > 0.5, ``localized_style_transfer.py:171-188``)."""
    with precision_flags(precision):
        logits = forward(sd, normalise(img01_hwc.float()))
    return torch.softmax(logits[0], dim=0)[0]
