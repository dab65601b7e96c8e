"""Multi-backbone NST with palette post-processing (reference
`gui/seven_page.py` "Style Mixer" page engine). Port of
``aip_tpu.pipelines.style_mixer``.

Components (reference line refs):
* backbone registry — ResNet-50, DenseNet-121, VGG16 and Swin-T feature
  extractors (:123-256), with ``register_backbone`` for others;
* ``style_transfer`` (:290-352) — Adam on the image, 300 iters, per-layer
  style weights, noise-mixed init ``0.6*content + 0.4*noise``;
* ``extract_palette`` (:395-409) — KMeans over CIELAB pixels;
* ``map_colors`` (:412-428) — nearest palette color in CIELAB;
* ``blend_images_with_intensity`` (:431-437) — gamma-2.2 blend;
* predefined palettes + HSL adjustment (:46-120);
* artist-prompt style selection (:566-600).

The JAX package draws the noise init with ``jax.random.normal`` and the
k-means starts with ``jax.random.choice``; here both come from a
``torch.Generator`` seeded with ``seed`` / ``random_state``, or are handed
in (``noise=``, ``init_idx=``), as the parity tests hand in JAX's draws.
Adam is optax's, written out (``pipelines.nst.adam_descent``), and the gradient
is taken inside ``fp32_convs`` so that the backward convs run in fp32 as
the forward ones do. Every entry point takes ``device=None`` (CUDA; raises
without it).
"""

from __future__ import annotations

import colorsys
import functools
import random
from pathlib import Path

import torch

from aip_tpu_torch.device import fp32_convs, resolve_device
from aip_tpu_torch.ops.palette import WHITE_D65, _srgb_to_xyz, xyz_to_lab
from aip_tpu_torch.pipelines.nst import adam_descent

# :46-58
PREDEFINED_PALETTES = {
    "Green": ["#00ff00", "#009900", "#66ff66", "#33cc33", "#00cc00"],
    "Mario": ["#fed1b0", "#ee1c25", "#0065b3", "#ffffff", "#894c2f"],
    "Black": ["#000000", "#333333", "#666666", "#999999", "#cccccc"],
    "White": ["#ffffff", "#f0f0f0", "#e0e0e0", "#d0d0d0", "#c0c0c0"],
    "Vintage": ["#131842", "#E68369", "#ECCEAE", "#FBF6E2", "#8E9B73"],
    "Blue": ["#000000", "#2f4550", "#586f7c", "#b8dbd9", "#f4f4f9"],
}
PALETTE_MENU = list(PREDEFINED_PALETTES)

WEIGHT_CONFIGURATIONS = {
    "Swin": {"swin": 1000.0},
    "VGG": {"layer2": 1000.0, "layer3": 1500.0},
    "default": {"layer2": 1000.0, "layer3": 1500.0},
}
MODEL_LIST = ["ResNet", "DenseNet", "Swin", "VGG"]

ARTISTS = {"1": "vangogh", "2": "pietmondriaan", "3": "picasso", "4": "claudemonet"}

_EXTRA_BACKBONES = {}


def register_backbone(name: str, extractor_fn) -> None:
    """extractor_fn(img_norm_nhwc) -> {layer_name: features}."""
    _EXTRA_BACKBONES[name] = extractor_fn


def hex_to_rgb_palette(hex_list):
    """:81-93 parity — [0,1] floats."""
    out = []
    for h in hex_list:
        h = h.lstrip("#")
        out.append([int(h[i:i + 2], 16) / 255.0 for i in (0, 2, 4)])
    return out


def adjust_palette_hsl(palette, saturation: float = 1.0, hue: float = 0.0):
    """:109-120 parity (colorsys HLS)."""
    adjusted = []
    for color_val in palette:
        h, l, s = colorsys.rgb_to_hls(*color_val)
        s *= saturation
        h = (h + hue) % 1.0
        adjusted.append(list(colorsys.hls_to_rgb(h, l, s)))
    return adjusted


def select_style_for_prompt(prompt: str, style_dir) -> str | None:
    """Artist-prompt selection (:566-600): match an artist keyword in the
    prompt and pick a random style image whose filename contains it."""
    prompt = prompt.lower()
    style_dir = Path(style_dir)
    for artist in ARTISTS.values():
        if artist in prompt.replace(" ", ""):
            candidates = [p for p in style_dir.glob("*") if artist in p.name.lower()]
            if candidates:
                return str(random.choice(candidates))
    all_imgs = [p for p in style_dir.glob("*")
                if p.suffix.lower() in (".jpg", ".jpeg", ".png")]
    return str(random.choice(all_imgs)) if all_imgs else None


# ---------------------------------------------------------------------------
# Backbones
# ---------------------------------------------------------------------------

def get_feature_extractor(model: str, device=None):
    """Returns fn(img_normalized_nhwc) -> {layer: feats} with the backbone's
    parameters on ``device``. A registered backbone comes first."""
    if model in _EXTRA_BACKBONES:
        return _EXTRA_BACKBONES[model]
    dev = resolve_device(device)
    if model == "ResNet":
        from aip_tpu_torch.models.resnet import get_resnet50_params, resnet50_features

        return functools.partial(resnet50_features, get_resnet50_params(device=dev))
    if model == "DenseNet":
        from aip_tpu_torch.models.densenet import densenet121_features, get_densenet121_params

        return functools.partial(densenet121_features, get_densenet121_params(device=dev))
    if model == "VGG":
        from aip_tpu_torch.models.lpips import _extract, get_vgg16_params

        params = get_vgg16_params(device=dev)

        def vgg_feats(x):
            taps = [t.permute(0, 2, 3, 1) for t in _extract(params, x.permute(0, 3, 1, 2))]
            # relu2_2 / relu3_3 / relu4_3 as layer2/3/4 (seven_page VGG
            # extractor uses the same block-level taps).
            return {"layer1": taps[0], "layer2": taps[1], "layer3": taps[2], "layer4": taps[3]}

        return vgg_feats
    if model == "Swin":
        from aip_tpu_torch.models.swin import get_swin_t_params, swin_t_features

        return functools.partial(swin_t_features, get_swin_t_params(device=dev))
    raise ValueError(f"unknown backbone {model}")


def _gram_chw(feat: torch.Tensor) -> torch.Tensor:
    """seven_page gram (:259-266): [1, H, W, C] -> [C, C] / numel."""
    _, h, w, c = feat.shape
    f = feat.reshape(h * w, c)
    return (f.T @ f) / (c * h * w)


def style_transfer(
    content01: torch.Tensor,
    style01: torch.Tensor,
    model: str = "ResNet",
    iterations: int = 300,
    content_weight: float = 0.5,
    style_weight: float = 1000.0,
    lr: float = 0.003,
    seed: int = 0,
    noise: torch.Tensor | None = None,
    device=None,
) -> torch.Tensor:
    """NST with the chosen backbone (:290-352). NHWC [1, H, W, 3] in/out.
    ``noise`` (the shape of the content) replaces the standard-normal draw
    of a ``torch.Generator`` seeded with ``seed``."""
    from aip_tpu_torch.models.vgg19_std import denormalize_imagenet, normalize_imagenet

    dev = resolve_device(device)
    extractor = get_feature_extractor(model, dev)
    if model == "Swin":
        content_layer, style_layers = "swin", ("swin",)
        weight_config = WEIGHT_CONFIGURATIONS["Swin"]
    else:
        content_layer, style_layers = "layer4", ("layer2", "layer3")
        weight_config = WEIGHT_CONFIGURATIONS["VGG" if model == "VGG" else "default"]

    x_c = normalize_imagenet(torch.as_tensor(content01).to(dev))
    x_s = normalize_imagenet(torch.as_tensor(style01).to(dev))
    with torch.no_grad():
        content_target = extractor(x_c)[content_layer]
        style_feats = extractor(x_s)
        style_grams = {k: _gram_chw(style_feats[k]) for k in style_layers}
    if noise is None:
        noise = torch.randn(tuple(x_c.shape), generator=torch.Generator().manual_seed(seed))
    img = 0.6 * x_c + 0.4 * torch.as_tensor(noise, dtype=torch.float32).to(dev)

    def loss_and_grad(img):
        img = img.detach().requires_grad_(True)
        with fp32_convs(), torch.enable_grad():
            feats = extractor(img)
            c_loss = torch.mean((feats[content_layer] - content_target) ** 2)
            s_loss = 0.0
            for layer in style_layers:
                g = _gram_chw(feats[layer])
                s_loss = s_loss + weight_config[layer] * torch.mean((g - style_grams[layer]) ** 2)
            loss = content_weight * c_loss + style_weight * s_loss
            return torch.autograd.grad(loss, img)[0]

    return denormalize_imagenet(adam_descent(img, loss_and_grad, iterations, lr))


# ---------------------------------------------------------------------------
# Palette post-processing
# ---------------------------------------------------------------------------

def rgb_to_cielab(rgb01: torch.Tensor) -> torch.Tensor:
    """Float CIELAB (skimage convention: L in [0,100], a/b signed). The cube
    root is a power (no ``torch.cbrt``), an ulp or two from ``jnp.cbrt``."""
    return xyz_to_lab(_srgb_to_xyz(rgb01.to(torch.float32)))


_XYZ_TO_RGB = ((3.240479, -1.537150, -0.498535),
               (-0.969256, 1.875992, 0.041556),
               (0.055648, -0.204043, 1.057311))


def cielab_to_rgb(lab: torch.Tensor) -> torch.Tensor:
    L, a, b = lab[..., 0], lab[..., 1], lab[..., 2]
    fy = (L + 16.0) / 116.0
    fx = fy + a / 500.0
    fz = fy - b / 200.0

    def finv(f):
        f3 = f ** 3
        return torch.where(f3 > 0.008856, f3, (f - 16.0 / 116.0) / 7.787)

    xn = torch.tensor(WHITE_D65, dtype=torch.float32, device=lab.device)
    xyz = torch.stack([finv(fx), finv(fy), finv(fz)], dim=-1) * xn
    m = torch.tensor(_XYZ_TO_RGB, dtype=torch.float32, device=lab.device)
    lin = xyz @ m.T
    srgb = torch.where(lin > 0.0031308,
                       1.055 * torch.clamp(lin, min=1e-8) ** (1 / 2.4) - 0.055, 12.92 * lin)
    return torch.clamp(srgb, 0.0, 1.0)


def _sq_distances(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """[N, 3] x [K, 3] -> [N, K] squared distances in the JAX package's form."""
    return (torch.sum(x ** 2, 1, keepdim=True) - 2 * x @ c.T) + torch.sum(c ** 2, 1)[None]


def _kmeans_lab(pixels_lab: torch.Tensor, num_colors: int, iters: int = 20,
                generator: torch.Generator | None = None,
                init_idx: torch.Tensor | None = None) -> torch.Tensor:
    """Lloyd's k-means from ``num_colors`` distinct pixels: ``init_idx``, or
    a permutation drawn from ``generator``."""
    n = pixels_lab.shape[0]
    if init_idx is None:
        init_idx = torch.randperm(n, generator=generator)[:num_colors]
    centers = pixels_lab[torch.as_tensor(init_idx).to(pixels_lab.device)]
    for _ in range(iters):
        assign = torch.argmin(_sq_distances(pixels_lab, centers), dim=1)
        one_hot = torch.nn.functional.one_hot(assign, num_colors).to(pixels_lab.dtype)
        counts = one_hot.sum(0)
        sums = one_hot.T @ pixels_lab
        centers = torch.where(counts[:, None] > 0,
                              sums / torch.clamp(counts[:, None], min=1), centers)
    return centers


def extract_palette(image01: torch.Tensor, num_colors: int = 5, random_state: int = 0,
                    init_idx: torch.Tensor | None = None) -> torch.Tensor:
    """KMeans palette in CIELAB (:395-409). Returns [num_colors, 3] RGB.
    The starts are ``init_idx`` (pixel indices) or drawn from a generator
    seeded with ``random_state``."""
    lab = rgb_to_cielab(image01).reshape(-1, 3)
    centers = _kmeans_lab(lab, num_colors, generator=torch.Generator().manual_seed(random_state),
                          init_idx=init_idx)
    return cielab_to_rgb(centers)


def map_colors(image01: torch.Tensor, palette_rgb01: torch.Tensor) -> torch.Tensor:
    """Nearest palette color per pixel in CIELAB (:412-428)."""
    shape = image01.shape
    lab = rgb_to_cielab(image01).reshape(-1, 3)
    pal_lab = rgb_to_cielab(palette_rgb01)
    mapped = pal_lab[torch.argmin(_sq_distances(lab, pal_lab), dim=1)]
    return cielab_to_rgb(mapped.reshape(shape))


def blend_images_with_intensity(base: torch.Tensor, over: torch.Tensor,
                                intensity: float = 1.0) -> torch.Tensor:
    """Gamma-2.2 blend (:431-437)."""
    b = torch.clamp(base, min=0.0) ** 2.2
    o = torch.clamp(over, min=0.0) ** 2.2
    return (b * intensity + o * (1.0 - intensity)) ** (1 / 2.2)


def stylize_with_palette(
    content,
    style,
    model: str = "ResNet",
    palette_name: str = "Vintage",
    palette_intensity: float = 0.25,
    iterations: int = 300,
    size: int = 256,
    saturation: float = 1.0,
    hue: float = 0.0,
    noise: torch.Tensor | None = None,
    device=None,
) -> torch.Tensor:
    """Full seven_page pipeline: NST -> palette map -> intensity blend.
    Returns HWC [0,1] on ``device``."""
    from aip_tpu_torch.ops.image import resize_bilinear
    from aip_tpu_torch.pipelines.adain_infer import _to_array

    dev = resolve_device(device)

    def square(img):
        return resize_bilinear(torch.from_numpy(_to_array(img)).to(dev), (size, size),
                               antialias=True)[None]

    out = style_transfer(square(content), square(style), model=model, iterations=iterations,
                         noise=noise, device=dev)
    palette = adjust_palette_hsl(
        hex_to_rgb_palette(PREDEFINED_PALETTES[palette_name]), saturation, hue)
    mapped = map_colors(out[0], torch.tensor(palette, dtype=torch.float32, device=dev))
    blended = blend_images_with_intensity(mapped, out[0], palette_intensity)
    return torch.clamp(blended, 0.0, 1.0)
