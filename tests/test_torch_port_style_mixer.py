"""The style mixer: aip_tpu_torch against aip_tpu on the CPU.

DenseNet-121 (a tree of 2 layers a block: the forward reads its depth from
the parameters) and Swin-T (full depth at 64^2, where windows pad and stage
4 fits one window and skips its shift, and at 96x128), both converters on
synthetic torchvision-layout state dicts, the CIELAB pair, k-means and
``map_colors`` from the same starting centres, the blend, the palette
helpers, ``style_transfer`` with a registered backbone and
``stylize_with_palette`` with each built-in backbone (small trees from numpy
seeds handed to both packages), with the JAX package's noise handed to the
port.

Tolerances: backbone features within 1e-4 of the largest |value|; LAB
within 1e-4 (L in [0, 100]; the cube root is a power here, an ulp or two
from ``jnp.cbrt``), RGB from LAB within 1e-5; k-means palettes within 1e-4;
``map_colors`` equal to 1e-5 except at near-ties of the LAB distance (at
most 0.5 % of the pixels, each a gap of at most 1e-3); images after Adam
steps within 1e-4 absolute.
"""

import random

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from aip_tpu.models import densenet as jdense
from aip_tpu.models import lpips as jlpips
from aip_tpu.models import resnet as jresnet
from aip_tpu.models import swin as jswin
from aip_tpu.models import weights as jweights
from aip_tpu.pipelines import style_mixer as jmix
from aip_tpu_torch.models import densenet as tdense
from aip_tpu_torch.models import resnet as tresnet
from aip_tpu_torch.models import swin as tswin
from aip_tpu_torch.models import weights as tweights
from aip_tpu_torch.pipelines import style_mixer as tmix

torch.set_num_threads(2)

NET_TOL = 1e-4
IMG_TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-12)


def _bn(g, c):
    return {"gamma": (1 + g.normal(0, .1, c)).astype(np.float32),
            "beta": g.normal(0, .1, c).astype(np.float32),
            "mean": g.normal(0, .1, c).astype(np.float32),
            "var": (1 + g.random(c)).astype(np.float32)}


def _w(g, kh, kw, cin, cout):
    return (g.standard_normal((kh, kw, cin, cout)) * (2 / (kh * kw * cin)) ** .5).astype(
        np.float32)


def _densenet_tree(seed, config=(2, 2, 2, 2)):
    """An HWIO DenseNet tree with ``config`` layers a block (growth 32)."""
    g = np.random.default_rng(seed)
    p = {"stem_w": _w(g, 7, 7, 3, 64), "stem_bn": _bn(g, 64), "blocks": [], "transitions": []}
    c = 64
    for bi, n in enumerate(config):
        p["blocks"].append([{"bn1": _bn(g, c + i * 32), "w1": _w(g, 1, 1, c + i * 32, 128),
                             "bn2": _bn(g, 128), "w2": _w(g, 3, 3, 128, 32)} for i in range(n)])
        c += n * 32
        if bi < 3:
            p["transitions"].append({"bn": _bn(g, c), "w": _w(g, 1, 1, c, c // 2)})
            c //= 2
    p["norm5"] = _bn(g, c)
    return p


def _resnet_tree(seed):
    """An HWIO ResNet-50 tree with one bottleneck a stage."""
    g = np.random.default_rng(seed)
    p = {"stem_conv": {"w": _w(g, 7, 7, 3, 64)}, "stem_bn": _bn(g, 64), "stages": []}
    cin = 64
    for _blocks, width, out in jresnet.STAGES:
        p["stages"].append([{
            "conv1": {"w": _w(g, 1, 1, cin, width)}, "bn1": _bn(g, width),
            "conv2": {"w": _w(g, 3, 3, width, width)}, "bn2": _bn(g, width),
            "conv3": {"w": _w(g, 1, 1, width, out)}, "bn3": _bn(g, out),
            "down_conv": {"w": _w(g, 1, 1, cin, out)}, "down_bn": _bn(g, out)}])
        cin = out
    return p


@pytest.fixture(scope="module")
def swin_tree():
    """A Swin-T tree of the JAX package's shapes, every leaf drawn with numpy
    (LayerNorms about 1, the rest about the init's scale)."""
    g = np.random.default_rng(3)
    shapes = jax.eval_shape(jswin.init_swin_t_params, jax.random.PRNGKey(0))

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        scale = 0.02 if "bias_table" in name or "patch" in name else s.shape[0] ** -0.5
        base = 1.0 if name.endswith("['g']") else 0.0
        return jnp.asarray(base + g.normal(0, scale if len(s.shape) > 1 else 0.05, s.shape),
                           jnp.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


# ---------------------------------------------------------------------------
# models/densenet.py, models/swin.py
# ---------------------------------------------------------------------------

def test_densenet_features_match_jax(rng):
    tree = _densenet_tree(0)
    x = rng.standard_normal((1, 64, 72, 3)).astype(np.float32)
    ref = jax.jit(jdense.densenet121_features)(tree, jnp.asarray(x))
    out = tdense.densenet121_features(tdense.from_jax_params(tree, "cpu"), _t(x))
    assert sorted(out) == sorted(ref) == ["layer1", "layer2", "layer3", "layer4"]
    for k in ref:
        assert tuple(out[k].shape) == ref[k].shape
        assert _rel(out[k].numpy(), ref[k]) <= NET_TOL, k


@pytest.mark.parametrize("hw", [(64, 64), (96, 128), (96, 160)])
def test_swin_features_match_jax(swin_tree, rng, hw):
    x = rng.standard_normal((1, *hw, 3)).astype(np.float32)
    ref = jax.jit(jswin.swin_t_features)(swin_tree, jnp.asarray(x))
    out = tswin.swin_t_features(tswin.from_jax_params(swin_tree, "cpu"), _t(x))
    assert sorted(out) == sorted(ref)
    assert tuple(out["swin"].shape) == (1, hw[0] // 32, hw[1] // 32, 768)
    for k in ref:
        assert _rel(out[k].numpy(), ref[k]) <= NET_TOL, k


def test_default_inits_have_the_jax_layout():
    jd = jax.tree.map(lambda s: s.shape, jax.eval_shape(jdense.init_densenet121_params,
                                                         jax.random.PRNGKey(0)))
    td = tdense.init_densenet121_params(device="cpu")
    assert len(td["blocks"]) == 4 and [len(b) for b in td["blocks"]] == [6, 12, 24, 16]
    assert tuple(td["blocks"][3][15]["w2"].shape) == (32, 128, 3, 3)
    assert jd["blocks"][3][15]["w2"] == (3, 3, 128, 32)
    assert tuple(td["norm5"]["gamma"].shape) == jd["norm5"]["gamma"] == (1024,)
    ts = tswin.init_swin_t_params(device="cpu")
    assert [len(s["blocks"]) for s in ts["stages"]] == list(jswin.DEPTHS)
    assert tuple(ts["stages"][2]["blocks"][0]["bias_table"].shape) == (169, 12)
    assert tuple(ts["patch_w"].shape) == (96, 3, 4, 4)


def _torchvision_densenet(g):
    """A state dict with torchvision ``densenet121``'s keys and shapes."""
    sd = {}

    def conv(k, shape):
        sd[f"{k}.weight"] = g.standard_normal(shape).astype(np.float32) * 0.05

    def bn(k, c):
        b = _bn(g, c)
        sd.update({f"{k}.weight": b["gamma"], f"{k}.bias": b["beta"],
                   f"{k}.running_mean": b["mean"], f"{k}.running_var": b["var"],
                   f"{k}.num_batches_tracked": np.array(3)})

    conv("features.conv0", (64, 3, 7, 7))
    bn("features.norm0", 64)
    c = 64
    for bi, n in enumerate(jdense.BLOCK_CONFIG):
        for li in range(n):
            p = f"features.denseblock{bi + 1}.denselayer{li + 1}"
            bn(f"{p}.norm1", c + li * 32)
            conv(f"{p}.conv1", (128, c + li * 32, 1, 1))
            bn(f"{p}.norm2", 128)
            conv(f"{p}.conv2", (32, 128, 3, 3))
        c += n * 32
        if bi < 3:
            bn(f"features.transition{bi + 1}.norm", c)
            conv(f"features.transition{bi + 1}.conv", (c // 2, c, 1, 1))
            c //= 2
    bn("features.norm5", c)
    sd["classifier.weight"] = np.zeros((1000, c), np.float32)
    return sd


def _torchvision_swin(g):
    """A state dict with torchvision ``swin_t``'s keys and shapes."""
    sd = {}

    def put(k, shape, scale=0.05):
        sd[k] = (g.standard_normal(shape) * scale).astype(np.float32)

    put("features.0.0.weight", (96, 3, 4, 4))
    put("features.0.0.bias", (96,))
    put("features.0.2.weight", (96,))
    put("features.0.2.bias", (96,))
    d = 96
    for si, depth in enumerate(jswin.DEPTHS):
        for bi in range(depth):
            p = f"features.{2 * si + 1}.{bi}"
            for name, shape in (("norm1.weight", (d,)), ("norm1.bias", (d,)),
                                ("attn.qkv.weight", (3 * d, d)), ("attn.qkv.bias", (3 * d,)),
                                ("attn.proj.weight", (d, d)), ("attn.proj.bias", (d,)),
                                ("attn.relative_position_bias_table",
                                 (169, jswin.HEADS[si])),
                                ("norm2.weight", (d,)), ("norm2.bias", (d,)),
                                ("mlp.0.weight", (4 * d, d)), ("mlp.0.bias", (4 * d,)),
                                ("mlp.3.weight", (d, 4 * d)), ("mlp.3.bias", (d,))):
                put(f"{p}.{name}", shape)
            sd[f"{p}.attn.relative_position_index"] = np.zeros(49 * 49, np.int64)
        if si < 3:
            m = f"features.{2 * si + 2}"
            put(f"{m}.norm.weight", (4 * d,))
            put(f"{m}.norm.bias", (4 * d,))
            put(f"{m}.reduction.weight", (2 * d, 4 * d))
            d *= 2
    put("norm.weight", (d,))
    put("norm.bias", (d,))
    put("head.weight", (1000, d))
    return sd


@pytest.mark.parametrize("net", ["densenet", "swin"])
def test_converters_match_jax_on_torchvision_state_dicts(tmp_path, net):
    """Each converter, directly and through ``get_*_params`` on a saved
    checkpoint, gives the tree the JAX package's converter gives."""
    g = np.random.default_rng(9)
    if net == "densenet":
        sd, jmod, tmod, get = _torchvision_densenet(g), jdense, tdense, "get_densenet121_params"
        jconv, tconv = jdense._convert_torch_densenet, tdense._convert_torch_densenet
    else:
        sd, jmod, tmod, get = _torchvision_swin(g), jswin, tswin, "get_swin_t_params"
        jconv, tconv = jswin._convert_torch_swin, tswin._convert_torch_swin
    ref = dict(tmod.from_jax_params(jax.tree.map(np.asarray, jconv(sd)), "cpu")
               .named_parameters())
    out = dict(tconv(sd, "cpu").named_parameters())
    assert sorted(out) == sorted(ref)
    assert all(torch.equal(out[k], ref[k]) for k in ref)
    ckpt = tmp_path / f"{net}.pth"
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, ckpt)
    loaded = dict(getattr(tmod, get)(str(ckpt), device="cpu").named_parameters())
    assert all(torch.equal(loaded[k], ref[k]) for k in ref)
    jloaded = getattr(jmod, get)(str(ckpt))
    assert jax.tree.structure(jloaded) == jax.tree.structure(jconv(sd))


# ---------------------------------------------------------------------------
# pipelines/style_mixer.py: the palette side
# ---------------------------------------------------------------------------

def test_palette_helpers_and_prompt_selection_match_jax(tmp_path):
    for name in tmix.PALETTE_MENU:
        pal = tmix.hex_to_rgb_palette(tmix.PREDEFINED_PALETTES[name])
        assert pal == jmix.hex_to_rgb_palette(jmix.PREDEFINED_PALETTES[name])
        assert (tmix.adjust_palette_hsl(pal, 0.6, 0.2)
                == jmix.adjust_palette_hsl(pal, 0.6, 0.2))
    for n in ("vangogh_1.jpg", "vangogh_2.png", "picasso.png", "notes.txt"):
        (tmp_path / n).write_bytes(b"")
    for prompt in ("Van Gogh night", "a cat"):
        random.seed(4)
        a = jmix.select_style_for_prompt(prompt, tmp_path)
        random.seed(4)
        assert tmix.select_style_for_prompt(prompt, tmp_path) == a


def test_cielab_pair_and_blend_match_jax(rng):
    rgb = rng.random((500, 3)).astype(np.float32)
    rgb[:3] = [[0, 0, 0], [1, 1, 1], [0.002, 0.001, 0.0]]
    lab = tmix.rgb_to_cielab(_t(rgb)).numpy()
    np.testing.assert_allclose(lab, np.asarray(jmix.rgb_to_cielab(jnp.asarray(rgb))), atol=1e-4)
    lab_in = (lab + rng.normal(0, 3, lab.shape)).astype(np.float32)
    np.testing.assert_allclose(tmix.cielab_to_rgb(_t(lab_in)).numpy(),
                               np.asarray(jmix.cielab_to_rgb(jnp.asarray(lab_in))), atol=1e-5)
    a, b = (rng.normal(0.5, 0.3, (20, 20, 3)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(tmix.blend_images_with_intensity(_t(a), _t(b), 0.3).numpy(),
                               np.asarray(jmix.blend_images_with_intensity(
                                   jnp.asarray(a), jnp.asarray(b), 0.3)), atol=1e-6)


def _clustered(rng, h=24, w=30, k=4):
    """An image of k well-separated colours plus noise (no k-means tie)."""
    centres = np.array([[0.9, 0.1, 0.1], [0.1, 0.2, 0.9], [0.2, 0.8, 0.2], [0.9, 0.9, 0.8]])
    labels = rng.integers(0, k, (h, w))
    return np.clip(centres[labels] + rng.normal(0, 0.03, (h, w, 3)), 0, 1).astype(np.float32)


@pytest.mark.parametrize("random_state", [0, 7])
def test_extract_palette_from_the_same_starting_centres(rng, random_state):
    img = _clustered(rng)
    k = 5
    idx = np.asarray(jax.random.choice(jax.random.PRNGKey(random_state), img.shape[0] *
                                       img.shape[1], (k,), replace=False))
    ref = np.asarray(jmix.extract_palette(jnp.asarray(img), k, random_state))
    out = tmix.extract_palette(_t(img), k, init_idx=_t(idx)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4)
    drawn = tmix.extract_palette(_t(img), k, random_state).numpy()
    assert drawn.shape == (k, 3)


def _near_tie_check(out, ref, image, palette):
    """Pixels where ``map_colors`` differs must be LAB near-ties."""
    differ = np.abs(out - ref).max(-1) > 1e-5
    lab = np.asarray(jmix.rgb_to_cielab(jnp.asarray(image)), np.float64)[differ]
    pal_lab = np.asarray(jmix.rgb_to_cielab(jnp.asarray(palette)), np.float64)
    d = ((lab[:, None] - pal_lab[None]) ** 2).sum(-1)
    d.sort(axis=1)
    assert differ.mean() <= 0.005
    assert (d[:, 1] - d[:, 0] <= 1e-3).all()


def test_map_colors_matches_jax(rng):
    img = rng.random((40, 50, 3)).astype(np.float32)
    pal = np.asarray(jmix.hex_to_rgb_palette(jmix.PREDEFINED_PALETTES["Vintage"]), np.float32)
    ref = np.asarray(jmix.map_colors(jnp.asarray(img), jnp.asarray(pal)))
    out = tmix.map_colors(_t(img), _t(pal)).numpy()
    _near_tie_check(out, ref, img, pal)


# ---------------------------------------------------------------------------
# style_transfer and stylize_with_palette
# ---------------------------------------------------------------------------

@pytest.fixture
def tiny_backbone(monkeypatch):
    """The same two-conv backbone registered in both packages."""
    g = np.random.default_rng(8)
    w1, w2 = _w(g, 3, 3, 3, 8), _w(g, 3, 3, 8, 8)

    def jfeats(x):
        y1 = jax.nn.relu(jax.lax.conv_general_dilated(x, w1, (1, 1), "SAME", dimension_numbers=(
            "NHWC", "HWIO", "NHWC")))
        y2 = jax.lax.conv_general_dilated(y1, w2, (2, 2), [(1, 1), (1, 1)], dimension_numbers=(
            "NHWC", "HWIO", "NHWC"))
        return {"layer2": y1, "layer3": y2, "layer4": jax.nn.relu(y2)}

    tw1, tw2 = (_t(np.transpose(w, (3, 2, 0, 1))) for w in (w1, w2))

    def tfeats(x):
        y1 = torch.relu(torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), tw1, padding=1))
        y2 = torch.nn.functional.conv2d(y1, tw2, stride=2, padding=1)
        return {"layer2": y1.permute(0, 2, 3, 1), "layer3": y2.permute(0, 2, 3, 1),
                "layer4": torch.relu(y2).permute(0, 2, 3, 1)}

    monkeypatch.setattr(jmix, "_EXTRA_BACKBONES", {"Tiny": jfeats})
    monkeypatch.setattr(tmix, "_EXTRA_BACKBONES", {})
    tmix.register_backbone("Tiny", tfeats)
    return "Tiny"


def test_style_transfer_with_a_registered_backbone_matches_jax(tiny_backbone, rng):
    c = rng.random((1, 24, 20, 3)).astype(np.float32)
    s = rng.random((1, 24, 20, 3)).astype(np.float32)
    ref = np.asarray(jmix.style_transfer(jnp.asarray(c), jnp.asarray(s), model=tiny_backbone,
                                         iterations=4, seed=3))
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(3), c.shape))
    out = tmix.style_transfer(_t(c), _t(s), model=tiny_backbone, iterations=4,
                              noise=_t(noise), device="cpu").numpy()
    assert np.abs(out - ref).max() <= IMG_TOL
    drawn = tmix.style_transfer(_t(c), _t(s), model=tiny_backbone, iterations=1, seed=3,
                                device="cpu")
    assert drawn.shape == (1, 24, 20, 3)


@pytest.fixture
def small_backbones(monkeypatch, tmp_path):
    """Both packages' built-in backbones on the same small weights: ResNet
    one block a stage, DenseNet two layers a block, VGG16 through the shared
    npz cache, Swin-T at full depth."""
    res, dense = _resnet_tree(1), _densenet_tree(2)
    g = np.random.default_rng(4)
    vgg = [{"w": _w(g, 3, 3, cin, cout), "b": (g.standard_normal(cout) * .05).astype(np.float32)}
           for _, cin, cout, _ in jlpips.conv_specs()]
    jweights.save_params_npz(vgg, tmp_path / "vgg16_imagenet.npz")
    monkeypatch.setattr(jweights, "DEFAULT_WEIGHTS_DIR", tmp_path)
    monkeypatch.setattr(tweights, "DEFAULT_WEIGHTS_DIR", tmp_path)
    monkeypatch.setattr(jresnet, "get_resnet50_params", lambda torch_path=None: res)
    monkeypatch.setattr(jdense, "get_densenet121_params", lambda torch_path=None: dense)
    monkeypatch.setattr(tresnet, "get_resnet50_params", lambda torch_path=None, device=None:
                        tresnet.from_jax_params(res, device))
    monkeypatch.setattr(tdense, "get_densenet121_params", lambda torch_path=None, device=None:
                        tdense.from_jax_params(dense, device))


@pytest.mark.parametrize("model,size", [("ResNet", 32), ("DenseNet", 32), ("VGG", 32),
                                        ("Swin", 64)])
def test_stylize_with_palette_matches_jax(small_backbones, swin_tree, monkeypatch, tmp_path,
                                          model, size):
    """The page's pipeline with each backbone, 2 iterations, the JAX
    package's seed-0 noise handed to the port."""
    monkeypatch.setattr(jswin, "get_swin_t_params", lambda torch_path=None: swin_tree)
    monkeypatch.setattr(tswin, "get_swin_t_params", lambda torch_path=None, device=None:
                        tswin.from_jax_params(swin_tree, device))
    g = np.random.default_rng(6)
    c, s = tmp_path / "c.png", tmp_path / "s.png"
    for p, hw in ((c, (40, 48)), (s, (36, 36))):
        Image.fromarray((g.random((*hw, 3)) * 255).astype(np.uint8)).save(p)
    kw = dict(model=model, iterations=2, size=size, palette_name="Mario", saturation=0.8)
    ref = np.asarray(jmix.stylize_with_palette(str(c), str(s), **kw))
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (1, size, size, 3)))
    out = tmix.stylize_with_palette(str(c), str(s), noise=_t(noise), device="cpu", **kw).numpy()
    assert out.shape == ref.shape == (size, size, 3)
    differ = np.abs(out - ref).max(-1) > IMG_TOL
    assert differ.mean() <= 0.005, differ.mean()


def test_style_mixer_entry_points_without_cuda_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = np.zeros((8, 8, 3), np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmix.stylize_with_palette(img, img, iterations=1, size=32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmix.get_feature_extractor("ResNet")
