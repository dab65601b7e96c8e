"""Localized style transfer: aip_tpu_torch against aip_tpu on the CPU.

The colour ops, the classical segmenter, ResNet-50, DeepLabV3-ResNet101 (a
tree of 2 blocks a stage, which runs both the first-block and the later
dilations, called eagerly on the JAX side), both converters on synthetic
torchvision-layout state dicts, the pipeline and its CLI. Parameters and
inputs are drawn with numpy from a seed and handed to both packages.

Tolerances: colour ops 1e-5 (absolute; the lab values are O(1)); the
classical masks equal wherever the background probability lies more than
1e-4 from the threshold; ResNet and DeepLab outputs within 1e-4 of the
largest |value|; the pipeline's combined array within 1e-3 mean abs
(BASELINE.md's AdaIN budget).
"""

import functools

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from aip_tpu.cli import run_semantic_segm as jcli
from aip_tpu.models import deeplab as jdeeplab
from aip_tpu.models import decoder as jdec
from aip_tpu.models import resnet as jresnet
from aip_tpu.models import segmenter as jseg
from aip_tpu.models import vgg as jvgg
from aip_tpu.models.vgg19_std import IMAGENET_MEAN, IMAGENET_STD
from aip_tpu.models import weights as jweights
from aip_tpu.ops import color as jcolor
from aip_tpu.pipelines import adain_infer as jinfer
from aip_tpu.pipelines import localized as jlocal
from aip_tpu_torch.cli import run_semantic_segm as tcli
from aip_tpu_torch.kernels import adain_head as K
from aip_tpu_torch.models import deeplab as tdeeplab
from aip_tpu_torch.models import resnet as tresnet
from aip_tpu_torch.models import segmenter as tseg
from aip_tpu_torch.models import weights as tweights
from aip_tpu_torch.ops import color as tcolor
from aip_tpu_torch.pipelines import adain_infer as tinfer
from aip_tpu_torch.pipelines import localized as tlocal

torch.set_num_threads(2)

COLOR_TOL = 1e-5
NET_TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-12)


# ---------------------------------------------------------------------------
# ops/color.py
# ---------------------------------------------------------------------------

def test_lab_round_trip_matches_jax(rng):
    rgb = rng.random((500, 3)).astype(np.float32)
    rgb[:5] = 0.0  # the 1e-6 LMS floor
    lab = tcolor.rgb_to_lab(_t(rgb)).numpy()
    np.testing.assert_allclose(lab, np.asarray(jcolor.rgb_to_lab(jnp.asarray(rgb))),
                               atol=COLOR_TOL)
    lab_in = (lab + rng.normal(0, 0.3, lab.shape)).astype(np.float32)  # some clip
    np.testing.assert_allclose(tcolor.lab_to_rgb(_t(lab_in)).numpy(),
                               np.asarray(jcolor.lab_to_rgb(jnp.asarray(lab_in))),
                               atol=COLOR_TOL)


@pytest.mark.parametrize("share", [1.0, 0.3, 0.0])
def test_weighted_pca1_matches_jax(rng, share):
    """Anisotropic points; the component's sign follows its largest entry.
    share 0: no weighted point (n clamps to 1)."""
    x = (rng.standard_normal((400, 3)) @ np.diag([2.0, 0.7, 0.2])
         @ np.linalg.qr(rng.standard_normal((3, 3)))[0]).astype(np.float32)
    w = (rng.random(400) < share).astype(np.float32)
    ref = jcolor.weighted_pca1(jnp.asarray(x), jnp.asarray(w))
    out = tcolor.weighted_pca1(_t(x), _t(w))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=COLOR_TOL)
    if share:
        comp = out[2].numpy()
        assert comp[np.argmax(np.abs(comp))] > 0


@pytest.mark.parametrize("k", [1, 7, 1024])
def test_masked_quantile_grid_matches_jax(rng, k):
    v = rng.standard_normal(300).astype(np.float32)
    w = (rng.random(300) < 0.4).astype(np.float32)
    np.testing.assert_allclose(tcolor.masked_quantile_grid(_t(v), _t(w), k).numpy(),
                               np.asarray(jcolor.masked_quantile_grid(jnp.asarray(v),
                                                                      jnp.asarray(w), k)),
                               atol=COLOR_TOL)


def test_linspace_is_jax_float32_linspace():
    for k in (2, 3, 1000, 1024):
        assert np.array_equal(tcolor._linspace(k, "cpu").numpy(),
                              np.asarray(jnp.linspace(0.0, 1.0, k)))


def test_interp_follows_jax_on_repeated_grid_values():
    """A grid full of repeated values: jnp.interp's rule (searchsorted
    right, the left value on a flat step, the ends outside) decides the
    answer. np.interp's differs there: at x == xp[-1] where the last grid
    value repeats, jnp.interp takes the left value of the flat step (9),
    np.interp fp[-1] (10)."""
    xp = np.array([0.0, 0.0, 0.0, 0.5, 0.5, 1.0, 1.0, 1.0, 2.0, 2.0], np.float32)
    fp = np.array([-3.0, -1.0, 0.0, 1.0, 4.0, 5.0, 7.0, 8.0, 9.0, 10.0], np.float32)
    x = np.array([-1.0, 0.0, 0.25, 0.5, 0.75, 1.0, 1.5, 2.0, 3.0,
                  np.nextafter(np.float32(0.5), np.float32(1.0))], np.float32)
    ref = np.asarray(jnp.interp(jnp.asarray(x), jnp.asarray(xp), jnp.asarray(fp)))
    out = tcolor._interp(_t(x), _t(xp), _t(fp)).numpy()
    np.testing.assert_allclose(out, ref, atol=COLOR_TOL)
    assert out[7] == 9.0 and np.interp(x, xp, fp)[7] == 10.0


@pytest.mark.parametrize("levels", [4, 60])
def test_masked_cdf_match_matches_jax_with_many_ties(rng, levels):
    """Quantised values: both quantile grids repeat values many times."""
    t = (np.round(rng.random(900) * levels) / levels).astype(np.float32)
    s = (rng.standard_normal(700) * 0.3).astype(np.float32)
    tw = (rng.random(900) < 0.6).astype(np.float32)
    sw = (rng.random(700) < 0.5).astype(np.float32)
    # the source on the target's support: same length, as in the pipeline
    s = np.resize(s, 900)
    sw = np.resize(sw, 900)
    ref = jcolor.masked_cdf_match(*map(jnp.asarray, (t, tw, s, sw)), k=256)
    out = tcolor.masked_cdf_match(*map(_t, (t, tw, s, sw)), k=256)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=COLOR_TOL)


def test_harmonize_foreground_matches_jax(rng):
    h, w = 24, 30
    fg = rng.random((h, w, 3)).astype(np.float32)
    bg = (rng.random((h, w, 3)) * 0.5 + 0.25).astype(np.float32)
    fgm = np.zeros((h, w), bool)
    fgm[6:18, 8:22] = True
    bgm = ~fgm
    ref = jcolor.harmonize_foreground(jnp.asarray(fg * fgm[..., None]),
                                      jnp.asarray(bg * bgm[..., None]),
                                      jnp.asarray(fgm), jnp.asarray(bgm))
    out = tcolor.harmonize_foreground(_t(fg * fgm[..., None]), _t(bg * bgm[..., None]),
                                      _t(fgm), _t(bgm))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=COLOR_TOL)


# ---------------------------------------------------------------------------
# models/segmenter.py
# ---------------------------------------------------------------------------

def _object_image(rng, h, w, noise=0.03):
    """A coloured object on a plain, slightly noisy border colour."""
    img = np.empty((h, w, 3), np.float32)
    img[:] = (0.35, 0.55, 0.75)
    yy, xx = np.mgrid[0:h, 0:w]
    blob = ((yy - h * 0.55) / (h * 0.3)) ** 2 + ((xx - w * 0.45) / (w * 0.28)) ** 2 < 1
    img[blob] = (0.8, 0.3, 0.2)
    img += rng.normal(0, noise, img.shape).astype(np.float32)
    return np.clip(img, 0, 1)


@pytest.mark.parametrize("hw", [(40, 56), (63, 47)])
def test_background_mask_matches_jax_outside_the_threshold_band(rng, hw):
    img = _object_image(rng, *hw, noise=0.08)
    ref = np.asarray(jseg.extract_background_mask(img))
    prob = tseg.background_probability(_t(img)).numpy()
    out = tseg.extract_background_mask(img, device="cpu").numpy()
    assert out.dtype == ref.dtype == np.uint8
    far = np.abs(prob - 0.5) > 1e-4
    assert np.array_equal(out[far], ref[far])
    assert 0.2 < out.mean() < 0.95
    # uint8 and RGBA inputs take the same path
    rgba = np.concatenate([img, np.ones(hw + (1,), np.float32)], -1)
    assert np.array_equal(tseg.extract_background_mask(rgba, device="cpu").numpy(), out)
    u8 = (img * 255).astype(np.uint8)
    assert np.array_equal(tseg.extract_background_mask(u8, device="cpu").numpy(),
                          np.asarray(jseg.extract_background_mask(u8)))


def test_registered_segmenter_is_used(monkeypatch):
    monkeypatch.setattr(tseg, "_REGISTERED", None)
    seen = []
    tseg.register_segmenter(lambda img: seen.append(img.shape) or np.ones(img.shape[:2]))
    out = tseg.extract_background_mask(np.zeros((5, 6, 3), np.float32), device="cpu")
    assert seen == [(5, 6, 3)] and out.shape == (5, 6)


# ---------------------------------------------------------------------------
# models/resnet.py and models/deeplab.py
# ---------------------------------------------------------------------------

def _w(rng, kh, kw, cin, cout):
    return (rng.standard_normal((kh, kw, cin, cout), dtype=np.float32)
            * np.float32((2.0 / (kh * kw * cin)) ** 0.5))


def _bn(rng, c, gamma=1.0):
    return {"gamma": (gamma * rng.uniform(0.5, 1.5, c)).astype(np.float32),
            "beta": rng.normal(0, 0.1, c).astype(np.float32),
            "mean": rng.normal(0, 0.1, c).astype(np.float32),
            "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}


def _bottlenecks(rng, stages, key):
    """JAX-layout stages; ``key(name)`` names a conv ('conv1' -> 'conv1_w' or
    {'conv1': {'w'}}). The last BN of a branch is scaled down so that deep
    random nets stay in range."""
    out, cin = [], 64
    for blocks, width, cout in stages:
        stage = []
        for bi in range(blocks):
            block = {}
            for name, (k, ci, co) in (("conv1", (1, cin if bi == 0 else cout, width)),
                                      ("conv2", (3, width, width)),
                                      ("conv3", (1, width, cout))):
                block.update(key(name, _w(rng, k, k, ci, co)))
            block.update(bn1=_bn(rng, width), bn2=_bn(rng, width), bn3=_bn(rng, cout, 0.3))
            if bi == 0:
                block.update(key("down", _w(rng, 1, 1, cin, cout)))
                block["down_bn"] = _bn(rng, cout)
            stage.append(block)
        out.append(stage)
        cin = cout
    return out


def _resnet_tree(rng):
    return {"stem_conv": {"w": _w(rng, 7, 7, 3, 64)}, "stem_bn": _bn(rng, 64),
            "stages": _bottlenecks(rng, jresnet.STAGES,
                                   lambda n, w: {("down_conv" if n == "down" else n): {"w": w}})}


def _deeplab_tree(rng, blocks=2):
    stages = [(blocks, width, out) for _b, width, out, *_ in jdeeplab.STAGES]
    a = {"convs": [_w(rng, 1, 1, 2048, 256)] + [_w(rng, 3, 3, 2048, 256) for _ in range(3)],
         "bns": [_bn(rng, 256) for _ in range(4)],
         "pool_w": _w(rng, 1, 1, 2048, 256), "pool_bn": _bn(rng, 256),
         "project_w": _w(rng, 1, 1, 1280, 256), "project_bn": _bn(rng, 256)}
    return {"stem_w": _w(rng, 7, 7, 3, 64), "stem_bn": _bn(rng, 64),
            "stages": _bottlenecks(rng, stages, lambda n, w: {f"{n}_w": w}),
            "aspp": a, "head_w": _w(rng, 3, 3, 256, 256), "head_bn": _bn(rng, 256),
            "cls_w": _w(rng, 1, 1, 256, 21),
            "cls_b": rng.normal(0, 0.1, 21).astype(np.float32)}


def test_resnet50_features_match_jax(rng):
    tree = _resnet_tree(rng)
    x = rng.standard_normal((1, 45, 38, 3)).astype(np.float32)
    ref = jresnet.resnet50_features(tree, jnp.asarray(x))
    out = tresnet.resnet50_features(tresnet.from_jax_params(tree, "cpu"), _t(x))
    assert list(out) == ["layer1", "layer2", "layer3", "layer4"]
    for name in out:
        assert out[name].shape == ref[name].shape
        assert _rel(out[name].numpy(), ref[name]) <= NET_TOL, name


@pytest.fixture(scope="module")
def deeplab_case():
    """A tree of 2 blocks a stage, a 65x49 image, and the JAX package's
    logits of its ImageNet normalisation (eager: no jit, no compile)."""
    rng = np.random.default_rng(5)
    tree = _deeplab_tree(rng)
    img = rng.random((65, 49, 3)).astype(np.float32)
    x = (img - np.array(IMAGENET_MEAN, np.float32)) / np.array(IMAGENET_STD, np.float32)
    ref = np.asarray(jdeeplab.deeplab_logits(tree, jnp.asarray(x)[None]))
    return tdeeplab.from_jax_params(tree, "cpu"), img, x, ref


def test_deeplab_two_blocks_a_stage_matches_jax(deeplab_case):
    """Layer 3 and 4 with two blocks each run the first-block dilation (1
    and 2) and the stage dilation (2 and 4); the ASPP rates 12/24/36 reach
    past a 9x7 map."""
    params, _img, x, ref = deeplab_case
    out = tdeeplab.deeplab_logits(params, _t(x)[None]).numpy()
    assert out.shape == ref.shape == (1, 65, 49, 21)
    assert _rel(out, ref) <= NET_TOL


def test_deeplab_segmenter_is_the_jax_logits_class0_step(deeplab_case):
    """The segmenter normalises, takes the softmax and thresholds class 0:
    equal to that step of the JAX package's logits (its jitted segmenter
    runs the same graph) wherever P(class 0) lies more than 1e-4 from 0.5."""
    params, img, _x, ref = deeplab_case
    logits = ref[0].astype(np.float64)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p0 = p[..., 0] / p.sum(-1)
    out = tdeeplab.make_background_segmenter(params)(img).numpy()
    far = np.abs(p0 - 0.5) > 1e-4
    assert out.dtype == np.uint8 and out.shape == (65, 49)
    assert np.array_equal(out[far], (p0 > 0.5)[far])


def _torch_bn_sd(rng, sd, prefix, c, gamma=1.0):
    bn = _bn(rng, c, gamma)
    sd.update({f"{prefix}.weight": bn["gamma"], f"{prefix}.bias": bn["beta"],
               f"{prefix}.running_mean": bn["mean"], f"{prefix}.running_var": bn["var"],
               f"{prefix}.num_batches_tracked": np.array(0, np.int64)})


def _oihw(rng, cout, cin, k):
    return np.ascontiguousarray(np.transpose(_w(rng, k, k, cin, cout), (3, 2, 0, 1)))


def _torch_backbone_sd(rng, stages, b=""):
    sd = {f"{b}conv1.weight": _oihw(rng, 64, 3, 7)}
    _torch_bn_sd(rng, sd, f"{b}bn1", 64)
    cin = 64
    for si, (blocks, width, cout, *_r) in enumerate(stages):
        for bi in range(blocks):
            p = f"{b}layer{si + 1}.{bi}"
            sd[f"{p}.conv1.weight"] = _oihw(rng, width, cin if bi == 0 else cout, 1)
            sd[f"{p}.conv2.weight"] = _oihw(rng, width, width, 3)
            sd[f"{p}.conv3.weight"] = _oihw(rng, cout, width, 1)
            for i, c in ((1, width), (2, width), (3, cout)):
                _torch_bn_sd(rng, sd, f"{p}.bn{i}", c, 0.3 if i == 3 else 1.0)
            if bi == 0:
                sd[f"{p}.downsample.0.weight"] = _oihw(rng, cout, cin, 1)
                _torch_bn_sd(rng, sd, f"{p}.downsample.1", cout)
        cin = cout
    return sd


def _torch_deeplab_sd(rng):
    sd = _torch_backbone_sd(rng, jdeeplab.STAGES, "backbone.")
    c = "classifier.0"
    for i in range(4):
        sd[f"{c}.convs.{i}.0.weight"] = _oihw(rng, 256, 2048, 1 if i == 0 else 3)
        _torch_bn_sd(rng, sd, f"{c}.convs.{i}.1", 256)
    sd[f"{c}.convs.4.1.weight"] = _oihw(rng, 256, 2048, 1)
    _torch_bn_sd(rng, sd, f"{c}.convs.4.2", 256)
    sd[f"{c}.project.0.weight"] = _oihw(rng, 256, 1280, 1)
    _torch_bn_sd(rng, sd, f"{c}.project.1", 256)
    sd["classifier.1.weight"] = _oihw(rng, 256, 256, 3)
    _torch_bn_sd(rng, sd, "classifier.2", 256)
    sd["classifier.4.weight"] = _oihw(rng, 21, 256, 1)
    sd["classifier.4.bias"] = rng.normal(0, 0.1, 21).astype(np.float32)
    sd["aux_classifier.0.weight"] = _oihw(rng, 8, 1024, 3)  # ignored by both
    return sd


def _save_sd(sd, path):
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, str(path))
    return path


def test_deeplab_checkpoint_gives_jax_logits(rng, tmp_path):
    """A torchvision-layout deeplabv3_resnet101 state dict at full depth
    (101 layers), saved with torch.save: both packages' get_deeplab_params
    read it (the port with its own weights_only loader) and give the same
    logits."""
    path = _save_sd(_torch_deeplab_sd(rng), tmp_path / "deeplab.pth")
    x = rng.standard_normal((1, 21, 19, 3)).astype(np.float32)
    jp = jdeeplab.get_deeplab_params(str(path))
    ref = np.asarray(jdeeplab.deeplab_logits(jp, jnp.asarray(x)))
    del jp
    tp = tdeeplab.get_deeplab_params(str(path), device="cpu")
    assert [len(s) for s in tp["stages"]] == [3, 4, 23, 3]
    out = tdeeplab.deeplab_logits(tp, _t(x)).numpy()
    assert _rel(out, ref) <= NET_TOL


def test_resnet_checkpoint_gives_jax_features(rng, tmp_path):
    path = _save_sd(_torch_backbone_sd(rng, jresnet.STAGES), tmp_path / "resnet50.pth")
    x = rng.standard_normal((1, 37, 42, 3)).astype(np.float32)
    ref = jresnet.resnet50_features(jresnet.get_resnet50_params(str(path)), jnp.asarray(x))
    out = tresnet.resnet50_features(tresnet.get_resnet50_params(str(path), device="cpu"),
                                    _t(x))
    for name in out:
        assert _rel(out[name].numpy(), ref[name]) <= NET_TOL, name


def _shapes(tree):
    """Leaf shapes of a JAX-layout tree, convs as OIHW."""
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    s = tuple(np.shape(tree))
    return s if len(s) != 4 else (s[3], s[2], s[0], s[1])


def _port_shapes(mod):
    if isinstance(mod, torch.nn.Parameter):
        return tuple(mod.shape)
    if isinstance(mod, (torch.nn.ModuleList, torch.nn.ParameterList)):
        return [_port_shapes(m) for m in mod]
    return {k: _port_shapes(v) for k, v in
            list(mod._parameters.items()) + list(mod._modules.items())}


def test_default_inits_have_the_jax_layout(rng):
    """Without a checkpoint the port falls back to its deterministic init
    (other draws than aip_tpu's): the trees have the JAX package's keys and
    shapes (``init_resnet50_params`` / ``init_deeplab_params``), and one
    generator seed gives one tree."""
    assert _port_shapes(tresnet.get_resnet50_params(device="cpu")) == _shapes(_resnet_tree(rng))
    full = _deeplab_tree(rng, blocks=1)
    full["stages"] = [[full["stages"][si][0]] + [_bottlenecks(rng, [(2, w, o)], lambda n, a: {
        f"{n}_w": a})[0][1]] * (b - 1) for si, (b, w, o, *_r) in enumerate(jdeeplab.STAGES)]
    assert _port_shapes(tdeeplab.get_deeplab_params(device="cpu")) == _shapes(full)
    a = tresnet.init_resnet50_params(torch.Generator().manual_seed(3), "cpu")["stem_conv"]["w"]
    b = tresnet.init_resnet50_params(torch.Generator().manual_seed(3), "cpu")["stem_conv"]["w"]
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# pipelines/localized.py and the CLI
# ---------------------------------------------------------------------------

def _hwio_params(rng, specs):
    return [{"w": (rng.standard_normal((k, k, cin, cout)) * (2.0 / (k * k * cin)) ** 0.5)
                  .astype(np.float32),
             "b": (rng.standard_normal(cout) * 0.05).astype(np.float32)}
            for k, cin, cout in specs]


@pytest.fixture
def shared_adain(tmp_path_factory, monkeypatch):
    """One AdaIN weight cache for both packages, and both packages'
    localized pipelines stylizing at a 32-px working size (PNG-free: the
    stylized image is the JPEG adain_inference writes, as in the pipeline)."""
    rng = np.random.default_rng(11)
    d = tmp_path_factory.mktemp("weights")
    jweights.save_params_npz(
        _hwio_params(rng, [(k, cin, cout) for _, cin, cout, k, _ in jvgg.conv_specs()]),
        d / "vgg_normalised.npz")
    jweights.save_params_npz(
        _hwio_params(rng, [(3, cin, cout) for _, cin, cout, _ in jdec.conv_specs()]),
        d / "adain_decoder.npz")
    monkeypatch.setattr(jweights, "DEFAULT_WEIGHTS_DIR", d)
    monkeypatch.setattr(tweights, "DEFAULT_WEIGHTS_DIR", d)
    for local, infer in ((jlocal, jinfer), (tlocal, tinfer)):
        monkeypatch.setattr(local, "adain_inference", functools.partial(
            infer.adain_inference, content_size=32, style_size=32))


@pytest.fixture
def captured(monkeypatch):
    """The combined array each package hands to save_image."""
    out = {}
    for name, local in (("jax", jlocal), ("port", tlocal)):
        orig = local.save_image

        def spy(arr, path, _name=name, _orig=orig):
            out[_name] = np.asarray(arr.detach().numpy() if isinstance(arr, torch.Tensor)
                                    else arr, np.float32)
            return _orig(arr, path)

        monkeypatch.setattr(local, "save_image", spy)
    return out


@pytest.fixture
def images(tmp_path, rng):
    c, s = tmp_path / "content.png", tmp_path / "style.png"
    Image.fromarray((_object_image(rng, 40, 56) * 255).astype(np.uint8)).save(c)
    Image.fromarray((rng.random((36, 36, 3)) * 255).astype(np.uint8)).save(s)
    return str(c), str(s)


def test_localized_style_transfer_matches_jax(shared_adain, captured, images, tmp_path):
    """40x56 content, stylized at 32x44 (the nearest-resize branch), the
    classical mask: masks equal, combined arrays within 1e-3 mean abs."""
    content = tinfer._to_array(images[0])
    assert np.array_equal(tseg.extract_background_mask(content, device="cpu").numpy(),
                          np.asarray(jseg.extract_background_mask(content)))
    ref = jlocal.run_localized_style_transfer(*images, output_path=str(tmp_path / "j"))
    out = tlocal.run_localized_style_transfer(*images, output_path=str(tmp_path / "t"),
                                              device="cpu")
    assert out.endswith("localized_style_transfer_result.jpg")
    assert Image.open(out).size == Image.open(ref).size == (56, 40)
    a, b = captured["port"], captured["jax"]
    assert a.shape == b.shape == (40, 56, 3)
    assert np.abs(a - b).mean() <= 1e-3, np.abs(a - b).mean()


def test_composite_localized_keeps_the_background_and_recolours_the_foreground(rng):
    content = _object_image(rng, 20, 24)
    stylized = rng.random((16, 18, 3)).astype(np.float32)  # the working size
    mask = np.zeros((20, 24), np.uint8)
    mask[:6] = 1
    out = tlocal.composite_localized(content, stylized, mask, device="cpu")
    resized = tlocal._numpy(tlocal.resize_nearest(_t(stylized), (20, 24)))
    assert np.array_equal(out[:6], resized[:6])
    assert not np.allclose(out[6:], content[6:])
    with pytest.raises(ValueError, match="mask/content"):
        tlocal.composite_localized(content[:19], stylized, mask, device="cpu")


def test_localized_with_a_segment_fn_and_the_cli(shared_adain, captured, images, tmp_path):
    """A segment_fn replaces the default segmenter; the CLI (plus --device)
    writes the same result as aip_tpu's."""
    half = lambda img: (np.arange(img.shape[1])[None, :] < img.shape[1] // 2).repeat(
        img.shape[0], 0).astype(np.uint8)
    jlocal.run_localized_style_transfer(*images, output_path=str(tmp_path / "j"),
                                        segment_fn=half)
    tlocal.run_localized_style_transfer(*images, output_path=str(tmp_path / "t"),
                                        segment_fn=half, device="cpu")
    assert np.abs(captured["port"] - captured["jax"]).mean() <= 1e-3
    argv = ["--content", images[0], "--style", images[1], "--file_name", "x"]
    ref = jcli.main(argv + ["--output", str(tmp_path / "jc")])
    out = tcli.main(argv + ["--output", str(tmp_path / "tc"), "--device", "cpu"])
    assert np.abs(captured["port"] - captured["jax"]).mean() <= 1e-3
    assert Image.open(out).size == Image.open(ref).size


def test_localized_runs_the_fp32_route_only_through_the_plain_versions_on_the_cpu(
        shared_adain, images, tmp_path):
    K.reset_launch_counts()
    tlocal.run_localized_style_transfer(*images, output_path=str(tmp_path / "t"),
                                        device="cpu")
    assert K.launch_counts() == {"encode_head": 0, "decode_tail": 0}


def test_localized_entry_points_without_cuda_raise(images, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = np.zeros((8, 8, 3), np.float32)
    calls = [
        lambda: tlocal.run_localized_style_transfer(*images),
        lambda: tlocal.composite_localized(img, img, np.zeros((8, 8), np.uint8)),
        lambda: tcli.main(["--content", images[0], "--style", images[1]]),
        lambda: tseg.extract_background_mask(img),
        lambda: tdeeplab.init_deeplab_params(),
        lambda: tdeeplab.get_deeplab_params(),
        lambda: tresnet.get_resnet50_params(),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_an_empty_background_harmonizes_to_nan_in_both_packages(rng):
    """Not a port fault: with no background pixel the source quantile grid
    is the float32-max sentinel, and both packages' harmonization turns the
    foreground to NaN (as the reference's would have nothing to match)."""
    fg = rng.random((8, 10, 3)).astype(np.float32)
    fgm, bgm = np.ones((8, 10), bool), np.zeros((8, 10), bool)
    ref = np.asarray(jcolor.harmonize_foreground(jnp.asarray(fg), jnp.asarray(fg * 0),
                                                 jnp.asarray(fgm), jnp.asarray(bgm)))
    out = tcolor.harmonize_foreground(_t(fg), _t(fg * 0), _t(fgm), _t(bgm)).numpy()
    assert np.isnan(ref).all() and np.isnan(out).all()
