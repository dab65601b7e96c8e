"""Optimisation NST: aip_tpu_torch against aip_tpu on the CPU.

``ops/gram.py``, the feathering window, ``nst_optimize`` (3 steps, two
weighted styles), ``run_style_transfer``, ``mix_styles``, ``color_mask``,
``spatially_varying_style_transfer`` and the CLI. The VGG-19 weights are
drawn with numpy from a seed and handed to both packages (``from_jax_params``
or the npz cache both read); images are 32-40 px.

Tolerances: Gram matrices 1e-6 of the largest entry; the feathering window
equal; masks 1e-6; images after NST steps 1e-5 absolute (each Adam step
moves a pixel by about lr whatever the gradient's size, so the images agree
to float32 rounding); the CLI's PNGs at most 1 level apart (the uint8
truncation of images 1e-7 apart).
"""

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from aip_tpu.cli import run_nst as jcli
from aip_tpu.models import vgg19_std as jv19
from aip_tpu.models import weights as jweights
from aip_tpu.ops import gram as jgram
from aip_tpu.ops import metrics as jmetrics
from aip_tpu.pipelines import nst as jnst
from aip_tpu_torch.cli import run_nst as tcli
from aip_tpu_torch.models import vgg19_std as tv19
from aip_tpu_torch.models import weights as tweights
from aip_tpu_torch.ops import gram as tgram
from aip_tpu_torch.ops import metrics as tmetrics
from aip_tpu_torch.pipelines import nst as tnst

torch.set_num_threads(2)

IMG_TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def vgg19():
    """HWIO VGG-19 (to conv5_1) from numpy seed 5, and the port's copy."""
    rng = np.random.default_rng(5)
    params = [{"w": (rng.standard_normal((3, 3, cin, cout)) * (2.0 / (9 * cin)) ** 0.5)
                    .astype(np.float32),
               "b": (rng.standard_normal(cout) * 0.05).astype(np.float32)}
              for _, cin, cout, _ in jv19.conv_specs()]
    return params, tv19.from_jax_params(params, "cpu")


@pytest.fixture
def shared_vgg19(vgg19, tmp_path, monkeypatch):
    """The same VGG-19 through the npz cache both packages read."""
    jweights.save_params_npz(vgg19[0], tmp_path / "vgg19_imagenet.npz")
    monkeypatch.setattr(jweights, "DEFAULT_WEIGHTS_DIR", tmp_path)
    monkeypatch.setattr(tweights, "DEFAULT_WEIGHTS_DIR", tmp_path)


def _images(tmp_path, n, h=40, w=36, seed=0):
    g = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        p = tmp_path / f"img{i}.png"
        Image.fromarray((g.random((h, w, 3)) * 255).astype(np.uint8)).save(p)
        paths.append(str(p))
    return paths


def test_gram_and_window_match_jax(rng):
    feat = rng.standard_normal((2, 7, 9, 16)).astype(np.float32)
    ref = np.asarray(jgram.gram_matrix(jnp.asarray(feat)))
    out = tgram.gram_matrix(_t(feat)).numpy()
    assert out.shape == ref.shape == (2, 16, 16)
    assert np.abs(out - ref).max() <= 1e-6 * np.abs(ref).max()
    for k, s in ((11, 1.5), (11, 0.3 * 4 + 0.8), (5, 1.1)):
        assert np.array_equal(tmetrics._gaussian_window(k, s), jmetrics._gaussian_window(k, s))


def test_nst_optimize_matches_jax(vgg19, rng):
    """3 Adam steps at 32^2 with two styles weighted 1:3."""
    params, tparams = vgg19
    c = rng.random((1, 32, 32, 3)).astype(np.float32)
    s = rng.random((2, 32, 32, 3)).astype(np.float32)
    w = np.array([1.0, 3.0], np.float32)
    ref = np.asarray(jnst.nst_optimize(params, jnp.asarray(c), jnp.asarray(s), jnp.asarray(w),
                                       num_steps=3))
    out = tnst.nst_optimize(tparams, _t(c), _t(s), _t(w), num_steps=3, device="cpu").numpy()
    assert out.shape == ref.shape == (1, 32, 32, 3)
    assert np.abs(out - ref).max() <= IMG_TOL
    assert np.abs(out - c).max() > 1e-3  # the steps moved the image


def test_nst_loss_and_grad_is_the_loss_the_steps_descend(vgg19, rng):
    """The port's step: the loss falls along -grad, and one Adam step from
    the targets equals nst_optimize's first."""
    _, tparams = vgg19
    c, s = _t(rng.random((1, 32, 32, 3)).astype(np.float32)), _t(
        rng.random((1, 32, 32, 3)).astype(np.float32))
    img, cf, grams, wts = tnst.nst_targets(tparams, c, s, torch.ones(1))
    loss, grad = tnst.nst_loss_and_grad(tparams, img, cf, grams, wts)
    step = img - 1e-3 * grad / grad.abs().max()
    assert tnst.nst_loss_and_grad(tparams, step, cf, grams, wts)[0] < loss
    assert grad.shape == img.shape and not grad.requires_grad


def test_run_style_transfer_and_mix_styles_match_jax(vgg19, tmp_path):
    """run_style_transfer caps a 40x36 content at max_dim 32 (bicubic);
    mix_styles squares three styles at size 32."""
    params, tparams = vgg19
    c, s1, s2, s3 = _images(tmp_path, 4)
    ref = np.asarray(jnst.run_style_transfer(c, s1, max_dim=32, num_steps=2, params=params))
    out = tnst.run_style_transfer(c, s1, max_dim=32, num_steps=2, params=tparams,
                                  device="cpu").numpy()
    assert out.shape == ref.shape == (32, 28, 3)
    assert np.abs(out - ref).max() <= IMG_TOL
    pairs = [(s1, 1.0), (s2, 2.0), (s3, 0.5)]
    ref = np.asarray(jnst.mix_styles(c, pairs, num_steps=2, size=32, params=params))
    out = tnst.mix_styles(c, pairs, num_steps=2, size=32, params=tparams, device="cpu").numpy()
    assert out.shape == ref.shape == (32, 32, 3)
    assert np.abs(out - ref).max() <= IMG_TOL


def _rgb_mask(h, w):
    m = np.zeros((h, w, 3), np.float32)
    m[:, : w // 3, 0] = 1
    m[:, w // 3: 2 * w // 3, 1] = 1
    m[: h // 2, 2 * w // 3:, 2] = 1
    return m


@pytest.mark.parametrize("feather", [0, 5, 2])
def test_color_mask_matches_jax(feather):
    mask = _rgb_mask(30, 33)
    for color in ((1.0, 0, 0), (0, 1.0, 0), (0, 0, 1.0)):
        ref = np.asarray(jnst.color_mask(jnp.asarray(mask), color, feather))
        out = tnst.color_mask(_t(mask), color, feather).numpy()
        assert out.shape == ref.shape == (30, 33)
        np.testing.assert_allclose(out, ref, atol=1e-6)


def test_spatially_varying_style_transfer_matches_jax(vgg19, tmp_path):
    """Three 2-step stylizations of a 40x36 content (capped at 32),
    composited by an R/G/B mask of another size (nearest resize)."""
    params, tparams = vgg19
    c, s1, s2, s3 = _images(tmp_path, 4, seed=1)
    mask = tmp_path / "mask.png"
    Image.fromarray((_rgb_mask(20, 18) * 255).astype(np.uint8)).save(mask)
    kw = dict(num_steps=2, max_dim=32)
    ref = np.asarray(jnst.spatially_varying_style_transfer(c, s1, s2, s3, str(mask),
                                                           params=params, **kw))
    out = tnst.spatially_varying_style_transfer(c, s1, s2, s3, str(mask), params=tparams,
                                                device="cpu", **kw).numpy()
    assert out.shape == ref.shape == (40, 36, 3)
    assert np.abs(out - ref).max() <= IMG_TOL


@pytest.mark.parametrize("mode", ["single", "mix", "mask"])
def test_run_nst_cli_matches_jax(shared_vgg19, tmp_path, mode):
    c, s1, s2, s3 = _images(tmp_path, 4, seed=2)
    argv = ["--content", c, "--steps", "2", "--max_dim", "32"]
    if mode == "single":
        argv += ["--style", s1]
    elif mode == "mix":
        argv += ["--style", s1, s2, "--weights", "1", "2"]
    else:
        mask = tmp_path / "mask.png"
        Image.fromarray((_rgb_mask(40, 36) * 255).astype(np.uint8)).save(mask)
        argv += ["--style", s1, s2, s3, "--mask", str(mask)]
    a = jcli.main(argv + ["--output", str(tmp_path / "j.png")])
    b = tcli.main(argv + ["--output", str(tmp_path / "t.png"), "--device", "cpu"])
    ja, tb = (np.asarray(Image.open(p), np.int32) for p in (a, b))
    assert ja.shape == tb.shape
    assert np.abs(ja - tb).max() <= 1


def test_nst_entry_points_without_cuda_raise(vgg19, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = np.zeros((8, 8, 3), np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tnst.run_style_transfer(img, img, num_steps=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tnst.nst_optimize(vgg19[1], _t(img)[None], _t(img)[None], torch.ones(1), num_steps=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tnst.mix_styles(img, [(img, 1.0)], num_steps=1, size=8)
