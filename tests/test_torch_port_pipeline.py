"""aip_tpu_torch.pipelines / cli vs aip_tpu's on the CPU, fp32.

Both packages run the same parameters: HWIO arrays drawn with numpy from a
seed, handed to aip_tpu as they are and to the port through
``from_jax_params``, or written once to an npz cache that both packages'
``DEFAULT_WEIGHTS_DIR`` point at.

Tolerances (BASELINE.md's budget for the reference): float outputs mean
abs <= 1e-3 and max abs <= 1e-2; relu4_1 embeddings max abs <= 1e-4 of
the largest value, as the model tests hold them; saved images at most one
8-bit step apart anywhere and <= 1e-3 apart on average.
"""

import functools

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from aip_tpu.cli import run_depth as jcli
from aip_tpu.models import decoder as jdec
from aip_tpu.models import depthnet as jdepthnet
from aip_tpu.models import vgg as jvgg
from aip_tpu.models import weights as jweights
from aip_tpu.pipelines import adain_infer as jinfer
from aip_tpu_torch.cli import run_depth as tcli
from aip_tpu_torch.kernels import adain_head as K
from aip_tpu_torch.models import decoder as tdec
from aip_tpu_torch.models import depthnet as tdepthnet
from aip_tpu_torch.models import vgg as tvgg
from aip_tpu_torch.models import weights as tweights
from aip_tpu_torch.pipelines import adain_infer as tinfer

torch.set_num_threads(2)

F32 = dict(compute_dtype=jnp.float32)
T32 = dict(compute_dtype=torch.float32, device="cpu")


def _hwio_params(rng, specs):
    """He-normal HWIO params for (k, cin, cout) specs, zero-free biases."""
    return [{"w": (rng.standard_normal((k, k, cin, cout)) * (2.0 / (k * k * cin)) ** 0.5)
                  .astype(np.float32),
             "b": (rng.standard_normal(cout) * 0.05).astype(np.float32)}
            for k, cin, cout in specs]


@pytest.fixture(scope="module")
def nets():
    """(jax vgg, jax decoder, port vgg, port decoder) on the same weights."""
    rng = np.random.default_rng(7)
    vgg = _hwio_params(rng, [(k, cin, cout) for _, cin, cout, k, _ in jvgg.conv_specs()])
    dec = _hwio_params(rng, [(3, cin, cout) for _, cin, cout, _ in jdec.conv_specs()])
    return vgg, dec, tweights.from_jax_params(vgg, "cpu"), tweights.from_jax_params(dec, "cpu")


@pytest.fixture(scope="module")
def weight_cache(nets, tmp_path_factory):
    d = tmp_path_factory.mktemp("weights")
    jweights.save_params_npz(nets[0], d / "vgg_normalised.npz")
    jweights.save_params_npz(nets[1], d / "adain_decoder.npz")
    return d


@pytest.fixture
def shared_cache(weight_cache, monkeypatch):
    monkeypatch.setattr(jweights, "DEFAULT_WEIGHTS_DIR", weight_cache)
    monkeypatch.setattr(tweights, "DEFAULT_WEIGHTS_DIR", weight_cache)


def _img(rng, *shape):
    return rng.random(shape).astype(np.float32)


def _close(out, ref, mean_tol=1e-3, max_tol=1e-2):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape
    assert np.isfinite(out).all()
    err = np.abs(out - ref)
    assert err.mean() <= mean_tol and err.max() <= max_tol, (err.mean(), err.max())


def test_stylize_simple_matches_jax(rng, nets):
    jv, jd, tv, td = nets
    c, s = _img(rng, 1, 40, 48, 3), _img(rng, 1, 36, 44, 3)
    ref = jinfer.stylize_simple(jv, jd, jnp.asarray(c), jnp.asarray(s), alpha=0.6, **F32)
    out = tinfer.stylize_simple(tv, td, c, s, alpha=0.6, **T32)
    _close(out, ref)


def test_stylize_depth_matches_jax(rng, nets):
    jv, jd, tv, td = nets
    c, s, d = _img(rng, 1, 40, 48, 3), _img(rng, 1, 32, 32, 3), _img(rng, 40, 48)
    ref = jinfer.stylize_depth(jv, jd, jnp.asarray(c), jnp.asarray(s), jnp.asarray(d),
                               offset=0.2, prominence=15.0, **F32)
    out = tinfer.stylize_depth(tv, td, c, s, d, offset=0.2, prominence=15.0, **T32)
    _close(out, ref)


def test_style_stats_and_serving_path_match_jax(rng, nets):
    jv, jd, tv, td = nets
    s, c = _img(rng, 1, 40, 40, 3), _img(rng, 2, 32, 40, 3)
    jm, js = jinfer.precompute_style_stats(jv, jnp.asarray(s), **F32)
    tm, ts = tinfer.precompute_style_stats(tv, s, **T32)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-4, atol=1e-5)
    ref = jinfer.stylize_with_stats(jv, jd, jnp.asarray(c), jm, js, alpha=0.5, **F32)
    out = tinfer.stylize_with_stats(tv, td, c, tm, ts, alpha=0.5, **T32)
    _close(out, ref)
    emb = tinfer.style_embedding(tv, s, **T32)
    ref = jinfer.style_embedding(jv, jnp.asarray(s), **F32)
    assert np.abs(emb.numpy() - np.asarray(ref)).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("with_masks", [False, True])
def test_stylize_batch_with_stats_matches_jax(rng, nets, monkeypatch, with_masks):
    """H % 8 != 0, so the output is resized back before the composite.
    aip_tpu's batch path has no dtype argument (it serves in bf16): its
    ``stylize_with_stats`` is pinned to fp32 here, the rest of its code runs
    as it is."""
    jv, jd, tv, td = nets
    monkeypatch.setattr(jinfer, "stylize_with_stats",
                        functools.partial(jinfer.stylize_with_stats, **F32))
    c, s = _img(rng, 2, 36, 44, 3), _img(rng, 1, 32, 32, 3)
    masks = (rng.random((2, 36, 44, 1)) > 0.5).astype(np.float32) if with_masks else None
    jm, js = jinfer.precompute_style_stats(jv, jnp.asarray(s), **F32)
    ref = jinfer.stylize_batch_with_stats(
        jv, jd, jnp.asarray(c), jm, js,
        masks=None if masks is None else jnp.asarray(masks), alpha=0.7)
    tm, ts = tinfer.precompute_style_stats(tv, s, **T32)
    out = tinfer.stylize_batch_with_stats(tv, td, c, tm, ts, masks=masks, alpha=0.7, **T32)
    assert out.shape == (2, 36, 44, 3)
    _close(out, ref)


def test_stylize_interpolated_matches_jax(rng, nets):
    jv, jd, tv, td = nets
    c, styles = _img(rng, 1, 32, 40, 3), _img(rng, 3, 32, 32, 3)
    w = np.array([0.5, 0.3, 0.2], np.float32)
    ref = jinfer.stylize_interpolated(jv, jd, jnp.asarray(c), jnp.asarray(styles),
                                      jnp.asarray(w), alpha=0.8, **F32)
    out = tinfer.stylize_interpolated(tv, td, c, styles, w, alpha=0.8, **T32)
    _close(out, ref)


def test_get_style_embeddings_matches_jax(rng, nets, tmp_path):
    """From a PNG file: PIL's resize on both sides, then relu4_1."""
    path = tmp_path / "style.png"
    Image.fromarray((_img(rng, 30, 50, 3) * 255).astype(np.uint8)).save(path)
    ref = np.asarray(jinfer.get_style_embeddings(path, style_size=40, vgg_params=nets[0]))
    out = tinfer.get_style_embeddings(path, style_size=40, vgg_params=nets[2],
                                      device="cpu").numpy()
    assert out.shape == ref.shape == (1, 5, 9, 512)
    assert np.abs(out - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("kind", ["float", "uint8"])
def test_estimate_proximity_matches_jax(rng, kind):
    img = _img(rng, 45, 61, 3)
    if kind == "uint8":
        img = (img * 255).astype(np.uint8)
    ref = np.asarray(jdepthnet.estimate_proximity(img))
    out = tdepthnet.estimate_proximity(img, device="cpu").numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)


def _pixels(path):
    return np.asarray(Image.open(path)).astype(np.int32)


def _same_image(a, b):
    pa, pb = _pixels(a), _pixels(b)
    assert pa.shape == pb.shape
    diff = np.abs(pa - pb)
    assert diff.max() <= 1 and diff.mean() / 255.0 <= 1e-3, (diff.max(), diff.mean())


@pytest.fixture
def images(tmp_path, rng):
    c, s = tmp_path / "content.png", tmp_path / "style.png"
    Image.fromarray((_img(rng, 44, 54, 3) * 255).astype(np.uint8)).save(c)
    Image.fromarray((_img(rng, 40, 40, 3) * 255).astype(np.uint8)).save(s)
    return c, s


@pytest.mark.parametrize("variant", ["plain", "use_depth", "preserve_color", "mask"])
def test_adain_inference_matches_jax(shared_cache, images, tmp_path, rng, variant):
    """content_size 36 gives a 36x44 working size (H % 8 != 0): the
    decoder returns 40x48, which the mask composite resizes back."""
    kw = dict(content_size=36, style_size=32, alpha=0.6, save_ext=".png",
              file_name=variant)
    if variant == "use_depth":
        kw["use_depth"] = True
    elif variant == "preserve_color":
        kw["preserve_color"] = True
    elif variant == "mask":
        kw["content_mask"] = (rng.random((44, 54)) > 0.5).astype(np.float32)
    ref = jinfer.adain_inference(*images, output=str(tmp_path / "jax"), **kw)
    out = tinfer.adain_inference(*images, output=str(tmp_path / "port"), device="cpu", **kw)
    assert out.name == ref.name == f"{variant}.png"
    assert _pixels(out).shape == ((36, 44, 3) if variant == "mask" else (40, 48, 3))
    _same_image(out, ref)


@pytest.mark.parametrize("flags", [[], ["--use_depth"]])
def test_run_depth_cli_matches_jax(shared_cache, images, tmp_path, monkeypatch, flags):
    """Both CLIs at their own 512-px working size. The CLI saves JPEG; both
    packages' ``adain_inference`` are pinned to PNG here so that the pixels
    compare without the codec."""
    for mod in (jinfer, tinfer):
        monkeypatch.setattr(mod, "adain_inference",
                            functools.partial(mod.adain_inference, save_ext=".png"))
    argv = ["--content", str(images[0]), "--style", str(images[1]), "--file_name", "x",
            *flags]
    ref = jcli.main(argv + ["--output", str(tmp_path / "jax")])
    out = tcli.main(argv + ["--output", str(tmp_path / "port"), "--device", "cpu"])
    assert _pixels(out).shape[0] == 512
    _same_image(out, ref)


def test_entry_points_without_cuda_raise(nets, images, monkeypatch):
    """device=None means CUDA; with no CUDA every entry point refuses to
    carry on on the CPU (the card's availability is patched away so that
    this holds on any machine)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, tv, td = nets
    x = np.zeros((1, 16, 16, 3), np.float32)
    calls = [
        lambda: tinfer.stylize_simple(tv, td, x, x),
        lambda: tinfer.stylize_depth(tv, td, x, x, np.zeros((16, 16), np.float32)),
        lambda: tinfer.precompute_style_stats(tv, x),
        lambda: tinfer.stylize_with_stats(tv, td, x, np.zeros((1, 1, 1, 512), np.float32),
                                          np.ones((1, 1, 1, 512), np.float32)),
        lambda: tinfer.get_style_embeddings(images[1], vgg_params=tv),
        lambda: tinfer.adain_inference(*images),
        lambda: tcli.main(["--content", str(images[0]), "--style", str(images[1])]),
        lambda: tdepthnet.estimate_proximity(x[0]),
        lambda: tvgg.init_vgg_params(),
        lambda: tdec.init_decoder_params(),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_cpu_modules_with_cuda_device_are_refused(nets):
    """A module on one device and a call on another is an error, not a copy."""
    _, _, tv, td = nets
    x = np.zeros((1, 16, 16, 3), np.float32)
    with pytest.raises(ValueError, match="parameters are on cpu"):
        tinfer.stylize_simple(tv, td, x, x, device="meta")


def test_cpu_pipeline_launches_no_kernel(rng, nets):
    K.reset_launch_counts()
    _, _, tv, td = nets
    tinfer.stylize_simple(tv, td, _img(rng, 1, 16, 16, 3), _img(rng, 1, 16, 16, 3), **T32)
    assert K.launch_counts() == {"encode_head": 0, "decode_tail": 0}
