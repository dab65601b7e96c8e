"""The pixel-art page: aip_tpu_torch against aip_tpu on the CPU.

The palette ops, the depixelizer, ``pixelize`` with every method,
``depixelize_and_stylize`` on both branches, the two CLIs, and the depth
proxy's blur that the AdaIN branch runs. Inputs are drawn with numpy from a
seed and handed to both packages; the AdaIN weights go through one npz
cache both packages read, the magenta weights are the committed checkpoint.

Tolerances: ``recolor_rgb`` and ``floyd_steinberg`` equal (integer
distances; the wavefront adds in the scan's order); ``recolor_lab`` may pick
the other colour only at a near-tie, a distance gap of at most 1e-3 in the
8-bit LAB scale (the cube root and the product sum round differently), and
its LAB values within 1e-3; the brightness/contrast curve within 1e-6 and
at most 1 level after the uint8 truncation; the depixelizer byte for byte;
both stylize branches within 1e-3 mean abs (BASELINE.md's budget); the
depth proxy within 1e-5 (its card gate).
"""

import functools
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from aip_tpu.cli import run_pixelize as jcli_pix
from aip_tpu.cli import run_vectorize as jcli_vec
from aip_tpu.models import decoder as jdec
from aip_tpu.models import depthnet as jdepth
from aip_tpu.models import magenta as jmagenta
from aip_tpu.models import vgg as jvgg
from aip_tpu.models import weights as jweights
from aip_tpu.ops import palette as jpal
from aip_tpu.pipelines import adain_infer as jinfer
from aip_tpu.pipelines import pixel_art as jpix
from aip_tpu_torch.cli import run_pixelize as tcli_pix
from aip_tpu_torch.cli import run_vectorize as tcli_vec
from aip_tpu_torch.models import depthnet as tdepth
from aip_tpu_torch.models import magenta as tmagenta
from aip_tpu_torch.models import weights as tweights
from aip_tpu_torch.ops import palette as tpal
from aip_tpu_torch.pipelines import adain_infer as tinfer
from aip_tpu_torch.pipelines import pixel_art as tpix

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
LAB_GAP = 1e-3
STYLIZE_TOL = 1e-3
CKPT = ROOT / "docs" / "examples" / "magenta" / "magenta_distilled.npz"


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _image(seed, h, w):
    """A photograph-like uint8 image: smooth gradients, blobs and noise."""
    g = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    img = np.stack([0.5 + 0.4 * np.sin(6 * xx + g.random() * 6),
                    0.5 + 0.4 * np.cos(5 * yy + g.random() * 6),
                    0.5 + 0.4 * np.sin(4 * (xx + yy))], -1)
    img += g.normal(0, 0.08, img.shape)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def _sprite(seed, h, w):
    """A pixel-art sprite: flat colours, rectangles, diagonal lines, a 2x2
    block whose two diagonals cross, and a one-pixel island."""
    g = np.random.default_rng(seed)
    pal = g.integers(0, 256, (6, 3)).astype(np.uint8)
    img = np.empty((h, w, 3), np.uint8)
    img[:] = pal[0]
    for _ in range(3):
        y0, x0 = g.integers(0, h - 3), g.integers(0, w - 3)
        img[y0:y0 + g.integers(2, h // 2), x0:x0 + g.integers(2, w // 2)] = pal[g.integers(1, 6)]
    for _ in range(2):
        c, d, s = pal[g.integers(1, 6)], g.integers(0, w), (1, -1)[g.integers(0, 2)]
        for y in range(h):
            if 0 <= d + s * y < w:
                img[y, d + s * y] = c
    y, x = g.integers(1, h - 3), g.integers(1, w - 3)
    img[y, x] = img[y + 1, x + 1] = pal[1]
    img[y, x + 1] = img[y + 1, x] = pal[2]
    img[g.integers(0, h), g.integers(0, w)] = 255 - pal[0]
    return img


def _palette(seed, n=16):
    return np.random.default_rng(seed).integers(0, 256, (n, 3)).astype(np.uint8)


# ---------------------------------------------------------------------------
# ops/palette.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("brightness,contrast", [(0.1, 0.2), (-0.07, 0.3), (0.0, -0.25),
                                                 (0.2, 0.0)])
def test_adjust_brightness_contrast_matches_jax(brightness, contrast):
    """As ``pixelize`` calls it: within 1e-6, at most 1 level after the
    truncation to uint8 (the pixels at 1 level are counted)."""
    arr = _image(0, 48, 64)
    ref = np.asarray(jpal.adjust_brightness_contrast(jnp.asarray(arr, jnp.float32) / 255.0,
                                                     brightness, contrast))
    out = tpal.adjust_brightness_contrast(_t(arr).to(torch.float32) / 255.0, brightness,
                                          contrast).numpy()
    assert np.abs(out - ref).max() <= 1e-6
    levels = np.abs((out * 255).astype(np.uint8).astype(int) - (ref * 255).astype(np.uint8))
    assert levels.max() <= 1, int((levels > 0).sum())


@pytest.mark.parametrize("seed,n", [(0, 16), (1, 4), (2, 1)])
def test_recolor_rgb_equals_jax(seed, n):
    img, pal = _image(seed, 37, 53), _palette(seed, n)
    pal[-1] = pal[0]  # a repeated colour: the first index wins on the tie
    ref = np.asarray(jpal.recolor_rgb(jnp.asarray(img), jnp.asarray(pal)))
    out = tpal.recolor_rgb(_t(img), _t(pal)).numpy()
    assert np.array_equal(out, ref)
    idx = tpal._nearest_indices(_t(img.reshape(-1, 3)).float(), _t(pal).float()).numpy()
    np.testing.assert_array_equal(
        idx, np.asarray(jpal._nearest_indices(jnp.asarray(img.reshape(-1, 3), jnp.float32),
                                              jnp.asarray(pal, jnp.float32))))


def test_cielab_u8_matches_jax():
    rgb = np.concatenate([_image(3, 40, 40).reshape(-1, 3),
                          np.array([[0, 0, 0], [255, 255, 255], [1, 2, 3]], np.uint8)])
    ref = np.asarray(jpal.rgb_to_cielab_u8(jnp.asarray(rgb)))
    out = tpal.rgb_to_cielab_u8(_t(rgb)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-3)
    xyz = np.asarray(jpal._srgb_to_xyz(jnp.asarray(rgb, jnp.float32) / 255.0))
    np.testing.assert_allclose(tpal._srgb_to_xyz(_t(rgb).float() / 255.0).numpy(), xyz,
                               atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_recolor_lab_differs_from_jax_only_at_near_ties(seed):
    img, pal = _image(seed, 64, 80), _palette(seed + 10)
    ref = np.asarray(jpal.recolor_lab(jnp.asarray(img), jnp.asarray(pal)))
    out = tpal.recolor_lab(_t(img), _t(pal)).numpy()
    differ = (out != ref).any(-1)
    lab = np.asarray(jpal.rgb_to_cielab_u8(jnp.asarray(img)), np.float64)[differ]
    pal_lab = np.asarray(jpal.rgb_to_cielab_u8(jnp.asarray(pal)), np.float64)

    def dist(chosen):
        i = [np.flatnonzero((pal == c).all(-1))[0] for c in chosen]
        return ((lab - pal_lab[i]) ** 2).sum(-1)

    gaps = np.abs(dist(out[differ]) - dist(ref[differ]))
    assert differ.sum() <= 0.001 * differ.size
    assert (gaps <= LAB_GAP).all(), gaps.max()


@pytest.mark.parametrize("seed,h,w,n", [(0, 17, 23, 16), (1, 40, 31, 16), (2, 1, 9, 4),
                                        (3, 11, 1, 5), (4, 33, 47, 16), (5, 24, 64, 8)])
def test_floyd_steinberg_equals_jax(seed, h, w, n):
    img, pal = _image(seed, h, w), _palette(seed + 20, n)
    ref = np.asarray(jpal.floyd_steinberg(jnp.asarray(img), jnp.asarray(pal)))
    out = tpal.floyd_steinberg(_t(img), _t(pal)).numpy()
    assert np.array_equal(out, ref)
    assert tpal.wavefront_steps(h, w) == 2 * (h - 1) + w


def _serial_scan(img, pal):
    """The JAX package's row-by-row scan in numpy float32, each product and
    sum rounded on its own (no fused multiply-add)."""
    h, w, _ = img.shape
    pal = pal.astype(np.float32)
    c1, c3, c5, c7 = (np.float32(k / 16) for k in (1, 3, 5, 7))
    above = np.zeros((w, 3), np.float32)
    out = np.zeros((h, w, 3), np.uint8)
    for y in range(h):
        row, nxt = img[y].astype(np.float32) + above, np.zeros((w, 3), np.float32)
        for x in range(w):
            d = pal - row[x]
            d = d * d
            new = pal[np.argmin((d[:, 0] + d[:, 1]) + d[:, 2])]
            e = row[x] - new
            out[y, x] = new
            if x + 1 < w:
                row[x + 1] = row[x + 1] + e * c7
                nxt[x + 1] = nxt[x + 1] + e * c1
            if x > 0:
                nxt[x - 1] = nxt[x - 1] + e * c3
            nxt[x] = nxt[x] + e * c5
        above = nxt
    return out


def test_floyd_steinberg_equals_the_scan_without_fused_multiply_adds():
    """A 192x256 image on which the JAX package's compiled scan differs: XLA's
    CPU backend fuses some of the scan's multiply-adds (the distance sum, the
    error terms), which flips one near-tie at pixel (30, 58) and the
    dithering after it. The wavefront rounds each operation on its own, as
    the scan is written, on the CPU and on the card alike."""
    g = np.random.default_rng(5)
    img = (g.random((192, 256, 3)) * 255).astype(np.uint8)
    pal = (g.random((16, 3)) * 255).astype(np.uint8)
    assert np.array_equal(tpal.floyd_steinberg(_t(img), _t(pal)).numpy(), _serial_scan(img, pal))


def test_wavefront_visits_every_pixel_once_after_its_neighbours():
    h, w = 7, 10
    ys, xs, counts = tpal._wavefront(h, w)
    assert sum(counts) == h * w and len(set(zip(ys, xs))) == h * w
    step = np.repeat(np.arange(len(counts)), counts)
    order = {(y, x): s for y, x, s in zip(ys, xs, step)}
    for (y, x), s in order.items():
        for dy, dx in ((0, -1), (-1, -1), (-1, 0), (-1, 1)):
            if (y + dy, x + dx) in order:
                assert order[(y + dy, x + dx)] < s


# ---------------------------------------------------------------------------
# pipelines/pixel_art.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,h,w", [(0, 16, 16), (1, 20, 26), (2, 9, 13)])
def test_depixelize_equals_jax_byte_for_byte(seed, h, w):
    sprite = _sprite(seed, h, w)
    ref = jpix.depixelize(sprite, scale=6)
    out = tpix.depixelize(sprite, scale=6)
    assert out.shape == ref.shape == (h * 6, w * 6, 3)
    assert out.tobytes() == ref.tobytes()


@pytest.mark.parametrize("method", ["RGB", "kd-tree", "LAB", "Floyd-Steinberg"])
def test_pixelize_matches_jax(method, tmp_path):
    """A PNG path in, downsampled, brightness and contrast, a Lospec palette:
    equal, except LAB's near-ties (counted, as in its op test)."""
    path = tmp_path / "img.png"
    Image.fromarray(_image(7, 70, 90)).save(path)
    pal = tpix.hex_palette_to_rgb(tpix.load_lospec_palettes()["pico-8"])
    kw = dict(downsampling_factor=3, brightness=0.05, contrast=0.2, palette=pal, method=method)
    ref = jpix.pixelize(str(path), **kw)
    out = tpix.pixelize(str(path), device="cpu", **kw)
    assert out.shape == ref.shape == (23, 30, 3) and out.dtype == np.uint8
    differ = (out != ref).any(-1)
    if method == "LAB":
        assert differ.sum() <= 2
    else:
        assert not differ.any()
    gray = tpix.pixelize(Image.open(path), grayscale=True, device="cpu")
    assert np.array_equal(gray, jpix.pixelize(Image.open(path), grayscale=True))


def test_palettes_load_from_the_repository_anywhere(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    pals = tpix.load_lospec_palettes()
    assert pals == jpix.load_lospec_palettes()
    assert len(pals) == 1029 and max(len(v) for v in pals.values()) <= 16
    assert np.array_equal(tpix.hex_palette_to_rgb(pals["pico-8"]),
                          jpix.hex_palette_to_rgb(pals["pico-8"]))


@pytest.fixture
def shared_adain(tmp_path_factory, monkeypatch):
    """One AdaIN weight cache for both packages, both stylizing at 32 px."""
    rng = np.random.default_rng(14)
    d = tmp_path_factory.mktemp("weights")

    def hwio(specs):
        return [{"w": (rng.standard_normal((k, k, cin, cout)) * (2.0 / (k * k * cin)) ** 0.5)
                 .astype(np.float32), "b": (rng.standard_normal(cout) * 0.05).astype(np.float32)}
                for k, cin, cout in specs]

    jweights.save_params_npz(hwio([(k, cin, cout) for _, cin, cout, k, _ in jvgg.conv_specs()]),
                             d / "vgg_normalised.npz")
    jweights.save_params_npz(hwio([(3, cin, cout) for _, cin, cout, _ in jdec.conv_specs()]),
                             d / "adain_decoder.npz")
    monkeypatch.setattr(jweights, "DEFAULT_WEIGHTS_DIR", d)
    monkeypatch.setattr(tweights, "DEFAULT_WEIGHTS_DIR", d)
    for infer in (jinfer, tinfer):
        monkeypatch.setattr(infer, "adain_inference", functools.partial(
            infer.adain_inference, content_size=32, style_size=32))


@pytest.fixture
def captured(monkeypatch):
    """The array each package's adain_inference hands to save_image."""
    out = {}
    for name, infer in (("jax", jinfer), ("port", tinfer)):
        orig = infer.save_image

        def spy(arr, path, _name=name, _orig=orig):
            out[_name] = np.asarray(arr.detach().numpy() if isinstance(arr, torch.Tensor)
                                    else arr, np.float32)
            return _orig(arr, path)

        monkeypatch.setattr(infer, "save_image", spy)
    return out


def test_depixelize_and_stylize_adain_matches_jax(shared_adain, captured, tmp_path):
    """The default branch: fp32 AdaIN with the depth proxy on the raster."""
    style = tmp_path / "style.png"
    Image.fromarray(_image(9, 40, 40)).save(style)
    sprite = _sprite(3, 10, 12)
    ref = jpix.depixelize_and_stylize(sprite, str(style), scale=4, output=str(tmp_path / "j"))
    out = tpix.depixelize_and_stylize(sprite, str(style), scale=4, output=str(tmp_path / "t"),
                                      device="cpu")
    assert Path(out).name == Path(ref).name == "depixelized_stylized.jpg"
    a, b = captured["port"], captured["jax"]
    assert a.shape == b.shape
    assert np.abs(a - b).mean() <= STYLIZE_TOL


def test_depixelize_and_stylize_fast_matches_jax(tmp_path, monkeypatch):
    """The magenta branch on the committed checkpoint (the JAX package's
    default is its seed-0 init; both take the checkpoint here)."""
    outs = {}
    j_make, t_make = jmagenta.make_fast_stylizer, tmagenta.make_fast_stylizer

    def spy(name, fn):
        def stylizer(frames, style):
            res = fn(frames, style)
            outs[name] = np.asarray(res.numpy() if isinstance(res, torch.Tensor) else res)
            return res
        return stylizer

    jparams = jmagenta.load_magenta_npz(CKPT)
    monkeypatch.setattr(jmagenta, "make_fast_stylizer",
                        lambda params=None: spy("jax", j_make(jparams)))
    monkeypatch.setattr(tmagenta, "make_fast_stylizer",
                        lambda params=None, device=None: spy("port", t_make(params, device)))
    style = tmp_path / "style.png"
    Image.fromarray(_image(11, 50, 70)).save(style)
    sprite = _sprite(4, 9, 11)
    jpix.depixelize_and_stylize(sprite, str(style), scale=4, output=str(tmp_path / "j"),
                                method="fast")
    p = tpix.depixelize_and_stylize(sprite, str(style), scale=4, output=str(tmp_path / "t"),
                                    method="fast",
                                    magenta_params=tmagenta.load_magenta_npz(CKPT, "cpu"),
                                    device="cpu")
    assert Image.open(p).size == (44, 36)
    assert outs["port"].shape == outs["jax"].shape == (1, 36, 44, 3)
    assert np.abs(outs["port"] - outs["jax"]).mean() <= STYLIZE_TOL


def test_the_cli_s_match_jax(tmp_path):
    img, sprite = tmp_path / "img.png", tmp_path / "sprite.png"
    Image.fromarray(_image(12, 40, 56)).save(img)
    Image.fromarray(_sprite(5, 12, 12)).save(sprite)
    argv = ["--input", str(img), "--palette", "pico-8", "--method", "Floyd-Steinberg",
            "--downsample", "2"]
    a = jcli_pix.main(argv + ["--output", str(tmp_path / "j.png")])
    b = tcli_pix.main(argv + ["--output", str(tmp_path / "t.png"), "--device", "cpu"])
    assert np.array_equal(np.asarray(Image.open(a)), np.asarray(Image.open(b)))
    argv = ["--input", str(sprite), "--scale", "5"]
    a = jcli_vec.main(argv + ["--output", str(tmp_path / "jv")])
    b = tcli_vec.main(argv + ["--output", str(tmp_path / "tv"), "--device", "cpu"])
    assert np.asarray(Image.open(a)).tobytes() == np.asarray(Image.open(b)).tobytes()


def test_pixel_art_entry_points_without_cuda_raise(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sprite = _sprite(6, 8, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpix.pixelize(sprite, palette=_palette(0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpix.depixelize_and_stylize(sprite, sprite, output=str(tmp_path))
    path = tmp_path / "s.png"
    Image.fromarray(sprite).save(path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli_vec.main(["--input", str(path), "--output", str(tmp_path / "v")])


# ---------------------------------------------------------------------------
# The depth proxy's blur (the AdaIN branch's default depth)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h,w", [(64, 64), (45, 61), (33, 200), (130, 97)])
def test_depth_proxy_matches_jax_without_a_conv(h, w):
    """A fixed-order sum of shifted slices (3 to 17 taps here) in place of
    cuDNN's conv: within 1e-5 of the JAX package's ``jnp.convolve``."""
    g = np.random.default_rng(h * w)
    img = g.random((h, w, 3)).astype(np.float32)
    ref = np.asarray(jdepth.estimate_proximity(img))
    out = tdepth.estimate_proximity(img, device="cpu").numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)


@pytest.mark.parametrize("k", [1, 2, 3, 8, 9, 33, 65])
def test_window_sum_adds_k_neighbours(k):
    x = torch.from_numpy(np.random.default_rng(k).random((5, 70)))
    out = tdepth._window_sum(x, k, 1)
    ref = torch.stack([x[:, j:j + k].sum(1) for j in range(70 - k + 1)], 1)
    assert out.shape == ref.shape
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-12)
