"""aip_tpu_torch.pipelines.video, models.magenta / mobilenet and the video
CLIs against aip_tpu's on the CPU, fp32.

Both packages run the same weights: AdaIN's as HWIO arrays drawn with numpy
from a seed (handed to aip_tpu as they are and to the port through
``from_jax_params``), magenta's through the npz bridge (the committed
``docs/examples/magenta/magenta_distilled.npz``, or a checkpoint the JAX
package's ``save_magenta_npz`` wrote).

Tolerances: the recurrence 1e-5 absolute (the same float32 warps and
blends); magenta 1e-4 of the largest value (oneDNN and XLA add convolution
sums in other orders); written frames compared as 8-bit images scaled to
[0, 1], mean abs <= 1e-3 (BASELINE.md's target) and at most one 8-bit step
anywhere: both packages truncate ``clip(x) * 255`` to uint8, so a value
that lies within float error of a step boundary lands one step apart.
"""

import os
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image
from scipy.ndimage import gaussian_filter

import jax
import jax.numpy as jnp

from aip_tpu.cli import run_video as jrun_video
from aip_tpu.models import decoder as jdec
from aip_tpu.models import magenta as jmag
from aip_tpu.models import mobilenet as jmb
from aip_tpu.models import vgg as jvgg
from aip_tpu.pipelines import video as jvideo
from aip_tpu_torch.cli import adain_video as tadain_video
from aip_tpu_torch.cli import run_video as trun_video
from aip_tpu_torch.kernels import tvl1 as ktvl1
from aip_tpu_torch.models import magenta as tmag
from aip_tpu_torch.models import mobilenet as tmb
from aip_tpu_torch.models import weights as tweights
from aip_tpu_torch.pipelines import video as tvideo

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
DISTILLED = ROOT / "docs" / "examples" / "magenta" / "magenta_distilled.npz"


def _hwio_params(rng, specs):
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


def _texture(seed, n, size, step=(1, 0)):
    """n frames of a smooth texture moving by ``step`` px a frame."""
    g = np.random.default_rng(seed)
    pad = 8 + n * max(abs(s) for s in step)
    base = gaussian_filter(g.random((size + 2 * pad, size + 2 * pad, 3)), (2, 2, 0))
    base = (base - base.min()) / (base.max() - base.min())
    return [base[pad - i * step[1]:pad - i * step[1] + size,
                 pad - i * step[0]:pad - i * step[0] + size] for i in range(n)]


def _write(images, directory, prefix="f", ext=".png"):
    directory.mkdir(parents=True, exist_ok=True)
    for i, img in enumerate(images):
        Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(
            directory / f"{prefix}_{i:03d}{ext}")
    return directory


@pytest.fixture
def video_dirs(tmp_path):
    """6 frames of 32^2 moving one pixel a frame, and 2 style images."""
    frames = _write(_texture(1, 6, 32), tmp_path / "frames")
    g = np.random.default_rng(2)
    styles = _write([g.random((40, 36, 3)), g.random((32, 32, 3))], tmp_path / "styles", "s")
    return frames, styles


def _same_frames(paths_a, paths_b):
    assert [p.name for p in paths_a] == [p.name for p in paths_b]
    a = np.stack([np.asarray(Image.open(p), np.float64) for p in paths_a]) / 255.0
    b = np.stack([np.asarray(Image.open(p), np.float64) for p in paths_b]) / 255.0
    err = np.abs(a - b)
    assert err.mean() <= 1e-3 and err.max() <= 1.0 / 255 + 1e-9, (err.mean(), err.max())


def test_temporal_blend_matches_jax(rng):
    stylized = rng.random((5, 16, 20, 3)).astype(np.float32)
    flows = (rng.standard_normal((4, 16, 20, 2)) * 2).astype(np.float32)
    ref = np.asarray(jvideo._temporal_blend(jnp.asarray(stylized), jnp.asarray(flows), 0.7))
    out = tvideo._temporal_blend(torch.from_numpy(stylized), torch.from_numpy(flows), 0.7)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


def test_stylize_frames_matches_jax(rng, nets):
    """The batched depth-aware stylization with per-frame style statistics,
    before 8-bit rounding: mean abs <= 1e-3, max <= 1e-2."""
    jv, jd, tv, td = nets
    frames = rng.random((3, 32, 32, 3)).astype(np.float32)
    mean = (rng.random((3, 1, 1, 512)) * 0.5).astype(np.float32)
    std = (rng.random((3, 1, 1, 512)) + 0.5).astype(np.float32)
    depth = np.array(jvideo._batch_proximity(jnp.asarray(frames)))
    np.testing.assert_allclose(tvideo._batch_proximity(torch.from_numpy(frames)).numpy(), depth,
                               atol=1e-5)
    ref = np.asarray(jvideo._stylize_frames(jv, jd, jnp.asarray(frames), jnp.asarray(mean),
                                            jnp.asarray(std), jnp.asarray(depth), 0.3, 20.0,
                                            jnp.float32))
    out = tvideo._stylize_frames(tv, td, torch.from_numpy(frames), torch.from_numpy(mean),
                                 torch.from_numpy(std), torch.from_numpy(depth), 0.3, 20.0,
                                 torch.float32).numpy()
    err = np.abs(out - ref)
    assert err.mean() <= 1e-3 and err.max() <= 1e-2, (err.mean(), err.max())


def test_multi_ada_video_matches_jax(nets, video_dirs, tmp_path):
    """6 frames at 32^2, 2 styles (switched after frame 3), depth on, TV-L1
    at its defaults, fp32: the written PNGs of both packages. aip_tpu's mesh
    branch stays off (6 frames on its 8 CPU devices)."""
    jv, jd, tv, td = nets
    frames, styles = video_dirs
    kw = dict(target_resolution=(32, 32), use_depth=True)
    ref = jvideo.apply_style_transfer_multi_ada(frames, styles, tmp_path / "jax", vgg_params=jv,
                                                dec_params=jd, compute_dtype=jnp.float32, **kw)
    trace = {}
    ktvl1.reset_launch_counts()
    out = tvideo.apply_style_transfer_multi_ada(frames, styles, tmp_path / "port", vgg_params=tv,
                                                dec_params=td, compute_dtype=torch.float32,
                                                device="cpu", trace=trace, **kw)
    assert len(out) == 6 and ktvl1.launch_counts() == {"tvl1": 0}
    _same_frames(out, ref)
    assert trace["flows"].shape == (5, 32, 32, 2) and trace["frames"] == 6
    assert set(trace["stage_ms"]) == {"load", "depth", "stylize", "flows", "blend", "save"}


# ---------------------------------------------------------------------------
# Magenta and MobileNetV2
# ---------------------------------------------------------------------------

def _rel_close(out, ref, tol=1e-4):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= tol * np.abs(ref).max(), np.abs(out - ref).max()


def _compare_magenta(jparams, tparams, style, content):
    jcin = jax.jit(jmag.predict_style)(jparams, jnp.asarray(style))
    tcin = tmag.predict_style(tparams, torch.from_numpy(style))
    assert list(tcin) == list(jcin)
    for name in jcin:
        for got, want in zip(tcin[name], jcin[name]):
            _rel_close(got.detach().numpy(), want)
    n = content.shape[0]
    jb = {k: (jnp.broadcast_to(g, (n, g.shape[-1])), jnp.broadcast_to(b, (n, b.shape[-1])))
          for k, (g, b) in jcin.items()}
    ref = jax.jit(jmag.transform)(jparams, jnp.asarray(content), jb)
    with torch.no_grad():
        out = tmag.stylize(tparams, torch.from_numpy(content), torch.from_numpy(style[0]))
    _rel_close(out.numpy(), ref)


def test_magenta_matches_jax_on_the_committed_checkpoint(rng):
    """The compact-trunk distilled checkpoint (83 arrays) through both."""
    style = rng.random((1, 48, 40, 3)).astype(np.float32)
    content = rng.random((2, 32, 36, 3)).astype(np.float32)
    tparams = tmag.load_magenta_npz(DISTILLED, device="cpu")
    assert len(np.load(DISTILLED).files) == 83 and tparams.predictor.mbv2 is None
    _compare_magenta(jmag.load_magenta_npz(DISTILLED), tparams, style, content)


def test_magenta_mobilenet_checkpoint_crosses_both_ways(rng, tmp_path):
    """A mobilenet_v2-trunk checkpoint written by the JAX package's
    save_magenta_npz loads in the port and agrees with JAX; the port's own
    save writes the same arrays under the same keys. (The weights start
    from the port's seeded init: aip_tpu's eager mobilenet init takes 17 s
    on the CPU.)"""
    seeded = tmag.init_magenta_params(torch.Generator().manual_seed(1), "mobilenet_v2",
                                      device="cpu")
    tmag.save_magenta_npz(seeded, tmp_path / "seed.npz")
    jparams = jmag.load_magenta_npz(tmp_path / "seed.npz")
    jmag.save_magenta_npz(jparams, tmp_path / "jax.npz")
    tparams = tmag.load_magenta_npz(tmp_path / "jax.npz", device="cpu")
    assert tparams.predictor.mbv2 is not None
    style = rng.random((1, 64, 64, 3)).astype(np.float32)
    _compare_magenta(jparams, tparams, style, rng.random((1, 32, 32, 3)).astype(np.float32))
    tmag.save_magenta_npz(tparams, tmp_path / "port.npz")
    a, b = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "port.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype.kind == b[k].dtype.kind and np.array_equal(a[k], b[k]), k


def _torchvision_state_dict(rng):
    """A torchvision mobilenet_v2 ``features.*`` state dict with random
    weights and BatchNorm statistics."""
    sd = {}

    def conv_bn(conv, bn, cin, cout, k, groups=1):
        sd[f"{conv}.weight"] = rng.standard_normal((cout, cin // groups, k, k)) * (
            2.0 / (k * k * cin // groups)) ** 0.5
        sd[f"{bn}.weight"] = rng.random(cout) + 0.5
        sd[f"{bn}.bias"] = rng.standard_normal(cout) * 0.1
        sd[f"{bn}.running_mean"] = rng.standard_normal(cout) * 0.1
        sd[f"{bn}.running_var"] = rng.random(cout) + 0.5

    conv_bn("features.0.0", "features.0.1", 3, 32, 3)
    idx, cin = 1, 32
    for t, c, n, _s in jmb.MBV2_CFG:
        for _ in range(n):
            base, hid = f"features.{idx}.conv", cin * t
            if t != 1:
                conv_bn(f"{base}.0.0", f"{base}.0.1", cin, hid, 1)
                conv_bn(f"{base}.1.0", f"{base}.1.1", hid, hid, 3, groups=hid)
                conv_bn(f"{base}.2", f"{base}.3", hid, c, 1)
            else:
                conv_bn(f"{base}.0.0", f"{base}.0.1", hid, hid, 3, groups=hid)
                conv_bn(f"{base}.1", f"{base}.2", hid, c, 1)
            idx, cin = idx + 1, c
    conv_bn(f"features.{idx}.0", f"features.{idx}.1", cin, jmb.MBV2_FEATURES, 1)
    return {k: v.astype(np.float32) for k, v in sd.items()}


def test_mbv2_features_match_jax(rng):
    """One torchvision-layout state dict through both converters, then
    mbv2_features on a 64x48 batch; and load_mbv2_trunk_from_torch."""
    sd = _torchvision_state_dict(rng)
    x = rng.random((2, 64, 48, 3)).astype(np.float32)
    ref = jmb.mbv2_features(jmb.convert_torch_mobilenet_v2(sd), jnp.asarray(x))
    trunk = tmb.convert_torch_mobilenet_v2(sd, device="cpu")
    with torch.no_grad():
        out = tmb.mbv2_features(trunk, torch.from_numpy(x))
    assert out.shape == (2, tmb.MBV2_FEATURES)
    _rel_close(out.numpy(), ref)
    params = tmag.init_magenta_params(torch.Generator().manual_seed(3), "mobilenet_v2",
                                      device="cpu")
    params = tmag.load_mbv2_trunk_from_torch(params, sd)
    with torch.no_grad():
        _rel_close(tmb.mbv2_features(params.predictor.mbv2, torch.from_numpy(x)).numpy(), ref)
    with pytest.raises(ValueError):
        tmag.load_mbv2_trunk_from_torch(tmag.init_magenta_params(device="cpu"), sd)


def test_fast_stylizer_video_matches_jax(video_dirs, tmp_path, monkeypatch):
    """apply_style_transfer with the magenta stylizer registered in both
    packages (the committed checkpoint), TV-L1 flows."""
    monkeypatch.setattr(jvideo, "_FAST_STYLIZE", None)
    monkeypatch.setattr(tvideo, "_FAST_STYLIZE", None)
    frames, styles = video_dirs
    style = styles / "s_001.png"
    jmag.use_magenta_stylizer(jmag.load_magenta_npz(DISTILLED))
    tmag.use_magenta_stylizer(tmag.load_magenta_npz(DISTILLED, device="cpu"))
    ref = jvideo.apply_style_transfer(frames, style, tmp_path / "jax", target_resolution=(32, 32))
    trace = {}
    out = tvideo.apply_style_transfer(frames, style, tmp_path / "port",
                                      target_resolution=(32, 32), device="cpu", trace=trace)
    _same_frames(out, ref)
    assert set(trace["stage_ms"]) == {"load", "stylize", "flows", "blend", "save"}


# ---------------------------------------------------------------------------
# CLIs and the device rule
# ---------------------------------------------------------------------------

def _at_32px(monkeypatch, name):
    """The CLIs stylize at 256^2, as the reference; the tests pin the
    pipeline call ``name`` to 32^2 so that they stay small on the CPU."""
    orig = getattr(tvideo, name)
    monkeypatch.setattr(tvideo, name, lambda *a, **k: orig(*a, **{**k, "target_resolution":
                                                                  (32, 32)}))


def _write_mp4(cv2, path, frames, fps=5):
    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for f in frames:
        writer.write((np.clip(f, 0, 1) * 255).astype(np.uint8)[..., ::-1])
    writer.release()
    return path


def test_run_video_cli_fast_stylizer_returns_its_path(tmp_path, monkeypatch):
    """The port's fast-stylizer branch returns the output path, where
    aip_tpu's returns None; and ``--fast_stylizer`` without a value finds
    the committed checkpoint from any working directory, where aip_tpu's
    default is relative to it."""
    cv2 = pytest.importorskip("cv2")
    monkeypatch.setattr(tvideo, "_FAST_STYLIZE", None)
    vid = _write_mp4(cv2, tmp_path / "in.mp4", _texture(3, 4, 32))
    style = _write([np.random.default_rng(4).random((32, 32, 3))], tmp_path / "style")
    work = tmp_path / "elsewhere"
    work.mkdir()
    monkeypatch.chdir(work)
    _at_32px(monkeypatch, "apply_style_transfer")
    argv = ["--fast_stylizer", "--style", str(style / "f_000.png"), "--video", str(vid),
            "--output", str(tmp_path / "out.mp4"), "--frames_dir", str(tmp_path / "cf"),
            "--styled_dir", str(tmp_path / "sf"), "--fps", "5"]
    out = trun_video.main(argv + ["--flow", "farneback", "--device", "cpu"])
    assert out == str(tmp_path / "out.mp4") and Path(out).stat().st_size > 0
    assert len(list((tmp_path / "sf").glob("*.jpg"))) == 4
    assert tvideo._FAST_STYLIZE is not None

    # aip_tpu's CLI on the same arguments, its pipeline stubbed out: None,
    # and a checkpoint path that does not exist from this directory.
    import aip_tpu.models.magenta as jm

    seen = {}
    monkeypatch.setattr(jm, "load_magenta_npz", lambda p: seen.setdefault("npz", p))
    monkeypatch.setattr(jm, "use_magenta_stylizer", lambda p: None)
    for name in ("clear_frames", "video_to_frames", "apply_style_transfer", "frames_to_video"):
        monkeypatch.setattr(jvideo, name, lambda *a, **k: None)
    assert jrun_video.main(argv) is None
    assert not os.path.isabs(seen["npz"]) and not Path(seen["npz"]).exists()


def test_run_video_cli_adain_path(tmp_path, monkeypatch):
    cv2 = pytest.importorskip("cv2")
    _at_32px(monkeypatch, "apply_style_transfer_multi_ada")
    vid = _write_mp4(cv2, tmp_path / "in.mp4", _texture(5, 4, 48, step=(1, 1)))
    g = np.random.default_rng(6)
    styles = _write([g.random((32, 32, 3)), g.random((24, 40, 3))], tmp_path / "styles", "s")
    out = trun_video.main(["--video", str(vid), "--styles", str(styles),
                           "--output", str(tmp_path / "out.mp4"),
                           "--frames_dir", str(tmp_path / "cf"),
                           "--styled_dir", str(tmp_path / "sf"),
                           "--device", "cpu"])
    assert out == str(tmp_path / "out.mp4") and Path(out).stat().st_size > 0
    assert [np.asarray(Image.open(p)).shape for p in sorted((tmp_path / "sf").glob("*.jpg"))] \
        == [(32, 32, 3)] * 4


def test_adain_video_cli(tmp_path):
    cv2 = pytest.importorskip("cv2")
    vid = _write_mp4(cv2, tmp_path / "in.mp4", _texture(7, 3, 40))
    g = np.random.default_rng(8)
    styles = _write([g.random((32, 32, 3)), g.random((32, 32, 3))], tmp_path / "styles", "s")
    out_path = str(tmp_path / "out" / "v.mp4")
    for style_args in ([str(styles / "s_000.png")],
                       [str(styles / "s_000.png"), str(styles / "s_001.png"),
                        "--style_interpolation_weights", "0.3", "0.7"]):
        out = tadain_video.main(["--content_video", str(vid), "--style_path", *style_args,
                                 "--content_size", "32", "--style_size", "32",
                                 "--output", out_path, "--device", "cpu"])
        assert out == out_path and Path(out).stat().st_size > 0
        cap = cv2.VideoCapture(out)
        assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 3
        cap.release()


def test_video_entry_points_without_cuda_raise(video_dirs, tmp_path, monkeypatch):
    """device=None means CUDA; with no CUDA every entry point refuses."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    frames, styles = video_dirs
    style = str(styles / "s_000.png")
    calls = [
        lambda: tvideo.apply_style_transfer_multi_ada(frames, styles, tmp_path / "o"),
        lambda: tvideo.apply_style_transfer(frames, style, tmp_path / "o"),
        lambda: tvideo.apply_style_transfer_multi(frames, styles, tmp_path / "o"),
        lambda: tvideo.run_style_transfer(str(tmp_path / "none.mp4"), styles),
        lambda: tmag.load_magenta_npz(DISTILLED),
        lambda: tmag.init_magenta_params(),
        lambda: tmag.make_fast_stylizer(),
        lambda: tmb.mbv2_trunk_skeleton(),
        lambda: trun_video.main(["--styles", str(styles)]),
        lambda: tadain_video.main(["--content_video", "x.mp4", "--style_path", style]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_mesh_branch_raises_with_several_cards(video_dirs, tmp_path, monkeypatch):
    """aip_tpu shards the frames over its devices when they divide the
    count; the port's frame sharding is slice 6, and says so."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    frames, styles = video_dirs
    with pytest.raises(NotImplementedError, match="slice 6"):
        tvideo.apply_style_transfer_multi_ada(frames, styles, tmp_path / "o", device="cuda")
