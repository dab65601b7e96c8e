"""The gaps in modules already ported, and the ImageNet VGG-19: aip_tpu_torch
against aip_tpu on the CPU, on inputs drawn with numpy from a seed.

Tolerances: quaternion functions 1e-6 (absolute; unit-scale rotations and
covariances of exp-normal scales, relative 1e-6 where they grow);
``reflect_conv3x3`` 1e-5 absolute against JAX and against reflection pad +
VALID conv; VGG-19 features 1e-5 of the largest |value|; the sweep CLI's
images within one 8-bit step everywhere and 1e-3 on average (BASELINE.md).
"""

import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

import jax.numpy as jnp

from aip_tpu.cli import sweep_depth as jsweep
from aip_tpu.models import decoder as jdec
from aip_tpu.models import vgg as jvgg
from aip_tpu.models import vgg19_std as jv19
from aip_tpu.models import weights as jweights
from aip_tpu.ops import image as jimage
from aip_tpu.ops import quaternion as jq
from aip_tpu.pipelines import adain_infer as jinfer
from aip_tpu_torch.cli import sweep_depth as tsweep
from aip_tpu_torch.models import vgg19_std as tv19
from aip_tpu_torch.models import weights as tweights
from aip_tpu_torch.ops import image as timage
from aip_tpu_torch.ops import quaternion as tq
from aip_tpu_torch.pipelines import adain_infer as tinfer

torch.set_num_threads(2)

QUAT_TOL = 1e-6
CONV_TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# ops/quaternion.py
# ---------------------------------------------------------------------------

@pytest.fixture
def splats(rng):
    s = np.exp(rng.standard_normal((64, 3)) * 0.5).astype(np.float32)
    q = rng.standard_normal((64, 4)).astype(np.float32)
    return s, q


def test_build_scaling_rotation_matches_jax(splats):
    s, q = splats
    np.testing.assert_allclose(tq.build_scaling_rotation(_t(s), _t(q)).numpy(),
                               np.asarray(jq.build_scaling_rotation(jnp.asarray(s),
                                                                    jnp.asarray(q))),
                               atol=QUAT_TOL, rtol=QUAT_TOL)


@pytest.mark.parametrize("modifier", [1.0, 0.37])
def test_covariance_and_strip_symmetric_match_jax(splats, modifier):
    s, q = splats
    ref = jq.covariance_from_scaling_rotation(jnp.asarray(s), jnp.asarray(q), modifier)
    out = tq.covariance_from_scaling_rotation(_t(s), _t(q), modifier)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=QUAT_TOL, rtol=QUAT_TOL)
    packed = tq.strip_symmetric(out).numpy()
    np.testing.assert_allclose(packed, np.asarray(jq.strip_symmetric(ref)),
                               atol=QUAT_TOL, rtol=QUAT_TOL)
    # order 00, 01, 02, 11, 12, 22
    c = out.numpy()
    assert np.array_equal(packed, np.stack([c[:, 0, 0], c[:, 0, 1], c[:, 0, 2], c[:, 1, 1],
                                            c[:, 1, 2], c[:, 2, 2]], -1))


# ---------------------------------------------------------------------------
# ops/image.py::reflect_conv3x3
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw", [(8, 10), (5, 5), (2, 3), (3, 2), (16, 7)])
@pytest.mark.parametrize("bias", [True, False])
def test_reflect_conv3x3_matches_jax_and_pad_conv(rng, hw, bias):
    x = rng.random((2, *hw, 5)).astype(np.float32)
    k = rng.standard_normal((3, 3, 5, 4)).astype(np.float32)  # HWIO
    b = rng.standard_normal(4).astype(np.float32) if bias else None
    ref = np.asarray(jimage.reflect_conv3x3(jnp.asarray(x), jnp.asarray(k),
                                            None if b is None else jnp.asarray(b)))
    w = _t(np.transpose(k, (3, 2, 0, 1)))  # OIHW
    out = timage.reflect_conv3x3(_t(x), w, None if b is None else _t(b))
    assert out.shape == ref.shape == (2, *hw, 4)
    np.testing.assert_allclose(out.numpy(), ref, atol=CONV_TOL)
    padded = timage.reflection_pad_2d(_t(x)).permute(0, 3, 1, 2)
    plain = F.conv2d(padded, w, None if b is None else _t(b)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.numpy(), plain.numpy(), atol=CONV_TOL)


def test_reflect_conv3x3_gradients_match_pad_conv(rng):
    x = _t(rng.random((1, 6, 9, 3)).astype(np.float32)).requires_grad_()
    w = _t(rng.standard_normal((2, 3, 3, 3)).astype(np.float32)).requires_grad_()
    g = _t(rng.random((1, 6, 9, 2)).astype(np.float32))
    grads = []
    for fn in (lambda: timage.reflect_conv3x3(x, w),
               lambda: F.conv2d(timage.reflection_pad_2d(x).permute(0, 3, 1, 2), w)
               .permute(0, 2, 3, 1)):
        grads.append(torch.autograd.grad((fn() * g).sum(), (x, w)))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=CONV_TOL)


# ---------------------------------------------------------------------------
# models/vgg19_std.py
# ---------------------------------------------------------------------------

def _vgg19_hwio(rng):
    return [{"w": (rng.standard_normal((3, 3, cin, cout)) * (2.0 / (9 * cin)) ** 0.5)
                  .astype(np.float32),
             "b": (rng.standard_normal(cout) * 0.05).astype(np.float32)}
            for _, cin, cout, _ in jv19.conv_specs()]


@pytest.mark.parametrize("taps", [jv19.NST_STYLE_LAYERS + (jv19.NST_CONTENT_LAYER,),
                                  ("conv2_1",)])
def test_vgg19_features_match_jax(rng, taps):
    params = _vgg19_hwio(rng)
    img = rng.random((1, 37, 45, 3)).astype(np.float32)
    x = np.asarray(jv19.normalize_imagenet(jnp.asarray(img)))
    np.testing.assert_allclose(tv19.normalize_imagenet(_t(img)).numpy(), x, atol=1e-6)
    ref = jv19.extract_features(params, jnp.asarray(x), taps)
    out = tv19.extract_features(tv19.from_jax_params(params, "cpu"), _t(x), taps)
    assert sorted(out) == sorted(ref) == sorted(taps)
    for name in taps:
        r = np.asarray(ref[name])
        assert out[name].shape == r.shape
        assert np.abs(out[name].numpy() - r).max() <= CONV_TOL * np.abs(r).max(), name
    y = rng.normal(0, 2, (1, 5, 6, 3)).astype(np.float32)
    np.testing.assert_allclose(tv19.denormalize_imagenet(_t(y)).numpy(),
                               np.asarray(jv19.denormalize_imagenet(jnp.asarray(y))), atol=1e-6)


def test_vgg19_params_from_the_shared_cache(rng, tmp_path, monkeypatch):
    """The npz cache both packages read; without it, the port's
    deterministic init (one generator seed, one model)."""
    params = _vgg19_hwio(rng)
    monkeypatch.setattr(jweights, "DEFAULT_WEIGHTS_DIR", tmp_path)
    monkeypatch.setattr(tweights, "DEFAULT_WEIGHTS_DIR", tmp_path)
    a = tv19.get_vgg19_params(device="cpu")
    b = tv19.init_vgg19_params(torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(p["w"], q["w"]) for p, q in zip(a, b))
    assert tuple(a[0]["w"].shape) == (64, 3, 3, 3) and len(a) == 13
    jweights.save_params_npz(params, tmp_path / "vgg19_imagenet.npz")
    x = rng.standard_normal((1, 20, 18, 3)).astype(np.float32)
    ref = jv19.extract_features(jv19.get_vgg19_params(), jnp.asarray(x), ("conv3_1",))
    out = tv19.extract_features(tv19.get_vgg19_params(device="cpu"), _t(x), ("conv3_1",))
    r = np.asarray(ref["conv3_1"])
    assert np.abs(out["conv3_1"].numpy() - r).max() <= CONV_TOL * np.abs(r).max()


# ---------------------------------------------------------------------------
# cli/sweep_depth.py
# ---------------------------------------------------------------------------

def _hwio_params(rng, specs):
    return [{"w": (rng.standard_normal((k, k, cin, cout)) * (2.0 / (k * k * cin)) ** 0.5)
                  .astype(np.float32),
             "b": (rng.standard_normal(cout) * 0.05).astype(np.float32)}
            for k, cin, cout in specs]


@pytest.mark.parametrize("flags", [["--offsets", "0", "0.5"], ["--prominences", "10"]])
def test_sweep_depth_cli_matches_jax(rng, tmp_path, monkeypatch, flags):
    """Both CLIs stylize at a 32-px working size (PNG, so that the pixels
    compare without the codec) from one weight cache; the comparison
    figure is written after the stylizations."""
    jweights.save_params_npz(
        _hwio_params(rng, [(k, cin, cout) for _, cin, cout, k, _ in jvgg.conv_specs()]),
        tmp_path / "w" / "vgg_normalised.npz")
    jweights.save_params_npz(
        _hwio_params(rng, [(3, cin, cout) for _, cin, cout, _ in jdec.conv_specs()]),
        tmp_path / "w" / "adain_decoder.npz")
    monkeypatch.setattr(jweights, "DEFAULT_WEIGHTS_DIR", tmp_path / "w")
    monkeypatch.setattr(tweights, "DEFAULT_WEIGHTS_DIR", tmp_path / "w")
    for mod in (jinfer, tinfer):
        monkeypatch.setattr(mod, "adain_inference", functools.partial(
            mod.adain_inference, content_size=32, style_size=32, save_ext=".png"))
    c, s = tmp_path / "c.png", tmp_path / "s.png"
    Image.fromarray((rng.random((40, 52, 3)) * 255).astype(np.uint8)).save(c)
    Image.fromarray((rng.random((36, 36, 3)) * 255).astype(np.uint8)).save(s)
    argv = ["--content", str(c), "--style", str(s), *flags]
    ref = jsweep.main(argv + ["--output", str(tmp_path / "j")])
    out = tsweep.main(argv + ["--output", str(tmp_path / "t"), "--device", "cpu"])
    assert out.endswith("depth_values_comparison.png") and Image.open(out).size
    names = sorted(p.name for p in (tmp_path / "t").glob("sweep_*.png"))
    assert names == sorted(p.name for p in (tmp_path / "j").glob("sweep_*.png"))
    assert len(names) == len(flags) - 1
    for n in names:
        a = np.asarray(Image.open(tmp_path / "t" / n), np.int16)
        b = np.asarray(Image.open(tmp_path / "j" / n), np.int16)
        assert np.abs(a - b).max() <= 1 and np.abs(a - b).mean() / 255 <= 1e-3


def test_gap_entry_points_without_cuda_raise(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tsweep.main(["--content", "c.png", "--style", "s.png",
                                      "--output", str(tmp_path)]),
                 lambda: tv19.get_vgg19_params(),
                 lambda: tv19.init_vgg19_params()):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


# ---------------------------------------------------------------------------
# Slice 7: every public name of the new modules, the host utilities and the
# COLMAP runner
# ---------------------------------------------------------------------------

# (module under aip_tpu / aip_tpu_torch, JAX names the port leaves out, why)
SLICE7_MODULES = (
    ("data", (), ""),
    ("data.images", (), ""),
    ("parallel", ("make_mesh", "best_grid", "conv_param_sharding", "batch_sharding",
                  "replicated"), "meshes and shardings: ROADMAP queue 1 item 9"),
    ("parallel.train", (), ""),
    ("cli.train_adain", (), ""),
    ("cli.train_magenta", (), ""),
    ("models.magenta_train", (), ""),
    ("models.midas", (), ""),
    ("utils", (), ""),
    ("utils.logging", (), ""),
    ("utils.profiling", ("jnp_flat",), "a jax.numpy helper of device_sync"),
    ("utils.system", (), ""),
    ("gs.convert", (), ""),
)


def _public_names(mod):
    """Functions and classes a module defines or, for a package, exports."""
    import inspect

    is_pkg = hasattr(mod, "__path__")
    return {name for name, obj in vars(mod).items()
            if not name.startswith("_") and (inspect.isfunction(obj) or inspect.isclass(obj))
            and (is_pkg or obj.__module__ == mod.__name__)}


@pytest.mark.parametrize("name,left_out,why", SLICE7_MODULES, ids=[m[0] for m in SLICE7_MODULES])
def test_slice7_public_names_match_jax(name, left_out, why):
    import importlib

    jax_names = _public_names(importlib.import_module(f"aip_tpu.{name}"))
    port_names = _public_names(importlib.import_module(f"aip_tpu_torch.{name}"))
    assert jax_names - port_names == set(left_out), why


def test_scalar_logger_matches_jax(tmp_path):
    import json

    from aip_tpu.utils.logging import ScalarLogger as JLogger
    from aip_tpu_torch.utils.logging import ScalarLogger as TLogger

    for cls, d in ((JLogger, tmp_path / "j"), (TLogger, tmp_path / "t")):
        log = cls(d, use_tensorboard=False)
        log.scalar("loss", 1.5, 1)
        log.scalar("lr", np.float32(0.25), np.int64(2))
        log.close()
    recs = [[{k: v for k, v in json.loads(l).items() if k != "t"}
             for l in (d / "scalars.jsonl").read_text().splitlines()]
            for d in (tmp_path / "j", tmp_path / "t")]
    assert recs[0] == recs[1] == [{"tag": "loss", "value": 1.5, "step": 1},
                                  {"tag": "lr", "value": 0.25, "step": 2}]


def test_system_utils_match_jax(tmp_path, monkeypatch):
    import random
    import sys

    from aip_tpu.utils import system as jsys
    from aip_tpu_torch.utils import system as tsys

    for i, mod in enumerate((jsys, tsys)):
        d = tmp_path / f"d{i}"
        mod.mkdir_p(str(d / "a" / "b"))
        mod.mkdir_p(str(d / "a" / "b"))
        for n in ("iteration_7000", "iteration_30000", "ours_15000", "notes"):
            (d / n).mkdir()
        assert mod.search_for_max_iteration(d) == 30000
        (d / "file").write_text("x")
        with pytest.raises(OSError):
            mod.mkdir_p(str(d / "file"))
    draws = []
    for mod in (jsys, tsys):
        monkeypatch.setattr(sys, "stdout", sys.stdout)
        mod.safe_state(silent=True, seed=3)
        print("silenced")
        draws.append((random.random(), np.random.rand()))
    assert draws[0] == draws[1]
    torch.manual_seed(0)
    tsys.safe_state(silent=True, seed=3)
    a = torch.rand(4)
    torch.manual_seed(3)
    assert torch.equal(a, torch.rand(4))


def test_profiling_utils(tmp_path):
    from aip_tpu_torch.utils import profiling as tprof

    timer = tprof.StepTimer(ema=0.5)
    for _ in range(2):
        timer.start()
        x = torch.ones(4) * 2
        dt = timer.stop(sync_on=[x])
        assert dt >= 0.0
    assert timer.value is not None
    tprof.device_sync(x)
    with tprof.trace(tmp_path / "tr"):
        torch.ones(8).sum()
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0


FAKE_COLMAP = """#!{python}
import json, shutil, sys
from pathlib import Path

args = sys.argv[1:]
with open({log!r}, "a") as f:
    f.write(json.dumps(args) + "\\n")
opt = dict(zip(args[1::2], args[2::2]))
if args[0] == "mapper":
    out = Path(opt["--output_path"]) / "0"
    out.mkdir(parents=True, exist_ok=True)
if args[0] == "image_undistorter":
    out = Path(opt["--output_path"])
    (out / "sparse").mkdir(parents=True, exist_ok=True)
    for n in ("cameras.bin", "images.bin", "points3D.bin"):
        (out / "sparse" / n).write_bytes(b"stub")
    (out / "images").mkdir(exist_ok=True)
    for p in Path(opt["--image_path"]).iterdir():
        shutil.copy(p, out / "images" / p.name)
"""


@pytest.mark.parametrize("skip_matching", [False, True])
def test_convert_scene_matches_jax(tmp_path, rng, skip_matching):
    """The same colmap calls (paths relative to each scene) and a byte-equal
    resize pyramid; a missing binary raises the same error."""
    import json
    import sys

    from aip_tpu.gs import convert as jconv
    from aip_tpu_torch.gs import convert as tconv

    imgs = [(rng.random((24, 40, 3)) * 255).astype(np.uint8) for _ in range(2)]
    calls = {}
    for name, mod in (("j", jconv), ("t", tconv)):
        src = tmp_path / name / "scene"
        (src / "input").mkdir(parents=True)
        if skip_matching:
            (src / "distorted" / "sparse" / "0").mkdir(parents=True)
        for i, a in enumerate(imgs):
            Image.fromarray(a).save(src / "input" / f"im{i}.png")
        log = tmp_path / name / "calls.jsonl"
        exe = tmp_path / name / "colmap"
        exe.write_text(FAKE_COLMAP.format(python=sys.executable, log=str(log)))
        exe.chmod(0o755)
        assert mod.convert_scene(src, colmap_executable=str(exe), resize=True,
                                 skip_matching=skip_matching) == str(src)
        calls[name] = [[a.replace(str(src), "SRC") for a in json.loads(l)]
                       for l in log.read_text().splitlines()]
    assert calls["t"] == calls["j"] and len(calls["t"]) == (1 if skip_matching else 4)
    for factor in (2, 4, 8):
        for i in range(2):
            rel = f"scene/images_{factor}/im{i}.png"
            assert (tmp_path / "t" / rel).read_bytes() == (tmp_path / "j" / rel).read_bytes()
    assert sorted(p.name for p in (tmp_path / "t" / "scene" / "sparse" / "0").iterdir()) == [
        "cameras.bin", "images.bin", "points3D.bin"]


def test_convert_without_colmap_raises_as_jax(tmp_path, monkeypatch):
    import shutil

    from aip_tpu.gs import convert as jconv
    from aip_tpu_torch.gs import convert as tconv

    monkeypatch.setattr(shutil, "which", lambda name: None)
    msgs = []
    for mod in (jconv, tconv):
        with pytest.raises(RuntimeError, match="colmap binary not found") as err:
            mod.main(["-s", str(tmp_path)])
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
