"""DeepLabV3-ResNet101 on the regional path (``segmenter="deeplab"``) on the
CPU, against the benchmark's plain reference (``portbench/reference/``,
plain PyTorch and NumPy that import nothing of the port).

The checkpoint is a torchvision-layout ``deeplabv3_resnet101`` state dict
at full widths and 1-2 bottlenecks a stage, seeded as the benchmark seeds
it (He-normal convs, BatchNorm statistics measured on calibration images,
residual branches' last gamma 0.25, class 0's bias set for a 60 %
background), saved with ``torch.save`` and
read through ``deeplab_weights``. No JAX is imported.

Tolerances: logits within 1e-5 of the largest |logit| (fp32 on one CPU,
two walks of the same convs); masks equal wherever the reference's
P(class 0) lies more than 1e-4 from 0.5; each float stage of the call
(the stylized image before its 8-bit save, the composite before its JPEG)
within 1e-4 of the reference's on the same inputs. The result JPEG against
the reference pipeline's is within 1 level mean: at the 32 x 42 working
size one JPEG block is 5 % of the image, so one 8-bit rounding flip of the
fp32 stylize moves a few tenths of a level (the benchmark's cell holds the
full size to its own limit).
"""

import functools
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from aip_tpu_torch.cli import run_semantic_segm as tcli  # noqa: E402
from aip_tpu_torch.models import deeplab as tdeeplab  # noqa: E402
from aip_tpu_torch.models import weights as tweights  # noqa: E402
from aip_tpu_torch.models.vgg19_std import normalize_imagenet  # noqa: E402
from aip_tpu_torch.pipelines import adain_infer as tinfer  # noqa: E402
from aip_tpu_torch.pipelines import localized as tlocal  # noqa: E402
from aip_tpu_torch.utils import profiling  # noqa: E402
from portbench.drivers import _adain, _deeplab  # noqa: E402
from portbench.drivers.request_closed import _png, _write_npz  # noqa: E402
from portbench.reference import adain as ref_adain  # noqa: E402
from portbench.reference import deeplab as ref_deeplab  # noqa: E402
from portbench.reference import images as ref_images  # noqa: E402
from portbench.reference import localized as ref_local  # noqa: E402

torch.set_num_threads(2)

LOGIT_TOL = 1e-5
BAND = 1e-4
FLOAT_TOL = 1e-4
RESULT_LEVELS = 1.0
H, W, WORK = 48, 64, 32
SEED = 2 ** 31 + 29


def _cfg(name, **over):
    return {**json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text()), **over}


def _checkpoint(path, blocks, seed=SEED, h=H, w=W):
    """A seeded torchvision-layout state dict with ``blocks`` a stage (and
    an aux classifier, which the port ignores), saved at ``path``."""
    cfg = _cfg("deeplabv3-resnet101", blocks=blocks)
    sd = _deeplab.seeded_state_dict(cfg, seed, _adain.images(seed + 1000, 2, h, w, "cpu"),
                                    0.6, 0.25)
    saved = dict(sd, **{"aux_classifier.0.weight": torch.zeros(4, 1024, 3, 3)})
    torch.save(saved, str(path))
    return sd


@pytest.fixture(autouse=True)
def _fresh_cache():
    tlocal._DEEPLAB.clear()
    yield
    tlocal._DEEPLAB.clear()


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A 1-1-2-1 checkpoint, AdaIN's npz weights (fitted as the benchmark
    fits them is not needed here: the check is the same computation), one
    48 x 64 content PNG and a 40 x 40 style PNG."""
    d = tmp_path_factory.mktemp("deeplab_scene")
    sd = _checkpoint(d / "deeplab.pt", [1, 1, 2, 1])
    adain_cfg = _cfg("adain-vgg19")
    enc_w, dec_w = _adain.make_weights(adain_cfg, SEED, "cpu")
    (d / "weights").mkdir()
    _write_npz(d / "weights" / "vgg_normalised.npz", enc_w,
               [l for l in adain_cfg["encoder_unused"] if l[0] == "conv"])
    _write_npz(d / "weights" / "adain_decoder.npz", dec_w, [])
    _png(d / "content.png", _adain.images(SEED + 10, 1, H, W, "cpu"))
    _png(d / "style.png", _adain.images(SEED + 2, 1, 40, 40, "cpu"))
    return {"dir": d, "sd": sd, "ckpt": d / "deeplab.pt", "adain_cfg": adain_cfg,
            "enc_w": enc_w, "dec_w": dec_w, "content": d / "content.png",
            "style": d / "style.png"}


@pytest.fixture
def small_adain(scene, monkeypatch):
    """The program's AdaIN weights from the scene's cache, stylizing at a
    32-px working size (the pipeline fixes 512)."""
    monkeypatch.setattr(tweights, "DEFAULT_WEIGHTS_DIR", scene["dir"] / "weights")
    monkeypatch.setattr(tlocal, "adain_inference", functools.partial(
        tinfer.adain_inference, content_size=WORK, style_size=WORK))


def _rel(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return np.abs(out - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("blocks", [[1, 1, 1, 1], [2, 2, 2, 2]])
def test_deeplab_logits_through_deeplab_weights_match_the_plain_reference(tmp_path, blocks):
    """Two blocks a stage run both the first-block and the stage dilation
    of layer3 and layer4; the converter reads each stage's depth from the
    state dict."""
    sd = _checkpoint(tmp_path / "dl.pt", blocks, h=37, w=52)
    params = tlocal.deeplab_params(str(tmp_path / "dl.pt"), "cpu")
    assert [len(s) for s in params["stages"]] == blocks
    img = _adain.images(SEED + 5, 1, 37, 52, "cpu")[0]
    out = tdeeplab.deeplab_logits(params, normalize_imagenet(img)[None])
    with torch.no_grad():
        ref = ref_deeplab.forward(sd, ref_deeplab.normalise(img))
    assert out.shape == (1, 37, 52, 21)
    assert _rel(out.permute(0, 3, 1, 2).numpy(), ref.numpy()) <= LOGIT_TOL


def _spy(monkeypatch, module, store, key):
    """Keep the float array each ``save_image`` of ``module`` gets."""
    real = module.save_image

    def spy(arr, path):
        store[key] = np.asarray(arr.detach().numpy() if isinstance(arr, torch.Tensor) else arr,
                                np.float64)
        return real(arr, path)

    monkeypatch.setattr(module, "save_image", spy)


def test_the_deeplab_call_matches_the_reference_pipeline(scene, small_adain, monkeypatch,
                                                         tmp_path):
    """The written mask against the reference's P(class 0) > 0.5; the
    stylized image before its save against the reference's masked AdaIN;
    the composite before its JPEG against the reference's harmonize of the
    same stylized JPEG and mask; the result JPEG against the reference
    pipeline's."""
    floats = {}
    _spy(monkeypatch, tinfer, floats, "stylized")
    _spy(monkeypatch, tlocal, floats, "combined")
    out = tlocal.run_localized_style_transfer(
        str(scene["content"]), str(scene["style"]), output_path=str(tmp_path), file_name="s",
        segmenter="deeplab", deeplab_weights=str(scene["ckpt"]), save_mask=True, device="cpu")
    assert out == str(tmp_path / tlocal.RESULT_NAME)

    u8 = ref_images.load_uint8(scene["content"])
    prob = ref_deeplab.background_probability(scene["sd"], torch.from_numpy(np.array(u8)) / 255.0)
    prob = prob.numpy()
    ref_mask = (prob > 0.5).astype(np.uint8)
    written = np.asarray(Image.open(tmp_path / tlocal.MASK_NAME))
    assert written.dtype == np.uint8 and written.shape == (H, W)
    assert set(np.unique(written)) <= {0, 255}
    mask = (written > 127).astype(np.uint8)
    far = np.abs(prob - 0.5) > BAND
    assert np.array_equal(mask[far], ref_mask[far])
    assert 0.2 < mask.mean() < 0.8, mask.mean()

    style = ref_images.load_resized(scene["style"], WORK)
    s_mean, s_std = ref_adain.style_stats(scene["adain_cfg"], scene["enc_w"], style[None])
    content = ref_images.load_resized(scene["content"], WORK)
    ref_stylized = ref_adain.stylize(scene["adain_cfg"], scene["enc_w"], scene["dec_w"],
                                     content[None], s_mean, s_std, 1.0)[0]
    ref_stylized = torch.nn.functional.interpolate(
        ref_stylized.permute(2, 0, 1)[None], size=content.shape[:2], mode="bilinear",
        align_corners=False)[0].permute(1, 2, 0)
    m = ref_local.nearest(torch.from_numpy(mask).float(), content.shape[:2])[..., None]
    ref_stylized = (content * (1 - m) + ref_stylized * m).numpy()
    assert np.abs(floats["stylized"][0] - ref_stylized).max() <= FLOAT_TOL

    stylized_jpeg = ref_images.load_uint8(tmp_path / "s.jpg")
    combined = ref_local.harmonize(u8, stylized_jpeg, mask)
    assert np.abs(floats["combined"] - combined).max() <= FLOAT_TOL

    want = ref_local.result(u8, ref_local.jpeg_round_trip(
        ref_local.stylize_masked(scene["adain_cfg"], scene["enc_w"], scene["dec_w"], content,
                                 s_mean, s_std, torch.from_numpy(ref_mask))), ref_mask)
    got = ref_images.load_uint8(out)
    assert np.abs(got.astype(np.int16) - want).mean() <= RESULT_LEVELS


def test_the_checkpoint_is_read_once_over_two_calls(scene, small_adain, monkeypatch,
                                                    tmp_path):
    """A second call with the same file reads nothing; a rewritten file
    (another mtime) is read again."""
    reads = []
    real = tweights._load_torch_state_dict
    monkeypatch.setattr(tweights, "_load_torch_state_dict",
                        lambda p: reads.append(p) or real(p))
    for k in range(2):
        tlocal.run_localized_style_transfer(
            str(scene["content"]), str(scene["style"]), output_path=str(tmp_path / str(k)),
            segmenter="deeplab", deeplab_weights=str(scene["ckpt"]), device="cpu")
    assert len(reads) == 1
    assert not (tmp_path / "0" / tlocal.MASK_NAME).exists()
    first = tlocal.deeplab_params(str(scene["ckpt"]), "cpu")
    st = scene["ckpt"].stat()
    os.utime(scene["ckpt"], ns=(st.st_atime_ns, st.st_mtime_ns + 10 ** 9))
    again = tlocal.deeplab_params(str(scene["ckpt"]), "cpu")
    assert len(reads) == 2 and again is not first
    assert tlocal.deeplab_params(str(scene["ckpt"]), "cpu") is again


def test_deeplab_without_a_real_checkpoint_raises(tmp_path, monkeypatch):
    """No fallback to the seeded init, whose mask is empty: no path, a
    missing file and a git-LFS pointer stub all raise before any network is
    built."""
    monkeypatch.setattr(tdeeplab, "init_deeplab_params",
                        lambda *a, **k: pytest.fail("fell back to the seeded init"))
    stub = tmp_path / "deeplabv3_resnet101.pth"
    stub.write_text("version https://git-lfs.github.com/spec/v1\noid sha256:0\nsize 1\n")
    img = tmp_path / "c.png"
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(img)
    with pytest.raises(ValueError, match="deeplab_weights"):
        tlocal.run_localized_style_transfer(str(img), str(img), segmenter="deeplab",
                                            device="cpu")
    for path in (tmp_path / "missing.pth", stub):
        with pytest.raises(FileNotFoundError, match="DeepLab checkpoint"):
            tlocal.run_localized_style_transfer(str(img), str(img), segmenter="deeplab",
                                                deeplab_weights=str(path), device="cpu")
    with pytest.raises(ValueError, match="segmenter must be"):
        tlocal.run_localized_style_transfer(str(img), str(img), segmenter="fcn", device="cpu")
    with pytest.raises(ValueError, match="not both"):
        tlocal.run_localized_style_transfer(str(img), str(img), segment_fn=lambda x: x,
                                            segmenter="deeplab", device="cpu")


def test_the_cli_flags_reach_the_pipeline(monkeypatch):
    calls = []
    monkeypatch.setattr(tlocal, "run_localized_style_transfer",
                        lambda **kw: calls.append(kw) or "out.jpg")
    base = ["--content", "c.png", "--style", "s.png", "--device", "cpu"]
    tcli.main(base)
    tcli.main(base + ["--segmenter", "deeplab", "--deeplab_weights", "dl.pth", "--save_mask"])
    assert [(c["segmenter"], c["deeplab_weights"], c["save_mask"]) for c in calls] == [
        ("classical", None, False), ("deeplab", "dl.pth", True)]
    assert all(c["device"] == "cpu" for c in calls)
    with pytest.raises(SystemExit):
        tcli.main(base + ["--segmenter", "fcn"])


def test_the_call_records_its_spans_and_counters_under_a_profiler(scene, small_adain,
                                                                  tmp_path):
    from torch.profiler import ProfilerActivity, profile

    tlocal.deeplab_params(str(scene["ckpt"]), "cpu")
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        tlocal.run_localized_style_transfer(
            str(scene["content"]), str(scene["style"]), output_path=str(tmp_path),
            segmenter="deeplab", deeplab_weights=str(scene["ckpt"]), save_mask=True,
            device="cpu")
    stats = profiling.span_stats()
    profiling.reset_spans()
    for name in ("localized.request", "localized.segment", "deeplab.forward",
                 "deeplab.backbone", "deeplab.aspp", "deeplab.head", "localized.harmonize",
                 "localized.save", "adain.stylize"):
        assert stats[name]["count"] == 1 and stats[name]["host_s"] > 0, name
    assert "localized.segmenter_load" not in stats      # loaded before, and cached
    mask = np.asarray(Image.open(tmp_path / tlocal.MASK_NAME)) > 127
    assert stats["localized.pixels"] == H * W
    assert stats["localized.background_px"] == int(mask.sum())
