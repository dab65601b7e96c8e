"""DPT-SwinV2-L-384 (``models.dpt_swin2``) and the depth-aware path's
``depth_model="dpt_swin2_large_384"`` on the CPU, against the benchmark's
plain reference (``portbench/reference/dpt_swin2.py``: plain PyTorch that
imports nothing of the port). No JAX package has a SwinV2. Swin-T's window
helpers, which the network reuses with a window argument, are held here to
the reference's at two windows; Swin-T itself stays held to the JAX
package's by ``test_torch_port_style_mixer.py::test_swin_features_match_jax``.

The tiny network is width 16 (heads of width 8), depths 2 a stage, window
8 with pretrained windows 4, 4, 4, 2, at a 64 x 64 input: stage grids 16
(4 windows, shifted by 4 in odd blocks), 8 (the grid is the window), 4 and
2 (the window clamped to the grid). Its checkpoint is seeded as the
benchmark seeds one (``drivers/_dpt_swin2.py``) and saved in the hub's
layout with ``torch.save``; a second copy draws the position-bias MLP, the
logit scales and the q and v biases large, so that the bias's gather and
the clamp show. The published widths are built on the meta device only.

Tolerances: the forward within 1e-5 of the largest |value| (the same
operations on one CPU; it reads 0); the stylized PNG within 0.05 mean
8-bit levels and the depth PNG within 1 16-bit level of the reference
pipeline's (the PNG rounds to half a level; the program's bicubic resizes
are products of dense matrices, the reference's ``F.interpolate``).
"""

import json
import math
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from aip_tpu_torch.cli import run_depth as tcli  # noqa: E402
from aip_tpu_torch.models import depthnet as tdepth  # noqa: E402
from aip_tpu_torch.models import dpt as tdpt  # noqa: E402
from aip_tpu_torch.models import dpt_swin2 as tswin2  # noqa: E402
from aip_tpu_torch.models import swin as tswin  # noqa: E402
from aip_tpu_torch.models import weights as tweights  # noqa: E402
from aip_tpu_torch.pipelines import adain_infer as tinfer  # noqa: E402
from aip_tpu_torch.utils import profiling  # noqa: E402
from portbench.drivers import _adain, _dpt_swin2  # noqa: E402
from portbench.drivers.request_closed import _png, _write_npz  # noqa: E402
from portbench.reference import adain as ref_adain  # noqa: E402
from portbench.reference import depth as ref_depth  # noqa: E402
from portbench.reference import dpt_swin2 as ref  # noqa: E402
from portbench.reference import images as ref_images  # noqa: E402

torch.set_num_threads(2)

FWD_TOL = 1e-5
IMG_LEVELS = 0.05
DEPTH_LEVELS = 1.0
H, W, WORK = 48, 64, 32
SEED = 2 ** 31 + 41
MODEL = "dpt_swin2_large_384"
LARGE = json.loads((ROOT / "portbench" / "configs" / "dpt-swin2-large-384-midas.json")
                   .read_text())
TINY = {**LARGE, "embed_dim": 16, "depths": [2, 2, 2, 2], "num_heads": [2, 2, 4, 4],
        "window_size": 8, "pretrained_window_sizes": [4, 4, 4, 2], "cpb_hidden": 32,
        "hooks": [1, 1, 1, 1], "features": 32, "head_features": 8, "num_classes": 10,
        "net_size": 64}
FIELDS = {f.name for f in tswin2.dataclasses.fields(tswin2.Swin2DPTConfig)}


def _config(cfg) -> tswin2.Swin2DPTConfig:
    return tswin2.Swin2DPTConfig(**{k: tuple(v) if isinstance(v, list) else v
                                    for k, v in cfg.items() if k in FIELDS})


def _rel(out, want):
    out, want = np.asarray(out, np.float64), np.asarray(want, np.float64)
    return np.abs(out - want).max() / np.abs(want).max()


def _normalised(x):
    return ((x - 0.5) / 0.5).permute(0, 3, 1, 2).contiguous()


def _perturbed(sd):
    """The state dict with the position-bias MLP drawn at std 1, the logit
    scales from N(log 10, 1.5) with each block's first head at log 1000
    (above the log 100 clamp) and the q and v biases at std 0.5."""
    g = torch.Generator().manual_seed(SEED + 3)
    out = dict(sd)
    for k, v in sd.items():
        if ".cpb_mlp." in k:
            out[k] = torch.randn(v.shape, generator=g)
        elif k.endswith("logit_scale"):
            out[k] = math.log(10.0) + 1.5 * torch.randn(v.shape, generator=g)
            out[k][0] = math.log(1000.0)
        elif k.endswith(("q_bias", "v_bias")):
            out[k] = 0.5 * torch.randn(v.shape, generator=g)
    return out


@pytest.fixture(autouse=True)
def _fresh_cache():
    tinfer._DEPTH.clear()
    yield
    tinfer._DEPTH.clear()


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A tiny seeded checkpoint (and its perturbed copy), AdaIN's npz
    weights, one 48 x 64 content PNG and a 40 x 40 style PNG."""
    d = tmp_path_factory.mktemp("dpt_swin2_scene")
    calibration = _adain.images(SEED + 1000, 1, H, W, "cpu")
    sd = _dpt_swin2.seeded_state_dict(TINY, SEED, calibration, 0.9)
    torch.save(sd, str(d / "dpt_swin2.pt"))
    adain_cfg = json.loads((ROOT / "portbench" / "configs" / "adain-vgg19.json").read_text())
    enc_w, dec_w = _adain.make_weights(adain_cfg, SEED, "cpu")
    (d / "weights").mkdir()
    _write_npz(d / "weights" / "vgg_normalised.npz", enc_w,
               [l for l in adain_cfg["encoder_unused"] if l[0] == "conv"])
    _write_npz(d / "weights" / "adain_decoder.npz", dec_w, [])
    _png(d / "content.png", _adain.images(SEED + 10, 1, H, W, "cpu"))
    _png(d / "style.png", _adain.images(SEED + 2, 1, 40, 40, "cpu"))
    return {"dir": d, "sd": sd, "perturbed": _perturbed(sd), "ckpt": d / "dpt_swin2.pt",
            "adain_cfg": adain_cfg, "enc_w": enc_w, "dec_w": dec_w,
            "content": d / "content.png", "style": d / "style.png"}


@pytest.fixture
def tiny(scene, monkeypatch):
    """The program's DPT-SwinV2 at the tiny sizes, AdaIN's weights from the
    scene's cache."""
    monkeypatch.setattr(tswin2, "DPT_SWIN2_L_384", _config(TINY))
    monkeypatch.setattr(tweights, "DEFAULT_WEIGHTS_DIR", scene["dir"] / "weights")
    monkeypatch.setattr(tdepth, "_REGISTERED", None)


def _call(scene, out_dir, **kw):
    return tinfer.adain_inference(str(scene["content"]), str(scene["style"]),
                                  content_size=WORK, style_size=WORK, save_ext=".png",
                                  output=str(out_dir), file_name="s", device="cpu", **kw)


def _pixels(path):
    with Image.open(path) as im:
        return np.asarray(im).astype(np.float64)


# --- the network --------------------------------------------------------------

def test_the_tiny_network_holds_every_kind_of_window():
    """Stage 1 shifted (a grid over the window), stage 2 a grid equal to the
    window, stages 3-4 clamped; pretrained windows unlike the windows; the
    windowed span holds stage 1 alone."""
    with torch.device("meta"):
        net = tswin2.DPTSwin2(_config(TINY))
    got = [(s.grid, b.window, b.shift, b.windows, b.attn.pretrained_window)
           for s in net.pretrained.model.layers for b in s.blocks]
    assert got == [(16, 8, 0, 4, 4), (16, 8, 4, 4, 4), (8, 8, 0, 1, 4), (8, 8, 0, 1, 4),
                   (4, 4, 0, 1, 4), (4, 4, 0, 1, 4), (2, 2, 0, 1, 2), (2, 2, 0, 1, 2)]
    assert [ref.windowing(TINY, i, j) for i in range(4) for j in range(2)] == [
        (w, s) for _g, w, s, _n, _p in got]


@pytest.mark.parametrize("weights", ["seeded", "perturbed"])
def test_the_network_matches_the_plain_reference_at_a_tiny_size(scene, weights):
    """The hub-layout checkpoint through ``dpt_swin2_from_state_dict``
    against the reference's forward of the same state dict (which computes
    the position bias in every block call), and each of the four taps."""
    sd = scene["sd" if weights == "seeded" else "perturbed"]
    net = tswin2.dpt_swin2_from_state_dict({k: v.numpy() for k, v in sd.items()}, "cpu",
                                           _config(TINY))
    x = _adain.images(SEED + 5, 1, 64, 64, "cpu")
    with torch.no_grad():
        out = net(x)
        want = ref.forward(sd, _normalised(x), TINY)
        taps = net._reassemble(net._encode(net._embed(x), x), 64, 64)
        ref_taps = ref.encoder(sd, _normalised(x), TINY)
    assert out.shape == (1, 64, 64)
    assert _rel(out.numpy(), want.numpy()) <= FWD_TOL
    for got, exp, c, g in zip(taps, ref_taps, (16, 32, 64, 128), (16, 8, 4, 2)):
        assert tuple(got.shape) == tuple(exp.shape) == (1, c, g, g)
        assert _rel(got.numpy(), exp.numpy()) <= FWD_TOL
    assert not any(p.requires_grad for p in net.parameters())


def test_the_position_bias_and_scale_are_timms(scene):
    """``prepare``'s buffers against the reference's per-call terms: 16
    sigmoid of the MLP over the log-spaced table gathered by the relative
    index, and exp of the logit scale clamped at log 100."""
    sd = scene["perturbed"]
    net = tswin2.dpt_swin2_from_state_dict(sd, "cpu", _config(TINY))
    clamped = 0
    for (i, j), block in zip([(i, j) for i in range(4) for j in range(2)], net.blocks()):
        p = f"pretrained.model.layers.{i}.blocks.{j}.attn"
        w, heads = block.window, block.attn.heads
        table = ref.coords_table(w, block.attn.pretrained_window)
        hidden = torch.relu(torch.nn.functional.linear(table, sd[f"{p}.cpb_mlp.0.weight"],
                                                       sd[f"{p}.cpb_mlp.0.bias"]))
        bias = torch.nn.functional.linear(hidden, sd[f"{p}.cpb_mlp.2.weight"]).view(-1, heads)
        bias = bias[ref.position_index(w).view(-1)].view(w * w, w * w, -1).permute(2, 0, 1)
        assert torch.equal(block.attn.pos_bias, 16 * torch.sigmoid(bias.contiguous()))
        scale = sd[f"{p}.logit_scale"]
        assert torch.equal(block.attn.scale, torch.clamp(scale, max=math.log(100.0)).exp())
        clamped += int((scale > math.log(100.0)).sum())
    assert clamped == 8
    assert float(net.blocks()[0].attn.pos_bias.std()) > 1.0


def test_the_seeded_init_is_timms_and_passes_its_share_of_the_calibration_image():
    """``init_dpt_swin2_params``: the reference's forward of its state dict
    gives its forward; timm's scales; and its output ReLU passes
    ``PASS_SHARE`` of the pixels of the calibration image at the network's
    input size."""
    net = tswin2.init_dpt_swin2_params(torch.Generator().manual_seed(5), "cpu", _config(TINY))
    sd = net.state_dict()
    gen = torch.Generator().manual_seed(5)
    drawn = tswin2.draw_dpt_swin2_params(gen, _config(TINY))
    img = tdpt.calibration_image(gen, (64, 64))
    with torch.no_grad():
        out = net(img)
        want = ref.forward(sd, _normalised(img), TINY)
        pre = net(img, relu=False)
    assert _rel(out.numpy(), want.numpy()) <= FWD_TOL
    last = "scratch.output_conv.4.bias"
    assert all(torch.equal(v, sd[k]) for k, v in drawn.state_dict().items() if k != last)
    assert abs(float((pre > 0).float().mean()) - tdpt.PASS_SHARE) < 1e-3
    blk = net.blocks()[0]
    assert torch.equal(blk.attn.logit_scale, torch.full((2, 1, 1), math.log(10.0)))
    assert float(blk.attn.q_bias.abs().max()) == float(blk.attn.v_bias.abs().max()) == 0.0
    assert float(blk.norm1.weight.min()) == 1.0 and float(blk.norm2.bias.abs().max()) == 0.0
    assert 0.015 < float(blk.mlp.fc1.weight.std()) < 0.025
    assert float(blk.mlp.fc1.bias.abs().max()) == 0.0


def test_the_published_widths_are_the_hub_layout():
    """DPT-SwinV2-L-384 on the meta device: every learned key and shape of
    the hub's ``DPT_SwinV2_L_384`` state dict in timm's order (the
    reference's list), 213,411,869 numbers, a strict round trip; its timm
    buffers at their shapes; 60 windows a 384^2 image."""
    with torch.device("meta"):
        net = tswin2.DPTSwin2()
    got = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    want = ref.state_dict_shapes(LARGE)
    assert list(got) == list(want) and got == want
    assert sum(np.prod(s) for s in got.values()) == LARGE["parameters"] == 213_411_869
    with torch.device("meta"):
        other = tswin2.DPTSwin2(_config(LARGE))
    assert other.config == tswin2.DPT_SWIN2_L_384
    assert other.config.widths == tuple(LARGE["widths"]) and other.config.grids == (96, 48, 24,
                                                                                    12)
    result = other.load_state_dict(net.state_dict(), strict=True, assign=True)
    assert not result.missing_keys and not result.unexpected_keys
    bufs = {k: tuple(v.shape) for k, v in net.recomputed_buffers().items()}
    b = "pretrained.model.layers"
    assert bufs[f"{b}.0.blocks.1.attn_mask"] == (16, 576, 576)
    assert bufs[f"{b}.1.blocks.1.attn_mask"] == (4, 576, 576)
    assert f"{b}.2.blocks.1.attn_mask" not in bufs and f"{b}.0.blocks.0.attn_mask" not in bufs
    assert bufs[f"{b}.2.blocks.17.attn.relative_coords_table"] == (1, 47, 47, 2)
    assert bufs[f"{b}.3.blocks.1.attn.relative_coords_table"] == (1, 23, 23, 2)
    assert bufs[f"{b}.3.blocks.1.attn.relative_position_index"] == (144, 144)
    assert sum(blk.windows for blk in net.blocks()) == 60


@pytest.mark.parametrize("change", ["none", "table", "index", "mask", "extra_mask", "missing"])
def test_timms_buffers_are_checked_and_dropped(scene, change):
    """A checkpoint holding timm 0.6's buffers loads strictly, giving the
    same network; one whose buffer differs from the recomputed value, a
    mask on an unshifted block, or a learned tensor missing raises."""
    with torch.device("meta"):
        net = tswin2.DPTSwin2(_config(TINY))
    bufs = net.recomputed_buffers()
    sd = {**scene["sd"], **bufs}
    b = "pretrained.model.layers.0.blocks.1"
    if change == "table":
        sd[f"{b}.attn.relative_coords_table"] = bufs[f"{b}.attn.relative_coords_table"] + 1e-4
    elif change == "index":
        sd[f"{b}.attn.relative_position_index"] = bufs[f"{b}.attn.relative_position_index"].flip(0)
    elif change == "mask":
        sd[f"{b}.attn_mask"] = torch.zeros_like(bufs[f"{b}.attn_mask"])
    elif change == "extra_mask":
        sd["pretrained.model.layers.1.blocks.1.attn_mask"] = bufs[f"{b}.attn_mask"][:1]
    elif change == "missing":
        del sd[f"{b}.attn.q_bias"]
    if change != "none":
        with pytest.raises((ValueError, RuntimeError)):
            tswin2.dpt_swin2_from_state_dict(sd, "cpu", _config(TINY))
        return
    net = tswin2.dpt_swin2_from_state_dict(sd, "cpu", _config(TINY))
    plain = tswin2.dpt_swin2_from_state_dict(scene["sd"], "cpu", _config(TINY))
    x = _adain.images(SEED + 6, 1, 64, 64, "cpu")
    with torch.no_grad():
        assert torch.equal(net(x), plain(x))
    assert set(net.state_dict()) == set(scene["sd"])


@pytest.mark.parametrize("hw", [(768, 1024), (1080, 1920), (384, 384), (500, 300), (10, 4000)])
def test_the_transform_squeezes_every_image_to_the_net_size(hw):
    """``swin384_transform``: ``keep_aspect_ratio=False``, so every image
    goes to 384 x 384 (the reference agrees), and the network refuses any
    other input, as timm's patch embedding does."""
    assert tdpt.transform_size(*hw, tswin2.DPT_SWIN2_L_384) == (384, 384)
    assert ref.transform_size(*hw, LARGE) == (384, 384)
    net = tswin2.init_dpt_swin2_params(torch.Generator().manual_seed(1), "cpu", _config(TINY))
    with pytest.raises(ValueError, match="64 x 64"):
        net(torch.zeros(1, 64, 96, 3))


# --- the depth-aware path -----------------------------------------------------

def test_the_call_matches_the_reference_pipeline(scene, tiny, tmp_path):
    """``adain_inference(use_depth=True, depth_model="dpt_swin2_large_384",
    save_depth=True)``: the depth PNG against the reference's normalised
    proximity (its 48 x 64 content squeezed to the 64 x 64 input), the
    stylized PNG against the reference's depth-blended AdaIN."""
    out = _call(scene, tmp_path, use_depth=True, depth_model=MODEL,
                depth_weights=str(scene["ckpt"]), save_depth=True, depth_offset=0.15)
    assert out == tmp_path / "s.png" and (tmp_path / "s_depth.png").is_file()
    u8 = ref_images.load_uint8(scene["content"])
    prox = ref.proximity(scene["sd"], torch.from_numpy(u8.copy()).float() / 255.0, TINY)
    dep = _pixels(tmp_path / "s_depth.png")
    assert dep.shape == (H, W) and dep.min() == 0 and dep.max() == 65535
    assert np.abs(dep - 65535 * ref_depth.normalised(prox)).max() <= DEPTH_LEVELS
    assert 0.3 < float((prox > 0).float().mean())

    style = ref_images.load_resized(scene["style"], WORK)
    s_mean, s_std = ref_adain.style_stats(scene["adain_cfg"], scene["enc_w"], style[None])
    content = ref_images.load_resized(scene["content"], WORK)
    want = ref_depth.stylize_depth(scene["adain_cfg"], scene["enc_w"], scene["dec_w"], content,
                                   s_mean, s_std, prox, 0.15, 20.0)
    got = _pixels(out)
    assert got.shape == tuple(want.shape)
    assert np.abs(got - ref_adain.to_uint8(want).numpy()).mean() <= IMG_LEVELS


def test_the_network_is_read_once_and_a_bad_path_raises(scene, tiny, monkeypatch, tmp_path):
    """``depth_network`` keeps the network across calls with the same file
    and the seeded init; a missing file or a git-LFS pointer raises."""
    reads = []
    real = tweights._load_torch_state_dict
    monkeypatch.setattr(tweights, "_load_torch_state_dict",
                        lambda p: reads.append(p) or real(p))
    first = tinfer.depth_network(MODEL, str(scene["ckpt"]), "cpu")
    assert tinfer.depth_network(MODEL, str(scene["ckpt"]), "cpu") is first
    assert len(reads) == 1
    assert tinfer.depth_network(MODEL, None, "cpu") is tinfer.depth_network(MODEL, None, "cpu")
    assert tinfer.depth_network("dpt_large", None, "cpu") is not tinfer.depth_network(
        MODEL, None, "cpu")
    stub = tmp_path / "dpt_swin2_large_384.pt"
    stub.write_text("version https://git-lfs.github.com/spec/v1\noid sha256:0\nsize 1\n")
    for path in (stub, tmp_path / "missing.pt"):
        with pytest.raises(FileNotFoundError, match="checkpoint"):
            _call(scene, tmp_path, use_depth=True, depth_model=MODEL, depth_weights=str(path))


def test_run_depth_writes_both_pngs(scene, tiny, tmp_path):
    """``run_depth --use_depth --depth_model dpt_swin2_large_384
    --depth_weights PT --save_depth`` on the CPU: the stylized PNG and the
    16-bit depth PNG, as the call writes them."""
    out = tmp_path / "cli"
    path = tcli.main(["--content", str(scene["content"]), "--style", str(scene["style"]),
                      "--output", str(out), "--file_name", "s", "--use_depth",
                      "--depth_model", MODEL, "--depth_weights", str(scene["ckpt"]),
                      "--save_depth", "--device", "cpu"])
    assert Path(path) == out / "s.jpg" and Path(path).is_file()
    with Image.open(out / "s_depth.png") as im:
        assert im.mode.startswith("I") and im.size == (W, H)
    same = _call(scene, tmp_path / "call", use_depth=True, depth_model=MODEL,
                 depth_weights=str(scene["ckpt"]), save_depth=True)
    assert np.array_equal(_pixels(out / "s_depth.png"), _pixels(same.with_name("s_depth.png")))


def test_the_call_records_its_spans_and_counters_under_a_profiler(scene, tiny, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    tinfer.depth_network(MODEL, str(scene["ckpt"]), "cpu")
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        _call(scene, tmp_path, use_depth=True, depth_model=MODEL,
              depth_weights=str(scene["ckpt"]))
    stats = profiling.span_stats()
    profiling.reset_spans()
    for name in ("dpt.forward", "dpt.embed", "dpt.encoder", "dpt.reassemble", "dpt.fusion",
                 "dpt.head", "swin2.windowed", "swin2.global"):
        assert stats[name]["count"] == 1 and stats[name]["host_s"] > 0, name
    for inner in ("swin2.windowed", "swin2.global"):
        assert stats[inner]["host_s"] < stats["dpt.encoder"]["host_s"]
    assert "adain.depth_load" not in stats
    # 64 x 64 input, patch 4: 16 x 16 tokens; windows 2 x 4 + 2 + 2 + 2.
    assert stats["dpt.tokens"] == 16 * 16
    assert stats["swin2.windows"] == 14
    assert stats["depth.calls"] == 1 and stats["depth.network_calls"] == 1


# --- Swin-T's window helpers ----------------------------------------------------

@pytest.mark.parametrize("window", [7, 8])
def test_the_window_helpers_take_a_window(window):
    """Partition, reverse and the shift mask at a window argument: the
    round trip is the identity, window 7 is the default, and the mask is
    the reference's (timm's) at the window."""
    x = torch.randn(2, 2 * window, 3 * window, 5, generator=torch.Generator().manual_seed(2))
    s = window // 2
    xw, dims = tswin._window_partition(x, s, s, window)
    assert xw.shape == (2 * 6, window * window, 5)
    back = tswin._window_reverse(xw, dims, 2 * window, 3 * window, 5, s, s, window)
    assert torch.equal(back, x)
    if window == tswin.WINDOW:
        assert torch.equal(xw, tswin._window_partition(x, s, s)[0])
        assert torch.equal(tswin._shift_mask(14, 21, 3, 3, "cpu"),
                           tswin._shift_mask(14, 21, 3, 3, "cpu", 7))
    mask = tswin._shift_mask(2 * window, 2 * window, s, s, "cpu", window)
    assert torch.equal(mask, ref.shift_mask(2 * window, window, s))
    assert torch.equal(torch.from_numpy(tswin._rel_index(window)), ref.position_index(window))
