"""DPT-Large (``models.dpt``) and the depth-aware path's choice of network
(``adain_inference(depth_model=...)``) on the CPU, against the benchmark's
plain reference (``portbench/reference/dpt.py``, ``reference/depth.py``:
plain PyTorch that imports nothing of the port). No JAX package has a DPT.

The small DPT is hidden 64, 4 heads, 4 blocks hooked at [0, 1, 2, 3],
reassemble widths [16, 32, 64, 64], features 32, a 6 x 6 position grid;
its checkpoint is seeded as the benchmark seeds one (``drivers/_dpt.py``)
and saved in the hub's layout with ``torch.save``. The published widths
are built on the meta device only.

Tolerances: the forward within 1e-5 of the largest |value| (the same
operations on one CPU; it reads 0); the stylized PNG within 0.05 mean
8-bit levels and the depth PNG within 1 16-bit level of the reference
pipeline's (the PNG rounds to half a level; the program's bicubic resizes
are products of dense matrices, the reference's ``F.interpolate``).
"""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from aip_tpu_torch.cli import run_depth as tcli  # noqa: E402
from aip_tpu_torch.models import depthnet as tdepth  # noqa: E402
from aip_tpu_torch.models import dpt as tdpt  # noqa: E402
from aip_tpu_torch.models import midas as tmidas  # noqa: E402
from aip_tpu_torch.models import weights as tweights  # noqa: E402
from aip_tpu_torch.pipelines import adain_infer as tinfer  # noqa: E402
from aip_tpu_torch.utils import profiling  # noqa: E402
from portbench.drivers import _adain, _dpt  # noqa: E402
from portbench.drivers.request_closed import _png, _write_npz  # noqa: E402
from portbench.reference import adain as ref_adain  # noqa: E402
from portbench.reference import depth as ref_depth  # noqa: E402
from portbench.reference import dpt as ref_dpt  # noqa: E402
from portbench.reference import images as ref_images  # noqa: E402
from portbench.roofline import dpt as dpt_work  # noqa: E402

torch.set_num_threads(2)

FWD_TOL = 1e-5
IMG_LEVELS = 0.05
DEPTH_LEVELS = 1.0
H, W, WORK = 48, 64, 32
SEED = 2 ** 31 + 37
LARGE = json.loads((ROOT / "portbench" / "configs" / "dpt-large-midas.json").read_text())
SMALL = {**LARGE, "hidden_size": 64, "num_hidden_layers": 4, "num_attention_heads": 4,
         "intermediate_size": 256, "pos_grid": 6, "hooks": [0, 1, 2, 3],
         "reassemble_widths": [16, 32, 64, 64], "features": 32, "net_size": 64}
FIELDS = {f.name for f in tdpt.dataclasses.fields(tdpt.DPTConfig)}


def _config(cfg) -> tdpt.DPTConfig:
    return tdpt.DPTConfig(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in cfg.items() if k in FIELDS})


def _rel(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return np.abs(out - ref).max() / np.abs(ref).max()


@pytest.fixture(autouse=True)
def _fresh_cache():
    tinfer._DEPTH.clear()
    yield
    tinfer._DEPTH.clear()


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A small seeded DPT checkpoint, AdaIN's npz weights, one 48 x 64
    content PNG and a 40 x 40 style PNG."""
    d = tmp_path_factory.mktemp("dpt_scene")
    sd = _dpt.seeded_state_dict(SMALL, SEED, _adain.images(SEED + 1000, 1, H, W, "cpu"), 0.9)
    torch.save(sd, str(d / "dpt.pt"))
    adain_cfg = json.loads((ROOT / "portbench" / "configs" / "adain-vgg19.json").read_text())
    enc_w, dec_w = _adain.make_weights(adain_cfg, SEED, "cpu")
    (d / "weights").mkdir()
    _write_npz(d / "weights" / "vgg_normalised.npz", enc_w,
               [l for l in adain_cfg["encoder_unused"] if l[0] == "conv"])
    _write_npz(d / "weights" / "adain_decoder.npz", dec_w, [])
    _png(d / "content.png", _adain.images(SEED + 10, 1, H, W, "cpu"))
    _png(d / "style.png", _adain.images(SEED + 2, 1, 40, 40, "cpu"))
    return {"dir": d, "sd": sd, "ckpt": d / "dpt.pt", "adain_cfg": adain_cfg,
            "enc_w": enc_w, "dec_w": dec_w, "content": d / "content.png",
            "style": d / "style.png"}


@pytest.fixture
def small(scene, monkeypatch):
    """The program's DPT at the small sizes, AdaIN's weights from the
    scene's cache."""
    monkeypatch.setattr(tdpt, "DPT_LARGE", _config(SMALL))
    monkeypatch.setattr(tweights, "DEFAULT_WEIGHTS_DIR", scene["dir"] / "weights")
    monkeypatch.setattr(tdepth, "_REGISTERED", None)


def _call(scene, out_dir, **kw):
    return tinfer.adain_inference(str(scene["content"]), str(scene["style"]),
                                  content_size=WORK, style_size=WORK, save_ext=".png",
                                  output=str(out_dir), file_name="s", device="cpu", **kw)


def _pixels(path):
    with Image.open(path) as im:
        return np.asarray(im)


# --- the model ----------------------------------------------------------------

@pytest.mark.parametrize("hw", [(64, 96), (96, 64)])
def test_dpt_matches_the_plain_reference_at_a_small_size(scene, hw):
    """The seeded hub-layout checkpoint through ``get_dpt_params`` against
    the reference's forward of the same state dict, on a non-square grid
    each way."""
    net = tdpt.get_dpt_params(scene["ckpt"], "cpu", _config(SMALL))
    x = _adain.images(SEED + 5, 1, *hw, "cpu")
    with torch.no_grad():
        out = net(x)
        ref = ref_dpt.forward(scene["sd"], ((x - 0.5) / 0.5).permute(0, 3, 1, 2).contiguous(),
                              SMALL)
    assert out.shape == (1, *hw)
    assert _rel(out.numpy(), ref.numpy()) <= FWD_TOL
    assert not any(p.requires_grad for p in net.parameters())


def test_the_seeded_init_is_timms_and_passes_its_share_of_the_calibration_image():
    """``init_dpt_params``: the reference's forward of its state dict gives
    its forward; the same seed the same weights; timm's scales; and its
    output ReLU passes ``PASS_SHARE`` of the pixels of the calibration
    image, the generator's draw after the weights."""
    net = tdpt.init_dpt_params(torch.Generator().manual_seed(5), "cpu", _config(SMALL))
    sd = net.state_dict()
    gen = torch.Generator().manual_seed(5)
    drawn = tdpt.draw_dpt_params(gen, _config(SMALL))
    img = tdpt.calibration_image(gen)
    with torch.no_grad():
        out = net(img)
        ref = ref_dpt.forward(sd, ((img - 0.5) / 0.5).permute(0, 3, 1, 2).contiguous(), SMALL)
        pre = net(img, relu=False)
    assert _rel(out.numpy(), ref.numpy()) <= FWD_TOL
    last = "scratch.output_conv.4.bias"
    assert all(torch.equal(v, sd[k]) for k, v in drawn.state_dict().items() if k != last)
    assert pre.shape == (1, *tdpt.CALIBRATION_HW)
    assert abs(float((pre > 0).float().mean()) - tdpt.PASS_SHARE) < 1e-3
    vit = net.pretrained.model
    assert float(vit.cls_token.abs().max()) < 1e-5
    assert 0.015 < float(vit.pos_embed.std()) < 0.025
    assert 0.015 < float(vit.blocks[0].mlp.fc1.weight.std()) < 0.025
    assert float(vit.blocks[0].mlp.fc1.bias.abs().max()) == 0.0
    fan_in = 16 * 9     # output_conv.2: 16 -> 32 channels, 3 x 3
    assert float(net.scratch.output_conv[2].weight.abs().max()) <= fan_in ** -0.5
    assert all(not p.requires_grad for p in net.parameters())


def test_the_published_widths_are_the_hub_layout():
    """DPT-Large on the meta device: every key and shape of the hub's
    ``DPT_Large`` state dict (the reference's list), 344,055,465 numbers
    (1.38 GB in fp32), and a state dict that round-trips with
    ``strict=True``."""
    with torch.device("meta"):
        net = tdpt.DPT()
    got = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    want = ref_dpt.state_dict_shapes(LARGE)
    assert got == want
    assert sum(np.prod(s) for s in got.values()) == LARGE["parameters"] == 344_055_465
    with torch.device("meta"):
        other = tdpt.DPT(_config(LARGE))
    assert other.config == tdpt.DPT_LARGE
    result = other.load_state_dict(net.state_dict(), strict=True, assign=True)
    assert not result.missing_keys and not result.unexpected_keys
    assert [len(getattr(net.pretrained, f"act_postprocess{k}")) for k in range(1, 5)] == [
        5, 5, 4, 5]


def test_the_position_grid_resizes_to_a_non_square_grid():
    """The class token's position is kept; the 24 x 24 grid goes to 24 x 32
    (the cell's) and 5 x 7 as ``F.interpolate``'s bilinear
    (align_corners=False) of the grid; its own size is the identity."""
    pos = torch.randn(1, 1 + 24 * 24, 8, generator=torch.Generator().manual_seed(1))
    grid = pos[0, 1:].reshape(1, 24, 24, 8).permute(0, 3, 1, 2)
    for gh, gw in ((24, 32), (5, 7)):
        out = tdpt.resize_pos_embed(pos, gh, gw)
        assert out.shape == (1, 1 + gh * gw, 8)
        assert torch.equal(out[:, 0], pos[:, 0])
        want = F.interpolate(grid, size=(gh, gw), mode="bilinear", align_corners=False)
        assert torch.equal(out[0, 1:].reshape(gh, gw, 8), want[0].permute(1, 2, 0))
    assert torch.equal(tdpt.resize_pos_embed(pos, 24, 24), pos)


@pytest.mark.parametrize("hw, want", [((768, 1024), (384, 512)), ((1080, 1920), (384, 672)),
                                      ((384, 384), (384, 384)), ((500, 300), (384, 224)),
                                      ((200, 260), (288, 384)), ((10, 4000), (32, 384))])
def test_the_transform_size_is_the_hubs(hw, want):
    """``Resize(384, 384, keep_aspect_ratio=True, ensure_multiple_of=32,
    resize_method="minimal")``: the scale nearer 1, each side rounded half
    to even to a multiple of 32; the reference agrees."""
    assert tdpt.transform_size(*hw) == want
    assert ref_dpt.transform_size(*hw) == want


def test_the_roofline_count_is_a_hand_count_at_the_cells_shape():
    """384 x 512: a 24 x 32 grid, 769 tokens; every product counted by hand
    from the published widths."""
    t, g, c, m = 769, 768, 1024, 4096
    block = 2 * t * c * 3 * c + 2 * 2 * 16 * t * t * 64 + 2 * t * c * c + 2 * 2 * t * c * m
    encoder = 24 * block
    patch = 2 * g * c * 3 * 16 * 16
    readouts = 4 * 2 * g * 2 * c * c
    post = (2 * g * c * (256 + 512 + 1024 + 1024)             # the 1x1 convs
            + 2 * g * 256 * 256 * 16 + 2 * g * 512 * 512 * 4   # transposed, at input pixels
            + 2 * (12 * 16) * 1024 * 1024 * 9)                 # the 3x3/2 conv
    rn = 2 * 9 * 256 * (96 * 128 * 256 + 48 * 64 * 512 + 24 * 32 * 1024 + 12 * 16 * 1024)
    f3 = 2 * 256 * 256 * 9
    fusion = (f3 * (2 * 12 * 16 + 4 * 24 * 32 + 4 * 48 * 64 + 4 * 96 * 128)
              + 2 * 256 * 256 * (24 * 32 + 48 * 64 + 96 * 128 + 192 * 256))
    head = 2 * 9 * (192 * 256 * 256 * 128 + 384 * 512 * 128 * 32) + 2 * 384 * 512 * 32
    total = encoder + patch + readouts + post + rn + fusion + head
    assert dpt_work.flops(LARGE, 384, 512) == total
    assert abs(encoder / 1e9 - 522.59) < 0.01 and abs(total / 1e12 - 0.7028) < 1e-4
    assert abs(dpt_work.work(LARGE, 384, 512)["dpt_bound_s"] - total / 67e12) < 1e-12


# --- the depth-aware path -----------------------------------------------------

def _depth_pixels(path):
    with Image.open(path) as im:
        return np.asarray(im).astype(np.float64)


def test_the_dpt_call_matches_the_reference_pipeline(scene, small, tmp_path):
    """``adain_inference(use_depth=True, depth_model="dpt_large",
    save_depth=True)``: the depth PNG against the reference's normalised
    proximity, the stylized PNG against the reference's depth-blended
    AdaIN of the same content."""
    out = _call(scene, tmp_path, use_depth=True, depth_model="dpt_large",
                depth_weights=str(scene["ckpt"]), save_depth=True, depth_offset=0.15)
    depth_png = tmp_path / "s_depth.png"
    assert out == tmp_path / "s.png" and depth_png.is_file()

    u8 = ref_images.load_uint8(scene["content"])
    prox = ref_dpt.proximity(scene["sd"], torch.from_numpy(u8.copy()).float() / 255.0, SMALL)
    norm = ref_depth.normalised(prox)
    dep = _depth_pixels(depth_png)
    assert dep.shape == (H, W) and dep.min() == 0 and dep.max() == 65535
    assert np.abs(dep - 65535 * norm).max() <= DEPTH_LEVELS
    assert 0.3 < float((prox > 0).float().mean())

    style = ref_images.load_resized(scene["style"], WORK)
    s_mean, s_std = ref_adain.style_stats(scene["adain_cfg"], scene["enc_w"], style[None])
    content = ref_images.load_resized(scene["content"], WORK)
    want = ref_depth.stylize_depth(scene["adain_cfg"], scene["enc_w"], scene["dec_w"], content,
                                   s_mean, s_std, prox, 0.15, 20.0)
    got = _pixels(out).astype(np.int16)
    assert got.shape == want.shape
    assert np.abs(got - ref_adain.to_uint8(want).numpy()).mean() <= IMG_LEVELS


def test_depth_model_none_leaves_the_outputs_as_they_were(scene, small, tmp_path):
    """Without ``depth_model`` the call is the public steps it was: the
    classical proxy (or the registered estimator, or ``depth_fn``) into
    ``stylize_depth``, and ``stylize_simple`` without depth; bit for bit."""
    dev = "cpu"
    vgg = tweights.get_vgg_params(device=dev)
    dec = tweights.get_decoder_params(device=dev)
    content = tinfer._test_transform(str(scene["content"]), WORK, False, dev)[None]
    style = tinfer._test_transform(str(scene["style"]), WORK, False, dev)[None]
    full = torch.from_numpy(tinfer._to_array(str(scene["content"])))

    def expect(depth_map, name):
        img = tinfer.stylize_depth(vgg, dec, content, style, depth_map, offset=0.5,
                                   prominence=20.0, compute_dtype=torch.float32, device=dev)
        tinfer.save_image(img, tmp_path / name)
        return _pixels(tmp_path / name)

    proxy = _pixels(_call(scene, tmp_path / "a", use_depth=True))
    assert np.array_equal(proxy, expect(tdepth.estimate_proximity(full), "proxy.png"))
    ramp = torch.linspace(0, 1, H)[:, None].expand(H, W).contiguous()
    given = _pixels(_call(scene, tmp_path / "b", use_depth=True, depth_fn=lambda img: ramp))
    assert np.array_equal(given, expect(ramp, "ramp.png"))
    tdepth.register_depth_model(lambda img: 1.0 - ramp)
    try:
        registered = _pixels(_call(scene, tmp_path / "c", use_depth=True))
    finally:
        tdepth.register_depth_model(None)
    assert np.array_equal(registered, expect(1.0 - ramp, "registered.png"))
    plain = _pixels(_call(scene, tmp_path / "d", alpha=0.5))
    simple = tinfer.stylize_simple(vgg, dec, content, style, alpha=0.5,
                                   compute_dtype=torch.float32, device=dev)
    tinfer.save_image(simple, tmp_path / "simple.png")
    assert np.array_equal(plain, _pixels(tmp_path / "simple.png"))
    assert not list((tmp_path / "a").glob("*_depth.png"))


@pytest.mark.parametrize("weights", ["seeded", "checkpoint"])
def test_midas_small_on_the_switch_gives_what_use_midas_gives(scene, small, tmp_path, weights):
    """``depth_model="midas_small"`` against today's way to MiDaS-small:
    ``use_midas`` registers the estimator, then ``use_depth=True``; the same
    PNG, from the seeded init or a hub-layout checkpoint."""
    path = None
    if weights == "checkpoint":
        net = tmidas.init_midas_params(torch.Generator().manual_seed(11), "cpu")
        path = tmp_path / "midas_v21_small_256.pt"
        torch.save(net.state_dict(), str(path))
    switched = _pixels(_call(scene, tmp_path / "switch", use_depth=True,
                             depth_model="midas_small",
                             depth_weights=None if path is None else str(path)))
    tmidas.use_midas(path, device="cpu")
    try:
        registered = _pixels(_call(scene, tmp_path / "registered", use_depth=True))
    finally:
        tdepth.register_depth_model(None)
    assert np.array_equal(switched, registered)
    proxy = _pixels(_call(scene, tmp_path / "proxy", use_depth=True))
    assert not np.array_equal(switched, proxy)


def test_the_network_is_read_once_over_two_calls(scene, small, monkeypatch, tmp_path):
    """A second call with the same file reads nothing; a rewritten file
    (another mtime) is read again."""
    reads = []
    real = tweights._load_torch_state_dict
    monkeypatch.setattr(tweights, "_load_torch_state_dict",
                        lambda p: reads.append(p) or real(p))
    for k in range(2):
        _call(scene, tmp_path / str(k), use_depth=True, depth_model="dpt_large",
              depth_weights=str(scene["ckpt"]))
    assert len(reads) == 1
    first = tinfer.depth_network("dpt_large", str(scene["ckpt"]), "cpu")
    st = scene["ckpt"].stat()
    os.utime(scene["ckpt"], ns=(st.st_atime_ns, st.st_mtime_ns + 10 ** 9))
    again = tinfer.depth_network("dpt_large", str(scene["ckpt"]), "cpu")
    assert len(reads) == 2 and again is not first
    assert tinfer.depth_network("dpt_large", str(scene["ckpt"]), "cpu") is again
    assert tinfer.depth_network("dpt_large", None, "cpu") is tinfer.depth_network(
        "dpt_large", None, "cpu")


def test_the_depth_options_refuse_what_they_cannot_do(scene, small, tmp_path):
    stub = tmp_path / "dpt_large-midas-2f21e586.pt"
    stub.write_text("version https://git-lfs.github.com/spec/v1\noid sha256:0\nsize 1\n")
    with pytest.raises(ValueError, match="depth_model must be"):
        _call(scene, tmp_path, use_depth=True, depth_model="dpt_hybrid")
    with pytest.raises(ValueError, match="not both"):
        _call(scene, tmp_path, use_depth=True, depth_model="dpt_large", depth_fn=lambda x: x)
    for kw in ({"depth_model": "dpt_large"}, {"save_depth": True}):
        with pytest.raises(ValueError, match="need use_depth"):
            _call(scene, tmp_path, **kw)
    for path in (stub, tmp_path / "missing.pt"):
        for model in ("dpt_large", "midas_small"):
            with pytest.raises(FileNotFoundError, match="checkpoint"):
                _call(scene, tmp_path, use_depth=True, depth_model=model,
                      depth_weights=str(path))


def test_save_depth_writes_the_normalised_proximity_as_16_bit(scene, small, tmp_path):
    """The proxy's map too: 16-bit grey at the content's full size, min 0,
    max 65535, the normalised map rounded half up; a constant map zeros."""
    _call(scene, tmp_path, use_depth=True, save_depth=True)
    dep = _depth_pixels(tmp_path / "s_depth.png")
    full = torch.from_numpy(tinfer._to_array(str(scene["content"])))
    want = ref_depth.normalised(tdepth.estimate_proximity(full))
    assert dep.shape == (H, W) and dep.min() == 0 and dep.max() == 65535
    assert np.array_equal(dep, np.floor(want * 65535 + 0.5))
    tinfer.save_depth_png(torch.full((5, 7), 3.0), tmp_path / "flat.png")
    with Image.open(tmp_path / "flat.png") as im:
        assert im.mode.startswith("I") and not np.asarray(im).any()


def test_the_cli_flags_reach_the_pipeline(monkeypatch):
    calls = []
    monkeypatch.setattr(tinfer, "adain_inference", lambda **kw: calls.append(kw) or "out.jpg")
    base = ["--content", "c.png", "--style", "s.png", "--device", "cpu"]
    tcli.main(base)
    tcli.main(base + ["--use_depth", "--depth_model", "dpt_large", "--depth_weights", "d.pt",
                      "--save_depth"])
    assert [(c["use_depth"], c["depth_model"], c["depth_weights"], c["save_depth"])
            for c in calls] == [(False, None, None, False), (True, "dpt_large", "d.pt", True)]
    with pytest.raises(SystemExit):
        tcli.main(base + ["--depth_model", "dpt_hybrid"])


def test_the_call_records_its_spans_and_counters_under_a_profiler(scene, small, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    tinfer.depth_network("dpt_large", str(scene["ckpt"]), "cpu")
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        _call(scene, tmp_path, use_depth=True, depth_model="dpt_large",
              depth_weights=str(scene["ckpt"]))
        _call(scene, tmp_path, use_depth=True)
    stats = profiling.span_stats()
    profiling.reset_spans()
    for name in ("dpt.forward", "dpt.embed", "dpt.encoder", "dpt.reassemble", "dpt.fusion",
                 "dpt.head"):
        assert stats[name]["count"] == 1 and stats[name]["host_s"] > 0, name
    assert stats["adain.depth"]["count"] == 2
    assert "adain.depth_load" not in stats      # loaded before, and cached
    # 48 x 64 -> a 64 x 64 network input at the small net_size: 4 x 4 patches.
    assert stats["dpt.tokens"] == 1 + 4 * 4
    assert stats["depth.calls"] == 2 and stats["depth.network_calls"] == 1
