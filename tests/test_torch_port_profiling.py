"""The port's spans and counters (``aip_tpu_torch.utils.profiling``): nothing
recorded outside a profiler; under one, host and self times, counts, the
profiler's own events, counters; the spans of ``adain_inference`` and of
the serving frame. The file imports no JAX; the card case is marked
``cuda`` and skips without one."""

import time

import numpy as np
import pytest
import torch
from PIL import Image
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from aip_tpu_torch.utils import profiling as P


@pytest.fixture(autouse=True)
def _fresh_totals():
    P.reset_spans()
    yield
    P.reset_spans()


def _events(prof, name):
    return [e for e in prof.events() if e.name == name]


def test_a_span_outside_a_profiler_records_nothing(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a span outside a profiler reached the profiler or the clock")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(time, "perf_counter_ns", refuse)
    with P.span("t.outer") as s:
        with P.span("t.inner", device=True):
            torch.ones(4).sum()
    assert s is None
    P.count("t.counter", 3)
    assert P.span_stats() == {}


def test_nested_spans_give_host_self_time_and_count():
    with profile(activities=[ProfilerActivity.CPU]):
        with P.span("t.outer"):
            time.sleep(0.02)
            for _ in range(2):
                with P.span("t.inner"):
                    time.sleep(0.03)
    stats = P.span_stats()
    outer, inner = stats["t.outer"], stats["t.inner"]
    assert outer["count"] == 1 and inner["count"] == 2
    assert inner["host_s"] >= 0.06 and outer["host_s"] >= 0.08
    assert inner["self_host_s"] == inner["host_s"]
    assert abs(outer["self_host_s"] - (outer["host_s"] - inner["host_s"])) < 1e-9
    assert 0.02 <= outer["self_host_s"] < outer["host_s"]
    assert outer["device_s"] is None and inner["device_s"] is None


def test_each_span_is_a_profiler_event_of_its_duration():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with P.span("t.a"):
            time.sleep(0.01)
            with P.span("t.b"):
                torch.randn(256, 256) @ torch.randn(256, 256)
                time.sleep(0.01)
    stats = P.span_stats()
    for name in ("t.a", "t.b"):
        (event,) = _events(prof, name)
        ours_us = stats[name]["host_s"] * 1e6
        theirs_us = event.time_range.end - event.time_range.start
        assert abs(theirs_us - ours_us) <= 50 + 0.05 * ours_us, (name, theirs_us, ours_us)
    assert _events(prof, "t.b")[0].cpu_parent.name == "t.a"


def test_counters_add_up_under_a_profiler():
    with profile(activities=[ProfilerActivity.CPU]):
        P.count("t.bytes", 2)
        P.count("t.bytes", 5)
        P.count("t.other", 1)
    P.count("t.bytes", 100)      # the profiler has stopped
    stats = P.span_stats()
    assert stats["t.bytes"] == 7 and stats["t.other"] == 1


def test_a_timed_span_reads_its_own_time_outside_a_profiler():
    with P.span("t.timed", timed=True) as s:
        time.sleep(0.01)
    assert s.ms() >= 10.0
    assert P.span_stats() == {}


def _parent(prof, name):
    (event,) = _events(prof, name)
    return event.cpu_parent.name if event.cpu_parent is not None else None


def test_adain_inference_spans_and_weight_counters(tmp_path, monkeypatch):
    from aip_tpu_torch.models import weights
    from aip_tpu_torch.models.decoder import init_decoder_params
    from aip_tpu_torch.models.vgg import init_vgg_params
    from aip_tpu_torch.pipelines.adain_infer import adain_inference

    wdir = tmp_path / "w"
    weights.save_params_npz(weights.hwio_params(init_vgg_params(0, "cpu")),
                            wdir / "vgg_normalised.npz")
    weights.save_params_npz(weights.hwio_params(init_decoder_params(1, "cpu")),
                            wdir / "adain_decoder.npz")
    monkeypatch.setattr(weights, "DEFAULT_WEIGHTS_DIR", wdir)
    rng = np.random.default_rng(0)
    for name, hw in (("c.png", (40, 48)), ("s.png", (32, 32))):
        Image.fromarray(rng.integers(0, 256, hw + (3,), dtype=np.uint8)).save(tmp_path / name)

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        adain_inference(tmp_path / "c.png", tmp_path / "s.png", content_size=32, style_size=32,
                        save_ext=".png", output=str(tmp_path / "out"), device="cpu")
    stats = P.span_stats()
    counts = {name: stats[name]["count"] for name in
              ("adain.request", "adain.weights", "adain.load", "adain.stylize",
               "adain.encode", "adain.decode", "adain.save", "adain.fetch")}
    assert counts == {"adain.request": 1, "adain.weights": 1, "adain.load": 1,
                      "adain.stylize": 1, "adain.encode": 2, "adain.decode": 1,
                      "adain.save": 1, "adain.fetch": 1}     # encodes: content, style
    assert _parent(prof, "adain.request") is None
    for child in ("adain.weights", "adain.load", "adain.stylize", "adain.save"):
        assert _parent(prof, child) == "adain.request"
    assert {e.cpu_parent.name for e in _events(prof, "adain.encode")} == {"adain.stylize"}
    assert _parent(prof, "adain.decode") == "adain.stylize"
    assert _parent(prof, "adain.fetch") == "adain.save"
    assert stats["adain.encode"]["device_s"] is None        # no card

    # Only the convs that run are read: the encoder's first 10 (to
    # relu4_1) and the whole decoder.
    used = 0
    for name, n_used in (("vgg_normalised", 10), ("adain_decoder", None)):
        with np.load(wdir / f"{name}.npz") as data:
            arrays = {k: data[k] for k in data.files}
        n = len(arrays) // 2 if n_used is None else n_used
        used += sum(arrays[f"{k}{i}"].nbytes for i in range(n) for k in "wb")
    assert stats["weights.bytes_read"] == stats["weights.bytes_used"] == used


def test_render_frame_spans_sit_under_gs_frame():
    from aip_tpu_torch.gs import gaussians as G
    from aip_tpu_torch.gs import render as R
    from aip_tpu_torch.gs.cameras import Camera

    gen = torch.Generator().manual_seed(0)
    pts = torch.rand((256, 3), generator=gen) * 2.0 - 1.0
    state, _ = G.create_from_pcd(pts, torch.rand((256, 3), generator=gen), capacity=256)
    sh = torch.randn((256, 16, 3), generator=gen) * 0.2
    cam = Camera(colmap_id=0, R=np.eye(3), T=np.array([0.0, 0.0, 4.0]), FoVx=0.9, FoVy=0.7,
                 image=np.zeros((48, 64, 3), np.float32), image_name="c", uid=0)
    fn = R.make_inference_frame_fn(state, None, R.make_settings(cam), torch.zeros(3),
                                   sh_override=sh)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        img = R.render_frame(fn, cam)
    assert img.shape == (48, 64, 3)
    stats = P.span_stats()
    assert stats["gs.frame"]["count"] == 1
    assert _parent(prof, "gs.frame") is None
    for child in ("gs.field", "gs.project", "gs.select", "gs.composite"):
        assert {e.cpu_parent.name for e in _events(prof, child)} == {"gs.frame"}, child
    assert stats["gs.frame"]["self_host_s"] < stats["gs.frame"]["host_s"]


@pytest.mark.cuda
def test_device_time_of_a_span_matches_the_profilers_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.randn((4096, 4096), device="cuda")
    for _ in range(3):
        x @ x
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with P.span("t.matmul", device=x):
            for _ in range(20):
                y = x @ x
        torch.cuda.synchronize()
    ours_s = P.span_stats()["t.matmul"]["device_s"]

    def kernels_s(e):
        return sum(k.duration for k in e.kernels) / 1e6 + sum(kernels_s(c)
                                                            for c in e.cpu_children)

    (event,) = [e for e in _events(prof, "t.matmul") if e.device_type == DeviceType.CPU]
    theirs_s = kernels_s(event)
    assert y.shape == x.shape and theirs_s > 0
    assert abs(ours_s - theirs_s) <= 0.1 * theirs_s, (ours_s, theirs_s)
