"""CPU tests of the SwinV2 depth cell (``depth.request.swin2l-384.fp32``,
driver ``request_depth_swin2``): whole runs through ``harness.run`` at a
tiny size (``cpu_run_depth_swin2.py``: width 16, window 8, a 64 x 64
network input, AdaIN at 32), a timed path broken underneath, the
roofline's counts against the reference's own products and a hand count,
and on the card the controls at the cell's size."""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

PB = Path(__file__).resolve().parents[1]
ROOT = PB.parent
CELL = "depth.request.swin2l-384.fp32"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CONFIG = json.loads((PB / "configs" / "dpt-swin2-large-384-midas.json").read_text())
TINY = {**CONFIG, "embed_dim": 16, "depths": [2, 2, 2, 2], "num_heads": [2, 2, 4, 4],
        "window_size": 8, "pretrained_window_sizes": [4, 4, 4, 2], "cpb_hidden": 32,
        "hooks": [1, 1, 1, 1], "features": 32, "head_features": 8, "num_classes": 10,
        "net_size": 64}


def _run(fault, *traces, tmp):
    """Result lines of runs of the cell on the CPU in a fresh process (the
    program reads ``AIP_TPU_WEIGHTS`` once, at import)."""
    proc = subprocess.run(
        [sys.executable, str(PB / "tests" / "cpu_run_depth_swin2.py"), str(ROOT), fault,
         *traces], capture_output=True, text=True, timeout=600, cwd=str(ROOT),
        env={**os.environ, "TMPDIR": str(tmp)})
    assert proc.returncode == 0, proc.stderr[-4000:]
    return [json.loads(l) for l in proc.stdout.splitlines()
            if l.startswith("{") and '"correct"' in l]


def test_a_clean_run_is_correct_and_names_its_metrics(tmp_path):
    plain, traced = _run("none", "0", "1", tmp=tmp_path)
    assert plain["correct"] is True and traced["correct"] is True, (plain, traced)
    assert set(plain["metrics"]) == {"request_p90_ms", "setup_s"}
    for r in (plain, traced):
        assert set(r["checks"]) == {"mean_abs_levels", "depth_levels"}
    assert {m["name"] for m in BENCH["per_layer"] if CELL in m.get("workloads", [CELL])} == {
        "dpt_device_ms.depth_swin2l", "swin2_encoder_device_ms.depth_swin2l",
        "swin2_windowed_device_ms.depth_swin2l", "dpt_roofline.depth_swin2l",
        "depth_mfu.depth_swin2l", "device_idle.depth_swin2l"}
    # Every one of them is a card's reading: the CPU reports none.
    assert traced["metrics"] == {}


@pytest.mark.parametrize("fault, check", [("nodepth", "mean_abs_levels"),
                                          ("skipblock", "depth_levels")])
def test_a_broken_timed_path_is_not_correct(tmp_path, fault, check):
    """The stylize step given a constant depth map, or the program's
    network with one block skipped: the run is not correct, by the check
    that sees it."""
    (r,) = _run(fault, "0", tmp=tmp_path)
    assert r["correct"] is False
    assert r["checks"][check]["value"] > r["checks"][check]["limit"], r["checks"]


def test_the_counts_are_the_reference_forwards_products(monkeypatch):
    """``roofline/dpt_swin2.py`` against the products the plain forward
    runs on tokens and maps (every Linear, conv and ``@``; the position
    bias's MLP over its coordinate table, which depends on no input, left
    out): 2 x multiply-adds, and 4 bytes each input, weight and output
    element (the biases left out); the score passes are the rest of the
    bytes."""
    sys.path.insert(0, str(ROOT))
    import torch.nn.functional as F

    from portbench.drivers import _adain, _dpt_swin2
    from portbench.reference import dpt_swin2 as ref
    from portbench.roofline import dpt_swin2 as work

    sd = _dpt_swin2.seeded_state_dict(TINY, 3, _adain.images(4, 1, 48, 64, "cpu"), 0.9)
    seen = {"flops": 0, "bytes": 0}
    linear = F.linear

    def counted(real, macs_of):
        def fn(x, w, *a, **kw):
            out = real(x, w, *a, **kw)
            if x.dim() != 4 or real is not linear:      # not the coordinate table's MLP
                seen["flops"] += 2 * macs_of(x, w, out)
                seen["bytes"] += 4 * (x.numel() + w.numel() + out.numel())
            return out
        return fn

    patches = {
        (F, "linear"): counted(F.linear, lambda x, w, o: o.numel() * w.shape[1]),
        (F, "conv2d"): counted(F.conv2d, lambda x, w, o: o.numel() * w[0].numel()),
        (torch.Tensor, "__matmul__"): counted(torch.Tensor.__matmul__,
                                              lambda x, w, o: o.numel() * x.shape[-1]),
    }
    for (mod, name), fn in patches.items():
        monkeypatch.setattr(mod, name, fn)
    with torch.no_grad():
        ref.forward(sd, torch.zeros(1, 3, 64, 64), TINY)
    monkeypatch.undo()
    ops = work.ops(TINY)
    assert work.flops(TINY) == seen["flops"]
    assert sum(4 * (i + o) for _n, m, i, o in ops if m) == seen["bytes"]
    # The passes over the scores: scale, bias, softmax a block, the mask in
    # the one shifted block (stage 1's second: grids 16, 8, 4, 2, window 8).
    passes = [n for n, m, _i, _o in ops if not m]
    assert len(passes) == 3 * 8 + 1 and "s0.b1.mask" in passes


def test_the_count_is_a_hand_count_at_the_cells_shape():
    """384 x 384: stage grids 96, 48, 24, 12 of widths 192-1536, windows of
    576 tokens (144 in stage 4), heads of width 32; every product counted
    by hand from the published widths, 0.3425 TFLOP and a 5.11 ms bound at
    67 TFLOP/s; stage 1's scores 16 x 6 x 576^2 a block."""
    sys.path.insert(0, str(ROOT))
    from portbench.roofline import dpt_swin2 as work

    def block(t, c, windows, n):
        return (2 * t * c * 3 * c + 2 * 2 * windows * (c // 32) * n * n * 32
                + 2 * t * c * c + 2 * 2 * t * c * 4 * c)

    stages = ((96 ** 2, 192, 16, 576, 2), (48 ** 2, 384, 4, 576, 2),
              (24 ** 2, 768, 1, 576, 18), (12 ** 2, 1536, 1, 144, 2))
    encoder = 2 * 96 * 96 * 192 * 3 * 16
    encoder += sum(d * block(t, c, nw, n) for t, c, nw, n, d in stages)
    encoder += sum(2 * (t // 4) * 4 * c * 2 * c for t, c, _w, _n, _d in stages[:3])
    rn = 2 * 9 * 256 * (96 * 96 * 192 + 48 * 48 * 384 + 24 * 24 * 768 + 12 * 12 * 1536)
    f3 = 2 * 256 * 256 * 9
    fusion = (f3 * (2 * 12 * 12 + 4 * 24 * 24 + 4 * 48 * 48 + 4 * 96 * 96)
              + 2 * 256 * 256 * (24 * 24 + 48 * 48 + 96 * 96 + 192 * 192))
    head = 2 * 9 * (192 * 192 * 256 * 128 + 384 * 384 * 128 * 32) + 2 * 384 * 384 * 32
    total = encoder + rn + fusion + head
    assert work.flops(CONFIG) == total
    assert abs(total / 1e12 - 0.3425) < 1e-4 and abs(encoder / 1e9 - 230.77) < 0.01
    w = work.work(CONFIG)
    assert abs(w["dpt_swin2_bound_s"] - total / 67e12) < 1e-12
    assert abs(w["dpt_swin2_bound_s"] * 1e3 - 5.112) < 1e-3
    scores = {n: i for n, _m, i, _o in work.ops(CONFIG) if n == "s0.b0.softmax"}
    assert scores == {"s0.b0.softmax": 16 * 6 * 576 ** 2}


@pytest.mark.cuda
def test_the_controls_fail_the_limits_on_the_card(card, tmp_path):
    """At the cell's own size (``calibrate.py``, one seed, in a process of
    its own): the program under both limits, TF32 in the program's place
    over one."""
    proc = subprocess.run(
        [sys.executable, str(PB / "calibrate.py"), "--workload", CELL, "--seeds",
         str(2 ** 31 + 7), "--units", "1", "--control", "1"],
        capture_output=True, text=True, timeout=900, cwd=str(ROOT),
        env={**os.environ, "TMPDIR": str(tmp_path)})
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.splitlines()[-1])
    limits = json.loads((PB / "workloads" / f"{CELL}.json").read_text())["limits"]
    assert all(line["program"][k] <= v for k, v in limits.items()), line
    assert any(line["control"][k] > v for k, v in limits.items()), line
    assert all(math.isfinite(v) for k, v in line["control"].items() if k.endswith("levels"))
