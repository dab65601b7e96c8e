"""CPU tests of the localized cell (``localized.1920x1080.fp32``, driver
``request_localized``): whole runs through ``harness.run`` at a tiny size
(``cpu_run_localized.py``: blocks 1-1-2-1 at 48 x 64, AdaIN at 32), a timed
path broken underneath, DeepLab's counts against the reference's own
convs, and on the card the controls at the cell's size."""

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
CELL = "localized.1920x1080.fp32"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def _run(fault, *traces, tmp):
    """Result lines of runs of the cell on the CPU in a fresh process (the
    program reads ``AIP_TPU_WEIGHTS`` once, at import)."""
    proc = subprocess.run(
        [sys.executable, str(PB / "tests" / "cpu_run_localized.py"), str(ROOT), fault, *traces],
        capture_output=True, text=True, timeout=600, cwd=str(ROOT),
        env={**os.environ, "TMPDIR": str(tmp)})
    assert proc.returncode == 0, proc.stderr[-4000:]
    return [json.loads(l) for l in proc.stdout.splitlines()
            if l.startswith("{") and '"correct"' in l]


def _metrics(cell):
    return {m["name"]: m for m in BENCH["per_layer"] if cell in m.get("workloads", [cell])}


def test_a_clean_run_is_correct_and_a_traced_run_reports_the_host_side_metrics(tmp_path):
    plain, traced = _run("none", "0", "1", tmp=tmp_path)
    assert plain["correct"] is True and traced["correct"] is True, (plain, traced)
    assert set(plain["metrics"]) == {"request_p90_ms", "setup_s"}
    for r in (plain, traced):
        assert set(r["checks"]) == {"mean_abs_levels", "mask_flips_outside_band"}
        assert r["checks"]["mask_flips_outside_band"]["value"] == 0
    assert set(_metrics(CELL)) == {
        "deeplab_device_ms.localized", "deeplab_roofline.localized", "localized_mfu.localized",
        "localized_harmonize_host_ms.localized", "localized_background_share.localized",
        "device_idle.localized"}
    # The CPU has no device time and no card: the host-side readings only.
    assert set(traced["metrics"]) == {"localized_harmonize_host_ms.localized",
                                      "localized_background_share.localized"}
    assert traced["metrics"]["localized_harmonize_host_ms.localized"]["value"] > 0
    assert 20.0 < traced["metrics"]["localized_background_share.localized"]["value"] < 80.0


@pytest.mark.parametrize("fault, check", [("mask", "mask_flips_outside_band"),
                                          ("alter", "mean_abs_levels")])
def test_a_broken_timed_path_is_not_correct(tmp_path, fault, check):
    """A mask block flipped where the segmenter decides it, or the
    composite altered before its save: the run is not correct, by the
    check that sees it."""
    (r,) = _run(fault, "0", tmp=tmp_path)
    assert r["correct"] is False
    assert r["checks"][check]["value"] > r["checks"][check]["limit"], r["checks"]


def test_deeplab_counts_are_the_reference_forwards_convs(monkeypatch):
    """``roofline/deeplab.py`` at two sizes against the convs the plain
    forward runs: 2 x multiply-adds, and 4 bytes each input, weight and
    output element (the classifier's bias left out), over a 2-2-3-2 net."""
    sys.path.insert(0, str(ROOT))
    import torch.nn.functional as F

    from portbench.drivers import _adain, _deeplab
    from portbench.reference import deeplab as ref
    from portbench.roofline import deeplab as work

    cfg = {**json.loads((PB / "configs" / "deeplabv3-resnet101.json").read_text()),
           "blocks": [2, 2, 3, 2]}
    sd = _deeplab.seeded_state_dict(cfg, 3, _adain.images(4, 1, 33, 47, "cpu"), 0.6, 0.25)
    real = F.conv2d
    for h, w in ((33, 47), (40, 24)):
        seen = {"flops": 0, "bytes": 0}

        def conv2d(x, wt, *a, **kw):
            out = real(x, wt, *a, **kw)
            seen["flops"] += 2 * out.numel() * wt[0].numel()
            seen["bytes"] += 4 * (x.numel() + wt.numel() + out.numel())
            return out

        monkeypatch.setattr(F, "conv2d", conv2d)
        with torch.no_grad():
            ref.forward(sd, torch.zeros(1, 3, h, w))
        monkeypatch.setattr(F, "conv2d", real)
        assert work.flops(cfg, h, w) == seen["flops"]
        assert work.nbytes(cfg, h, w) == seen["bytes"]
    full = json.loads((PB / "configs" / "deeplabv3-resnet101.json").read_text())
    assert abs(work.flops(full, 1080, 1920) / 1e12 - 3.815) < 0.001


@pytest.mark.cuda
def test_the_controls_fail_the_limits_on_the_card(card, tmp_path):
    """At the cell's own size (``calibrate.py``, one seed, in a process of
    its own): the program under both limits; TF32 in the program's place
    over one, and TF32 in DeepLab alone over the flip count."""
    proc = subprocess.run(
        [sys.executable, str(PB / "calibrate.py"), "--workload", CELL, "--seeds",
         str(2 ** 31 + 3), "--units", "1", "--control", "1"],
        capture_output=True, text=True, timeout=900, cwd=str(ROOT),
        env={**os.environ, "TMPDIR": str(tmp_path)})
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.splitlines()[-1])
    limits = json.loads((PB / "workloads" / f"{CELL}.json").read_text())["limits"]
    assert all(line["program"][k] <= v for k, v in limits.items()), line
    assert any(line["control"][k] > v for k, v in limits.items()), line
    assert line["control"]["deeplab_tf32.mask_flips_outside_band"] > 0, line
    assert all(math.isfinite(v) for v in line["control"].values())
