"""CPU tests of the depth cell (``depth.request.512.fp32``, driver
``request_depth``): whole runs through ``harness.run`` at a tiny size
(``cpu_run_depth.py``: hidden 64, 4 blocks, a 64 x 64 network input, AdaIN
at 32), a timed path broken underneath, DPT's counts against the
reference's own products, and on the card the controls at the cell's
size."""

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
CELL = "depth.request.512.fp32"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def _run(fault, *traces, tmp):
    """Result lines of runs of the cell on the CPU in a fresh process (the
    program reads ``AIP_TPU_WEIGHTS`` once, at import)."""
    proc = subprocess.run(
        [sys.executable, str(PB / "tests" / "cpu_run_depth.py"), str(ROOT), fault, *traces],
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
        assert set(r["checks"]) == {"mean_abs_levels", "depth_levels"}
    assert set(_metrics(CELL)) == {
        "dpt_device_ms.depth", "dpt_encoder_device_ms.depth", "dpt_roofline.depth",
        "adain_depth_host_ms.depth", "depth_network_share.depth", "depth_mfu.depth",
        "device_idle.depth"}
    # The CPU has no device time and no card: the host-side readings only.
    assert set(traced["metrics"]) == {"adain_depth_host_ms.depth", "depth_network_share.depth"}
    assert traced["metrics"]["adain_depth_host_ms.depth"]["value"] > 0
    assert traced["metrics"]["depth_network_share.depth"]["value"] == 100.0


@pytest.mark.parametrize("fault, check", [("nodepth", "mean_abs_levels"),
                                          ("skipblock", "depth_levels")])
def test_a_broken_timed_path_is_not_correct(tmp_path, fault, check):
    """The stylize step given a constant depth map, or the program's DPT
    with one block skipped: the run is not correct, by the check that sees
    it."""
    (r,) = _run(fault, "0", tmp=tmp_path)
    assert r["correct"] is False
    assert r["checks"][check]["value"] > r["checks"][check]["limit"], r["checks"]


def test_dpt_counts_are_the_reference_forwards_products(monkeypatch):
    """``roofline/dpt.py`` at two sizes against the products the plain
    forward runs (every Linear, conv, transposed conv and ``@``): 2 x
    multiply-adds, and 4 bytes each input, weight and output element (the
    biases left out)."""
    sys.path.insert(0, str(ROOT))
    import torch.nn.functional as F

    from portbench.drivers import _adain, _dpt
    from portbench.reference import dpt as ref
    from portbench.roofline import dpt as work

    cfg = {**json.loads((PB / "configs" / "dpt-large-midas.json").read_text()),
           "hidden_size": 64, "num_hidden_layers": 5, "num_attention_heads": 4,
           "intermediate_size": 128, "pos_grid": 6, "hooks": [0, 2, 3, 4],
           "reassemble_widths": [8, 16, 32, 32], "features": 16, "net_size": 64}
    sd = _dpt.seeded_state_dict(cfg, 3, _adain.images(4, 1, 64, 96, "cpu"), 0.9)
    seen = {"flops": 0, "bytes": 0}

    def counted(real, macs_of):
        def fn(x, w, *a, **kw):
            out = real(x, w, *a, **kw)
            seen["flops"] += 2 * macs_of(x, w, out)
            seen["bytes"] += 4 * (x.numel() + w.numel() + out.numel())
            return out
        return fn

    patches = {
        (F, "linear"): counted(F.linear, lambda x, w, o: o.numel() * w.shape[1]),
        (F, "conv2d"): counted(F.conv2d, lambda x, w, o: o.numel() * w[0].numel()),
        (F, "conv_transpose2d"): counted(F.conv_transpose2d,
                                         lambda x, w, o: x.numel() * w[0].numel()),
        (torch.Tensor, "__matmul__"): counted(torch.Tensor.__matmul__,
                                              lambda x, w, o: o.numel() * x.shape[-1]),
    }
    for h, w in ((64, 96), (96, 64)):
        seen.update(flops=0, bytes=0)
        for (mod, name), fn in patches.items():
            monkeypatch.setattr(mod, name, fn)
        with torch.no_grad():
            ref.forward(sd, torch.zeros(1, 3, h, w), cfg)
        monkeypatch.undo()
        assert work.flops(cfg, h, w) == seen["flops"], (h, w)
        assert work.nbytes(cfg, h, w) == seen["bytes"], (h, w)


@pytest.mark.cuda
def test_the_controls_fail_the_limits_on_the_card(card, tmp_path):
    """At the cell's own size (``calibrate.py``, one seed, in a process of
    its own): the program under both limits; TF32 in the program's place
    over one, and TF32 in DPT alone over the depth limit."""
    proc = subprocess.run(
        [sys.executable, str(PB / "calibrate.py"), "--workload", CELL, "--seeds",
         str(2 ** 31 + 5), "--units", "1", "--control", "1"],
        capture_output=True, text=True, timeout=900, cwd=str(ROOT),
        env={**os.environ, "TMPDIR": str(tmp_path)})
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.splitlines()[-1])
    limits = json.loads((PB / "workloads" / f"{CELL}.json").read_text())["limits"]
    assert all(line["program"][k] <= v for k, v in limits.items()), line
    assert any(line["control"][k] > v for k, v in limits.items()), line
    assert line["control"]["dpt_tf32.depth_levels"] > limits["depth_levels"], line
    assert all(math.isfinite(v) for k, v in line["control"].items() if k.endswith("levels"))
