"""CPU runs of the cells that read the program's own spans and counters:
each traced run reports the host-side ones and leaves the device ones out,
since the CPU has no device time. One process a run, since the program's
totals last the process."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

PB = Path(__file__).resolve().parents[1]
ROOT = PB.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
READERS = {"program_span", "program_ratio"}


def _program_metrics(cell):
    """{metric: reads device time} of the cell's metrics that read the
    program's totals."""
    out = {}
    for m in BENCH["per_layer"]:
        if cell not in m.get("workloads", [cell]):
            continue
        spec = json.loads((PB / "metrics" / f"{m['name']}.json").read_text())
        if spec["reader"] in READERS:
            out[m["name"]] = spec["params"].get("field") == "device"
    return out


@pytest.mark.parametrize("cell", ["adain.request.fp32-512", "gs.render.1088x1920",
                                  "adain.serve.b32-512.bf16"])
def test_a_traced_cpu_run_reports_the_host_side_program_metrics(tmp_path, cell):
    proc = subprocess.run(
        [sys.executable, str(PB / "tests" / "cpu_run.py"), str(ROOT), "none", f"{cell}:1"],
        capture_output=True, text=True, timeout=600, cwd=str(ROOT),
        env={**__import__("os").environ, "TMPDIR": str(tmp_path)})
    assert proc.returncode == 0, proc.stderr[-4000:]
    (result,) = [json.loads(l) for l in proc.stdout.splitlines()
                 if l.startswith("{") and '"correct"' in l]
    assert result["correct"] is True
    wanted = _program_metrics(cell)
    assert wanted
    for name, device in wanted.items():
        if device:
            assert name not in result["metrics"], name
        else:
            value = result["metrics"][name]["value"]
            assert value > 0, (name, value)
    if cell == "adain.request.fp32-512":
        share = result["metrics"]["adain_weights_used_share.request"]["value"]
        assert 20.0 < share < 40.0, share
