"""The benchmark's core: one run of one cell.

``run`` reads ``BENCHMARK.json`` and the cell's files by name, builds the
cell's driver, warms it up (set-up), drives it in a closed loop for the
window, optionally traces a further segment with ``torch.profiler``, then
checks what the window produced against the plain reference and returns
the result line. Nothing here knows a cell, a configuration or a metric by
name: each comes from its own file.

* ``workloads/<cell>.json``: ``config``, ``driver``, ``precision``,
  ``control``, ``params`` (the traffic) and ``why``;
* ``configs/<config>.json``: the configuration's sizes;
* ``drivers/<driver>.py``: ``build(ctx)`` returns the cell's driver object
  (see ``drivers/__init__.py`` for what it offers);
* ``metrics/<metric>.json``: ``reader`` (a module of ``readers/``) and its
  ``params``.
"""

from __future__ import annotations

import importlib
import json
import math
import os
import sys
import time
import traceback
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "aip_tpu")
TRACE_PRE_SECONDS = 10.0


def process_age_s() -> float:
    """Seconds since this process started, from the kernel's own clock
    (``/proc/self/stat`` field 22 against ``/proc/uptime``)."""
    ticks = os.sysconf("SC_CLK_TCK")
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    started = int(fields[19]) / ticks
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return max(uptime - started, 0.0)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({name for name in list(sys.modules) if name.split(".")[0] in FORBIDDEN})


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(root: Path, workload: str) -> dict:
    """The cell's entry of ``BENCHMARK.json`` with its files read: the
    workload file, its configuration file, and the metrics it reports."""
    bench = load_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise SystemExit(f"unknown workload {workload!r}")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    wl = load_json(HERE / "workloads" / f"{workload}.json")

    def reports(metric):
        return workload in metric.get("workloads", [workload])

    return {
        "name": workload,
        "entry": entry,
        "workload": wl,
        "config": load_json(root / cfg_entry["file"]),
        "end_to_end": [m for m in bench["end_to_end"] if reports(m)],
        "per_layer": [m for m in bench["per_layer"] if reports(m)],
    }


def load_driver(name: str):
    return importlib.import_module(f"portbench.drivers.{name}")


def load_reader(name: str):
    return importlib.import_module(f"portbench.readers.{name}")


def card_info(torch) -> dict:
    """The card's name, clocks and power limit (nvidia-smi, where it runs)."""
    import subprocess

    info = {"kind": torch.cuda.get_device_name(0)}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=20, check=True)
        info["nvidia_smi"] = out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError) as exc:
        info["nvidia_smi"] = f"not read: {exc}"
    return info


class Context:
    """What a driver is built from: the seed, the device, the cell's files,
    the checkout's root and a scratch directory under ``TMPDIR``."""

    def __init__(self, spec: dict, seed: int, device, root: Path, scale: dict | None = None):
        self.seed = int(seed)
        self.device = device
        self.root = root
        self.name = spec["name"]
        self.workload = spec["workload"]
        scale = dict(scale or {})
        self.config = {**spec["config"], **scale.pop("config", {})}
        self.params = {**spec["workload"]["params"], **scale}
        self.precision = spec["workload"]["precision"]
        tmp = Path(os.environ.get("TMPDIR", "/tmp"))
        self.scratch = tmp / "portbench" / spec["name"]


def _closed_loop(drv, seconds: float, sync, min_units: int = 1):
    """Run ``drv.unit()`` back to back until ``seconds`` have passed (at
    least ``min_units`` times). Returns (window seconds, per-unit records,
    failures)."""
    records, failed = [], 0
    t0 = time.perf_counter()
    while True:
        t_start = time.perf_counter()
        try:
            info = drv.unit()
            sync()
            records.append({"t0": t_start - t0, "s": time.perf_counter() - t_start, **(info or {})})
        except Exception:   # a failed unit is counted, and the loop goes on
            traceback.print_exc(file=sys.stderr)
            failed += 1
            if failed > 3 and not records:
                raise
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds and len(records) + failed >= min_units:
            return elapsed, records, failed


def run(root: Path, workload: str, seed: int, seconds: float, trace: bool,
        device=None, scale: dict | None = None) -> dict:
    """One run of one cell. ``device=None`` is the card, and the run
    refuses to go on without one; a test passes ``"cpu"`` and a ``scale``
    that shrinks the traffic's sizes."""
    import torch

    spec = cell_spec(root, workload)
    chips = int(spec["entry"]["chips"])
    on_card = device is None
    if on_card:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise SystemExit(f"{workload} needs {chips} CUDA device(s); "
                             f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = torch.device("cuda", 0)
        torch.cuda.reset_peak_memory_stats()
    device = torch.device(device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    ctx = Context(spec, seed, device, root, scale)
    drv = load_driver(spec["workload"]["driver"]).build(ctx)
    drv.warm()
    sync()
    setup_s = process_age_s()

    notes = {"workload": workload, "seed": ctx.seed, "setup_s": setup_s}
    if on_card:
        notes["card"] = card_info(torch)
    from portbench.roofline import peaks
    notes["peaks"] = peaks.PUBLISHED

    def peak_bytes():
        return int(torch.cuda.max_memory_allocated()) if on_card else 0

    result = {"correct": False, "attempted": 0, "failed": 0, "metrics": {}}
    if not trace:
        window_s, records, failed = _closed_loop(drv, seconds, sync)
        peak = peak_bytes()
        values = drv.end_to_end(records, window_s)
        values["setup_s"] = setup_s
        for m in spec["end_to_end"]:
            if m["name"] in values:
                result["metrics"][m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
        notes.update(drv.notes(records, window_s))
        trace_info = None
    else:
        pre_s = min(float(seconds), TRACE_PRE_SECONDS)
        window_s, records, failed = _closed_loop(drv, pre_s, sync, min_units=2)
        from portbench import trace as trace_mod
        summary = trace_mod.traced(drv, int(ctx.params.get("trace_units", 5)), sync,
                                   on_card=on_card)
        failed += summary.failed
        # Read before work(), whose count of live pairs runs the reference.
        peak = peak_bytes()
        rctx = {"trace": summary,
                "unit_s": window_s / max(len(records), 1), "work": drv.work(),
                "port_kernels": trace_mod.port_kernel_names(), "on_card": on_card}
        for m in spec["per_layer"]:
            mfile = load_json(HERE / "metrics" / f"{m['name']}.json")
            value = load_reader(mfile["reader"]).read(mfile.get("params", {}), rctx)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        notes.update(drv.notes(records, window_s))
        notes["traced_units"] = summary.units
        trace_info = summary

    result["attempted"] = len(records) + failed + (trace_info.units if trace_info else 0)
    result["failed"] = failed
    dev_info = {"platform": "gpu" if on_card else "cpu",
                "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                "count": chips if on_card else 0,
                "memory_peak_bytes": peak}
    if trace_info is not None:
        dev_info["busy_s"] = trace_info.busy_s
        dev_info["window_s"] = trace_info.window_s
        result["breakdown"] = trace_info.breakdown()
    result["device"] = dev_info

    found = forbidden_modules()
    if found:
        raise SystemExit(f"forbidden modules loaded: {found}")

    drv.release()
    if on_card:
        torch.cuda.empty_cache()
    checks = drv.check()
    if hasattr(drv, "close"):
        drv.close()
    notes["checks"] = checks
    ok = failed == 0 and bool(checks) and all(
        c["value"] is not None and math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
    result["correct"] = ok
    result["notes"] = notes
    result["checks"] = checks
    return result


def print_result(result: dict) -> None:
    """The earlier line of notes, the checks on standard error, then the
    result as the last line of standard output."""
    notes = result.pop("notes", {})
    checks = result.pop("checks", {})
    print(json.dumps({"notes": notes}, default=str), flush=True)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    result["checks"] = checks
    print(json.dumps(result), flush=True)

