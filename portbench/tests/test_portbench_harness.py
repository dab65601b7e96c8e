"""CPU tests of the benchmark's harness, names, counts and references.
Card tests are marked ``cuda`` and skip without one."""

from __future__ import annotations

import json
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

PB = Path(__file__).resolve().parents[1]
ROOT = PB.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}
FORBIDDEN = {"jax", "jaxlib", "flax", "aip_tpu"}


def _cpu_run(root, fault, *cells, tmp):
    """Result lines and loaded top-level modules of a CPU run in a fresh
    process (the program reads ``AIP_TPU_WEIGHTS`` once, at import)."""
    proc = subprocess.run(
        [sys.executable, str(PB / "tests" / "cpu_run.py"), str(root), fault, *cells],
        capture_output=True, text=True, timeout=600, cwd=str(root),
        env={**__import__("os").environ, "TMPDIR": str(tmp)})
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = [json.loads(l) for l in proc.stdout.splitlines() if l.startswith("{")]
    results = [l for l in lines if "correct" in l]
    return results, set(lines[-1]["modules"])


# --- BENCHMARK.json ----------------------------------------------------------

def test_names_units_and_keys_are_allowed():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        assert (ROOT / c["file"]).is_file()
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert (PB / "workloads" / f"{w['name']}.json").is_file()
        names.append(w["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert (PB / "metrics" / f"{m['name']}.json").is_file()
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for n in names:
        assert NAME.match(n), n
    assert len(names) == len(set(names))
    for text in [c["source"] for c in BENCH["configs"]] + [
            x.get("why", "") for x in BENCH["configs"] + BENCH["workloads"]] + [
            m.get("layer", "") for m in BENCH["per_layer"]] + BENCH["command"]:
        assert len(text) <= 200 and "\n" not in text and "\t" not in text
    assert {"setup_s"} <= {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


def test_every_file_under_paths_is_named_from_name_characters():
    for p in PB.rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


# --- the counts -------------------------------------------------------------

def test_conv_flops_against_hand_counts():
    from portbench.roofline import adain as W

    # 3x3 conv 4->5 on a padded 6x7 input: 6*7 outputs, 2*4*5*9 each.
    f, hw = W.conv_flops([["pad"], ["conv", 4, 5, 3]], 6, 7, batch=2)
    assert f == 2 * 6 * 7 * (2 * 4 * 5 * 9) and hw == (6, 7)
    # ceil-mode pool: 7 -> 4; up 2x: 4 -> 8.
    assert W.conv_flops([["pool"], ["up"]], 7, 7)[1] == (8, 8)
    # 1x1 conv 3->3, then pad and a 3x3 conv 3->64, on 8x8.
    f, _ = W.conv_flops([["conv", 3, 3, 1], ["pad"], ["conv", 3, 64, 3]], 8, 8)
    assert f == 2 * 64 * 9 + 2 * 64 * 27 * 64


def test_adain_flops_at_512_are_253_gflop():
    """VGG-19 to relu4_1 and the decoder at 512^2: the sum over convs of 2 x
    H_out x W_out x C_in x C_out x k^2 is 126.54 + 126.53 GFLOP."""
    from portbench.roofline import adain as W

    cfg = json.loads((PB / "configs" / "adain-vgg19.json").read_text())
    enc = W.encode_flops(cfg, 512, 512)
    total = W.stylize_flops(cfg, 512, 512)
    by_hand = 2 * (512 * 512 * (9 + 27 * 64 + 576 * 64) + 256 * 256 * (576 * 128 + 1152 * 128)
                   + 128 * 128 * (1152 * 256 + 3 * 2304 * 256) + 64 * 64 * 2304 * 512)
    assert enc == by_hand
    assert abs(enc / 1e9 - 126.538) < 0.001 and abs(total / 1e9 - 253.072) < 0.001
    assert W.stylize_flops(cfg, 512, 512, batch=32) == 32 * total


def test_head_and_tail_work_by_hand():
    from portbench.roofline import adain as W
    from portbench.roofline import peaks

    f, b = W.head_work(1, 4, 6, 2)
    assert f == 2 * 24 * (64 * 27 + 64 * 576)
    assert b == 24 * 3 * 2 + 2 * 3 * 64 * 2 + 4 * (9 + 3 + 27 * 64 + 64 + 576 * 64 + 64)
    f, b = W.tail_work(2, 3, 5, 4)
    assert f == 2 * 2 * 6 * 10 * (64 * 576 + 3 * 576)
    assert b == 2 * 15 * 64 * 4 + 2 * 60 * 3 * 4 + 4 * (576 * 64 + 64 + 576 * 3 + 3)
    assert peaks.bound_s(989e12, 1.0, peaks.BF16_FLOPS) == 1.0
    assert peaks.bound_s(1.0, 3.35e12, peaks.BF16_FLOPS) == 1.0


# --- the result line, the imports, the faults ---------------------------------

def test_result_line_has_the_contract_keys_and_no_jax(tmp_path):
    results, modules = _cpu_run(ROOT, "none", "adain.request.fp32-512",
                                "adain.request.fp32-512:1", "adain.serve.b32-512.bf16",
                                "adain.serve.b32-512.bf16:1", "gs.render.1088x1920",
                                "gs.render.1088x1920:1", tmp=tmp_path)
    assert len(results) == 6
    for r, trace in zip(results, (False, True) * 3):
        assert set(r) == RESULT_KEYS | ({"breakdown"} if trace else set())
        assert list(r)[-1] == "checks"
        assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
        assert r["device"]["platform"] == "cpu"
        for c in r["checks"].values():
            assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    assert "setup_s" in results[0]["metrics"] and "request_p90_ms" in results[0]["metrics"]
    assert set(results[0]["metrics"]) == {"request_p90_ms", "setup_s"}
    assert "images_per_s" in results[2]["metrics"]
    assert "frames_per_s" in results[4]["metrics"]
    assert not modules & FORBIDDEN, modules & FORBIDDEN
    assert "aip_tpu_torch" in modules


@pytest.mark.parametrize("fault, cells", [
    ("alter", ("adain.request.fp32-512", "adain.serve.b32-512.bf16", "gs.render.1088x1920")),
    # A request stylizes one image and a frame is one view: neither has a
    # batch to leave half of.
    ("half", ("adain.serve.b32-512.bf16",)),
])
def test_a_broken_timed_path_is_not_correct(tmp_path, fault, cells):
    results, _ = _cpu_run(ROOT, fault, *cells, tmp=tmp_path)
    assert len(results) == len(cells)
    for r in results:
        assert r["correct"] is False, r["checks"]


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import torch\n"
            "from portbench.reference import adain, images\n"
            "import portbench.reference as R, pkgutil, importlib\n"
            "for m in pkgutil.iter_modules(R.__path__): importlib.import_module('portbench.reference.' + m.name)\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))") % str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    loaded = set(json.loads(proc.stdout.strip().replace("'", '"')))
    assert not loaded & (FORBIDDEN | {"aip_tpu_torch"}), loaded


def test_a_cell_and_a_metric_added_as_files_alone(tmp_path):
    """A stub cell, its driver, a metric of a new reader and one of an
    existing reader, added as files to a copy: the harness finds them by
    name and reports the metric."""
    root = tmp_path / "checkout"
    shutil.copytree(PB, root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "stub-config", "source": "https://example.org/stub",
                             "file": "portbench/configs/stub-config.json", "reduced": [],
                             "why": "a stub"})
    bench["workloads"].append({"name": "stub.cell", "config": "stub-config", "traffic": "stub",
                               "chips": 1, "why": "a stub"})
    bench["end_to_end"].append({"name": "stub_per_s", "unit": "units/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["stub.cell"]})
    for name in ("stub_share.cell", "device_idle.stub"):
        bench["per_layer"].append({"name": name, "unit": "%", "better": "higher",
                                   "source": "host_clock", "layer": "stub",
                                   "moves": "stub_per_s", "workloads": ["stub.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    files = {
        "configs/stub-config.json": json.dumps({"name": "stub-config", "size": 3}),
        "workloads/stub.cell.json": json.dumps({
            "config": "stub-config", "driver": "stub_count", "precision": "fp32",
            "control": "tf32", "params": {"trace_units": 3}, "limits": {"off": 0.0}}),
        "metrics/stub_share.cell.json": json.dumps({"reader": "stub_work",
                                                    "params": {"key": "share"}}),
        "metrics/device_idle.stub.json": json.dumps({"reader": "device_idle", "params": {}}),
        "readers/stub_work.py": "def read(params, ctx):\n    return ctx['work'][params['key']]\n",
        "drivers/stub_count.py": (
            "class D:\n"
            "    def __init__(self, ctx): self.ctx, self.n = ctx, 0\n"
            "    def warm(self): pass\n"
            "    def unit(self):\n        self.n += 1\n        return {'k': self.ctx.config['size']}\n"
            "    def end_to_end(self, records, window_s):\n"
            "        return {'stub_per_s': len(records) / window_s}\n"
            "    def notes(self, records, window_s): return {'units': len(records)}\n"
            "    def work(self): return {'share': 42.0}\n"
            "    def release(self): pass\n"
            "    def check(self): return {'off': {'value': 0.0, 'limit': 0.0}}\n"
            "def build(ctx): return D(ctx)\n"),
    }
    for rel, text in files.items():
        (root / "portbench" / rel).write_text(text)
    results, modules = _cpu_run(root, "none", "stub.cell", "stub.cell:1", tmp=tmp_path)
    plain, traced = results
    assert plain["correct"] is True and set(plain["metrics"]) == {"stub_per_s", "setup_s"}
    assert traced["metrics"] == {"stub_share.cell": {"value": 42.0, "unit": "%"}}
    assert "aip_tpu_torch" not in modules


# --- the controls --------------------------------------------------------------

def _serve_driver(device, seed, **scale):
    sys.path.insert(0, str(ROOT))
    from portbench import harness

    spec = harness.cell_spec(ROOT, "adain.serve.b32-512.bf16")
    ctx = harness.Context(spec, seed, device, ROOT, scale)
    return harness.load_driver("serve_batch").build(ctx), spec


def test_serve_control_fails_its_limit_on_the_cpu():
    """The fp8 reference in the program's place reads above the limit,
    and the program's bf16 call under it, at 4 x 64^2."""
    drv, spec = _serve_driver(torch.device("cpu"), 2 ** 31 + 5, batch=4, size=64,
                              batches=1, keep=1)
    drv.warm()
    drv.unit()
    limit = spec["workload"]["limits"]["err_vs_bf16"]
    assert drv.control()["err_vs_bf16"] > limit
    assert drv.check()["err_vs_bf16"]["value"] < limit


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["adain.serve.b32-512.bf16", "adain.request.fp32-512",
                                  "gs.render.1088x1920"])
def test_controls_fail_their_limits_on_the_card(card, cell, tmp_path):
    """At the cell's own size on the card (``calibrate.py``, one seed, in a
    process of its own): the program under each limit, the control above
    one."""
    proc = subprocess.run(
        [sys.executable, str(PB / "calibrate.py"), "--workload", cell, "--seeds",
         str(2 ** 31 + 3), "--units", "1", "--control", "1"],
        capture_output=True, text=True, timeout=900, cwd=str(ROOT),
        env={**__import__("os").environ, "TMPDIR": str(tmp_path)})
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.splitlines()[-1])
    limits = json.loads((PB / "workloads" / f"{cell}.json").read_text())["limits"]
    assert all(line["program"][k] <= v for k, v in limits.items()), line
    assert any(line["control"][k] > v for k, v in limits.items()), line
    assert all(math.isfinite(v) for v in line["control"].values())
