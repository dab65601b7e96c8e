"""Run cells on the CPU at a tiny size, past the harness's look for a card:

    python portbench/tests/cpu_run.py ROOT FAULT CELL[:TRACE] ...

``FAULT`` (``none``, ``alter``, ``half``) breaks the timed path underneath
(see ``FAULTS``). Prints the result line of each run as run.py would, then
one JSON line with the top-level names of every loaded module."""

from __future__ import annotations

import json
import sys
from pathlib import Path

SCALE = {
    "adain.serve.b32-512.bf16": {"batch": 4, "size": 32, "batches": 2, "trace_units": 2},
    "gs.render.1088x1920": {"height": 72, "width": 128, "views": 2, "trace_units": 1},
    "adain.request.fp32-512": {"content_w": 64, "content_h": 48, "style_w": 48, "style_h": 48,
                               "content_size": 32, "style_size": 32, "trace_units": 2},
}


def _alter(out):
    """An answer altered where it is produced: one image's top-left block."""
    out = out.clone()
    out[-1, :8, :8, :] += 0.25
    return out


def _half(out):
    """Half of the batch left out: its second half copies the first."""
    out = out.clone()
    n = out.shape[0]
    if n > 1:
        out[n // 2:] = out[:n - n // 2]
    return out


FAULTS = {
    "alter": [("aip_tpu_torch.pipelines.adain_infer", "stylize_with_stats", _alter),
              ("aip_tpu_torch.pipelines.adain_infer", "stylize_simple", _alter),
              ("aip_tpu_torch.gs.render", "render_frame", lambda img: img + 0.05)],
    "half": [("aip_tpu_torch.pipelines.adain_infer", "stylize_with_stats", _half)],
}


def _break(fault: str) -> None:
    """Wrap the calls the window drives so that what they produce carries
    the fault."""
    import importlib

    for mod_name, name, broken in FAULTS.get(fault, []):
        mod = importlib.import_module(mod_name)

        def wrapped(*a, _real=getattr(mod, name), _broken=broken, **kw):
            return _broken(_real(*a, **kw))

        setattr(mod, name, wrapped)


def main(argv) -> int:
    root, fault, cells = Path(argv[0]), argv[1], argv[2:]
    sys.path.insert(0, str(root))
    import os

    from portbench import harness

    # The request driver points the program's weight cache at its scratch
    # directory before the program is imported; _break imports it first.
    spec = harness.cell_spec(root, "adain.request.fp32-512")
    os.environ["AIP_TPU_WEIGHTS"] = str(harness.Context(spec, 0, "cpu", root).scratch / "weights")
    _break(fault)
    for cell in cells:
        name, _, trace = cell.partition(":")
        result = harness.run(root, name, 2 ** 31 + 11, 0.5, trace == "1", device="cpu",
                             scale=SCALE.get(name, {}))
        harness.print_result(result)
    print(json.dumps({"modules": sorted({m.split(".")[0] for m in sys.modules})}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
