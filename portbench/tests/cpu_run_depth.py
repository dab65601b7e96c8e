"""Run the depth cell on the CPU at a tiny size, past the harness's look for a
card:

    python portbench/tests/cpu_run_depth.py ROOT FAULT [TRACE ...]

The program's DPT is cut to ``SMALL`` (hidden 64, 4 heads, 4 blocks hooked
at 0-3, features 32, a 64 x 64 network input), the benchmark's to the same
through the scale. ``FAULT`` breaks the timed path underneath: ``none``;
``nodepth``, the stylize step given a constant map (depth left out);
``skipblock``, the program's DPT with its second block skipped. Prints
each run's result line as run.py would."""

from __future__ import annotations

import json
import sys
from pathlib import Path

CELL = "depth.request.512.fp32"
SMALL = {"hidden_size": 64, "num_hidden_layers": 4, "num_attention_heads": 4,
         "intermediate_size": 256, "pos_grid": 6, "hooks": [0, 1, 2, 3],
         "reassemble_widths": [16, 32, 64, 64], "features": 32, "net_size": 64}
SCALE = {"config": SMALL, "content_w": 64, "content_h": 48, "style_w": 40, "style_h": 40,
         "content_size": 32, "style_size": 32, "calibration_images": 1, "trace_units": 2}


def _break(fault: str) -> None:
    import torch

    from aip_tpu_torch.models import dpt
    from aip_tpu_torch.pipelines import adain_infer

    if fault == "nodepth":
        real = adain_infer.stylize_depth

        def flat(vgg, dec, content, style, depth_map, *a, **kw):
            return real(vgg, dec, content, style, torch.zeros_like(depth_map), *a, **kw)

        adain_infer.stylize_depth = flat
    elif fault == "skipblock":
        real_load = dpt.dpt_from_state_dict

        def skipped(*a, **kw):
            net = real_load(*a, **kw)
            net.pretrained.model.blocks[1] = torch.nn.Identity()
            return net

        dpt.dpt_from_state_dict = skipped


def main(argv) -> int:
    root, fault, traces = Path(argv[0]), argv[1], argv[2:] or ["0"]
    sys.path.insert(0, str(root))
    import os

    from portbench import harness

    spec = harness.cell_spec(root, CELL)
    os.environ["AIP_TPU_WEIGHTS"] = str(harness.Context(spec, 0, "cpu", root).scratch / "weights")
    from aip_tpu_torch.models import dpt

    fields = {f.name for f in dpt.dataclasses.fields(dpt.DPTConfig)}
    cfg = {**spec["config"], **SMALL}
    dpt.DPT_LARGE = dpt.DPTConfig(**{k: tuple(v) if isinstance(v, list) else v
                                     for k, v in cfg.items() if k in fields})
    _break(fault)
    for trace in traces:
        result = harness.run(root, CELL, 2 ** 31 + 19, 0.5, trace == "1", device="cpu",
                             scale=json.loads(json.dumps(SCALE)))
        harness.print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
