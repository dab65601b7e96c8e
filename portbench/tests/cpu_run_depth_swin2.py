"""Run the SwinV2 depth cell on the CPU at a tiny size, past the harness's
look for a card:

    python portbench/tests/cpu_run_depth_swin2.py ROOT FAULT [TRACE ...]

The program's DPT-SwinV2 is cut to ``SMALL`` (width 16, window 8 with a
pretrained window of 4, a 64 x 64 network input: stage grids 16, 8, 4, 2,
so one shifted stage, one whose grid is the window and two clamped), the
benchmark's to the same through the scale. ``FAULT`` breaks the timed path
underneath: ``none``; ``nodepth``, the stylize step given a constant map
(depth left out); ``skipblock``, the program's network with the first
block of its third stage skipped. Prints each run's result line as run.py
would."""

from __future__ import annotations

import json
import sys
from pathlib import Path

CELL = "depth.request.swin2l-384.fp32"
SMALL = {"embed_dim": 16, "depths": [2, 2, 2, 2], "num_heads": [2, 2, 4, 4],
         "window_size": 8, "pretrained_window_sizes": [4, 4, 4, 2], "cpb_hidden": 32,
         "hooks": [1, 1, 1, 1], "features": 32, "head_features": 8, "num_classes": 10,
         "net_size": 64}
SCALE = {"config": SMALL, "content_w": 64, "content_h": 48, "style_w": 40, "style_h": 40,
         "content_size": 32, "style_size": 32, "calibration_images": 1, "trace_units": 2}


def _break(fault: str) -> None:
    import torch

    from aip_tpu_torch.models import dpt_swin2
    from aip_tpu_torch.pipelines import adain_infer

    if fault == "nodepth":
        real = adain_infer.stylize_depth

        def flat(vgg, dec, content, style, depth_map, *a, **kw):
            return real(vgg, dec, content, style, torch.zeros_like(depth_map), *a, **kw)

        adain_infer.stylize_depth = flat
    elif fault == "skipblock":
        real_load = dpt_swin2.dpt_swin2_from_state_dict

        def skipped(*a, **kw):
            net = real_load(*a, **kw)
            net.pretrained.model.layers[2].blocks[0].forward = lambda x: x
            return net

        dpt_swin2.dpt_swin2_from_state_dict = skipped


def main(argv) -> int:
    root, fault, traces = Path(argv[0]), argv[1], argv[2:] or ["0"]
    sys.path.insert(0, str(root))
    import os

    from portbench import harness

    spec = harness.cell_spec(root, CELL)
    os.environ["AIP_TPU_WEIGHTS"] = str(harness.Context(spec, 0, "cpu", root).scratch / "weights")
    from aip_tpu_torch.models import dpt_swin2

    fields = {f.name for f in dpt_swin2.dataclasses.fields(dpt_swin2.Swin2DPTConfig)}
    cfg = {**spec["config"], **SMALL}
    dpt_swin2.DPT_SWIN2_L_384 = dpt_swin2.Swin2DPTConfig(
        **{k: tuple(v) if isinstance(v, list) else v for k, v in cfg.items() if k in fields})
    _break(fault)
    for trace in traces:
        result = harness.run(root, CELL, 2 ** 31 + 23, 0.5, trace == "1", device="cpu",
                             scale=json.loads(json.dumps(SCALE)))
        harness.print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
