"""Run the localized cell on the CPU at a tiny size, past the harness's look
for a card:

    python portbench/tests/cpu_run_localized.py ROOT FAULT [TRACE ...]

The program's stylize step runs at ``SCALE``'s working sizes (the pipeline
fixes AdaIN's at 512). ``FAULT`` breaks the timed path underneath: ``none``;
``mask``, one 8 x 8 block of each mask flipped where the segmenter decides
it; ``alter``, the composite's top-left 16 x 16 block brightened. Prints
each run's result line as run.py would."""

from __future__ import annotations

import functools
import json
import sys
from pathlib import Path

CELL = "localized.1920x1080.fp32"
SCALE = {"config": {"blocks": [1, 1, 2, 1]}, "content_w": 64, "content_h": 48,
         "style_w": 40, "style_h": 40, "content_size": 32, "style_size": 32,
         "calibration_images": 2, "trace_units": 2}


def _flip_block(mask):
    mask = mask.clone()
    mask[:8, :8] = 1 - mask[:8, :8]
    return mask


def _alter(out):
    out = out.copy()
    out[:16, :16] += 0.25
    return out


def _break(fault: str) -> None:
    from aip_tpu_torch.models import deeplab
    from aip_tpu_torch.pipelines import localized

    if fault == "mask":
        real = deeplab.make_background_segmenter

        def segmenter(params, *a, **kw):
            seg = real(params, *a, **kw)
            return lambda img: _flip_block(seg(img))

        deeplab.make_background_segmenter = segmenter
    elif fault == "alter":
        real_composite = localized.composite_localized
        localized.composite_localized = lambda *a, **kw: _alter(real_composite(*a, **kw))


def main(argv) -> int:
    root, fault, traces = Path(argv[0]), argv[1], argv[2:] or ["0"]
    sys.path.insert(0, str(root))
    import os

    from portbench import harness

    spec = harness.cell_spec(root, CELL)
    os.environ["AIP_TPU_WEIGHTS"] = str(harness.Context(spec, 0, "cpu", root).scratch / "weights")
    from aip_tpu_torch.pipelines import adain_infer, localized

    localized.adain_inference = functools.partial(
        adain_infer.adain_inference, content_size=SCALE["content_size"],
        style_size=SCALE["style_size"])
    _break(fault)
    for trace in traces:
        result = harness.run(root, CELL, 2 ** 31 + 17, 0.5, trace == "1", device="cpu",
                             scale=json.loads(json.dumps(SCALE)))
        harness.print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
