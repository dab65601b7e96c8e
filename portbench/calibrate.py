"""Readings for a cell's limits: the program's numbers and the control's
(the reference at the precision below the cell's in the program's place)
over many seeds in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 --units 4 [--control 1]

Each seed builds the cell anew, runs ``--units`` units, and prints one JSON
line with the compared numbers (``program``) and, with ``--control 1``,
the control's (``control``). No benchmark run calls this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from run import ROOT, _caches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--units", type=int, default=4)
    ap.add_argument("--control", type=int, default=0)
    args = ap.parse_args(argv)
    _caches()
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness

    spec = harness.cell_spec(ROOT, args.workload)
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = harness.Context(spec, seed, dev, ROOT)
        drv = harness.load_driver(spec["workload"]["driver"]).build(ctx)
        drv.warm()
        for _ in range(args.units):
            drv.unit()
        torch.cuda.synchronize()
        drv.release()
        line = {"workload": args.workload, "seed": seed,
                "program": {k: v["value"] for k, v in drv.check().items()}}
        if args.control:
            line["control"] = drv.control()
        if hasattr(drv, "close"):
            drv.close()
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del drv
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
