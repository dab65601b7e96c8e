#!/usr/bin/env python3
"""Repeat the port's depth proxy on one NVIDIA card against the CPU, and
name the card kernels of each call.

    python3 scripts/depth_proxy_repeat.py [--package-root DIR] [--label NAME]
                                          [--after-card-tests] [--trials 50]

``models.depthnet.estimate_proximity`` divides its blurred gradient energy
by the blur's own range, which magnifies any rounding of the blur; its
card-vs-CPU gate is 1e-5 max abs
(``tests/test_torch_port_cuda.py``). Each trial runs the proxy on a seeded
image under PyTorch's default TF32 flags, first in one of three states of
the caching allocator, and prints one JSON line: the state, the shape, the
max abs error against the same package on the CPU, and the names of the
card kernels the call launched (torch.profiler). The states cycle through
``empty`` (``empty_cache``: nothing cached), ``full`` (a tensor holding 90 %
of the free memory while the proxy runs), ``cached`` (a 4 GiB block freed
into the cache, so the largest cached block is large) and ``brim`` (all but
64 MiB of the card held). Trial 0 is the card test's own 64x64 shape; every
other trial takes a shape of its own with the same 9-tap blur (min(h, w) in
64..79), so that a library that picks and caches its algorithm per shape
picks it anew in each trial's state.

``--after-card-tests`` first runs the card test file of the package root in
this process (``pytest --noconftest``), as the test suite leaves the card.
``--package-root`` loads ``aip_tpu_torch`` from another checkout (a parent
commit unpacked with ``git archive``). The last line sums the trials: the
failures (error above 1e-5) and, for each distinct set of kernel names, the
trials and their largest error. Lines also go to
``build/depth_proxy/<label>.jsonl``.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
GATE = 1e-5


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package-root", default=str(ROOT))
    ap.add_argument("--label", default="this_checkout")
    ap.add_argument("--after-card-tests", action="store_true")
    ap.add_argument("--trials", type=int, default=50)
    args = ap.parse_args(argv)
    pkg_root = Path(args.package_root).resolve()
    sys.path.insert(0, str(pkg_root))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("depth_proxy_repeat: CUDA is not available")
    from aip_tpu_torch.models import depthnet

    out_path = ROOT / "build" / "depth_proxy" / f"{args.label}.jsonl"
    out_path.parent.mkdir(parents=True, exist_ok=True)
    lines = []

    def emit(**fields):
        lines.append(fields)
        print(json.dumps(fields), flush=True)

    if args.after_card_tests:
        import pytest

        rc = pytest.main(["-q", "--noconftest", "-p", "no:cacheprovider",
                          str(pkg_root / "tests" / "test_torch_port_cuda.py")])
        emit(card_tests_exit_code=int(rc))

    dev = torch.device("cuda")
    free = torch.cuda.mem_get_info()[0]
    groups = {}
    for i in range(args.trials):
        h, w = (64, 64) if i == 0 else (64 + i % 16, 65 + (i // 16 + 5 * i) % 15)
        state = ("empty", "full", "cached", "brim")[i % 4]
        g = np.random.default_rng(100 + i)
        img = torch.from_numpy(g.random((h, w, 3)).astype(np.float32))
        img = torch.nn.functional.avg_pool2d(img.permute(2, 0, 1)[None], 5, 1, 2)[0].permute(
            1, 2, 0).contiguous()
        ref = depthnet.estimate_proximity(img)
        held = None
        torch.cuda.empty_cache()
        if state in ("full", "brim"):
            free_now = torch.cuda.mem_get_info()[0]
            keep = int(0.1 * free_now) if state == "full" else 64 << 20
            held = torch.empty(max(free_now - keep, 0), dtype=torch.uint8, device=dev)
        elif state == "cached":
            torch.empty(4 << 30, dtype=torch.uint8, device=dev)
        x = img.to(dev)
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                out = depthnet.estimate_proximity(x)
                torch.cuda.synchronize()
        finally:
            torch.backends.cudnn.allow_tf32 = False
        del held
        torch.cuda.empty_cache()
        names = sorted({e.name[:120] for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA})
        err = float((out.cpu() - ref).abs().max())
        emit(trial=i, state=state, hw=[h, w], max_abs=err, fails=err > GATE, kernels=names)
        key = json.dumps(names)
        n, worst = groups.get(key, (0, 0.0))
        groups[key] = (n + 1, max(worst, err))
    import subprocess

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    emit(summary=True, label=args.label, package_root=str(pkg_root),
         card=smi.strip(), free_bytes_at_start=free, trials=args.trials,
         gate=GATE, failures=sum(1 for l in lines if l.get("fails")),
         kernel_sets=[{"kernels": json.loads(k), "trials": n, "max_abs": worst}
                      for k, (n, worst) in groups.items()])
    out_path.write_text("".join(json.dumps(l) + "\n" for l in lines))


if __name__ == "__main__":
    main()
