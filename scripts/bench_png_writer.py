#!/usr/bin/env python3
"""The PNG writer of ``save_image`` and ``save_depth_png`` on one NVIDIA
card and its host: the filter kernel (``csrc/png_filter.cu``) beside its
bytes bound, and the host's time to write each file before and after.

    python3 scripts/bench_png_writer.py [--repeat 20] [--out DIR]

Two images, made from torch seed 0 on the card: the request cells' 512x683
RGB output (coarse noise upsampled bicubically plus fine noise, fitted to
mean 0.5 and standard deviation 0.2, fp32 NHWC) and the depth cell's
768x1024 proximity map (fp32). One JSON line each:

* ``kernel_ms``: the kernel's own device time a launch, from
  ``torch.profiler`` over ``--repeat`` calls; ``call_ms``: the wrapper's
  call (the 16-bit one with its min and max), ms a call over ``--repeat``
  calls in one CUDA-event window (median of 5 windows), which the host's
  launch overhead sets; ``bound_ms``: the bytes the kernel reads and
  writes over 3.35 TB/s (the fp32 input as it is read); ``equal_plain``
  and ``max_abs_rows``: its rows equal the plain version's, and their
  largest byte difference; ``plain_ms``: the plain version on the CPU copy (host clock,
  median of 5);
* ``write_ms``: the writer from the CUDA tensor to the file (kernel, fetch
  of the filtered rows, deflate in strips, write), host clock, median of
  ``--repeat``; ``deflate_ms_1`` and ``deflate_ms_pool``: the strips alone
  on one thread and on the process's pool;
* ``pil_ms``: the path the writer replaced on the same tensor (fetch of the
  fp32 or float64 map, numpy's rounding, PIL's PNG at the same level),
  timed the same way; the two files' bytes, whether PIL decodes them to
  the same pixels (``same_pixels``) and their largest difference
  (``max_abs_pixels``).

A first line names the card, its power limit and the host's cores.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

HBM_BYTES_S = 3.35e12


def _old_save_image(t, path):
    """``save_image`` before the writer."""
    import numpy as np
    from PIL import Image

    a = np.clip(t.detach().float().cpu().numpy()[0], 0.0, 1.0)
    Image.fromarray(np.clip(np.floor(a * 255.0 + 0.5), 0, 255).astype(np.uint8)).save(str(path))


def _old_save_depth_png(d, path):
    """``save_depth_png`` before the writer."""
    import numpy as np
    from PIL import Image

    d = d.detach().double().cpu().numpy()
    extent = d.max() - d.min()
    norm = (d - d.min()) / extent if extent > 0 else np.zeros_like(d)
    Image.fromarray(np.floor(norm * 65535.0 + 0.5).astype(np.uint16)).save(str(path),
                                                                         compress_level=1)


def _host_ms(fn, repeat):
    import torch

    times = []
    for _ in range(repeat):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def _call_ms(torch, fn, repeat):
    fn()
    torch.cuda.synchronize()
    windows = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(repeat):
            fn()
        end.record()
        end.synchronize()
        windows.append(start.elapsed_time(end) / repeat)
    return statistics.median(windows)


def _device_ms(torch, fn, repeat, name="png_filter"):
    """Mean device ms of the kernels whose name holds ``name``, a launch."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(repeat):
            fn()
        torch.cuda.synchronize()
    times = [e.device_time_total / 1e3 for e in prof.key_averages() if name in e.key]
    counts = [e.count for e in prof.key_averages() if name in e.key]
    return sum(times) / max(sum(counts), 1) if counts else None


def images(torch, dev):
    """The request cells' 512x683 RGB output and the depth cell's map."""
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(0)
    img = F.interpolate(torch.rand((1, 3, 24, 24), generator=gen, device=dev), size=(512, 683),
                        mode="bicubic")
    img = img + 0.05 * torch.randn((1, 3, 512, 683), generator=gen, device=dev)
    img = ((img - img.mean()) / img.std() * 0.2 + 0.5).permute(0, 2, 3, 1).contiguous()
    low = torch.rand((1, 1, 24, 32), generator=gen, device=dev)
    depth = F.interpolate(low, size=(768, 1024), mode="bicubic")[0, 0].contiguous()
    return img, depth


def measure(torch, dev, repeat=20, out_dir=None):
    """One dict a file: the image (``save_image``) and the depth map
    (``save_depth_png``)."""
    import numpy as np
    from PIL import Image

    from aip_tpu_torch.kernels import png_filter as PF
    from aip_tpu_torch.pipelines import adain_infer
    from aip_tpu_torch.utils import png

    out = Path(out_dir or tempfile.mkdtemp(prefix="png_writer_"))
    out.mkdir(parents=True, exist_ok=True)
    img, depth = images(torch, dev)
    cases = [
        ("save_image", img, lambda p: adain_infer.save_image(img, p), _old_save_image,
         lambda: PF.png_rows8(img[0]), lambda: PF.png_rows8(img[0].cpu()),
         img.numel() * 4, 8, 3, adain_infer.PNG_LEVEL),
        ("save_depth_png", depth, lambda p: adain_infer.save_depth_png(depth, p),
         _old_save_depth_png, lambda: PF.png_rows16(depth), lambda: PF.png_rows16(depth.cpu()),
         depth.numel() * depth.element_size(), 16, 1, adain_infer.DEPTH_PNG_LEVEL),
    ]
    rows_out = []
    with ThreadPoolExecutor(1) as one:
        for name, t, new, old, card, plain, in_bytes, bits, channels, level in cases:
            rows = card()
            torch.cuda.synchronize()
            want = plain()
            equal = bool(torch.equal(rows.cpu(), want))
            max_abs_rows = int((rows.cpu().int() - want.int()).abs().max())
            host_rows = rows.cpu().numpy()
            new_path, old_path = out / f"{name}_writer.png", out / f"{name}_pil.png"
            row = {
                "file": name, "shape": list(t.shape), "bit_depth": bits, "level": level,
                "kernel_ms": _device_ms(torch, card, repeat),
                "call_ms": _call_ms(torch, card, repeat),
                "bound_ms": 1e3 * (in_bytes + rows.numel()) / HBM_BYTES_S,
                "plain_ms": _host_ms(plain, 5),
                "bytes_read": in_bytes, "bytes_written": rows.numel(), "equal_plain": equal,
                "max_abs_rows": max_abs_rows,
                "write_ms": _host_ms(lambda: new(new_path), repeat),
                "pil_ms": _host_ms(lambda: old(t, old_path), repeat),
                "deflate_ms_1": _host_ms(lambda: png.deflate(host_rows, level, one), repeat),
                "deflate_ms_pool": _host_ms(lambda: png.deflate(host_rows, level), repeat),
                "strips": len(png.strips(*host_rows.shape)),
                "writer_bytes": new_path.stat().st_size, "pil_bytes": old_path.stat().st_size,
            }
            with Image.open(new_path) as a, Image.open(old_path) as b:
                a, b = np.asarray(a).astype(np.int64), np.asarray(b).astype(np.int64)
                row["same_pixels"] = bool(a.shape == b.shape and np.array_equal(a, b))
                row["max_abs_pixels"] = int(np.abs(a - b).max()) if a.shape == b.shape else None
            rows_out.append(row)
    return rows_out


def card_line(torch):
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        smi = f"not read: {exc}"
    return {"card": torch.cuda.get_device_name(0), "nvidia_smi": smi,
            "host_cores": len(os.sched_getaffinity(0)), "cpu_count": os.cpu_count(),
            "torch": torch.__version__}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeat", type=int, default=20)
    ap.add_argument("--out", default=None, help="directory for the files (a temporary one)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_png_writer needs a CUDA card")
    print(json.dumps(card_line(torch)), flush=True)
    for row in measure(torch, torch.device("cuda"), args.repeat, args.out):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
