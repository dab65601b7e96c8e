#!/usr/bin/env python3
"""The fp32 walk conv kernel (``csrc/conv3x3_f32.cu``) on every walk shape
of one AdaIN request, beside cuDNN's fp32 conv, on one NVIDIA card.

    python3 scripts/bench_conv3x3_f32.py [--size 512x683] [--batch 1] [--repeat 20]
                                         [--skip-float64] [--style]

The shapes are those the fp32 walks run on a content image of ``--size``
(the encoder past its head to relu4_1, and the decoder before its tail;
``--style``: the encoder's alone, as the style image runs it),
each with He-normal weights and a ReLU'd, reflection-bordered input from
torch seed 0. For each distinct shape one JSON line:

* ``kernel_ms``: the kernel on the NHWC-contiguous input, ms a call over
  ``--repeat`` calls in one CUDA-event window (median of 5 windows), at the
  tile ``tile_rows`` picks (``tile_rows``) and at each tiling
  (``kernel_ms_rows8``, ``kernel_ms_rows16``);
* ``wrapper_ms``: ``conv3x3_f32`` on the walks' input, an NHWC view of an
  NCHW tensor, so it includes the copy to NHWC;
* ``cudnn_ms``: ``F.conv2d`` on the same NCHW tensor, TF32 off (the call
  the walks made before the kernel), and its launches a call as
  torch.profiler counts them;
* ``bound_ms``: three TF32 products an operation at 495 TFLOP/s
  (``bound_fp32_ms``: the CUDA cores' 67 TFLOP/s), and the kernel's share;
* ``err_kernel``, ``err_cudnn``: max abs difference from the conv in
  float64 over the largest float64 value (unless ``--skip-float64``).

A last line sums the request: ``uses`` calls of each shape.
"""

import argparse
import json
import statistics
import subprocess
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

TF32_PEAK = 495e12
FP32_PEAK = 67e12


def walk_shapes(h, w, decoder=True):
    """(Cin, Cout, H_out, W_out) of each fp32 walk conv on an h x w image:
    the encoder's (``models.vgg.walk_conv_shapes``) and, with ``decoder``,
    the decoder's on its relu4_1 map (``models.decoder.walk_conv_shapes``)."""
    from aip_tpu_torch.models import decoder as tdec
    from aip_tpu_torch.models import vgg as tvgg

    shapes = tvgg.walk_conv_shapes(h, w)
    return shapes + tdec.walk_conv_shapes(*shapes[-1][2:]) if decoder else shapes


def _window_ms(torch, fn, repeat):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(repeat):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / repeat)
    return statistics.median(times)


def _launches(torch, fn):
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = Counter(e.name for e in prof.events() if e.device_type.name == "CUDA")
    return sum(names.values()), [n for n, _ in names.most_common(4)]


def measure(torch, dev, gen, batch, cin, cout, ho, wo, repeat=20, float64=True):
    """One walk conv shape: the kernel against cuDNN (see the module
    docstring); returns its line as a dict."""
    import torch.nn.functional as F

    from aip_tpu_torch.kernels import conv3x3_f32 as KF
    from aip_tpu_torch.kernels._build import launch

    x = torch.relu(torch.randn(batch, cin, ho, wo, generator=gen, device=dev))
    x = F.pad(x, (1, 1, 1, 1), mode="reflect")                  # NCHW, the walks' layout
    weight = torch.randn(cout, cin, 3, 3, generator=gen, device=dev) * (2 / (9 * cin)) ** .5
    view = x.permute(0, 2, 3, 1)                                  # the walks' NHWC view
    nhwc = view.contiguous()
    packed = KF.pack_weights(weight)
    KF.reset_launch_counts()
    out = KF.conv3x3_f32(nhwc, weight, packed)
    torch.cuda.synchronize()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    row = {"cin": cin, "cout": cout, "h": ho, "w": wo, "batch": batch,
           "kernel_launches": KF.launch_counts()["conv3x3_f32"],
           "tile_rows": KF.tile_rows(batch, ho, wo, cout, sms)}
    if float64:
        ref = F.conv2d(x.double(), weight.double()).permute(0, 2, 3, 1)
        scale = float(ref.abs().max())
        row["err_kernel"] = float((out.double() - ref).abs().max()) / scale
        cud = F.conv2d(x, weight).permute(0, 2, 3, 1)
        row["err_cudnn"] = float((cud.double() - ref).abs().max()) / scale
        del ref, cud
    flop = 2.0 * batch * ho * wo * cin * cout * 9
    row["kernel_ms"] = _window_ms(torch, lambda: KF.conv3x3_f32(nhwc, weight, packed), repeat)
    row["wrapper_ms"] = _window_ms(torch, lambda: KF.conv3x3_f32(view, weight, packed), repeat)
    for rows in (8, 16):   # each tiling, whichever tile_rows picks
        row[f"kernel_ms_rows{rows}"] = _window_ms(torch, lambda: launch(
            KF._lib().aip_conv3x3_f32, dev, nhwc, packed, out, batch, ho, wo, cin, cout,
            rows // 8), repeat)
    row["cudnn_ms"] = _window_ms(torch, lambda: F.conv2d(x, weight), repeat)
    row["cudnn_launches"], row["cudnn_kernels"] = _launches(torch, lambda: F.conv2d(x, weight))
    row["bound_ms"] = 3 * flop / TF32_PEAK * 1e3
    row["bound_fp32_ms"] = flop / FP32_PEAK * 1e3
    row["kernel_share_of_bound"] = row["bound_ms"] / row["kernel_ms"]
    row["kernel_tflops"] = flop / row["kernel_ms"] / 1e9
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", default="512x683")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--repeat", type=int, default=20)
    ap.add_argument("--skip-float64", action="store_true")
    ap.add_argument("--style", action="store_true",
                    help="the style image's encoder shapes (square --size) instead")
    args = ap.parse_args(argv)
    h, w = map(int, args.size.split("x"))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "smi": smi,
                      "size": args.size, "batch": args.batch}), flush=True)

    shapes = walk_shapes(h, w, decoder=not args.style)
    uses = Counter(shapes)
    gen = torch.Generator(device=dev).manual_seed(0)
    total = Counter()
    for shape in uses:
        row = measure(torch, dev, gen, args.batch, *shape, repeat=args.repeat,
                      float64=not args.skip_float64)
        row["uses"] = uses[shape]
        for k in ("kernel_ms", "wrapper_ms", "cudnn_ms", "bound_ms"):
            total[k] += row[k] * row["uses"]
        print(json.dumps(row), flush=True)
    print(json.dumps({"request_sum": {k: round(v, 4) for k, v in total.items()},
                      "convs": len(shapes)}), flush=True)


if __name__ == "__main__":
    main()
