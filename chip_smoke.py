#!/usr/bin/env python3
"""Build and drive the PyTorch port (``aip_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. device: CUDA is required; the card's name and power limit as nvidia-smi
   reports them are printed on a line of their own.
2. build: ``aip_tpu_torch/csrc/adain_head.cu`` compiled with nvcc for sm_90a.
3. kernel vs plain, for each kernel wrapper the main path calls, with TF32
   off for fp32 convs and
   matmuls: fp32 (max abs <= 1e-4 * max|ref|) and bf16 against the plain
   version in fp32 on the same bf16-rounded inputs and weights (<= 1e-2 *
   max|ref|), at batch 2 on 512^2 and 37x45 (tail: 256^2 and 19x23 in),
   and in bf16 at the serving shape, batch 32 x 512^2.
4. serving path (the main path): ``precompute_style_stats`` +
   ``stylize_with_stats``, batch 32, 512^2, bf16, alpha 0.5, with every
   launch count set to 0 just before and read just after.
5. end to end in fp32 on one 256^2 image: the card (kernels) against the
   port on the CPU (plain path), mean abs <= 1e-3.
6. CLI: ``aip_tpu_torch.cli.run_depth.main`` on PNGs written from a seed,
   plain and ``--use_depth``.
7. times at batch 32 x 512^2 bf16 (CUDA events, median of 10 after a
   warm-up): the serving path's images/s, and for each kernel its time,
   its plain version's, the same chain as cuDNN calls (``library_ms``,
   timed here only) and its bound.
8. profile: torch.profiler over three serving calls, device time by kernel
   and the device's busy share.

The last line is ``{"ok": true, "device": {...}}``. Weights are the port's
deterministic random init (no checkpoint is committed); everything the run
writes goes under ``build/chip_smoke/`` in the checkout.
"""

import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"

# H100 SXM data sheet, dense: bf16 tensor cores, HBM3.
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12

SOURCE = "adain_head"
KERNELS = {
    "encode_head": "aip_tpu/ops/pallas/adain_head.py:174",
    "decode_tail": "aip_tpu/ops/pallas/adain_head.py:278",
}


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script needs an NVIDIA card")
    os.environ.setdefault("AIP_TPU_WEIGHTS", str(WORK / "weights"))
    sys.path.insert(0, str(ROOT))

    import torch.nn.functional as F

    from aip_tpu_torch.cli import run_depth
    from aip_tpu_torch.kernels import _build
    from aip_tpu_torch.kernels import adain_head as K
    from aip_tpu_torch.models import weights
    from aip_tpu_torch.pipelines import adain_infer

    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    bf16, f32 = torch.bfloat16, torch.float32

    # 1. device --------------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    emit("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         tf32_conv=torch.backends.cudnn.allow_tf32, tf32_matmul=torch.backends.cuda.matmul.allow_tf32)

    # 2. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    report = _build.build(SOURCE)
    build_s = time.perf_counter() - t0
    WORK.mkdir(parents=True, exist_ok=True)
    (WORK / "build.log").write_text(report)
    emit("build", source=f"aip_tpu_torch/csrc/{SOURCE}.cu", seconds=build_s,
         compiled=bool(report),
         registers=[l.strip() for l in report.splitlines() if "registers" in l])

    # Model and inputs, from seeds --------------------------------------------
    vgg = weights.get_vgg_params(device=dev)
    dec = weights.get_decoder_params(device=dev)
    head_w = [t.detach() for c in vgg.convs[:3] for t in (c.weight, c.bias)]
    tail_w = [t.detach() for c in dec.convs[-2:] for t in (c.weight, c.bias)]
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape, dtype=f32):
        return torch.rand(*shape, generator=gen, device=dev).to(dtype)

    def relu_randn(*shape, dtype=f32):
        return torch.relu(torch.randn(*shape, generator=gen, device=dev)).to(dtype)

    # 3. kernel vs plain ----------------------------------------------------
    cases = {
        "encode_head": (K.encode_head, K.encode_head_reference, head_w, rand,
                        [(2, 512, 512, 3), (2, 37, 45, 3)], (32, 512, 512, 3)),
        "decode_tail": (K.decode_tail, K.decode_tail_reference, tail_w, relu_randn,
                        [(2, 256, 256, 64), (2, 19, 23, 64)], (32, 256, 256, 64)),
    }
    main_err = {}
    for name, (kernel, plain, ws, make, shapes, serving) in cases.items():
        runs = [(s, dt) for dt in (f32, bf16) for s in shapes] + [(serving, bf16)]
        for shape, dt in runs:
            x = make(*shape, dtype=dt)
            out = kernel(x, *ws)
            torch.cuda.synchronize()
            ref = plain(x.float(), *[w.to(dt).float() for w in ws])
            err = (out.float() - ref).abs().max().item()
            scale = ref.abs().max().item()
            tol = (1e-4 if dt == f32 else 1e-2) * scale
            emit("kernel_vs_plain", kernel=name, shape=list(shape), dtype=str(dt)[6:],
                 out_shape=list(out.shape), max_abs_err=err, max_abs_ref=scale, tol=tol)
            if not (out.shape == ref.shape and err <= tol):
                raise AssertionError(f"{name} {list(shape)} {dt}: error {err} > {tol}")
            del x, out, ref
        main_err[name] = err  # the serving-shape case, run last
    torch.cuda.empty_cache()

    # 4. serving path (main path) -------------------------------------------
    style = rand(1, 512, 512, 3)
    content = rand(32, 512, 512, 3)
    K.reset_launch_counts()
    style_mean, style_std = adain_infer.precompute_style_stats(vgg, style, device=dev)
    out = adain_infer.stylize_with_stats(vgg, dec, content, style_mean, style_std, alpha=0.5,
                                         compute_dtype=bf16, device=dev)
    torch.cuda.synchronize()
    launches = K.launch_counts()
    emit("serving_path", batch=32, size=512, dtype="bfloat16", alpha=0.5,
         out_shape=list(out.shape), finite=bool(torch.isfinite(out).all()), launches=launches)
    if not (out.shape == (32, 512, 512, 3) and torch.isfinite(out).all()):
        raise AssertionError("serving path output is not finite or has the wrong shape")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the main path was not launched: {launches}")
    del out

    # 5. end to end, card vs CPU, fp32 --------------------------------------
    img, sty = rand(1, 256, 256, 3).cpu(), rand(1, 256, 256, 3).cpu()
    K.reset_launch_counts()
    m, s = adain_infer.precompute_style_stats(vgg, sty, compute_dtype=f32, device=dev)
    on_card = adain_infer.stylize_with_stats(vgg, dec, img, m, s, compute_dtype=f32,
                                             device=dev).cpu()
    card_launches = K.launch_counts()
    vgg_cpu = weights.from_jax_params(_hwio(vgg), "cpu")
    dec_cpu = weights.from_jax_params(_hwio(dec), "cpu")
    m, s = adain_infer.precompute_style_stats(vgg_cpu, sty, compute_dtype=f32, device="cpu")
    on_cpu = adain_infer.stylize_with_stats(vgg_cpu, dec_cpu, img, m, s, compute_dtype=f32,
                                            device="cpu")
    diff = (on_card - on_cpu).abs()
    emit("end_to_end_fp32", size=256, mean_abs=diff.mean().item(), max_abs=diff.max().item(),
         launches_on_card=card_launches, tol_mean_abs=1e-3)
    if not (diff.mean().item() <= 1e-3 and min(card_launches.values()) > 0):
        raise AssertionError("card and CPU disagree end to end")

    # 6. CLI ----------------------------------------------------------------
    from PIL import Image

    cli_dir = WORK / "cli"
    cli_dir.mkdir(parents=True, exist_ok=True)
    paths = []
    for i, hw in enumerate([(300, 420), (256, 256)]):
        p = cli_dir / f"in{i}.png"
        Image.fromarray((rand(*hw, 3).cpu().numpy() * 255).astype("uint8")).save(p)
        paths.append(str(p))
    for flags in ([], ["--use_depth"]):
        name = "depth" if flags else "plain"
        K.reset_launch_counts()
        path = run_depth.main(["--content", paths[0], "--style", paths[1], "--output",
                               str(cli_dir), "--file_name", name, *flags])
        torch.cuda.synchronize()
        counts = K.launch_counts()
        size = Image.open(path).size if path.exists() else None
        emit("cli", flags=flags, output=str(path.relative_to(ROOT)), image_size=size,
             launches=counts, file_io=True)
        if size is None or min(counts.values()) <= 0:
            raise AssertionError(f"CLI run {flags} wrote nothing or launched no kernel")

    # 7. times --------------------------------------------------------------
    serve_ms = _time_ms(torch, lambda: adain_infer.stylize_with_stats(
        vgg, dec, content, style_mean, style_std, alpha=0.5, compute_dtype=bf16, device=dev))
    emit("serving_time", batch=32, ms=serve_ms, images_per_s=32 / serve_ms * 1e3)

    x = content.to(bf16)
    y = relu_randn(32, 256, 256, 64, dtype=bf16)
    w_eff, b_eff = K.fold_rgb_conv(*[w.to(bf16).float() for w in head_w[:4]])
    lib_head = [w.to(bf16) for w in (w_eff, b_eff, head_w[4], head_w[5])]
    lib_tail = [w.to(bf16) for w in tail_w]
    timed = {
        "encode_head": (lambda: K.encode_head(x, *head_w),
                        lambda: K.encode_head_reference(x, *head_w),
                        lambda: _library_head(F, x, *lib_head), _head_work(x)),
        "decode_tail": (lambda: K.decode_tail(y, *tail_w),
                        lambda: K.decode_tail_reference(y, *tail_w),
                        lambda: _library_tail(F, y, *lib_tail), _tail_work(y)),
    }
    lines = []
    for name, (kern, plain, lib, (flops, nbytes)) in timed.items():
        t_comp, t_mem = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
        lines.append({
            "name": name, "route": "cuda", "source": f"aip_tpu_torch/csrc/{SOURCE}.cu",
            "replaces": KERNELS[name], "launches": launches[name],
            "max_abs_err": main_err[name],
            "ms": _time_ms(torch, kern), "plain_ms": _time_ms(torch, plain),
            "bound_ms": max(t_comp, t_mem) * 1e3,
            "bound_by": "operations" if t_comp >= t_mem else "bytes",
            "library_ms": _time_ms(torch, lib),
        })
        emit("kernel_work", kernel=name, shape=list((x if name == "encode_head" else y).shape),
             dtype="bfloat16", flops=flops, bytes=nbytes, peak_flops=PEAK_FLOPS,
             peak_bytes_per_s=PEAK_BYTES)

    # 8. profile ------------------------------------------------------------
    _profile(torch, lambda: adain_infer.stylize_with_stats(
        vgg, dec, content, style_mean, style_std, alpha=0.5, compute_dtype=bf16, device=dev))
    print(json.dumps({"kernels": lines}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


def _hwio(module):
    """A module's convs as HWIO params, the form ``from_jax_params`` takes."""
    return [{"w": c.weight.detach().permute(2, 3, 1, 0).cpu().numpy(),
             "b": c.bias.detach().cpu().numpy()} for c in module.convs]


def _time_ms(torch, fn, runs=10, warmup=2):
    """Median of ``runs`` CUDA-event timings of ``fn``, after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _profile(torch, fn, calls=3):
    """torch.profiler over ``calls`` serving calls after a warm-up: device
    time by kernel name per call, and the device's busy share of the host's
    wall time (kernels run on one stream, so their durations do not
    overlap)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    busy_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    emit("serving_profile", calls=calls, wall_ms_per_call=wall_us / 1e3 / calls,
         device_ms_per_call=busy_ms / calls if by_name else "not measured",
         device_busy_share=busy_ms * 1e3 / wall_us if by_name else "not measured",
         kernels=[{"name": name[:100], "ms_per_call": ms / calls, "launches_per_call": n / calls}
                  for name, (ms, n) in top])


def _head_work(x):
    """(FLOPs, bytes) of the head on x [B,H,W,3]: 2 x the MACs of the folded
    chain it runs, conv1 (3x3 3->64, RGB conv folded in) and conv2 (3x3
    64->64); x read once, the pooled output written once, fp32 weights read
    once."""
    b, h, w, _ = x.shape
    it = x.element_size()
    flops = 2 * b * h * w * (64 * 27 + 64 * 576)
    nbytes = (b * h * w * 3 * it + b * math.ceil(h / 2) * math.ceil(w / 2) * 64 * it
              + 4 * (9 + 3 + 27 * 64 + 64 + 576 * 64 + 64))
    return flops, nbytes


def _tail_work(y):
    """(FLOPs, bytes) of the tail on y [B,h,w,64]: 2 x the MACs of the
    64->64 and 64->3 convs at 2h x 2w; y read once, the output written once."""
    b, h, w, _ = y.shape
    it = y.element_size()
    flops = 2 * b * (2 * h) * (2 * w) * (64 * 576 + 3 * 576)
    nbytes = b * h * w * 64 * it + b * 4 * h * w * 3 * it + 4 * (576 * 64 + 64 + 576 * 3 + 3)
    return flops, nbytes


def _library_head(F, x, w_eff, b_eff, w2, b2):
    """The head as cuDNN calls on channels_last bf16, RGB conv folded."""
    t = x.permute(0, 3, 1, 2)
    t = F.relu(F.conv2d(F.pad(t, (1, 1, 1, 1), mode="reflect"), w_eff, b_eff))
    t = F.relu(F.conv2d(F.pad(t, (1, 1, 1, 1), mode="reflect"), w2, b2))
    return F.max_pool2d(t, 2, 2, ceil_mode=True)


def _library_tail(F, y, w2, b2, w1, b1):
    """The tail as cuDNN calls on channels_last bf16."""
    u = F.interpolate(y.permute(0, 3, 1, 2), scale_factor=2, mode="nearest")
    z = F.relu(F.conv2d(F.pad(u, (1, 1, 1, 1), mode="reflect"), w2, b2))
    return F.conv2d(F.pad(z, (1, 1, 1, 1), mode="reflect"), w1, b1)


if __name__ == "__main__":
    main()
