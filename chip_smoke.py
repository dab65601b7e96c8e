#!/usr/bin/env python3
"""Build and drive the PyTorch port (``aip_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. device: CUDA is required; the card's name and power limit as nvidia-smi
   reports them are printed on a line of their own.
2. build: ``aip_tpu_torch/csrc/adain_head.cu`` and ``composite.cu``
   compiled with nvcc for sm_90a, both at once, with ptxas's register and
   spill report.
3. kernel vs plain, for each AdaIN kernel wrapper, with TF32 off for fp32
   convs and matmuls: fp32 (max abs <= 1e-4 * max|ref|) and bf16 against
   the plain version in fp32 on the same bf16-rounded inputs and weights
   (<= 1e-2 * max|ref|), at batch 2 on 512^2 and 37x45 (tail: 256^2 and
   19x23 in), and in bf16 at the serving shape, batch 32 x 512^2.
4. AdaIN serving path (a main path): ``precompute_style_stats`` +
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

Stylized 3DGS inference render, on the committed trained model
``docs/examples/bed_0037_r5`` (130,968 Gaussians, its recorded selection)
and on the 1080p fog of ``scripts/bench_gs.py`` (100k Gaussians from numpy
seed 0):

9.  scenes: a Blender-format camera set (8 cameras at 800^2, blank PNGs, on
    an orbit from which the model fills the frame), a model directory with
    ``cfg_args.json`` pointed at it, and a style PNG from a seed.
10. compositor kernels vs plain, float32, on the inputs the two main paths
    hand them (captured from one frame of each) and on edge cases (counts
    0, counts not a multiple of 64, segments starting mid-group, a block
    that saturates early). Pass: max abs <= 1e-3 * max(1, max|ref|) and
    mean abs <= 1e-5, because the kernel's sequential transmittance product
    and the plain version's exp(cumsum(log1p)) round differently, so the
    1e-4 cutoff can flip at single pixels.
11. main path, windowed: ``gs.pipeline.run_3dgs_rendering`` on the
    committed model; the GIF and 8 PNGs exist, > 10 % of pixels differ
    from the background, the windowed kernel ran >= 8 times.
12. main path, segment walk: ``make_inference_frame_fn`` + ``render_frame``
    on the fog at 1088x1920; the segment kernel ran, the windowed did not.
13. card vs CPU, float32: the committed model at 256^2 from one camera,
    the card (kernels) against the port on the CPU (plain versions), mean
    abs <= 1e-4.
14. times (CUDA events, median of 10 after a warm-up): ms per frame of the
    committed model at 800^2 and at 1088x1920 under ``fit_selection(...,
    hi=8192)`` over the 8 cameras, and of the fog; each compositor's ms,
    plain ms, launches per frame and bound; a torch.profiler breakdown of
    one 1088x1920 frame of the committed model by stage, with the device's
    busy share.

Stylized 3DGS training, at full width (``GSTrainConfig``'s defaults: capacity
2^17, a 16 x 2^19 x 2 hash grid, style_dim 256, K 128, macro 4, kc 1024),
one view per step:

15. a training scene (the 8 orbit cameras of phase 9 moved out to 1.5 times
    their distance, the port's own 800^2 renders of the committed model as
    images, a 100k-point cloud from numpy seed 0); one photometric step captures the gathered
    [2500, 128, .] arrays of the real 800^2 selection, on which kernels A
    (forward) and B (backward) are held against their plain versions, and
    on edge tiles (empty, saturating, the 0.99 clamp, opacity 0, invalid
    slots). Image and T_final at 1e-5 absolute, gradients at 1e-4 of each
    one's largest value.
16. kernel C on the same step's x01 [131072, 3] and upstream gradient
    against its plain version (one ``index_add_``), at 1e-4 of the largest
    entry (atomics add thousands of contributions to the coarse levels'
    rows in another order).
17. one training step at 128^2 (capacity 4096, a 2^16 table) from one
    trainer on the card and on the CPU: the loss at 1e-4 relative, every
    parameter group's gradient and the screen-space offset's at 1e-3 of
    their largest entry.
18. training (a main path): ``gs.pipeline.run_3dgs_training`` for 60
    iterations with the schedule shortened so that every event fires
    (photometric then style steps, clone, split, prune, opacity reset,
    recompaction, the RVQ boundary, mask prunes), with the launch counts
    set to 0 just before and read just after; then
    ``run_3dgs_rendering`` of the saved model. Prints the events, the loss
    curve (the mean of the last 5 photometric losses must be below the
    first 5), the median step ms per phase (CUDA events), launches per step
    and peak memory.
19. the CLI: ``aip_tpu_torch.cli.run_3dgs.main`` for 4 iterations, which
    trains and then renders.
20. times of A, B and C on the served inputs (ms, plain ms, bound,
    ``index_add_`` as C's library call), and a torch.profiler breakdown of
    one photometric and one style step by stage, with the busy share.

The line before the last lists every kernel (``{"kernels": [...]}``); the
last line is ``{"ok": true, "device": {...}}``. AdaIN weights are the
port's deterministic random init (no checkpoint is committed); everything
the run writes goes under ``build/chip_smoke/`` in the checkout.
"""

import json
import math
import os
import statistics
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"

# H100 SXM data sheet, dense: bf16 tensor cores, float32 on the CUDA cores,
# HBM3.
PEAK_FLOPS = 989e12
PEAK_FLOPS_F32 = 67e12
PEAK_BYTES = 3.35e12

SOURCES = ("adain_head", "composite", "composite_ad", "hashgrad")
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "encode_head": ("adain_head", "aip_tpu/ops/pallas/adain_head.py:174"),
    "decode_tail": ("adain_head", "aip_tpu/ops/pallas/adain_head.py:278"),
    "composite_macro_mxu_seg": ("composite", "aip_tpu/ops/pallas/composite.py:442"),
    "composite_macro_mxu": ("composite", "aip_tpu/ops/pallas/composite.py:509"),
    "composite_ad_fwd": ("composite_ad", "aip_tpu/ops/pallas/composite_ad.py:184"),
    "composite_ad_bwd": ("composite_ad", "aip_tpu/ops/pallas/composite_ad.py:211"),
    "hash_grad": ("hashgrad", "aip_tpu/ops/pallas/hashgrad.py:74"),
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

    # 2. build: one nvcc per source, all started together ---------------------
    def timed_build(name):
        t0 = time.perf_counter()
        return _build.build(name), time.perf_counter() - t0

    with ThreadPoolExecutor(len(SOURCES)) as pool:
        built = dict(zip(SOURCES, pool.map(timed_build, SOURCES)))
    WORK.mkdir(parents=True, exist_ok=True)
    for name, (report, build_s) in built.items():
        (WORK / f"build_{name}.log").write_text(report)
        emit("build", source=f"aip_tpu_torch/csrc/{name}.cu", seconds=build_s,
             compiled=bool(report),
             registers=[l.strip() for l in report.splitlines()
                        if "registers" in l or "spill" in l])

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
            "name": name, "route": "cuda", "source": f"aip_tpu_torch/csrc/{KERNELS[name][0]}.cu",
            "replaces": KERNELS[name][1], "launches": launches[name],
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
    del content, x, y
    torch.cuda.empty_cache()

    # 9-14. stylized 3DGS inference render -------------------------------------
    gs_lines, bed = _gs_phases(torch, dev)
    lines += gs_lines
    # 15-20. stylized 3DGS training ----------------------------------------------
    lines += _train_phases(torch, dev, bed)
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


# ---------------------------------------------------------------------------
# Stylized 3DGS inference render (phases 9-14)
# ---------------------------------------------------------------------------

BED = ROOT / "docs" / "examples" / "bed_0037_r5"
GS_WORK = WORK / "3dgs"
GS_SPANS = ("gs.project", "gs.select", "gs.gather", "gs.composite")
ROW_BYTES = 64          # one packed [16] float32 row
PAIR_FLOPS = 15         # float32 operations per (row, pixel) pair, the exp counted as one


def _gs_phases(torch, dev):
    """Phases 9-14. Returns the compositors' lines of the kernels table and
    what the training phases reuse: the committed model on the card, its
    800^2 frame function, the orbit cameras and the style."""
    import numpy as np
    from PIL import Image

    from aip_tpu_torch.gs import compress, pipeline
    from aip_tpu_torch.gs import rasterizer as R
    from aip_tpu_torch.gs import render as GR
    from aip_tpu_torch.gs.cameras import Camera, focal2fov, fov2focal
    from aip_tpu_torch.gs.colorfield import precompute_features
    from aip_tpu_torch.gs.dataset import Scene
    from aip_tpu_torch.kernels import adain_head as KA
    from aip_tpu_torch.kernels import composite as KC
    from aip_tpu_torch.pipelines.adain_infer import get_style_embeddings

    plain = {"composite_macro_mxu_seg": KC.composite_macro_mxu_seg_reference,
             "composite_macro_mxu": KC.composite_macro_mxu_reference}

    # 9. scenes ---------------------------------------------------------------
    t0 = time.perf_counter()
    model_dir, style_png = _write_bed_scene(np, Image)
    cfg = json.loads((model_dir / "cfg_args.json").read_text())
    sel = cfg["selection"]
    state, field, _, _ = compress.load_npz(model_dir / "model.npz", device=dev)
    load_s = time.perf_counter() - t0
    cams = Scene(cfg["source_path"], shuffle=False).getTrainCameras()
    style_f = get_style_embeddings(str(style_png), device=dev).mean(dim=(1, 2))
    enc = precompute_features(field, state.xyz)
    bg = torch.zeros(3, device=dev)
    n_bed = state.capacity

    def bed_fn(settings):
        return GR.make_inference_frame_fn(state, field, settings, bg, style_f=style_f,
                                          precomputed_enc=enc)

    def branch(n, settings):
        return "segment" if R.uses_segment_path(n, settings) else "windowed"

    fn_800 = bed_fn(GR.settings_from_selection(sel, 800, 800, max_per_tile=sel["max_per_tile"]))
    fog_state, fog_sh, fog_cam = _fog(torch, np, Camera, dev)
    fog_fn = GR.make_inference_frame_fn(
        fog_state, None, R.RasterSettings(1088, 1920, max_per_tile=128, chunk=8192, macro=4,
                                          macro_capacity=1152, dup_span=2,
                                          composite_backend="mxu"),
        bg, sh_override=fog_sh)
    emit("gs_scenes", model=str(BED.relative_to(ROOT)), gaussians=n_bed, selection=sel,
         cameras=len(cams), size=[cams[0].image_height, cams[0].image_width],
         load_and_decode_s=load_s, fog_gaussians=fog_state.capacity,
         branch={"bed_0037_800": branch(n_bed, fn_800.settings),
                 "fog_1088x1920": branch(fog_state.capacity, fog_fn.settings)})

    # 10. compositor kernels vs plain -------------------------------------------
    served = {}
    with _capture(KC, "composite_macro_mxu", served):
        GR.render_frame(fn_800, cams[0])
    with _capture(KC, "composite_macro_mxu_seg", served):
        GR.render_frame(fog_fn, fog_cam)
    torch.cuda.synchronize()
    main_err = {}
    for name, (args, kw) in served.items():
        main_err[name] = _composite_check(torch, name, getattr(KC, name), plain[name], args, kw,
                                          "served")
    for name, (args, kw), case in _edge_cases(np, torch, KC, dev):
        _composite_check(torch, name, getattr(KC, name), plain[name], args, kw, case)

    # 11. main path, windowed: run_3dgs_rendering on the committed model -------
    out_dir = GS_WORK / "renders"
    shutil.rmtree(out_dir, ignore_errors=True)
    KC.reset_launch_counts()
    KA.reset_launch_counts()
    t0 = time.perf_counter()
    gif = Path(pipeline.run_3dgs_rendering(str(style_png), str(model_dir),
                                           output_dir=str(out_dir), device=dev))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    win_launches = {**KC.launch_counts(), **KA.launch_counts()}
    pngs = sorted(out_dir.glob("*.png"))
    drawn = [float((np.abs(np.asarray(Image.open(p), np.int16)).max(axis=-1) > 1).mean())
             for p in pngs]
    emit("gs_main_windowed", entry="aip_tpu_torch.gs.pipeline.run_3dgs_rendering",
         gif=str(gif.relative_to(ROOT)), gif_exists=gif.is_file(), pngs=len(pngs),
         size=list(np.asarray(Image.open(pngs[0])).shape) if pngs else None,
         drawn_fraction_min=min(drawn, default=0.0), wall_s=wall_s,
         branch=branch(n_bed, fn_800.settings), launches=win_launches)
    if not (gif.is_file() and len(pngs) == len(cams) == 8 and min(drawn) > 0.1
            and win_launches["composite_macro_mxu"] >= 8):
        raise AssertionError("run_3dgs_rendering did not render the model through the "
                             "windowed kernel")

    # 12. main path, segment walk: the 1080p fog --------------------------------
    KC.reset_launch_counts()
    img = GR.render_frame(fog_fn, fog_cam)
    torch.cuda.synchronize()
    seg_launches = KC.launch_counts()
    emit("gs_main_segment", entry="make_inference_frame_fn + render_frame",
         out_shape=list(img.shape), finite=bool(torch.isfinite(img).all()),
         mean=img.mean().item(), branch=branch(fog_state.capacity, fog_fn.settings),
         launches=seg_launches)
    if not (img.shape == (1088, 1920, 3) and torch.isfinite(img).all()
            and seg_launches["composite_macro_mxu_seg"] > 0
            and seg_launches["composite_macro_mxu"] == 0):
        raise AssertionError("the fog did not render through the segment kernel alone")

    # 13. card vs CPU, float32, 256^2 -------------------------------------------
    c0 = cams[0]
    cam256 = Camera(colmap_id=0, R=c0.R, T=c0.T, FoVx=c0.FoVx, FoVy=c0.FoVy,
                    image=np.zeros((256, 256, 3), np.float32), image_name="c256", uid=0)
    s256 = GR.settings_from_selection(sel, 256, 256, max_per_tile=sel["max_per_tile"])
    KC.reset_launch_counts()
    on_card = GR.render_frame(bed_fn(s256), cam256).cpu()
    card_launches = KC.launch_counts()
    st_cpu, fd_cpu = state.to("cpu"), field.to("cpu")
    fn_cpu = GR.make_inference_frame_fn(st_cpu, fd_cpu, s256, bg.cpu(), style_f=style_f.cpu(),
                                        precomputed_enc=precompute_features(fd_cpu, st_cpu.xyz))
    on_cpu = GR.render_frame(fn_cpu, cam256)
    diff = (on_card - on_cpu).abs()
    emit("gs_card_vs_cpu", size=256, mean_abs=diff.mean().item(), max_abs=diff.max().item(),
         tol_mean_abs=1e-4, launches_on_card=card_launches,
         branch=branch(n_bed, fn_cpu.settings))
    if not (diff.mean().item() <= 1e-4 and sum(card_launches.values()) > 0):
        raise AssertionError("card and CPU disagree on the 3DGS render")
    del st_cpu, fd_cpu, fn_cpu

    # 14. times -----------------------------------------------------------------
    blank = np.zeros((1088, 1920, 3), np.float32)
    cams_1080 = [Camera(colmap_id=0, R=c.R, T=c.T, FoVx=c.FoVx,
                        FoVy=focal2fov(fov2focal(c.FoVx, 1920), 1088), image=blank,
                        image_name=c.image_name, uid=0) for c in cams]
    fitted_fns = {}
    for label, cs in (("bed_0037_800", cams), ("bed_0037_1088x1920", cams_1080)):
        fsel = GR.fit_selection(state, cs, hi=8192)
        fn = bed_fn(GR.settings_from_selection(
            fsel, cs[0].image_height, cs[0].image_width, max_per_tile=fsel["max_per_tile"],
            macro=4, composite_backend="mxu"))
        fitted_fns[label] = fn
        frame = _cycle(GR.render_frame, fn, cs)
        for _ in cs:  # warm every pose
            frame()
        KC.reset_launch_counts()
        ms = _time_ms(torch, frame)
        emit("gs_frame_time", scene=label, fitted_selection=fsel, ms=ms, fps=1e3 / ms,
             branch=branch(n_bed, fn.settings),
             launches_per_frame={k: v / 12 for k, v in KC.launch_counts().items()})
    ms = _time_ms(torch, lambda: GR.render_frame(fog_fn, fog_cam))
    emit("gs_frame_time", scene="fog_1088x1920", ms=ms, fps=1e3 / ms,
         branch=branch(fog_state.capacity, fog_fn.settings))

    lines = []
    per_frame = {"composite_macro_mxu": win_launches["composite_macro_mxu"] / len(pngs),
                 "composite_macro_mxu_seg": seg_launches["composite_macro_mxu_seg"]}
    main_launches = {"composite_macro_mxu": win_launches["composite_macro_mxu"],
                     "composite_macro_mxu_seg": seg_launches["composite_macro_mxu_seg"]}
    for name in ("composite_macro_mxu_seg", "composite_macro_mxu"):
        args, kw = served[name]
        nbytes, pairs, rows = _composite_work(KC, name, args, kw)
        t_comp, t_mem = pairs * PAIR_FLOPS / PEAK_FLOPS_F32, nbytes / PEAK_BYTES
        lines.append({
            "name": name, "route": "cuda", "source": f"aip_tpu_torch/csrc/{KERNELS[name][0]}.cu",
            "replaces": KERNELS[name][1], "launches": main_launches[name],
            "max_abs_err": main_err[name],
            "ms": _time_ms(torch, lambda: getattr(KC, name)(*args, **kw)),
            "plain_ms": _time_ms(torch, lambda: plain[name](*args, **kw)),
            "bound_ms": max(t_comp, t_mem) * 1e3,
            "bound_by": "operations" if t_comp >= t_mem else "bytes",
            "library_ms": None,
        })
        emit("gs_kernel_work", kernel=name, served_by="fog_1088x1920" if "seg" in name
             else "bed_0037_800", launches_per_frame=per_frame[name], rows_walked=rows,
             pairs=pairs, bytes=nbytes, flops=pairs * PAIR_FLOPS,
             definition=("pairs = sum over blocks of the rows walked up to the early exit "
                         "(counted by the plain version) x bs^2; operations = 15 float32 per "
                         "pair at 67 TFLOP/s (H100 SXM, CUDA cores); bytes = the walked 64-byte "
                         "rows, counts and starts read once, the planes written once, at "
                         "3.35 TB/s"),
             library_ms_reason="no single PyTorch call composites depth-sorted Gaussians")
    _gs_profile(torch, _cycle(GR.render_frame, fitted_fns["bed_0037_1088x1920"], cams_1080))
    return lines, dict(cams=cams, fn_800=fn_800, state=state, style_f=style_f,
                       style_png=style_png)


def _write_bed_scene(np, Image, size=800, n_cams=8, fov=0.8):
    """A Blender-format camera set around the committed model (blank
    images), a model directory whose cfg_args.json points at it, and a style
    image from a seed. The orbit circles the z axis at 25 degrees elevation,
    at the distance where the sphere holding 80 % of the splats spans the
    field of view."""
    scene, model = GS_WORK / "scene", GS_WORK / "model"
    (scene / "images").mkdir(parents=True, exist_ok=True)
    model.mkdir(parents=True, exist_ok=True)
    xyz = np.load(BED / "model.npz")["xyz"].astype(np.float64)
    center = np.median(xyz, axis=0)
    dist = np.percentile(np.linalg.norm(xyz - center, axis=1), 80) / math.tan(fov / 2)
    blank = Image.fromarray(np.zeros((size, size, 3), np.uint8))
    elev = math.radians(25)
    frames = []
    for k in range(n_cams):
        a = 2 * math.pi * k / n_cams
        pos = center + dist * np.array([math.cos(a) * math.cos(elev),
                                        math.sin(a) * math.cos(elev), math.sin(elev)])
        fwd = (center - pos) / np.linalg.norm(center - pos)
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        c2w = np.eye(4)  # OpenGL axes: x right, y up, the camera looking down -z
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, np.cross(right, fwd), -fwd, pos
        blank.save(scene / "images" / f"r_{k}.png")
        frames.append({"file_path": f"./images/r_{k}", "transform_matrix": c2w.tolist()})
    (scene / "transforms_train.json").write_text(
        json.dumps({"camera_angle_x": fov, "frames": frames}))
    cfg = json.loads((BED / "cfg_args.json").read_text())
    cfg["source_path"] = str(scene)
    (model / "cfg_args.json").write_text(json.dumps(cfg))
    shutil.copyfile(BED / "model.npz", model / "model.npz")
    style = GS_WORK / "style.png"
    rgb = np.random.default_rng(0).random((256, 256, 3))
    Image.fromarray((rgb * 255).astype(np.uint8)).save(style)
    return model, style


def _fog(torch, np, Camera, dev, n=100_000):
    """scripts/bench_gs.py's 100k-Gaussian fog (numpy seed 0, mixed
    opacities) as a GaussianState, its colours as degree-0 SH, and its
    1088x1920 camera."""
    from aip_tpu_torch.gs.gaussians import GaussianState
    from aip_tpu_torch.ops.sh import C0

    rng = np.random.default_rng(0)
    means = (rng.random((n, 3)) * 2 - 1).astype(np.float32)
    scales = (rng.random((n, 3)) * 0.01 + 0.003).astype(np.float32)
    quats = rng.standard_normal((n, 4)).astype(np.float32)
    opac = (rng.random(n) * 0.8 + 0.1).astype(np.float32)
    colors = rng.random((n, 3)).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    state = GaussianState(
        xyz=t(means), scaling=t(np.log(scales)), rotation=t(quats),
        opacity=t(np.log(opac / (1 - opac))[:, None]), mask=t(np.ones((n, 1), np.float32)),
        active=torch.ones(n, dtype=torch.bool, device=dev),
        max_radii2d=torch.zeros(n, device=dev), xyz_grad_accum=torch.zeros(n, 1, device=dev),
        denom=torch.zeros(n, 1, device=dev))
    sh = np.zeros((n, 16, 3), np.float32)
    sh[:, 0] = (colors - 0.5) / C0   # SH -> RGB adds 0.5 back
    cam = Camera(colmap_id=0, R=np.eye(3), T=np.array([0.0, 0.0, 3.0]), FoVx=1.2, FoVy=0.8,
                 image=np.zeros((1088, 1920, 3), np.float32), image_name="fog", uid=0)
    return state, t(sh), cam


class _capture:
    """Within the block, record the arguments of the first call of
    ``module.<name>`` (the kernel wrapper, which still runs)."""

    def __init__(self, module, name, store):
        self.module, self.name, self.store = module, name, store

    def __enter__(self):
        orig = self.orig = getattr(self.module, self.name)

        def spy(*args, **kw):
            self.store.setdefault(self.name, (args, kw))
            return orig(*args, **kw)

        spy.launches = 0  # the wrapper counts on its module's name, here the spy
        setattr(self.module, self.name, spy)

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def _composite_check(torch, name, kernel, plain, args, kw, case):
    out = kernel(*args, **kw)
    torch.cuda.synchronize()
    ref = plain(*args, **kw)
    err = (out - ref).abs()
    tol_max = 1e-3 * max(1.0, ref.abs().max().item())
    emit("gs_kernel_vs_plain", kernel=name, case=case, in_shape=list(args[0].shape),
         out_shape=list(out.shape), max_abs_err=err.max().item(),
         mean_abs_err=err.mean().item(), tol_max_abs=tol_max, tol_mean_abs=1e-5)
    if not (out.shape == ref.shape and err.max().item() <= tol_max
            and err.mean().item() <= 1e-5):
        raise AssertionError(f"{name} ({case}) disagrees with its plain version")
    return err.max().item()


def _edge_cases(np, torch, KC, dev, bs=64, mtw=3, mth=2, kc=200):
    """Segments with counts 0, 37 and 129, segments that start mid-group, a
    count above kc, and a block that is opaque after ten rows; the same
    blocks as a window."""
    g = np.random.default_rng(3)
    n = 1400
    rows = np.zeros((n, 16), np.float32)
    rows[:, 0] = g.random(n) * mtw * bs
    rows[:, 1] = g.random(n) * mth * bs
    sig = g.random(n) * 6 + 1.5
    rows[:, 2] = 1.0 / sig ** 2
    rows[:, 3] = (g.random(n) - 0.5) * 0.2 / sig ** 2
    rows[:, 4] = 1.0 / (sig * (g.random(n) + 0.5)) ** 2
    rows[:, 5] = np.log(g.random(n) * 0.9 + 0.05)
    rows[:, 6:9] = g.random((n, 3))
    rows[700:710, 0:6] = [(4 % mtw + 0.5) * bs, (4 // mtw + 0.5) * bs, 1e-4, 0.0, 1e-4, 0.0]
    starts = torch.tensor([0, 5, 250, 450, 700, 1000], dtype=torch.int32, device=dev)
    counts = torch.tensor([0, 37, 200, 129, 200, 260], dtype=torch.int32, device=dev)
    table = torch.from_numpy(rows).to(dev)
    bg = torch.tensor([0.2, 0.1, 0.3], device=dev)
    geo = dict(bs=bs, mtw=mtw)
    clipped = torch.clamp(counts, max=kc)
    window = KC._segment_window(table, starts, clipped, kc).contiguous()
    return [("composite_macro_mxu_seg", ((table, starts, counts, bg),
                                         dict(n_blocks=mtw * mth, kc=kc, **geo)), "edge"),
            ("composite_macro_mxu", ((window, clipped, bg), geo), "edge")]


def _composite_work(KC, name, args, kw):
    """(bytes, pairs, rows walked) of one compositor call, as the plain
    version counts the early exit."""
    if name == "composite_macro_mxu_seg":
        table, starts, counts, bg = args
        window = KC._segment_window(table, starts, counts, kw["kc"])
        index_bytes = 8 * counts.numel()
    else:
        window, counts, bg = args
        index_bytes = 4 * counts.numel()
    bs = kw["bs"]
    rows = KC.walked_rows(window, counts, bg, bs, kw["mtw"])
    out_bytes = counts.numel() * 3 * bs * bs * 4
    return rows * ROW_BYTES + index_bytes + out_bytes, rows * bs * bs, rows


def _cycle(render_frame, fn, cams):
    """A zero-argument frame that renders the next camera each call."""
    state = {"i": 0}

    def frame():
        cam = cams[state["i"] % len(cams)]
        state["i"] += 1
        return render_frame(fn, cam)

    return frame


def _gs_profile(torch, frame, calls=3):
    """torch.profiler over ``calls`` frames after a warm-up: the device time
    of each rasterizer stage, the rest, the heaviest kernels, and the
    device's busy share of the host's wall time. A stage's time is the
    device time of the PyTorch ops inside its record_function span; the
    compositor kernels, launched through ctypes and so linked to no op, are
    the composite stage by their kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    frame()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            frame()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    by_name = {}
    for e in events:
        if e.device_type == DeviceType.CUDA and e.name not in GS_SPANS:
            us, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    busy_us = sum(us for us, _ in by_name.values())
    stages = {name: 0.0 for name in GS_SPANS}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name in stages:
            stages[e.name] += e.device_time_total
    stages["gs.composite"] += sum(us for name, (us, _) in by_name.items()
                                  if "composite_macro_kernel" in name)
    ms = {k: v / 1e3 / calls for k, v in stages.items()}
    ms["rest"] = busy_us / 1e3 / calls - sum(ms.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    measured = busy_us > 0 and stages["gs.project"] > 0
    emit("gs_profile", scene="bed_0037_1088x1920", calls=calls,
         wall_ms_per_frame=wall_us / 1e3 / calls,
         device_ms_per_frame=busy_us / 1e3 / calls if busy_us else "not measured",
         device_busy_share=busy_us / wall_us if busy_us else "not measured",
         stage_device_ms=ms if measured else "not measured",
         kernels=[{"name": name[:100], "ms_per_frame": us / 1e3 / calls,
                   "launches_per_frame": n / calls} for name, (us, n) in top])


# ---------------------------------------------------------------------------
# Stylized 3DGS training (phases 15-20)
# ---------------------------------------------------------------------------

TRAIN_WORK = WORK / "train"
AD_FWD_PAIR_FLOPS = 25    # float32 operations per (slot, pixel) of kernel A, the exp as one
AD_BWD_PAIR_FLOPS = 70    # kernel B: the alpha rebuilt, the chain rule, the 9-term reduction
HASH_POINT_LEVEL_FLOPS = 60   # kernel C per (point, level): corners, weights, 16 products/adds
TRAIN_SPANS = ("gs.field", "gs.project", "gs.select", "gs.gather", "gs.composite", "gs.loss",
               "gs.adam", "gs.stats")
TRAIN_SIZE = 800          # the orbit views' size (phase 9's cameras)
N_OBJECT, N_BACKGROUND = 16_000, 84_000   # the initial cloud: the object and the far points
ORBIT_SCALE = 1.5         # the training orbit's distance over phase 9's
# The shortened schedule of phase 18: GSTrainConfig's defaults otherwise.
SCHEDULE = dict(iterations=60, freeze_iters=40, densify_from_iter=10, densification_interval=10,
                densify_until_iter=45, opacity_reset_interval=25, mask_prune_iter=10,
                net_lr_step=(20, 40, 55))


def _train_phases(torch, dev, bed):
    """Phases 15-20. Returns the lines of kernels A, B and C."""
    import numpy as np
    from PIL import Image

    from aip_tpu_torch.cli import run_3dgs
    from aip_tpu_torch.gs import gaussians as G
    from aip_tpu_torch.gs import pipeline
    from aip_tpu_torch.gs import train as T
    from aip_tpu_torch.gs.cameras import Camera
    from aip_tpu_torch.gs.colorfield import _encode_terms
    from aip_tpu_torch.gs.dataset import Scene
    from aip_tpu_torch.kernels import composite as KC
    from aip_tpu_torch.kernels import composite_ad as KAD
    from aip_tpu_torch.kernels import hashgrad as KH

    scene_dir = _write_train_scene(np, Image, bed)
    scene = Scene(str(scene_dir), shuffle=False)
    cams = scene.getTrainCameras()
    ext = scene.cameras_extent
    cfg = T.GSTrainConfig(**SCHEDULE)
    pcd = scene.point_cloud
    bg = torch.zeros(3, device=dev)
    style_f = bed["style_f"]

    # 15. kernels A and B on a real 800^2 selection --------------------------------
    trainer = T.init_trainer(cfg, pcd.points, pcd.colors, ext, seed=0, device=dev)
    step = T.make_train_step(cfg, ext, "photometric", TRAIN_SIZE, TRAIN_SIZE)
    arrays = T.camera_to_arrays(cams[0], device=dev)
    served = {}
    with _capture(KAD, "composite_ad_fwd", served), _capture(KAD, "composite_ad_bwd", served), \
            _capture(KH, "hash_grad", served):
        step(trainer, arrays, style_f, bg)
    torch.cuda.synchronize()
    fwd_args, bwd_args = served["composite_ad_fwd"][0], served["composite_ad_bwd"][0]
    n_tiles, k = fwd_args[0].shape[:2]
    n_valid = int(fwd_args[4].sum().item())
    emit("train_scene", scene=str(scene_dir.relative_to(ROOT)), cameras=len(cams),
         size=[cams[0].image_height, cams[0].image_width], points=len(pcd.points),
         capacity=cfg.capacity, table=[16, 1 << cfg.log2_hashmap, 2], style_dim=cfg.style_dim,
         settings=step.settings._asdict(), tiles=n_tiles, slots=k, valid_slots=n_valid)
    checked = _ad_check(torch, KAD, fwd_args, bwd_args, "served")
    ad_err = {"composite_ad_fwd": checked["fwd"], "composite_ad_bwd": checked["bwd"]}
    _ad_check(torch, KAD, *_ad_edge_cases(np, torch, KAD, dev), "edge")

    # 16. kernel C at full width ----------------------------------------------------
    x01, g_out, shape = served["hash_grad"][0]
    out = KH.hash_grad(x01, g_out, shape)
    torch.cuda.synchronize()
    ref = KH.hash_grad_reference(x01, g_out, shape)
    c_err = (out - ref).abs().max().item()
    c_tol = 1e-4 * ref.abs().max().item()
    emit("hash_grad_vs_plain", points=x01.shape[0], table=list(shape), max_abs_err=c_err,
         max_abs_ref=ref.abs().max().item(), tol=c_tol, nonzero_rows=int((ref != 0).any(-1).sum()))
    if not c_err <= c_tol:
        raise AssertionError(f"hash_grad disagrees with index_add_: {c_err} > {c_tol}")
    del out, ref

    # 17. one training step, card against the port on the CPU, 128^2 ---------------
    _card_vs_cpu_step(torch, np, T, G, Camera, Image, scene_dir, cams, pcd, ext, style_f, dev)

    # 18. training at full width --------------------------------------------------
    model_dir = TRAIN_WORK / "model"
    shutil.rmtree(model_dir, ignore_errors=True)
    trace = {}
    for mod in (KAD, KH, KC):
        mod.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipeline.run_3dgs_training(str(scene_dir), str(bed["style_png"]), model_path=str(model_dir),
                               cfg=cfg, progress_every=0, device=dev, trace=trace)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = {**KAD.launch_counts(), **KH.launch_counts()}
    peak = torch.cuda.max_memory_allocated()
    steps = trace["steps"]
    photo = [loss for _, ph, loss, _ in steps if ph == "photometric"]
    by_phase = {}
    for _, ph, _, ms in steps:
        by_phase.setdefault(ph, []).append(ms)
    ev = trace["events"]
    emit("train_full_width", entry="aip_tpu_torch.gs.pipeline.run_3dgs_training",
         schedule=SCHEDULE, steps=len(steps), events=ev,
         loss_curve=[round(loss, 6) for _, _, loss, _ in steps],
         first5_photometric=float(np.mean(photo[:5])), last5_photometric=float(np.mean(photo[-5:])),
         median_step_ms={ph: statistics.median(v) for ph, v in by_phase.items()},
         launches=train_launches,
         launches_per_step={k_: v / len(steps) for k_, v in train_launches.items()},
         peak_memory_gib=peak / 2**30, wall_s=train_s,
         storage=(model_dir / "storage").read_text().splitlines())
    fired = ("photometric_steps", "style_steps", "densify_events", "cloned", "split", "pruned",
             "opacity_reset", "recompact", "rvq_qat_start", "mask_prune_events")
    missing = [e for e in fired if ev.get(e, 0) <= 0]
    if missing or "final_mask_pruned" not in ev:
        raise AssertionError(f"events that never fired: {missing}")
    if not (np.isfinite([loss for _, _, loss, _ in steps]).all()
            and np.mean(photo[-5:]) < np.mean(photo[:5])):
        raise AssertionError("the photometric loss did not fall")
    if min(train_launches.values()) < len(steps):
        raise AssertionError(f"a training kernel was not launched every step: {train_launches}")
    KC.reset_launch_counts()
    gif = Path(pipeline.run_3dgs_rendering(str(bed["style_png"]), str(model_dir),
                                           output_dir=str(model_dir / "renders"), device=dev))
    torch.cuda.synchronize()
    pngs = sorted((model_dir / "renders").glob("*.png"))
    render_launches = KC.launch_counts()
    emit("train_render", gif=str(gif.relative_to(ROOT)), gif_exists=gif.is_file(),
         pngs=len(pngs), launches=render_launches)
    # From 512^2 up the inference render takes the macro-block compositors.
    macro = TRAIN_SIZE * TRAIN_SIZE >= 512 * 512
    if not (gif.is_file() and len(pngs) == len(cams)
            and (sum(render_launches.values()) > 0 or not macro)):
        raise AssertionError("the trained model did not render")

    # 19. the CLI: train a few iterations, then render -------------------------------
    cli_out = TRAIN_WORK / "cli"
    shutil.rmtree(cli_out, ignore_errors=True)
    for mod in (KAD, KH):
        mod.reset_launch_counts()
    t0 = time.perf_counter()
    cli_gif = Path(run_3dgs.main(["--content", str(scene_dir), "--style", str(bed["style_png"]),
                                  "--output", str(cli_out), "--iterations", "4",
                                  "--freeze_iters", "2"]))
    torch.cuda.synchronize()
    cli_launches = {**KAD.launch_counts(), **KH.launch_counts()}
    emit("train_cli", entry="aip_tpu_torch.cli.run_3dgs.main", iterations=4,
         gif=str(cli_gif.relative_to(ROOT)), gif_exists=cli_gif.is_file(),
         model=(cli_out / "model.npz").is_file(), launches=cli_launches,
         wall_s=time.perf_counter() - t0)
    if not (cli_gif.is_file() and min(cli_launches.values()) >= 4):
        raise AssertionError("the CLI did not train through the kernels and render")

    # Times of A, B and C on the inputs the main path gave them --------------------
    lines = []
    bound = _ad_bound(fwd_args, n_valid)
    timed = {
        "composite_ad_fwd": (lambda: KAD.composite_ad_fwd(*fwd_args),
                             lambda: KAD.composite_ad_fwd_reference(*fwd_args), None),
        "composite_ad_bwd": (lambda: KAD.composite_ad_bwd(*bwd_args),
                             lambda: KAD.composite_ad_bwd_reference(*bwd_args), None),
    }
    idx, w = _encode_terms(shape, x01)
    vals = (w[..., None] * g_out.reshape(x01.shape[0], shape[0], 1, shape[2])).reshape(-1, shape[2])
    flat = idx.reshape(-1)
    table = torch.zeros((shape[0] * shape[1], shape[2]), device=dev)
    timed["hash_grad"] = (lambda: KH.hash_grad(x01, g_out, shape),
                          lambda: KH.hash_grad_reference(x01, g_out, shape),
                          lambda: table.index_add_(0, flat, vals))
    bound["hash_grad"] = _hash_bound(x01, shape)
    errs = {**ad_err, "hash_grad": c_err}
    for name, (kern, plain, lib) in timed.items():
        t_comp, t_mem = bound[name]
        lines.append({
            "name": name, "route": "cuda", "source": f"aip_tpu_torch/csrc/{KERNELS[name][0]}.cu",
            "replaces": KERNELS[name][1], "launches": train_launches[name],
            "max_abs_err": errs[name],
            "ms": _time_ms(torch, kern), "plain_ms": _time_ms(torch, plain),
            "bound_ms": max(t_comp, t_mem) * 1e3,
            "bound_by": "operations" if t_comp >= t_mem else "bytes",
            "library_ms": None if lib is None else _time_ms(torch, lib),
        })
        emit("train_kernel_work", kernel=name, flops=t_comp * PEAK_FLOPS_F32,
             bytes=t_mem * PEAK_BYTES, launches_per_step=train_launches[name] / len(steps),
             definition=_BOUND_NOTES[name])
    del idx, w, vals, flat, table

    # 20. profile of one photometric and one style step --------------------------------
    guide = np.asarray(Image.open(model_dir / "stylized" / f"{cams[0].image_name}.jpg")
                       .convert("RGB").resize((TRAIN_SIZE, TRAIN_SIZE), Image.BILINEAR),
                       np.float32) / 255.0
    style_arrays = T.camera_to_arrays(cams[0], image=guide, device=dev)
    for phase, cam_arrays in (("photometric", arrays), ("style", style_arrays)):
        fn = T.make_train_step(cfg, ext, phase, TRAIN_SIZE, TRAIN_SIZE)
        _train_profile(torch, phase, lambda: fn(trainer, cam_arrays, style_f, bg))
    return lines


_BOUND_NOTES = {
    "composite_ad_fwd": ("operations = 25 float32 per (valid slot, pixel) at 67 TFLOP/s; bytes = "
                         "the gathered [T,K,10] inputs read once, image and T_final written once"),
    "composite_ad_bwd": ("operations = 70 float32 per (valid slot, pixel) at 67 TFLOP/s; bytes = "
                         "inputs, T_final and the upstream gradient read once, the [T,K,9] "
                         "gradients written once"),
    "hash_grad": ("operations = 60 float32 per (point, level); bytes = x01 and the upstream "
                  "gradient read once, the [L,T,F] table written once (atomics not counted)"),
}


def _write_train_scene(np, Image, bed):
    """The training scene: the 8 orbit cameras of phase 9 moved out to 1.5
    times their distance from the model (the object fills about two thirds
    of each view, and the scene extent, which scales the densification
    rule's size split between clone and split, grows with the orbit), with
    the port's own 800^2 inference renders of the committed model as
    images, and a points3d.ply of 100k points from numpy seed 0. 16k are
    drawn from the model's active positions, so the cloud covers the
    object; 84k are sparse far points in a wide slab above every camera
    (outside all views, as a COLMAP cloud's far points are), whose kNN
    scales exceed a tenth of the scene extent. The first densification
    after the opacity reset interval prunes them, so the live count falls
    below a quarter of the capacity and the capacity buckets recompact (the
    bucket rule keeps twice the live count: at 100k live splats a 2^17
    capacity never shrinks)."""
    from aip_tpu_torch.gs.dataset import Scene, write_ply
    from aip_tpu_torch.gs.render import render_frame

    scene = TRAIN_WORK / "scene"
    shutil.rmtree(scene, ignore_errors=True)
    (scene / "images").mkdir(parents=True)
    rng = np.random.default_rng(0)
    state = bed["state"]
    xyz = state.xyz[state.active].cpu().numpy().astype(np.float64)
    obj = xyz[rng.choice(len(xyz), N_OBJECT, replace=False)]
    center = np.median(xyz, axis=0)
    meta = json.loads((GS_WORK / "scene" / "transforms_train.json").read_text())
    blank = Image.fromarray(np.zeros((TRAIN_SIZE, TRAIN_SIZE, 3), np.uint8))
    for f in meta["frames"]:
        c2w = np.array(f["transform_matrix"])
        c2w[:3, 3] = center + ORBIT_SCALE * (c2w[:3, 3] - center)
        f["transform_matrix"] = c2w.tolist()
        blank.save(scene / (f["file_path"].lstrip("./") + ".png"))
    (scene / "transforms_train.json").write_text(json.dumps(meta))
    dist = float(np.linalg.norm(np.array(meta["frames"][0]["transform_matrix"])[:3, 3] - center))
    back = np.empty((N_BACKGROUND, 3))
    back[:, :2] = center[:2] + (rng.random((N_BACKGROUND, 2)) * 2 - 1) * 24 * dist
    back[:, 2] = center[2] + (2 + rng.random(N_BACKGROUND) * 4) * dist
    pts = np.concatenate([obj, back]).astype(np.float32)
    write_ply(scene / "points3d.ply", pts, rng.integers(0, 256, (len(pts), 3)))
    for cam in Scene(str(scene), shuffle=False).getTrainCameras():
        img = render_frame(bed["fn_800"], cam).clamp(0, 1).cpu().numpy()
        Image.fromarray((img * 255).astype(np.uint8)).save(scene / "images" / f"{cam.image_name}.png")
    return scene


def _ad_check(torch, KAD, fwd_args, bwd_args, case):
    """Kernels A and B against their plain versions on one input: the image
    and T_final at 1e-5 absolute, each gradient at 1e-4 of its largest
    value (the same float32 walks; B reduces the 256 pixels in another
    order). Returns the largest absolute errors, {"fwd": .., "bwd": ..}."""
    out, tf = KAD.composite_ad_fwd(*fwd_args)
    grads = KAD.composite_ad_bwd(*bwd_args)
    torch.cuda.synchronize()
    ref_out, ref_tf = KAD.composite_ad_fwd_reference(*fwd_args)
    ref_grads = KAD.composite_ad_bwd_reference(*bwd_args)
    f_err = max((out - ref_out).abs().max().item(), (tf - ref_tf).abs().max().item())
    rel = [(a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
           for a, b in zip(grads, ref_grads)]
    b_err = max((a - b).abs().max().item() for a, b in zip(grads, ref_grads))
    emit("composite_ad_vs_plain", case=case, in_shape=list(fwd_args[0].shape),
         fwd_max_abs_err=f_err, fwd_tol=1e-5,
         bwd_max_rel_err=dict(zip(("mean", "conic", "color", "opacity"), rel)), bwd_tol_rel=1e-4,
         t_final_min=tf.min().item())
    if not (f_err <= 1e-5 and max(rel) <= 1e-4):
        raise AssertionError(f"composite_ad kernels disagree with the plain version ({case})")
    return {"fwd": f_err, "bwd": b_err}


def _ad_edge_cases(np, torch, KAD, dev, k=128, tile_w=4):
    """8 tiles of K slots around each tile's pixels: tile 1 empty (every
    slot invalid), tile 2 saturating below T = 1e-4, tile 3 a splat at the
    0.99 clamp and one of opacity 0, tile 4 invalid slots between valid
    ones, tile 5 only its first slot valid. Returns the forward's and the
    backward's arguments, with an upstream gradient from seed 5."""
    g = np.random.default_rng(5)
    n = 8
    t = np.arange(n)
    x0 = ((t % tile_w) * 16).astype(np.float32)[:, None]
    y0 = ((t // tile_w) * 16).astype(np.float32)[:, None]
    mean = np.stack([x0 + g.random((n, k)) * 20 - 2, y0 + g.random((n, k)) * 20 - 2], -1)
    sig = g.random((n, k)) * 4 + 1.5
    conic = np.stack([1 / sig ** 2, (g.random((n, k)) - 0.5) * 0.3 / sig ** 2,
                      1 / (sig * (g.random((n, k)) + 0.6)) ** 2], -1)
    color = g.random((n, k, 3))
    op = g.random((n, k, 1)) * 0.7 + 0.1
    valid = np.ones((n, k, 1))
    valid[1] = 0.0
    conic[2, :, 0] = conic[2, :, 2] = 1e-3
    conic[2, :, 1] = 0.0
    op[2] = 0.98
    mean[3, 0] = [x0[3, 0] + 7.5, y0[3, 0] + 7.5]
    op[3, 0] = 1.0
    op[3, 1] = 0.0
    valid[4, ::3] = 0.0
    valid[5, 1:] = 0.0
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    args = [f(a) for a in (mean, conic, color, op, valid)] + [f([0.2, 0.5, 0.1])]
    _, t_final = KAD.composite_ad_fwd_reference(*args, tile_w)
    g_out = f(g.standard_normal((n, 3, 16, 16)))
    return (*args, tile_w), (*args, t_final, g_out, tile_w)


def _ad_bound(fwd_args, n_valid):
    """(operations s, bytes s) of kernels A and B on the served input."""
    n_tiles, k = fwd_args[0].shape[:2]
    pairs = n_valid * 256
    in_bytes = n_tiles * k * 10 * 4
    img_bytes = n_tiles * 256 * 4
    return {
        "composite_ad_fwd": (pairs * AD_FWD_PAIR_FLOPS / PEAK_FLOPS_F32,
                             (in_bytes + 4 * img_bytes) / PEAK_BYTES),
        "composite_ad_bwd": (pairs * AD_BWD_PAIR_FLOPS / PEAK_FLOPS_F32,
                             (in_bytes + 4 * img_bytes + n_tiles * k * 9 * 4) / PEAK_BYTES),
    }


def _hash_bound(x01, shape):
    n = x01.shape[0]
    l, t, f = shape
    return (n * l * HASH_POINT_LEVEL_FLOPS / PEAK_FLOPS_F32,
            (n * 3 * 4 + n * l * f * 4 + l * t * f * 4) / PEAK_BYTES)


def _card_vs_cpu_step(torch, np, T, G, Camera, Image, scene_dir, cams, pcd, ext, style_f, card):
    """Phase 17: one photometric step at 128^2 (3,000 points of the cloud's
    object part, capacity 4,096, a 2^16 table so that kernel C runs; the
    other settings GSTrainConfig's defaults) from
    one trainer, on the card and on the CPU. The loss at 1e-4 relative;
    every parameter group's gradient (Adam's first moment after one step is
    0.1 g) and the screen-space offset's gradient at 1e-3 of their largest
    entry: float32 sums in other orders, atomics in kernel C."""
    from aip_tpu_torch.kernels import composite_ad as KAD
    from aip_tpu_torch.kernels import hashgrad as KH

    rng = np.random.default_rng(1)
    img = Image.open(scene_dir / "images" / f"{cams[0].image_name}.png").convert("RGB")
    img = np.asarray(img.resize((128, 128), Image.BILINEAR), np.float32) / 255.0
    c = cams[0]
    cam = Camera(colmap_id=0, R=c.R, T=c.T, FoVx=c.FoVx, FoVy=c.FoVy, image=img,
                 image_name="c128", uid=0)
    cfg = T.GSTrainConfig(capacity=4096, log2_hashmap=16)
    pick = rng.choice(N_OBJECT, min(3000, N_OBJECT), replace=False)
    trainer = T.init_trainer(cfg, pcd.points[pick], pcd.colors[pick], ext, seed=0, device="cpu")
    gs = trainer.gstate
    # Anisotropic, rotated splats, so that every group has a gradient.
    gs = gs._replace(
        scaling=gs.scaling + torch.from_numpy(rng.normal(0, 0.3, (4096, 3)).astype(np.float32)),
        rotation=torch.from_numpy(rng.standard_normal((4096, 4)).astype(np.float32)))
    trainer = trainer._replace(gstate=gs)
    res = []
    for dev in ("cpu", card):
        tr = G.tree_map(lambda t: t.to(dev) if t.ndim else t, trainer)
        step = T.make_train_step(cfg, ext, "photometric", 128, 128)
        stats = {}
        KAD.reset_launch_counts()
        KH.reset_launch_counts()
        with _capture(G, "add_densification_stats", stats):
            new, metrics = step(tr, T.camera_to_arrays(cam, device=dev), style_f.to(dev),
                                torch.zeros(3, device=dev))
        torch.cuda.synchronize()
        launches = {**KAD.launch_counts(), **KH.launch_counts()}
        grads = {k: v.cpu() / 0.1 for k, v in {**new.opt_g.mu, **new.opt_net.mu}.items()}
        grads["screenspace_offset"] = stats["add_densification_stats"][0][1].cpu()
        res.append((metrics["loss"].item(), grads))
    (l_cpu, g_cpu), (l_gpu, g_gpu) = res
    errs = {k: (g_gpu[k] - g_cpu[k]).abs().max().item() / max(g_cpu[k].abs().max().item(), 1e-30)
            for k in g_cpu}
    loss_err = abs(l_gpu - l_cpu) / abs(l_cpu)
    emit("train_card_vs_cpu", size=128, capacity=4096, table=[16, 1 << 16, 2], loss_cpu=l_cpu,
         loss_card=l_gpu, loss_rel_err=loss_err, grad_rel_err=errs, tol_loss=1e-4, tol_grad=1e-3,
         launches_on_card=launches)
    if not (loss_err <= 1e-4 and max(errs.values()) <= 1e-3 and min(launches.values()) >= 1):
        raise AssertionError("a training step on the card disagrees with the CPU")


def _train_profile(torch, phase, fn):
    """torch.profiler over one training step after a warm-up: device time
    by stage and the device's busy share of the host's wall time. A stage
    is the device time of the ops inside its record_function span (colour
    field forward, projection, selection, gather, loss, Adam, statistics);
    kernels A, B and C by their kernel names (the profiler links a ctypes
    launch to the enclosing span or autograd node; they are taken out of
    it); the backward's gather transpose (IndexSelectBackward: the
    scatter-add into per-Gaussian arrays, an index_add_) and the rest of
    the backward by the autograd nodes the engine ran."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    by_name = {}
    for e in events:
        if e.device_type == DeviceType.CUDA and e.name not in TRAIN_SPANS:
            us, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    busy_us = sum(us for us, _ in by_name.values())
    stages = {name: 0.0 for name in TRAIN_SPANS}
    stages.update({"kernel A": 0.0, "kernel B": 0.0, "kernel C": 0.0,
                   "backward scatter-add": 0.0, "backward other": 0.0})
    named = (("kernel A", "composite_ad_fwd"), ("kernel B", "composite_ad_bwd"),
             ("kernel C", "hash_grad"))

    def subtree_us(e):
        """Device time of the kernels an op and its children launched,
        kernels A, B and C left out (they are stages of their own)."""
        own = sum(k.duration for k in e.kernels if not any(p in k.name for _, p in named))
        return own + sum(subtree_us(c) for c in e.cpu_children)

    node = "autograd::engine::evaluate_function: "
    for e in events:
        if e.device_type != DeviceType.CPU:
            continue
        if e.name in TRAIN_SPANS:
            stages[e.name] += subtree_us(e)
        elif e.name.startswith(node):
            op = e.name[len(node):]
            key = "backward scatter-add" if op.startswith("Index") else "backward other"
            stages[key] += subtree_us(e)
    for name, (us, _) in by_name.items():
        for key, pat in named:
            if pat in name:
                stages[key] += us
    ms = {k: v / 1e3 for k, v in stages.items()}
    ms["rest"] = busy_us / 1e3 - sum(ms.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    measured = busy_us > 0 and stages["gs.project"] > 0
    emit("train_profile", step=phase, wall_ms=wall_us / 1e3,
         device_ms=busy_us / 1e3 if busy_us else "not measured",
         device_busy_share=busy_us / wall_us if busy_us else "not measured",
         stage_device_ms=ms if measured else "not measured",
         kernels=[{"name": name[:100], "ms": us / 1e3, "launches": n} for name, (us, n) in top])


if __name__ == "__main__":
    main()
