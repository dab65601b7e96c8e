#!/usr/bin/env python3
"""Build and drive the PyTorch port (``aip_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. device: CUDA is required; the card's name and power limit as nvidia-smi
   reports them are printed on a line of their own.
2. build: every source in ``SOURCES`` (``aip_tpu_torch/csrc/*.cu``)
   compiled with nvcc for sm_90a, all at once, with ptxas's register,
   spill and shared-memory report.
3. kernel vs plain, for each AdaIN kernel wrapper, with TF32 off for fp32
   convs and matmuls: fp32 (the three-TF32 kernels of ``adain_head.cu``)
   against the fp32 plain version (max abs <= 1e-4 * max|ref|) and against
   the plain version run in float64 (max abs <= 1.5e-6 * max|ref|, printed
   beside the fp32 plain version's own error against float64), at batch 2
   on 512^2 and 37x45 (tail: 256^2 and 19x23 in), batch 32 x 512^2 and
   batch 1 x 512x683 (tail: 256x342 in); bf16 (the kernels of
   ``adain_head_tc.cu``) against the plain version in fp32 on the same
   bf16-rounded inputs and weights (<= 1e-2 * max|ref|) and against the
   bf16 plain version, which rounds where the TPU kernel does (max abs <=
   2^-7 * max|ref|, one bf16 ulp at the largest value, and mean abs <= 1e-4
   * max|ref|), at batch 2 on 512^2 and 37x45 and at the serving shape,
   batch 32 x 512^2; each launch took its dtype's route
   (``route_launch_counts``).
4. AdaIN serving path (a main path): ``precompute_style_stats`` +
   ``stylize_with_stats``, batch 32, 512^2, bf16, alpha 0.5, with every
   launch count set to 0 just before and read just after; every launch
   took the bf16 route.
5. end to end in fp32 on one 256^2 image (the fp32 kernels' path): the
   card (kernels) against the port on the CPU (plain path), mean abs <=
   1e-3, every launch on the fp32 route; then once more with PyTorch's
   default TF32 flags (cuDNN's fp32 convs in TF32), as the CLI runs, mean
   abs <= 1e-3 too.
6. CLI: ``aip_tpu_torch.cli.run_depth.main`` on PNGs written from a seed,
   plain and ``--use_depth``.
7. times at batch 32 x 512^2 (CUDA events): the serving path's images/s
   (median of 10 after a warm-up); each bf16 kernel over 100 calls in one
   window; each fp32 kernel at batch 32 and at batch 1 x 512^2, as the
   median of 10 single calls and over 100 calls in one window; each with
   its plain version's time, the same chain as cuDNN calls
   (``library_ms``, timed here only, TF32 off), its bound, achieved TFLOP/s
   and share of the bound (fp32: the fp32-accurate tensor-core bound, three
   TF32 products an operation, beside the CUDA-core bound); and one cuDNN
   64->64 3x3 conv alone on channels_last bf16 (``conv64_cudnn_ms``, a yardstick for
   the dominant conv).
8. profile: torch.profiler over three serving calls and over one fp32
   ``stylize_simple`` call at batch 1 x 512^2, device time by kernel and
   the device's busy share; the calls repack no weights (the cached packs
   of both routes are the same objects after them).

Stylized 3DGS inference render, on the committed trained model
``docs/examples/bed_0037_r5`` (130,968 Gaussians, its recorded selection)
and on the 1080p fog of ``scripts/bench_gs.py`` (100k Gaussians from numpy
seed 0):

9.  scenes: a Blender-format camera set (8 cameras at 800^2, blank PNGs, on
    an orbit from which the model fills the frame), a model directory with
    ``cfg_args.json`` pointed at it, and a style PNG from a seed.
10. compositor kernels vs plain, float32, on the inputs the two main paths
    hand them (captured from one frame of each: the indexed entries, which
    read the rows through the selection's index) and on edge cases (counts
    0, counts not a multiple of 64, segments starting mid-group, a block
    that saturates early, a count above kc, bg != 0; through the
    JAX-signature wrappers and the indexed entries). Pass: max abs <= 1e-3
    * max(1, max|ref|) and mean abs <= 1e-5, because the kernel's
    sequential transmittance product and the plain version's
    exp(cumsum(log1p)) round differently, so the 1e-4 cutoff can flip at
    single pixels; and each indexed call equal (max abs 0) to the kernel
    on the gathered rows and to its walk emulated in plain torch.
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
    hi=8192)`` over the 8 cameras, and of the fog; both fitted scenes
    through both branches (the segment-or-windowed crossover, recorded
    only); each compositor on its served inputs: ms over 100 calls in one
    window (the kernels line) and a single call, plain ms, launches per
    frame, the dense bound (every walked pair) and the live bound (the
    pairs with alpha >= 1/255, ``bound_ms``), the share of walked (row,
    sub-tile) pairs the cull keeps at each sub-tile height, the layout
    sweep (sub-tile height and pixels a thread, each equal to the default
    bit for bit) and ptxas's registers and spills; a torch.profiler
    breakdown of one 1088x1920 frame of the committed model by stage, with
    the device's busy share.

Stylized 3DGS training, at full width (``GSTrainConfig``'s defaults: capacity
2^17, a 16 x 2^19 x 2 hash grid, style_dim 256, K 128, macro 4, kc 1024),
one view per step:

15. a training scene (the 8 orbit cameras of phase 9 moved out to 1.5 times
    their distance, the port's own 800^2 renders of the committed model as
    images, a 100k-point cloud from numpy seed 0); one photometric step captures the packed
    [2500, 128, 9] gather of the real 800^2 selection, on which kernels A
    (forward) and B (backward) are held against their plain versions, and
    on edge tiles (empty, saturating, the 0.99 clamp, opacity 0, invalid
    slots between valid ones, every slot valid and on top of each other).
    Image and T_final equal (max abs 0), gradients at 1e-4 of each one's
    largest value and 0 off the live list; the live share after the cull,
    and B against its emulation in plain torch (reported).
16. kernel C on the same step's x01 [131072, 3] and upstream gradient
    against its plain version (one ``index_add_``), at 1e-4 of the largest
    entry (atomics add thousands of contributions to the coarse levels'
    rows in another order): once, 20 times more, right after a NaN-filled
    table-sized block is freed (the kernel's table reuses it: every row
    that no contribution touches exactly 0, every entry finite), and at
    the shapes that reach the kernel's other paths (``HASH_SHAPES``: F = 1;
    F = 4, where dense level 0 does not fit shared memory and every level
    goes to global memory; 15 levels, a short last phase; a 2^10 table,
    every level summed in shared memory); the sort-based gradient of
    ``hash_encode_sg``
    (``sorted_table_grad``, plain PyTorch, no atomics) timed on the same
    inputs as a deterministic yardstick, its error reported.
17. one training step at 128^2 (capacity 4096, a 2^16 table) from one
    trainer on the card and on the CPU: the loss at 1e-4 relative, every
    parameter group's gradient and the screen-space offset's at 1e-3 of
    their largest entry.
18. training (a main path): ``gs.pipeline.run_3dgs_training`` for 60
    iterations with the schedule shortened so that every event fires
    (photometric then style steps, clone, split, prune, opacity reset,
    recompaction, the RVQ boundary, mask prunes), with the launch counts
    set to 0 just before and read just after; A's and B's arguments at the
    last photometric step (iteration 39, after the densify, prune and
    opacity-reset events) are captured and held as in phase 15; then
    ``run_3dgs_rendering`` of the saved model. Prints the events, the loss
    curve (the mean of the last 5 photometric losses must be below the
    first 5), the median step ms per phase (CUDA events), launches per step
    and peak memory.
19. the CLI: ``aip_tpu_torch.cli.run_3dgs.main`` for 4 iterations, which
    trains and then renders.
20. times of A, B and C on the served inputs (ms over 100 back-to-back
    calls in one CUDA-event window, beside the single-call figure; plain
    ms, bound, ``index_add_`` as C's library call); C's device ms from the
    profiler beside the window, and before -> after (the time PERF.md recorded for the kernel this one
    replaced) with the card's name and power limit; A and B on the late
    step's inputs too, and on both the P sweep (P = 1, 2, 4, 8 pixels a
    thread; every P agreeing with the default one) with the live share and
    ptxas's registers and spills; the device launches of one composite
    forward and backward, packed against the four-array form; and a
    torch.profiler breakdown of one photometric and one style step by
    stage (device ms and launches), with the busy share.

Video style transfer with TV-L1 temporal consistency, at the JAX package's
video workload: 96 frames at 256^2 of a smooth texture (numpy seed 0) that
moves by a known sub-pixel step each frame, 2 style images, depth on, the
AdaIN model in bf16, TV-L1 at its defaults (4 levels x 5 warps x 300
iterations), blend 0.7:

21. ``tvl1`` kernel vs plain, float32: on the inputs the 96-frame flow call
    hands each pyramid level (95 pairs at 256^2, 128^2, 64^2 and 32^2,
    captured from the first warp), 300 iterations, on random 128^2 and
    64^2 fields at 95 pairs and 300 iterations, and on edge cases (H or
    W = 2, H smaller than the tile form's halo, 37x45, frames just above
    the whole-frame limit, grad2 = 0 everywhere, iters 0, 1 and not a
    multiple of the tile form's k, B = 1); max abs 0: both round alike.
22. main path: ``pipelines.video.apply_style_transfer_multi_ada`` on the
    frame directory, with the launch counts set to 0 just before and read
    just after (tvl1 at least 300 iterations per level and warp on the
    kernel, in fewer launches; encode_head, decode_tail, every one of
    these two on the bf16 route); the 96
    PNGs exist; the flows' mean endpoint error against the known step over
    the interior <= 0.25 px. encode_head and decode_tail are then held
    against their plain versions, by phase 3's rule, on the arguments this
    call gave them (captured at each shape).
23. fast-stylizer path: ``use_magenta_stylizer(load_magenta_npz(...))``
    on the committed distilled checkpoint, then ``apply_style_transfer``
    on the same frames.
24. card vs CPU, fp32: 6 frames at 64^2 through the whole video call, and
    one magenta frame at 64^2, the card (kernels) against the port on the
    CPU (plain versions): frames mean abs <= 1e-3, flows mean abs <= 1e-4
    px, the magenta frame mean abs <= 1e-6; with TF32 off, then with
    PyTorch's default flags (cuDNN's fp32 convs in TF32 unless a call says
    otherwise); and, as a control that must fail the magenta gate, with
    the default flags and ``fp32_convs`` undone in the flow, Farneback,
    magenta and MobileNet modules (what TF32 does to those convs; the depth
    proxy's blur has no conv).
25. times: frames/s of the phase-22 call (host clock, median of 3) with its
    stages (CUDA events); per pyramid level the ``tvl1`` kernel's form
    (whole frame, or tile and k), ms per (level, warp) call, ms per
    iteration, launches per call and bound; the tile form's k in {4, 8,
    12, 16} at 256^2 and 128^2; its SASS instructions per pixel and
    iteration (cuobjdump); its plain ms; and a torch.profiler breakdown of
    one video call by stage with the busy share. Then the CLI,
    ``cli.run_video.main`` on 4 frames, where cv2 imports (the card's
    machine has none: a line says it did not run).

The other 3DGS render paths and the novel-view video, on the committed
model of phase 9 (kernels 5-7 of ``csrc/composite_walk.cu``):

26. the three walk kernels against their plain versions, max abs <= 1e-5
    (both round every per-pixel operation alike), the fused walk's at max
    abs 0, and kernels 5 and 7 against their dense twins (the cull off) at
    max abs 0: on the
    inputs the paths below hand them (captured from one frame of each, the
    fused walk's at 1088x1920 and at 800^2, where the last macro-block
    column holds 2 of 4 tiles; kernel 5's on each of the 8 cameras at
    1088x1920, kernel 7's on each of the 8 views at 800^2 and on the
    1088x1920 lists of rasterize_fast) and on edge cases (empty tiles and
    blocks, saturation, the 0.99 clamp, opacity below 1/255, invalid slots
    between valid ones, K = 1, lists longer than one staged chunk, counts
    that are no multiple of 32, blocks of 16, 32 and 64 px; fused lists of
    Kc = 2, 200 and 5120 at macro 1 to 5 with edge blocks; and splats just
    inside and just outside the 1/255 contour at a tile's and a sub-tile's
    corner, for kernels 5, 6 and 7).
27. main path, per-tile walk: ``run_3dgs_rendering(renderer="pallas")``
    over the 8 views at 800^2; the GIF and 8 PNGs exist, > 10 % of pixels
    differ from the background, ``composite_tiles`` ran >= 8 times and no
    other compositor ran.
28. main paths at 1088x1920 under ``fit_selection(..., hi=8192)``, macro 4:
    ``make_inference_frame_fn`` with ``composite_backend="pallas"`` (the
    coefficient walk alone) and ``rasterize_fused`` (the fused walk alone);
    then the three paths at 256^2 on the card against the port on the CPU,
    mean abs <= 1e-4.
29. ``gs.render_video.render_video``: 16 frames of the ellipse path, read
    back from the mp4; then ``cli.render_video.main`` with ``--circular``
    (4 frames) and ``--gaussians``.
30. times: ms per frame of the three paths at 800^2 and 1088x1920 (fitted
    selection, macro 4; CUDA events, median of 10), a torch.profiler
    breakdown of one 1088x1920 frame of each camera for each path with the
    busy share, and each kernel's ms (100 calls in one window), launches
    per frame, plain ms and bound; for the three culled walks the dense
    bound (every slot or row walked, at every pixel), the live bound (the
    pairs with alpha >= 1/255, ``bound_ms``), the share of pairs the cull
    keeps, ptxas's registers and spills, and before -> after (the time
    PERF.md recorded for the kernel this one replaced) with the path's
    frame device ms and the card's name and power limit; kernel 5 on each
    camera's inputs (its ``ms`` and ``bound_ms`` the medians over the 8
    cameras, beside the profile's per-frame composite ms); kernel 7's P
    sweep (P = 2, 4, 8, each equal to the default bit for bit), every
    view's window and the 1088x1920 lists of rasterize_fast.

Localized style transfer, DeepLabV3-ResNet101 and the 3DGS evaluation tools
(no new kernel; these paths run the fp32 AdaIN kernels and A, B, C and a
render compositor), on a 1024x768 content image from numpy seed 0 (a plain
border colour, a shaded object, noise) and a 512^2 style image:

31. main path, localized: ``run_localized_style_transfer`` on the card with
    the classical segmenter, under PyTorch's default TF32 flags, with the
    launch counts set to 0 just before and read just after (the fp32
    ``encode_head`` and ``decode_tail`` each launched); the mask keeps 20-80
    % background; the card's mask equals the CPU's except where the
    background probability lies within 1e-4 of 0.5 (counts printed); the
    combined array before the JPEG (the card's mask handed to the CPU run)
    within 1e-3 mean abs of the CPU's; the fp32 kernels held against their
    plain versions on the arguments the call gave them (phase 3's rule);
    the call's wall ms (median of 3) and a profile; then
    ``cli.run_semantic_segm.main``.
32. DeepLabV3-ResNet101 at full depth (101 layers, output stride 8, the
    port's deterministic init) on the same image in fp32: the card's logits
    against the port on the CPU, max abs over max |logit| <= DEEPLAB_TOL,
    with TF32 off and with PyTorch's default flags; a control with the
    defaults and ``fp32_convs`` undone in the DeepLab and ResNet modules,
    which must miss that limit; the segmenter registered with
    ``register_segmenter`` for one localized call on the card; the
    forward's ms (CUDA events, median of 10), FLOPs and a profile by op
    group with the busy share.
33. ``gs.full_eval.run_full_eval`` with both Deep Blending scene names on
    phase 18's training scene, 60 iterations (freeze 40) at full width: A,
    B, C and a render compositor launched; ``{model: {}}`` for both scenes,
    as the JAX package returns (the render step writes ``<model>/renders``,
    the metrics step reads ``<model>/test``); then
    ``<model>/test/ours_60/{renders,gt}`` from the 800^2 renders and the
    scene's images, ``gs.metrics_cli.evaluate`` with LPIPS (uniform lin
    weights, recorded); one 800^2 LPIPS VGG16 pair card against CPU under
    PyTorch's default flags, relative error <= 1e-5, and its ms.

The pixel-art page, optimisation NST and the style mixer (no new kernel; the
pixel-art page's AdaIN branch runs the fp32 AdaIN kernels), on a 1024x768
photograph-like image from numpy seed 0 (colour gradients, a shaded disc,
noise) and a 48x64 sprite from seed 0 (flat colours, rectangles, diagonal
lines, a 2x2 block whose diagonals cross, a one-pixel island). The checks of
these four phases are all made; any that fails raises after phase 37:

34. ``pipelines.pixel_art.pixelize`` at downsample 4 with brightness 0.05
    and contrast 0.2, with ``pico-8`` and ``sweetie-16`` and each of RGB,
    kd-tree, LAB and Floyd-Steinberg, and RGB and LAB at downsample 1: the
    card against the port on the CPU, equal except LAB, whose differing
    pixels must be near-ties (``_lab_picks``: the two picks' squared 8-bit
    LAB distances no further apart than the two devices' LAB values and the
    float32 distance's rounding can move them); each call's wall ms and the
    palette op's device ms; the Floyd-Steinberg wavefront's step count.
35. ``depixelize`` (host seconds; the same bytes in two calls and as the
    JAX package's raster of this sprite, by its sha256),
    ``depixelize_and_stylize(method="adain")`` at scale 10 with
    TF32 off and under PyTorch's default flags, the launch counts set to 0
    before and read after (the fp32 ``encode_head`` and ``decode_tail``
    launched), the image the call saves within STYLIZE_TOL mean abs of the
    CPU's, both kernels held against their plain versions on the arguments
    the call gave them (phase 3's rule); the ``"fast"`` branch on the
    committed magenta checkpoint, card against CPU; ``cli.run_vectorize``
    (equal to ``depixelize``) and ``cli.run_pixelize``.
36. optimisation NST at full width (VGG-19 to conv5_1, the reference's
    layers and weights; seeded weights): ``run_style_transfer`` on the
    1024x768 content at max_dim 1024, ``mix_styles`` with 3 styles at 256^2,
    ``spatially_varying_style_transfer`` with a seeded R/G/B mask and
    ``cli.run_nst.main``, each with its step count cut (NST_STEPS, printed
    beside the default) and its ms a step; card against CPU at 512^2: step
    1's loss within NST_LOSS_TOL relative with TF32 off and under PyTorch's
    defaults, its image gradient's errors printed (of the largest entry,
    relative L2, summed over 32^2 blocks) beside the CPU's own against
    float64 (near-ties of a 2x2 max route a few entries' gradient to a
    neighbour, so no fp32 gradient through the pools is within 1e-3 of the
    largest entry); the conv1_1 style term's gradient, which crosses no
    pool, within NST_GRAD_TOL of its largest entry, and a control with the
    backward outside ``fp32_convs`` that must miss that limit; the image
    after 10 steps within NST_10_STEP_TOL mean abs; a profile of one step at
    512^2 by kernel group, with the busy share.
37. ``pipelines.style_mixer.stylize_with_palette`` at 256^2 with each of
    ResNet, DenseNet, Swin and VGG (the iterations cut), ms an iteration;
    DenseNet-121 and Swin-T at full depth and width at 256^2, card against
    CPU under PyTorch's defaults, within NET_TOL of the largest |value|;
    ``map_colors`` (differing pixels only at LAB near-ties) and
    ``extract_palette`` from the same starting pixels (within PALETTE_TOL).

The trainers and MiDaS (slice 7; no new kernel: the fp32 head and tail run
on a training path, their backward recomputing through cuDNN convs), on 16
content and 16 style images at 512^2 (numpy seed 0):

38. ``cli.train_adain.main`` at the reference's defaults (VGG-19 to relu4_1
    and the 9-conv decoder at full width, batch 8, crop 256, fp32, style
    weight 10, lr 1e-4, decay 5e-5), 20 of 160,000 steps: the checkpoint
    and the log written, the fp32 head and tail launched once a step
    (counts set to 0 just before). Step 1 card against the port on the CPU:
    the loss within TRAIN_LOSS_TOL, the relu1_1 style term's decoder
    gradient (no max pool) within ``_fp32_gate`` (each parameter's relative
    L2 error within 1e-5 plus 4 times the CPU's own distance from float64
    there), with TF32 off, under PyTorch's defaults, and a control with the
    backward outside ``fp32_convs`` that must miss; the head and tail
    against their plain versions on the step's arguments (phase 3's rule);
    ms a step, one step's device ms by op group (``TRAIN_GROUPS``), the
    busy share, and the tail's recompute backward timed alone.
39. ``cli.train_magenta.main`` (the compact trunk, batch 8, crop 256, lr
    1e-3), 20 of 40,000 steps, the same checks (the pixel term's gradient:
    the stylizer alone, no max pool); the saved npz stylizes a 256^2 frame
    within MAGENTA_FP32_TOL mean abs of the CPU.
40. MiDaS-small at full width from the seeded init at the hub's 256^2,
    card against CPU within MIDAS_TOL, TF32 off and under the defaults, its
    forward ms; ``use_midas(None)`` then ``adain_inference(use_depth=True)``
    at 512^2 fp32 card against CPU within DEPTH_CALL_TOL mean abs, the fp32
    kernels launched, its wall and device ms; then the classical estimator
    put back and ``estimate_proximity`` equal to what it gave before.

The line before the last lists every kernel (``{"kernels": [...]}``); the
last line is ``{"ok": true, "device": {...}}``. AdaIN weights are the
port's deterministic random init (no checkpoint is committed); everything
the run writes goes under ``build/chip_smoke/`` in the checkout.
"""

import itertools
import json
import math
import os
import re
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
# HBM3; and an fp32-accurate product on the tensor cores, three TF32
# products (495 TFLOP/s dense) an operation.
PEAK_FLOPS = 989e12
PEAK_FLOPS_F32 = 67e12
PEAK_FLOPS_F32_TC = 495e12 / 3
PEAK_BYTES = 3.35e12
# The fp32 AdaIN kernels against their plain version run in float64, max abs
# over the largest value. On an H100 the kernels (a fresh partial sum a tap)
# read 5-7e-7 and the fp32 plain version 6-9e-7; one partial over all 9 taps
# read 2.5-5.1e-6 and misses this limit, as does a 3xbf16 split (5-7e-6,
# emulated on the CPU).
FP32_FLOAT64_TOL = 1.5e-6

SOURCES = ("adain_head", "adain_head_tc", "composite", "composite_ad", "hashgrad", "tvl1",
           "composite_walk")
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "encode_head": ("adain_head_tc", "aip_tpu/ops/pallas/adain_head.py:174"),
    "decode_tail": ("adain_head_tc", "aip_tpu/ops/pallas/adain_head.py:278"),
    "encode_head_fp32": ("adain_head", "aip_tpu/ops/pallas/adain_head.py:174"),
    "decode_tail_fp32": ("adain_head", "aip_tpu/ops/pallas/adain_head.py:278"),
    "composite_macro_mxu_seg": ("composite", "aip_tpu/ops/pallas/composite.py:442"),
    "composite_macro_mxu": ("composite", "aip_tpu/ops/pallas/composite.py:509"),
    "composite_macro_blocks": ("composite_walk", "aip_tpu/ops/pallas/composite.py:253"),
    "composite_from_macro": ("composite_walk", "aip_tpu/ops/pallas/composite.py:102"),
    "composite_tiles": ("composite_walk", "aip_tpu/ops/pallas/composite.py:154"),
    "composite_ad_fwd": ("composite_ad", "aip_tpu/ops/pallas/composite_ad.py:184"),
    "composite_ad_bwd": ("composite_ad", "aip_tpu/ops/pallas/composite_ad.py:211"),
    "hash_grad": ("hashgrad", "aip_tpu/ops/pallas/hashgrad.py:74"),
    "tvl1": ("tvl1", "aip_tpu/ops/pallas/tvl1.py:99"),
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
    default_tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    bf16, f32 = torch.bfloat16, torch.float32

    # 1. device --------------------------------------------------------------
    smi = _card()
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
                        if "registers" in l or "spill" in l or "Compiling entry" in l])
    tc, fp32 = _build.library("adain_head_tc"), _build.library("adain_head")
    emit("build_smem", sources=["aip_tpu_torch/csrc/adain_head_tc.cu",
                                "aip_tpu_torch/csrc/adain_head.cu"],
         dynamic_smem_bytes={"encode_head_tc_kernel": tc.aip_adain_head_tc_smem(0),
                             "decode_tail_tc_kernel": tc.aip_adain_head_tc_smem(1),
                             "encode_head_kernel": fp32.aip_adain_head_smem(0),
                             "decode_tail_kernel": fp32.aip_adain_head_smem(1)})

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
        "encode_head": (head_w, rand, [(2, 512, 512, 3), (2, 37, 45, 3)], (32, 512, 512, 3),
                        (1, 512, 683, 3)),
        "decode_tail": (tail_w, relu_randn, [(2, 256, 256, 64), (2, 19, 23, 64)],
                        (32, 256, 256, 64), (1, 256, 342, 64)),
    }
    main_err = {}
    for name, (ws, make, shapes, serving, wide) in cases.items():
        main_err[f"{name}_fp32"] = max(
            _adain_check(torch, K, name, make(*shape, dtype=f32), ws, "random")
            for shape in shapes + [serving, wide])
        torch.cuda.empty_cache()
        for shape in shapes + [serving]:
            err = _adain_check(torch, K, name, make(*shape, dtype=bf16), ws, "random")
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
    routes = K.route_launch_counts()
    emit("serving_path", batch=32, size=512, dtype="bfloat16", alpha=0.5,
         out_shape=list(out.shape), finite=bool(torch.isfinite(out).all()), launches=launches,
         route_launches=routes)
    if not (out.shape == (32, 512, 512, 3) and torch.isfinite(out).all()):
        raise AssertionError("serving path output is not finite or has the wrong shape")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the main path was not launched: {launches}")
    if routes["bf16"] != launches:
        raise AssertionError(f"a bf16 launch missed the bf16 route: {routes}")
    del out

    # 5. end to end, card vs CPU, fp32 --------------------------------------
    img, sty = rand(1, 256, 256, 3).cpu(), rand(1, 256, 256, 3).cpu()
    vgg_cpu = weights.from_jax_params(weights.hwio_params(vgg), "cpu")
    dec_cpu = weights.from_jax_params(weights.hwio_params(dec), "cpu")
    m, s = adain_infer.precompute_style_stats(vgg_cpu, sty, compute_dtype=f32, device="cpu")
    on_cpu = adain_infer.stylize_with_stats(vgg_cpu, dec_cpu, img, m, s, compute_dtype=f32,
                                            device="cpu")
    for flags, (tf32_conv, tf32_matmul) in (("tf32_off", (False, False)),
                                             ("pytorch_defaults", default_tf32)):
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = (
            tf32_conv, tf32_matmul)
        K.reset_launch_counts()
        m, s = adain_infer.precompute_style_stats(vgg, sty, compute_dtype=f32, device=dev)
        on_card = adain_infer.stylize_with_stats(vgg, dec, img, m, s, compute_dtype=f32,
                                                 device=dev).cpu()
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        card_launches = K.launch_counts()
        routes = K.route_launch_counts()
        diff = (on_card - on_cpu).abs()
        emit("end_to_end_fp32", size=256, flags=flags, tf32_conv=tf32_conv,
             tf32_matmul=tf32_matmul, mean_abs=diff.mean().item(), max_abs=diff.max().item(),
             launches_on_card=card_launches, route_launches=routes, tol_mean_abs=1e-3)
        if not (diff.mean().item() <= 1e-3 and min(card_launches.values()) > 0
                and routes["fp32"] == card_launches):
            raise AssertionError(f"card and CPU disagree end to end ({flags}), or an fp32 "
                                 f"launch missed the fp32 route: {routes}")
        if flags == "tf32_off":
            launches.update({f"{k}_fp32": n for k, n in card_launches.items()})

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
    x32, y32 = content, y.float()
    w_eff, b_eff = K.fold_rgb_conv(*[w.to(bf16).float() for w in head_w[:4]])
    lib_head = [w.to(bf16) for w in (w_eff, b_eff, head_w[4], head_w[5])]
    lib_tail = [w.to(bf16) for w in tail_w]
    w_eff32, b_eff32 = K.fold_rgb_conv(*head_w[:4])
    timed = {  # name -> (kernel, plain, library, its input); each a function of the input
        "encode_head": (lambda a: K.encode_head(a, *head_w),
                        lambda a: K.encode_head_bf16_reference(a, *head_w),
                        lambda a: _library_head(F, a, *lib_head), x),
        "decode_tail": (lambda a: K.decode_tail(a, *tail_w),
                        lambda a: K.decode_tail_bf16_reference(a, *tail_w),
                        lambda a: _library_tail(F, a, *lib_tail), y),
        "encode_head_fp32": (lambda a: K.encode_head(a, *head_w),
                             lambda a: K.encode_head_reference(a, *head_w),
                             lambda a: _library_head(F, a, w_eff32, b_eff32, *head_w[4:]), x32),
        "decode_tail_fp32": (lambda a: K.decode_tail(a, *tail_w),
                             lambda a: K.decode_tail_reference(a, *tail_w),
                             lambda a: _library_tail(F, a, *tail_w), y32),
    }
    lines = []
    for name, (kern, plain, lib, arg) in timed.items():
        fp32 = arg.dtype == f32
        # fp32: the serving batch and batch 1 (the CLI's and the style
        # embeddings' shape), each as single calls and in one window.
        for a in (arg, arg[:1].contiguous()) if fp32 else (arg,):
            flops, nbytes = (_head_work if name.startswith("encode") else _tail_work)(a)
            peak = PEAK_FLOPS_F32_TC if fp32 else PEAK_FLOPS
            t_comp, t_mem = flops / peak, nbytes / PEAK_BYTES
            ms = _time_many_ms(torch, lambda: kern(a), 100)
            line = {
                "name": name, "route": "cuda",
                "source": f"aip_tpu_torch/csrc/{KERNELS[name][0]}.cu",
                "replaces": KERNELS[name][1], "launches": launches[name],
                "max_abs_err": main_err[name],
                "ms": ms, "plain_ms": _time_ms(torch, lambda: plain(a)),
                "bound_ms": max(t_comp, t_mem) * 1e3,
                "bound_by": "operations" if t_comp >= t_mem else "bytes",
                "library_ms": _time_ms(torch, lambda: lib(a)),
            }
            extra = {}
            if fp32:
                extra = {"single_call_ms": _time_ms(torch, lambda: kern(a)),
                         "cuda_core_bound_ms": max(flops / PEAK_FLOPS_F32, t_mem) * 1e3,
                         "plain_ms": line["plain_ms"], "library_ms": line["library_ms"]}
            if a is arg:
                lines.append(line)
            emit("kernel_work", kernel=name, shape=list(a.shape), dtype=str(a.dtype)[6:],
                 flops=flops, bytes=nbytes, peak_flops=peak, peak_bytes_per_s=PEAK_BYTES,
                 ms=ms, timing="100 calls in one window", bound_ms=line["bound_ms"],
                 achieved_tflops=flops / ms / 1e9, bound_share=line["bound_ms"] / ms, **extra)
    torch.cuda.empty_cache()
    z = relu_randn(32, 512, 512, 64, dtype=bf16).permute(0, 3, 1, 2)  # channels_last
    w_conv = head_w[4].to(bf16).contiguous(memory_format=torch.channels_last)
    b_conv = head_w[5].to(bf16)
    conv_ms = _time_ms(torch, lambda: F.conv2d(z, w_conv, b_conv, padding=1))
    conv_flops = 2 * z.numel() * 64 * 9
    emit("conv64_cudnn", shape=list(z.shape), layout="channels_last", dtype="bfloat16",
         conv64_cudnn_ms=conv_ms, achieved_tflops=conv_flops / conv_ms / 1e9,
         definition="F.conv2d 64->64 3x3, zero padding 1, cuDNN; a yardstick for the "
                    "kernels' dominant conv, not their library_ms")
    del z, y32

    # 8. profile ------------------------------------------------------------
    kinds = {"encode_head": head_w, "decode_tail": tail_w,
             "encode_head_fp32": head_w, "decode_tail_fp32": tail_w}
    packs = {kind: K.packed_weights(kind, *ws) for kind, ws in kinds.items()}
    _profile(torch, lambda: adain_infer.stylize_with_stats(
        vgg, dec, content, style_mean, style_std, alpha=0.5, compute_dtype=bf16, device=dev))
    one, one_style = content[:1].contiguous(), style
    _profile(torch, lambda: adain_infer.stylize_simple(
        vgg, dec, one, one_style, alpha=0.5, compute_dtype=f32, device=dev), calls=1,
        label="fp32_call_profile", call="stylize_simple, batch 1 x 512^2, fp32")
    repacked = {kind: K.packed_weights(kind, *ws) is not packs[kind] for kind, ws in kinds.items()}
    emit("serving_packs", repacked_during_profile=repacked)
    if any(repacked.values()):
        raise AssertionError("a steady-state call repacked the kernels' weights")
    del content, x, y
    torch.cuda.empty_cache()

    # 9-14. stylized 3DGS inference render -------------------------------------
    gs_lines, bed = _gs_phases(torch, dev)
    lines += gs_lines
    # 15-20. stylized 3DGS training ----------------------------------------------
    lines += _train_phases(torch, dev, bed)
    torch.cuda.empty_cache()
    # 21-25. video style transfer -----------------------------------------------
    lines += _video_phases(torch, dev, default_tf32)
    torch.cuda.empty_cache()
    # 26-30. the other 3DGS render paths and the novel-view video -----------------
    lines += _walk_phases(torch, dev, bed)
    torch.cuda.empty_cache()
    # 31-33. localized style transfer, DeepLab, 3DGS evaluation -------------------
    _slice5_phases(torch, dev, default_tf32)
    torch.cuda.empty_cache()
    # 34-37. the pixel-art page, optimisation NST, the style mixer ------------------
    _slice6_phases(torch, dev, default_tf32)
    torch.cuda.empty_cache()
    # 38-40. AdaIN decoder training, magenta distillation, MiDaS -------------------
    by_path = _slice7_phases(torch, dev, default_tf32)
    for line in lines:
        if line["name"] in ("encode_head_fp32", "decode_tail_fp32"):
            line["launches_by_path"] = {path: counts[line["name"][:-5]]
                                        for path, counts in by_path.items()}
    print(json.dumps({"kernels": lines}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


def _adain_check(torch, K, name, x, ws, case):
    """The AdaIN kernel wrapper ``name`` against its plain version in fp32 on
    the same inputs and weights rounded to x's dtype: max abs <= 1e-4 (fp32)
    or 1e-2 (bf16) of the reference's largest value; an fp32 x also against
    the plain version run in float64 (max abs <= FP32_FLOAT64_TOL of its largest value,
    printed beside the fp32 plain version's own error against it); a bf16 x
    also against the bf16 plain version (max abs <= 2^-7 of its largest
    value, one bf16 ulp there, and mean abs <= 1e-4 of it). The launch must
    take x's route (``route_launch_counts``).
    Returns the error against the route's own plain version."""
    ws = [w.detach() for w in ws]
    bf16 = x.dtype == torch.bfloat16
    route = "bf16" if bf16 else "fp32"
    before = K.route_launch_counts()[route][name]
    out = getattr(K, name)(x, *ws)
    torch.cuda.synchronize()
    took_route = K.route_launch_counts()[route][name] - before == 1
    ref = getattr(K, f"{name}_reference")(x.float(), *[w.to(x.dtype).float() for w in ws])
    err = (out.float() - ref).abs().max().item()
    scale = ref.abs().max().item()
    tol = (1e-2 if bf16 else 1e-4) * scale
    ok = out.shape == ref.shape and err <= tol and took_route
    fields = {}
    if not bf16:
        ref64 = getattr(K, f"{name}_reference")(x.double(), *[w.double() for w in ws])
        fields = {"float64_max_abs_err": (out.double() - ref64).abs().max().item(),
                  "float64_tol": FP32_FLOAT64_TOL * ref64.abs().max().item(),
                  "plain_fp32_float64_max_abs_err": (ref.double() - ref64).abs().max().item()}
        del ref64
        ok = ok and fields["float64_max_abs_err"] <= fields["float64_tol"]
    else:
        ref = getattr(K, f"{name}_bf16_reference")(x, *ws).float()
        diff, scale16 = (out.float() - ref).abs(), ref.abs().max().item()
        fields = {"bf16_plain_max_abs_err": diff.max().item(), "bf16_plain_tol": 2 ** -7 * scale16,
                  "bf16_plain_mean_abs_err": diff.mean().item(),
                  "bf16_plain_mean_tol": 1e-4 * scale16}
        ok = (ok and fields["bf16_plain_max_abs_err"] <= fields["bf16_plain_tol"]
              and fields["bf16_plain_mean_abs_err"] <= fields["bf16_plain_mean_tol"])
    emit("kernel_vs_plain", kernel=name, case=case, shape=list(x.shape), dtype=str(x.dtype)[6:],
         route=route if took_route else "another", out_shape=list(out.shape), max_abs_err=err,
         max_abs_ref=scale, tol=tol, **fields)
    if not ok:
        raise AssertionError(f"{name} {list(x.shape)} {x.dtype} ({case}) failed: "
                             f"error {err} > {tol}, {fields} or the wrong route")
    return fields["bf16_plain_max_abs_err"] if bf16 else err


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


def _time_many_ms(torch, fn, n, warmup=3):
    """One CUDA-event window around ``n`` back-to-back calls of ``fn``,
    divided by ``n``, after a warm-up. The host queues calls ahead of the
    device, so a short kernel is timed by the device rather than by its
    wrapper's checks and allocations (while those stay shorter than it)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def _profile(torch, fn, calls=3, label="serving_profile", **fields):
    """torch.profiler over ``calls`` calls of ``fn`` after a warm-up: device
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
    emit(label, **fields, calls=calls, wall_ms_per_call=wall_us / 1e3 / calls,
         device_ms_per_call=busy_ms / calls if by_name else "not measured",
         device_busy_share=busy_ms * 1e3 / wall_us if by_name else "not measured",
         kernels=[{"name": name[:100], "ms_per_call": ms / calls, "launches_per_call": n / calls}
                  for name, (ms, n) in top])


def _stage_profile(torch, label, fn, stages, named=(), stage_of=None, calls=1, **fields):
    """torch.profiler over ``calls`` calls of ``fn`` after a warm-up, per
    call: each stage's device time, the rest, the heaviest kernels and the
    device's busy share of the host's wall time (one stream: kernel
    durations do not overlap). Returns the device ms per call and each
    stage's.

    A CPU event that ``stage_of`` maps to a stage (by default a
    record_function span named in ``stages``) takes the kernels that it and
    its children launched; an inner stage's event takes its own. Each
    correlation id is credited once: kineto links a kernel to every CPU
    event of its launch's id, and a launch that blocks gets a second one
    ("Command Buffer Full", "Activity Buffer Request"). Kernels launched
    through ctypes are linked to no op of their stage: ``named``, pairs of
    (stage, kernel-name pattern), credits them by name instead."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    stage_of = stage_of or (lambda name: name if name in stages else None)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    by_name = {}
    for e in events:  # kernels and copies, not the spans' device-side annotations
        if (e.device_type == DeviceType.CUDA and e.name not in stages
                and not getattr(e, "is_user_annotation", False)):
            us, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    busy_us = sum(us for us, _ in by_name.values())
    device_us = dict.fromkeys(stages, 0.0)
    launches = dict.fromkeys(stages, 0)
    credited, credited_us = set(), {}

    def walk(e, stage):
        stage = stage_of(e.name) or stage
        if stage is not None and e.kernels and e.id not in credited:
            credited.add(e.id)
            for k in e.kernels:
                if not any(p in k.name for _, p in named):
                    device_us[stage] += k.duration
                    launches[stage] += 1
                    credited_us[k.name] = credited_us.get(k.name, 0.0) + k.duration
        for c in e.cpu_children:
            walk(c, stage)

    for e in events:
        if e.device_type == DeviceType.CPU and e.cpu_parent is None:
            walk(e, None)
    for name, (us, n) in by_name.items():
        stage = next((s for s, p in named if p in name), None)
        if stage is not None:
            device_us[stage] += us
            launches[stage] += n
    ms = {k: v / 1e3 / calls for k, v in device_us.items()}
    ms["rest"] = busy_us / 1e3 / calls - sum(ms.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    measured = busy_us > 0 and sum(device_us.values()) > 0
    # A negative rest: the kernels credited for more time than they ran.
    over = {name[:100]: (us - by_name.get(name, (0.0, 0))[0]) / 1e3 / calls
            for name, us in credited_us.items() if us > by_name.get(name, (0.0, 0))[0] + 1e-3}
    emit(label, **fields, calls=calls, wall_ms_per_call=wall_us / 1e3 / calls,
         device_ms_per_call=busy_us / 1e3 / calls if busy_us else "not measured",
         device_busy_share=busy_us / wall_us if busy_us else "not measured",
         stage_device_ms_per_call=ms if measured else "not measured",
         stage_launches_per_call={k: v / calls for k, v in launches.items()},
         device_launches_per_call=sum(n for _, n in by_name.values()) / calls,
         over_credited_ms_per_call=over,
         kernels=[{"name": name[:100], "ms_per_call": us / 1e3 / calls,
                   "launches_per_call": n / calls} for name, (us, n) in top])
    return (busy_us / 1e3 / calls if busy_us else "not measured"), (ms if measured else {})


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
    """The head as cuDNN calls on x's NHWC memory (channels_last), in x's
    dtype, RGB conv folded."""
    t = x.permute(0, 3, 1, 2)
    t = F.relu(F.conv2d(F.pad(t, (1, 1, 1, 1), mode="reflect"), w_eff, b_eff))
    t = F.relu(F.conv2d(F.pad(t, (1, 1, 1, 1), mode="reflect"), w2, b2))
    return F.max_pool2d(t, 2, 2, ceil_mode=True)


def _library_tail(F, y, w2, b2, w1, b1):
    """The tail as cuDNN calls on y's NHWC memory (channels_last), in y's
    dtype."""
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
    # The rasterizer calls the indexed entries (the kernel reads the rows
    # through the selection's index); their plain version gathers the rows
    # and runs the JAX-signature wrapper's.
    served = {}
    with _capture(KC, "composite_macro_mxu_indexed", served):
        GR.render_frame(fn_800, cams[0])
    with _capture(KC, "composite_macro_mxu_seg_indexed", served):
        GR.render_frame(fog_fn, fog_cam)
    torch.cuda.synchronize()
    main_err = {}
    for iname, (args, kw) in served.items():
        name = _gathered(KC, iname, args)[0]
        main_err[name] = _indexed_check(torch, KC, plain, iname, args, kw, "served")
    for name, (args, kw), case in _edge_cases(np, torch, KC, dev):
        if name.endswith("_indexed"):
            _indexed_check(torch, KC, plain, name, args, kw, case)
        else:
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
    fitted_fns, fitted_sel = {}, {}
    for label, cs in (("bed_0037_800", cams), ("bed_0037_1088x1920", cams_1080)):
        fsel = fitted_sel[label] = GR.fit_selection(state, cs, hi=8192)
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
    # The segment-or-windowed crossover on this card: each fitted scene
    # through both branches (frame ms over the cameras, and the kernel on
    # camera 0's inputs). Recorded only; _SEG_SLOT_RATIO stays the JAX
    # package's, so both packages take the same branch.
    for label, cs in (("bed_0037_800", cams), ("bed_0037_1088x1920", cams_1080)):
        fn, ratio = fitted_fns[label], R._SEG_SLOT_RATIO
        for forced, r in (("segment", math.inf), ("windowed", 0.0)):
            R._SEG_SLOT_RATIO = r
            try:
                taken = branch(n_bed, fn.settings)
                iname = ("composite_macro_mxu_seg_indexed" if taken == "segment"
                         else "composite_macro_mxu_indexed")
                cap = {}
                with _capture(KC, iname, cap):
                    GR.render_frame(fn, cs[0])
                frame = _cycle(GR.render_frame, fn, cs)
                for _ in cs:
                    frame()
                frame_ms = _time_ms(torch, frame)
            finally:
                R._SEG_SLOT_RATIO = ratio
            args, kw = cap[iname]
            emit("gs_crossover", scene=label, forced=forced, branch=taken, frame_ms=frame_ms,
                 kernel=iname, kernel_ms_100_calls=_time_many_ms(
                     torch, lambda: getattr(KC, iname)(*args, **kw), MANY_CALLS),
                 seg_slot_ratio=ratio)

    lines = []
    per_frame = {"composite_macro_mxu": win_launches["composite_macro_mxu"] / len(pngs),
                 "composite_macro_mxu_seg": seg_launches["composite_macro_mxu_seg"]}
    main_launches = {"composite_macro_mxu": win_launches["composite_macro_mxu"],
                     "composite_macro_mxu_seg": seg_launches["composite_macro_mxu_seg"]}
    for iname in ("composite_macro_mxu_seg_indexed", "composite_macro_mxu_indexed"):
        args, kw = served[iname]
        name, gargs = _gathered(KC, iname, args)
        nbytes, pairs, rows, live = _composite_work(KC, name, gargs, kw)
        t_dense, t_live = pairs * PAIR_FLOPS / PEAK_FLOPS_F32, live * PAIR_FLOPS / PEAK_FLOPS_F32
        t_mem = nbytes / PEAK_BYTES
        kernel = (lambda: getattr(KC, iname)(*args, **kw))
        ms = _time_many_ms(torch, kernel, MANY_CALLS)
        base = kernel()
        sweep = {}
        for lay in KC.LAYOUTS[kw["bs"]]:
            out = getattr(KC, iname)(*args, **kw, layout=lay)
            torch.cuda.synchronize()
            sweep[f"16x{lay[0]} p={lay[1]}"] = {
                "ms_100_calls": _time_many_ms(
                    torch, lambda: getattr(KC, iname)(*args, **kw, layout=lay), MANY_CALLS),
                "max_abs_vs_default": (out - base).abs().max().item(),
                **KC.macro_layout(kw["bs"], *lay)}
        if max(v["max_abs_vs_default"] for v in sweep.values()) != 0.0:
            raise AssertionError(f"{iname}: a layout of the sweep differs from the default")
        line = {
            "name": name, "route": "cuda", "source": f"aip_tpu_torch/csrc/{KERNELS[name][0]}.cu",
            "replaces": KERNELS[name][1], "launches": main_launches[name],
            "max_abs_err": main_err[name], "ms": ms,
            "plain_ms": _time_ms(torch, lambda: plain[name](*_gathered(KC, iname, args)[1],
                                                            **kw)),
            "bound_ms": max(t_live, t_mem) * 1e3,
            "bound_by": "operations" if t_live >= t_mem else "bytes",
            "library_ms": None,
        }
        lines.append(line)
        window = (KC._segment_window(gargs[0], gargs[1], gargs[2], kw["kc"]) if "seg" in name
                  else gargs[0])
        emit("gs_kernel_work", kernel=name, entry=iname,
             served_by="fog_1088x1920" if "seg" in name else "bed_0037_800",
             launches_per_frame=per_frame[name], rows_walked=rows, pairs=pairs,
             live_pairs=live, live_share=live / max(pairs, 1), bytes=nbytes,
             flops=pairs * PAIR_FLOPS, ms_100_calls=ms, ms_single_call=_time_ms(torch, kernel),
             dense_bound_ms=max(t_dense, t_mem) * 1e3, live_bound_ms=line["bound_ms"],
             share_of_live_bound=line["bound_ms"] / ms,
             share_of_dense_bound=max(t_dense, t_mem) * 1e3 / ms,
             kept_row_sub_tile_share=_sub_tile_shares(torch, KC, window, gargs[-2], gargs[-1],
                                                      kw["bs"], kw["mtw"]),
             layout_sweep=sweep, ptxas=_composite_ptxas(),
             definition=("pairs = sum over blocks of the rows walked up to the early exit "
                         "(counted by the plain version) x bs^2, live pairs = those with "
                         "alpha >= 1/255; operations = 15 float32 per pair at 67 TFLOP/s "
                         "(H100 SXM, CUDA cores): the dense bound counts every pair, the live "
                         "bound (bound_ms) the live ones; bytes = the walked 64-byte rows, "
                         "counts and starts read once, the planes written once, at 3.35 TB/s"),
             library_ms_reason="no single PyTorch call composites depth-sorted Gaussians")
        del window
    _stage_profile(torch, "gs_profile",
                   _cycle(GR.render_frame, fitted_fns["bed_0037_1088x1920"], cams_1080),
                   GS_SPANS, named=(("gs.composite", "composite_macro_kernel"),), calls=3,
                   scene="bed_0037_1088x1920")
    return lines, dict(cams=cams, fn_800=fn_800, state=state, style_f=style_f,
                       style_png=style_png, field=field, enc=enc, model_dir=model_dir, sel=sel,
                       cams_1080=cams_1080, fitted_sel=fitted_sel)


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
    """Within the block, record the arguments of ``module.<name>`` (the
    kernel wrapper, which still runs): those of the first call for each
    ``key(args)``, by default the name; a call whose key is None is not
    recorded."""

    def __init__(self, module, name, store, key=None):
        self.module, self.name, self.store = module, name, store
        self.key = key or (lambda args: name)

    def __enter__(self):
        orig = self.orig = getattr(self.module, self.name)

        def spy(*args, **kw):
            key = self.key(args)
            if key is not None:
                self.store.setdefault(key, (args, kw))
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
    blocks as a window; and both through the indexed entries, on the table
    shuffled (gid_s and macro_idx the inverse permutation), with bg != 0."""
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
    perm = torch.from_numpy(g.permutation(n)).to(dev)
    shuffled = table[perm].contiguous()
    gid = torch.argsort(perm).to(torch.int32)       # shuffled[gid] = table
    slot = torch.arange(kc, device=dev)
    idx = torch.where(slot[None, :] < clipped[:, None],
                      gid[torch.clamp(starts.long()[:, None] + slot[None, :], max=n - 1)],
                      torch.full((), -1, dtype=torch.int32, device=dev)).to(torch.int32)
    return [("composite_macro_mxu_seg", ((table, starts, counts, bg),
                                         dict(n_blocks=mtw * mth, kc=kc, **geo)), "edge"),
            ("composite_macro_mxu", ((window, clipped, bg), geo), "edge"),
            ("composite_macro_mxu_seg_indexed", ((shuffled, gid, starts, counts, bg),
                                                 dict(n_blocks=mtw * mth, kc=kc, **geo)), "edge"),
            ("composite_macro_mxu_indexed", ((shuffled, idx.contiguous(), clipped, bg), geo),
             "edge")]


def _gathered(KC, iname, args):
    """An indexed entry's call as its JAX-signature wrapper's: (name, args)
    on the gathered rows."""
    if iname == "composite_macro_mxu_seg_indexed":
        table, gid, starts, counts, bg = args
        return "composite_macro_mxu_seg", (table[gid.long()].contiguous(), starts, counts, bg)
    table, idx, counts, bg = args
    return "composite_macro_mxu", (table[idx.clamp(min=0).long()].contiguous(), counts, bg)


def _indexed_check(torch, KC, plain, iname, args, kw, case):
    """The indexed entry against the plain version on the gathered rows (the
    tolerance of ``_composite_check``), against the kernel on the gathered
    rows (max abs 0: the same kernel reads the same rows) and against the
    kernel's walk emulated in plain torch (max abs 0: both round every
    operation alike, ``composite_macro_walk_reference``)."""
    name, gargs = _gathered(KC, iname, args)
    out = getattr(KC, iname)(*args, **kw)
    gathered = getattr(KC, name)(*gargs, **kw)
    torch.cuda.synchronize()
    if name == "composite_macro_mxu_seg":
        window, counts = KC._segment_window(gargs[0], gargs[1], gargs[2], kw["kc"]), gargs[2]
    else:
        window, counts = gargs[0], gargs[1]
    emulated = KC.composite_macro_walk_reference(window, counts, gargs[-1], kw["bs"], kw["mtw"])
    same = (out - gathered).abs().max().item() if out.numel() else 0.0
    emu = (out - emulated).abs().max().item() if out.numel() else 0.0
    emit("gs_indexed_vs_gathered", kernel=iname, case=case, max_abs_err=same,
         emulation_max_abs_err=emu, tol_max_abs=0.0)
    if same != 0.0 or emu != 0.0:
        raise AssertionError(f"{iname} ({case}) differs from the kernel on the gathered rows "
                             f"or from its emulation")
    return _composite_check(torch, name, lambda *a, **k: out, plain[name], gargs, kw,
                            f"{case}, indexed")


def _composite_work(KC, name, args, kw):
    """(bytes, pairs, rows walked, live pairs) of one compositor call, as
    the plain version counts the early exit and the 1/255 cutoff."""
    if name == "composite_macro_mxu_seg":
        table, starts, counts, bg = args
        window = KC._segment_window(table, starts, counts, kw["kc"])
        index_bytes = 8 * counts.numel()
    else:
        window, counts, bg = args
        index_bytes = 4 * counts.numel()
    bs = kw["bs"]
    _, walked, live = KC._windowed(window, counts, bg, bs, kw["mtw"], 0, 1 << 31)
    rows = int(walked.sum())
    out_bytes = counts.numel() * 3 * bs * bs * 4
    return rows * ROW_BYTES + index_bytes + out_bytes, rows * bs * bs, rows, int(live.sum())


def _sub_tile_shares(torch, KC, window, counts, bg, bs, mtw):
    """Per sub-tile height: the share of the walked (row, sub-tile) pairs
    the kernel's cull keeps (rows up to each block's early exit)."""
    walked = KC._windowed(window, counts, bg, bs, mtw, 0, 1 << 31)[1]
    rows = torch.arange(window.shape[1], device=window.device)
    out = {}
    for sh in sorted({sh for sh, _ in KC.LAYOUTS[bs]}):
        keep = KC.sub_tile_live(window, counts, bs, mtw, sh)
        keep = keep & (rows[None, :] < walked[:, None])[..., None]
        out[f"16x{sh}"] = int(keep.sum()) / max(int(walked.sum()) * keep.shape[2], 1)
    return out


def _composite_ptxas():
    """Registers and spills of each layout of the macro-block kernel, from
    the build's ptxas report: {"bs=64 sh=16 p=2": {...}, ...}."""
    path = WORK / "build_composite.log"
    report = path.read_text() if path.is_file() else ""
    out, cur = {}, None
    for line in report.splitlines():
        if "Compiling entry" in line:
            m = re.search(r"composite_macro_kernelILi(\d+)ELi(\d+)ELi(\d+)E", line)
            cur = f"bs={m[1]} sh={m[2]} p={m[3]}" if m else None
        elif cur is not None:
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            regs = re.search(r"Used (\d+) registers", line)
            if spill:
                out.setdefault(cur, {}).update(spill_stores=int(spill[1]),
                                               spill_loads=int(spill[2]))
            if regs:
                out.setdefault(cur, {})["registers"] = int(regs[1])
    return out or "not measured"


def _cycle(render_frame, fn, cams):
    """A zero-argument frame that renders the next camera each call."""
    state = {"i": 0}

    def frame():
        cam = cams[state["i"] % len(cams)]
        state["i"] += 1
        return render_frame(fn, cam)

    return frame


# ---------------------------------------------------------------------------
# Stylized 3DGS training (phases 15-20)
# ---------------------------------------------------------------------------

TRAIN_WORK = WORK / "train"
MANY_CALLS = 100          # calls in one CUDA-event window (_time_many_ms)
AD_FWD_PAIR_FLOPS = 25    # float32 operations per (slot, pixel) of kernel A, the exp as one
AD_BWD_PAIR_FLOPS = 70    # kernel B: the alpha rebuilt, the chain rule, the 9-term reduction
HASH_POINT_LEVEL_FLOPS = 60   # kernel C per (point, level): corners, weights, 16 products/adds
TRAIN_SPANS = ("gs.field", "gs.project", "gs.select", "gs.gather", "gs.composite", "gs.loss",
               "gs.adam", "gs.stats")
# Phase 20's stages: the spans (colour field forward, projection, selection,
# gather, loss, Adam, statistics), kernels A, B and C by their kernel names,
# and the backward by the autograd nodes the engine ran: the gather's
# transpose (IndexSelectBackward, an index_add_ into per-Gaussian arrays)
# and the rest.
TRAIN_NAMED = (("kernel A", "composite_ad_fwd"), ("kernel B", "composite_ad_bwd"),
               ("kernel C", "hash_grad"))
TRAIN_STAGES = (TRAIN_SPANS + tuple(s for s, _ in TRAIN_NAMED)
                + ("backward scatter-add", "backward other"))
AUTOGRAD_NODE = "autograd::engine::evaluate_function: "
TRAIN_SIZE = 800          # the orbit views' size (phase 9's cameras)
N_OBJECT, N_BACKGROUND = 16_000, 84_000   # the initial cloud: the object and the far points
ORBIT_SCALE = 1.5         # the training orbit's distance over phase 9's
# The shortened schedule of phase 18: GSTrainConfig's defaults otherwise.
SCHEDULE = dict(iterations=60, freeze_iters=40, densify_from_iter=10, densification_interval=10,
                densify_until_iter=45, opacity_reset_interval=25, mask_prune_iter=10,
                net_lr_step=(20, 40, 55))
# Phase 18's call of kernels A and B (from 0) captured a second time: that of
# the last photometric step, iteration freeze_iters - 1, after the densify
# and prune events of iterations 20 and 30 and the opacity reset of 25.
LATE_CALL = SCHEDULE["freeze_iters"] - 2


def _train_phases(torch, dev, bed):
    """Phases 15-20. Returns the lines of kernels A, B and C."""
    import numpy as np
    from PIL import Image

    from aip_tpu_torch.cli import run_3dgs
    from aip_tpu_torch.gs import gaussians as G
    from aip_tpu_torch.gs import pipeline
    from aip_tpu_torch.gs import train as T
    from aip_tpu_torch.gs.cameras import Camera
    from aip_tpu_torch.gs import colorfield as CF
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
    with _capture(KAD, "composite_ad_fwd_packed", served), \
            _capture(KAD, "composite_ad_bwd_packed", served), _capture(KH, "hash_grad", served):
        step(trainer, arrays, style_f, bg)
    torch.cuda.synchronize()
    fwd_args, bwd_args = served["composite_ad_fwd_packed"][0], served["composite_ad_bwd_packed"][0]
    n_tiles, k = fwd_args[0].shape[:2]
    n_valid = int(fwd_args[1].sum().item())
    emit("train_scene", scene=str(scene_dir.relative_to(ROOT)), cameras=len(cams),
         size=[cams[0].image_height, cams[0].image_width], points=len(pcd.points),
         capacity=cfg.capacity, table=[16, 1 << cfg.log2_hashmap, 2], style_dim=cfg.style_dim,
         settings=step.settings._asdict(), tiles=n_tiles, slots=k, valid_slots=n_valid)
    checked = _ad_check(torch, KAD, fwd_args, bwd_args, "served")
    ad_err = {"composite_ad_fwd": checked["fwd"], "composite_ad_bwd": checked["bwd"]}
    _ad_check(torch, KAD, *_ad_edge_cases(np, torch, KAD, dev), "edge")

    # 16. kernel C at full width ----------------------------------------------------
    x01, g_out, shape = served["hash_grad"][0]
    c_err, sorted_ms = _hash_checks(torch, KH, CF, x01, g_out, shape, dev)

    # 17. one training step, card against the port on the CPU, 128^2 ---------------
    _card_vs_cpu_step(torch, np, T, G, Camera, Image, scene_dir, cams, pcd, ext, style_f, dev)

    # 18. training at full width --------------------------------------------------
    model_dir = TRAIN_WORK / "model"
    shutil.rmtree(model_dir, ignore_errors=True)
    trace = {}
    late = {}  # A's and B's arguments at the last photometric step
    for mod in (KAD, KH, KC):
        mod.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _capture(KAD, "composite_ad_fwd_packed", late, key=_nth_call(LATE_CALL, "fwd")), \
            _capture(KAD, "composite_ad_bwd_packed", late, key=_nth_call(LATE_CALL, "bwd")):
        pipeline.run_3dgs_training(str(scene_dir), str(bed["style_png"]),
                                   model_path=str(model_dir), cfg=cfg, progress_every=0,
                                   device=dev, trace=trace)
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
    late_fwd, late_bwd = late["fwd"][0], late["bwd"][0]
    late_checked = _ad_check(torch, KAD, late_fwd, late_bwd, f"late step {LATE_CALL + 1}")
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
        "composite_ad_fwd": (lambda: KAD.composite_ad_fwd_packed(*fwd_args),
                             lambda: KAD.composite_ad_fwd_reference(*_ad_plain_args(KAD, fwd_args)),
                             None),
        "composite_ad_bwd": (lambda: KAD.composite_ad_bwd_packed(*bwd_args),
                             lambda: KAD.composite_ad_bwd_reference(*_ad_plain_args(KAD, bwd_args)),
                             None),
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
        single_ms = _time_ms(torch, kern)
        lines.append({
            "name": name, "route": "cuda", "source": f"aip_tpu_torch/csrc/{KERNELS[name][0]}.cu",
            "replaces": KERNELS[name][1], "launches": train_launches[name],
            "max_abs_err": errs[name],
            "ms": _time_many_ms(torch, kern, MANY_CALLS), "plain_ms": _time_ms(torch, plain),
            "bound_ms": max(t_comp, t_mem) * 1e3,
            "bound_by": "operations" if t_comp >= t_mem else "bytes",
            "library_ms": None if lib is None else _time_ms(torch, lib),
        })
        emit("train_kernel_work", kernel=name, inputs="step 1", flops=t_comp * PEAK_FLOPS_F32,
             bytes=t_mem * PEAK_BYTES, launches_per_step=train_launches[name] / len(steps),
             ms_many_calls=lines[-1]["ms"], calls_in_window=MANY_CALLS,
             ms_single_call=single_ms, plain_ms=lines[-1]["plain_ms"],
             bound_ms=lines[-1]["bound_ms"], definition=_BOUND_NOTES[name])
    del idx, w, vals, flat, table
    _hash_times(torch, KH, x01, g_out, shape, next(l for l in lines if l["name"] == "hash_grad"),
                sorted_ms)
    # A and B on the late step's inputs, and the P sweep on both
    _ad_late_times(torch, KAD, late_fwd, late_bwd, late_checked, f"step {LATE_CALL + 1}")
    _ad_sweep(torch, KAD, {"step 1": (fwd_args, bwd_args), f"step {LATE_CALL + 1}":
                           (late_fwd, late_bwd)}, checked, late_checked)
    _ad_launches(torch, KAD, fwd_args)

    # 20. profile of one photometric and one style step --------------------------------
    guide = np.asarray(Image.open(model_dir / "stylized" / f"{cams[0].image_name}.jpg")
                       .convert("RGB").resize((TRAIN_SIZE, TRAIN_SIZE), Image.BILINEAR),
                       np.float32) / 255.0
    style_arrays = T.camera_to_arrays(cams[0], image=guide, device=dev)
    for phase, cam_arrays in (("photometric", arrays), ("style", style_arrays)):
        fn = T.make_train_step(cfg, ext, phase, TRAIN_SIZE, TRAIN_SIZE)
        _stage_profile(torch, "train_profile", lambda: fn(trainer, cam_arrays, style_f, bg),
                       TRAIN_STAGES, named=TRAIN_NAMED, stage_of=_train_stage, step=phase)
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


HASH_TOL = 1e-4           # kernel C against index_add_, of the largest entry
HASH_REPEATS = 20
# Kernel C's other paths, reached through shapes (csrc/hashgrad.cu sums a
# level in shared memory when its rows fit 48 KiB, and zeroes 2 levels a
# phase): (case, levels, log2 rows, features).
HASH_SHAPES = (("F=1: level 0 in shared memory", None, None, 1),
               ("F=4: dense level 0 too large for shared memory, every level global",
                None, None, 4),
               ("15 levels: a short last phase", 15, None, 2),
               ("2^10 rows: every level in shared memory, both of each phase", None, 10, 2))
# The times PERF.md recorded (section 6, H100 80GB HBM3 at 700.00 W, 100 calls in
# one window) for the kernels this port's kernel C and fused walk replaced:
# kernel C zero-filled by its wrapper, two launches; the fused walk with one
# block a tile, every slot of the list walked.
BEFORE_MS = {"hash_grad": 0.1102, "composite_from_macro": 4.711, "composite_macro_blocks": 0.8541,
             "composite_tiles": 0.1005}


def _hash_checks(torch, KH, CF, x01, g_out, shape, dev):
    """Phase 16: kernel C against its plain version at HASH_TOL of the
    largest entry, on the served step, 20 times, after a NaN-filled
    allocation and at HASH_SHAPES. Returns (the served error, the
    sort-based gradient's ms)."""
    l, t, f = shape
    n = x01.shape[0]
    ref = KH.hash_grad_reference(x01, g_out, shape)
    tol = HASH_TOL * ref.abs().max().item()

    def check(out, want, tol, case, **extra):
        torch.cuda.synchronize()
        err = (out - want).abs().max().item()
        emit("hash_grad_vs_plain", case=case, points=n, table=list(out.shape),
             max_abs_err=err, max_abs_ref=want.abs().max().item(), tol=tol, **extra)
        if not (out.shape == want.shape and err <= tol):
            raise AssertionError(f"hash_grad ({case}) disagrees with index_add_: {err} > {tol}")
        return err

    served_err = check(KH.hash_grad(x01, g_out, shape), ref, tol, "served",
                       nonzero_rows=int((ref != 0).any(-1).sum()))
    first = KH.hash_grad(x01, g_out, shape)
    errs, spread = [], 0.0
    for _ in range(HASH_REPEATS):
        out = KH.hash_grad(x01, g_out, shape)
        torch.cuda.synchronize()
        errs.append((out - ref).abs().max().item())
        spread = max(spread, (out - first).abs().max().item())
    emit("hash_grad_repeats", calls=HASH_REPEATS, max_abs_err=max(errs), tol=tol,
         run_to_run_max_abs=spread)
    if not max(errs) <= tol:
        raise AssertionError(f"a repeated hash_grad call is {max(errs)} off index_add_")
    del first, out
    # A NaN-filled block of the table's size, freed just before the call:
    # the kernel's torch.empty gets it back, and must write every entry.
    torch.cuda.synchronize()
    poison = torch.full((l, t, f), float("nan"), device=dev)
    ptr = poison.data_ptr()
    del poison
    out = KH.hash_grad(x01, g_out, shape)
    torch.cuda.synchronize()
    idx, _ = CF._encode_terms(shape, x01)                                   # [N, L, 8]
    live = (g_out.reshape(n, l, f) != 0).any(-1)
    touched = torch.zeros(l * t, dtype=torch.bool, device=dev)
    touched[idx[live]] = True
    untouched = out.reshape(l * t, f)[~touched]
    bad = int((untouched != 0).any(-1).sum())      # NaN != 0 counts too
    finite = bool(torch.isfinite(out).all())
    emit("hash_grad_poisoned", reused_block=out.data_ptr() == ptr,
         untouched_rows=int(untouched.shape[0]), nonzero_untouched_rows=bad, finite=finite)
    if not (out.data_ptr() == ptr and bad == 0 and finite):
        raise AssertionError("hash_grad left poisoned or non-zero entries in untouched rows "
                             "(or the poisoned block was not reused)")
    check(out, ref, tol, "after a NaN-filled block")
    del out, idx, untouched
    # The other shapes: the same points, a gradient wherever the served one
    # has one (the served levels' mask, cycled over the levels).
    gen = torch.Generator(device=dev).manual_seed(16)
    for case, l_, log2, f_ in HASH_SHAPES:
        s_ = (l_ or l, 1 << log2 if log2 else t, f_)
        mask = live[:, torch.arange(s_[0], device=dev) % l, None]
        go = (torch.randn((n, s_[0], f_), generator=gen, device=dev) * mask).reshape(n, -1)
        want = KH.hash_grad_reference(x01, go, s_)
        check(KH.hash_grad(x01, go, s_), want, HASH_TOL * want.abs().max().item(), case)
        del go, want, mask
    # The deterministic yardstick: hash_encode_sg's sort-based gradient.
    srt = CF.sorted_table_grad(x01, g_out, shape)
    sorted_ms = _time_ms(torch, lambda: CF.sorted_table_grad(x01, g_out, shape), 5, 1)
    emit("hash_grad_sorted_yardstick", entry="aip_tpu_torch.gs.colorfield.sorted_table_grad",
         ms=sorted_ms, max_abs_vs_plain=(srt - ref).abs().max().item(),
         max_abs_ref=ref.abs().max().item(),
         same_bits_again=bool(torch.equal(srt, CF.sorted_table_grad(x01, g_out, shape))))
    del srt, ref
    torch.cuda.empty_cache()
    return served_err, sorted_ms


def _hash_times(torch, KH, x01, g_out, shape, line, sorted_ms):
    """Phase 20, kernel C: the window's ms beside the kernel's own device ms
    from the profiler, the bound and before -> after, with the card."""
    device_ms, all_ms, period_ms = _device_ms(torch, lambda: KH.hash_grad(x01, g_out, shape),
                                              "hash_grad_kernel")
    # The host's time to issue a call (no synchronisation inside the loop).
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MANY_CALLS):
        KH.hash_grad(x01, g_out, shape)
    host_ms = (time.perf_counter() - t0) * 1e3 / MANY_CALLS
    torch.cuda.synchronize()
    emit("hash_grad_times", card=_card(), ms_100_calls=line["ms"],
         profiler_device_ms=device_ms, profiler_all_device_ms=all_ms,
         profiler_start_to_start_ms=period_ms, bound_ms=line["bound_ms"],
         share_of_bound=line["bound_ms"] / line["ms"], host_ms_per_call=host_ms,
         sorted_yardstick_ms=sorted_ms,
         before_ms=BEFORE_MS["hash_grad"], after_ms=line["ms"],
         before_source="PERF.md section 6, row 10 (100 calls in one window)")


def _device_ms(torch, fn, pattern, calls=20):
    """torch.profiler over ``calls`` calls of ``fn`` after a warm-up: the
    device ms per call of the kernels whose name holds ``pattern``, and of
    all device work."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    mine = total = 0.0
    starts = []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            total += us
            if pattern in e.name:
                mine += us
                starts.append(e.time_range.start)
    starts.sort()
    period = ((starts[-1] - starts[0]) / (len(starts) - 1) / 1e3 if len(starts) > 1
              else "not measured")
    return (mine / 1e3 / calls if mine else "not measured",
            total / 1e3 / calls if total else "not measured", period)


def _card():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def _train_stage(name):
    """The phase-20 stage of a CPU event's name, or None."""
    if name in TRAIN_SPANS:
        return name
    if name.startswith(AUTOGRAD_NODE):
        index = name[len(AUTOGRAD_NODE):].startswith("Index")
        return "backward scatter-add" if index else "backward other"
    return None


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


def _ad_plain_args(KAD, args):
    """A packed wrapper's arguments (g, valid, ...) as the plain versions
    take them (mean, conic, colour, opacity, valid, ...)."""
    return (*KAD._unpack(args[0]), *args[1:])


def _nth_call(n, key):
    """A ``_capture`` key that records the n-th call (from 0) only."""
    calls = itertools.count()
    return lambda args: key if next(calls) == n else None


def _ad_check(torch, KAD, fwd_args, bwd_args, case):
    """Kernels A and B against their plain versions on one input: the image
    and T_final equal (max abs 0: the same float32 walk, rounded alike, and
    the culled slots add exactly nothing), each gradient at 1e-4 of its
    largest value (B sums the 256 pixels in another order, with one suffix
    division), and 0 for every slot off the live list. Also B against its
    emulation in plain torch on the card (reported, not gated) and the live
    share. Returns {"fwd", "bwd": largest absolute errors, "valid", "live":
    slot counts}."""
    g, valid, bg, tile_w = fwd_args
    out, tf = KAD.composite_ad_fwd_packed(*fwd_args)
    d_g = KAD.composite_ad_bwd_packed(*bwd_args)
    torch.cuda.synchronize()
    ref_out, ref_tf = KAD.composite_ad_fwd_reference(*_ad_plain_args(KAD, fwd_args))
    ref_grads = KAD.composite_ad_bwd_reference(*_ad_plain_args(KAD, bwd_args))
    emulated = KAD.composite_ad_bwd_culled_reference(*bwd_args, p=KAD.BWD_P)
    keep = KAD.live_slots(g, valid, tile_w)
    f_err = max((out - ref_out).abs().max().item(), (tf - ref_tf).abs().max().item())
    grads = KAD._unpack(d_g)
    rel = [(a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
           for a, b in zip(grads, ref_grads)]
    b_err = max((a - b).abs().max().item() for a, b in zip(grads, ref_grads))
    off_list = d_g[~keep].abs().sum().item()
    n_valid, n_live = int(valid.sum().item()), int(keep.sum().item())
    emit("composite_ad_vs_plain", case=case, in_shape=list(g.shape), fwd_max_abs_err=f_err,
         fwd_tol=0.0, bwd_max_rel_err=dict(zip(("mean", "conic", "color", "opacity"), rel)),
         bwd_tol_rel=1e-4, bwd_off_list_abs_sum=off_list,
         bwd_vs_emulation_max_abs=(d_g - emulated).abs().max().item(), p={"A": KAD.FWD_P,
                                                                         "B": KAD.BWD_P},
         valid_slots=n_valid, live_slots=n_live, live_share=n_live / max(n_valid, 1),
         t_final_min=tf.min().item())
    if not (f_err == 0.0 and max(rel) <= 1e-4 and off_list == 0.0):
        raise AssertionError(f"composite_ad kernels disagree with the plain version ({case})")
    return {"fwd": f_err, "bwd": b_err, "valid": n_valid, "live": n_live}


def _ad_edge_cases(np, torch, KAD, dev, k=128, tile_w=4):
    """8 tiles of K slots around each tile's pixels: tile 1 empty (every
    slot invalid), tile 2 saturating below T = 1e-4, tile 3 a splat at the
    0.99 clamp and one of opacity 0, tile 4 invalid slots between valid
    ones, tile 5 only its first slot valid, tile 6 every slot valid and on
    top of each other. Returns the packed forward's and backward's
    arguments, with an upstream gradient from seed 5."""
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
    mean[6] = [x0[6, 0] + 6.3, y0[6, 0] + 9.1]
    conic[6] = [0.02, 0.004, 0.03]
    op[6] = 0.05
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)  # noqa: E731
    args = [f(a) for a in (mean, conic, color, op, valid)] + [f([0.2, 0.5, 0.1])]
    _, t_final = KAD.composite_ad_fwd_reference(*args, tile_w)
    g_out = f(g.standard_normal((n, 3, 16, 16)))
    packed = KAD.pack(*args[:4])
    return (packed, args[4], args[5], tile_w), (packed, args[4], args[5], t_final, g_out, tile_w)


def _ad_late_times(torch, KAD, fwd_args, bwd_args, checked, label):
    """Kernels A and B on the late step's inputs: ms over MANY_CALLS calls
    in one window, one call alone, the plain versions and the bound."""
    bound = _ad_bound(fwd_args, checked["valid"])
    runs = {"composite_ad_fwd": (
        lambda: KAD.composite_ad_fwd_packed(*fwd_args),
        lambda: KAD.composite_ad_fwd_reference(*_ad_plain_args(KAD, fwd_args))),
        "composite_ad_bwd": (
        lambda: KAD.composite_ad_bwd_packed(*bwd_args),
        lambda: KAD.composite_ad_bwd_reference(*_ad_plain_args(KAD, bwd_args)))}
    for name, (kern, plain) in runs.items():
        t_comp, t_mem = bound[name]
        emit("train_kernel_work", kernel=name, inputs=label, flops=t_comp * PEAK_FLOPS_F32,
             bytes=t_mem * PEAK_BYTES, ms_many_calls=_time_many_ms(torch, kern, MANY_CALLS),
             calls_in_window=MANY_CALLS, ms_single_call=_time_ms(torch, kern),
             plain_ms=_time_ms(torch, plain), bound_ms=max(t_comp, t_mem) * 1e3,
             bound_by="operations" if t_comp >= t_mem else "bytes",
             definition=_BOUND_NOTES[name])


def _ad_ptxas():
    """Registers and spills of each instance of kernels A and B, from the
    build's ptxas report: {"A P=4": {"registers": .., ...}, ...}."""
    path = WORK / "build_composite_ad.log"
    report = path.read_text() if path.is_file() else ""
    out, cur = {}, None
    for line in report.splitlines():
        if "Compiling entry" in line:
            m = re.search(r"composite_ad_(fwd|bwd)_kernelILi(\d)E", line)
            cur = f"{'A' if m[1] == 'fwd' else 'B'} P={m[2]}" if m else None
        elif cur is not None:
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            regs = re.search(r"Used (\d+) registers", line)
            if spill:
                out.setdefault(cur, {}).update(spill_stores=int(spill[1]),
                                               spill_loads=int(spill[2]))
            if regs:
                out.setdefault(cur, {})["registers"] = int(regs[1])
    return out or "not measured"


def _ad_sweep(torch, KAD, captures, *checked):
    """Kernels A and B at every P (pixels a thread) on each capture: ms over
    MANY_CALLS calls in one window; A equal to the default P's image at
    every P, B within 1e-4 of the default P's largest gradient; the
    default P and the staging alone (empty lists) through raw launches;
    with the live share and ptxas's registers and spills."""
    regs = _ad_ptxas()
    for (label, (fwd_args, bwd_args)), chk in zip(captures.items(), checked):
        out0 = KAD.composite_ad_fwd_packed(*fwd_args)[0]
        d0 = KAD.composite_ad_bwd_packed(*bwd_args)
        ms, agree = {}, {}
        for p in KAD.PIXELS_PER_THREAD:
            same = torch.equal(KAD.composite_ad_fwd_packed(*fwd_args, p=p)[0], out0)
            rel = ((KAD.composite_ad_bwd_packed(*bwd_args, p=p) - d0).abs().max()
                   / d0.abs().max().clamp(min=1e-30)).item()
            agree[p] = {"A_equal": same, "B_max_rel": rel}
            if not (same and rel <= 1e-4):
                raise AssertionError(f"composite_ad at P={p} disagrees ({label})")
            ms[f"A P={p}"] = _time_many_ms(
                torch, lambda: KAD.composite_ad_fwd_packed(*fwd_args, p=p), MANY_CALLS)
            ms[f"B P={p}"] = _time_many_ms(
                torch, lambda: KAD.composite_ad_bwd_packed(*bwd_args, p=p), MANY_CALLS)
        # The staging alone: every mean moved 10^4 px off, so every valid
        # slot takes the whole float64 test and the lists are empty. Launched
        # through the C entry points (no wrapper checks or allocations, which
        # take longer than such a short kernel), beside the whole kernels.
        far = fwd_args[0].clone()
        far[..., 0] += 1e4
        if KAD.live_slots(far, fwd_args[1], fwd_args[3]).any():
            raise AssertionError("a slot 10^4 px off its tile was kept")
        fwd, bwd = _ad_raw_launches(torch, KAD, fwd_args, bwd_args)
        for name, launch, g in (("A", fwd, fwd_args[0]), ("B", bwd, fwd_args[0]),
                                ("A staging only", fwd, far), ("B staging only", bwd, far)):
            if launch(g) != 0:
                raise AssertionError(f"{name} failed to launch")
            ms[f"{name}, raw launches"] = _time_many_ms(torch, lambda: launch(g), MANY_CALLS)
        emit("composite_ad_sweep", inputs=label, in_shape=list(fwd_args[0].shape),
             valid_slots=chk["valid"], live_slots=chk["live"],
             live_share=chk["live"] / max(chk["valid"], 1), ms_many_calls=ms,
             calls_in_window=MANY_CALLS, agree_with_default_p=agree,
             default_p={"A": KAD.FWD_P, "B": KAD.BWD_P}, ptxas=regs)


def _ad_raw_launches(torch, KAD, fwd_args, bwd_args):
    """Kernels A and B at the default P, each a function of the packed rows
    that launches through the C entry point into preallocated outputs."""
    g, valid, bg, tile_w = fwd_args
    t_final, g_out = bwd_args[3], bwd_args[4]
    n, k = g.shape[:2]
    out = torch.empty((n, 3, 16, 16), device=g.device)
    tf = torch.empty((n, 16, 16), device=g.device)
    d_g = torch.empty_like(g)
    lib, stream = KAD._lib(), torch.cuda.current_stream().cuda_stream

    def fwd(rows):
        return lib.aip_composite_ad_fwd(rows.data_ptr(), valid.data_ptr(), bg.data_ptr(),
                                        out.data_ptr(), tf.data_ptr(), n, k, tile_w,
                                        KAD.FWD_P, stream)

    def bwd(rows):
        return lib.aip_composite_ad_bwd(rows.data_ptr(), valid.data_ptr(), bg.data_ptr(),
                                        t_final.data_ptr(), g_out.data_ptr(), d_g.data_ptr(),
                                        n, k, tile_w, KAD.BWD_P, stream)

    return fwd, bwd


def _ad_launches(torch, KAD, fwd_args):
    """Device launches and device ms of one forward and backward of the
    composite alone on the step-1 gather: the packed form the rasterizer
    calls (the gather in, its [T, K, 9] gradient out), against the
    four-array form on views of the same gather (``composite_tiles_ad``:
    the views packed in, and each view's gradient written back into a zero
    [T, K, 9] and summed, as the four-array Function's backward did)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    g, valid, bg, tile_w = fwd_args
    g_out = torch.ones((g.shape[0], 3, 16, 16), device=g.device)
    forms = {"packed": lambda x: KAD.composite_tiles_ad_packed(x, valid, tile_w, bg),
             "four_arrays": lambda x: KAD.composite_tiles_ad(
                 x[..., 0:2], x[..., 2:5], x[..., 5:8], x[..., 8:9], valid, tile_w, bg)}
    res = {}
    for name, fn in forms.items():
        leaf = g.detach().clone().requires_grad_()
        fn(leaf).backward(g_out)
        torch.cuda.synchronize()
        leaf.grad = None
        KAD.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn(leaf).backward(g_out)
            torch.cuda.synchronize()
        ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and "composite_ad" not in e.name]
        res[name] = {"torch_launches": len(ev),
                     "torch_device_ms": sum(e.time_range.elapsed_us() for e in ev) / 1e3,
                     "torch_kernels": sorted({e.name[:70] for e in ev}),
                     "kernel_launches": KAD.launch_counts()}
    emit("composite_ad_launches", in_shape=list(g.shape), forms=res,
         definition="PyTorch's launches around kernels A and B (the profiler's CUDA events "
                    "other than the two kernels) and the wrappers' launch counts")


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


# ---------------------------------------------------------------------------
# Video style transfer with TV-L1 temporal consistency (phases 21-25)
# ---------------------------------------------------------------------------

VIDEO_WORK = WORK / "video"
VIDEO_FRAMES, VIDEO_SIZE = 96, 256
VIDEO_STEP = (0.6, -0.35)        # (dx, dy) px a frame: the flows are -VIDEO_STEP
EPE_MARGIN, EPE_BOUND = 16, 0.25  # tests/test_torch_port_flow.py's bound, in px
TVL1_TOL = 0.0                   # the kernel rounds every operation as the plain loop does
TVL1_PIXEL_ITER_FLOPS = 55       # float32 operations per pixel and iteration
TVL1_PIXEL_BYTES = 64            # 10 fields read, 6 written, float32
TVL1_FLOW_ITERATIONS = 4 * 5 * 300  # kernel iterations of one flow call: levels x warps x iters
DISTILLED = ROOT / "docs" / "examples" / "magenta" / "magenta_distilled.npz"


def _video_phases(torch, dev, default_tf32):
    """Phases 21-25. Returns the tvl1 kernel's line of the kernels table.
    ``default_tf32``: PyTorch's (cuDNN, matmul) TF32 flags at start-up."""
    import numpy as np
    from PIL import Image

    from aip_tpu_torch.kernels import adain_head as KA
    from aip_tpu_torch.kernels import tvl1 as KT
    from aip_tpu_torch.models import decoder as DEC
    from aip_tpu_torch.models import magenta, weights
    from aip_tpu_torch.models import vgg as VGG
    from aip_tpu_torch.ops import flow as OF
    from aip_tpu_torch.pipelines import video

    shutil.rmtree(VIDEO_WORK, ignore_errors=True)
    t0 = time.perf_counter()
    frames_dir = _write_images(np, Image, _moving_texture(np, VIDEO_FRAMES, VIDEO_SIZE, 0),
                               VIDEO_WORK / "frames", "frame")
    g = np.random.default_rng(1)
    styles_dir = _write_images(np, Image, [g.random((VIDEO_SIZE, VIDEO_SIZE, 3)),
                                           _moving_texture(np, 1, VIDEO_SIZE, 2)[0] ** 2],
                               VIDEO_WORK / "styles", "style")
    emit("video_scene", frames=VIDEO_FRAMES, size=VIDEO_SIZE, step_px=VIDEO_STEP,
         styles=len(video._list_images(styles_dir)), write_s=time.perf_counter() - t0,
         frames_dir=str(frames_dir.relative_to(ROOT)))

    # 21. the kernel against its plain version ----------------------------------------
    frames = video._load_frames(frames_dir, video._list_images(frames_dir),
                                (VIDEO_SIZE, VIDEO_SIZE), dev)
    served = {}  # the first call at each pyramid level, by its width
    with _capture(OF, "tvl1_inner", served, key=lambda a: a[0].shape[-1]):
        OF.estimate_flow_tvl1(frames[:-1], frames[1:])
    del frames
    main_err = max(_tvl1_check(torch, KT, a, f"served {hw}^2") for hw, (a, _) in served.items())
    args = served[VIDEO_SIZE][0]
    gen = torch.Generator(device=dev).manual_seed(21)
    above = KT.FRAME_SIDE + 1  # the smallest side that takes the tile form
    for case, b, h, w, iters, flat in (
            ("H=2", 4, 2, 200, 30, False), ("W=2", 4, 200, 2, 30, False),
            ("H=3 < halo", 4, 3, 200, 300, False), ("37x45", 2, 37, 45, 30, False),
            ("H above the whole-frame limit", 4, above, KT.FRAME_SIDE, 300, False),
            ("W above the whole-frame limit", 4, KT.FRAME_SIDE, above, 300, False),
            ("grad2=0", 2, 100, 100, 30, True), ("iters=0", 2, 32, 32, 0, False),
            ("iters=1", 2, 100, 100, 1, False),
            ("iters not a multiple of k", 2, 100, 100, 3 * KT.form(100, 100) + 1, False),
            ("B=1", 1, VIDEO_SIZE, VIDEO_SIZE, 300, False),
            ("random 128^2", 95, 128, 128, 300, False), ("random 64^2", 95, 64, 64, 300, False)):
        _tvl1_check(torch, KT, _tvl1_random(torch, gen, dev, b, h, w, iters, flat), case)

    # 22. main path: the 96-frame multi-style depth-aware video call -------------------
    vgg = weights.get_vgg_params(device=dev)
    dec = weights.get_decoder_params(device=dev)
    call = dict(target_resolution=(VIDEO_SIZE, VIDEO_SIZE), compute_dtype=torch.bfloat16,
                use_depth=True, flow_method="tvl1", vgg_params=vgg, dec_params=dec, device=dev)
    out_dir = VIDEO_WORK / "styled"
    trace, adain_served = {}, {}

    def by_shape(name):
        return lambda a: (name, tuple(a[0].shape), a[0].dtype)

    KT.reset_launch_counts()
    KA.reset_launch_counts()
    t0 = time.perf_counter()
    with _capture(VGG, "encode_head", adain_served, key=by_shape("encode_head")), \
            _capture(DEC, "decode_tail", adain_served, key=by_shape("decode_tail")):
        paths = video.apply_style_transfer_multi_ada(frames_dir, styles_dir, out_dir,
                                                     trace=trace, **call)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {**KT.launch_counts(), **KA.launch_counts()}
    tvl1_iters = KT.iteration_counts()["tvl1"]
    adain_bf16 = KA.route_launch_counts()["bf16"]
    epe = _endpoint_error(np, trace["flows"])
    emit("video_main", entry="aip_tpu_torch.pipelines.video.apply_style_transfer_multi_ada",
         frames=len(paths), pngs_exist=all(p.is_file() for p in paths),
         out_size=list(np.asarray(Image.open(paths[0])).shape), launches=launches,
         tvl1_iterations=tvl1_iters, adain_bf16_launches=adain_bf16, flow_epe_px=epe,
         epe_bound_px=EPE_BOUND, wall_s_first_call=wall_s,
         stage_ms_first_call=trace["stage_ms"])
    if not (len(paths) == VIDEO_FRAMES and all(p.is_file() for p in paths)):
        raise AssertionError("the video call did not write every frame")
    if not (_tvl1_ran(launches["tvl1"], tvl1_iters) and launches["encode_head"] > 0
            and launches["decode_tail"] > 0):
        raise AssertionError(f"a kernel of the video path was not launched: {launches}")
    if adain_bf16 != KA.launch_counts():
        raise AssertionError(f"a bf16 AdaIN launch missed the bf16 route: {adain_bf16}")
    if not epe <= EPE_BOUND:
        raise AssertionError(f"flows are {epe} px off the known step")
    # The AdaIN kernels at the shapes this call gave them, with phase 3's rule.
    for (name, _, _), (a, _) in adain_served.items():
        _adain_check(torch, KA, name, a[0], a[1:], "video served")
    del adain_served

    # 23. fast-stylizer path --------------------------------------------------------
    fast_dir = VIDEO_WORK / "styled_fast"
    magenta.use_magenta_stylizer(magenta.load_magenta_npz(DISTILLED, device=dev))
    KT.reset_launch_counts()
    fast_trace = {}
    try:
        fast = video.apply_style_transfer(frames_dir, styles_dir / "style_001.png", fast_dir,
                                          target_resolution=(VIDEO_SIZE, VIDEO_SIZE),
                                          device=dev, trace=fast_trace)
        torch.cuda.synchronize()
    finally:
        video.register_fast_stylizer(None)
    fast_launches = KT.launch_counts()
    fast_iters = KT.iteration_counts()["tvl1"]
    emit("video_fast_stylizer", entry="aip_tpu_torch.pipelines.video.apply_style_transfer",
         checkpoint=str(DISTILLED.relative_to(ROOT)), frames=len(fast), launches=fast_launches,
         tvl1_iterations=fast_iters,
         flow_epe_px=_endpoint_error(np, fast_trace["flows"]),
         stage_ms_first_call=fast_trace["stage_ms"])
    if not (len(fast) == VIDEO_FRAMES and all(p.is_file() for p in fast)
            and _tvl1_ran(fast_launches["tvl1"], fast_iters)):
        raise AssertionError("the fast-stylizer video call failed")

    # 24. card vs CPU, fp32, 6 frames and a magenta frame at 64^2 -------------------------
    _video_card_vs_cpu(torch, np, Image, video, weights, magenta, KT, vgg, dec, dev,
                       default_tf32)

    # 25. times ------------------------------------------------------------------------
    walls, stage_runs = [], []
    for _ in range(3):
        run_trace = {}
        t0 = time.perf_counter()
        video.apply_style_transfer_multi_ada(frames_dir, styles_dir, out_dir, trace=run_trace,
                                             **call)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        stage_runs.append(run_trace["stage_ms"])
    wall = statistics.median(walls)
    emit("video_time", frames=VIDEO_FRAMES, size=VIDEO_SIZE, dtype="bfloat16",
         wall_s=walls, frames_per_s=VIDEO_FRAMES / wall,
         stage_ms={k: statistics.median(r[k] for r in stage_runs) for k in stage_runs[0]},
         stage_definition="CUDA events recorded at each stage's bounds, median of 3 calls")

    per_level = {}
    for hw, (a, _) in sorted(served.items()):
        b, h, w = a[0].shape
        iters, k = a[7], KT.form(h, w)
        KT.reset_launch_counts()
        KT.tvl1_inner(*a)
        launches_per_call = KT.launch_counts()["tvl1"]
        ms = _time_many_ms(torch, lambda: KT.tvl1_inner(*a), 5, 1)
        t_comp, t_mem = _tvl1_bound_s(b, h, w, iters)
        per_level[hw] = {"shape": [b, h, w], "iters": iters,
                         "form": "whole frame" if k == 0 else
                                 f"tiles of {KT.TILE_SIDE - 2 * k}^2 with a {k}-px halo",
                         "k": k if k else iters, "launches_per_call": launches_per_call,
                         "ms_per_call": ms, "ms_per_iteration": ms / iters,
                         "ms_per_call_single": _time_ms(torch, lambda: KT.tvl1_inner(*a), 3, 1),
                         "bound_ms": max(t_comp, t_mem) * 1e3}
    # The tile form's k: iterations a launch, each on a (64 - 2k)^2 tile.
    k_sweep = {hw: {k: _time_many_ms(torch, lambda: KT._launch(*served[hw][0], k=k), 5, 1)
                    for k in KT.TILE_KS} for hw in (VIDEO_SIZE, VIDEO_SIZE // 2)}
    plain_ms = _time_ms(torch, lambda: KT.tvl1_inner_reference(*args), 3, 1)
    b, h, w = args[0].shape
    iters = args[7]
    t_comp, t_mem = _tvl1_bound_s(b, h, w, iters)
    call_ms = per_level[VIDEO_SIZE]["ms_per_call"]
    emit("tvl1_kernel_work", served_shape=[b, h, w], iters=iters, per_level=per_level,
         k_sweep_ms_per_call=k_sweep,
         k_chosen={hw: KT.form(hw, hw) for hw in k_sweep},
         sass_per_pixel_iteration=_tvl1_sass_per_pixel_iteration(),
         launches_per_video_call=launches["tvl1"], iterations_per_video_call=tvl1_iters,
         calls_per_video_call=tvl1_iters // iters,
         flops=TVL1_PIXEL_ITER_FLOPS * b * h * w * iters, bytes=TVL1_PIXEL_BYTES * b * h * w,
         flow_stage_kernel_ms=sum(5 * v["ms_per_call"] for v in per_level.values()),
         definition=("operations = 55 float32 per pixel and iteration (a division and a square "
                     "root as one each) at 67 TFLOP/s (H100 SXM, CUDA cores); bytes = the ten "
                     "[B,H,W] inputs read once and the six outputs written once, at 3.35 TB/s"),
         library_ms_reason="no single PyTorch call runs a TV-L1 iteration")
    _stage_profile(torch, "video_profile", lambda: video.apply_style_transfer_multi_ada(
        frames_dir, styles_dir, out_dir, **call), VIDEO_STAGES, named=VIDEO_NAMED,
        frames=VIDEO_FRAMES)
    _video_cli(torch, np, Image, KT, styles_dir)
    return [{"name": "tvl1", "route": "cuda", "source": "aip_tpu_torch/csrc/tvl1.cu",
             "iterations": tvl1_iters,
             "replaces": KERNELS["tvl1"][1], "launches": launches["tvl1"],
             "max_abs_err": main_err, "ms": call_ms, "plain_ms": plain_ms,
             "bound_ms": max(t_comp, t_mem) * 1e3,
             "bound_by": "operations" if t_comp >= t_mem else "bytes", "library_ms": None}]


def _moving_texture(np, n, size, seed):
    """n frames [size, size, 3] in [0, 1] of a smooth periodic texture
    (Gaussian-filtered noise, sigma 2.5 px, by its spectrum) moved by
    i * VIDEO_STEP at frame i, exactly, by a phase ramp: frame_i(x) =
    T(x + i * step), so the flow from frame i to frame i+1 is -step."""
    rng = np.random.default_rng(seed)
    spec = np.fft.rfft2(rng.standard_normal((3, size, size)))
    ky = np.fft.fftfreq(size)[:, None]
    kx = np.fft.rfftfreq(size)[None, :]
    spec = spec * np.exp(-(kx ** 2 + ky ** 2) * 2 * (math.pi * 2.5) ** 2)
    ramp = np.exp(2j * math.pi * (kx * VIDEO_STEP[0] + ky * VIDEO_STEP[1]))
    frames = np.stack([np.fft.irfft2(spec * ramp ** i, s=(size, size)) for i in range(n)])
    frames = frames.transpose(0, 2, 3, 1)
    return (frames - frames.min()) / (frames.max() - frames.min())


def _write_images(np, Image, images, directory, prefix):
    directory.mkdir(parents=True, exist_ok=True)
    for i, img in enumerate(images):
        Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(
            directory / f"{prefix}_{i:03d}.png")
    return directory


def _endpoint_error(np, flows):
    """Mean endpoint error (px) of [N, H, W, 2] flows against -VIDEO_STEP,
    EPE_MARGIN px in from the borders."""
    c = EPE_MARGIN
    inner = flows[:, c:-c, c:-c].float().cpu().numpy()
    return float(np.linalg.norm(inner + np.asarray(VIDEO_STEP), axis=-1).mean())


def _tvl1_ran(launches, iterations):
    """A flow call's tvl1 counts: every iteration of its 4 levels x 5 warps
    x 300 ran on the kernel, in fewer launches than iterations."""
    return iterations >= TVL1_FLOW_ITERATIONS and 0 < launches < iterations


def _tvl1_bound_s(b, h, w, iters):
    """(operations, bytes) over the card's peaks, in seconds, of one call."""
    return (TVL1_PIXEL_ITER_FLOPS * b * h * w * iters / PEAK_FLOPS_F32,
            TVL1_PIXEL_BYTES * b * h * w / PEAK_BYTES)


def _tvl1_sass_per_pixel_iteration():
    """SASS instructions of each tvl1 kernel instantiation's iteration loop
    (the backward branch spanning the most instructions), per pixel a thread
    holds, read with cuobjdump from the built library; None where the
    toolkit has no cuobjdump. Keyed "RWxRH/PPT/K"."""
    from aip_tpu_torch.kernels import _build

    tool = Path(_build._nvcc()).parent / "cuobjdump"
    if not tool.is_file():
        return None
    sass = subprocess.run([str(tool), "-sass", str(_build._target("tvl1"))],
                          capture_output=True, text=True, check=True).stdout
    out = {}
    for block in re.split(r"\n\s*Function : ", sass)[1:]:
        params = re.search(r"tvl1_blocked_kernel\D*?ILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E", block)
        if params is None:
            continue
        rw, rh, ppt, k = (int(v) for v in params.groups())
        ins = [(int(a, 16), t) for a, t in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", block)]
        loop = 0
        for at, text in ins:
            m = re.search(r"BRA\s+(?:`\()?(0x[0-9a-f]+)", text)
            if m and int(m.group(1), 16) < at:
                start = int(m.group(1), 16)
                loop = max(loop, sum(1 for a, _ in ins if start <= a <= at))
        out[f"{rw}x{rh}/{ppt}/{k}"] = {"loop_instructions": loop, "per_pixel": loop / ppt,
                                       "kernel_instructions": len(ins)}
    return out


def _tvl1_random(torch, gen, dev, b, h, w, iters, flat):
    """tvl1_inner arguments from ``gen``: the data term, warped gradients
    (0 with ``flat``, so the safe branch runs), their squared norm, a flow
    and dual fields under way; lambda 0.15, theta 0.3, tau 0.25."""
    def f(s):
        return torch.randn((b, h, w), generator=gen, device=dev) * s

    gx, gy = (f(0.0), f(0.0)) if flat else (f(0.5), f(0.5))
    return (f(0.1), gx, gy, gx * gx + gy * gy, f(0.5), f(0.5),
            tuple(f(0.2) for _ in range(4)), iters, 0.15 * 0.3, 0.3, 0.25 / 0.3)


def _tvl1_check(torch, KT, args, case):
    """The kernel against the plain version on the card, the six outputs at
    max abs <= TVL1_TOL. Returns the largest error."""
    got = KT.tvl1_inner(*args)
    torch.cuda.synchronize()
    want = KT.tvl1_inner_reference(*args)
    err = max((a - b).abs().max().item()
              for a, b in zip((got[0], got[1], *got[2]), (want[0], want[1], *want[2])))
    emit("tvl1_vs_plain", case=case, shape=list(args[0].shape), iters=args[7],
         max_abs_err=err, max_abs_u=max(want[0].abs().max().item(), want[1].abs().max().item()),
         tol=TVL1_TOL)
    if not err <= TVL1_TOL:
        raise AssertionError(f"tvl1 ({case}) is {err} off its plain version")
    return err


# The modules whose fp32 convs run under device.fp32_convs: phase 24 undoes it
# in them once, to show that its magenta gate catches cuDNN's TF32 there.
FP32_CONV_MODULES = ("aip_tpu_torch.ops.flow", "aip_tpu_torch.ops.farneback",
                     "aip_tpu_torch.models.magenta", "aip_tpu_torch.models.mobilenet")


# The magenta frame's gate, card against CPU, mean abs: fp32 convs read about
# 1e-7, the same convs in TF32 about 5e-5 (PERF.md, section 6).
MAGENTA_FP32_TOL = 1e-6


class _without_fp32_convs:
    """Within the block, ``fp32_convs`` of ``modules`` (FP32_CONV_MODULES by
    default) does nothing: cuDNN's TF32 flag alone decides how their fp32
    convs run."""

    def __init__(self, modules=FP32_CONV_MODULES):
        self.names = modules

    def __enter__(self):
        import contextlib
        import importlib

        self.mods = [importlib.import_module(m) for m in self.names]
        self.orig = [m.fp32_convs for m in self.mods]
        for m in self.mods:
            m.fp32_convs = contextlib.nullcontext

    def __exit__(self, *exc):
        for m, f in zip(self.mods, self.orig):
            m.fp32_convs = f


def _video_card_vs_cpu(torch, np, Image, video, weights, magenta, KT, vgg, dec, card,
                       default_tf32):
    """Phase 24: 6 frames at 64^2 and 2 styles, the whole fp32 video call,
    and one magenta frame at 64^2 from the committed checkpoint, on the card
    and on the CPU (the same weights): frames mean abs <= 1e-3 (video frames
    as 8-bit images scaled to [0, 1]), flows mean abs <= 1e-4 px, the
    magenta frame mean abs <= MAGENTA_FP32_TOL. On the card with TF32 off
    and with PyTorch's default flags; then, as a control, with the defaults
    and ``fp32_convs`` undone, where the magenta frame must miss that gate
    (the frames and flows are reported only)."""
    root = VIDEO_WORK / "card_vs_cpu"
    frames_dir = _write_images(np, Image, _moving_texture(np, 6, 64, 3), root / "frames", "f")
    g = np.random.default_rng(4)
    styles_dir = _write_images(np, Image, [g.random((64, 64, 3)), g.random((48, 64, 3))],
                               root / "styles", "s")
    content = torch.from_numpy(_moving_texture(np, 1, 64, 5).astype(np.float32))
    style = torch.from_numpy(g.random((64, 64, 3)).astype(np.float32))

    def run(dev, v, d):
        trace = {}
        KT.reset_launch_counts()
        paths = video.apply_style_transfer_multi_ada(
            frames_dir, styles_dir, root / f"out_{torch.device(dev).type}",
            target_resolution=(64, 64), compute_dtype=torch.float32, vgg_params=v,
            dec_params=d, device=dev, trace=trace)
        imgs = np.stack([np.asarray(Image.open(p), np.float64) for p in paths]) / 255.0
        with torch.no_grad():
            frame = magenta.stylize(magenta.load_magenta_npz(DISTILLED, device=dev),
                                    content.to(dev), style.to(dev)).cpu()
        return (imgs, trace["flows"].cpu(), frame, KT.launch_counts()["tvl1"],
                KT.iteration_counts()["tvl1"])

    i_cpu, f_cpu, m_cpu, n_cpu, it_cpu = run(
        "cpu", *(weights.from_jax_params(weights.hwio_params(m), "cpu") for m in (vgg, dec)))
    for flags, tf32, held in (("tf32_off", (False, False), True),
                              ("pytorch_defaults", default_tf32, True),
                              ("pytorch_defaults_without_fp32_convs", default_tf32, False)):
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            if held:
                i_gpu, f_gpu, m_gpu, n_gpu, it_gpu = run(card, vgg, dec)
            else:
                with _without_fp32_convs():
                    i_gpu, f_gpu, m_gpu, n_gpu, it_gpu = run(card, vgg, dec)
        finally:
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        img_err = np.abs(i_gpu - i_cpu)
        flow_err = (f_gpu - f_cpu).abs()
        mag_err = (m_gpu - m_cpu).abs()
        emit("video_card_vs_cpu", flags=flags, tf32_conv=tf32[0], tf32_matmul=tf32[1],
             fp32_convs=held, held_to_the_gates=held, control_must_miss_magenta_gate=not held,
             frames=6, size=64,
             frames_mean_abs=float(img_err.mean()), frames_max_abs=float(img_err.max()),
             flows_mean_abs_px=flow_err.mean().item(), flows_max_abs_px=flow_err.max().item(),
             magenta_frame_mean_abs=mag_err.mean().item(),
             magenta_frame_max_abs=mag_err.max().item(),
             tol_magenta_frame_mean_abs=MAGENTA_FP32_TOL, tol_frames_mean_abs=1e-3,
             tol_flows_mean_abs_px=1e-4, tvl1_launches_on_card=n_gpu,
             tvl1_iterations_on_card=it_gpu, tvl1_launches_on_cpu=n_cpu,
             tvl1_iterations_on_cpu=it_cpu)
        if held and not (img_err.mean() <= 1e-3 and flow_err.mean().item() <= 1e-4
                         and mag_err.mean().item() <= MAGENTA_FP32_TOL
                         and _tvl1_ran(n_gpu, it_gpu) and n_cpu == it_cpu == 0):
            raise AssertionError(f"the video call or the magenta frame on the card disagrees "
                                 f"with the CPU ({flags})")
        if not held and not mag_err.mean().item() > MAGENTA_FP32_TOL:
            raise AssertionError("with fp32_convs undone under TF32 the magenta frame still "
                                 "meets its gate: the gate cannot tell fp32 from TF32")


VIDEO_STAGES = ("video.load", "video.depth", "video.stylize", "video.flows", "video.blend",
                "video.save")
# The ctypes-launched kernels' stages, by kernel name (_stage_profile).
VIDEO_NAMED = (("video.flows", "tvl1_blocked_kernel"), ("video.stylize", "encode_head_kernel"),
               ("video.stylize", "decode_tail_kernel"), ("video.stylize", "encode_head_tc_kernel"),
               ("video.stylize", "decode_tail_tc_kernel"))


def _video_cli(torch, np, Image, KT, styles_dir):
    """``cli.run_video.main`` on a 4-frame mp4, where cv2 imports."""
    try:
        import cv2
    except ImportError:
        emit("video_cli", ran=False,
             reason="cv2 is not installed on this machine: the CLI's mp4 decode and encode "
                    "need it; the video path ran through the pipeline functions above")
        return
    from aip_tpu_torch.cli import run_video

    cli = VIDEO_WORK / "cli"
    cli.mkdir(parents=True, exist_ok=True)
    writer = cv2.VideoWriter(str(cli / "in.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 20,
                             (VIDEO_SIZE, VIDEO_SIZE))
    for img in _moving_texture(np, 4, VIDEO_SIZE, 5):
        writer.write((img * 255).astype(np.uint8)[..., ::-1])
    writer.release()
    KT.reset_launch_counts()
    out = run_video.main(["--video", str(cli / "in.mp4"), "--styles", str(styles_dir),
                          "--output", str(cli / "out.mp4"), "--frames_dir", str(cli / "frames"),
                          "--styled_dir", str(cli / "styled")])
    torch.cuda.synchronize()
    emit("video_cli", ran=True, entry="aip_tpu_torch.cli.run_video.main", output=out,
         exists=Path(out).is_file(), launches=KT.launch_counts(),
         iterations=KT.iteration_counts())
    if not (Path(out).is_file()
            and _tvl1_ran(KT.launch_counts()["tvl1"], KT.iteration_counts()["tvl1"])):
        raise AssertionError("the video CLI wrote no video or launched no tvl1 kernel")


# ---------------------------------------------------------------------------
# The other 3DGS render paths and the novel-view video (phases 26-30)
# ---------------------------------------------------------------------------

WALK_TOL = 1e-5
# Path -> the kernel it runs: the coefficient walk (make_inference_frame_fn
# with composite_backend="pallas"), the fused walk (rasterize_fused), the
# per-tile walk (rasterize_fast, render(renderer="pallas")).
WALK_PATHS = {"pallas": "composite_macro_blocks", "fused": "composite_from_macro",
              "fast": "composite_tiles"}
DENSE_TWINS = ("composite_macro_blocks", "composite_tiles")   # kernels with a dense twin
WALK_KERNEL_NAMES = {"composite_macro_blocks": "macro_blocks_kernel",
                     "composite_from_macro": "from_macro_kernel",
                     "composite_tiles": "walk_tiles_kernel"}
TILE_PAIR_FLOPS = 17    # kernels 6, 7 per (walked slot, pixel): offsets, power, exp, clamps, tests
BLOCK_PAIR_FLOPS = 12   # kernel 5 per (walked row, pixel): 3 products, 4 sums, exp, clamps, test
SLOT_BYTES = 40         # a gathered slot: mean 2, conic 3, colour 3, opacity, valid (float32)
COEFF_ROW_BYTES = 48    # a coefficient row (8 float32) and its colour (4)
VIDEO_FRAMES_3DGS = 16


def _walk_phases(torch, dev, bed):
    """Phases 26-30. Returns the lines of kernels 5, 6 and 7."""
    import numpy as np
    from PIL import Image

    from aip_tpu_torch.cli import render_video as cli_render_video
    from aip_tpu_torch.gs import pipeline
    from aip_tpu_torch.gs import render as GR
    from aip_tpu_torch.gs import render_video as RV
    from aip_tpu_torch.gs.cameras import Camera
    from aip_tpu_torch.gs.colorfield import precompute_features
    from aip_tpu_torch.kernels import composite as KC

    plain = {"composite_macro_blocks": KC.composite_macro_blocks_reference,
             "composite_from_macro": KC.composite_from_macro_reference,
             "composite_tiles": KC.composite_tiles_reference}
    state, field, style_f, enc = bed["state"], bed["field"], bed["style_f"], bed["enc"]
    cams, cams_1080, sel = bed["cams"], bed["cams_1080"], bed["sel"]
    bg = torch.zeros(3, device=dev)
    model_dir, style_png = bed["model_dir"], bed["style_png"]

    def fitted(label):
        fsel = bed["fitted_sel"][label]
        c = (cams if label == "bed_0037_800" else cams_1080)[0]
        return GR.settings_from_selection(fsel, c.image_height, c.image_width,
                                          max_per_tile=fsel["max_per_tile"], macro=4)

    # 26. kernels 5-7 against their plain versions ---------------------------------
    s800 = GR.settings_from_selection(sel, 800, 800, max_per_tile=sel["max_per_tile"])
    f1080 = _walk_frames(torch, GR, state, field, style_f, enc, bg, fitted("bed_0037_1088x1920"))
    f800 = _walk_frames(torch, GR, state, field, style_f, enc, bg, fitted("bed_0037_800"))
    served, served_800, served_fast = {}, {}, {}
    # Kernel 5's inputs on each 1088x1920 camera, kernel 7's on each 800^2
    # view (what run_3dgs_rendering renders per view).
    blocks_cams = [_captured(KC, "composite_macro_blocks", lambda: f1080["pallas"](c))
                   for c in cams_1080]
    tiles_views = [_captured(KC, "composite_tiles", lambda: GR.render(
        c, state, field, bg, style_f=style_f, mode="inference", settings=s800, renderer="pallas",
        precomputed_enc=enc)) for c in cams]
    served["composite_macro_blocks"], served["composite_tiles"] = blocks_cams[0], tiles_views[0]
    with _capture(KC, "composite_from_macro", served):
        f1080["fused"](cams_1080[0])
    with _capture(KC, "composite_from_macro", served_800):
        f800["fused"](cams[0])
    with _capture(KC, "composite_tiles", served_fast):
        f1080["fast"](cams_1080[0])
    torch.cuda.synchronize()
    main_err = {name: _walk_check(torch, KC, name, plain[name], *served[name], "served")
                for name in WALK_KERNEL_NAMES}
    _walk_check(torch, KC, "composite_from_macro", plain["composite_from_macro"],
                *served_800["composite_from_macro"], "served 800^2 (edge macro blocks)")
    for i, args in enumerate(blocks_cams[1:], 1):
        _walk_check(torch, KC, "composite_macro_blocks", plain["composite_macro_blocks"], *args,
                    f"served 1088x1920, camera {i}")
    for i, args in enumerate(tiles_views[1:], 1):
        _walk_check(torch, KC, "composite_tiles", plain["composite_tiles"], *args,
                    f"served 800^2, view {i}")
    _walk_check(torch, KC, "composite_tiles", plain["composite_tiles"],
                *served_fast["composite_tiles"], "served 1088x1920 (rasterize_fast)")
    for name, (args, kw), case in (_walk_edge_cases(np, torch, dev)
                                   + _fused_edge_cases(np, torch, dev)
                                   + _contour_walk_cases(np, torch, dev)):
        _walk_check(torch, KC, name, plain[name], args, kw, case)

    # 27. main path, per-tile walk: run_3dgs_rendering(renderer="pallas") ------------
    out_dir = GS_WORK / "renders_pallas"
    shutil.rmtree(out_dir, ignore_errors=True)
    KC.reset_launch_counts()
    t0 = time.perf_counter()
    gif = Path(pipeline.run_3dgs_rendering(str(style_png), str(model_dir), output_dir=str(out_dir),
                                           renderer="pallas", device=dev))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    tile_launches = KC.launch_counts()
    pngs = sorted(out_dir.glob("*.png"))
    drawn = [float((np.abs(np.asarray(Image.open(p), np.int16)).max(axis=-1) > 1).mean())
             for p in pngs]
    emit("gs_main_per_tile", entry="aip_tpu_torch.gs.pipeline.run_3dgs_rendering",
         renderer="pallas", gif=str(gif.relative_to(ROOT)), gif_exists=gif.is_file(),
         pngs=len(pngs), drawn_fraction_min=min(drawn, default=0.0), wall_s=wall_s,
         launches=tile_launches)
    others = sum(tile_launches.values()) - tile_launches["composite_tiles"]
    if not (gif.is_file() and len(pngs) == len(cams) == 8 and min(drawn) > 0.1
            and tile_launches["composite_tiles"] >= 8 and others == 0):
        raise AssertionError("run_3dgs_rendering(renderer='pallas') did not render the model "
                             "through the per-tile kernel alone")

    # 28. main paths at 1088x1920: the coefficient walk and the fused walk ----------
    main_launches = {"composite_tiles": tile_launches["composite_tiles"]}
    for path in ("pallas", "fused"):
        kernel = WALK_PATHS[path]
        KC.reset_launch_counts()
        img = f1080[path](cams_1080[0])
        torch.cuda.synchronize()
        counts = KC.launch_counts()
        main_launches[kernel] = counts[kernel]
        emit("gs_main_" + path, entry=("make_inference_frame_fn(composite_backend='pallas')"
                                       if path == "pallas" else "rasterize_fused"),
             scene="bed_0037_1088x1920", out_shape=list(img.shape),
             finite=bool(torch.isfinite(img).all()), mean=img.mean().item(), launches=counts)
        size = (cams_1080[0].image_height, cams_1080[0].image_width, 3)
        if not (img.shape == size and torch.isfinite(img).all() and counts[kernel] > 0
                and sum(counts.values()) == counts[kernel]):
            raise AssertionError(f"the {path} path did not render through {kernel} alone")
    c0 = cams[0]
    cam256 = Camera(colmap_id=0, R=c0.R, T=c0.T, FoVx=c0.FoVx, FoVy=c0.FoVy,
                    image=np.zeros((256, 256, 3), np.float32), image_name="c256", uid=0)
    s256 = GR.settings_from_selection(sel, 256, 256, max_per_tile=sel["max_per_tile"], macro=4)
    st_cpu, fd_cpu = state.to("cpu"), field.to("cpu")
    on_cpu = _walk_frames(torch, GR, st_cpu, fd_cpu, style_f.cpu(),
                          precompute_features(fd_cpu, st_cpu.xyz), bg.cpu(), s256)
    on_card = _walk_frames(torch, GR, state, field, style_f, enc, bg, s256)
    for path, kernel in WALK_PATHS.items():
        KC.reset_launch_counts()
        card = on_card[path](cam256).cpu()
        launched = KC.launch_counts()[kernel]
        diff = (card - on_cpu[path](cam256)).abs()
        emit("gs_card_vs_cpu", path=path, size=256, mean_abs=diff.mean().item(),
             max_abs=diff.max().item(), tol_mean_abs=1e-4, launches_on_card={kernel: launched})
        if not (diff.mean().item() <= 1e-4 and launched > 0):
            raise AssertionError(f"card and CPU disagree on the {path} path")
    del st_cpu, fd_cpu, on_cpu, on_card

    # 29. the novel-view video and its CLI ------------------------------------------
    _render_video_phase(torch, KC, RV, cli_render_video, model_dir, style_png, len(cams), dev)

    # 30. times ---------------------------------------------------------------------
    for label, cs in (("bed_0037_800", cams), ("bed_0037_1088x1920", cams_1080)):
        fns = f1080 if label.endswith("1920") else f800
        for path, fn in fns.items():
            frame = _cycle(lambda f, c: f(c), fn, cs)
            for _ in cs:  # warm every pose
                frame()
            KC.reset_launch_counts()
            ms = _time_ms(torch, frame)
            emit("gs_frame_time", scene=label, path=path, kernel=WALK_PATHS[path],
                 fitted_selection=bed["fitted_sel"][label], ms=ms, fps=1e3 / ms,
                 launches_per_frame={k: v / 12 for k, v in KC.launch_counts().items() if v})
    frame_device_ms, frame_stage_ms = {}, {}
    for path, fn in f1080.items():   # one frame of each camera
        kernel = WALK_PATHS[path]
        frame_device_ms[path], frame_stage_ms[path] = _stage_profile(
            torch, "gs_profile", _cycle(lambda f, c: f(c), fn, cams_1080), GS_SPANS,
            named=(("gs.composite", WALK_KERNEL_NAMES[kernel]),), calls=len(cams_1080),
            scene="bed_0037_1088x1920", path=path)
    lines = []
    per_frame = {"composite_tiles": main_launches["composite_tiles"] / len(pngs),
                 "composite_macro_blocks": main_launches["composite_macro_blocks"],
                 "composite_from_macro": main_launches["composite_from_macro"]}
    blocks = _blocks_times(torch, KC, blocks_cams, frame_stage_ms["pallas"], len(cams_1080))
    for name in ("composite_macro_blocks", "composite_from_macro", "composite_tiles"):
        args, kw = served[name]
        flops, nbytes, pairs = _walk_work(KC, name, args, kw)
        work = None
        if name == "composite_from_macro":
            work = _fused_work(KC, args, kw)
            flops = work["live_pairs"] * TILE_PAIR_FLOPS   # the live bound
        elif name == "composite_tiles":
            work = _tiles_work(KC, args)
            flops = work["live_pairs"] * TILE_PAIR_FLOPS
        t_comp, t_mem = flops / PEAK_FLOPS_F32, nbytes / PEAK_BYTES
        if name == "composite_macro_blocks":   # the medians over the cameras
            ms, (t_comp, t_mem) = blocks["median_ms_100_calls"], blocks["median_live_bound_s"]
        else:
            ms = _time_many_ms(torch, lambda: getattr(KC, name)(*args, **kw), MANY_CALLS)
        lines.append({
            "name": name, "route": "cuda", "source": f"aip_tpu_torch/csrc/{KERNELS[name][0]}.cu",
            "replaces": KERNELS[name][1], "launches": main_launches[name],
            "max_abs_err": main_err[name], "ms": ms,
            "plain_ms": _time_ms(torch, lambda: plain[name](*args, **kw), 2, 1),
            "bound_ms": max(t_comp, t_mem) * 1e3,
            "bound_by": "operations" if t_comp >= t_mem else "bytes",
            "library_ms": None,
        })
        emit("gs_walk_kernel_work", kernel=name,
             served_by="bed_0037_800 per-tile" if name == "composite_tiles"
             else "bed_0037_1088x1920 fitted, macro 4",
             in_shape=list(args[0].shape), launches_per_frame=per_frame[name], pairs=pairs,
             flops=flops, bytes=nbytes, ms_many_calls=lines[-1]["ms"], calls_in_window=MANY_CALLS,
             definition=_WALK_BOUND_NOTES[name],
             library_ms_reason="no single PyTorch call composites depth-sorted Gaussians")
        if name == "composite_from_macro":
            _fused_times(torch, KC, args, kw, lines[-1], work, nbytes,
                         frame_device_ms["fused"])
        elif name == "composite_tiles":
            _tiles_times(torch, KC, tiles_views, served_fast["composite_tiles"], lines[-1], work,
                         nbytes, frame_device_ms["fast"], frame_stage_ms["fast"])
        else:
            emit("gs_blocks_walk_times", card=_card(), **blocks, ptxas=_walk_ptxas(),
                 ms_single_call=_time_ms(torch, lambda: KC.composite_macro_blocks(*args, **kw)),
                 plain_ms=lines[-1]["plain_ms"], frame_device_ms=frame_device_ms["pallas"],
                 frame_stage_device_ms=frame_stage_ms["pallas"],
                 before_ms=BEFORE_MS["composite_macro_blocks"], after_ms=ms,
                 before_source="PERF.md section 6, row 5 (camera 0, 100 calls in one window)")
    return lines


_WALK_BOUND_NOTES = {
    "composite_macro_blocks": (
        "pairs = sum over blocks of the rows walked up to the 32-row early exit (counted by the "
        "plain version) x bs^2 (the dense bound), live pairs = those with alpha >= 1/255 (the "
        "live bound; bound_ms, ms: the medians over the 8 cameras); operations = 12 float32 per "
        "pair at 67 TFLOP/s (H100 SXM, CUDA cores; the contribution's 10 more only where alpha "
        ">= 1/255 are not counted); bytes = the walked 48-byte rows, the counts and the planes "
        "once, at 3.35 TB/s"),
    "composite_from_macro": (
        "pairs = sum over tiles of their block's slots up to its last valid one x 256 (the "
        "dense bound), live pairs = those (slot, pixel) pairs with alpha >= 1/255 (the live "
        "bound, bound_ms); operations = 17 float32 per pair at 67 TFLOP/s (the contribution's "
        "10 more only where alpha >= 1/255 are not counted); bytes = each block's walked "
        "40-byte slots, its whole valid row (scanned for the end) and the tiles once, at "
        "3.35 TB/s"),
    "composite_tiles": (
        "pairs = sum over tiles of their slots up to the last valid one x 256 (the dense "
        "bound), live pairs = those with a valid slot and alpha >= 1/255 (the live bound, "
        "bound_ms); operations = 17 float32 per pair at 67 TFLOP/s (the contribution's 10 more "
        "only where alpha >= 1/255 are not counted); bytes = the valid slots' 36 bytes, the "
        "whole valid array and the tiles once, at 3.35 TB/s"),
}


def _walk_frames(torch, GR, state, field, style_f, enc, bg, settings):
    """frame(cam) -> [H, W, 3] of each path of phases 26-30 at ``settings``
    (macro > 1), on the state's device: the serving frame function with
    composite_backend="pallas", and the serving frame's colours and
    activations through rasterize_fused and rasterize_fast."""
    from aip_tpu_torch.gs import rasterizer as R
    from aip_tpu_torch.gs.colorfield import predict_sh

    fn = GR.make_inference_frame_fn(state, field, settings._replace(composite_backend="pallas"),
                                    bg, style_f=style_f, precomputed_enc=enc)
    with torch.no_grad():
        sh = predict_sh(field, state.xyz, style_f, precomputed_enc=enc)
        scales, rotations, opacity = GR._inference_activations(state)

    def through(raster):
        @torch.no_grad()
        def frame(cam):
            vm, pm, campos = GR._camera_tensors(cam, state.xyz.device)
            colors = GR._sh_colors(sh, state.xyz, campos)
            return raster(state.xyz, scales, rotations, opacity, colors, vm, pm, bg, settings,
                          tanfovx=math.tan(cam.FoVx * 0.5), tanfovy=math.tan(cam.FoVy * 0.5))[0]
        return frame

    return {"pallas": lambda cam: GR.render_frame(fn, cam), "fused": through(R.rasterize_fused),
            "fast": through(R.rasterize_fast)}


def _walk_check(torch, KC, name, plain, args, kw, case):
    """A walk kernel against its plain version on one input: max abs <=
    WALK_TOL (both round every per-pixel operation alike), the fused walk's
    at max abs 0; kernels 5 and 7 also against their dense twins (the cull
    off), max abs 0. Returns the error against the plain version."""
    out = getattr(KC, name)(*args, **kw)
    dense = getattr(KC, name)(*args, **kw, _dense=True) if name in DENSE_TWINS else out
    torch.cuda.synchronize()
    ref = plain(*args, **kw)
    err = (out - ref).abs().max().item() if out.numel() else 0.0
    dense_err = (out - dense).abs().max().item() if out.numel() else 0.0
    tol = 0.0 if name == "composite_from_macro" else WALK_TOL
    emit("gs_walk_vs_plain", kernel=name, case=case, in_shape=list(args[0].shape),
         out_shape=list(out.shape), max_abs_err=err, tol_max_abs=tol,
         **({"dense_twin_max_abs_err": dense_err, "dense_twin_tol": 0.0}
            if name in DENSE_TWINS else {}))
    if not (out.shape == ref.shape and err <= tol and dense_err == 0.0):
        raise AssertionError(f"{name} ({case}) is {err} off its plain version and {dense_err} "
                             f"off its dense twin")
    return err


def _captured(KC, name, fn):
    """The (args, kw) of the first call of ``KC.<name>`` while ``fn()``
    runs."""
    store = {}
    with _capture(KC, name, store):
        fn()
    return store[name]


def _fused_slots(np, g, th, tw, macro, kc):
    """Fused-walk lists of a th x tw tile grid in macro blocks of ``macro``
    tiles: slots scattered up to 40 px around each block (many far from
    most of its tiles; the first at its centre), sizes 0.5-12 px, any
    rotation, opacities 0.002-1, valid a prefix of random length; the first
    list empty, the last with invalid slots between valid ones. Returns
    (arrays, kw)."""
    mth, mtw = -(-th // macro), -(-tw // macro)
    m, bs = mth * mtw, 16 * macro
    b = np.arange(m)
    cx = ((b % mtw) * bs + bs / 2)[:, None]
    cy = ((b // mtw) * bs + bs / 2)[:, None]
    mean = np.stack([cx + (g.random((m, kc)) - 0.5) * (bs + 80),
                     cy + (g.random((m, kc)) - 0.5) * (bs + 80)], -1)
    conic = _conics(np, g.uniform(0.5, 12, (m, kc)), g.uniform(0.5, 12, (m, kc)),
                    g.uniform(0, math.pi, (m, kc)))
    mean[:, 0] = np.concatenate([cx, cy], -1)      # every list draws at its centre
    op = np.exp(g.uniform(math.log(0.002), 0, (m, kc)))
    op[:, 0] = 0.8
    valid = (np.arange(kc)[None, :] < g.integers(1, kc + 1, (m, 1))).astype(np.float32)
    valid[0] = 0.0
    valid[-1, ::3] = 0.0
    return ([mean, conic, g.random((m, kc, 3)), op, valid],
            dict(n_tiles=th * tw, tile_w=tw, macro=macro, macro_tile_w=mtw))


def _conics(np, s1, s2, theta):
    """Conic (a, b, c) of the covariance R diag(s1^2, s2^2) R^T."""
    c, s = np.cos(theta), np.sin(theta)
    i1, i2 = 1 / s1 ** 2, 1 / s2 ** 2
    return np.stack([c * c * i1 + s * s * i2, c * s * (i1 - i2), s * s * i1 + c * c * i2], -1)


CONTOUR_EPS = (-1e-2, -1e-4, -1e-6, -1e-7, 0.0, 1e-7, 1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1)
CONTOUR_SHAPES = ((3.0, 3.0, 0.0), (2.0, 5.0, 0.0), (0.35, 40.0, 0.0), (60.0, 45.0, 0.0),
                  (1.5, 9.0, 0.6), (0.4, 25.0, 2.3))   # (sigma 1, sigma 2, rotation)
CONTOUR_OPS = (1.0, 0.5, 0.05, 0.0045)


def _fused_contour(np):
    """One macro block of 4 x 4 tiles listing, for each shape, opacity and
    eps, a splat up and left of pixel (48, 48), the top-left pixel of tile
    (3, 3), on the diagonal, where q(corner - mean) = L (1 + eps) and L = 2
    ln(255 op) is the 1/255 contour: just inside for eps < 0, just outside
    for eps > 0."""
    u = np.array([-1.0, -1.0]) / math.sqrt(2.0)
    mean, conic, op = [], [], []
    for s1, s2, theta in CONTOUR_SHAPES:
        a, b, c = _conics(np, np.float64(s1), np.float64(s2), np.float64(theta))
        qu = a * u[0] ** 2 + 2 * b * u[0] * u[1] + c * u[1] ** 2
        for o in CONTOUR_OPS:
            for e in CONTOUR_EPS:
                d = math.sqrt(max(2 * math.log(255 * o) * (1 + e), 0.0) / qu)
                mean.append([48.0 + d * u[0], 48.0 + d * u[1]])
                conic.append([a, b, c])
                op.append(o)
    k = len(op)
    color = np.random.default_rng(5).random((1, k, 3))
    return ([np.asarray(mean)[None], np.asarray(conic)[None], color, np.asarray(op)[None],
             np.ones((1, k))], dict(n_tiles=16, tile_w=4, macro=4, macro_tile_w=1))


def _fused_edge_cases(np, torch, dev):
    """The fused walk's lists of Kc = 2, 200 and 5120 at macro 1 to 5, tile
    grids whose last macro-block column and row hold fewer tiles, and the
    1/255 contour sweep."""
    g = np.random.default_rng(27)
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)  # noqa: E731
    bg = f([0.2, 0.1, 0.3])
    cases = []
    for kc, macro, th, tw in ((2, 1, 3, 5), (2, 4, 5, 6), (200, 2, 5, 7), (200, 3, 7, 8),
                              (200, 5, 6, 11), (5120, 4, 6, 9), (5120, 5, 7, 11)):
        arrays, kw = _fused_slots(np, g, th, tw, macro, kc)
        cases.append(("composite_from_macro", ([f(a) for a in arrays] + [bg], kw),
                      f"edge Kc={kc}, macro {macro}, {th}x{tw} tiles"))
    arrays, kw = _fused_contour(np)
    cases.append(("composite_from_macro", ([f(a) for a in arrays] + [bg], kw),
                  "1/255 contour sweep at a tile's corner"))
    return cases


def _fused_work(KC, args, kw):
    """The fused walk's work on one call (``from_macro_work``), in (slot,
    pixel) pairs: those it spans without the cull (the dense pairs), those
    its cull keeps (what it evaluates) and those with alpha >= 1/255 (the
    live pairs)."""
    dense, kept, live = KC.from_macro_work(*args[:5], **kw)
    return {"dense_pairs": dense, "kept_pairs": kept, "kept_share": kept / max(dense, 1),
            "live_pairs": live, "live_share": live / max(dense, 1)}


def _walk_ptxas():
    """Registers and spills of the kernels of composite_walk.cu, from the
    build's ptxas report: {"from_macro_kernel": {...}, "macro_blocks_kernel
    bs=64": {...}, "walk_tiles_kernel dense": {...}, ...}."""
    path = WORK / "build_composite_walk.log"
    report = path.read_text() if path.is_file() else ""
    out, cur = {}, None
    for line in report.splitlines():
        if "Compiling entry" in line:
            m = re.search(r"(from_macro_kernel|walk_tiles_kernel|macro_blocks_kernel)"
                          r"(?:I(?:Li(\d+)E)?Lb(\d)E)?", line)
            cur = None if not m else (m[1] + (f" bs={m[2]}" if m[2] else "")
                                      + (" dense" if m[3] == "0" else ""))
        elif cur is not None:
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            regs = re.search(r"Used (\d+) registers", line)
            if spill:
                out.setdefault(cur, {}).update(spill_stores=int(spill[1]),
                                               spill_loads=int(spill[2]))
            if regs:
                out.setdefault(cur, {})["registers"] = int(regs[1])
    return out or "not measured"


def _fused_times(torch, KC, args, kw, line, fused, nbytes, frame_device_ms):
    """Phase 30, the fused walk: dense and live bounds, the kept share,
    ptxas, before -> after with the fused frame's device ms and the card."""
    t_dense = fused["dense_pairs"] * TILE_PAIR_FLOPS / PEAK_FLOPS_F32
    t_mem = nbytes / PEAK_BYTES
    emit("gs_fused_walk_times", card=_card(), ms_100_calls=line["ms"],
         ms_single_call=_time_ms(torch, lambda: KC.composite_from_macro(*args, **kw)),
         dense_bound_ms=max(t_dense, t_mem) * 1e3, live_bound_ms=line["bound_ms"],
         share_of_live_bound=line["bound_ms"] / line["ms"],
         share_of_dense_bound=max(t_dense, t_mem) * 1e3 / line["ms"], **fused,
         ptxas=_walk_ptxas(),
         fused_frame_device_ms=frame_device_ms, before_ms=BEFORE_MS["composite_from_macro"],
         after_ms=line["ms"], before_source="PERF.md section 6, row 6 (100 calls in one window)")


def _contour_walk_cases(np, torch, dev):
    """Kernels 5 and 7 on the fused walk's 1/255 contour sweep at pixel (48,
    48) (``_fused_contour``): 16 tiles of a 4-tile row, each listing the
    sweep (the pixel is tile (3, 3)'s top-left), and one 64 px block of the
    sweep's rows packed by the rasterizer (the pixel is sub-tile (3, 3)'s
    top-left)."""
    from aip_tpu_torch.gs import rasterizer as R

    arrays, _ = _fused_contour(np)
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)  # noqa: E731
    bg = f([0.2, 0.1, 0.3])
    tiles = [f(np.broadcast_to(a, (16,) + a.shape[1:])) for a in arrays]
    mean, conic, color, op = (f(a[0]) for a in arrays[:4])
    idx = torch.arange(op.shape[0], dtype=torch.int32, device=dev)[None]
    coeff, gcol, gop, counts = R._macro_coeffs(idx, mean, conic, color, op, 1, 1, 64)
    zero = torch.zeros_like(gop[..., None])
    rows = [torch.cat([coeff, gop[..., None], zero], -1).contiguous(),
            torch.cat([gcol, zero], -1).contiguous(), counts, bg]
    return [("composite_tiles", (tiles + [bg, 4], {}), "1/255 contour sweep at a tile's corner"),
            ("composite_macro_blocks", (rows, dict(bs=64)),
             "1/255 contour sweep at a sub-tile's corner")]


def _tiles_work(KC, args):
    """The per-tile walk's work on one call (``tiles_work``), in (slot,
    pixel) pairs: dense, kept by its cull, live."""
    dense, kept, live = KC.tiles_work(*args[:5], args[6])
    return {"dense_pairs": dense, "kept_pairs": kept, "kept_share": kept / max(dense, 1),
            "live_pairs": live, "live_share": live / max(dense, 1)}


def _blocks_times(torch, KC, cams_args, frame_stage_ms, n_frames):
    """Phase 30, the coefficient walk on each 1088x1920 camera's inputs: ms
    over 100 calls in one window, the rows walked up to the exit, the
    dense, kept and live pairs and bounds (a line per camera); the medians
    (the kernels line's ms and bound), the mean and the sum over the
    cameras beside the profile's composite ms (one frame of each camera)."""
    per, live_s = [], []
    for i, (args, kw) in enumerate(cams_args):
        coeff, colors, counts, _ = args
        bs = kw["bs"]
        work = KC.blocks_work(coeff, colors, counts, bs)
        nbytes = (work["walked_rows"] * COEFF_ROW_BYTES + 4 * counts.numel()
                  + counts.numel() * 3 * bs * bs * 4)
        t_mem = nbytes / PEAK_BYTES
        t_dense = work["dense_pairs"] * BLOCK_PAIR_FLOPS / PEAK_FLOPS_F32
        t_live = work["live_pairs"] * BLOCK_PAIR_FLOPS / PEAK_FLOPS_F32
        live_s.append((t_live, t_mem))
        row = {"camera": i, "ms_100_calls": _time_many_ms(
            torch, lambda: KC.composite_macro_blocks(*args, **kw), MANY_CALLS), **work,
            "kept_share": work["kept_pairs"] / max(work["dense_pairs"], 1),
            "live_share": work["live_pairs"] / max(work["dense_pairs"], 1), "bytes": nbytes,
            "dense_bound_ms": max(t_dense, t_mem) * 1e3, "live_bound_ms": max(t_live, t_mem) * 1e3}
        emit("gs_blocks_walk_camera", **row)
        per.append(row)
    ms = [r["ms_100_calls"] for r in per]
    total = {k: sum(r[k] for r in per)
             for k in ("dense_pairs", "kept_pairs", "live_pairs")}
    composite = frame_stage_ms.get("gs.composite", "not measured")
    return {"per_camera_ms_100_calls": ms, "median_ms_100_calls": statistics.median(ms),
            "mean_ms_100_calls": statistics.mean(ms), "sum_ms_100_calls": sum(ms),
            "profile_composite_ms_per_frame": composite,
            "profile_composite_ms_all_cameras": (composite * n_frames
                                                 if composite != "not measured" else composite),
            "median_dense_bound_ms": statistics.median(r["dense_bound_ms"] for r in per),
            "median_live_bound_ms": statistics.median(r["live_bound_ms"] for r in per),
            "median_live_bound_s": (statistics.median(t for t, _ in live_s),
                                    statistics.median(t for _, t in live_s)),
            "kept_share": total["kept_pairs"] / max(total["dense_pairs"], 1),
            "live_share": total["live_pairs"] / max(total["dense_pairs"], 1), **total}


def _tiles_times(torch, KC, views, fast, line, work, nbytes, frame_device_ms, frame_stage_ms):
    """Phase 30, the per-tile walk: every 800^2 view's window, the dense
    and live bounds and the kept share, the 1088x1920 lists of
    rasterize_fast, ptxas, before -> after with the per-tile frame's device
    ms and the card."""
    args, kw = views[0]
    per_view = [_time_many_ms(torch, lambda: KC.composite_tiles(*a, **k), MANY_CALLS)
                for a, k in views]
    t_dense = work["dense_pairs"] * TILE_PAIR_FLOPS / PEAK_FLOPS_F32
    t_mem = nbytes / PEAK_BYTES
    fast_args, fast_kw = fast
    fast_work = _tiles_work(KC, fast_args)
    fast_bytes = _walk_work(KC, "composite_tiles", fast_args, fast_kw)[1] / PEAK_BYTES
    emit("gs_tiles_walk_times", card=_card(), ms_100_calls=line["ms"],
         ms_single_call=_time_ms(torch, lambda: KC.composite_tiles(*args, **kw)),
         per_view_ms_100_calls=per_view, median_view_ms_100_calls=statistics.median(per_view),
         dense_bound_ms=max(t_dense, t_mem) * 1e3, live_bound_ms=line["bound_ms"],
         share_of_dense_bound=max(t_dense, t_mem) * 1e3 / line["ms"],
         share_of_live_bound=line["bound_ms"] / line["ms"], **work, ptxas=_walk_ptxas(),
         rasterize_fast_1088x1920={
             "in_shape": list(fast_args[0].shape), **fast_work,
             "ms_100_calls": _time_many_ms(torch, lambda: KC.composite_tiles(*fast_args,
                                                                             **fast_kw),
                                           MANY_CALLS),
             "dense_bound_ms": max(fast_work["dense_pairs"] * TILE_PAIR_FLOPS / PEAK_FLOPS_F32,
                                   fast_bytes) * 1e3,
             "live_bound_ms": max(fast_work["live_pairs"] * TILE_PAIR_FLOPS / PEAK_FLOPS_F32,
                                  fast_bytes) * 1e3},
         frame_device_ms=frame_device_ms, frame_stage_device_ms=frame_stage_ms,
         before_ms=BEFORE_MS["composite_tiles"], after_ms=line["ms"],
         before_source="PERF.md section 6, row 7 (view 0, 100 calls in one window)")


def _walk_edge_cases(np, torch, dev):
    """Per-tile slots with an empty tile, a tile saturating below T = 1e-4,
    a splat at the 0.99 clamp, one below 1/255 and invalid slots between
    valid ones (K 40 and K 1); a 5 x 7 tile grid of 2 x 2-tile blocks with
    an empty block, a list that ends early and lists of 700 slots; blocks
    of 16, 32 and 64 px with count 0, a count of 37, a block opaque within
    its first 32-row group and one drawn near its origin only."""
    g = np.random.default_rng(26)
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)  # noqa: E731
    bg = f([0.2, 0.1, 0.3])

    def slots(rows, k, x0, y0, spread=20.0):
        mean = np.stack([x0[:, None] + g.random((rows, k)) * spread - 2,
                         y0[:, None] + g.random((rows, k)) * spread - 2], -1)
        sig = g.random((rows, k)) * 4 + 1.5
        conic = np.stack([1 / sig ** 2, (g.random((rows, k)) - 0.5) * 0.3 / sig ** 2,
                          1 / (sig * (g.random((rows, k)) + 0.6)) ** 2], -1)
        valid = np.ones((rows, k))
        valid[:, k - k // 4:] = 0.0
        return [mean, conic, g.random((rows, k, 3)), g.random((rows, k)) * 0.7 + 0.1, valid]

    cases = []
    t = np.arange(8)
    for k in (40, 1):
        mean, conic, color, op, valid = slots(8, k, (t % 4) * 16.0, (t // 4) * 16.0)
        if k > 1:
            valid[1] = 0.0
            conic[2, :, 0] = conic[2, :, 2] = 1e-3
            conic[2, :, 1] = 0.0
            op[2], valid[2] = 0.98, 1.0
            mean[3, 0] = [55.5, 7.5]   # the centre of tile 3
            op[3, 0], op[3, 1] = 1.0, 0.003
            valid[4, ::3] = 0.0
        cases.append(("composite_tiles", ([f(a) for a in (mean, conic, color, op, valid)]
                                          + [bg, 4], {}), f"edge K={k}"))
    b = np.arange(12)
    arrays = slots(12, 700, (b % 4) * 32.0, (b // 4) * 32.0, spread=36.0)
    arrays[4][3] = 0.0
    arrays[4][5, 7:] = 0.0
    cases.append(("composite_from_macro", ([f(a) for a in arrays] + [bg],
                                           dict(n_tiles=35, tile_w=7, macro=2, macro_tile_w=4)),
                  "edge 5x7 tiles, Kc=700"))
    for bs, kc in ((16, 40), (32, 100), (64, 1000)):
        m = 6
        mx, my = g.random((m, kc)) * bs, g.random((m, kc)) * bs
        mx[3], my[3] = g.random(kc) * bs * 0.2, g.random(kc) * bs * 0.2
        sig = g.random((m, kc)) * 6 + 1.5
        ca, cc = 1 / sig ** 2, 1 / (sig * (g.random((m, kc)) + 0.6)) ** 2
        cb = (g.random((m, kc)) - 0.5) * 0.3 / sig ** 2
        ca[2, :10], cc[2, :10], cb[2, :10] = 1e-4, 1e-4, 0.0
        op = g.random((m, kc)) * 0.8 + 0.1
        op[2, :10] = 0.99
        coeff = np.stack([-0.5 * (ca * mx * mx + cc * my * my) - cb * mx * my, ca * mx + cb * my,
                          cc * my + cb * mx, -0.5 * ca, -0.5 * cc, -cb, op, 0 * op], -1)
        colors = np.concatenate([g.random((m, kc, 3)), np.zeros((m, kc, 1))], -1)
        counts = torch.tensor([0, min(37, kc), kc, kc, kc, kc // 2], dtype=torch.int32,
                              device=dev)
        cases.append(("composite_macro_blocks", ([f(coeff), f(colors), counts, bg], dict(bs=bs)),
                      f"edge bs={bs}, Kc={kc}"))
    return cases


def _walk_work(KC, name, args, kw):
    """(operations, bytes, pairs) of one walk-kernel call, counted from this
    call's data: the slots or rows the kernel walks."""
    if name == "composite_macro_blocks":
        coeff, colors, counts, _ = args
        bs = kw["bs"]
        rows = KC.blocks_walked_rows(coeff, colors, counts, bs)
        pairs = rows * bs * bs
        return (pairs * BLOCK_PAIR_FLOPS,
                rows * COEFF_ROW_BYTES + 4 * counts.numel() + counts.numel() * 3 * bs * bs * 4,
                pairs)
    valid = args[4]
    ends = KC.valid_ends(valid).long()
    if name == "composite_tiles":
        n_tiles, walked = valid.shape[0], ends
    else:
        n_tiles = kw["n_tiles"]
        walked = ends[KC.macro_of_tile(n_tiles, kw["tile_w"], kw["macro"], kw["macro_tile_w"],
                                       valid.device)]
    pairs = int(walked.sum()) * 256
    # The walked slots, and the whole valid array (the kernel scans it for the end).
    nbytes = int(ends.sum()) * (SLOT_BYTES - 4) + valid.numel() * 4 + n_tiles * 3 * 256 * 4
    return pairs * TILE_PAIR_FLOPS, nbytes, pairs


def _render_video_phase(torch, KC, RV, cli_render_video, model_dir, style_png, n_views, dev):
    """Phase 29: ``render_video`` of the committed model, 16 frames on the
    ellipse path through the orbit cameras, read back from the mp4; then
    ``cli.render_video.main`` with ``--circular`` (4 frames) and
    ``--gaussians`` (each view and 10 jittered ones)."""
    import cv2

    KC.reset_launch_counts()
    t0 = time.perf_counter()
    mp4 = RV.render_video(str(model_dir), str(style_png), n_frames=VIDEO_FRAMES_3DGS, fps=8,
                          device=dev)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = KC.launch_counts()
    cap = cv2.VideoCapture(mp4)
    n, shape = 0, None
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        n, shape = n + 1, list(frame.shape)
    cap.release()
    emit("gs_render_video", entry="aip_tpu_torch.gs.render_video.render_video",
         mp4=str(Path(mp4).relative_to(ROOT)), frames=n, frame_shape=shape, wall_s=wall_s,
         launches=launches)
    if not (n == VIDEO_FRAMES_3DGS and sum(launches.values()) >= VIDEO_FRAMES_3DGS):
        raise AssertionError(f"render_video wrote {n} frames, launched {launches}")
    t0 = time.perf_counter()
    outs = cli_render_video.main(["-m", str(model_dir), "--style", str(style_png), "--circular",
                                  "--gaussians", "--n_frames", "4", "--device", str(dev)])
    torch.cuda.synchronize()
    circular = len(list(Path(outs[0]).glob("*.png")))
    jittered = len(list(Path(outs[1]).glob("view_*/jitter/*.png")))
    emit("gs_render_video_cli", entry="aip_tpu_torch.cli.render_video.main",
         outputs=[str(Path(o).relative_to(ROOT)) for o in outs], circular_pngs=circular,
         jittered_pngs=jittered, wall_s=time.perf_counter() - t0)
    if not (circular == 4 and jittered == 10 * n_views):
        raise AssertionError("the render_video CLI did not write its frames")



# ---------------------------------------------------------------------------
# Localized style transfer, DeepLabV3-ResNet101 and 3DGS evaluation (31-33)
# ---------------------------------------------------------------------------

SLICE5_WORK = WORK / "slice5"
CONTENT_HW = (768, 1024)   # the localized content image, H x W (non-square)
MASK_BAND = 1e-4           # masks may differ where background_probability is this near 0.5
LOCALIZED_TOL = 1e-3       # the combined array, card against CPU, mean abs (BASELINE.md)
# DeepLab logits, card against the port on the CPU: max abs over max |logit|.
# On an H100 at 1x768x1024 fp32 convs read 6.4e-6 (TF32 off and under
# PyTorch's defaults alike), the same convs in TF32 1.8e-3: the limit lies
# an order of magnitude from each.
DEEPLAB_TOL = 1e-4
LPIPS_TOL = 1e-5           # one 800^2 LPIPS VGG16 pair, card against CPU, relative
EVAL_ITERS, EVAL_FREEZE = 60, 40
# Phase 32's device time by op group: the top-level aten op a kernel was
# launched under.
DEEPLAB_GROUPS = {"aten::conv2d": "convolutions", "aten::einsum": "bilinear resize",
                  "aten::max_pool2d": "stem max pool", "aten::mean": "ASPP image pooling",
                  "aten::cat": "ASPP concat", "aten::sub": "BN and ReLU",
                  "aten::mul": "BN and ReLU", "aten::add": "BN, ReLU and residual",
                  "aten::rsqrt": "BN and ReLU", "aten::relu": "BN and ReLU",
                  "aten::softmax": "softmax and threshold", "aten::gt": "softmax and threshold"}
# The modules whose fp32 convs phase 32's control runs without fp32_convs.
DEEPLAB_CONV_MODULES = ("aip_tpu_torch.models.deeplab", "aip_tpu_torch.models.resnet")


def _object_content(np, h, w, seed=0):
    """A content image whose classical mask is meaningful: a plain border
    colour, a shaded elliptical object of another colour covering about a
    third of the frame, and noise (numpy ``seed``)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.empty((h, w, 3), np.float32)
    img[:] = (0.35, 0.55, 0.75)
    r2 = ((yy - 0.55 * h) / (0.34 * h)) ** 2 + ((xx - 0.45 * w) / (0.3 * w)) ** 2
    shade = 0.75 + 0.25 * np.cos(xx / w * 9.0) * np.sin(yy / h * 7.0)
    obj = r2 < 1
    img[obj] = np.stack([0.85 * shade, 0.3 * shade, 0.2 + 0.1 * shade], -1)[obj]
    img += rng.normal(0, 0.02, img.shape).astype(np.float32)
    return np.clip(img, 0, 1)


def _deeplab_group(name):
    return DEEPLAB_GROUPS.get(name)


def _slice5_phases(torch, dev, default_tf32):
    """Phases 31-33 (localized style transfer with the classical and the
    DeepLab segmenter, DeepLabV3-ResNet101 at full depth, the 3DGS
    evaluation tools). No kernel is new: the localized path runs the fp32
    AdaIN kernels, the evaluation's training and render runs A, B, C and a
    render compositor."""
    import copy

    import numpy as np
    from PIL import Image

    from aip_tpu_torch.cli import run_semantic_segm
    from aip_tpu_torch.kernels import adain_head as KA
    from aip_tpu_torch.models import decoder as DEC
    from aip_tpu_torch.models import deeplab as DL
    from aip_tpu_torch.models import segmenter as SEG
    from aip_tpu_torch.models import vgg as VGG
    from aip_tpu_torch.models.vgg19_std import normalize_imagenet
    from aip_tpu_torch.pipelines import localized as LOC
    from aip_tpu_torch.pipelines.adain_infer import _to_array

    shutil.rmtree(SLICE5_WORK, ignore_errors=True)
    SLICE5_WORK.mkdir(parents=True)
    h, w = CONTENT_HW
    content_png, style_png = SLICE5_WORK / "content.png", SLICE5_WORK / "style.png"
    Image.fromarray((_object_content(np, h, w) * 255).astype(np.uint8)).save(content_png)
    g = np.random.default_rng(1)
    Image.fromarray((g.random((512, 512, 3)) * 255).astype(np.uint8)).save(style_png)
    content = _to_array(content_png)

    # 31. localized, full width, the classical segmenter ----------------------------
    _set_tf32(torch, default_tf32)
    try:
        prob_card = SEG.background_probability(torch.from_numpy(content).to(dev)).cpu()
        mask_card = SEG.extract_background_mask(content, device=dev).cpu().numpy()
        served = {}

        def by_shape(name):
            return lambda a: (name, tuple(a[0].shape), a[0].dtype)

        KA.reset_launch_counts()
        t0 = time.perf_counter()
        with _capture(VGG, "encode_head", served, key=by_shape("encode_head")), \
                _capture(DEC, "decode_tail", served, key=by_shape("decode_tail")):
            result = LOC.run_localized_style_transfer(
                str(content_png), str(style_png), output_path=str(SLICE5_WORK / "card"),
                device=dev)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        fp32_launches = KA.route_launch_counts()["fp32"]
        combined_card = LOC.composite_localized(
            content, _to_array(SLICE5_WORK / "card" / "test.jpg"), mask_card, device=dev)
    finally:
        _set_tf32(torch, (False, False))
    prob_cpu = SEG.background_probability(torch.from_numpy(content))
    mask_cpu = SEG.extract_background_mask(content, device="cpu").numpy()
    differ = mask_card != mask_cpu
    in_band = (prob_cpu - 0.5).abs().numpy() <= MASK_BAND
    LOC.run_localized_style_transfer(str(content_png), str(style_png),
                                     output_path=str(SLICE5_WORK / "cpu"),
                                     segment_fn=lambda _img: mask_card, device="cpu")
    combined_cpu = LOC.composite_localized(
        content, _to_array(SLICE5_WORK / "cpu" / "test.jpg"), mask_card, device="cpu")
    err = np.abs(combined_card - combined_cpu)
    bg_share = float(mask_card.mean())
    emit("localized_main", entry="aip_tpu_torch.pipelines.localized.run_localized_style_transfer",
         segmenter="classical (border colour)", content_hw=[h, w], style_hw=[512, 512],
         flags="pytorch_defaults", tf32_conv=default_tf32[0], tf32_matmul=default_tf32[1],
         result=str(Path(result).relative_to(ROOT)), result_size=Image.open(result).size,
         background_share=bg_share, fp32_launches=fp32_launches, wall_s_first_call=first_s,
         masks_differ_px=int(differ.sum()), masks_differ_outside_band_px=int(
             (differ & ~in_band).sum()), pixels_in_band=int(in_band.sum()), band=MASK_BAND,
         combined_mean_abs=float(err.mean()), combined_max_abs=float(err.max()),
         tol_combined_mean_abs=LOCALIZED_TOL, card_max_abs_prob_diff=float(
             (prob_card - prob_cpu).abs().max()))
    if not (Path(result).is_file() and Image.open(result).size == (w, h)):
        raise AssertionError("the localized call wrote no result of the content's size")
    if not 0.2 <= bg_share <= 0.8:
        raise AssertionError(f"the classical mask keeps {bg_share} background, not 20-80 %")
    if min(fp32_launches.values()) <= 0:
        raise AssertionError(f"an fp32 AdaIN kernel was not launched: {fp32_launches}")
    if (differ & ~in_band).any():
        raise AssertionError("card and CPU masks differ outside the threshold band")
    if not err.mean() <= LOCALIZED_TOL:
        raise AssertionError(f"the combined arrays differ by {err.mean()} mean abs")
    for (name, _, _), (a, _) in served.items():
        _adain_check(torch, KA, name, a[0], a[1:], "localized served")
    del served

    _set_tf32(torch, default_tf32)
    try:
        wall_ms = [1e3 * _wall_s(torch, lambda: LOC.run_localized_style_transfer(
            str(content_png), str(style_png), output_path=str(SLICE5_WORK / "card"),
            device=dev)) for _ in range(3)]
        _profile(torch, lambda: LOC.run_localized_style_transfer(
            str(content_png), str(style_png), output_path=str(SLICE5_WORK / "card"), device=dev),
            calls=1, label="localized_profile",
            call="run_localized_style_transfer, 1024x768 content, 512^2 style, fp32")
        _conv_profile(torch, lambda: LOC.run_localized_style_transfer(
            str(content_png), str(style_png), output_path=str(SLICE5_WORK / "card"), device=dev),
            "localized_conv_profile")
        KA.reset_launch_counts()
        cli_out = run_semantic_segm.main(["--content", str(content_png), "--style",
                                          str(style_png), "--output", str(SLICE5_WORK / "cli")])
        torch.cuda.synchronize()
    finally:
        _set_tf32(torch, (False, False))
    cli_launches = KA.route_launch_counts()["fp32"]
    emit("localized_time", wall_ms=statistics.median(wall_ms), wall_ms_runs=wall_ms,
         timing="host clock, median of 3, JPEG IO included")
    emit("localized_cli", entry="aip_tpu_torch.cli.run_semantic_segm.main",
         output=str(Path(cli_out).relative_to(ROOT)), fp32_launches=cli_launches)
    if not (Path(cli_out).is_file() and min(cli_launches.values()) > 0):
        raise AssertionError("the run_semantic_segm CLI wrote nothing or launched no kernel")

    # 32. DeepLabV3-ResNet101 at full depth, fp32 ------------------------------------
    t0 = time.perf_counter()
    params_cpu = DL.get_deeplab_params(device="cpu")
    params = copy.deepcopy(params_cpu).to(dev)
    x_cpu = normalize_imagenet(torch.from_numpy(content))[None]
    x = x_cpu.to(dev)
    with torch.no_grad():
        t1 = time.perf_counter()
        ref = DL.deeplab_logits(params_cpu, x_cpu)
        cpu_s = time.perf_counter() - t1
    scale = ref.abs().max().item()
    depth = [len(s) for s in params["stages"]]
    errs = {}
    for flags, tf32, held in (("tf32_off", (False, False), True),
                              ("pytorch_defaults", default_tf32, True),
                              ("pytorch_defaults_without_fp32_convs", default_tf32, False)):
        _set_tf32(torch, tf32)
        try:
            with torch.no_grad():
                if held:
                    out = DL.deeplab_logits(params, x).cpu()
                else:
                    with _without_fp32_convs(DEEPLAB_CONV_MODULES):
                        out = DL.deeplab_logits(params, x).cpu()
        finally:
            _set_tf32(torch, (False, False))
        errs[flags] = (out - ref).abs().max().item() / scale
        emit("deeplab_card_vs_cpu", flags=flags, tf32_conv=tf32[0], tf32_matmul=tf32[1],
             fp32_convs=held, control_must_miss=not held, blocks_per_stage=depth,
             input_hw=[h, w], out_shape=list(out.shape), finite=bool(torch.isfinite(out).all()),
             max_abs_logit=scale, rel_max_abs_err=errs[flags], tol=DEEPLAB_TOL,
             cpu_forward_s=cpu_s)
        if held and not (out.shape == (1, h, w, DL.NUM_CLASSES) and torch.isfinite(out).all()
                         and errs[flags] <= DEEPLAB_TOL):
            raise AssertionError(f"DeepLab logits on the card disagree with the CPU ({flags})")
        if not held and not errs[flags] > DEEPLAB_TOL:
            raise AssertionError("with fp32_convs undone under TF32 the DeepLab logits still "
                                 "meet their gate: the gate cannot tell fp32 from TF32")
    del out, ref, params_cpu
    SEG.register_segmenter(DL.make_background_segmenter(params))
    try:
        KA.reset_launch_counts()
        deeplab_result = LOC.run_localized_style_transfer(
            str(content_png), str(style_png), output_path=str(SLICE5_WORK / "deeplab"),
            device=dev)
        torch.cuda.synchronize()
        dl_mask = SEG.extract_background_mask(content, device=dev)
    finally:
        SEG.register_segmenter(None)
    dl_launches = KA.route_launch_counts()["fp32"]
    emit("localized_deeplab", segmenter="deeplab.make_background_segmenter (registered)",
         result=str(Path(deeplab_result).relative_to(ROOT)), fp32_launches=dl_launches,
         background_share=float(dl_mask.float().mean()))
    if not (Path(deeplab_result).is_file() and min(dl_launches.values()) > 0):
        raise AssertionError("the registered DeepLab segmenter's localized run failed")

    def forward():
        with torch.no_grad():
            return DL.deeplab_logits(params, x)

    fwd_ms = _time_ms(torch, forward)
    flops = _deeplab_flops(params, h, w)
    dev_ms, groups = _stage_profile(torch, "deeplab_profile", forward,
                                    tuple(dict.fromkeys(DEEPLAB_GROUPS.values())),
                                    stage_of=_deeplab_group,
                                    call="deeplab_logits, 1x768x1024, fp32, TF32 off")
    emit("deeplab_time", ms=fwd_ms, timing="CUDA events, median of 10", input_hw=[h, w],
         flops=flops, achieved_tflops=flops / fwd_ms / 1e9,
         fp32_cuda_core_bound_ms=flops / PEAK_FLOPS_F32 * 1e3, device_ms=dev_ms,
         group_device_ms=groups)
    del params, x
    torch.cuda.empty_cache()

    # 33. 3DGS evaluation ------------------------------------------------------------
    _eval_phase(torch, np, Image, dev, default_tf32)


def _conv_profile(torch, fn, label):
    """torch.profiler over one call of ``fn`` after a warm-up: the device
    time and launches of each ``aten::conv2d`` by its input and weight
    shapes, heaviest first (cuDNN picks an algorithm per shape). Each CPU
    event's kernels are credited once, as in ``_stage_profile``: kineto
    links a blocked launch's kernels to a second event."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    credited, rows = set(), {}

    def kernels(e):
        us, n = 0.0, 0
        if e.kernels and e.id not in credited:
            credited.add(e.id)
            us, n = sum(k.duration for k in e.kernels), len(e.kernels)
        for c in e.cpu_children:
            cu, cn = kernels(c)
            us, n = us + cu, n + cn
        return us, n

    for e in prof.events():
        if e.name == "aten::conv2d":
            key = json.dumps(e.input_shapes[:2])
            us, n = kernels(e)
            calls, total_us, launches = rows.get(key, (0, 0.0, 0))
            rows[key] = (calls + 1, total_us + us, launches + n)
    top = sorted(rows.items(), key=lambda kv: -kv[1][1])
    emit(label, convs=[{"input_weight_shapes": json.loads(k), "calls": c, "device_ms": us / 1e3,
                        "launches": n} for k, (c, us, n) in top[:8]],
         conv_device_ms=sum(us for _, us, _ in rows.values()) / 1e3)


def _set_tf32(torch, flags):
    """Set cuDNN's and the matmuls' TF32 flags to ``flags``."""
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def _wall_s(torch, fn):
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _deeplab_flops(params, h, w):
    """2 x the multiply-adds of the convs of ``deeplab_logits`` at h x w."""
    def out(n, stride):
        return (n - 1) // stride + 1

    total = 0
    hh, ww = out(h, 2), out(w, 2)
    total += hh * ww * params["stem_w"].numel()
    hh, ww = out(hh, 2), out(ww, 2)
    for si, stage in enumerate(params["stages"]):
        for bi, block in enumerate(stage):
            s = 2 if si == 1 and bi == 0 else 1
            total += hh * ww * block["conv1_w"].numel()
            if "down_w" in block:
                total += out(hh, s) * out(ww, s) * block["down_w"].numel()
            hh, ww = out(hh, s), out(ww, s)
            total += hh * ww * (block["conv2_w"].numel() + block["conv3_w"].numel())
    a = params["aspp"]
    total += hh * ww * (sum(c.numel() for c in a["convs"]) + a["project_w"].numel()
                        + params["head_w"].numel() + params["cls_w"].numel())
    total += a["pool_w"].numel()
    return 2 * total


def _eval_phase(torch, np, Image, dev, default_tf32):
    """Phase 33: ``run_full_eval`` over phase 18's training scene as both
    Deep Blending scenes, 60 iterations at full width, then the evaluation
    of the 800^2 renders against the scene's images, and LPIPS card vs CPU."""
    import copy

    from aip_tpu_torch.gs import full_eval as FE
    from aip_tpu_torch.gs import metrics_cli as MC
    from aip_tpu_torch.gs.dataset import Scene
    from aip_tpu_torch.kernels import composite as KC
    from aip_tpu_torch.kernels import composite_ad as KAD
    from aip_tpu_torch.kernels import hashgrad as KH
    from aip_tpu_torch.models import lpips as LP

    scene_dir = TRAIN_WORK / "scene"
    style_png = GS_WORK / "style.png"
    db = SLICE5_WORK / "deepblending"
    db.mkdir(parents=True)
    for name in FE.DEEP_BLENDING:
        (db / name).symlink_to(scene_dir, target_is_directory=True)
    out_root = SLICE5_WORK / "eval"
    for mod in (KAD, KH, KC):
        mod.reset_launch_counts()
    t0 = time.perf_counter()
    res = FE.run_full_eval(str(style_png), str(out_root), deepblending=str(db),
                           iterations=EVAL_ITERS, freeze_iters=EVAL_FREEZE, device=dev)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {**KAD.launch_counts(), **KH.launch_counts()}
    render = KC.launch_counts()
    models = [str(out_root / n) for n in FE.DEEP_BLENDING]
    emit("full_eval", entry="aip_tpu_torch.gs.full_eval.run_full_eval", scenes=FE.DEEP_BLENDING,
         iterations=EVAL_ITERS, freeze_iters=EVAL_FREEZE, result=res, wall_s=wall_s,
         launches=launches, render_launches=render)
    if res != {m: {} for m in models}:
        raise AssertionError(f"run_full_eval returned {res}, not {{model: {{}}}} for each scene")
    if min(launches.values()) <= 0 or sum(render.values()) <= 0:
        raise AssertionError(f"a kernel of the evaluation path was not launched: {launches}, "
                             f"{render}")

    cams = Scene(str(scene_dir), shuffle=False).getTrainCameras()
    for m in models:
        method = Path(m) / "test" / f"ours_{EVAL_ITERS}"
        (method / "renders").mkdir(parents=True)
        (method / "gt").mkdir()
        for i, cam in enumerate(cams):
            shutil.copy(Path(m) / "renders" / f"{i:05d}.png", method / "renders" / f"{i:05d}.png")
            shutil.copy(scene_dir / "images" / f"{cam.image_name}.png",
                        method / "gt" / f"{i:05d}.png")
    _set_tf32(torch, default_tf32)
    try:
        t0 = time.perf_counter()
        metrics = MC.evaluate(models, use_lpips=True, device=dev)
        eval_s = time.perf_counter() - t0
    finally:
        _set_tf32(torch, (False, False))
    emit("evaluate", entry="aip_tpu_torch.gs.metrics_cli.evaluate", views=len(cams),
         size=[cams[0].image_height, cams[0].image_width], results=metrics, wall_s=eval_s)
    for m in models:
        r = metrics[m][f"ours_{EVAL_ITERS}"]
        if not (r["lpips_weights"] == "uniform-fallback"
                and all(np.isfinite(r[k]) for k in ("PSNR", "SSIM", "LPIPS"))):
            raise AssertionError(f"evaluate gave {r}")

    vgg = LP.get_vgg16_params(device=dev)
    vgg_cpu = copy.deepcopy(vgg).cpu()
    method = Path(models[0]) / "test" / f"ours_{EVAL_ITERS}"
    pair = [torch.from_numpy(np.asarray(Image.open(method / d / "00000.png").convert("RGB"),
                                        np.float32) / 255.0)[None] for d in ("renders", "gt")]
    with torch.no_grad():
        ref = LP.lpips(*pair, vgg_cpu)
        _set_tf32(torch, default_tf32)
        try:
            on_card = LP.lpips(*[p.to(dev) for p in pair], vgg).cpu()
            lpips_ms = _time_ms(torch, lambda: LP.lpips(*[p.to(dev) for p in pair], vgg))
        finally:
            _set_tf32(torch, (False, False))
    rel = ((on_card - ref).abs() / ref.abs()).max().item()
    emit("lpips_card_vs_cpu", net="vgg", size=list(pair[0].shape[1:3]), flags="pytorch_defaults",
         card=on_card.item(), cpu=ref.item(), rel_err=rel, tol=LPIPS_TOL, pair_ms=lpips_ms,
         timing="CUDA events, median of 10, the pair's host-to-card copies included")
    if not rel <= LPIPS_TOL:
        raise AssertionError(f"LPIPS on the card is {rel} from the CPU")


SLICE6_WORK = WORK / "slice6"
PHOTO_HW = (768, 1024)       # the pixelize and NST content image, H x W
SPRITE_HW = (48, 64)         # the depixelized sprite
# The sha256 of the JAX package's depixelize of that sprite (numpy seed 0)
# at scale 10, taken on the CPU with Pillow 12.1.0; the port's raster on the
# card's machine must have the same bytes.
SPRITE_RASTER_SHA256 = "84ca4e5fb142b54acf08a6e6fbd59f8777e6fc741ea9de3f5e8dcdac6679e896"
PALETTES = ("pico-8", "sweetie-16")
PIXELIZE_KW = dict(brightness=0.05, contrast=0.2)
STYLIZE_TOL = 1e-3           # both stylize branches, card against CPU, mean abs (BASELINE.md)
NST_LOSS_TOL = 1e-4          # NST step 1 at 512^2, card against CPU: loss, relative
# ... and the conv1_1 style term's image gradient, of its largest entry: an
# H100 80GB HBM3 (700 W) read 1.22e-5 with TF32 off and under PyTorch's
# defaults (the card's data-gradient conv sums in another order than the
# CPU's) and 3.83e-4 with the backward in TF32, the control.
NST_GRAD_TOL = 1e-4
# The image after 10 steps at 512^2, card against CPU, mean abs in [0, 1]:
# the same card read 2.79-2.87e-5 (max 2.3-2.5e-3, where a max-pool near-tie
# flips an early update).
NST_10_STEP_TOL = 1e-4
NET_TOL = 1e-4               # DenseNet-121 and Swin-T features, of the largest |value|
PALETTE_TOL = 1e-3           # k-means palettes from the same starts, max abs RGB
# The NST step's profile groups, by the op that launched the kernels.
NST_GROUPS = {"aten::conv2d": "conv forward", "aten::convolution_backward": "conv data gradient",
              "aten::max_pool2d": "max pools", "aten::max_pool2d_with_indices_backward":
              "max pools' backward", "aten::bmm": "Gram matrices and their gradient",
              "aten::relu": "ReLU and its backward", "aten::threshold_backward":
              "ReLU and its backward"}
# Steps and iterations of each full-width call, beside the JAX package's
# defaults; only these are cut.
NST_STEPS = {"run_style_transfer": (30, 800), "mix_styles": (100, 2000),
             "spatially_varying_style_transfer": (10, 800), "cli.run_nst": (5, 800),
             "stylize_with_palette": (20, 300)}


def _photo(np, h, w, seed=0):
    """A photograph-like float image: smooth colour gradients, a shaded
    disc and noise (numpy ``seed``)."""
    g = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32) / max(h, w)
    img = np.stack([0.5 + 0.4 * np.sin(6 * xx + 1.3), 0.5 + 0.4 * np.cos(5 * yy + 0.4),
                    0.5 + 0.4 * np.sin(4 * (xx + yy))], -1)
    disc = (xx - 0.45) ** 2 + (yy - 0.35) ** 2 < 0.04
    img[disc] = img[disc] * 0.4 + np.array([0.5, 0.3, 0.1], np.float32)
    img += g.normal(0, 0.05, img.shape)
    return np.clip(img, 0, 1).astype(np.float32)


def _sprite(np, h, w, seed=0):
    """A pixel-art sprite (numpy ``seed``): flat colours, rectangles,
    diagonal lines, a 2x2 block whose diagonals cross, a one-pixel island."""
    g = np.random.default_rng(seed)
    pal = g.integers(0, 256, (6, 3)).astype(np.uint8)
    img = np.empty((h, w, 3), np.uint8)
    img[:] = pal[0]
    for _ in range(4):
        y0, x0 = g.integers(0, h - 3), g.integers(0, w - 3)
        img[y0:y0 + g.integers(2, h // 2), x0:x0 + g.integers(2, w // 2)] = pal[g.integers(1, 6)]
    for _ in range(3):
        c, d, s = pal[g.integers(1, 6)], g.integers(0, w), (1, -1)[g.integers(0, 2)]
        for y in range(h):
            if 0 <= d + s * y < w:
                img[y, d + s * y] = c
    y, x = g.integers(1, h - 3), g.integers(1, w - 3)
    img[y, x] = img[y + 1, x + 1] = pal[1]
    img[y, x + 1] = img[y + 1, x] = pal[2]
    img[g.integers(0, h), g.integers(0, w)] = 255 - pal[0]
    return img


def _lab_picks(torch, to_lab, nearest, pixels, pal, dev):
    """Nearest palette colours in LAB on the card and on the CPU, computed as
    the ops compute them (``to_lab``, then ``nearest`` in float32). Where the
    picks differ, each must be a near-tie: on the CPU's LAB values (float64)
    the two picks' squared distances differ by no more than the two
    devices' LAB values (at most ``e`` apart, measured) and the float32
    distance's rounding (16 ulps of its largest term) can move them.
    Returns the picks (card, CPU) and the numbers."""
    lab = {d: (to_lab(pixels.to(d)).reshape(-1, 3), to_lab(pal.to(d)))
           for d in ("cpu", dev)}
    picks = {d: nearest(*lab[d]).cpu() for d in lab}
    (x_cpu, p_cpu), (x_card, p_card) = [(a.double().cpu(), b.double().cpu())
                                        for a, b in (lab["cpu"], lab[dev])]
    e = max((x_card - x_cpu).norm(dim=1).max().item(), (p_card - p_cpu).norm(dim=1).max().item())
    differ = (picks[dev] != picks["cpu"]).nonzero().flatten()
    x, a, b = x_cpu[differ], p_cpu[picks[dev][differ]], p_cpu[picks["cpu"][differ]]
    d_a, d_b = ((x - a) ** 2).sum(1), ((x - b) ** 2).sum(1)
    terms = torch.stack([(a * a).sum(1), (b * b).sum(1), 2 * (x * a).sum(1).abs(),
                         2 * (x * b).sum(1).abs(), (x * x).sum(1)], 1).amax(1)
    bound = 4 * (d_a.sqrt() + d_b.sqrt()) * e + 8 * e * e + 16 * 2.0 ** -24 * terms
    gap = (d_a - d_b).abs()
    return picks[dev], picks["cpu"], {
        "differing_px": int(differ.numel()), "lab_card_vs_cpu_max": e,
        "largest_distance_gap": gap.max().item() if differ.numel() else 0.0,
        "largest_gap_over_bound": (gap / bound).max().item() if differ.numel() else 0.0}


def _slice6_phases(torch, dev, default_tf32):
    """Phases 34-37 (the pixel-art page, optimisation NST and the style
    mixer). No kernel is new: the AdaIN branch of the pixel-art page runs
    the fp32 AdaIN kernels. Every check is made; a failing one raises after
    phase 37 has printed its lines."""
    failures = []

    def check(ok, what):
        if not ok:
            failures.append(what)
            emit("slice6_check_failed", what=what)

    shutil.rmtree(SLICE6_WORK, ignore_errors=True)
    SLICE6_WORK.mkdir(parents=True)
    _pixelize_phase(torch, dev, check)
    _depixelize_phase(torch, dev, default_tf32, check)
    torch.cuda.empty_cache()
    _nst_phase(torch, dev, default_tf32, check)
    torch.cuda.empty_cache()
    _style_mixer_phase(torch, dev, default_tf32, check)
    if failures:
        raise AssertionError(f"slice 6 checks failed: {failures}")


def _pixelize_phase(torch, dev, check):
    """Phase 34: ``pixelize`` of a 1024x768 image with each method and two
    16-colour palettes, card against the port on the CPU."""
    import numpy as np
    from PIL import Image

    from aip_tpu_torch.ops import palette as PAL
    from aip_tpu_torch.pipelines import pixel_art as PIX

    photo = SLICE6_WORK / "photo.png"
    Image.fromarray((_photo(np, *PHOTO_HW) * 255).astype(np.uint8)).save(photo)
    palettes = PIX.load_lospec_palettes()
    runs = [(name, method, 4) for name in PALETTES
            for method in ("RGB", "kd-tree", "LAB", "Floyd-Steinberg")]
    runs += [(name, method, 1) for name in PALETTES for method in ("RGB", "LAB")]
    for name, method, ds in runs:
        pal = PIX.hex_palette_to_rgb(palettes[name])
        kw = dict(downsampling_factor=ds, palette=pal, method=method, **PIXELIZE_KW)
        out = PIX.pixelize(str(photo), device=dev, **kw)
        ref = PIX.pixelize(str(photo), device="cpu", **kw)
        wall_ms = [1e3 * _wall_s(torch, lambda: PIX.pixelize(str(photo), device=dev, **kw))
                   for _ in range(3)]
        base = PIX.pixelize(str(photo), device="cpu", downsampling_factor=ds, **PIXELIZE_KW)
        x, p = torch.from_numpy(base).to(dev), torch.from_numpy(pal).to(dev)
        op = {"RGB": PAL.recolor_rgb, "kd-tree": PAL.recolor_rgb, "LAB": PAL.recolor_lab,
              "Floyd-Steinberg": PAL.floyd_steinberg}[method]
        op_ms = _time_ms(torch, lambda: op(x, p), runs=5, warmup=1)
        fields = {}
        if method == "LAB":
            card, cpu, fields = _lab_picks(torch, PAL.rgb_to_cielab_u8, PAL._nearest_indices,
                                           torch.from_numpy(base), torch.from_numpy(pal), dev)
            ok = (fields["largest_gap_over_bound"] <= 1.0
                  and np.array_equal(pal[card.numpy()].reshape(out.shape), out)
                  and np.array_equal(pal[cpu.numpy()].reshape(ref.shape), ref))
        else:
            fields = {"differing_px": int((out != ref).any(-1).sum())}
            ok = fields["differing_px"] == 0
        if method == "Floyd-Steinberg":
            fields["wavefront_steps"] = PAL.wavefront_steps(*base.shape[:2])
            fields["serial_pixel_steps"] = base.shape[0] * base.shape[1]
        emit("pixelize", entry="aip_tpu_torch.pipelines.pixel_art.pixelize", palette=name,
             colours=len(pal), method=method, downsample=ds, out_hw=list(out.shape[:2]),
             in_hw=list(PHOTO_HW), wall_ms=statistics.median(wall_ms),
             timing_wall="host clock, median of 3: PNG read, PIL resize, copies, the op",
             op_ms=op_ms, timing_op="CUDA events, median of 5, the palette op alone",
             card_equals_cpu=ok, **fields)
        check(ok and out.dtype == np.uint8, f"pixelize {name} {method} ds {ds}")


def _depixelize_phase(torch, dev, default_tf32, check):
    """Phase 35: the depixelizer on a 48x64 sprite, both stylize branches on
    its raster (card against CPU), and the two pixel-art CLIs."""
    import hashlib

    import numpy as np
    from PIL import Image

    from aip_tpu_torch.cli import run_pixelize, run_vectorize
    from aip_tpu_torch.kernels import adain_head as KA
    from aip_tpu_torch.models import decoder as DEC
    from aip_tpu_torch.models import magenta as MAG
    from aip_tpu_torch.models import vgg as VGG
    from aip_tpu_torch.pipelines import adain_infer as INF
    from aip_tpu_torch.pipelines import pixel_art as PIX

    sprite = _sprite(np, *SPRITE_HW)
    sprite_png = SLICE6_WORK / "sprite.png"
    Image.fromarray(sprite).save(sprite_png)
    t0 = time.perf_counter()
    raster = PIX.depixelize(sprite, scale=10)
    host_s = time.perf_counter() - t0
    style_png = SLICE6_WORK / "style.png"
    Image.fromarray((_photo(np, 512, 512, seed=1)[::-1] * 255).astype(np.uint8)).save(style_png)

    saved = {}
    orig_save = INF.save_image

    def spy(arr, path):
        saved[str(path)] = arr.detach().float().cpu().numpy() if isinstance(
            arr, torch.Tensor) else np.asarray(arr, np.float32)
        return orig_save(arr, path)

    INF.save_image = spy
    try:
        ref_path = PIX.depixelize_and_stylize(sprite, str(style_png), output=str(
            SLICE6_WORK / "adain_cpu"), device="cpu")
        ref = saved[str(ref_path)]
        for flags, tf32 in (("tf32_off", (False, False)), ("pytorch_defaults", default_tf32)):
            served = {}

            def by_shape(name):
                return lambda a: (name, tuple(a[0].shape), a[0].dtype)

            _set_tf32(torch, tf32)
            KA.reset_launch_counts()
            try:
                with _capture(VGG, "encode_head", served, key=by_shape("encode_head")), \
                        _capture(DEC, "decode_tail", served, key=by_shape("decode_tail")):
                    t0 = time.perf_counter()
                    path = PIX.depixelize_and_stylize(
                        sprite, str(style_png), output=str(SLICE6_WORK / f"adain_{flags}"),
                        device=dev)
                    torch.cuda.synchronize()
                    wall_s = time.perf_counter() - t0
            finally:
                _set_tf32(torch, (False, False))
            launches = KA.route_launch_counts()["fp32"]
            err = float(np.abs(saved[str(path)] - ref).mean())
            emit("depixelize_and_stylize", method="adain", flags=flags, tf32_conv=tf32[0],
                 sprite_hw=list(SPRITE_HW), scale=10, raster_hw=list(raster.shape[:2]),
                 out_shape=list(saved[str(path)].shape), fp32_launches=launches,
                 mean_abs_err=err, tol=STYLIZE_TOL, wall_s=wall_s,
                 timing="host clock, the first call in these flags: depixelize, depth, "
                        "AdaIN fp32, JPEG")
            check(err <= STYLIZE_TOL, f"adain branch {flags}: {err}")
            check(launches["encode_head"] >= 1 and launches["decode_tail"] >= 1,
                  f"adain branch {flags} launched {launches}")
            for (name, _, _), (a, _) in served.items():
                _adain_check(torch, KA, name, a[0], a[1:], "depixelize_and_stylize served")
    finally:
        INF.save_image = orig_save

    outs, orig_make = {}, MAG.make_fast_stylizer
    for label, d in (("cpu", "cpu"), ("card", dev)):
        def make(params=None, device=None, _label=label):
            fn = orig_make(params, device)

            def stylizer(frames, style):
                res = fn(frames, style)
                outs[_label] = res.detach().cpu()
                return res
            return stylizer

        MAG.make_fast_stylizer = make
        try:
            t0 = time.perf_counter()
            fast = PIX.depixelize_and_stylize(
                sprite, str(style_png), method="fast", output=str(SLICE6_WORK / f"fast_{label}"),
                magenta_params=MAG.load_magenta_npz(DISTILLED, device=d), device=d)
            fast_s = time.perf_counter() - t0
        finally:
            MAG.make_fast_stylizer = orig_make
    err = float((outs["card"] - outs["cpu"]).abs().mean())
    emit("depixelize_and_stylize", method="fast", checkpoint=str(DISTILLED.relative_to(ROOT)),
         out_shape=list(outs["card"].shape), result=str(Path(fast).relative_to(ROOT)),
         mean_abs_err=err, tol=STYLIZE_TOL, wall_s=fast_s, flags="tf32_off")
    check(err <= STYLIZE_TOL, f"fast branch: {err}")

    t0 = time.perf_counter()
    again = PIX.depixelize(sprite, scale=10)
    emit("depixelize", entry="aip_tpu_torch.pipelines.pixel_art.depixelize",
         sprite_hw=list(SPRITE_HW), scale=10, out_hw=list(raster.shape[:2]),
         pillow=Image.__version__,
         host_s=host_s, host_s_second=time.perf_counter() - t0,
         sha256=hashlib.sha256(raster.tobytes()).hexdigest(), reference_sha256=SPRITE_RASTER_SHA256,
         equal_across_calls=raster.tobytes() == again.tobytes())
    check(raster.tobytes() == again.tobytes()
          and hashlib.sha256(raster.tobytes()).hexdigest() == SPRITE_RASTER_SHA256,
          "depixelize differs across calls or from the JAX package's raster")
    vec = run_vectorize.main(["--input", str(sprite_png), "--output",
                              str(SLICE6_WORK / "cli_vectorized")])
    vec_ok = np.asarray(Image.open(vec)).tobytes() == raster.tobytes()
    pix = run_pixelize.main(["--input", str(SLICE6_WORK / "photo.png"), "--output",
                             str(SLICE6_WORK / "cli_pixelized.png"), "--method",
                             "Floyd-Steinberg", "--downsample", "4"])
    emit("pixel_art_cli", vectorize=str(Path(vec).relative_to(ROOT)),
         vectorize_equals_depixelize=vec_ok, pixelize=str(Path(pix).relative_to(ROOT)),
         pixelize_hw=list(np.asarray(Image.open(pix)).shape[:2]))
    check(vec_ok and Path(pix).is_file(), "a pixel-art CLI")


def _nst_phase(torch, dev, default_tf32, check):
    """Phase 36: optimisation NST at full width (VGG-19 to conv5_1, the
    reference's layers and weights), the step counts cut."""
    import contextlib
    import copy
    import functools

    import torch.nn.functional as F

    import numpy as np
    from PIL import Image

    from aip_tpu_torch.cli import run_nst
    from aip_tpu_torch.models import vgg19_std as V19
    from aip_tpu_torch.pipelines import nst as NST

    photo = SLICE6_WORK / "photo.png"
    styles = []
    for i in range(3):
        p = SLICE6_WORK / f"nst_style{i}.png"
        Image.fromarray((_photo(np, 512, 512, seed=10 + i)[:, ::-1] * 255).astype(
            np.uint8)).save(p)
        styles.append(str(p))
    params = V19.get_vgg19_params(device=dev)

    def timed(name, fn):
        steps, default = NST_STEPS[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(steps)
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        return out, dict(steps=steps, default_steps=default, wall_s=s, ms_a_step=1e3 * s / steps,
                         timing="host clock around the call, synchronised; targets included")

    out, t = timed("run_style_transfer", lambda n: NST.run_style_transfer(
        str(photo), styles[0], max_dim=1024, num_steps=n, params=params, device=dev))
    emit("nst", entry="aip_tpu_torch.pipelines.nst.run_style_transfer", content_hw=list(PHOTO_HW),
         out_shape=list(out.shape), finite=bool(torch.isfinite(out).all()), **t)
    check(tuple(out.shape) == (*PHOTO_HW, 3) and bool(torch.isfinite(out).all()),
          "run_style_transfer")
    out, t = timed("mix_styles", lambda n: NST.mix_styles(
        str(photo), list(zip(styles, (1.0, 2.0, 0.5))), num_steps=n, params=params, device=dev))
    emit("nst", entry="aip_tpu_torch.pipelines.nst.mix_styles", size=256, styles=3,
         out_shape=list(out.shape), finite=bool(torch.isfinite(out).all()), **t)
    check(tuple(out.shape) == (256, 256, 3) and bool(torch.isfinite(out).all()), "mix_styles")
    mask = np.zeros((*PHOTO_HW, 3), np.uint8)
    g = np.random.default_rng(0)
    cuts = np.sort(g.integers(PHOTO_HW[1] // 5, 4 * PHOTO_HW[1] // 5, 2))
    mask[:, :cuts[0], 0] = mask[:, cuts[0]:cuts[1], 1] = mask[:, cuts[1]:, 2] = 255
    mask_png = SLICE6_WORK / "nst_mask.png"
    Image.fromarray(mask).save(mask_png)
    out, t = timed("spatially_varying_style_transfer", lambda n: (
        NST.spatially_varying_style_transfer(str(photo), *styles, str(mask_png), params=params,
                                             device=dev, num_steps=n)))
    emit("nst", entry="aip_tpu_torch.pipelines.nst.spatially_varying_style_transfer",
         mask_cuts=cuts.tolist(), out_shape=list(out.shape),
         finite=bool(torch.isfinite(out).all()), **t)
    check(tuple(out.shape) == (*PHOTO_HW, 3), "spatially_varying_style_transfer")
    cli_out, t = timed("cli.run_nst", lambda n: run_nst.main(
        ["--content", str(photo), "--style", styles[0], "--steps", str(n),
         "--output", str(SLICE6_WORK / "cli_nst.png")]))
    emit("nst", entry="aip_tpu_torch.cli.run_nst.main", output=str(Path(cli_out).relative_to(
        ROOT)), size=list(Image.open(cli_out).size), **t)
    check(Image.open(cli_out).size == PHOTO_HW[::-1], "run_nst CLI")

    # Card against CPU at 512^2: step 1, then 10 steps.
    params_cpu = copy.deepcopy(params).cpu()
    c = torch.from_numpy(_photo(np, 512, 512, seed=3))[None]
    s = torch.from_numpy(_photo(np, 512, 512, seed=4)[::-1].copy())[None]
    one = torch.ones(1)
    full, pre_pool = V19.NST_STYLE_LAYERS, ("conv1_1",)

    def step(p, d, layers, dtype=torch.float32):
        content = V19.NST_CONTENT_LAYER if layers == full else layers[0]
        targets = NST.nst_targets(p, c.to(d, dtype), s.to(d, dtype), one.to(d, dtype), layers,
                                  content)
        loss, grad = NST.nst_loss_and_grad(p, *targets, style_layers=layers,
                                           content_layer=content)
        return loss.item(), grad.double().cpu()

    def grad_errors(g, ref):
        d = g - ref
        blocks = [F.avg_pool2d(t.permute(0, 3, 1, 2), 32) for t in (d, ref)]
        return {"of_largest_entry": (d.abs().max() / ref.abs().max()).item(),
                "relative_l2": (d.norm() / ref.norm()).item(),
                "summed_over_32x32_blocks_of_largest": (blocks[0].abs().max()
                                                        / blocks[1].abs().max()).item()}

    t0 = time.perf_counter()
    loss_cpu, grad_cpu = step(params_cpu, "cpu", full)
    cpu_step_s = time.perf_counter() - t0
    f64 = functools.partial(V19.extract_features, compute_dtype=torch.float64)
    NST.backbone.extract_features, orig_extract = f64, V19.extract_features
    try:
        loss64, grad64 = step(copy.deepcopy(params_cpu).double(), "cpu", full, torch.float64)
    finally:
        NST.backbone.extract_features = orig_extract
    emit("nst_step1_cpu_vs_float64", size=[512, 512], loss_rel_err=abs(loss_cpu - loss64) / loss64,
         grad_errors=grad_errors(grad_cpu, grad64),
         note="fp32 on the CPU against float64: the floor of any fp32 gradient through the pools")
    loss_pre_cpu, grad_pre_cpu = step(params_cpu, "cpu", pre_pool)
    for flags, tf32, held in (("tf32_off", (False, False), True),
                              ("pytorch_defaults", default_tf32, True),
                              ("pytorch_defaults_backward_outside_fp32_convs", default_tf32, False)):
        _set_tf32(torch, tf32)
        try:
            with contextlib.ExitStack() as stack:
                if not held:
                    stack.enter_context(_without_fp32_convs(("aip_tpu_torch.pipelines.nst",)))
                loss, grad = step(params, dev, full)
                _, grad_pre = step(params, dev, pre_pool)
        finally:
            _set_tf32(torch, (False, False))
        loss_rel = abs(loss - loss_cpu) / abs(loss_cpu)
        pre_err = ((grad_pre - grad_pre_cpu).abs().max() / grad_pre_cpu.abs().max()).item()
        emit("nst_step1_card_vs_cpu", flags=flags, tf32_conv=tf32[0], backward_in_fp32_convs=held,
             control_must_miss=not held, size=[512, 512], loss_card=loss, loss_cpu=loss_cpu,
             loss_rel_err=loss_rel, loss_tol=NST_LOSS_TOL,
             grad_errors=grad_errors(grad, grad_cpu), grad_max_abs=grad_cpu.abs().max().item(),
             conv1_1_term_grad_err_of_largest=pre_err, conv1_1_term_grad_tol=NST_GRAD_TOL,
             cpu_step_s=cpu_step_s)
        if held:
            check(loss_rel <= NST_LOSS_TOL and pre_err <= NST_GRAD_TOL, f"NST step 1 {flags}")
        else:
            check(pre_err > NST_GRAD_TOL, "NST step 1 control met the conv1_1 gradient gate")
    t0 = time.perf_counter()
    ten_cpu = NST.nst_optimize(params_cpu, c, s, one, num_steps=10, device="cpu")
    cpu_s = time.perf_counter() - t0
    _set_tf32(torch, default_tf32)
    try:
        ten = NST.nst_optimize(params, c.to(dev), s.to(dev), one.to(dev), num_steps=10,
                               device=dev).cpu()
    finally:
        _set_tf32(torch, (False, False))
    diff = (ten - ten_cpu).abs()
    emit("nst_10_steps_card_vs_cpu", flags="pytorch_defaults", size=[512, 512],
         mean_abs_err=diff.mean().item(), max_abs_err=diff.max().item(),
         tol_mean_abs=NST_10_STEP_TOL, moved_mean_abs=(ten_cpu - c).abs().mean().item(),
         cpu_s=cpu_s)
    check(diff.mean().item() <= NST_10_STEP_TOL, "NST 10 steps card against CPU")
    _nst_profile(torch, NST, params, c.to(dev), s.to(dev), one.to(dev))
    del params_cpu


def _nst_profile(torch, NST, params, c, s, one):
    """torch.profiler over one NST step at 512^2 (TF32 off): device ms by
    op group (``NST_GROUPS``) and the busy share."""
    targets = NST.nst_targets(params, c, s, one)
    _stage_profile(torch, "nst_step_profile", lambda: NST.nst_loss_and_grad(params, *targets),
                   tuple(dict.fromkeys(NST_GROUPS.values())), stage_of=NST_GROUPS.get,
                   call="nst_loss_and_grad at 512^2, VGG-19 to conv5_1, TF32 off")


def _style_mixer_phase(torch, dev, default_tf32, check):
    """Phase 37: ``stylize_with_palette`` with each backbone at 256^2 (the
    iterations cut), DenseNet-121 and Swin-T at full depth card against CPU,
    ``map_colors`` and ``extract_palette`` from the same starts."""
    import copy

    import numpy as np

    from aip_tpu_torch.models import densenet as DN
    from aip_tpu_torch.models import swin as SW
    from aip_tpu_torch.models.vgg19_std import normalize_imagenet
    from aip_tpu_torch.pipelines import style_mixer as MIX

    photo = SLICE6_WORK / "photo.png"
    style = SLICE6_WORK / "nst_style0.png"
    n, default = NST_STEPS["stylize_with_palette"]
    result = None
    for model in MIX.MODEL_LIST:
        walls = {}
        MIX.stylize_with_palette(str(photo), str(style), model=model, iterations=1, device=dev)
        for iters in (1, n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = MIX.stylize_with_palette(str(photo), str(style), model=model,
                                              iterations=iters, device=dev)
            torch.cuda.synchronize()
            walls[iters] = time.perf_counter() - t0
        ok = tuple(result.shape) == (256, 256, 3) and bool(torch.isfinite(result).all())
        emit("stylize_with_palette", model=model, size=256, iterations=n,
             default_iterations=default, wall_s=walls[n], wall_s_1_iteration=walls[1],
             ms_an_iteration=1e3 * (walls[n] - walls[1]) / (n - 1),
             timing="host clock, synchronised, after a warm-up call; an iteration's ms from the "
                    f"difference of an {n}-iteration and a 1-iteration call (each builds its "
                    "backbone)",
             out_shape=list(result.shape), finite=ok)
        check(ok, f"stylize_with_palette {model}")

    x = normalize_imagenet(torch.from_numpy(_photo(np, 256, 256, seed=5)))[None]
    for name, get, feats in (("DenseNet-121", DN.get_densenet121_params, DN.densenet121_features),
                             ("Swin-T", SW.get_swin_t_params, SW.swin_t_features)):
        params_cpu = get(device="cpu")
        params = copy.deepcopy(params_cpu).to(dev)
        with torch.no_grad():
            ref = feats(params_cpu, x)
            _set_tf32(torch, default_tf32)
            try:
                out = {k: v.cpu() for k, v in feats(params, x.to(dev)).items()}
                ms = _time_ms(torch, lambda: feats(params, x.to(dev)), runs=5)
            finally:
                _set_tf32(torch, (False, False))
        errs = {k: (out[k] - ref[k]).abs().max().item() / ref[k].abs().max().item() for k in ref}
        emit("backbone_card_vs_cpu", net=name, flags="pytorch_defaults", input_hw=[256, 256],
             taps={k: list(v.shape) for k, v in out.items()}, rel_max_abs_err=errs, tol=NET_TOL,
             forward_ms=ms, timing="CUDA events, median of 5")
        check(max(errs.values()) <= NET_TOL, f"{name} features card against CPU")

    img = result.detach().cpu()
    pal = torch.tensor(MIX.adjust_palette_hsl(MIX.hex_to_rgb_palette(
        MIX.PREDEFINED_PALETTES["Vintage"])), dtype=torch.float32)
    card, cpu, picks = _lab_picks(
        torch, MIX.rgb_to_cielab, lambda x, p: torch.argmin(MIX._sq_distances(x, p), dim=1),
        img, pal, dev)
    mapped_cpu = MIX.map_colors(img, pal)
    mapped = MIX.map_colors(img.to(dev), pal.to(dev)).cpu()
    lab_pal = MIX.rgb_to_cielab(pal)
    same_picks = (torch.equal(mapped_cpu, MIX.cielab_to_rgb(lab_pal[cpu].reshape(img.shape)))
                  and torch.equal(mapped, MIX.cielab_to_rgb(
                      MIX.rgb_to_cielab(pal.to(dev))[card.to(dev)].reshape(img.shape)).cpu()))
    init = torch.randperm(img.shape[0] * img.shape[1], generator=torch.Generator().manual_seed(0))[:5]
    pal_cpu = MIX.extract_palette(img, 5, init_idx=init)
    pal_card = MIX.extract_palette(img.to(dev), 5, init_idx=init).cpu()
    pal_err = (pal_card - pal_cpu).abs().max().item()
    emit("palette_card_vs_cpu", image="the last stylize_with_palette result, 256^2",
         map_colors=picks, map_colors_picks_reproduced=same_picks,
         extract_palette_max_abs_err=pal_err, tol=PALETTE_TOL, init_idx=init.tolist())
    check(picks["largest_gap_over_bound"] <= 1.0 and same_picks and pal_err <= PALETTE_TOL,
          "map_colors / extract_palette card vs CPU")


# ---------------------------------------------------------------------------
# AdaIN decoder training, magenta distillation, MiDaS (phases 38-40)
# ---------------------------------------------------------------------------

SLICE7_WORK = WORK / "slice7"
# Steps of each trainer's run, beside the reference's defaults; only these
# are cut.
TRAIN_STEPS = {"train_adain": (20, 160_000), "train_magenta": (20, 40_000)}
TRAIN_LOSS_TOL = 1e-4        # step 1's loss, card against CPU, relative
MIDAS_TOL = 1e-4             # MiDaS's forward, card against CPU, of the largest |value|
DEPTH_CALL_TOL = 1e-3        # the depth-aware call, card against CPU, mean abs (BASELINE.md)
# A training step's profile groups, by the op that launched the kernels; the
# fp32 head and tail kernels by name (launched through ctypes).
TRAIN_GROUPS = {"aten::conv2d": "conv forward", "aten::convolution_backward": "conv backward",
                "aten::reflection_pad2d": "reflection pads and their backward",
                "aten::reflection_pad2d_backward": "reflection pads and their backward",
                "aten::max_pool2d": "max pools and their backward",
                "aten::max_pool2d_with_indices_backward": "max pools and their backward",
                "aten::upsample_nearest2d": "upsampling and its backward",
                "aten::upsample_nearest2d_backward": "upsampling and its backward"}
TRAIN_KERNELS = (("fp32 head kernel", "encode_head_kernel"),
                 ("fp32 tail kernel", "decode_tail_kernel"))


def _slice7_phases(torch, dev, default_tf32):
    """Phases 38-40. Each check raises as it fails, after its line is
    printed. Returns the fp32 head's and tail's launches on each path."""
    import numpy as np
    from PIL import Image

    shutil.rmtree(SLICE7_WORK, ignore_errors=True)
    dirs = {}
    g = np.random.default_rng(0)
    for kind in ("content", "style"):
        d = dirs[kind] = SLICE7_WORK / kind
        d.mkdir(parents=True)
        for i in range(16):
            img = (_photo(np, 512, 512, seed=int(g.integers(1 << 31))) if kind == "content"
                   else _texture(np, g, 512))
            Image.fromarray((img * 255).astype(np.uint8)).save(d / f"{i:02d}.png")
    by_path = {"adain_train": _adain_train_phase(torch, dev, default_tf32, dirs)}
    torch.cuda.empty_cache()
    by_path["magenta_distill"] = _distill_phase(torch, dev, default_tf32, dirs)
    torch.cuda.empty_cache()
    by_path["midas_depth_call"] = _midas_phase(torch, dev, default_tf32, dirs)
    return by_path


def _texture(np, g, size):
    """A style-like texture: a few random plane waves in random colours."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    img = np.zeros((size, size, 3), np.float32)
    for _ in range(4):
        f, th, ph = g.uniform(4, 40), g.uniform(0, np.pi), g.uniform(0, 2 * np.pi)
        wave = 0.5 + 0.5 * np.sin(2 * np.pi * f * (xx * np.cos(th) + yy * np.sin(th)) + ph)
        img += wave[..., None] * g.uniform(0, 0.5, 3).astype(np.float32)
    return np.clip(img + g.normal(0, 0.03, img.shape), 0, 1).astype(np.float32)


class _plain_kernels:
    """Within the block the models call the head's and tail's plain
    versions: the float64 references on the card, which the kernels refuse."""

    def __enter__(self):
        from aip_tpu_torch.kernels import adain_head as K
        from aip_tpu_torch.models import decoder, vgg

        self.orig = (vgg.encode_head, decoder.decode_tail)
        vgg.encode_head, decoder.decode_tail = K.encode_head_reference, K.decode_tail_reference

    def __exit__(self, *exc):
        from aip_tpu_torch.models import decoder, vgg

        vgg.encode_head, decoder.decode_tail = self.orig


class _capture_kernel_args:
    """Within the block every call of the models' head and tail is recorded
    (``head``, ``tail``: lists of argument tuples) and then made."""

    def __enter__(self):
        from aip_tpu_torch.models import decoder, vgg

        self.head, self.tail = [], []
        self.orig = (vgg.encode_head, decoder.decode_tail)

        def record(calls, fn):
            def wrapper(*args):
                calls.append(tuple(a.detach() for a in args))
                return fn(*args)
            return wrapper

        vgg.encode_head = record(self.head, self.orig[0])
        decoder.decode_tail = record(self.tail, self.orig[1])
        return self

    def __exit__(self, *exc):
        from aip_tpu_torch.models import decoder, vgg

        vgg.encode_head, decoder.decode_tail = self.orig


def _fp32_gate(ref, ref64):
    """(check, report) of a gradient against the CPU's ``ref``: each
    parameter's relative L2 error within 1e-5 plus 4 times the CPU's own
    fp32 distance from float64 (``ref`` from ``ref64``) there. The floor
    differs by parameter (the decoder's deep convs read 1e-4 on the CPU,
    where per-channel style statistics make their sums cancel; the rest
    1e-6). A parameter whose float64 gradient is below 1e-6 of the largest
    (a CIN beta before another CIN: 0 in exact arithmetic) is left out."""
    norm = {k: float(v.double().norm()) for k, v in ref64.items()}
    keep = [k for k in norm if norm[k] >= 1e-6 * max(norm.values())]

    def errors(grads, against):
        return {k: float((grads[k].double().cpu() - against[k].double().cpu()).norm()) / norm[k]
                for k in keep}

    floor = errors(ref, ref64)

    def ratios(grads):
        return {k: e / (1e-5 + 4 * floor[k]) for k, e in errors(grads, ref).items()}

    def report(grads):
        r = ratios(grads)
        worst = sorted(r, key=r.get, reverse=True)[:3]
        return {"largest_over_gate": r[worst[0]],
                "worst": [{"param": k, "rel_l2_err": r[k] * (1e-5 + 4 * floor[k]),
                           "cpu_fp32_from_float64": floor[k]} for k in worst],
                "params_held": len(keep), "params_left_out": len(norm) - len(keep)}

    return (lambda grads: max(ratios(grads).values()) <= 1.0), report


def _train_cli(torch, K, name, main, argv):
    """Run a trainer's CLI with the launch counts set to 0 just before and
    read just after; returns (wall s, fp32 and bf16 launches)."""
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    main(argv)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, K.route_launch_counts()


def _step_checks(torch, K, default_tf32, label, module, loss_fn, grads_fn, loss_cpu, ref, ref64):
    """Step 1 card against CPU, TF32 off, under PyTorch's defaults, and the
    control with ``module``'s ``fp32_convs`` undone (the backward outside
    it), which must miss the gradient gate."""
    import contextlib

    held, report = _fp32_gate(ref, ref64)
    for flags, tf32, inside in (("tf32_off", (False, False), True),
                                ("pytorch_defaults", default_tf32, True),
                                ("pytorch_defaults_backward_outside_fp32_convs", default_tf32,
                                 False)):
        _set_tf32(torch, tf32)
        try:
            with contextlib.ExitStack() as stack:
                if not inside:
                    stack.enter_context(_without_fp32_convs((module,)))
                loss = loss_fn()
                grads = grads_fn()
        finally:
            _set_tf32(torch, (False, False))
        loss_rel = abs(loss - loss_cpu) / abs(loss_cpu)
        ok = held(grads)
        emit(f"{label}_step1_card_vs_cpu", flags=flags, tf32_conv=tf32[0],
             backward_in_fp32_convs=inside, control_must_miss=not inside, loss_card=loss,
             loss_cpu=loss_cpu, loss_rel_err=loss_rel, loss_tol=TRAIN_LOSS_TOL,
             no_pool_term_grad=report(grads), grad_gate_met=ok)
        if inside and not (loss_rel <= TRAIN_LOSS_TOL and ok):
            raise AssertionError(f"{label} step 1 ({flags}): card and CPU disagree")
        if not inside and ok:
            raise AssertionError(f"{label} step 1: the control met the gradient gate")


def _kernels_on_step_args(torch, K, label, cap, head_index=0):
    """Rows 1f and 2f against their plain versions on the arguments a
    step gave them (phase 3's rule)."""
    for name, args in (("encode_head", cap.head[head_index]), ("decode_tail", cap.tail[0])):
        _adain_check(torch, K, name, args[0].contiguous(), args[1:], label)


def _train_timing(torch, K, label, one, call, tail_args):
    """ms a step (CUDA events, median of 10 after 2), one step's device ms
    by op group and the busy share, and the tail's kernel and its recompute
    backward (the plain version's forward and backward) alone."""
    step_ms = _time_ms(torch, one)
    stages = tuple(dict.fromkeys(TRAIN_GROUPS.values())) + tuple(s for s, _ in TRAIN_KERNELS)
    device_ms, stage_ms = _stage_profile(torch, f"{label}_step_profile", one, stages,
                                         named=TRAIN_KERNELS, stage_of=TRAIN_GROUPS.get,
                                         call=call)
    y, *w = tail_args
    y = y.detach().requires_grad_()
    w = [t.detach().requires_grad_() for t in w]
    out = K.decode_tail(y, *w)
    g_out = torch.randn_like(out)
    recompute_ms = _time_ms(torch, lambda: torch.autograd.grad(
        K.decode_tail_reference(y, *w), [y, *w], g_out))
    kernel_ms = _time_ms(torch, lambda: K.decode_tail(y.detach(), *[t.detach() for t in w]))
    emit(f"{label}_step_time", ms_a_step=step_ms, timing="CUDA events, median of 10 after 2",
         device_ms_a_step=device_ms, tail_shape=list(y.shape), tail_kernel_ms=kernel_ms,
         tail_recompute_backward_ms=recompute_ms,
         recompute_note="the tail's backward: its plain version run again, forward and "
                        "backward, on the saved input (cuDNN convs)")
    return step_ms


def _loader_time(dirs, batches=10):
    """The CLI's data loader alone (16 decoding threads, batch 8, crop 256):
    ms a batch over ``batches`` batches after the first, host clock."""
    from aip_tpu_torch.data.images import FlatFolderDataset, infinite_batches

    it = infinite_batches(FlatFolderDataset(dirs["content"]), 8, seed=0, crop=256,
                          num_workers=16)
    next(it)
    t0 = time.perf_counter()
    for _ in range(batches):
        next(it)
    emit("train_data_loader", batch=8, crop=256, image_size=512, workers=16,
         ms_a_batch=1e3 * (time.perf_counter() - t0) / batches, batches=batches,
         cpu_count=os.cpu_count(), timing="host clock, after the first batch; a step of "
         "train_adain reads two such batches (content and style)")


def _first_batches(dirs, batch, torch):
    from aip_tpu_torch.data.images import FlatFolderDataset, infinite_batches

    c = next(infinite_batches(FlatFolderDataset(dirs["content"]), batch, seed=0, crop=256))
    s = next(infinite_batches(FlatFolderDataset(dirs["style"]), batch, seed=1, crop=256))
    return torch.from_numpy(c), torch.from_numpy(s)


def _adain_train_phase(torch, dev, default_tf32, dirs):
    """Phase 38."""
    import copy
    import json as _json

    import numpy as np

    from aip_tpu_torch.cli import train_adain
    from aip_tpu_torch.kernels import adain_head as K
    from aip_tpu_torch.models import decoder as D
    from aip_tpu_torch.models import weights
    from aip_tpu_torch.parallel import train as PT

    steps, default = TRAIN_STEPS["train_adain"]
    out = SLICE7_WORK / "adain"
    wall, routes = _train_cli(torch, K, "train_adain", train_adain.main, [
        "--content_dir", str(dirs["content"]), "--style_dir", str(dirs["style"]),
        "--save_dir", str(out / "experiments"), "--log_dir", str(out / "logs"),
        "--max_iter", str(steps), "--save_model_interval", str(steps)])
    ckpt = out / "experiments" / f"decoder_iter_{steps}.npz"
    log = out / "logs" / "train_log.jsonl"
    saved = weights.load_params_npz(ckpt) if ckpt.is_file() else []
    finite = bool(saved) and all(np.isfinite(p["w"]).all() and np.isfinite(p["b"]).all()
                                 for p in saved)
    records = [_json.loads(l) for l in log.read_text().splitlines()] if log.is_file() else None
    emit("adain_train_cli", entry="aip_tpu_torch.cli.train_adain.main", batch=8, crop=256,
         dtype="float32", steps=steps, default_steps=default, wall_s=wall,
         ms_a_step_with_data=1e3 * wall / steps, route_launches=routes,
         launches_a_step={k: v / steps for k, v in routes["fp32"].items()},
         checkpoint=str(ckpt.relative_to(ROOT)), checkpoint_convs=len(saved),
         checkpoint_finite=finite, log_written=records is not None, log_records=records,
         log_note="a record every 100 iterations, as the JAX package writes")
    if not (finite and records is not None and min(routes["fp32"].values()) > 0
            and not any(routes["bf16"].values())):
        raise AssertionError(f"train_adain: checkpoint, log or fp32 launches missing: {routes}")
    _loader_time(dirs)

    # Step 1 from the CLI's start, card against the port on the CPU.
    vgg = weights.get_vgg_params(device=dev).requires_grad_(False)
    dec = D.init_decoder_params(0, device=dev)
    c, s = _first_batches(dirs, 8, torch)
    vgg_cpu, dec_cpu = copy.deepcopy(vgg).cpu(), copy.deepcopy(dec).cpu()
    term = dict(style_weight=1.0, content_weight=0.0, style_taps=("relu1_1",))
    t0 = time.perf_counter()
    with torch.no_grad():
        loss_cpu = PT.adain_train_loss(dec_cpu, vgg_cpu, c, s)[0].item()
    _, _, ref = PT.train_loss_and_grads(dec_cpu, vgg_cpu, c, s, **term)
    cpu_s = time.perf_counter() - t0
    del vgg_cpu, dec_cpu
    with _plain_kernels():
        _, _, ref64 = PT.train_loss_and_grads(
            copy.deepcopy(dec).double(), copy.deepcopy(vgg).double(), c.to(dev).double(),
            s.to(dev).double(), compute_dtype=torch.float64, **term)
    cd, sd = c.to(dev), s.to(dev)

    def loss_fn():
        with torch.no_grad():
            return PT.adain_train_loss(dec, vgg, cd, sd)[0].item()

    emit("adain_train_cpu_reference", batch=8, crop=256, cpu_s=cpu_s,
         note="the loss, and the relu1_1 style term's gradient; float64 on the card through "
              "the plain versions")
    _step_checks(torch, K, default_tf32, "adain_train", "aip_tpu_torch.parallel.train",
                 loss_fn, lambda: PT.train_loss_and_grads(dec, vgg, cd, sd, **term)[2],
                 loss_cpu, ref, ref64)
    del ref64
    with _capture_kernel_args() as cap:
        PT.train_loss_and_grads(dec, vgg, cd, sd)
    _kernels_on_step_args(torch, K, "adain_train_step", cap)

    opt = PT.make_optimizer()
    vgg_t, state = PT.shard_train_setup([dev], vgg, dec, opt)
    step = PT.compile_train_step([dev], opt, vgg_t)
    holder = [state]

    def one():
        holder[0] = step(holder[0], cd, sd)[0]

    _train_timing(torch, K, "adain_train", one,
                  "one make_train_step step, batch 8 x 256^2, fp32, TF32 off", cap.tail[0])
    return routes["fp32"]


def _distill_phase(torch, dev, default_tf32, dirs):
    """Phase 39."""
    import copy

    import numpy as np

    from aip_tpu_torch.cli import train_magenta
    from aip_tpu_torch.kernels import adain_head as K
    from aip_tpu_torch.models import magenta as M
    from aip_tpu_torch.models import magenta_train as MT
    from aip_tpu_torch.models import weights
    from aip_tpu_torch.parallel.train import make_optimizer

    steps, default = TRAIN_STEPS["train_magenta"]
    save = SLICE7_WORK / "magenta" / "magenta.npz"
    wall, routes = _train_cli(torch, K, "train_magenta", train_magenta.main, [
        "--content_dir", str(dirs["content"]), "--style_dir", str(dirs["style"]),
        "--save_path", str(save), "--max_iter", str(steps), "--save_model_interval", str(steps)])
    emit("magenta_distill_cli", entry="aip_tpu_torch.cli.train_magenta.main", batch=8,
         crop=256, trunk="compact", lr=1e-3, steps=steps, default_steps=default, wall_s=wall,
         ms_a_step_with_data=1e3 * wall / steps, route_launches=routes,
         launches_a_step={k: v / steps for k, v in routes["fp32"].items()},
         saved=str(save.relative_to(ROOT)) if save.is_file() else None)
    if not (save.is_file() and min(routes["fp32"].values()) > 0
            and not any(routes["bf16"].values())):
        raise AssertionError(f"train_magenta: no checkpoint or fp32 launches missing: {routes}")

    vgg = weights.get_vgg_params(device=dev).requires_grad_(False)
    dec = weights.get_decoder_params(device=dev).requires_grad_(False)
    stu = M.init_magenta_params(torch.Generator().manual_seed(0), device=dev)
    c, s = _first_batches(dirs, 8, torch)
    s = s[0]
    cpu = [copy.deepcopy(m).cpu() for m in (vgg, dec)]
    stu_cpu = M.MagentaParams(*(copy.deepcopy(m).cpu() for m in stu))
    t0 = time.perf_counter()
    with torch.no_grad():
        loss_cpu = MT.distill_loss(stu_cpu, *cpu, c, s).item()
    _, ref = MT.distill_loss_and_grads(stu_cpu, *cpu, c, s, lambda_feat=0.0)
    cpu_s = time.perf_counter() - t0
    del cpu, stu_cpu
    with _plain_kernels():
        _, ref64 = MT.distill_loss_and_grads(
            M.MagentaParams(*(copy.deepcopy(m).double() for m in stu)),
            copy.deepcopy(vgg).double(), copy.deepcopy(dec).double(), c.to(dev).double(),
            s.to(dev).double(), lambda_feat=0.0)
    cd, sd = c.to(dev), s.to(dev)

    def loss_fn():
        with torch.no_grad():
            return MT.distill_loss(stu, vgg, dec, cd, sd).item()

    emit("magenta_distill_cpu_reference", batch=8, crop=256, cpu_s=cpu_s,
         note="the loss, and the pixel term's gradient (lambda_feat 0); float64 on the card "
              "through the plain versions")
    _step_checks(torch, K, default_tf32, "magenta_distill", "aip_tpu_torch.models.magenta_train",
                 loss_fn, lambda: MT.distill_loss_and_grads(stu, vgg, dec, cd, sd,
                                                            lambda_feat=0.0)[1],
                 loss_cpu, ref, ref64)
    del ref64
    with _capture_kernel_args() as cap:
        MT.distill_loss_and_grads(stu, vgg, dec, cd, sd)
    # The head's calls: teacher content, teacher style, student (with a
    # gradient), teacher features.
    emit("magenta_distill_head_calls", shapes=[list(a[0].shape) for a in cap.head],
         tail_calls=len(cap.tail))
    _kernels_on_step_args(torch, K, "magenta_distill_step", cap, head_index=2)

    opt = make_optimizer(1e-3)
    opt_state = opt.init({k: p.detach() for k, p in MT._named(stu)})
    step = MT.make_distill_step(opt, vgg, dec)
    holder = [opt_state]

    def one():
        holder[0] = step(stu, holder[0], cd, sd)[1]

    _train_timing(torch, K, "magenta_distill", one,
                  "one make_distill_step step, batch 8 x 256^2, fp32, TF32 off", cap.tail[0])

    # The saved stylizer, card against CPU on a 256^2 frame (phase 24's gate).
    frame = torch.from_numpy(_photo(np, 256, 256, seed=7))[None]
    sty = torch.from_numpy(_texture(np, np.random.default_rng(7), 256))
    with torch.no_grad():
        ref_frame = M.stylize(M.load_magenta_npz(save, device="cpu"), frame, sty)
        _set_tf32(torch, default_tf32)
        try:
            out = M.stylize(M.load_magenta_npz(save, device=dev), frame.to(dev), sty.to(dev))
            out = out.cpu()
        finally:
            _set_tf32(torch, (False, False))
    err = (out - ref_frame).abs().mean().item()
    emit("magenta_distilled_frame_card_vs_cpu", flags="pytorch_defaults", size=256,
         mean_abs_err=err, tol=MAGENTA_FP32_TOL, finite=bool(torch.isfinite(out).all()))
    if not err <= MAGENTA_FP32_TOL:
        raise AssertionError(f"the distilled stylizer's frame: card {err} from the CPU")
    return routes["fp32"]


def _midas_phase(torch, dev, default_tf32, dirs):
    """Phase 40."""
    import copy

    import numpy as np
    from PIL import Image

    from aip_tpu_torch.kernels import adain_head as K
    from aip_tpu_torch.models import depthnet
    from aip_tpu_torch.models import midas as MD
    from aip_tpu_torch.pipelines.adain_infer import adain_inference

    net = MD.init_midas_params(device=dev)
    net_cpu = copy.deepcopy(net).cpu()
    x = torch.from_numpy(_photo(np, 256, 256, seed=40))[None]
    with torch.no_grad():
        ref = MD.midas_inverse_depth(net_cpu, x)
        for flags, tf32 in (("tf32_off", (False, False)), ("pytorch_defaults", default_tf32)):
            _set_tf32(torch, tf32)
            try:
                out = MD.midas_inverse_depth(net, x.to(dev)).cpu()
            finally:
                _set_tf32(torch, (False, False))
            err = ((out - ref).abs().max() / ref.abs().max()).item()
            emit("midas_card_vs_cpu", flags=flags, input_hw=[256, 256], rel_max_abs_err=err,
                 tol=MIDAS_TOL, finite=bool(torch.isfinite(out).all()))
            if not err <= MIDAS_TOL:
                raise AssertionError(f"MiDaS ({flags}): card {err} from the CPU")
        xd = x.to(dev)
        fwd_ms = _time_ms(torch, lambda: MD.midas_inverse_depth(net, xd))
    params = sum(p.numel() for p in net.parameters())
    emit("midas_forward_time", input_hw=[256, 256], ms=fwd_ms, parameters=params,
         timing="CUDA events, median of 10 after 2, TF32 off")

    content = dirs["content"] / "00.png"
    style = dirs["style"] / "00.png"
    img = torch.from_numpy(np.asarray(Image.open(content), np.float32) / 255.0).to(dev)
    before = depthnet.estimate_proximity(img)
    outs, calls = {}, {}
    for where in ("cpu", dev):
        MD.use_midas(None, device=where)
        try:
            K.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = adain_inference(str(content), str(style), output=str(SLICE7_WORK / "depth"),
                                   file_name=f"midas_{torch.device(where).type}",
                                   save_ext=".png", use_depth=True, device=where)
            torch.cuda.synchronize()
            calls[torch.device(where).type] = (time.perf_counter() - t0, K.route_launch_counts())
            outs[torch.device(where).type] = np.asarray(Image.open(path), np.float32) / 255.0
            if where == dev:
                device_ms, _ = _stage_profile(
                    torch, "midas_depth_call_profile", lambda: adain_inference(
                        str(content), str(style), output=str(SLICE7_WORK / "depth"),
                        file_name="midas_profiled", save_ext=".png", use_depth=True,
                        device=dev), (), named=(), call="adain_inference(use_depth=True) with "
                    "MiDaS at 512^2, fp32, TF32 off, PNG IO included")
        finally:
            depthnet.register_depth_model(None)
    err = float(np.abs(outs["cuda"] - outs["cpu"]).mean())
    wall, routes = calls["cuda"]
    after = depthnet.estimate_proximity(img)
    same = bool(torch.equal(before, after))
    emit("midas_depth_call", entry="adain_inference(use_depth=True) after use_midas(None)",
         size=512, dtype="float32", out_shape=list(outs["cuda"].shape), mean_abs_err=err,
         tol=DEPTH_CALL_TOL, wall_ms=1e3 * wall, cpu_wall_ms=1e3 * calls["cpu"][0],
         device_ms=device_ms, route_launches=routes,
         classical_proxy_restored=same)
    if not (err <= DEPTH_CALL_TOL and min(routes["fp32"].values()) > 0 and same):
        raise AssertionError(f"the MiDaS depth call failed: err {err}, launches {routes}, "
                             f"classical proxy restored {same}")
    return routes["fp32"]


if __name__ == "__main__":
    main()
