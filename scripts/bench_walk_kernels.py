#!/usr/bin/env python3
"""Time kernels 5 and 7 of a checkout's ``aip_tpu_torch`` (the coefficient
walk and the per-tile walk) on their served inputs, on one NVIDIA card.

    python3 scripts/bench_walk_kernels.py [--package-root DIR] [--label NAME]

Writes the committed bed_0037 model's camera set as ``chip_smoke.py`` phase
9 does (under ``build/chip_smoke/3dgs`` of this checkout), takes a style
vector from numpy seed 0, and prints one JSON line per measurement:

* ``blocks``: ``composite_macro_blocks`` on each 1088x1920 camera's
  coefficient rows (``composite_backend="pallas"``, ``fit_selection(...,
  hi=8192)``, macro 4), ms over 100 calls in one CUDA-event window per
  camera, their median, mean and sum;
* ``tiles``: ``composite_tiles`` on each 800^2 view's per-tile lists
  (``render(renderer="pallas")``) and on camera 0's 1088x1920
  ``rasterize_fast`` lists, the same way;
* ``frames``: torch.profiler over one 1088x1920 frame of each camera
  through the coefficient path and the per-tile path: device ms, the
  ``gs.composite`` stage's ms and the busy share, per frame.

``--package-root`` loads ``aip_tpu_torch`` from another checkout (a parent
commit unpacked with ``git archive``): its kernels and rasterizer, this
checkout's scene and timing, so that two commits are measured the same way,
in turns, in one call. The kernels build into that checkout's ``build/``.
"""

import argparse
import importlib.util
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package-root", default=str(ROOT),
                    help="the checkout whose aip_tpu_torch is timed")
    ap.add_argument("--label", default="this checkout")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.package_root).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import numpy as np
    import torch
    from PIL import Image

    import aip_tpu_torch
    from aip_tpu_torch.gs import compress
    from aip_tpu_torch.gs import render as GR
    from aip_tpu_torch.gs.cameras import Camera, focal2fov, fov2focal
    from aip_tpu_torch.gs.colorfield import precompute_features
    from aip_tpu_torch.gs.dataset import Scene
    from aip_tpu_torch.kernels import _build
    from aip_tpu_torch.kernels import composite as KC

    if not torch.cuda.is_available():
        raise SystemExit("bench_walk_kernels: CUDA is not available")
    dev = torch.device("cuda")
    head = {"label": args.label, "package": str(Path(aip_tpu_torch.__file__).parent),
            "card": cs._card()}
    report = _build.build("composite_walk")
    if report:   # built here: registers and spills of each kernel
        cs.WORK.mkdir(parents=True, exist_ok=True)
        (cs.WORK / "build_composite_walk.log").write_text(report)
        print(json.dumps({**head, "ptxas": cs._walk_ptxas()}), flush=True)
    model_dir, _ = cs._write_bed_scene(np, Image)
    cfg = json.loads((model_dir / "cfg_args.json").read_text())
    sel = cfg["selection"]
    state, field, _, _ = compress.load_npz(model_dir / "model.npz", device=dev)
    cams = Scene(cfg["source_path"], shuffle=False).getTrainCameras()
    style_f = torch.from_numpy(
        np.random.default_rng(0).standard_normal((1, 512)).astype(np.float32) * 0.5).to(dev)
    enc = precompute_features(field, state.xyz)
    bg = torch.zeros(3, device=dev)
    blank = np.zeros((1088, 1920, 3), np.float32)
    cams_1080 = [Camera(colmap_id=0, R=c.R, T=c.T, FoVx=c.FoVx,
                        FoVy=focal2fov(fov2focal(c.FoVx, 1920), 1088), image=blank,
                        image_name=c.image_name, uid=0) for c in cams]
    fsel = GR.fit_selection(state, cams_1080, hi=8192)
    frames = cs._walk_frames(torch, GR, state, field, style_f, enc, bg, GR.settings_from_selection(
        fsel, 1088, 1920, max_per_tile=fsel["max_per_tile"], macro=4))
    s800 = GR.settings_from_selection(sel, 800, 800, max_per_tile=sel["max_per_tile"])

    def window_ms(name, calls):
        out = []
        for a, kw in calls:
            out.append(cs._time_many_ms(torch, lambda: getattr(KC, name)(*a, **kw),
                                        cs.MANY_CALLS))
        return out

    def plain_err(name, call):
        """Max abs of the kernel against its plain version on one call."""
        a, kw = call
        got = getattr(KC, name)(*a, **kw)
        return (got - getattr(KC, f"{name}_reference")(*a, **kw)).abs().max().item()

    blocks = [cs._captured(KC, "composite_macro_blocks", lambda: frames["pallas"](c))
              for c in cams_1080]
    ms = window_ms("composite_macro_blocks", blocks)
    print(json.dumps({**head, "kernel": "composite_macro_blocks", "inputs": "bed_0037 1088x1920 "
                      "fitted, macro 4, cameras 0-7", "in_shape": list(blocks[0][0][0].shape),
                      "per_camera_ms_100_calls": ms, "median_ms": statistics.median(ms),
                      "mean_ms": statistics.mean(ms), "sum_ms": sum(ms),
                      "camera0_max_abs_vs_plain": plain_err("composite_macro_blocks", blocks[0])}),
          flush=True)
    del blocks
    views = [cs._captured(KC, "composite_tiles", lambda: GR.render(
        c, state, field, bg, style_f=style_f, mode="inference", settings=s800, renderer="pallas",
        precomputed_enc=enc)) for c in cams]
    fast = cs._captured(KC, "composite_tiles", lambda: frames["fast"](cams_1080[0]))
    ms = window_ms("composite_tiles", views)
    print(json.dumps({**head, "kernel": "composite_tiles", "inputs": "bed_0037 800^2 per-tile "
                      "lists, views 0-7", "in_shape": list(views[0][0][0].shape),
                      "per_view_ms_100_calls": ms, "median_ms": statistics.median(ms),
                      "view0_ms": ms[0],
                      "max_abs_vs_plain": max(plain_err("composite_tiles", v) for v in views
                                              + [fast]),
                      "rasterize_fast_1088x1920_in_shape":
                      list(fast[0][0].shape),
                      "rasterize_fast_1088x1920_ms": window_ms("composite_tiles", [fast])[0]}),
          flush=True)
    del views, fast
    for path in ("pallas", "fast"):
        kernel = cs.WALK_PATHS[path]
        device_ms, stages = cs._stage_profile(
            torch, "bench_walk_profile", cs._cycle(lambda f, c: f(c), frames[path], cams_1080),
            cs.GS_SPANS, named=(("gs.composite", cs.WALK_KERNEL_NAMES[kernel]),),
            calls=len(cams_1080), scene="bed_0037_1088x1920", path=path, label_of_run=args.label)
        print(json.dumps({**head, "frames": path, "kernel": kernel, "device_ms": device_ms,
                          "composite_ms": stages.get("gs.composite", "not measured")}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
