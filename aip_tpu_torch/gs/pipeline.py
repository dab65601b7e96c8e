"""User-facing 3DGS entry points: train and render, matching the reference API.

Port of ``aip_tpu/gs/pipeline.py``:

* ``run_3dgs_training`` (reference ``Style_3DGS/train.py:418-500``): build
  the config, optionally fit the selection's giant handling to the initial
  scene, train, save ``model.npz``, the ``storage`` report and
  ``cfg_args.json`` with the ``"selection"`` record that inference must
  reuse;
* ``run_3dgs_rendering`` (reference ``render.py:51-113``): load the
  compressed model, decode the hash features once, pool the style
  embedding, render the train cameras with the selection shape the model
  was trained under, and write one PNG per view and an animated GIF, whose
  path is returned.

``device=None`` means CUDA; ``mesh_dp > 1`` and ``gaussian_shard`` (slice 6)
raise ``NotImplementedError``.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from aip_tpu_torch.device import resolve_device
from aip_tpu_torch.gs import compress as compress_mod
from aip_tpu_torch.gs.dataset import Scene


def run_3dgs_training(content_path, style_img_path, model_path="output/3dgs_model",
                      iterations: int = 15_000, freeze_iters: int = 7_000,
                      use_depth: bool = False, depth_offset: float = 0.5,
                      depth_prominence: float = 20.0, white_background: bool = False,
                      capacity: int = 1 << 17, log2_hashmap: int = 19,
                      progress_every: int = 500, img_size: int = 512, seed: int = 0,
                      checkpoint_iterations=(), test_iterations=(), start_checkpoint=None,
                      logger=None, max_per_tile: int = 128, macro_capacity: int = 1024,
                      views_per_step: int = 1, mesh_dp: int = 0, gaussian_shard: bool = False,
                      fit_train_selection: bool = False, resolution: int = -1, device=None,
                      cfg=None, trace=None) -> str:
    """Train a stylized 3DGS scene and save the compressed model. Returns
    model_path. ``cfg`` (a ``GSTrainConfig``), when given, replaces the
    config the keyword arguments build (its schedule included); ``trace``
    is passed to ``train``."""
    import dataclasses

    from aip_tpu_torch.gs.train import GSTrainConfig, train

    if mesh_dp > 1 or gaussian_shard:
        raise NotImplementedError(
            "run_3dgs_training(mesh_dp > 1 / gaussian_shard) trains over several cards, the "
            "multi-GPU slice of the port (ROADMAP queue 1, slice 6)")
    dev = resolve_device(device)
    if cfg is None:
        cfg = GSTrainConfig(iterations=iterations, freeze_iters=freeze_iters,
                            white_background=white_background, capacity=capacity,
                            log2_hashmap=log2_hashmap, max_per_tile=max_per_tile,
                            macro_capacity=macro_capacity)
    scene = Scene(str(content_path), white_background=cfg.white_background,
                  resolution=resolution)
    if fit_train_selection:
        # Fit the giant handling (backend, span, pools) to the initial
        # scene's demand with extra margin, so training renders never
        # truncate giants; capacities stay the caller's.
        from aip_tpu_torch.gs.gaussians import create_from_pcd
        from aip_tpu_torch.gs.render import fit_selection

        pcd = scene.point_cloud
        st0, _dc = create_from_pcd(pcd.points, pcd.colors, cfg.capacity, device=dev)
        sel0 = fit_selection(st0, scene.getTrainCameras(), margin=1.5)
        print(f"fit_train_selection: {sel0}", flush=True)
        cfg = dataclasses.replace(
            cfg, dup_span=sel0["dup_span"], giant_capacity=sel0["giant_capacity"],
            giant_backend=sel0.get("giant_backend", "merge"),
            giant_span=sel0.get("giant_span", cfg.giant_span),
            giant_pool=max(sel0.get("giant_pool", 0), cfg.giant_pool),
            giant_pool_full=max(sel0.get("giant_pool_full", 0), cfg.giant_pool_full))
    trainer, _style_f = train(
        scene, style_img_path, cfg, use_depth=use_depth, depth_offset=depth_offset,
        depth_prominence=depth_prominence, img_size=img_size,
        guide_dir=str(Path(model_path) / "stylized"), progress_every=progress_every, seed=seed,
        checkpoint_iterations=checkpoint_iterations, test_iterations=test_iterations,
        start_checkpoint=start_checkpoint, checkpoint_dir=str(Path(model_path) / "checkpoints"),
        logger=logger, views_per_step=views_per_step, device=dev, trace=trace)

    out = Path(model_path)
    out.mkdir(parents=True, exist_ok=True)
    report = compress_mod.save_npz(out / "model.npz", trainer.gstate, trainer.field,
                                   trainer.rvq_scale, trainer.rvq_rot)
    (out / "storage").write_text(report)
    (out / "cfg_args.json").write_text(json.dumps({
        "source_path": str(content_path),
        "white_background": cfg.white_background,
        "resolution": resolution,
        "iterations": cfg.iterations,
        "freeze_iters": cfg.freeze_iters,
        "log2_hashmap": cfg.log2_hashmap,
        # The selection shape training rendered with; inference reuses it.
        "selection": {
            "max_per_tile": cfg.max_per_tile,
            "macro_capacity": cfg.macro_capacity,
            "dup_span": cfg.dup_span,
            "giant_capacity": cfg.giant_capacity,
            "giant_backend": cfg.giant_backend,
            "giant_span": cfg.giant_span,
            "giant_pool": cfg.giant_pool,
            "giant_pool_full": cfg.giant_pool_full,
        },
    }))
    return str(model_path)


def run_3dgs_rendering(style_image, model_path="output/3dgs_model", output_dir=None,
                       max_per_tile: int = 128, fps: int = 10, renderer: str = "auto",
                       mesh_dp: int = 0, device=None) -> str:
    """Render the trained scene under a (possibly new) style; returns the
    GIF path. ``device=None`` means CUDA. Views of 512^2 and more go
    through ``make_inference_frame_fn`` (the macro-block compositors),
    smaller ones through ``render`` (``renderer`` as given)."""
    from PIL import Image

    from aip_tpu_torch.gs.colorfield import precompute_features
    from aip_tpu_torch.gs.render import (fit_selection, make_inference_frame_fn, render,
                                         render_frame, settings_from_selection)
    from aip_tpu_torch.pipelines.adain_infer import _to_array, get_style_embeddings

    if mesh_dp > 1:
        raise NotImplementedError(
            "run_3dgs_rendering(mesh_dp > 1) renders Gaussian-sharded over several cards, "
            "the multi-GPU slice of the port (ROADMAP queue 1, slice 6)")
    dev = resolve_device(device)
    model_path = Path(model_path)
    cfg_args = json.loads((model_path / "cfg_args.json").read_text())
    state, field, _rvq_scale, _rvq_rot = compress_mod.load_npz(model_path / "model.npz",
                                                               device=dev)

    scene = Scene(cfg_args["source_path"],
                  white_background=cfg_args.get("white_background", False),
                  resolution=cfg_args.get("resolution", -1),
                  shuffle=False)
    cams_all = scene.getTrainCameras()
    uses_macro = renderer in ("auto", "matmul") and any(
        c.image_height * c.image_width >= 512 * 512 for c in cams_all)
    if "selection" in cfg_args:
        # Render with the selection shape training optimized under.
        sel = cfg_args["selection"]
    elif uses_macro:
        # Legacy model (no recorded shape): fitted capacity, default spans.
        sel = dict(fit_selection(state, cams_all), dup_span=3, giant_capacity=128,
                   giant_backend="merge")
    else:
        sel = {"macro_capacity": 1024, "dup_span": 2, "giant_capacity": 128}
    bg = torch.tensor([1.0, 1.0, 1.0] if cfg_args.get("white_background") else [0.0, 0.0, 0.0],
                      device=dev)

    style_f = None
    if field.style_w is not None:
        feat = get_style_embeddings(_to_array(style_image), device=dev)
        style_f = feat.mean(dim=(1, 2))

    out_dir = Path(output_dir or (model_path / "renders"))
    out_dir.mkdir(parents=True, exist_ok=True)
    # Hash features are camera-independent: decode them once.
    enc = precompute_features(field, state.xyz)
    frame_fns = {}
    frames = []
    for i, cam in enumerate(cams_all):
        settings = settings_from_selection(sel, cam.image_height, cam.image_width,
                                           max_per_tile=sel.get("max_per_tile", max_per_tile))
        if renderer in ("auto", "matmul") and cam.image_height * cam.image_width >= 512 * 512:
            key = (cam.image_height, cam.image_width)
            if key not in frame_fns:
                frame_fns[key] = make_inference_frame_fn(state, field, settings, bg,
                                                         style_f=style_f, precomputed_enc=enc)
            rendered = render_frame(frame_fns[key], cam)
        else:
            rendered = render(cam, state, field, bg, style_f=style_f, mode="inference",
                              settings=settings, renderer=renderer,
                              precomputed_enc=enc).render
        img = np.clip(rendered.float().cpu().numpy(), 0, 1)
        im = Image.fromarray((img * 255).astype(np.uint8))
        im.save(out_dir / f"{i:05d}.png")
        frames.append(im)

    gif_path = out_dir / "render.gif"
    if frames:
        frames[0].save(gif_path, save_all=True, append_images=frames[1:],
                       duration=int(1000 / fps), loop=0)
    return str(gif_path)
