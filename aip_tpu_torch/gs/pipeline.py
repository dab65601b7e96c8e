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

Every renderer of a trained model (this one and ``gs.render_video``'s three)
goes through ``load_trained_scene``, ``style_embedding`` and
``render_views``, which picks each view's route and the selection shape of
a model that recorded none (``default_selection``).

``device=None`` means CUDA. ``mesh_dp > 1`` builds a (dp,) mesh of that
many devices (``parallel.mesh.make_dp_mesh``: CUDA cards, or repeated CPU
devices on the CPU): training splits each view batch over it (and, with
``gaussian_shard``, the colour field's Gaussians), rendering splits the
Gaussians over it (``parallel.gs.rasterize_sharded``).
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
    from aip_tpu_torch.parallel.mesh import make_dp_mesh

    dev = resolve_device(device)
    mesh = make_dp_mesh(mesh_dp, device=dev)
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
        logger=logger, views_per_step=views_per_step, mesh=mesh, gaussian_shard=gaussian_shard,
        device=dev, trace=trace)

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


def load_trained_scene(model_path, device):
    """A trained model directory's (state, field, scene, background, recorded
    selection or None): ``model.npz`` and ``cfg_args.json``'s scene,
    background colour and ``"selection"``."""
    model_path = Path(model_path)
    cfg = json.loads((model_path / "cfg_args.json").read_text())
    state, field, _rvq_s, _rvq_r = compress_mod.load_npz(model_path / "model.npz", device=device)
    scene = Scene(cfg["source_path"], white_background=cfg.get("white_background", False),
                  resolution=cfg.get("resolution", -1), shuffle=False)
    bg = torch.tensor([1.0, 1.0, 1.0] if cfg.get("white_background") else [0.0, 0.0, 0.0],
                      device=device)
    return state, field, scene, bg, cfg.get("selection")


def style_embedding(field, style_image, device):
    """The pooled AdaIN style embedding [1, 512] of ``style_image``, or None
    where the field takes no style or no image is given."""
    if field.style_w is None or style_image is None:
        return None
    from aip_tpu_torch.pipelines.adain_infer import _to_array, get_style_embeddings

    return get_style_embeddings(_to_array(style_image), device=device).mean(dim=(1, 2))


def default_selection(state, cams, renderer: str = "auto") -> dict:
    """The selection shape of a model that recorded none: where a view takes
    the macro-block route, the fitted capacity with the legacy spans; else
    the defaults of the per-tile route."""
    from aip_tpu_torch.gs.render import fit_selection, takes_macro_route

    if renderer in ("auto", "matmul") and any(
            takes_macro_route(c.image_height, c.image_width) for c in cams):
        return dict(fit_selection(state, cams), dup_span=3, giant_capacity=128,
                    giant_backend="merge")
    return {"macro_capacity": 1024, "dup_span": 2, "giant_capacity": 128}


def render_views(cams, state, field, bg, style_f, out_dir, sel, max_per_tile: int,
                 renderer: str = "auto", mesh=None) -> list:
    """Render ``cams`` into ``out_dir/00000.png``, ... and return the paths.
    ``sel`` is the selection shape (``default_selection`` when None),
    ``max_per_tile`` the per-tile capacity. Views on the macro-block route
    with no mesh and renderer ``auto`` or ``matmul`` go through one
    ``make_inference_frame_fn`` a resolution; every other view through
    ``render`` (``renderer`` and ``mesh`` as given)."""
    from PIL import Image

    from aip_tpu_torch.gs.colorfield import precompute_features
    from aip_tpu_torch.gs.render import (make_inference_frame_fn, render, render_frame,
                                         settings_from_selection, takes_macro_route)

    if sel is None:
        sel = default_selection(state, cams, renderer)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    # Hash features are camera-independent: decode them once.
    enc = precompute_features(field, state.xyz)
    frame_fns = {}
    paths = []
    for i, cam in enumerate(cams):
        settings = settings_from_selection(sel, cam.image_height, cam.image_width,
                                           max_per_tile=max_per_tile)
        if (mesh is None and renderer in ("auto", "matmul")
                and takes_macro_route(cam.image_height, cam.image_width)):
            key = (cam.image_height, cam.image_width)
            if key not in frame_fns:
                frame_fns[key] = make_inference_frame_fn(state, field, settings, bg,
                                                         style_f=style_f, precomputed_enc=enc)
            rendered = render_frame(frame_fns[key], cam)
        else:
            rendered = render(cam, state, field, bg, style_f=style_f, mode="inference",
                              settings=settings, renderer=renderer, mesh=mesh,
                              precomputed_enc=enc).render
        img = (np.clip(rendered.float().cpu().numpy(), 0, 1) * 255).astype(np.uint8)
        paths.append(out_dir / f"{i:05d}.png")
        Image.fromarray(img).save(paths[-1])
    return paths


def run_3dgs_rendering(style_image, model_path="output/3dgs_model", output_dir=None,
                       max_per_tile: int = 128, fps: int = 10, renderer: str = "auto",
                       mesh_dp: int = 0, device=None) -> str:
    """Render the trained scene under a (possibly new) style; returns the
    GIF path. ``device=None`` means CUDA. Each view renders as
    ``render_views`` routes it, with the recorded selection's
    ``max_per_tile`` where it has one; with ``mesh_dp > 1`` every view
    through ``render(mesh=...)``."""
    from PIL import Image

    from aip_tpu_torch.parallel.mesh import make_dp_mesh

    dev = resolve_device(device)
    mesh = make_dp_mesh(mesh_dp, device=dev)
    state, field, scene, bg, sel = load_trained_scene(model_path, dev)
    cams = scene.getTrainCameras()
    if sel is None:     # no shape recorded: resolved here for its max_per_tile
        sel = default_selection(state, cams, renderer)
    out_dir = Path(output_dir or (Path(model_path) / "renders"))
    paths = render_views(cams, state, field, bg, style_embedding(field, style_image, dev),
                         out_dir, sel, sel.get("max_per_tile", max_per_tile), renderer, mesh)
    frames = [Image.open(p) for p in paths]
    gif_path = out_dir / "render.gif"
    if frames:
        frames[0].save(gif_path, save_all=True, append_images=frames[1:],
                       duration=int(1000 / fps), loop=0)
    return str(gif_path)
