"""User-facing 3DGS render entry point, matching the reference API.

Port of ``aip_tpu/gs/pipeline.py``'s ``run_3dgs_rendering`` (reference
``Style_3DGS/render.py:51-113``): load the compressed model, decode the
hash features once, pool the style embedding, render the train cameras
with the selection shape the model was trained under, and write one PNG
per view and an animated GIF, whose path is returned. Training
(``run_3dgs_training``) belongs to the training slice.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from aip_tpu_torch.device import resolve_device
from aip_tpu_torch.gs import compress as compress_mod
from aip_tpu_torch.gs.dataset import Scene


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
