"""Render trained scenes along novel-view paths.

Port of ``aip_tpu/gs/render_video.py`` (reference
`Style_3DGS/render_video.py`: ellipse video :61-72, circular orbit :48-58,
gaussian-jittered views :75-96). Every entry point loads ``model.npz`` and
``cfg_args.json`` from ``model_path``, renders with the selection shape the
model was trained under (or a fitted one when none is recorded), and writes
PNGs; ``render_video`` also writes an mp4 through cv2. ``device=None``
means CUDA; ``mesh_dp > 1`` (Gaussian-sharded rendering over several cards,
slice 6) raises ``NotImplementedError``.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from aip_tpu_torch.device import resolve_device


def _load(model_path, device):
    from aip_tpu_torch.gs import compress as compress_mod
    from aip_tpu_torch.gs.dataset import Scene

    model_path = Path(model_path)
    cfg = json.loads((model_path / "cfg_args.json").read_text())
    state, field, _rvq_s, _rvq_r = compress_mod.load_npz(model_path / "model.npz", device=device)
    scene = Scene(cfg["source_path"], white_background=cfg.get("white_background", False),
                  resolution=cfg.get("resolution", -1), shuffle=False)
    bg = torch.tensor([1.0, 1.0, 1.0] if cfg.get("white_background") else [0.0, 0.0, 0.0],
                      device=device)
    return state, field, scene, bg, cfg.get("selection")


def _render_cams(cams, state, field, bg, style_f, out_dir, max_per_tile=128, sel=None):
    """Render ``cams`` into ``out_dir/00000.png``, ... Returns the paths.
    Views of 512^2 and more go through one ``make_inference_frame_fn`` per
    resolution, smaller ones through ``render``."""
    from PIL import Image

    from aip_tpu_torch.gs.colorfield import precompute_features
    from aip_tpu_torch.gs.render import (fit_selection, make_inference_frame_fn, render,
                                         render_frame, settings_from_selection)

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    # ``sel`` is the selection shape training recorded (cfg_args
    # "selection"); rendering reuses what training optimised under.
    uses_macro = any(c.image_height * c.image_width >= 512 * 512 for c in cams)
    if sel is None:
        # No recorded shape: fitted capacity with the legacy spans.
        sel = (dict(fit_selection(state, cams), dup_span=3, giant_capacity=128,
                    giant_backend="merge") if uses_macro
               else {"macro_capacity": 1024, "dup_span": 2, "giant_capacity": 128})
    enc = precompute_features(field, state.xyz)
    frame_fns = {}
    paths = []
    for i, cam in enumerate(cams):
        settings = settings_from_selection(sel, cam.image_height, cam.image_width,
                                           max_per_tile=max_per_tile)
        if cam.image_height * cam.image_width >= 512 * 512:
            key = (cam.image_height, cam.image_width)
            if key not in frame_fns:
                frame_fns[key] = make_inference_frame_fn(state, field, settings, bg,
                                                         style_f=style_f, precomputed_enc=enc)
            rendered = render_frame(frame_fns[key], cam)
        else:
            rendered = render(cam, state, field, bg, style_f=style_f, mode="inference",
                              settings=settings, precomputed_enc=enc).render
        img = (np.clip(rendered.float().cpu().numpy(), 0, 1) * 255).astype(np.uint8)
        p = out_dir / f"{i:05d}.png"
        Image.fromarray(img).save(p)
        paths.append(p)
    return paths


def _style_embedding(field, style_image, device):
    if field.style_w is None or style_image is None:
        return None
    from aip_tpu_torch.pipelines.adain_infer import _to_array, get_style_embeddings

    return get_style_embeddings(_to_array(style_image), device=device).mean(dim=(1, 2))


def render_video(model_path, style_image=None, n_frames: int = 600, fps: int = 30,
                 max_per_tile: int = 128, mesh_dp: int = 0, device=None) -> str:
    """Ellipse-path video (render_video.py:61-72): ``n_frames`` PNGs under
    ``model_path/video/ellipse`` and ``model_path/video/ellipse.mp4``.
    Returns the mp4's path."""
    import cv2

    from aip_tpu_torch.gs.pose_paths import apply_pose, generate_ellipse_path

    if mesh_dp > 1:
        raise NotImplementedError(
            "render_video(mesh_dp > 1) renders Gaussian-sharded over several cards, the "
            "multi-GPU slice of the port (ROADMAP queue 1, slice 6)")
    dev = resolve_device(device)
    state, field, scene, bg, sel = _load(model_path, dev)
    style_f = _style_embedding(field, style_image, dev)
    views = scene.getTrainCameras()
    poses = generate_ellipse_path(views, n_frames=n_frames)
    cams = [apply_pose(views[0], p) for p in poses]
    out_dir = Path(model_path) / "video" / "ellipse"
    paths = _render_cams(cams, state, field, bg, style_f, out_dir, max_per_tile, sel=sel)
    mp4 = str(Path(model_path) / "video" / "ellipse.mp4")
    h, w, _ = cv2.imread(str(paths[0])).shape
    writer = cv2.VideoWriter(mp4, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for p in paths:
        writer.write(cv2.imread(str(p)))
    writer.release()
    return mp4


def render_circular_video(model_path, style_image=None, radius: float = 0.5,
                          n_frames: int = 240, view_index: int = 0,
                          max_per_tile: int = 128, device=None) -> str:
    """Circular-orbit frames (render_video.py:48-58) under
    ``model_path/circular``. Returns that directory."""
    from aip_tpu_torch.gs.pose_paths import circular_pose

    dev = resolve_device(device)
    state, field, scene, bg, sel = _load(model_path, dev)
    style_f = _style_embedding(field, style_image, dev)
    views = scene.getTrainCameras()
    base = views[min(view_index, len(views) - 1)]
    cams = [circular_pose(base, radius, 2 * np.pi * i / n_frames) for i in range(n_frames)]
    out_dir = Path(model_path) / "circular"
    _render_cams(cams, state, field, bg, style_f, out_dir, max_per_tile, sel=sel)
    return str(out_dir)


def gaussian_render(model_path, style_image=None, mean: float = 0.0, std: float = 0.03,
                    n_views: int = 10, n_jitter: int = 10, max_per_tile: int = 128,
                    seed: int = 0, device=None) -> str:
    """Jittered-view sweep (render_video.py:75-96): per training view, its
    frame and ``n_jitter`` jittered ones (numpy ``default_rng(seed)``) under
    ``model_path/video/gaussians_std<std>``. Returns that directory."""
    from aip_tpu_torch.gs.pose_paths import gaussian_pose

    dev = resolve_device(device)
    state, field, scene, bg, sel = _load(model_path, dev)
    style_f = _style_embedding(field, style_image, dev)
    rng = np.random.default_rng(seed)
    views = scene.getTrainCameras()[:n_views]
    root = Path(model_path) / "video" / f"gaussians_std{std}"
    for i, view in enumerate(views):
        sub = root / f"view_{i}"
        _render_cams([view], state, field, bg, style_f, sub, max_per_tile, sel=sel)
        jittered = [gaussian_pose(view, rng, mean, std) for _ in range(n_jitter)]
        _render_cams(jittered, state, field, bg, style_f, sub / "jitter", max_per_tile, sel=sel)
    return str(root)
