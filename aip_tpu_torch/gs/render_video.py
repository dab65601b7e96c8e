"""Render trained scenes along novel-view paths.

Port of ``aip_tpu/gs/render_video.py`` (reference
`Style_3DGS/render_video.py`: ellipse video :61-72, circular orbit :48-58,
gaussian-jittered views :75-96). Every entry point loads ``model.npz`` and
``cfg_args.json`` from ``model_path``, renders with the selection shape the
model was trained under (or a fitted one when none is recorded), and writes
PNGs through ``gs.pipeline.render_views``; ``render_video`` also writes an
mp4 through cv2. ``device=None`` means CUDA; ``render_video(mesh_dp > 1)``
renders every frame with the Gaussians split over a (dp,) mesh
(``render(mesh=...)``).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from aip_tpu_torch.device import resolve_device
from aip_tpu_torch.gs.pipeline import load_trained_scene, render_views, style_embedding


def render_video(model_path, style_image=None, n_frames: int = 600, fps: int = 30,
                 max_per_tile: int = 128, mesh_dp: int = 0, device=None) -> str:
    """Ellipse-path video (render_video.py:61-72): ``n_frames`` PNGs under
    ``model_path/video/ellipse`` and ``model_path/video/ellipse.mp4``.
    Returns the mp4's path."""
    import cv2

    from aip_tpu_torch.gs.pose_paths import apply_pose, generate_ellipse_path
    from aip_tpu_torch.parallel.mesh import make_dp_mesh

    dev = resolve_device(device)
    mesh = make_dp_mesh(mesh_dp, device=dev)
    state, field, scene, bg, sel = load_trained_scene(model_path, dev)
    style_f = style_embedding(field, style_image, dev)
    views = scene.getTrainCameras()
    poses = generate_ellipse_path(views, n_frames=n_frames)
    cams = [apply_pose(views[0], p) for p in poses]
    out_dir = Path(model_path) / "video" / "ellipse"
    paths = render_views(cams, state, field, bg, style_f, out_dir, sel, max_per_tile, mesh=mesh)
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
    state, field, scene, bg, sel = load_trained_scene(model_path, dev)
    style_f = style_embedding(field, style_image, dev)
    views = scene.getTrainCameras()
    base = views[min(view_index, len(views) - 1)]
    cams = [circular_pose(base, radius, 2 * np.pi * i / n_frames) for i in range(n_frames)]
    out_dir = Path(model_path) / "circular"
    render_views(cams, state, field, bg, style_f, out_dir, sel, max_per_tile)
    return str(out_dir)


def gaussian_render(model_path, style_image=None, mean: float = 0.0, std: float = 0.03,
                    n_views: int = 10, n_jitter: int = 10, max_per_tile: int = 128,
                    seed: int = 0, device=None) -> str:
    """Jittered-view sweep (render_video.py:75-96): per training view, its
    frame and ``n_jitter`` jittered ones (numpy ``default_rng(seed)``) under
    ``model_path/video/gaussians_std<std>``. Returns that directory."""
    from aip_tpu_torch.gs.pose_paths import gaussian_pose

    dev = resolve_device(device)
    state, field, scene, bg, sel = load_trained_scene(model_path, dev)
    style_f = style_embedding(field, style_image, dev)
    rng = np.random.default_rng(seed)
    views = scene.getTrainCameras()[:n_views]
    root = Path(model_path) / "video" / f"gaussians_std{std}"
    for i, view in enumerate(views):
        sub = root / f"view_{i}"
        render_views([view], state, field, bg, style_f, sub, sel, max_per_tile)
        jittered = [gaussian_pose(view, rng, mean, std) for _ in range(n_jitter)]
        render_views(jittered, state, field, bg, style_f, sub / "jitter", sel, max_per_tile)
    return str(root)
