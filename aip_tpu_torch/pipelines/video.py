"""Video style transfer with optical-flow temporal consistency. Port of
``aip_tpu.pipelines.video`` (reference `video/utils.py`):

* ``video_to_frames`` / ``frames_to_video`` / ``clear_frames``: host-side
  decode and encode (cv2, imported where it is used; mp4v, 20 fps);
* ``apply_style_transfer_multi_ada``: per-frame depth-aware AdaIN at
  256 px, the style switched every ``max(1, n_frames // n_styles)`` frames,
  then the recurrence ``out_i = a * stylized_i + (1 - a) * warp(out_{i-1},
  flow_i)`` with a = 0.7, where flow_i runs from frame i-1 to frame i;
* ``apply_style_transfer``: the same recurrence over a registered fast
  stylizer (``models.magenta.use_magenta_stylizer``), else single-style
  AdaIN without depth;
* ``run_style_transfer``: mp4 in, mp4 out.

All frames of a call are stylized as one batch, and all consecutive pairs
go through the flow estimator as one batch, one batch a device when the
frames are sharded over several (TV-L1 by default: its inner
loop is the ``tvl1`` CUDA kernel on the card). Every entry point takes
``device=None``, which means CUDA, and raises when CUDA is absent. A
``trace`` dict, when given, receives each stage's milliseconds
(``stage_ms``: load, depth, stylize, flows, blend, save; CUDA events on the
card, the host clock on the CPU) and the flows; each stage is also a
``video.<stage>`` span (``utils.profiling``).
"""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
from pathlib import Path

import numpy as np
import torch

from aip_tpu_torch.device import check_module_device, resolve_device
from aip_tpu_torch.models import weights as weights_mod
from aip_tpu_torch.models.decoder import decoder_apply
from aip_tpu_torch.models.depthnet import _proximity_core
from aip_tpu_torch.models.vgg import vgg_encode
from aip_tpu_torch.ops.adain import calc_mean_std
from aip_tpu_torch.ops.depth import compute_stylization_strength_map
from aip_tpu_torch.ops.flow import blend_images, estimate_flow_method, warp_image
from aip_tpu_torch.ops.image import resize_bilinear
from aip_tpu_torch.parallel import mesh as mesh_mod
from aip_tpu_torch.parallel.sharding import gather, replicate_module
from aip_tpu_torch.pipelines.adain_infer import _to_array, precompute_style_stats
from aip_tpu_torch.utils.profiling import span

_IMAGE_EXTS = (".jpg", ".jpeg", ".png")


# ---------------------------------------------------------------------------
# Host-side video IO
# ---------------------------------------------------------------------------

def video_to_frames(video_path, output_dir) -> list:
    """Decode a video to ``frame_00000.jpg``... (video/utils.py:24-38)."""
    import cv2

    Path(output_dir).mkdir(parents=True, exist_ok=True)
    cap = cv2.VideoCapture(str(video_path))
    paths = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        p = Path(output_dir) / f"frame_{len(paths):05d}.jpg"
        cv2.imwrite(str(p), frame)
        paths.append(p)
    cap.release()
    return paths


def frames_to_video(image_folder, output_video, fps: int = 20):
    """The folder's .jpg frames, in name order, to an mp4v video
    (video/utils.py:374-392). Returns the video's path, or None when the
    folder holds no frame."""
    import cv2

    images = sorted(f for f in os.listdir(image_folder) if f.endswith(".jpg"))
    if not images:
        return None
    first = cv2.imread(os.path.join(image_folder, images[0]))
    h, w, _ = first.shape
    Path(output_video).parent.mkdir(parents=True, exist_ok=True)
    writer = cv2.VideoWriter(str(output_video), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for name in images:
        writer.write(cv2.imread(os.path.join(image_folder, name)))
    writer.release()
    return str(output_video)


def clear_frames(directory) -> None:
    """Remove every file but .gitkeep (video/utils.py:395-404)."""
    d = Path(directory)
    if not d.exists():
        return
    for p in d.iterdir():
        if p.is_file() and p.name != ".gitkeep":
            p.unlink()


def _list_images(directory) -> list:
    return sorted(f for f in os.listdir(directory) if f.lower().endswith(_IMAGE_EXTS))


def _load_frames(directory, names, hw, dev) -> torch.Tensor:
    """[N, H, W, 3] float32 on ``dev``: each file antialias-resized to hw."""
    return torch.stack([
        resize_bilinear(torch.from_numpy(_to_array(Path(directory) / f)).to(dev), hw,
                        antialias=True)
        for f in names])


def _save_frames(frames: torch.Tensor, directory, names) -> list:
    """Write [N, H, W, 3] in [0, 1] as 8-bit images, truncating as
    ``aip_tpu`` does (``(clip(x) * 255).astype(uint8)``)."""
    from PIL import Image

    arr = frames.detach().float().cpu().numpy()
    paths = []
    for img, name in zip(arr, names):
        p = Path(directory) / name
        Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(p)
        paths.append(p)
    return paths


class _Stages:
    """Stage spans of one call: a ``video.<name>`` span each and, for a
    ``trace`` dict, the stage's milliseconds (the span's CUDA events on the
    card, read once the call has ended; the host clock on the CPU)."""

    def __init__(self, trace, dev: torch.device):
        self.trace, self.dev, self.spans = trace, dev, []

    @contextlib.contextmanager
    def __call__(self, name: str):
        with span(f"video.{name}", device=self.dev, timed=self.trace is not None) as s:
            yield
        if s is not None:
            self.spans.append((name, s))

    def finish(self, **fields) -> None:
        if self.trace is None:
            return
        self.trace["stage_ms"] = {name: s.ms() for name, s in self.spans}
        self.trace.update(fields)


# ---------------------------------------------------------------------------
# Device-side batched compute
# ---------------------------------------------------------------------------

def _batch_proximity(frames: torch.Tensor) -> torch.Tensor:
    """[N, H, W, 3] -> [N, H, W] proximity maps."""
    return torch.stack([_proximity_core(f) for f in frames])


@torch.no_grad()
def _stylize_frames(vgg_params, dec_params, frames, s_mean, s_std, depth_maps, offset,
                    prominence, compute_dtype):
    """Batched depth-aware AdaIN with per-frame style statistics.
    frames [N, H, W, 3]; s_mean, s_std [N, 1, 1, C]; depth_maps [N, H, W]."""
    content_f = vgg_encode(vgg_params, frames, "relu4_1", compute_dtype)
    hc, wc = content_f.shape[1], content_f.shape[2]
    p = torch.stack([compute_stylization_strength_map(d, (hc, wc), offset, prominence)
                     for d in depth_maps])[..., None]
    c_mean, c_std = calc_mean_std(content_f)
    x = content_f.float()
    adain_feat = (x - c_mean) / c_std * s_std + s_mean
    feat = adain_feat * (1.0 - p) + x * p
    out = decoder_apply(dec_params, feat.to(compute_dtype), compute_dtype)
    return torch.clamp(out.float(), 0.0, 1.0)


def _frame_shards(n: int, devices) -> list:
    """(device, first, stop) of each device's run of consecutive frames,
    as even as ``torch.tensor_split`` cuts them (empty runs dropped)."""
    bounds = [len(c) for c in torch.tensor_split(torch.arange(n), len(devices))]
    out, first = [], 0
    for dev, size in zip(devices, bounds):
        if size:
            out.append((dev, first, first + size))
        first += size
    return out


def _sharded_flows(frames: torch.Tensor, shards, method: str) -> torch.Tensor:
    """``_batch_flows`` with the pairs split over the shards' devices:
    shard (dev, a, b) computes the flows into frames max(a, 1) .. b - 1,
    the pair across its first boundary taking the previous shard's last
    frame; gathered in frame order on the frames' device."""
    parts = []
    for dev, a, b in shards:
        lo = max(a, 1)
        if lo < b:
            parts.append(estimate_flow_method(frames[lo - 1:b - 1].to(dev),
                                              frames[lo:b].to(dev), method=method))
    if not parts:
        return frames.new_zeros((0, frames.shape[1], frames.shape[2], 2))
    return gather(parts, frames.device)


def _batch_flows(frames: torch.Tensor, method: str = "lk") -> torch.Tensor:
    """[N, H, W, 3] -> [N-1, H, W, 2] flows between consecutive frames, all
    pairs in one batch (``aip_tpu`` maps them in chunks of 32, for a TPU
    gather fault). ``method``: 'farneback' | 'tvl1' | 'lk'."""
    if frames.shape[0] < 2:
        return frames.new_zeros((0, frames.shape[1], frames.shape[2], 2))
    return estimate_flow_method(frames[:-1], frames[1:], method=method)


@torch.no_grad()
def _temporal_blend(stylized: torch.Tensor, flows: torch.Tensor,
                    alpha: float = 0.7) -> torch.Tensor:
    """The serial recurrence out_i = blend(stylized_i, warp(out_{i-1},
    flow_i)), one warp and one blend per frame on the device."""
    prev = stylized[0]
    out = [prev]
    for cur, flow in zip(stylized[1:], flows):
        prev = blend_images(cur, warp_image(prev[None], flow[None])[0], alpha)
        out.append(prev)
    return torch.stack(out)


@torch.no_grad()
def apply_style_transfer_multi_ada(
    content_dir,
    style_dir,
    output_dir,
    target_resolution=(256, 256),
    alpha: float = 0.7,
    offset: float = 0.30,
    prominence: float = 20.0,
    use_depth: bool = True,
    cancel_flag=None,
    vgg_params=None,
    dec_params=None,
    compute_dtype=torch.bfloat16,
    shard: bool = True,
    flow_method: str = "tvl1",
    device=None,
    trace=None,
) -> list:
    """Stylize a frame directory against a directory of styles (reference
    video/utils.py:304-371). Returns the written frame paths.

    ``shard`` with more than one device in ``parallel.mesh.local_devices``
    (every card, for a CUDA call) splits the frames into runs of
    consecutive frames, one a device: each device computes its frames'
    depth maps and stylizations and the flows into them (the pair across a
    run's first boundary takes the previous run's last frame) with its own
    copy of the networks; the results are gathered in frame order on
    ``device`` for the serial blend."""
    dev = resolve_device(device)
    content_frames = _list_images(content_dir)
    style_images = _list_images(style_dir)
    if not style_images:
        raise ValueError("No style images found in the style directory.")
    n, m = len(content_frames), len(style_images)
    devices = mesh_mod.local_devices(dev) if shard else [dev]
    shards = _frame_shards(n, devices) if len(devices) > 1 else None
    if vgg_params is None:
        vgg_params = weights_mod.get_vgg_params(device=dev)
    if dec_params is None:
        dec_params = weights_mod.get_decoder_params(device=dev)
    for module in (vgg_params, dec_params):
        check_module_device(module, dev)

    Path(output_dir).mkdir(parents=True, exist_ok=True)
    frames_per_style = max(1, n // m)
    h, w = target_resolution[1], target_resolution[0]
    stages = _Stages(trace, dev)

    with stages("load"):
        frames = _load_frames(content_dir, content_frames, (h, w), dev)
    runs = shards or [(dev, 0, n)]
    with stages("depth"):
        depth_maps = [_batch_proximity(frames[a:b].to(d)) if use_depth
                      else torch.ones((b - a, h, w), device=d)  # constant -> P = 0
                      for d, a, b in runs]
    with stages("stylize"):
        # One encode per style; the reference's switching rule (:336-338).
        stats = [precompute_style_stats(vgg_params,
                                        torch.from_numpy(_to_array(Path(style_dir) / s))[None],
                                        compute_dtype=compute_dtype, device=dev)
                 for s in style_images]
        means = torch.cat([s[0] for s in stats])
        stds = torch.cat([s[1] for s in stats])
        idx = torch.from_numpy(np.minimum(np.arange(n) // frames_per_style, m - 1)).to(dev)
        run_devices = [d for d, _, _ in runs]
        vggs = replicate_module(vgg_params, run_devices)
        decs = replicate_module(dec_params, run_devices)
        stylized = gather([
            _stylize_frames(v, dc, frames[a:b].to(d), means[idx[a:b]].to(d),
                            stds[idx[a:b]].to(d), dm, float(offset), float(prominence),
                            compute_dtype)
            for v, dc, dm, (d, a, b) in zip(vggs, decs, depth_maps, runs)], dev)
    if cancel_flag is not None and getattr(cancel_flag, "is_set", lambda: False)():
        return []
    return _blend_and_save(stages, stylized, frames, flow_method, alpha, output_dir,
                           content_frames, shards)


def _blend_and_save(stages, stylized, frames, flow_method, alpha, output_dir, names,
                    shards=None) -> list:
    with stages("flows"):
        flows = (_batch_flows(frames, method=flow_method) if shards is None
                 else _sharded_flows(frames, shards, flow_method))
    with stages("blend"):
        blended = _temporal_blend(stylized, flows, alpha)
    with stages("save"):
        paths = _save_frames(blended, output_dir, names)
    stages.finish(flows=flows, frames=len(names))
    return paths


# Hook for a feed-forward stylizer (the reference's TF-Hub magenta module,
# `video/utils.py:14,108-154`): fn(frames [N, H, W, 3] in [0, 1], style
# [H, W, 3] in [0, 1]) -> [N, H, W, 3]; ``models.magenta.use_magenta_stylizer``
# installs the port's magenta network. Frames and style reach it as tensors
# on the call's device.
_FAST_STYLIZE = None


def register_fast_stylizer(fn) -> None:
    global _FAST_STYLIZE
    _FAST_STYLIZE = fn


@torch.no_grad()
def apply_style_transfer(
    content_dir,
    style_image_path,
    output_dir,
    target_resolution=(256, 256),
    alpha: float = 0.7,
    cancel_flag=None,
    flow_method: str = "tvl1",
    device=None,
    trace=None,
    **kw,
) -> list:
    """Feed-forward-stylizer video path (video/utils.py:108-154). Uses the
    registered fast stylizer; without one, single-style AdaIN without the
    depth pass (the same temporal machinery)."""
    if _FAST_STYLIZE is None:
        return apply_style_transfer_ada(
            content_dir, style_image_path, output_dir,
            target_resolution=target_resolution, alpha=alpha, cancel_flag=cancel_flag,
            use_depth=False, flow_method=flow_method, device=device, trace=trace, **kw)
    dev = resolve_device(device)
    Path(output_dir).mkdir(parents=True, exist_ok=True)
    names = _list_images(content_dir)
    h, w = target_resolution[1], target_resolution[0]
    stages = _Stages(trace, dev)
    with stages("load"):
        frames = _load_frames(content_dir, names, (h, w), dev)
        style = resize_bilinear(torch.from_numpy(_to_array(style_image_path)).to(dev), (h, w),
                                antialias=True)
    with stages("stylize"):
        stylized = torch.as_tensor(_FAST_STYLIZE(frames, style), dtype=torch.float32,
                                   device=dev)
    if cancel_flag is not None and getattr(cancel_flag, "is_set", lambda: False)():
        return []
    return _blend_and_save(stages, stylized, frames, flow_method, alpha, output_dir, names)


def apply_style_transfer_ada(
    content_dir,
    style_image_path,
    output_dir,
    target_resolution=(256, 256),
    alpha: float = 0.7,
    offset: float = 0.30,
    prominence: float = 20.0,
    cancel_flag=None,
    **kw,
) -> list:
    """Single-style AdaIN video stylization (video/utils.py:240-302): the
    multi-style path over a one-style directory."""
    style_dir = Path(tempfile.mkdtemp(prefix="aip_single_style_"))
    try:
        shutil.copy(str(style_image_path), style_dir / Path(style_image_path).name)
        return apply_style_transfer_multi_ada(
            content_dir, style_dir, output_dir, target_resolution=target_resolution,
            alpha=alpha, offset=offset, prominence=prominence, cancel_flag=cancel_flag, **kw)
    finally:
        shutil.rmtree(style_dir, ignore_errors=True)


def apply_style_transfer_multi(content_dir, style_dir, output_dir,
                               target_resolution=(256, 256), alpha: float = 0.7,
                               cancel_flag=None, **kw) -> list:
    """Multi-style variant without the depth pass (video/utils.py:156-215)."""
    return apply_style_transfer_multi_ada(
        content_dir, style_dir, output_dir, target_resolution=target_resolution, alpha=alpha,
        cancel_flag=cancel_flag, use_depth=False, **kw)


def run_style_transfer(
    selected_video="input/videos/sample.mp4",
    styles_dir="input/videos/styles/",
    content_dir="input/videos/content_frames/",
    styled_dir="input/videos/styled_frames/",
    output_video="video/outputs/stylized_video_manual.mp4",
    offset: float = 0.30,
    prominence: float = 20.0,
    fps: int = 20,
    flow_method: str = "tvl1",
    device=None,
) -> str:
    """mp4 -> frames -> multi-style AdaIN with temporal blending -> mp4
    (video/utils.py:407-425). Returns the mp4 path."""
    dev = resolve_device(device)
    clear_frames(content_dir)
    clear_frames(styled_dir)
    video_to_frames(selected_video, content_dir)
    apply_style_transfer_multi_ada(content_dir, styles_dir, styled_dir,
                                   target_resolution=(256, 256), offset=offset,
                                   prominence=prominence, flow_method=flow_method, device=dev)
    frames_to_video(styled_dir, output_video, fps=fps)
    return str(output_video)
