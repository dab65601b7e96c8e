"""Stylized 3DGS training loop (Compact-3DGS schedule + AdaIN style phase).

Port of ``aip_tpu/gs/train.py`` (reference ``Style_3DGS/train.py:42-307``,
defaults ``arguments/__init__.py:75-99``), one view per step:

* two-phase loss: ``0.8 L1 + 0.2 (1 - SSIM) + 5e-4 mean(sigmoid(mask))``
  until ``freeze_iters``, then L1 against the per-view AdaIN style guide
  (computed once per camera by slice 1's pipeline);
* densify/clone/split every 100 iterations in [500, 15000), opacity reset
  every 3000, mask prune every 1000 after densification ends, the RVQ
  quantisation-aware phase over the last 1/30 of the schedule, capacity
  buckets (recompact / regrow) after densification events;
* two optimisers written out as ``adam_update`` on plain tensors, with
  optax's formula (bias-corrected moments, eps outside the square root,
  the learning rate taken at the count before the update): per-group Adam
  (eps 1e-15) with the log-lerp xyz schedule, and the network Adam with
  the 100-iteration linear warm-up and MultiStep(0.33).

A step is eager PyTorch: render (differentiable ``rasterize``; on a card
the compositor kernels A and B and, for tables of 2^16 rows and more, the
hash-table gradient kernel C), the loss, one ``torch.autograd.grad`` for
every parameter and the screen-space offset, both Adam updates and the
densification statistics (dL/d mean2d is the gradient of a zero
``screenspace_offset``). Densification is ``gs.gaussians``' fixed-capacity
slot code; Adam moments of re-used slots are zeroed through the same slot
masks. The step names its stages for ``torch.profiler`` with
``record_function`` spans (``gs.loss``, ``gs.adam``, ``gs.stats``, beside
the renderer's ``gs.field`` and the rasterizer's four), which
``chip_smoke.py``'s step breakdown reads.

Random draws (split offsets, k-means starts) come from one
``torch.Generator`` seeded with ``seed``, the view order from numpy's
``default_rng(seed)`` as in the JAX package; a checkpoint carries both
states, so a resumed run continues exactly. ``views_per_step > 1``,
``mesh``, ``gaussian_shard`` and ``view_chunk`` (slice 6) and
``network_gui`` (slice 7) raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from aip_tpu_torch.device import resolve_device
from aip_tpu_torch.gs import gaussians as G
from aip_tpu_torch.gs import rvq as rvq_mod
from aip_tpu_torch.gs.colorfield import ColorFieldParams, init_colorfield
from aip_tpu_torch.gs.rasterizer import TILE, RasterSettings, _pairsort_slots
from aip_tpu_torch.gs.render import render
from aip_tpu_torch.ops.metrics import l1_loss, psnr, ssim


@dataclass(frozen=True)
class GSTrainConfig:
    """The JAX package's ``GSTrainConfig`` field for field (see its
    comments for each one's meaning)."""

    iterations: int = 15_000
    freeze_iters: int = 7_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    mask_lr: float = 0.01
    net_lr: float = 0.01
    net_lr_step: tuple = (5_000, 15_000, 25_000)
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    lambda_mask: float = 0.0005
    densification_interval: int = 100
    opacity_reset_interval: int = 3_000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002
    mask_prune_iter: int = 1_000
    rvq_iter: int = 29_000
    rvq_size: int = 64
    rvq_num: int = 6
    style_dim: int = 256
    log2_hashmap: int = 19
    capacity: int = 1 << 17
    max_per_tile: int = 128
    raster_chunk: int = 4096
    macro_above_pixels: int = 256 * 256
    macro: int = 4
    macro_capacity: int = 1024
    dup_span: int = 3
    giant_capacity: int = 128
    giant_backend: str = "merge"
    giant_span: int = 8
    giant_pool: int = 16384
    giant_pool_full: int = 1024
    white_background: bool = False
    recompact_floor: int = 8192
    ad_stream_above_bytes: int = 2 << 30
    opacity_cull: bool = True


class CameraArrays(NamedTuple):
    """One view's tensors (camera, ground truth or style guide)."""

    world_view: torch.Tensor
    full_proj: torch.Tensor
    campos: torch.Tensor
    image: torch.Tensor       # [H, W, 3]
    height: int
    width: int
    tanfovx: float
    tanfovy: float


def camera_to_arrays(cam, image=None, device=None) -> CameraArrays:
    dev = resolve_device(device)
    img = cam.image if image is None else image
    f32 = dict(dtype=torch.float32, device=dev)
    return CameraArrays(
        world_view=torch.as_tensor(np.asarray(cam.world_view_transform), **f32),
        full_proj=torch.as_tensor(np.asarray(cam.full_proj_transform), **f32),
        campos=torch.as_tensor(np.asarray(cam.camera_center), **f32),
        image=torch.as_tensor(img, **f32) if isinstance(img, torch.Tensor)
        else torch.as_tensor(np.asarray(img), **f32),
        height=cam.image_height, width=cam.image_width,
        tanfovx=math.tan(cam.FoVx * 0.5), tanfovy=math.tan(cam.FoVy * 0.5))


def expon_lr(step, lr_init, lr_final, lr_delay_mult, max_steps, delay_steps=0):
    """Log-lerp schedule (general_utils.py:29-62) in float32."""
    f32 = torch.float32
    t = torch.clamp(torch.tensor(step / max_steps, dtype=f32), 0.0, 1.0)
    return torch.exp(torch.log(torch.tensor(lr_init, dtype=f32)) * (1 - t)
                     + torch.log(torch.tensor(lr_final, dtype=f32)) * t)


# ---------------------------------------------------------------------------
# Adam, as optax.adam computes it
# ---------------------------------------------------------------------------

class AdamState(NamedTuple):
    count: torch.Tensor   # int32 scalar: updates taken
    mu: dict              # name -> first moment
    nu: dict              # name -> second moment


def adam_init(params: dict) -> AdamState:
    # The count stays on the host: the schedules read it every step.
    return AdamState(torch.zeros((), dtype=torch.int32),
                     {k: torch.zeros_like(v) for k, v in params.items()},
                     {k: torch.zeros_like(v) for k, v in params.items()})


@torch.no_grad()
def adam_update(params: dict, grads: dict, state: AdamState, lrs: dict, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-15):
    """One Adam step on every entry of ``params``: mu = (1 - b1) g + b1 mu,
    nu = (1 - b2) g^2 + b2 nu, the update mu_hat / (sqrt(nu_hat) + eps) at
    bias corrections 1 - b^(count + 1), times -lr. ``lrs`` maps each name to
    its learning rate for this step. Returns (new params, new state)."""
    count = state.count + 1
    c = count.to(torch.float32)
    bc1 = 1 - torch.tensor(b1, dtype=torch.float32, device=c.device) ** c
    bc2 = 1 - torch.tensor(b2, dtype=torch.float32, device=c.device) ** c
    new_p, new_mu, new_nu = {}, {}, {}
    for k, p in params.items():
        g = grads[k]
        mu = (1 - b1) * g + b1 * state.mu[k]
        nu = (1 - b2) * (g * g) + b2 * state.nu[k]
        update = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
        new_p[k] = p + (-lrs[k]) * update
        new_mu[k], new_nu[k] = mu, nu
    return new_p, AdamState(count, new_mu, new_nu)


G_KEYS = ("xyz", "opacity", "scaling", "rotation", "mask")


def gaussian_lrs(cfg: GSTrainConfig, spatial_lr_scale: float, count: int) -> dict:
    """Per-group learning rates at optimiser count ``count``: xyz on the
    log-lerp schedule, the rest constant."""
    xyz = expon_lr(count, cfg.position_lr_init * spatial_lr_scale,
                   cfg.position_lr_final * spatial_lr_scale, cfg.position_lr_delay_mult,
                   cfg.position_lr_max_steps)
    return {"xyz": xyz, "opacity": cfg.opacity_lr, "scaling": cfg.scaling_lr,
            "rotation": cfg.rotation_lr, "mask": cfg.mask_lr}


def net_lr(cfg: GSTrainConfig, count: int):
    """LinearLR(0.01 -> 1 over 100) * MultiStep(0.33 at net_lr_step)."""
    warm = min(1.0, 0.01 + 0.99 * count / 100.0)
    gamma = 1.0
    for m in cfg.net_lr_step:
        gamma *= 0.33 if count >= m else 1.0
    return torch.tensor(cfg.net_lr, dtype=torch.float32) * torch.tensor(
        warm, dtype=torch.float32) * torch.tensor(gamma, dtype=torch.float32)


class TrainerState(NamedTuple):
    gstate: G.GaussianState
    field: ColorFieldParams
    opt_g: AdamState
    opt_net: AdamState
    rvq_scale: rvq_mod.RVQState | None
    rvq_rot: rvq_mod.RVQState | None
    step: int


def _gparams(gstate: G.GaussianState) -> dict:
    return {k: getattr(gstate, k) for k in G_KEYS}


def _field_params(field: ColorFieldParams) -> dict:
    return {k: v for k, v in field._asdict().items() if v is not None}


def make_trainer(gstate: G.GaussianState, field: ColorFieldParams) -> TrainerState:
    """A trainer at step 0 (fresh Adam states) around a state and a field."""
    return TrainerState(gstate, field, adam_init(_gparams(gstate)),
                        adam_init(_field_params(field)), None, None, 0)


def init_trainer(cfg: GSTrainConfig, points, colors, spatial_lr_scale: float, seed: int = 0,
                 device=None) -> TrainerState:
    dev = resolve_device(device)
    gstate, _sh_dc = G.create_from_pcd(np.asarray(points), np.asarray(colors), cfg.capacity,
                                       device=dev)
    field = init_colorfield(seed, style_dim=cfg.style_dim or None,
                            log2_hashmap=cfg.log2_hashmap, device=dev)
    return make_trainer(gstate, field)


def make_settings_from_dims(height: int, width: int, cfg: GSTrainConfig,
                            views: int = 1) -> RasterSettings:
    """The JAX package's rule: hierarchical selection from
    ``macro_above_pixels``; ``remat_composite`` and ``ad_backend`` kept for
    parity of settings (on a card the composite is always kernels A/B)."""
    macro = cfg.macro if height * width >= cfg.macro_above_pixels else 1
    n_tiles = ((height + 15) // 16) * ((width + 15) // 16)
    per_view = n_tiles * cfg.max_per_tile * 256 * 4
    remat = views * per_view > (1 << 29)
    ad_backend = "pallas" if per_view > cfg.ad_stream_above_bytes else "xla"
    return RasterSettings(
        image_height=height, image_width=width,
        max_per_tile=cfg.max_per_tile, chunk=cfg.raster_chunk,
        macro=macro, macro_capacity=cfg.macro_capacity,
        dup_span=cfg.dup_span, giant_capacity=cfg.giant_capacity,
        giant_backend=cfg.giant_backend, giant_span=cfg.giant_span,
        giant_pool=cfg.giant_pool, giant_pool_full=cfg.giant_pool_full,
        remat_composite=remat and ad_backend == "xla", ad_backend=ad_backend,
        opacity_cull=cfg.opacity_cull)


def _per_view_bytes(height: int, width: int, cfg: GSTrainConfig, settings) -> int:
    """Bytes one rendered view holds in the JAX package's dense autodiff
    (its view-chunk budget): the [tiles, K, 256] composite intermediates,
    the per-tile gather, and the selection working set."""
    th = -(-height // TILE)
    tw = -(-width // TILE)
    n_tiles = th * tw
    total = n_tiles * cfg.max_per_tile * 256 * 4 + n_tiles * cfg.max_per_tile * 16 * 4
    if settings.macro > 1:
        m = settings.macro
        mb = math.ceil(th / m) * math.ceil(tw / m)
        total += mb * settings.macro_capacity * (m * m * 13 + 16)
        if settings.select_backend == "pairsort":
            total += _pairsort_slots(cfg.capacity, settings, math.ceil(th / m),
                                     math.ceil(tw / m)) * 4 * 6
    return total


class _CamView:
    """The camera attributes ``render`` reads, as tensors."""

    def __init__(self, camera: CameraArrays, settings: RasterSettings):
        self.world_view_transform = camera.world_view
        self.full_proj_transform = camera.full_proj
        self.camera_center = camera.campos
        self.image_height = settings.image_height
        self.image_width = settings.image_width
        self.FoVx = self.FoVy = 0.0


def render_from_arrays(camera: CameraArrays, gstate, field, bg, style_f, mode, rvq_s, rvq_r,
                       settings, screenspace_offset=None, sh_override=None):
    """``render`` over a CameraArrays bundle."""
    return render(_CamView(camera, settings), gstate, field, bg, style_f=style_f, mode=mode,
                  rvq_scale=rvq_s, rvq_rot=rvq_r, settings=settings,
                  screenspace_offset=screenspace_offset, tanfovx=camera.tanfovx,
                  tanfovy=camera.tanfovy, sh_override=sh_override)


def _slice6(what: str):
    return NotImplementedError(f"{what} is the multi-view / multi-GPU training of slice 6 of "
                               "the port (ROADMAP queue 1)")


def make_train_step(cfg: GSTrainConfig, spatial_lr_scale: float, phase: str, height: int,
                    width: int, use_rvq: bool = False, views_per_step: int = 1,
                    view_chunk: int | None = None, gaussian_shard=None):
    """The step for 'photometric' or 'style' at one image size. Returns
    ``step(trainer, camera: CameraArrays, style_f, bg) -> (trainer,
    metrics)``; metrics hold the loss and the L1 term as scalar tensors."""
    if views_per_step != 1 or view_chunk:
        raise _slice6(f"views_per_step={views_per_step}")
    if gaussian_shard is not None:
        raise _slice6("gaussian_shard")
    if phase not in ("photometric", "style"):
        raise ValueError(f"unknown phase {phase!r}")
    mode = "train_rvq" if use_rvq else "train"
    settings = make_settings_from_dims(height, width, cfg)

    def step(trainer: TrainerState, camera: CameraArrays, style_f, bg):
        gp = {k: v.detach().requires_grad_() for k, v in _gparams(trainer.gstate).items()}
        fp = {k: v.detach().requires_grad_() for k, v in _field_params(trainer.field).items()}
        gstate = trainer.gstate._replace(**gp)
        field = ColorFieldParams(**{k: fp.get(k) for k in ColorFieldParams._fields})
        offs = torch.zeros((gstate.capacity, 2), device=gstate.xyz.device, requires_grad=True)

        out = render_from_arrays(camera, gstate, field, bg, style_f, mode, trainer.rvq_scale,
                                 trainer.rvq_rot, settings, offs)
        with record_function("gs.loss"):
            img, gt = out.render, camera.image
            ll1 = l1_loss(img, gt)
            if phase == "photometric":
                # Mask regulariser over live slots only.
                act = gstate.active[:, None].to(torch.float32)
                mask_reg = (torch.sum(torch.sigmoid(gstate.mask) * act)
                            / torch.clamp(act.sum(), min=1))
                loss = ((1.0 - cfg.lambda_dssim) * ll1
                        + cfg.lambda_dssim * (1.0 - ssim(img[None], gt[None]))
                        + cfg.lambda_mask * mask_reg)
            else:
                loss = ll1   # gt is the stylized guide
        names = [*gp, *fp]
        leaves = [*gp.values(), *fp.values(), offs]
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        g_gauss = dict(zip(names[:len(gp)], grads[:len(gp)]))
        g_field = dict(zip(names[len(gp):], grads[len(gp):-1]))
        g_offs = grads[-1]

        with record_function("gs.adam"):
            count = int(trainer.opt_g.count)
            new_g, opt_g = adam_update(_gparams(trainer.gstate), g_gauss, trainer.opt_g,
                                       gaussian_lrs(cfg, spatial_lr_scale, count))
            lr_n = net_lr(cfg, int(trainer.opt_net.count))
            new_f, opt_net = adam_update(_field_params(trainer.field), g_field, trainer.opt_net,
                                         {k: lr_n for k in g_field})
        new_field = ColorFieldParams(**{k: new_f.get(k) for k in ColorFieldParams._fields})
        with record_function("gs.stats"):
            gstate = G.add_densification_stats(trainer.gstate._replace(**new_g), g_offs,
                                               out.radii.detach(), width=width, height=height)
        new_trainer = trainer._replace(gstate=gstate, field=new_field, opt_g=opt_g,
                                       opt_net=opt_net, step=trainer.step + 1)
        return new_trainer, {"loss": loss.detach(), "l1": ll1.detach()}

    step.settings = settings
    return step


def zero_moment_slots(opt_state: AdamState, slot_mask: torch.Tensor) -> AdamState:
    """Zero Adam moments at re-used slots after densification appends."""
    c = slot_mask.shape[0]

    def fix(t):
        if t.ndim >= 1 and t.shape[0] == c:
            m = slot_mask.reshape((c,) + (1,) * (t.ndim - 1))
            return torch.where(m, torch.zeros((), dtype=t.dtype, device=t.device), t)
        return t

    return G.tree_map(fix, opt_state)


def _guides(cams, style_image, img_size, use_depth, depth_offset, depth_prominence, guide_out,
            guide_batch, dev) -> dict:
    """One stylized guide per camera, resized to the camera and kept on
    the device (train.py:87-115): the batched serving path of slice 1 when
    no depth map is involved and the cameras share a size, else
    ``adain_inference`` per view."""
    from aip_tpu_torch.ops.image import resize_bilinear, resize_nearest
    from aip_tpu_torch.pipelines.adain_infer import (_test_transform, _to_array,
                                                     adain_inference, precompute_style_stats,
                                                     save_image, stylize_batch_with_stats)

    guides = {}
    same_res = len({(c.image_height, c.image_width) for c in cams}) == 1
    if guide_batch > 1 and not use_depth and same_res and len(cams) > 1:
        from aip_tpu_torch.models import weights as weights_mod

        vggp = weights_mod.get_vgg_params(device=dev)
        decp = weights_mod.get_decoder_params(device=dev)
        style_t = _test_transform(style_image, img_size, False, dev)
        s_mean, s_std = precompute_style_stats(vggp, style_t[None], device=dev)
        Path(guide_out).mkdir(parents=True, exist_ok=True)
        for i0 in range(0, len(cams), guide_batch):
            chunk = cams[i0:i0 + guide_batch]
            gts = [(c.image * 255).astype(np.uint8) for c in chunk]
            cb = torch.stack([_test_transform(g, img_size, False, dev) for g in gts])
            masks = torch.stack([
                resize_nearest(torch.from_numpy((g[..., :1] > 0).astype(np.float32)).to(dev)[None],
                               (cb.shape[1], cb.shape[2]))[0] for g in gts])
            out = torch.clamp(stylize_batch_with_stats(vggp, decp, cb, s_mean, s_std,
                                                       masks=masks, alpha=0.5, device=dev),
                              0.0, 1.0)
            for c, o in zip(chunk, out):
                p = Path(guide_out) / f"{c.image_name}.jpg"
                save_image(o[None], p)
                guides[c.image_name] = resize_bilinear(
                    torch.from_numpy(_to_array(p)).to(dev), (c.image_height, c.image_width))
    else:
        for cam in cams:
            gt = (cam.image * 255).astype(np.uint8)
            mask = (gt > 0).transpose(2, 0, 1)[:1].astype(np.float32)
            path = adain_inference(
                content_img=gt, style_img=style_image, content_size=img_size,
                style_size=img_size, content_mask=mask, output=str(guide_out),
                file_name=cam.image_name, use_depth=use_depth, depth_offset=depth_offset,
                depth_prominence=depth_prominence, compute_dtype=torch.bfloat16, device=dev)
            guides[cam.image_name] = resize_bilinear(
                torch.from_numpy(_to_array(path)).to(dev), (cam.image_height, cam.image_width))
    return guides


def _seed_codebooks(trainer: TrainerState, cfg: GSTrainConfig, gen: torch.Generator):
    """k-means RVQ codebooks on the live scales and rotations."""
    active = trainer.gstate.active
    scales = G.get_scaling(trainer.gstate)[active]
    rots = G.get_rotation(trainer.gstate)[active]
    return trainer._replace(
        rvq_scale=rvq_mod.kmeans_init(scales, cfg.rvq_num, cfg.rvq_size, generator=gen),
        rvq_rot=rvq_mod.kmeans_init(rots, cfg.rvq_num, cfg.rvq_size, generator=gen))


def train(scene, style_image, cfg: GSTrainConfig = GSTrainConfig(), use_depth: bool = False,
          img_size: int = 512, depth_offset: float = 0.5, depth_prominence: float = 20.0,
          guide_dir=None, progress_every: int = 0, seed: int = 0, checkpoint_iterations=(),
          start_checkpoint=None, checkpoint_dir=None, test_iterations=(), logger=None,
          network_gui=None, views_per_step: int = 1, guide_batch: int = 8, mesh=None,
          mesh_axis: str = "dp", gaussian_shard: bool = False, device=None, trace=None):
    """Full two-phase stylized training. Returns (TrainerState, style_f).

    ``scene`` is a ``gs.dataset.Scene``; ``style_image`` a path or array.
    ``device=None`` means CUDA. ``trace``, a dict, is filled as the loop
    runs: ``trace["events"]`` counts the schedule's events as they fire
    (``*_steps``, ``densify_events``, ``opacity_reset``, ``mask_prune_events``,
    ``recompact``, ``regrow``, ``rvq_qat_start``) and the Gaussians they
    added or removed (``cloned``, ``split``, ``pruned``, ``mask_pruned``,
    ``final_mask_pruned``); ``trace["steps"]`` lists (iteration, phase,
    loss, step ms) per step (ms from CUDA events on a card, the host clock on
    the CPU; each traced step synchronises)."""
    from aip_tpu_torch.pipelines.adain_infer import _to_array, get_style_embeddings

    if views_per_step != 1:
        raise _slice6(f"views_per_step={views_per_step}")
    if mesh is not None or gaussian_shard:
        raise _slice6("mesh / gaussian_shard")
    if network_gui is not None:
        raise NotImplementedError("network_gui is the shell slice of the port (ROADMAP queue 1, "
                                  "slice 7)")
    from aip_tpu_torch.gs.checkpoint import load_checkpoint, load_loop_state, save_checkpoint

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    stack: list = []
    pcd = scene.point_cloud
    trainer = init_trainer(cfg, pcd.points, pcd.colors, scene.cameras_extent, seed, device=dev)
    first_iter = 0
    if start_checkpoint is not None:
        trainer = load_checkpoint(start_checkpoint, trainer)
        first_iter = int(trainer.step)
        loop = load_loop_state(start_checkpoint)
        if loop is not None:
            rng.bit_generator.state = loop["rng"]
            gen.set_state(loop["gen"])
            stack = list(loop["stack"])

    bg = torch.tensor([1.0, 1.0, 1.0] if cfg.white_background else [0.0, 0.0, 0.0], device=dev)
    style_f = None
    if cfg.style_dim:
        style_f = get_style_embeddings(_to_array(style_image), device=dev).mean(dim=(1, 2))

    cams = scene.getTrainCameras()
    guide_out = guide_dir or tempfile.mkdtemp(prefix="aip_gs_guides_")
    guides = _guides(cams, style_image, img_size, use_depth, depth_offset, depth_prominence,
                     guide_out, guide_batch, dev)

    steps = {}

    def get_step(phase, cam, use_rvq=False):
        key = (phase, cam.image_height, cam.image_width, use_rvq)
        if key not in steps:
            steps[key] = make_train_step(cfg, scene.cameras_extent, phase, cam.image_height,
                                         cam.image_width, use_rvq=use_rvq)
        return steps[key]

    rvq_start = min(cfg.rvq_iter, cfg.iterations - max(1, cfg.iterations // 30))
    cam_arrays = [camera_to_arrays(c, device=dev) for c in cams]
    guide_arrays = [camera_to_arrays(c, image=guides[c.image_name], device=dev) for c in cams]
    events = trace.setdefault("events", {}) if trace is not None else {}
    step_log = trace.setdefault("steps", []) if trace is not None else None

    def count(name, n=1):
        events[name] = events.get(name, 0) + n

    for it in range(first_iter + 1, cfg.iterations + 1):
        if not stack:
            stack = list(rng.permutation(len(cams)))
        ci = stack.pop()

        # Seed RVQ codebooks at the QAT boundary.
        if it == rvq_start + 1 and trainer.rvq_scale is None:
            trainer = _seed_codebooks(trainer, cfg, gen)
            count("rvq_qat_start")
        use_rvq = it > rvq_start and trainer.rvq_scale is not None

        phase = "photometric" if it < cfg.freeze_iters else "style"
        arrays = cam_arrays if phase == "photometric" else guide_arrays
        step = get_step(phase, cams[ci], use_rvq)
        if step_log is not None:
            t0 = _clock(dev)
        trainer, metrics = step(trainer, arrays[ci], style_f, bg)
        if step_log is not None:
            step_log.append((it, phase + ("_rvq" if use_rvq else ""),
                             float(metrics["loss"]), _elapsed_ms(dev, t0)))
        count(f"{phase}_steps")

        if use_rvq:
            act = trainer.gstate.active
            trainer = trainer._replace(
                rvq_scale=rvq_mod.update_codebooks(trainer.rvq_scale,
                                                   G.get_scaling(trainer.gstate), act),
                rvq_rot=rvq_mod.update_codebooks(trainer.rvq_rot,
                                                 G.get_rotation(trainer.gstate), act))

        # Densification schedule (train.py:264-293).
        if it < cfg.densify_until_iter:
            if it > cfg.densify_from_iter and it % cfg.densification_interval == 0:
                grads = G.avg_densify_grads(trainer.gstate)
                gstate, slots_c = G.densify_and_clone(
                    trainer.gstate, cfg.densify_grad_threshold, cfg.percent_dense,
                    scene.cameras_extent, grads=grads)
                gstate, slots_s = G.densify_and_split(
                    gstate, cfg.densify_grad_threshold, cfg.percent_dense,
                    scene.cameras_extent, grads=grads, generator=gen)
                size_thr = 20.0 if it > cfg.opacity_reset_interval else 0.0
                n_before = int(gstate.n_active)
                gstate = G.prune(gstate, 0.005, scene.cameras_extent, size_thr)
                count("densify_events")
                count("cloned", int(slots_c.sum()))
                count("split", int(slots_s.sum()))
                count("pruned", n_before - int(gstate.n_active))
                gstate = G.reset_stats(gstate)
                trainer = trainer._replace(
                    gstate=gstate, opt_g=zero_moment_slots(trainer.opt_g, slots_c | slots_s))
            if it % cfg.opacity_reset_interval == 0 or (
                    cfg.white_background and it == cfg.densify_from_iter):
                trainer = trainer._replace(gstate=G.reset_opacity(trainer.gstate))
                count("opacity_reset")
        elif it % cfg.mask_prune_iter == 0:
            n_before = int(trainer.gstate.n_active)
            trainer = trainer._replace(gstate=G.mask_prune(trainer.gstate))
            count("mask_prune_events")
            count("mask_pruned", n_before - int(trainer.gstate.n_active))

        # Capacity buckets: pack live slots to the front and shrink, or
        # zero-pad back toward cfg.capacity past 3/4 occupancy.
        if cfg.recompact_floor and it % cfg.densification_interval == 0:
            n = int(trainer.gstate.n_active)
            cap_now = trainer.gstate.capacity
            bucket = G.capacity_bucket(n, floor=cfg.recompact_floor)
            if bucket < cap_now:
                order = G.recompact_order(trainer.gstate)
                trainer = trainer._replace(gstate=G.shrink_tree(trainer.gstate, order, bucket),
                                           opt_g=G.shrink_tree(trainer.opt_g, order, bucket))
                count("recompact")
                if progress_every:
                    print(f"iter {it}: recompact {n} live -> capacity {bucket}")
            elif 4 * n > 3 * cap_now and cap_now < cfg.capacity:
                new_cap = min(bucket, cfg.capacity)
                trainer = trainer._replace(gstate=G.grow_tree(trainer.gstate, cap_now, new_cap),
                                           opt_g=G.grow_tree(trainer.opt_g, cap_now, new_cap))
                count("regrow")
                if progress_every:
                    print(f"iter {it}: regrow {n} live -> capacity {new_cap}")

        if progress_every and it % progress_every == 0:
            print(f"iter {it}: loss={float(metrics['loss']):.5f} "
                  f"n={int(trainer.gstate.n_active)}")
        if logger is not None and it % 10 == 0:
            logger.scalar("train/loss", float(metrics["loss"]), it)
            logger.scalar("train/l1", float(metrics["l1"]), it)
            logger.scalar("train/n_gaussians", int(trainer.gstate.n_active), it)

        if it in test_iterations:
            psnrs, l1s = [], []
            with torch.no_grad():
                for ca in cam_arrays[: min(4, len(cam_arrays))]:
                    settings = make_settings_from_dims(ca.height, ca.width, cfg)
                    out = render_from_arrays(ca, trainer.gstate, trainer.field, bg, style_f,
                                             "train", None, None, settings)
                    img = torch.clamp(out.render, 0.0, 1.0)
                    psnrs.append(float(psnr(img[None], ca.image[None])[0, 0]))
                    l1s.append(float(torch.mean(torch.abs(img - ca.image))))
            if logger is not None:
                logger.scalar("test/psnr", float(np.mean(psnrs)), it)
                logger.scalar("test/l1", float(np.mean(l1s)), it)
            if progress_every:
                print(f"[ITER {it}] eval: L1 {np.mean(l1s):.4f} PSNR {np.mean(psnrs):.2f}")

        if it in checkpoint_iterations:
            ckpt_dir = Path(checkpoint_dir or (Path(guide_out) / "checkpoints"))
            save_checkpoint(ckpt_dir / f"chkpnt{it}", trainer,
                            loop={"rng": rng.bit_generator.state, "gen": gen.get_state(),
                                  "stack": [int(s) for s in stack]})

    # Final mask prune; codebooks seeded here only if the loop never
    # reached the QAT boundary.
    n_before = int(trainer.gstate.n_active)
    trainer = trainer._replace(gstate=G.mask_prune(trainer.gstate))
    count("final_mask_pruned", n_before - int(trainer.gstate.n_active))
    if trainer.rvq_scale is None:
        trainer = _seed_codebooks(trainer, cfg, gen)
    return trainer, style_f


def _clock(dev):
    if dev.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def _elapsed_ms(dev, start) -> float:
    if dev.type == "cuda":
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        end.synchronize()
        return start.elapsed_time(end)
    return (time.perf_counter() - start) * 1e3
