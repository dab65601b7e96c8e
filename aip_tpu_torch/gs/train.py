"""Stylized 3DGS training loop (Compact-3DGS schedule + AdaIN style phase).

Port of ``aip_tpu/gs/train.py`` (reference ``Style_3DGS/train.py:42-307``,
defaults ``arguments/__init__.py:75-99``):

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
masks. The step names its stages with ``utils.profiling`` spans
(``gs.loss``, ``gs.adam``, ``gs.stats``, beside
the renderer's ``gs.field`` and the rasterizer's four), which
``chip_smoke.py``'s step breakdown reads.

Random draws (split offsets, k-means starts) come from one
``torch.Generator`` seeded with ``seed``, the view order from numpy's
``default_rng(seed)`` as in the JAX package; a checkpoint carries both
states, so a resumed run continues exactly. ``views_per_step > 1``
batches views into one step (``make_train_step``); ``mesh`` and
``gaussian_shard`` shard it (``parallel.gs``); ``network_gui`` (a
``gs.network_gui.NetworkGUI``) serves a connected viewer one inference
frame a loop pass.
"""

from __future__ import annotations

import math
import tempfile
import time
import warnings
from dataclasses import dataclass
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from aip_tpu_torch.device import resolve_device
from aip_tpu_torch.gs import gaussians as G
from aip_tpu_torch.gs import rvq as rvq_mod
from aip_tpu_torch.gs.colorfield import ColorFieldParams, init_colorfield, predict_sh
from aip_tpu_torch.gs.rasterizer import TILE, RasterSettings, _pairsort_slots
from aip_tpu_torch.gs.render import render
from aip_tpu_torch.ops.metrics import l1_loss, psnr, ssim
from aip_tpu_torch.utils.profiling import span


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


def make_settings_from_dims(height: int, width: int, cfg: GSTrainConfig) -> RasterSettings:
    """The JAX package's rule: hierarchical selection from
    ``macro_above_pixels``; ``ad_backend`` from the JAX package's dense
    autodiff budget, which chooses only between CPU paths (on a card the
    composite is always kernels A/B)."""
    macro = cfg.macro if height * width >= cfg.macro_above_pixels else 1
    n_tiles = ((height + 15) // 16) * ((width + 15) // 16)
    per_view = n_tiles * cfg.max_per_tile * 256 * 4
    ad_backend = "pallas" if per_view > cfg.ad_stream_above_bytes else "xla"
    return RasterSettings(
        image_height=height, image_width=width,
        max_per_tile=cfg.max_per_tile, chunk=cfg.raster_chunk,
        macro=macro, macro_capacity=cfg.macro_capacity,
        dup_span=cfg.dup_span, giant_capacity=cfg.giant_capacity,
        giant_backend=cfg.giant_backend, giant_span=cfg.giant_span,
        giant_pool=cfg.giant_pool, giant_pool_full=cfg.giant_pool_full,
        ad_backend=ad_backend,
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


def stack_cameras(cams: list) -> CameraArrays:
    """Stack same-resolution CameraArrays into a view batch (leading dim B)
    for a views_per_step > 1 train step."""
    if len({(c.height, c.width) for c in cams}) != 1:
        raise ValueError("stack_cameras needs views of one resolution")
    dev = cams[0].world_view.device
    return CameraArrays(
        world_view=torch.stack([c.world_view for c in cams]),
        full_proj=torch.stack([c.full_proj for c in cams]),
        campos=torch.stack([c.campos for c in cams]),
        image=torch.stack([c.image for c in cams]),
        height=cams[0].height, width=cams[0].width,
        tanfovx=torch.tensor([float(c.tanfovx) for c in cams], dtype=torch.float32, device=dev),
        tanfovy=torch.tensor([float(c.tanfovy) for c in cams], dtype=torch.float32, device=dev))


def _unstack(camera) -> list:
    """[(one view's CameraArrays, its device)] of a stacked batch, or of a
    ``Sharded`` batch's parts in shard order (each view on its part's
    device)."""
    from aip_tpu_torch.parallel.sharding import Sharded

    parts = camera.parts if isinstance(camera, Sharded) else (camera,)
    views = []
    for part in parts:
        tx, ty = part.tanfovx.tolist(), part.tanfovy.tolist()
        for i in range(part.world_view.shape[0]):
            views.append(CameraArrays(part.world_view[i], part.full_proj[i], part.campos[i],
                                      part.image[i], part.height, part.width, tx[i], ty[i]))
    return [(v, v.world_view.device) for v in views]


def _view_chunk(n_views: int, view_chunk, per_view: int) -> int:
    """Views a chunk: ``view_chunk`` (which must divide the batch), else the
    JAX package's rule: the largest divisor of B whose views stay within
    1 GiB of ``_per_view_bytes``."""
    if view_chunk:
        if n_views % view_chunk:
            raise ValueError(f"view_chunk ({view_chunk}) must divide views_per_step "
                             f"({n_views})")
        return view_chunk
    vchunk = n_views
    while vchunk > 1 and (n_views % vchunk or vchunk * per_view > (1 << 30)):
        vchunk -= 1
    return vchunk


def make_train_step(cfg: GSTrainConfig, spatial_lr_scale: float, phase: str, height: int,
                    width: int, use_rvq: bool = False, views_per_step: int = 1,
                    view_chunk: int | None = None, gaussian_shard=None):
    """The step for 'photometric' or 'style' at one image size. Returns
    ``step(trainer, camera, style_f, bg) -> (trainer, metrics)``; metrics
    hold the loss and the L1 term as scalar tensors.

    ``views_per_step`` B > 1 renders a batch of views per optimiser step
    (``camera`` a ``stack_cameras`` batch, or a ``parallel.gs.
    shard_view_batch`` of one, whose views render on their shard's device):
    the colour field runs once for the batch and the views render with
    its SH as ``sh_override``; the loss is the mean over views; views go in
    chunks of ``view_chunk`` (``_view_chunk``), each chunk one backward to
    the Gaussian parameters and a detached SH leaf, so one chunk's graphs
    are freed before the next is built; the SH gradients summed over the
    chunks then take one backward through the colour field (kernel C once
    a batch, kernels A and B once a view). Densification statistics are
    added per view, in view order, at B times the mean loss's offset
    gradient, as B reference iterations would add them; both optimisers
    read their schedules at B times their count, and ``step`` advances by
    B. ``gaussian_shard=(mesh, axis)`` computes the SH with
    ``parallel.gs.predict_sh_sharded`` (with B = 1 too)."""
    if phase not in ("photometric", "style"):
        raise ValueError(f"unknown phase {phase!r}")
    n_views = views_per_step
    if n_views < 1:
        raise ValueError(f"views_per_step must be >= 1, got {n_views}")
    mode = "train_rvq" if use_rvq else "train"
    settings = make_settings_from_dims(height, width, cfg)
    vchunk = _view_chunk(n_views, view_chunk, _per_view_bytes(height, width, cfg, settings))
    batched = n_views > 1 or gaussian_shard is not None

    def view_loss(gstate, field, camera, style_f, bg, offs, rvq_s, rvq_r, sh=None):
        out = render_from_arrays(camera, gstate, field, bg, style_f, mode, rvq_s, rvq_r,
                                 settings, offs, sh_override=sh)
        with span("gs.loss"):
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
        return loss, ll1, out.radii.detach()

    def compute_sh(field, gstate, style_f):
        if gaussian_shard is not None:
            from aip_tpu_torch.parallel.gs import predict_sh_sharded

            mesh, axis = gaussian_shard
            return predict_sh_sharded(mesh, field, gstate.xyz, style_f, axis=axis)
        return predict_sh(field, gstate.xyz, style_f)

    def grads_one_view(trainer, gp, fp, gstate, field, camera, style_f, bg):
        """The one-view step's forward and one backward."""
        offs = torch.zeros((gstate.capacity, 2), device=gstate.xyz.device, requires_grad=True)
        loss, ll1, radii = view_loss(gstate, field, camera, style_f, bg, offs, trainer.rvq_scale,
                                     trainer.rvq_rot)
        leaves = [*gp.values(), *fp.values(), offs]
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        return (loss, ll1, dict(zip(gp, grads[:len(gp)])),
                dict(zip(fp, grads[len(gp):-1])), [grads[-1]], [radii])

    def grads_batched(trainer, gp, fp, gstate, field, camera, style_f, bg):
        """The colour field once, the views in chunks, the field's backward
        once (see the docstring)."""
        home = gstate.xyz.device
        views = [(camera, home)] if n_views == 1 else _unstack(camera)
        if len(views) != n_views:
            raise ValueError(f"a batch of {len(views)} views for views_per_step={n_views}")
        with span("gs.field"):
            sh = compute_sh(field, gstate, style_f)
        sh_leaf = sh.detach().requires_grad_()
        placed = {}

        def on(dev):
            """The step's inputs on ``dev`` (copies that carry gradients home)."""
            if dev not in placed:
                rvq = [None if r is None else G.tree_map(lambda t: t.to(dev), r)
                       for r in (trainer.rvq_scale, trainer.rvq_rot)]
                placed[dev] = (G.tree_map(lambda t: t.to(dev), gstate), sh_leaf.to(dev),
                               bg.to(dev), *rvq)
            return placed[dev]

        g_gauss = dict.fromkeys(gp)
        g_sh = None
        losses, ll1s, g_offs, radii = [], [], [], []
        for c0 in range(0, n_views, vchunk):
            total, offs_c = 0.0, []
            for cam_v, dev in views[c0:c0 + vchunk]:
                gs_v, sh_v, bg_v, rvq_s, rvq_r = on(dev)
                offs = torch.zeros((gstate.capacity, 2), device=home, requires_grad=True)
                loss, ll1, rad = view_loss(gs_v, None, cam_v, None, bg_v, offs.to(dev), rvq_s,
                                           rvq_r, sh=sh_v)
                total = total + loss.to(home) / n_views
                losses.append(loss.detach().to(home))
                ll1s.append(ll1.detach().to(home))
                radii.append(rad.to(home))
                offs_c.append(offs)
            leaves = [*gp.values(), sh_leaf, *offs_c]
            grads = torch.autograd.grad(total, leaves, allow_unused=True)
            placed.clear()   # this chunk's graphs go with their last reference
            for k, g in zip(gp, grads):
                if g is not None:
                    g_gauss[k] = g if g_gauss[k] is None else g_gauss[k] + g
            g = grads[len(gp)]
            g_sh = g if g_sh is None else g_sh + g
            g_offs += [torch.zeros_like(o) if go is None else go
                       for o, go in zip(offs_c, grads[len(gp) + 1:])]
        # One backward through the colour field with the summed SH gradient
        # (the field reads the positions detached: no gradient to xyz).
        f_grads = torch.autograd.grad(sh, list(fp.values()), grad_outputs=g_sh,
                                      allow_unused=True)
        g_gauss = {k: torch.zeros_like(gp[k]) if g is None else g for k, g in g_gauss.items()}
        g_field = {k: torch.zeros_like(p) if g is None else g
                   for (k, p), g in zip(fp.items(), f_grads)}
        loss = torch.stack(losses).mean()
        return (loss, torch.stack(ll1s).mean(), g_gauss, g_field,
                [g * n_views for g in g_offs], radii)

    def step(trainer: TrainerState, camera, style_f, bg):
        gp = {k: v.detach().requires_grad_() for k, v in _gparams(trainer.gstate).items()}
        fp = {k: v.detach().requires_grad_() for k, v in _field_params(trainer.field).items()}
        gstate = trainer.gstate._replace(**gp)
        field = ColorFieldParams(**{k: fp.get(k) for k in ColorFieldParams._fields})
        fn = grads_batched if batched else grads_one_view
        loss, ll1, g_gauss, g_field, g_offs, radii = fn(trainer, gp, fp, gstate, field, camera,
                                                        style_f, bg)
        with span("gs.adam"):
            count = int(trainer.opt_g.count)
            new_g, opt_g = adam_update(_gparams(trainer.gstate), g_gauss, trainer.opt_g,
                                       gaussian_lrs(cfg, spatial_lr_scale, count * n_views))
            lr_n = net_lr(cfg, int(trainer.opt_net.count) * n_views)
            new_f, opt_net = adam_update(_field_params(trainer.field), g_field, trainer.opt_net,
                                         {k: lr_n for k in g_field})
        new_field = ColorFieldParams(**{k: new_f.get(k) for k in ColorFieldParams._fields})
        with span("gs.stats"):
            gstate = trainer.gstate._replace(**new_g)
            for g, r in zip(g_offs, radii):
                gstate = G.add_densification_stats(gstate, g, r, width=width, height=height)
        new_trainer = trainer._replace(gstate=gstate, field=new_field, opt_g=opt_g,
                                       opt_net=opt_net, step=trainer.step + n_views)
        return new_trainer, {"loss": loss.detach(), "l1": ll1.detach()}

    step.settings = settings
    step.view_chunk = vchunk
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
    the CPU; each traced step synchronises).

    ``views_per_step`` B > 1 consumes B views a step; one step covers the
    reference iterations (it - B, it], and every iteration-indexed event
    fires in the window that crosses it (at B = 1 each guard is the
    per-iteration one). All train cameras must share one resolution, and
    the iterations and the resume point must be multiples of B
    (``ValueError``); a resume with another B rebases both Adam counts to
    the resume point over B. The phase is that of the window's first
    iteration; under RVQ the codebooks take B updates a window.

    ``mesh`` (a ``parallel.mesh.Mesh``) puts the trainer on its home device
    and splits each view batch over ``mesh_axis`` (B % dp == 0), each chunk
    being the whole batch; ``gaussian_shard=True`` also splits the colour
    field's Gaussians over it (``parallel.gs.predict_sh_sharded``: a
    power-of-two axis that divides ``recompact_floor`` and ``capacity``).

    ``network_gui`` (a ``gs.network_gui.NetworkGUI``) is polled once a loop
    pass, before the pass draws its views: a connected viewer's request is
    rendered from the current state and style (``mode="inference"``, its
    scaling modifier, ``max_per_tile`` from ``cfg``) and sent as HWC uint8
    bytes with the scene's ``ply_path`` as the verify string. The viewer is
    dropped when it asks not to be kept alive, and on any error."""
    from aip_tpu_torch.gs.checkpoint import load_checkpoint, load_loop_state, save_checkpoint
    from aip_tpu_torch.pipelines.adain_infer import _to_array, get_style_embeddings

    B = views_per_step
    pgs = None
    if mesh is not None:
        from aip_tpu_torch.parallel import gs as pgs

        dp = mesh.shape[mesh_axis]
        if B > 1 and B % dp:
            raise ValueError(f"views_per_step ({B}) must be a multiple of mesh axis "
                             f"{mesh_axis!r} ({dp})")
        if gaussian_shard and (dp & (dp - 1) or cfg.recompact_floor % dp
                               or cfg.capacity % dp):
            raise ValueError(
                "gaussian_shard needs a power-of-two mesh axis dividing recompact_floor and "
                f"capacity (got dp={dp}, floor={cfg.recompact_floor}, capacity={cfg.capacity})")
        dev = resolve_device(mesh.home)
    elif gaussian_shard:
        raise ValueError("gaussian_shard requires a mesh")
    else:
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
    if pgs is not None:
        trainer = pgs.replicate_trainer(mesh, trainer)

    cams = scene.getTrainCameras()
    if B > 1:
        if len({(c.image_height, c.image_width) for c in cams}) != 1:
            raise ValueError("views_per_step > 1 requires all train cameras at one resolution")
        if first_iter % B or (cfg.iterations - first_iter) % B:
            raise ValueError(f"iterations ({cfg.iterations}) and resume point ({first_iter}) "
                             f"must be multiples of views_per_step ({B})")
    if start_checkpoint is not None:
        # The schedules read count * B; a checkpoint written with another B
        # counts in its own steps, so rebase both counts to the resume point.
        cnt = torch.tensor(first_iter // B, dtype=torch.int32)
        trainer = trainer._replace(opt_g=trainer.opt_g._replace(count=cnt),
                                   opt_net=trainer.opt_net._replace(count=cnt.clone()))

    guide_out = guide_dir or tempfile.mkdtemp(prefix="aip_gs_guides_")
    guides = _guides(cams, style_image, img_size, use_depth, depth_offset, depth_prominence,
                     guide_out, guide_batch, dev)

    steps = {}

    def get_step(phase, cam, use_rvq=False):
        key = (phase, cam.image_height, cam.image_width, use_rvq)
        if key not in steps:
            steps[key] = make_train_step(
                cfg, scene.cameras_extent, phase, cam.image_height, cam.image_width,
                use_rvq=use_rvq, views_per_step=B,
                # A dp-split batch is one chunk: each device holds B/dp views.
                view_chunk=B if pgs is not None and B > 1 else None,
                gaussian_shard=(mesh, mesh_axis) if gaussian_shard else None)
        return steps[key]

    rvq_start = min(cfg.rvq_iter, cfg.iterations - max(1, cfg.iterations // 30))
    cam_arrays = [camera_to_arrays(c, device=dev) for c in cams]
    guide_arrays = [camera_to_arrays(c, image=guides[c.image_name], device=dev) for c in cams]
    events = trace.setdefault("events", {}) if trace is not None else {}
    step_log = trace.setdefault("steps", []) if trace is not None else None

    def count(name, n=1):
        events[name] = events.get(name, 0) + n

    # One pass covers reference iterations (it - B, it]; at B = 1 the guards
    # are the per-iteration ones (mod_fire(m): it % m == 0, crossed(x): it == x).
    for it in range(first_iter + B, cfg.iterations + 1, B):
        prev = it - B

        def crossed(x):
            return prev < x <= it

        def mod_fire(m):
            return it // m > prev // m

        if network_gui is not None:
            _serve_viewer(network_gui, trainer, bg, style_f, cfg, scene.scene_info.ply_path)
        cis = []
        for _ in range(B):
            if not stack:
                stack = list(rng.permutation(len(cams)))
            cis.append(stack.pop())

        # Seed RVQ codebooks at the QAT boundary.
        if crossed(rvq_start + 1) and trainer.rvq_scale is None:
            trainer = _seed_codebooks(trainer, cfg, gen)
            count("rvq_qat_start")
        use_rvq = it > rvq_start and trainer.rvq_scale is not None

        # The phase of the window's first iteration.
        phase = "photometric" if prev + 1 < cfg.freeze_iters else "style"
        arrays = cam_arrays if phase == "photometric" else guide_arrays
        batch = arrays[cis[0]] if B == 1 else stack_cameras([arrays[c] for c in cis])
        if pgs is not None and B > 1:
            batch = pgs.shard_view_batch(mesh, batch, axis=mesh_axis)
        step = get_step(phase, cams[cis[0]], use_rvq)
        if step_log is not None:
            t0 = _clock(dev)
        trainer, metrics = step(trainer, batch, style_f, bg)
        if step_log is not None:
            step_log.append((it, phase + ("_rvq" if use_rvq else ""),
                             float(metrics["loss"]), _elapsed_ms(dev, t0)))
        count(f"{phase}_steps")

        if use_rvq:
            # One codebook update per reference iteration.
            act = trainer.gstate.active
            for _ in range(B):
                trainer = trainer._replace(
                    rvq_scale=rvq_mod.update_codebooks(trainer.rvq_scale,
                                                       G.get_scaling(trainer.gstate), act),
                    rvq_rot=rvq_mod.update_codebooks(trainer.rvq_rot,
                                                     G.get_rotation(trainer.gstate), act))

        # Densification schedule (train.py:264-293).
        if it < cfg.densify_until_iter:
            if it > cfg.densify_from_iter and mod_fire(cfg.densification_interval):
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
            if mod_fire(cfg.opacity_reset_interval) or (
                    cfg.white_background and crossed(cfg.densify_from_iter)):
                trainer = trainer._replace(gstate=G.reset_opacity(trainer.gstate))
                count("opacity_reset")
        elif mod_fire(cfg.mask_prune_iter):
            n_before = int(trainer.gstate.n_active)
            trainer = trainer._replace(gstate=G.mask_prune(trainer.gstate))
            count("mask_prune_events")
            count("mask_pruned", n_before - int(trainer.gstate.n_active))

        # Capacity buckets: pack live slots to the front and shrink, or
        # zero-pad back toward cfg.capacity past 3/4 occupancy.
        if cfg.recompact_floor and mod_fire(cfg.densification_interval):
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

        if progress_every and mod_fire(progress_every):
            print(f"iter {it}: loss={float(metrics['loss']):.5f} "
                  f"n={int(trainer.gstate.n_active)}")
        if logger is not None and mod_fire(10):
            logger.scalar("train/loss", float(metrics["loss"]), it)
            logger.scalar("train/l1", float(metrics["l1"]), it)
            logger.scalar("train/n_gaussians", int(trainer.gstate.n_active), it)

        if any(crossed(x) for x in test_iterations):
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

        for x in checkpoint_iterations:
            if crossed(x):
                # Saved under the requested iteration's name; with B > 1 the
                # state is up to B - 1 iterations newer.
                ckpt_dir = Path(checkpoint_dir or (Path(guide_out) / "checkpoints"))
                save_checkpoint(ckpt_dir / f"chkpnt{x}", trainer,
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


def _serve_viewer(network_gui, trainer: TrainerState, bg, style_f, cfg: GSTrainConfig,
                  verify: str) -> None:
    """One remote-viewer poll (``aip_tpu/gs/train.py:773-800``): accept a
    waiting viewer, answer its request with a frame of the current state,
    and drop it when it asks not to be kept alive or anything fails."""
    network_gui.try_connect()
    if network_gui.conn is None:
        return
    try:
        cam, _do_training, keep_alive, scaling = network_gui.receive()
        frame = None
        if cam is not None:
            out = render(cam, trainer.gstate, trainer.field, bg, style_f=style_f,
                         mode="inference", scaling_modifier=scaling,
                         settings=RasterSettings(cam.image_height, cam.image_width,
                                                 max_per_tile=cfg.max_per_tile))
            frame = (np.clip(out.render.cpu().numpy(), 0, 1) * 255).astype(np.uint8)
        network_gui.send(frame, verify)
        if not keep_alive:
            network_gui.disconnect()
    except Exception as e:  # the viewer is optional: training goes on without it
        warnings.warn(f"remote viewer dropped: {e!r}", RuntimeWarning)
        network_gui.disconnect()


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
