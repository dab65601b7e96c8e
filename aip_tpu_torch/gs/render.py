"""Render a GaussianState with neural colours.

Port of ``aip_tpu/gs/render.py`` (reference
``Style_3DGS/gaussian_renderer/__init__.py:18-130``): style-conditioned SH
from the colour field, SH -> RGB on the view direction, then the
rasterizer. ``render`` has the three modes of the JAX package:
``"inference"`` (no gradient), ``"train"`` (the straight-through mask gate
on scales and opacities) and ``"train_rvq"`` (scales and rotations through
the RVQ codebooks, straight-through), the training modes through the
differentiable ``rasterize``. ``make_inference_frame_fn`` is the serving
path: everything camera-independent (SH, activations) is computed once and
each frame runs the view-dependent SH evaluation and ``rasterize_matmul``.
``fit_selection`` is the JAX package's host-side fit, copied, on top of the
port's ``project_gaussians``; ``fit_macro_capacity`` returns its
macro_capacity alone.

In inference mode ``renderer="pallas"`` takes ``rasterize_fast``, the
per-tile compositor; training modes always rasterize, as in the JAX
package. In inference, ``mesh`` renders with the Gaussians split over
``mesh_axis`` (``parallel.gs.rasterize_sharded``); the training modes
ignore it, as the JAX package's do.

How a view renders in inference is decided here, once:
``takes_macro_route`` (a view of at least ``MACRO_ROUTE_PIXELS`` takes the
macro-block compositors unless the caller names another renderer) and
``inference_settings`` (the macro grid those compositors run on).
"""

from __future__ import annotations

import itertools
import math
from typing import NamedTuple

import numpy as np
import torch

from aip_tpu_torch.gs import gaussians as G
from aip_tpu_torch.gs import rvq as rvq_mod
from aip_tpu_torch.gs.colorfield import ColorFieldParams, predict_sh
from aip_tpu_torch.gs.rasterizer import (TILE, RasterSettings, project_gaussians, rasterize,
                                         rasterize_fast, rasterize_matmul, selection_radii)
from aip_tpu_torch.ops.sh import eval_sh
from aip_tpu_torch.utils.profiling import span


class RenderOutput(NamedTuple):
    render: torch.Tensor        # [H, W, 3]
    radii: torch.Tensor         # [C]
    visibility: torch.Tensor    # [C] bool


MACRO_ROUTE_PIXELS = 512 * 512


def takes_macro_route(height: int, width: int) -> bool:
    """Whether an H x W view renders through the macro-block compositors
    (``rasterize_matmul``) when the renderer is left to choose."""
    return height * width >= MACRO_ROUTE_PIXELS


def inference_settings(settings: RasterSettings) -> RasterSettings:
    """A view's settings on the macro-block route: as given where they
    already name a macro grid (``macro > 1``, whose ``composite_backend`` is
    kept), else macro 4, at least 1024 candidates a block and the
    ``"mxu"`` compositors."""
    if settings.macro > 1:
        return settings
    return settings._replace(macro=4, macro_capacity=max(settings.macro_capacity, 1024),
                             composite_backend="mxu")


def make_settings(camera, max_per_tile: int = 128, chunk: int = 4096) -> RasterSettings:
    return RasterSettings(image_height=camera.image_height, image_width=camera.image_width,
                          max_per_tile=max_per_tile, chunk=chunk)


# Selection-dict keys that map 1:1 onto RasterSettings fields (the schema of
# fit_selection's result and of cfg_args.json["selection"]).
SELECTION_KEYS = ("macro_capacity", "dup_span", "giant_capacity",
                  "giant_backend", "giant_span", "giant_pool",
                  "giant_pool_full", "giant_tiers")


def settings_from_selection(sel: dict, height: int, width: int,
                            max_per_tile: int = 128, **kw) -> RasterSettings:
    """RasterSettings from a (possibly legacy) selection dict."""
    fields = {k: sel[k] for k in SELECTION_KEYS if k in sel}
    if "giant_tiers" in fields:
        # JSON round-trips tuples as lists; keep the settings hashable.
        fields["giant_tiers"] = tuple((int(s), int(p)) for s, p in fields["giant_tiers"])
    return RasterSettings(image_height=height, image_width=width,
                          max_per_tile=max_per_tile, **fields, **kw)


def _camera_tensors(camera, device):
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.as_tensor(np.asarray(camera.world_view_transform), **f32),
            torch.as_tensor(np.asarray(camera.full_proj_transform), **f32),
            torch.as_tensor(np.asarray(camera.camera_center), **f32))


@torch.no_grad()
def fit_selection(state: G.GaussianState, cams, macro: int = 4, sample: int = 8,
                  margin: float = 1.15, lo: int = 1024, hi: int = 4096,
                  max_span: int = 6, opacity_cull: bool = True) -> dict:
    """Fit the pair-sort selection shape to the scene's measured demand
    (``aip_tpu.gs.render.fit_selection``, copied: macro_capacity from the
    worst per-block demand, dup_span and the anchored giant tiers by the
    fewest emitted pair slots, each pool covering the worst measured
    count * margin). One host-side pass over ``sample`` evenly spaced
    cameras; returns the same dict."""
    cams = list(cams)
    if not cams:
        return {"macro_capacity": lo, "dup_span": 2, "giant_capacity": 128,
                "giant_backend": "merge", "max_per_tile": 128}
    step = max(1, len(cams) // sample)
    dev = state.xyz.device
    scales = torch.exp(state.scaling)
    opac = torch.sigmoid(state.opacity)[:, 0]
    active = state.active.cpu().numpy()
    bs = macro * TILE
    worst = 0
    worst_tile = 0
    n_alive_max = 0
    n_blocks_max = 1
    spans = list(range(2, max_span + 1))
    worst_giants = {d: 0 for d in spans}
    tier_spans = [2, 3, 4, 6, 8, 12, 16, 24, 32]
    cum_fit = []
    tot_g = []
    for cam in cams[::step]:
        s = RasterSettings(image_height=cam.image_height, image_width=cam.image_width)
        vm, pm, _ = _camera_tensors(cam, dev)
        mean2d, _depths, _conics, radii, valid = project_gaussians(
            state.xyz, scales, state.rotation, vm, pm,
            math.tan(cam.FoVx * 0.5), math.tan(cam.FoVy * 0.5), s)
        if opacity_cull:
            radii = selection_radii(radii, opac)
        v = ((valid & (opac > 1.0 / 255.0)).cpu().numpy() & active
             & (radii.cpu().numpy() > 0))
        mx = mean2d[:, 0].cpu().numpy()[v]
        my = mean2d[:, 1].cpu().numpy()[v]
        r = radii.cpu().numpy()[v]
        n_alive_max = max(n_alive_max, int(v.sum()))
        th = -(-s.image_height // bs)
        tw = -(-s.image_width // bs)
        n_blocks_max = max(n_blocks_max, th * tw)
        ux0 = np.floor((mx - r) / bs).astype(int)
        ux1 = np.floor((mx + r) / bs).astype(int)
        uy0 = np.floor((my - r) / bs).astype(int)
        uy1 = np.floor((my + r) / bs).astype(int)
        x0 = np.clip(ux0, 0, tw - 1)
        x1 = np.clip(ux1, 0, tw - 1)
        y0 = np.clip(uy0, 0, th - 1)
        y1 = np.clip(uy1, 0, th - 1)

        def rect_hist(shape, ry0, rx0, ry1, rx1):
            d = np.zeros((shape[0] + 1, shape[1] + 1), np.int64)
            np.add.at(d, (ry0, rx0), 1)
            np.add.at(d, (ry0, rx1 + 1), -1)
            np.add.at(d, (ry1 + 1, rx0), -1)
            np.add.at(d, (ry1 + 1, rx1 + 1), 1)
            return d.cumsum(0).cumsum(1)[: shape[0], : shape[1]]

        worst = max(worst, int(rect_hist((th, tw), y0, x0, y1, x1).max()))

        th16 = -(-s.image_height // TILE)
        tw16 = -(-s.image_width // TILE)
        tx0 = np.clip(np.floor((mx - r) / TILE).astype(int), 0, tw16 - 1)
        tx1 = np.clip(np.floor((mx + r) / TILE).astype(int), 0, tw16 - 1)
        ty0 = np.clip(np.floor((my - r) / TILE).astype(int), 0, th16 - 1)
        ty1 = np.clip(np.floor((my + r) / TILE).astype(int), 0, th16 - 1)
        worst_tile = max(worst_tile, int(rect_hist((th16, tw16), ty0, tx0, ty1, tx1).max()))

        sb = max(1, -(-max(th, tw) // 4))
        sth, stw = -(-th // sb), -(-tw // sb)
        sx0, sx1 = x0 // sb, x1 // sb
        sy0, sy1 = y0 // sb, y1 // sb
        cam_cum = {}
        cam_tot = {}
        for d_span in spans:
            g = (ux1 - ux0 >= d_span) | (uy1 - uy0 >= d_span)
            cam_tot[d_span] = int(g.sum())
            if g.any():
                h = rect_hist((sth, stw), sy0[g], sx0[g], sy1[g], sx1[g])
                worst_giants[d_span] = max(worst_giants[d_span], int(h.max()))
                cs = np.maximum(x1 - x0, y1 - y0)[g]
                cam_cum[d_span] = np.array([int((cs < t).sum()) for t in tier_spans])
            else:
                cam_cum[d_span] = np.zeros(len(tier_spans), np.int64)
        cum_fit.append(cam_cum)
        tot_g.append(cam_tot)

    cap = -(-int(worst * margin) // 64) * 64
    kc = max(lo, min(hi, cap))

    def giant_cap(d_span):
        return max(128, -(-int(worst_giants[d_span] * margin) // 64) * 64)

    def bucket(count, floor):
        return max(floor, -(-int(count * margin) // 64) * 64)

    idx_of = {t: i for i, t in enumerate(tier_spans)}
    useful = [t for t in tier_spans if t * t < n_blocks_max]
    tier_tax = max(4096, n_alive_max // 4)

    def fit_direct(d, subset):
        cost = n_alive_max * d * d
        pools = []
        for j, t in enumerate(subset):
            w = 0
            for cc in cum_fit:
                c_hi = int(cc[d][idx_of[t]])
                c_lo = int(cc[d][idx_of[subset[j - 1]]]) if j else 0
                w = max(w, c_hi - c_lo)
            p = bucket(w, 128)
            pools.append((t, p))
            cost += p * t * t + tier_tax
        w_far = 0
        for cc, tg in zip(cum_fit, tot_g):
            c_hi = int(cc[d][idx_of[subset[-1]]]) if subset else 0
            w_far = max(w_far, tg[d] - c_hi)
        p_far = bucket(w_far, 64)
        cost += p_far * n_blocks_max
        return cost, tuple(pools), p_far

    best = None
    for d in spans:
        if not useful:
            cost, pools, p_far = fit_direct(d, (2,))
            best = min(best, (cost, d, pools, p_far)) if best else (cost, d, pools, p_far)
            continue
        for k in range(1, min(3, len(useful)) + 1):
            for subset in itertools.combinations(useful, k):
                cost, pools, p_far = fit_direct(d, subset)
                if best is None or cost < best[0]:
                    best = (cost, d, pools, p_far)
    _, dup, tiers, pool_full = best

    k_tile = max(32, min(512, -(-int(worst_tile * margin) // 32) * 32))
    return {"macro_capacity": kc, "dup_span": dup,
            "giant_capacity": giant_cap(dup),
            "giant_backend": "direct", "giant_tiers": tiers,
            "giant_pool_full": pool_full,
            "max_per_tile": k_tile}


def fit_macro_capacity(state: G.GaussianState, cams, macro: int = 4, sample: int = 8,
                       margin: float = 1.15, lo: int = 1024, hi: int = 4096) -> int:
    """The fitted macro_capacity alone (``aip_tpu.gs.render.fit_macro_capacity``,
    the JAX package's backward-compatible wrapper of ``fit_selection``)."""
    return fit_selection(state, cams, macro=macro, sample=sample, margin=margin, lo=lo,
                         hi=hi)["macro_capacity"]


def _sh_colors(sh: torch.Tensor, xyz: torch.Tensor, campos: torch.Tensor) -> torch.Tensor:
    """View-dependent RGB from per-Gaussian deg-3 SH (CUDA computeColor
    parity: normalize dir, eval, +0.5, clamp at 0)."""
    dirs = xyz - campos[None, :]
    dirs = dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1, keepdim=True), min=1e-8)
    rgb = eval_sh(3, sh.transpose(1, 2), dirs)
    return torch.clamp(rgb + 0.5, min=0.0)


def _inference_activations(state: G.GaussianState):
    """(scales, rotations, opacity) of inference mode; inactive slots get
    opacity 0."""
    opacity = torch.where(state.active, torch.sigmoid(state.opacity)[:, 0],
                          torch.zeros((), device=state.opacity.device))
    return torch.exp(state.scaling), state.rotation, opacity


def make_inference_frame_fn(state: G.GaussianState, field: ColorFieldParams | None,
                            settings: RasterSettings, bg_color,
                            style_f: torch.Tensor | None = None,
                            precomputed_enc: torch.Tensor | None = None,
                            sh_override: torch.Tensor | None = None):
    """One camera->image function for inference serving. The SH
    coefficients and the activations are computed here, once; the returned
    ``frame(vm, pm, campos, tanfovx, tanfovy) -> [H, W, 3]``, one
    ``gs.frame`` span, evaluates the view-dependent colour (``gs.field``)
    and runs ``rasterize_matmul`` on ``inference_settings(settings)``
    (``composite_backend="pallas"`` at a macro grid takes the coefficient
    walk). Tensors live on the state's device."""
    settings = inference_settings(settings)
    with torch.no_grad():
        if sh_override is not None:
            sh = sh_override
        else:
            sh = predict_sh(field, state.xyz, style_f, precomputed_enc=precomputed_enc)
        xyz = state.xyz
        scales, rotations, opacity = _inference_activations(state)
    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=xyz.device)

    @torch.no_grad()
    def frame(vm, pm, campos, tanfovx, tanfovy):
        with span("gs.frame"):
            with span("gs.field"):
                colors = _sh_colors(sh, xyz, campos)
            img, _radii = rasterize_matmul(xyz, scales, rotations, opacity, colors, vm, pm, bg,
                                           settings, tanfovx=tanfovx, tanfovy=tanfovy)
            return img

    frame.settings = settings
    frame.device = xyz.device
    return frame


def render_frame(frame_fn, camera) -> torch.Tensor:
    """Drive a make_inference_frame_fn function with a Camera."""
    vm, pm, campos = _camera_tensors(camera, frame_fn.device)
    return frame_fn(vm, pm, campos, math.tan(camera.FoVx * 0.5), math.tan(camera.FoVy * 0.5))


def render(camera, state: G.GaussianState, field: ColorFieldParams, bg_color,
           style_f: torch.Tensor | None = None, mode: str = "train",
           rvq_scale=None, rvq_rot=None, scaling_modifier: float = 1.0,
           settings: RasterSettings | None = None, screenspace_offset=None,
           precomputed_enc: torch.Tensor | None = None, tanfovx=None, tanfovy=None,
           renderer: str = "auto", sh_override: torch.Tensor | None = None, mesh=None,
           mesh_axis: str = "dp") -> RenderOutput:
    """One view. ``mode`` is ``"train"``, ``"train_rvq"`` or ``"inference"``;
    renderer ``auto`` takes ``matmul`` for an inference view on the
    macro-block route (``takes_macro_route``), else ``xla`` (the
    differentiable ``rasterize``). In inference ``pallas`` is
    ``rasterize_fast``. The
    camera is a Camera, or any object with tensor ``world_view_transform``,
    ``full_proj_transform`` and ``camera_center`` when ``settings`` and the
    tangents are given. Tensors live on the state's device."""
    if mode not in ("train", "train_rvq", "inference"):
        raise ValueError(f"unknown render mode {mode!r}")
    if renderer not in ("auto", "xla", "matmul", "pallas"):
        raise ValueError(f"unknown renderer {renderer!r}")
    if mode == "inference":
        with torch.no_grad():
            return _render(camera, state, field, bg_color, style_f, mode, rvq_scale, rvq_rot,
                           scaling_modifier, settings, screenspace_offset, precomputed_enc,
                           tanfovx, tanfovy, renderer, sh_override, mesh, mesh_axis)
    return _render(camera, state, field, bg_color, style_f, mode, rvq_scale, rvq_rot,
                   scaling_modifier, settings, screenspace_offset, precomputed_enc, tanfovx,
                   tanfovy, renderer, sh_override)


def _render(camera, state, field, bg_color, style_f, mode, rvq_scale, rvq_rot,
            scaling_modifier, settings, screenspace_offset, precomputed_enc, tanfovx, tanfovy,
            renderer, sh_override, mesh=None, mesh_axis="dp") -> RenderOutput:
    if settings is None:
        settings = make_settings(camera)
    if tanfovx is None:
        tanfovx = math.tan(camera.FoVx * 0.5)
    if tanfovy is None:
        tanfovy = math.tan(camera.FoVy * 0.5)
    dev = state.xyz.device
    if isinstance(camera.world_view_transform, torch.Tensor):
        vm, pm, campos = (camera.world_view_transform, camera.full_proj_transform,
                          camera.camera_center)
    else:
        vm, pm, campos = _camera_tensors(camera, dev)
    xyz = state.xyz
    if mode == "inference":
        scales, rotations, opacity = _inference_activations(state)
    else:
        m = G.ste_mask(state)
        if mode == "train_rvq":
            if rvq_scale is None or rvq_rot is None:
                raise ValueError("render(mode='train_rvq') needs rvq_scale and rvq_rot")
            scales = rvq_mod.quantize(rvq_scale, G.get_scaling(state))[0] * m
            rotations = rvq_mod.quantize(rvq_rot, G.get_rotation(state))[0]
        else:
            scales = G.get_scaling(state) * m
            rotations = G.get_rotation(state)
        opacity = (G.get_opacity(state) * m)[:, 0]
        # Inactive slots contribute nothing.
        opacity = torch.where(state.active, opacity, torch.zeros((), device=dev))
    with span("gs.field"):
        if sh_override is not None:
            sh = sh_override
        else:
            sh = predict_sh(field, xyz, style_f, precomputed_enc=precomputed_enc)
        colors = _sh_colors(sh, xyz, campos)
    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=dev)

    if mesh is not None and mode == "inference":
        # The Gaussians split over the mesh, exact against the replicated render.
        from aip_tpu_torch.parallel.gs import rasterize_sharded

        if scaling_modifier != 1.0:
            scales = scales * scaling_modifier
        img, radii = rasterize_sharded(mesh, xyz, scales, rotations, opacity, colors, vm, pm, bg,
                                       inference_settings(settings), tanfovx=tanfovx,
                                       tanfovy=tanfovy, axis=mesh_axis)
        return RenderOutput(render=img, radii=radii,
                            visibility=(radii > 0) & state.active.to(radii.device))

    if renderer == "auto":
        renderer = ("matmul" if mode == "inference"
                    and takes_macro_route(settings.image_height, settings.image_width) else "xla")
    if renderer == "matmul" and mode == "inference":
        img, radii = rasterize_matmul(xyz, scales, rotations, opacity, colors, vm, pm, bg,
                                      inference_settings(settings), tanfovx=tanfovx,
                                      tanfovy=tanfovy, scale_modifier=scaling_modifier)
    elif renderer == "pallas" and mode == "inference":
        img, radii = rasterize_fast(xyz, scales, rotations, opacity, colors, vm, pm, bg,
                                    settings, tanfovx=tanfovx, tanfovy=tanfovy,
                                    scale_modifier=scaling_modifier)
    else:   # "xla", and training always rasterizes
        img, radii = rasterize(xyz, scales, rotations, opacity, colors, vm, pm, bg, settings,
                               tanfovx=tanfovx, tanfovy=tanfovy,
                               scale_modifier=scaling_modifier,
                               screenspace_offset=screenspace_offset)
    return RenderOutput(render=img, radii=radii, visibility=(radii > 0) & state.active)
