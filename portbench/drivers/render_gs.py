"""Stylized 3DGS rendering: a closed loop of ``render_frame`` over an orbit
of cameras, as a video render or a viewer drives it.

Set-up loads the committed model with the program's loader, makes the
style feature from the seed, decodes the hash features once, fits the
selection (``fit_selection(..., macro=4, hi=fit_hi)``), builds the frame
function with ``make_inference_frame_fn`` as ``run_3dgs_rendering`` does,
and renders every camera once. ``params``: ``model`` (a directory of the
checkout), ``views``, ``height``, ``width``, ``fov`` (horizontal),
``elevation_deg``, ``fit_hi``, ``keep``, ``trace_units``. The orbit
circles the model's median at the distance where the sphere holding 80 %
of its splats spans the field of view.

The check renders the kept frames' cameras with the reference (the model
decoded by the benchmark's own reader, no selection capacity) and compares
the worst frame's mean absolute difference (``mean_abs``).
"""

from __future__ import annotations

import math
import random
import statistics
from types import SimpleNamespace

import numpy as np
import torch

from portbench.reference import checkpoint as ref_ckpt
from portbench.reference import gs as ref
from portbench.reference.adain import precision_flags
from portbench.roofline import gs as work_mod


def look_at(pos, center):
    """World-to-camera (x right, y down, z forward) as a 4 x 4 matrix."""
    f = center - pos
    f = f / np.linalg.norm(f)
    r = np.cross(f, [0.0, 0.0, 1.0])
    r = r / np.linalg.norm(r)
    d = np.cross(f, r)
    w2c = np.eye(4)
    w2c[:3, :3] = np.stack([r, d, f])
    w2c[:3, 3] = -w2c[:3, :3] @ pos
    return w2c


def projection(fovx, fovy, znear=0.01, zfar=100.0):
    """The 3DGS perspective matrix (column-vector form)."""
    p = np.zeros((4, 4))
    p[0, 0] = 1.0 / math.tan(fovx / 2)
    p[1, 1] = 1.0 / math.tan(fovy / 2)
    p[3, 2] = 1.0
    p[2, 2] = zfar / (zfar - znear)
    p[2, 3] = -(zfar * znear) / (zfar - znear)
    return p


def make_orbit(p, xyz: np.ndarray, device):
    """(the program's camera objects, the reference's camera dicts)."""
    h, w = int(p["height"]), int(p["width"])
    fovx = float(p["fov"])
    fovy = 2 * math.atan(h / (2 * (w / (2 * math.tan(fovx / 2)))))
    center = np.median(xyz, axis=0)
    dist = np.percentile(np.linalg.norm(xyz - center, axis=1), 80) / math.tan(fovx / 2)
    elev = math.radians(float(p["elevation_deg"]))
    prog, cams = [], []
    for k in range(int(p["views"])):
        a = 2 * math.pi * k / int(p["views"])
        pos = center + dist * np.array([math.cos(a) * math.cos(elev),
                                        math.sin(a) * math.cos(elev), math.sin(elev)])
        wv = look_at(pos, center).T.astype(np.float32)
        full = (wv.astype(np.float64) @ projection(fovx, fovy).T).astype(np.float32)
        prog.append(SimpleNamespace(world_view_transform=wv, full_proj_transform=full,
                                    camera_center=pos.astype(np.float32), FoVx=fovx, FoVy=fovy,
                                    image_height=h, image_width=w))
        f32 = dict(dtype=torch.float32, device=device)
        cams.append({"world_view": torch.tensor(wv, **f32), "full_proj": torch.tensor(full, **f32),
                     "campos": torch.tensor(pos, **f32), "height": h, "width": w,
                     "tanfovx": math.tan(fovx / 2), "tanfovy": math.tan(fovy / 2)})
    return prog, cams


class RenderGS:
    def __init__(self, ctx):
        from aip_tpu_torch.gs import compress
        from aip_tpu_torch.gs import rasterizer as R
        from aip_tpu_torch.gs import render as GR
        from aip_tpu_torch.gs.colorfield import precompute_features

        self.ctx, p, dev = ctx, ctx.params, ctx.device
        self.GR = GR
        self.model = ctx.root / p["model"] / "model.npz"
        state, field, _, _ = compress.load_npz(self.model, device=dev)
        self.n = state.capacity
        gen = torch.Generator(device=dev).manual_seed(ctx.seed)
        self.style_f = torch.relu(torch.randn((1, int(ctx.config["style_features"])),
                                              generator=gen, device=dev))
        self.bg = torch.zeros(3, device=dev)
        self.prog_cams, self.cams = make_orbit(p, state.xyz.cpu().numpy().astype(np.float64), dev)
        enc = precompute_features(field, state.xyz)
        self.sel = GR.fit_selection(state, self.prog_cams, macro=int(ctx.config["macro"]),
                                    hi=int(p["fit_hi"]))
        settings = GR.settings_from_selection(self.sel, int(p["height"]), int(p["width"]),
                                              max_per_tile=self.sel["max_per_tile"])
        self.fn = GR.make_inference_frame_fn(state, field, settings, self.bg,
                                             style_f=self.style_f, precomputed_enc=enc)
        self.branch = "segment" if R.uses_segment_path(self.n, self.fn.settings) else "windowed"
        self.k = 0
        self.rng = random.Random(ctx.seed)
        self.keep = int(p["keep"])
        self.kept = []     # reservoir of (camera index, frame)

    def warm(self):
        for cam in self.prog_cams:
            self.GR.render_frame(self.fn, cam)

    def unit(self):
        i = self.k % len(self.prog_cams)
        frame = self.GR.render_frame(self.fn, self.prog_cams[i])
        if len(self.kept) < self.keep:
            self.kept.append((i, frame))
        else:
            j = self.rng.randrange(self.k + 1)
            if j < self.keep:
                self.kept[j] = (i, frame)
        self.k += 1
        return {}

    def end_to_end(self, records, window_s):
        return {"frames_per_s": len(records) / window_s}

    def notes(self, records, window_s):
        return {"frames_in_window": len(records), "window_s": window_s,
                "frame_ms_median": 1e3 * statistics.median(r["s"] for r in records),
                "branch": self.branch, "gaussians": self.n,
                "selection": {k: v for k, v in self.sel.items()},
                "macro_capacity": self.fn.settings.macro_capacity}

    def work(self):
        leaves = self._reference_leaves()
        cam = self.cams[self.kept[0][0]]
        with precision_flags("fp32"):
            _, live, blocks = ref.render_inference(leaves, self.active, cam, self.style_f,
                                                   self.bg, self.ctx.config)
        return work_mod.render_frame_work(cam["height"], cam["width"], live, blocks,
                                          int(self.active.sum()))

    def release(self):
        self.fn = None

    def _reference_leaves(self):
        if not hasattr(self, "_leaves"):
            g, f = ref_ckpt.load(self.model, self.ctx.device)
            self._leaves = {**g, **f}
            self.active = torch.ones(g["xyz"].shape[0], dtype=torch.bool,
                                     device=self.ctx.device)
        return self._leaves

    def _worst(self, frames):
        leaves = self._reference_leaves()
        worst = 0.0
        for (i, _), got in zip(self.kept, frames):
            with precision_flags("fp32"):
                want, _, _ = ref.render_inference(leaves, self.active, self.cams[i],
                                                  self.style_f, self.bg, self.ctx.config)
            if got.shape != want.shape or not torch.isfinite(got).all():
                return math.inf
            worst = max(worst, float((got.float() - want).abs().mean()))
        return worst

    def check(self):
        value = self._worst([f for _, f in self.kept])
        return {"mean_abs": {"value": value, "limit": self.ctx.workload["limits"]["mean_abs"]}}

    def control(self):
        leaves = self._reference_leaves()
        low = []
        for i, _ in self.kept:
            with precision_flags(self.ctx.workload["control"]):
                low.append(ref.render_inference(leaves, self.active, self.cams[i], self.style_f,
                                                self.bg, self.ctx.config)[0])
        return {"mean_abs": self._worst(low)}


def build(ctx):
    return RenderGS(ctx)
