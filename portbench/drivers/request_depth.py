"""One client in a closed loop of the depth-aware ``adain_inference`` with
DPT-Large, the call behind ``run_depth --use_depth --depth_model
dpt_large`` and the GUI's depth page: image files in, the stylized PNG and
its 16-bit depth PNG out.

Set-up writes ``contents`` content PNGs (``content_w`` x ``content_h``) and
one style PNG from the seed under the run's scratch directory in
``TMPDIR``; the stylizer's weights (the ``stylizer`` configuration's) as
the npz cache under an ``AIP_TPU_WEIGHTS`` there, their decoder fitted to
``output_std`` on content 0 at ``fit_alpha`` as the request cell fits it;
and a seeded DPT (``drivers/_dpt.py``, calibrated on
``calibration_images`` seeded images of the contents' size) as a
hub-layout ``.pt`` state dict, read by the program through
``depth_weights``. Request k stylizes content k mod ``contents`` with the
depth blend (``depth_offset``, ``depth_prominence``) at ``content_size`` /
``style_size`` and writes ``r<k>.png`` and ``r<k>_depth.png``.

The check reads back every PNG pair the window wrote and compares it with
the plain reference's pipeline of the same content (``reference/dpt.py``,
``reference/depth.py``): ``mean_abs_levels``, the worst image's mean
absolute difference in 8-bit levels, and ``depth_levels``, the worst
depth PNG's largest absolute difference from the reference's normalised
proximity, in 16-bit levels.
"""

from __future__ import annotations

import inspect
import os
import shutil
import statistics

import numpy as np
import torch

from portbench.drivers import _adain, _dpt
from portbench.drivers.request_closed import _levels, _png, _quantile, _write_npz
from portbench.drivers.request_localized import _stylizer_config
from portbench.reference import adain as ref_adain
from portbench.reference import depth as ref_depth
from portbench.reference import dpt as ref_dpt
from portbench.reference import images as ref_images
from portbench.roofline import adain as adain_work
from portbench.roofline import dpt as dpt_work

LEVELS16 = 65535.0


class RequestDepth:
    def __init__(self, ctx):
        self.ctx, p, dev = ctx, ctx.params, ctx.device
        root = ctx.scratch
        shutil.rmtree(root, ignore_errors=True)
        self.inputs, self.out_dir, wdir = root / "in", root / "out", root / "weights"
        for d in (self.inputs, self.out_dir, wdir):
            d.mkdir(parents=True)
        os.environ["AIP_TPU_WEIGHTS"] = str(wdir)
        from aip_tpu_torch.models import weights as weights_mod
        from aip_tpu_torch.pipelines import adain_infer

        if "depth_model" not in inspect.signature(adain_infer.adain_inference).parameters:
            raise SystemExit("adain_inference takes no depth_model: this program cannot run "
                             "DPT on the depth-aware path")
        if weights_mod.DEFAULT_WEIGHTS_DIR != wdir:
            raise RuntimeError("the program read AIP_TPU_WEIGHTS before the benchmark set it")
        self.program = adain_infer
        self.fn = adain_infer.adain_inference
        self.adain_cfg = _stylizer_config(ctx)
        h, w = int(p["content_h"]), int(p["content_w"])
        self.contents = []
        for i in range(int(p["contents"])):
            path = self.inputs / f"content{i}.png"
            _png(path, _adain.images(ctx.seed + 10 + i, 1, h, w, dev))
            self.contents.append(path)
        self.style = self.inputs / "style.png"
        _png(self.style, _adain.images(ctx.seed + 2, 1, int(p["style_h"]), int(p["style_w"]), dev))

        self.enc_w, self.dec_w = _adain.make_weights(self.adain_cfg, ctx.seed, dev)
        self.dec_w = self._fit_output(float(p["output_std"]))
        _write_npz(wdir / "vgg_normalised.npz", self.enc_w,
                   [l for l in self.adain_cfg["encoder_unused"] if l[0] == "conv"])
        _write_npz(wdir / "adain_decoder.npz", self.dec_w, [])

        calibration = _adain.images(ctx.seed + 1000, int(p["calibration_images"]), h, w, dev)
        sd = _dpt.seeded_state_dict(ctx.config, ctx.seed, calibration, float(p["pass_share"]))
        del calibration
        self.sd = {k: v.cpu() for k, v in sd.items()}
        del sd
        self.ckpt = root / "dpt_large-midas.pt"
        torch.save(self.sd, str(self.ckpt))
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        self.k = 0
        self.written = []     # (content index, image path)
        self._refs = {}

    def _fit_output(self, std):
        """The decoder's last conv rescaled per channel: content 0's
        reference output at ``fit_alpha`` gets mean 0.5 and standard
        deviation ``std`` in each channel."""
        p, dev = self.ctx.params, self.ctx.device
        style = ref_images.load_resized(self.style, int(p["style_size"])).to(dev)
        c = ref_images.load_resized(self.contents[0], int(p["content_size"])).to(dev)
        s_mean, s_std = ref_adain.style_stats(self.adain_cfg, self.enc_w, style[None])
        w, b = self.dec_w[-1]
        z = ref_adain.stylize(self.adain_cfg, self.enc_w, self.dec_w, c[None], s_mean, s_std,
                              float(p["fit_alpha"]))[0].reshape(-1, 3) - b
        gain = std / z.std(dim=0)
        return self.dec_w[:-1] + [(w * gain[:, None, None, None], 0.5 - z.mean(dim=0) * gain)]

    def _call(self, i, name):
        p = self.ctx.params
        return self.fn(
            str(self.contents[i]), str(self.style), content_size=int(p["content_size"]),
            style_size=int(p["style_size"]), depth_offset=float(p["depth_offset"]),
            depth_prominence=float(p["depth_prominence"]), save_ext=".png",
            output=str(self.out_dir), file_name=name, use_depth=True, depth_model="dpt_large",
            depth_weights=str(self.ckpt), save_depth=True, compute_dtype=torch.float32,
            device=self.ctx.device)

    def warm(self):
        self._call(0, "warm")

    def unit(self):
        i = self.k % len(self.contents)
        path = self._call(i, f"r{self.k:05d}")
        self.written.append((i, path))
        self.k += 1
        return {}

    def end_to_end(self, records, window_s):
        times = sorted(r["s"] for r in records)
        return {"request_p90_ms": 1e3 * _quantile(times, 0.9)}

    def notes(self, records, window_s):
        times = [r["s"] for r in records]
        loads = [v[2] for v in getattr(self.program, "_DEPTH", {}).values()]
        return {"requests_in_window": len(records),
                "beyond_p90": sum(t > _quantile(sorted(times), 0.9) for t in times),
                "request_ms_median": 1e3 * statistics.median(times),
                "request_ms_mean": 1e3 * statistics.fmean(times), "window_s": window_s,
                "depth_load_ms": loads[0] if loads else None}

    def work(self):
        p, cfg = self.ctx.params, self.ctx.config
        h, w = int(p["content_h"]), int(p["content_w"])
        nh, nw = ref_dpt.transform_size(h, w, cfg["net_size"], cfg["multiple_of"])
        ch, cw = ref_images.smaller_edge_size(h, w, int(p["content_size"]))
        sh, sw = ref_images.smaller_edge_size(int(p["style_h"]), int(p["style_w"]),
                                              int(p["style_size"]))
        dw = dpt_work.work(cfg, nh, nw)
        return {**dw, "flops": dw["dpt_flops"]
                + adain_work.stylize_flops(self.adain_cfg, ch, cw)
                + adain_work.encode_flops(self.adain_cfg, sh, sw)}

    def release(self):
        self.fn = None
        self.program._DEPTH.clear()

    # --- the comparison ---------------------------------------------------------

    def _reference(self, dpt_precision, adain_precision):
        """For each content, with DPT and AdaIN at these precisions: the
        normalised proximity [H, W] float64, the 8-bit stylized image, and
        the share of the proximity's pixels above 0 (what the final ReLU
        passed, after the resize back)."""
        key = (dpt_precision, adain_precision)
        if key in self._refs:
            return self._refs[key]
        p, cfg, dev = self.ctx.params, self.ctx.config, self.ctx.device
        sd = {k: v.to(dev) for k, v in self.sd.items()}
        style = ref_images.load_resized(self.style, int(p["style_size"])).to(dev)
        s_mean, s_std = ref_adain.style_stats(self.adain_cfg, self.enc_w, style[None],
                                              adain_precision)
        out = []
        for path in self.contents:
            img = torch.from_numpy(ref_images.load_uint8(path).copy()).to(dev).float() / 255.0
            prox = ref_dpt.proximity(sd, img, cfg, dpt_precision)
            c = ref_images.load_resized(path, int(p["content_size"])).to(dev)
            stylized = ref_depth.stylize_depth(
                self.adain_cfg, self.enc_w, self.dec_w, c, s_mean, s_std, prox,
                float(p["depth_offset"]), float(p["depth_prominence"]), adain_precision)
            out.append((ref_depth.normalised(prox), ref_adain.to_uint8(stylized).cpu().numpy(),
                        float((prox > 0).float().mean())))
        del sd
        self._refs[key] = out
        return out

    def _compare(self, items):
        """(worst mean abs 8-bit levels, worst largest abs 16-bit depth
        levels) of (content index, image, depth levels) items against the
        fp32 reference's; inf where one is missing or has another shape."""
        want = self._reference("fp32", "fp32")
        worst, depth = 0.0, 0.0
        for i, img, dep in items:
            norm, ref_img, _share = want[i]
            if img is None or dep is None or dep.shape != norm.shape:
                return float("inf"), float("inf")
            worst = max(worst, _levels(img, ref_img))
            depth = max(depth, float(np.abs(dep - LEVELS16 * norm).max()))
        return worst, depth

    def _written(self):
        """(content index, image, depth levels) of each request of the
        window, read back one request at a time (None where a file is
        missing)."""
        from PIL import Image

        for i, path in self.written:
            dpath = path.with_name(f"{path.stem}_depth.png")
            dep = None
            if dpath.is_file():
                with Image.open(str(dpath)) as im:
                    dep = np.asarray(im).astype(np.float64)
            yield (i, ref_images.load_uint8(path) if path.is_file() else None, dep)

    def check(self):
        limits = self.ctx.workload["limits"]
        if not self.written:
            return {k: {"value": None, "limit": v} for k, v in limits.items()}
        worst, depth = self._compare(self._written())
        return {"mean_abs_levels": {"value": worst, "limit": limits["mean_abs_levels"]},
                "depth_levels": {"value": depth, "limit": limits["depth_levels"]}}

    def close(self):
        shutil.rmtree(self.ctx.scratch, ignore_errors=True)

    def control(self):
        """The reference at TF32 in the program's place, whole and in DPT
        alone, its depth maps rounded to 16 bits as a written PNG is; and
        the fp32 reference's share of pixels the final ReLU passed."""
        low = self.ctx.workload["control"]
        out = {}
        for name, key in (("", (low, low)), ("dpt_tf32.", (low, "fp32"))):
            items = [(i, img, np.floor(norm * LEVELS16 + 0.5))
                     for i, (norm, img, _s) in enumerate(self._reference(*key))]
            worst, depth = self._compare(items)
            out.update({f"{name}mean_abs_levels": worst, f"{name}depth_levels": depth})
        out["reference.pass_share"] = [s for _n, _i, s in self._reference("fp32", "fp32")]
        return out


def build(ctx):
    return RequestDepth(ctx)
