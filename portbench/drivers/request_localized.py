"""One client in a closed loop of ``run_localized_style_transfer`` with
the DeepLab segmenter, the call behind the regional CLI and GUI page:
image files in, a result JPEG and its mask PNG out.

Set-up writes ``contents`` content PNGs (``content_w`` x ``content_h``) and
one style PNG from the seed under the run's scratch directory in
``TMPDIR``; the stylizer's weights (the ``stylizer`` configuration's) as the
npz cache under an ``AIP_TPU_WEIGHTS`` there, their decoder fitted to
``output_std`` on content 0 as the request cell fits it; and a seeded
DeepLabV3-ResNet101 checkpoint (``drivers/_deeplab.py``) as a torchvision
``.pt`` state dict, read by the program through ``deeplab_weights``.
Request k segments, stylizes and harmonizes content k mod ``contents`` into
a directory of its own (the result's name is fixed) and saves the mask.

The check reads back every result JPEG and mask the window wrote and
compares them with the plain reference's pipeline of the same content
(``reference/localized.py``): ``mean_abs_levels``, the worst result's mean
absolute difference in 8-bit levels, and ``mask_flips_outside_band``, the
pixels where a written mask differs from the reference's and the
reference's P(class 0) lies farther than ``mask_band`` from 0.5.
"""

from __future__ import annotations

import inspect
import json
import os
import shutil
import statistics

import numpy as np
import torch

from portbench.drivers import _adain, _deeplab
from portbench.drivers.request_closed import _levels, _png, _quantile, _write_npz
from portbench.reference import adain as ref_adain
from portbench.reference import deeplab as ref_deeplab
from portbench.reference import images as ref_images
from portbench.reference import localized as ref_local
from portbench.roofline import adain as adain_work
from portbench.roofline import deeplab as deeplab_work

RESULT = "localized_style_transfer_result.jpg"
MASK = "localized_style_transfer_mask.png"


def _stylizer_config(ctx) -> dict:
    bench = json.loads((ctx.root / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == ctx.config["stylizer"])
    return json.loads((ctx.root / entry["file"]).read_text())


class RequestLocalized:
    def __init__(self, ctx):
        self.ctx, p, dev = ctx, ctx.params, ctx.device
        root = ctx.scratch
        shutil.rmtree(root, ignore_errors=True)
        self.inputs, self.out_dir, wdir = root / "in", root / "out", root / "weights"
        for d in (self.inputs, self.out_dir, wdir):
            d.mkdir(parents=True)
        os.environ["AIP_TPU_WEIGHTS"] = str(wdir)
        from aip_tpu_torch.models import weights as weights_mod
        from aip_tpu_torch.pipelines import localized

        if "segmenter" not in inspect.signature(localized.run_localized_style_transfer).parameters:
            raise SystemExit("run_localized_style_transfer takes no segmenter: this program "
                             "cannot run DeepLab on the regional path")
        if weights_mod.DEFAULT_WEIGHTS_DIR != wdir:
            raise RuntimeError("the program read AIP_TPU_WEIGHTS before the benchmark set it")
        self.program = localized
        self.fn = localized.run_localized_style_transfer
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
        sd = _deeplab.seeded_state_dict(ctx.config, ctx.seed, calibration,
                                        float(p["background_share"]), float(p["residual_gamma"]))
        del calibration
        self.sd = {k: v.cpu() for k, v in sd.items()}
        del sd
        self.ckpt = root / "deeplabv3_resnet101.pt"
        torch.save(self.sd, str(self.ckpt))
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        self.k = 0
        self.written = []     # (content index, request directory)
        self._refs = {}

    def _fit_output(self, std):
        """The decoder's last conv rescaled per channel: content 0's
        reference output at alpha 1 gets mean 0.5 and standard deviation
        ``std`` in each channel."""
        p, dev = self.ctx.params, self.ctx.device
        style = ref_images.load_resized(self.style, int(p["style_size"])).to(dev)
        c = ref_images.load_resized(self.contents[0], int(p["content_size"])).to(dev)
        s_mean, s_std = ref_adain.style_stats(self.adain_cfg, self.enc_w, style[None])
        w, b = self.dec_w[-1]
        z = ref_adain.stylize(self.adain_cfg, self.enc_w, self.dec_w, c[None], s_mean, s_std,
                              1.0)[0].reshape(-1, 3) - b
        gain = std / z.std(dim=0)
        return self.dec_w[:-1] + [(w * gain[:, None, None, None], 0.5 - z.mean(dim=0) * gain)]

    def _call(self, i, out):
        return self.fn(str(self.contents[i]), str(self.style), output_path=str(out),
                       file_name="stylized", device=self.ctx.device, segmenter="deeplab",
                       deeplab_weights=str(self.ckpt), save_mask=True)

    def warm(self):
        self._call(0, self.out_dir / "warm")

    def unit(self):
        i = self.k % len(self.contents)
        out = self.out_dir / f"r{self.k:05d}"
        self._call(i, out)
        self.written.append((i, out))
        self.k += 1
        return {}

    def end_to_end(self, records, window_s):
        times = sorted(r["s"] for r in records)
        return {"request_p90_ms": 1e3 * _quantile(times, 0.9)}

    def notes(self, records, window_s):
        times = [r["s"] for r in records]
        loads = [v[2] for v in getattr(self.program, "_DEEPLAB", {}).values()]
        return {"requests_in_window": len(records),
                "beyond_p90": sum(t > _quantile(sorted(times), 0.9) for t in times),
                "request_ms_median": 1e3 * statistics.median(times),
                "request_ms_mean": 1e3 * statistics.fmean(times), "window_s": window_s,
                "segmenter_load_ms": loads[0] if loads else None}

    def work(self):
        p = self.ctx.params
        h, w = int(p["content_h"]), int(p["content_w"])
        ch, cw = ref_images.smaller_edge_size(h, w, int(p["content_size"]))
        sh, sw = ref_images.smaller_edge_size(int(p["style_h"]), int(p["style_w"]),
                                              int(p["style_size"]))
        dl = deeplab_work.work(self.ctx.config, h, w)
        return {**dl, "flops": dl["deeplab_flops"]
                + adain_work.stylize_flops(self.adain_cfg, ch, cw)
                + adain_work.encode_flops(self.adain_cfg, sh, sw)}

    def release(self):
        self.fn = None
        self.program._DEEPLAB.clear()

    # --- the comparison ---------------------------------------------------------

    def _reference(self, deeplab_precision, adain_precision):
        """For each content: (P(class 0) of the fp32 reference, the mask the
        pipeline at these precisions uses, its result JPEG as read back)."""
        key = (deeplab_precision, adain_precision)
        if key in self._refs:
            return self._refs[key]
        p, dev = self.ctx.params, self.ctx.device
        sd = {k: v.to(dev) for k, v in self.sd.items()}
        style = ref_images.load_resized(self.style, int(p["style_size"])).to(dev)
        s_mean, s_std = ref_adain.style_stats(self.adain_cfg, self.enc_w, style[None],
                                              adain_precision)
        out = []
        for path in self.contents:
            u8 = ref_images.load_uint8(path)
            img = torch.from_numpy(np.array(u8)).to(dev).float() / 255.0
            prob = ref_deeplab.background_probability(sd, img, deeplab_precision)
            mask = prob > self.ctx.config["threshold"]
            c = ref_images.load_resized(path, int(p["content_size"])).to(dev)
            stylized = ref_local.stylize_masked(self.adain_cfg, self.enc_w, self.dec_w, c,
                                                s_mean, s_std, mask, adain_precision)
            mask_np = mask.cpu().numpy().astype(np.uint8)
            out.append((prob.cpu().numpy(), mask_np,
                        ref_local.result(u8, ref_local.jpeg_round_trip(stylized), mask_np)))
        del sd
        self._refs[key] = out
        return out

    def _compare(self, items):
        """(worst mean abs levels, flips outside the band, the largest
        |P - 0.5| at a flipped pixel) of (content index, mask, result)
        items against the fp32 reference's; inf where one is missing."""
        want = self._reference("fp32", "fp32")
        band = float(self.ctx.params["mask_band"])
        worst, flips, margin = 0.0, 0, 0.0
        for i, mask, res in items:
            prob, ref_mask, ref_res = want[i]
            if mask is None or res is None or mask.shape != ref_mask.shape:
                return float("inf"), float("inf"), float("inf")
            off = np.abs(prob - 0.5)[mask != ref_mask]
            flips += int((off > band).sum())
            margin = max(margin, float(off.max()) if off.size else 0.0)
            worst = max(worst, _levels(res, ref_res))
        return worst, flips, margin

    def _written(self):
        """(content index, mask, result) of each request of the window, read
        back from its files one request at a time (None where a file is
        missing)."""
        for i, out in self.written:
            mask, res = out / MASK, out / RESULT
            yield (i, (ref_images.load_uint8(mask)[..., 0] > 127).astype(np.uint8)
                   if mask.is_file() else None,
                   ref_images.load_uint8(res) if res.is_file() else None)

    def check(self):
        limits = self.ctx.workload["limits"]
        if not self.written:
            return {k: {"value": None, "limit": v} for k, v in limits.items()}
        worst, flips, _margin = self._compare(self._written())
        return {"mean_abs_levels": {"value": worst, "limit": limits["mean_abs_levels"]},
                "mask_flips_outside_band": {"value": flips,
                                            "limit": limits["mask_flips_outside_band"]}}

    def close(self):
        shutil.rmtree(self.ctx.scratch, ignore_errors=True)

    def control(self):
        """The reference at TF32 in the program's place, whole and in DeepLab
        alone, and the largest |P - 0.5| at a flipped pixel of each and of
        the program's written masks (for the band)."""
        low = self.ctx.workload["control"]
        out = {}
        for name, key in (("", (low, low)), ("deeplab_tf32.", (low, "fp32"))):
            ref = self._reference(*key)
            worst, flips, margin = self._compare([(i, m, r) for i, (_p, m, r) in enumerate(ref)])
            out.update({f"{name}mean_abs_levels": worst,
                        f"{name}mask_flips_outside_band": flips,
                        f"{name}flip_margin": margin})
        if self.written:
            out["program.flip_margin"] = self._compare(self._written())[2]
        return out


def build(ctx):
    return RequestLocalized(ctx)
