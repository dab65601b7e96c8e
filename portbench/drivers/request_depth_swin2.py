"""One client in a closed loop of the depth-aware ``adain_inference`` with
DPT-SwinV2-L-384, the call behind ``run_depth --use_depth --depth_model
dpt_swin2_large_384``: the traffic of ``request_depth`` (whose driver this
one extends), with only the network and its checkpoint changed, so that
the two cells differ in the encoder alone.

Set-up is ``request_depth``'s, except that the seeded checkpoint is
``drivers/_dpt_swin2.py``'s (calibrated on ``calibration_images`` seeded
images of the contents' size, squeezed to ``net_size`` square as the hub's
``swin384_transform`` does), written as a hub-layout ``.pt`` and read by
the program through ``depth_weights``. The check is ``request_depth``'s
(``mean_abs_levels`` on the stylized PNGs, ``depth_levels`` on the 16-bit
depth PNGs) against the plain reference's pipeline with
``reference/dpt_swin2.py`` as its depth network.

A program whose ``DEPTH_MODELS`` lacks the network stops at once with a
``SystemExit`` that says so.
"""

from __future__ import annotations

import os
import shutil

import torch

from portbench.drivers import _adain, _dpt_swin2
from portbench.drivers.request_closed import _png, _write_npz
from portbench.drivers.request_depth import RequestDepth
from portbench.drivers.request_localized import _stylizer_config
from portbench.reference import adain as ref_adain
from portbench.reference import depth as ref_depth
from portbench.reference import dpt_swin2 as ref_swin2
from portbench.reference import images as ref_images
from portbench.roofline import adain as adain_work
from portbench.roofline import dpt_swin2 as swin2_work

MODEL = "dpt_swin2_large_384"


class RequestDepthSwin2(RequestDepth):
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

        if MODEL not in getattr(adain_infer, "DEPTH_MODELS", ()):
            raise SystemExit(f"adain_inference's DEPTH_MODELS lacks {MODEL!r}: this program "
                             "cannot run DPT-SwinV2-L-384 on the depth-aware path")
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
        sd = _dpt_swin2.seeded_state_dict(ctx.config, ctx.seed, calibration,
                                          float(p["pass_share"]))
        del calibration
        self.sd = {k: v.cpu() for k, v in sd.items()}
        del sd
        self.ckpt = root / f"{MODEL}.pt"
        torch.save(self.sd, str(self.ckpt))
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        self.k = 0
        self.written = []     # (content index, image path)
        self._refs = {}

    def _call(self, i, name):
        p = self.ctx.params
        return self.fn(
            str(self.contents[i]), str(self.style), content_size=int(p["content_size"]),
            style_size=int(p["style_size"]), depth_offset=float(p["depth_offset"]),
            depth_prominence=float(p["depth_prominence"]), save_ext=".png",
            output=str(self.out_dir), file_name=name, use_depth=True, depth_model=MODEL,
            depth_weights=str(self.ckpt), save_depth=True, compute_dtype=torch.float32,
            device=self.ctx.device)

    def work(self):
        p, cfg = self.ctx.params, self.ctx.config
        h, w = int(p["content_h"]), int(p["content_w"])
        ch, cw = ref_images.smaller_edge_size(h, w, int(p["content_size"]))
        sh, sw = ref_images.smaller_edge_size(int(p["style_h"]), int(p["style_w"]),
                                              int(p["style_size"]))
        dw = swin2_work.work(cfg)
        return {**dw, "flops": dw["dpt_swin2_flops"]
                + adain_work.stylize_flops(self.adain_cfg, ch, cw)
                + adain_work.encode_flops(self.adain_cfg, sh, sw)}

    def _reference(self, dpt_precision, adain_precision):
        """``RequestDepth._reference`` with the SwinV2 network: for each
        content the normalised proximity, the 8-bit stylized image and the
        share of the proximity's pixels above 0."""
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
            prox = ref_swin2.proximity(sd, img, cfg, dpt_precision)
            c = ref_images.load_resized(path, int(p["content_size"])).to(dev)
            stylized = ref_depth.stylize_depth(
                self.adain_cfg, self.enc_w, self.dec_w, c, s_mean, s_std, prox,
                float(p["depth_offset"]), float(p["depth_prominence"]), adain_precision)
            out.append((ref_depth.normalised(prox), ref_adain.to_uint8(stylized).cpu().numpy(),
                        float((prox > 0).float().mean())))
        del sd
        self._refs[key] = out
        return out


def build(ctx):
    return RequestDepthSwin2(ctx)
