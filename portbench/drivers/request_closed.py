"""One client in a closed loop of ``adain_inference``, the call behind the
CLI and the GUI's AdaIN and Depth pages: image files in, an image file out.

Set-up writes ``contents`` content images (``content_w`` x ``content_h``)
and one style image, all from the seed, as PNGs under the run's scratch
directory in ``TMPDIR``, and the weights as the npz cache under an
``AIP_TPU_WEIGHTS`` there, so that every request loads them from disk as
it would a checkpoint. The decoder's last conv is rescaled per channel so
that content 0's output has mean 0.5 and standard deviation
``output_std``, as a trained decoder's output lies in [0, 1]: without it
the random weights' gain sets how much of the output saturates, and with
it how long the PNG encode takes, seed by seed. Request k stylizes content k mod ``contents`` at
``content_size`` / ``style_size`` and writes a lossless PNG. The check
reads back every PNG the window wrote and compares it with the reference's
8-bit image of the same content (``mean_abs_levels``: the worst request's
mean absolute difference, in 8-bit levels).
"""

from __future__ import annotations

import os
import shutil
import statistics

import numpy as np
import torch

from portbench.drivers import _adain
from portbench.reference import adain as ref
from portbench.reference import images as ref_images
from portbench.roofline import adain as work_mod

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def _png(path, img_nhwc):
    from PIL import Image

    a = (img_nhwc[0].clamp(0, 1) * 255.0 + 0.5).floor().to(torch.uint8).cpu().numpy()
    Image.fromarray(a).save(str(path))


def _write_npz(path, weights, extra_layers):
    """The program's npz cache format: w{i} HWIO, b{i}, in network order;
    ``extra_layers`` (convs the checkpoint holds past the last one used)
    are written as zeros."""
    flat = {}
    for i, (w, b) in enumerate(weights):
        flat[f"w{i}"] = w.permute(2, 3, 1, 0).cpu().numpy()
        flat[f"b{i}"] = b.cpu().numpy()
    for j, (_, cin, cout, k) in enumerate(extra_layers, start=len(weights)):
        flat[f"w{j}"] = np.zeros((k, k, cin, cout), np.float32)
        flat[f"b{j}"] = np.zeros((cout,), np.float32)
    np.savez(str(path), **flat)


class RequestClosed:
    def __init__(self, ctx):
        self.ctx, p, dev = ctx, ctx.params, ctx.device
        self.cfg = ctx.config
        self.dtype = DTYPES[ctx.precision]
        root = ctx.scratch
        shutil.rmtree(root, ignore_errors=True)
        self.inputs, self.out_dir, wdir = root / "in", root / "out", root / "weights"
        for d in (self.inputs, self.out_dir, wdir):
            d.mkdir(parents=True)
        os.environ["AIP_TPU_WEIGHTS"] = str(wdir)
        from aip_tpu_torch.models import weights as weights_mod
        from aip_tpu_torch.pipelines import adain_infer

        if weights_mod.DEFAULT_WEIGHTS_DIR != wdir:
            raise RuntimeError("the program read AIP_TPU_WEIGHTS before the benchmark set it")
        self.fn = adain_infer
        h, w = int(p["content_h"]), int(p["content_w"])
        self.contents = []
        for i in range(int(p["contents"])):
            path = self.inputs / f"content{i}.png"
            _png(path, _adain.images(ctx.seed + 10 + i, 1, h, w, dev))
            self.contents.append(path)
        self.style = self.inputs / "style.png"
        _png(self.style, _adain.images(ctx.seed + 2, 1, int(p["style_h"]), int(p["style_w"]), dev))
        self.enc_w, self.dec_w = _adain.make_weights(self.cfg, ctx.seed, dev)
        self.dec_w = self._fit_output(float(p["output_std"]))
        _write_npz(wdir / "vgg_normalised.npz", self.enc_w,
                   [l for l in self.cfg["encoder_unused"] if l[0] == "conv"])
        _write_npz(wdir / "adain_decoder.npz", self.dec_w, [])
        self.k = 0
        self.written = []     # (content index, path)

    def _fit_output(self, std):
        """The decoder's weights with the last conv rescaled per channel:
        content 0's reference output gets mean 0.5 and standard deviation
        ``std`` in each channel."""
        p, dev = self.ctx.params, self.ctx.device
        style = ref_images.load_resized(self.style, int(p["style_size"])).to(dev)
        c = ref_images.load_resized(self.contents[0], int(p["content_size"])).to(dev)
        s_mean, s_std = ref.style_stats(self.cfg, self.enc_w, style[None])
        w, b = self.dec_w[-1]
        z = ref.stylize(self.cfg, self.enc_w, self.dec_w, c[None], s_mean, s_std,
                        float(p["alpha"]))[0].reshape(-1, 3) - b
        gain = std / z.std(dim=0)
        return self.dec_w[:-1] + [(w * gain[:, None, None, None], 0.5 - z.mean(dim=0) * gain)]

    def _call(self, i, name):
        p = self.ctx.params
        return self.fn.adain_inference(
            str(self.contents[i]), str(self.style), content_size=int(p["content_size"]),
            style_size=int(p["style_size"]), alpha=float(p["alpha"]), save_ext=".png",
            output=str(self.out_dir), file_name=name, compute_dtype=self.dtype,
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
        return {"requests_in_window": len(records),
                "beyond_p90": sum(t > _quantile(sorted(times), 0.9) for t in times),
                "request_ms_median": 1e3 * statistics.median(times),
                "request_ms_mean": 1e3 * statistics.fmean(times), "window_s": window_s}

    def work(self):
        p = self.ctx.params
        ch, cw = ref_images.smaller_edge_size(int(p["content_h"]), int(p["content_w"]),
                                              int(p["content_size"]))
        sh, sw = ref_images.smaller_edge_size(int(p["style_h"]), int(p["style_w"]),
                                              int(p["style_size"]))
        return {"flops": work_mod.stylize_flops(self.cfg, ch, cw)
                + work_mod.encode_flops(self.cfg, sh, sw)}

    def release(self):
        self.fn = None

    def _reference(self, precision):
        p = self.ctx.params
        dev = self.ctx.device
        style = ref_images.load_resized(self.style, int(p["style_size"])).to(dev)
        s_mean, s_std = ref.style_stats(self.cfg, self.enc_w, style[None], precision)
        outs = []
        for path in self.contents:
            c = ref_images.load_resized(path, int(p["content_size"])).to(dev)
            out = ref.stylize(self.cfg, self.enc_w, self.dec_w, c[None], s_mean, s_std,
                              float(p["alpha"]), precision)
            outs.append(ref.to_uint8(out[0]).cpu().numpy())
        return outs

    def check(self):
        want = self._reference("fp32")
        worst = 0.0
        for i, path in self.written:
            got = ref_images.load_uint8(path)
            worst = max(worst, _levels(got, want[i]))
        return {"mean_abs_levels": {"value": worst if self.written else None,
                                    "limit": self.ctx.workload["limits"]["mean_abs_levels"]}}

    def close(self):
        shutil.rmtree(self.ctx.scratch, ignore_errors=True)

    def control(self):
        want = self._reference("fp32")
        low = self._reference(self.ctx.workload["control"])
        return {"mean_abs_levels": max(_levels(a, b) for a, b in zip(low, want))}


def _levels(got: np.ndarray, want: np.ndarray) -> float:
    if got.shape != want.shape:
        return float("inf")
    return float(np.abs(got.astype(np.int16) - want.astype(np.int16)).mean())


def _quantile(sorted_values, q):
    """The q-quantile by linear interpolation between order statistics."""
    x = (len(sorted_values) - 1) * q
    lo = int(x)
    hi = min(lo + 1, len(sorted_values) - 1)
    return sorted_values[lo] + (sorted_values[hi] - sorted_values[lo]) * (x - lo)


def build(ctx):
    return RequestClosed(ctx)
