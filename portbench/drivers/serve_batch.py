"""Batch serving: a closed loop of ``stylize_with_stats`` on batches of
content images, against one style whose statistics are cached in set-up.

Traffic parameters: ``batch``, ``size`` (square images), ``batches`` (how
many distinct batches the seed makes; the loop cycles them), ``alpha``,
``keep`` (batches sampled from the window for the check),
``trace_units``. The check compares the kept batches with the reference's
fp32 output: each image's relative RMS error, over the relative RMS error
of the reference computed with each conv's input and weight rounded to
bf16, worst image (``err_vs_bf16``). The random weights leave some relu4_1
channels with a tiny spread that AdaIN scales up, so how much any rounding
shows in the output swings from seed to seed; the ratio takes that out.
"""

from __future__ import annotations

import random
import statistics

import torch

from portbench.drivers import _adain
from portbench.reference import adain as ref
from portbench.roofline import adain as work_mod
from portbench.roofline import peaks

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


class ServeBatch:
    def __init__(self, ctx):
        from aip_tpu_torch.models.decoder import AdaINDecoder
        from aip_tpu_torch.models.vgg import VGGEncoder
        from aip_tpu_torch.pipelines import adain_infer

        self.ctx, p, dev = ctx, ctx.params, ctx.device
        self.cfg = ctx.config
        self.batch, self.size = int(p["batch"]), int(p["size"])
        self.alpha = float(p["alpha"])
        self.dtype = DTYPES[ctx.precision]
        self.enc_w, self.dec_w = _adain.make_weights(self.cfg, ctx.seed, dev)
        self.vgg, self.dec = VGGEncoder(dev), AdaINDecoder(dev)
        _adain.fill(self.vgg, self.enc_w)
        _adain.fill(self.dec, self.dec_w)
        self.contents = _adain.images(ctx.seed + 1, int(p["batches"]) * self.batch,
                                      self.size, self.size, dev)
        self.contents = self.contents.view(int(p["batches"]), self.batch, self.size, self.size, 3)
        self.style = _adain.images(ctx.seed + 2, 1, self.size, self.size, dev)
        self.fn = adain_infer
        self.k = 0
        self.rng = random.Random(ctx.seed)
        self.keep = int(p["keep"])
        self.kept = []        # reservoir of (batch index, output)

    def warm(self):
        self.mean, self.std = self.fn.precompute_style_stats(
            self.vgg, self.style, compute_dtype=self.dtype, device=self.ctx.device)
        self._call(0)

    def _call(self, i):
        return self.fn.stylize_with_stats(self.vgg, self.dec, self.contents[i], self.mean,
                                          self.std, alpha=self.alpha, compute_dtype=self.dtype,
                                          device=self.ctx.device)

    def unit(self):
        i = self.k % self.contents.shape[0]
        out = self._call(i)
        if len(self.kept) < self.keep:
            self.kept.append((i, out))
        else:
            j = self.rng.randrange(self.k + 1)
            if j < self.keep:
                self.kept[j] = (i, out)
        self.k += 1
        return {"images": self.batch}

    def end_to_end(self, records, window_s):
        return {"images_per_s": sum(r["images"] for r in records) / window_s}

    def notes(self, records, window_s):
        return {"batches_in_window": len(records),
                "images_in_window": sum(r["images"] for r in records),
                "batch_ms_median": 1e3 * statistics.median(r["s"] for r in records),
                "window_s": window_s}

    def work(self):
        b, s = self.batch, self.size
        it = torch.finfo(self.dtype).bits // 8
        peak = peaks.BY_NAME[self.ctx.precision]
        head = work_mod.head_work(b, s, s, it)
        tail = work_mod.tail_work(b, s // 2, s // 2, it)
        return {"flops": work_mod.stylize_flops(self.cfg, s, s, b),
                "encode_head_bound_s": peaks.bound_s(*head, peak),
                "decode_tail_bound_s": peaks.bound_s(*tail, peak)}

    def release(self):
        self.vgg = self.dec = self.fn = None

    def _reference(self, i, precision):
        s_mean, s_std = ref.style_stats(self.cfg, self.enc_w, self.style, "fp32")
        return ref.stylize(self.cfg, self.enc_w, self.dec_w, self.contents[i], s_mean, s_std,
                           self.alpha, precision)

    def _ratio(self, outs):
        """The worst image's error against the fp32 reference, in units of
        the error a plain bf16 computation of the same image makes."""
        worst = 0.0
        for (i, _), out in zip(self.kept, outs):
            want = self._reference(i, "fp32")
            unit = _adain.rel_rms_per_image(self._reference(i, "bf16"), want)
            worst = max(worst, float((_adain.rel_rms_per_image(out, want) / unit).max()))
        return worst

    def check(self):
        value = self._ratio([out for _, out in self.kept])
        return {"err_vs_bf16": {"value": value,
                                "limit": self.ctx.workload["limits"]["err_vs_bf16"]}}

    def control(self):
        low = [self._reference(i, self.ctx.workload["control"]) for i, _ in self.kept]
        return {"err_vs_bf16": self._ratio(low)}


def build(ctx):
    return ServeBatch(ctx)
