"""Batched, mesh-sharded AdaIN inference. Port of ``aip_tpu.parallel.infer``.

The reference stylizes one image at a time (``AdaIN/test.py:153-247``); here
a batch (frames of a video, views of a scene, a directory of images) is
split over the mesh's ``dp`` devices and each shard runs ``stylize_simple``
on its device, with the encoder's head and the decoder's tail as the AdaIN
kernels on a card (bf16 by default, the fp32 kernels at ``torch.float32``).
"""

from __future__ import annotations

import torch

from aip_tpu_torch.parallel.sharding import Sharded, gather, replicate_module, split


def compile_batch_stylize(mesh, alpha: float = 0.5, compute_dtype=torch.bfloat16):
    """Returns fn(vgg_params, dec_params, content[B], style[B]) -> [B] on
    the mesh's home device: the batch split over ``dp`` (B % dp == 0), the
    parameters copied once to each dp device."""
    from aip_tpu_torch.pipelines.adain_infer import stylize_simple

    devices = mesh.axis_devices("dp")
    copies = {}

    def fn(vgg_params, dec_params, content, style):
        key = (id(vgg_params), id(dec_params))
        if copies.get("key") != key:
            copies.update(key=key, vgg=replicate_module(vgg_params, devices),
                          dec=replicate_module(dec_params, devices))
        parts = [x.parts if isinstance(x, Sharded) else split(x, devices).parts
                 for x in (content, style)]
        outs = [stylize_simple(v, d, c, s, alpha=alpha, compute_dtype=compute_dtype, device=dev)
                for v, d, c, s, dev in zip(copies["vgg"], copies["dec"], *parts, devices)]
        return gather(outs, mesh.home)

    return fn
