"""Multi-device 3DGS: view-batch data parallelism, Gaussian-sharded colour
field and Gaussian-sharded rendering. Port of ``aip_tpu.parallel.gs``.

On the port's single-process meshes (``parallel.mesh``):

* ``replicate_trainer`` puts the trainer on the mesh's home device; a
  sharded step copies what each device needs with ``.to()``, and autograd
  through those copies sums the gradients of the per-device copies (the
  psum XLA inserts);
* ``shard_view_batch`` splits a stacked view batch over ``dp``: the train
  step renders each shard's views on its device
  (``gs.train.make_train_step``);
* ``predict_sh_sharded`` splits the Gaussians over ``dp`` for the colour
  field: each device encodes and runs the MLP on N/dp rows with its own
  copy of the field (kernel C in its backward on a card), and the SH are
  concatenated on the home device;
* ``rasterize_sharded`` renders with the Gaussians split over ``dp``: each
  shard projects and macro-bins its own Gaussians and gathers its
  candidates' packed rows; the all-to-all hands each device one strip of
  macro blocks with every shard's candidates for them, concatenated in
  shard order; a stable sort of their depths merges them; the windowed
  compositor (kernel 4 on a card) composites the strip at its ``block0``;
  the strips are concatenated into the image.
"""

from __future__ import annotations

import math

import torch

from aip_tpu_torch.gs import gaussians as G
from aip_tpu_torch.parallel.sharding import Sharded, gather, split


def replicate_trainer(mesh, trainer):
    """Every trainer tensor of one or more dimensions on the mesh's home
    device (host-side scalars, e.g. Adam counts, stay where they are)."""
    home = mesh.home
    return G.tree_map(lambda x: x.to(home) if x.ndim >= 1 else x, trainer)


def shard_view_batch(mesh, cams, axis: str = "dp") -> Sharded:
    """A stacked ``CameraArrays`` batch (``gs.train.stack_cameras``) split
    over ``axis``: part i holds views [i B/dp, (i + 1) B/dp) on the axis's
    device i. B % dp must be 0."""
    devices = mesh.axis_devices(axis)
    fields = {}
    for name, value in cams._asdict().items():
        fields[name] = (split(value, devices).parts if isinstance(value, torch.Tensor)
                        and value.ndim >= 1 else (value,) * len(devices))
    parts = tuple(type(cams)(**{k: v[i] for k, v in fields.items()})
                  for i in range(len(devices)))
    return Sharded(parts, tuple(devices))


def replicated_scalars(mesh, *arrays):
    out = tuple(torch.as_tensor(a).to(mesh.home) for a in arrays)
    return out if len(out) > 1 else out[0]


def predict_sh_sharded(mesh, field, xyz: torch.Tensor, style_f: torch.Tensor | None = None,
                       axis: str = "dp") -> torch.Tensor:
    """Gaussian-sharded colour field: [N, 16, 3] SH on ``xyz``'s device,
    equal to ``predict_sh(field, xyz, style_f)``. Shard i encodes rows
    [i N/dp, (i + 1) N/dp) on the axis's device i with its own copy of the
    field; gradients reach ``field`` and ``style_f`` through the copies.
    N % dp must be 0."""
    from aip_tpu_torch.gs.colorfield import predict_sh

    devices = mesh.axis_devices(axis)
    if xyz.shape[0] % len(devices):
        raise ValueError(f"{xyz.shape[0]} Gaussians do not split over the {len(devices)} "
                         f"devices of mesh axis {axis!r}")
    outs = []
    for rows, dev in zip(split(xyz, devices).parts, devices):
        f = type(field)(*(None if v is None else v.to(dev) for v in field))
        outs.append(predict_sh(f, rows, None if style_f is None else style_f.to(dev)))
    return gather(outs, xyz.device)


def shard_gaussian_arrays(mesh, *arrays, axis: str = "dp"):
    """Per-Gaussian arrays split over ``axis`` (pad N to a dp multiple
    first: inactive slots render as opacity 0). Returns ``Sharded`` values."""
    devices = mesh.axis_devices(axis)
    out = tuple(split(torch.as_tensor(a), devices) for a in arrays)
    return out if len(out) > 1 else out[0]


def rasterize_sharded(mesh, means3d, scales, rotations, opacities, colors, viewmatrix,
                      projmatrix, bg_color, settings, tanfovx=1.0, tanfovy=1.0,
                      axis: str = "dp"):
    """Inference rasterization with the Gaussians split over ``axis``.
    Exact: each shard keeps ``settings.macro_capacity`` candidates a block,
    so the merged list of a block holds dp x Kc, a superset of the
    replicated path's Kc. Per-Gaussian inputs are ``Sharded`` (from
    ``shard_gaussian_arrays``) or tensors (split here); N % dp == 0.
    Returns (image [H, W, 3], radii [N]) on the mesh's home device."""
    from aip_tpu_torch.gs.rasterizer import (TILE, _tile_grid, cull_radii, pack_raw_table,
                                             project_gaussians, select_macro_pairsort)
    from aip_tpu_torch.kernels import composite as K

    if settings.macro <= 1:
        raise ValueError("rasterize_sharded needs hierarchical settings (macro > 1)")
    devices = mesh.axis_devices(axis)
    dp = len(devices)
    g = [x.parts if isinstance(x, Sharded) else split(x, devices).parts
         for x in (means3d, scales, rotations, opacities, colors)]
    th, tw = _tile_grid(settings)
    m = settings.macro
    mth, mtw = math.ceil(th / m), math.ceil(tw / m)
    bs = m * TILE
    n_blocks = mth * mtw
    per = -(-n_blocks // dp)          # blocks a strip
    pad = per * dp - n_blocks
    home = mesh.home

    raws, deps, radii = [], [], []
    for (xyz, sc, rot, op, col), dev in zip(zip(*g), devices):
        vm = torch.as_tensor(viewmatrix, dtype=torch.float32).to(dev)
        pm = torch.as_tensor(projmatrix, dtype=torch.float32).to(dev)
        mean2d, depths, conics, rad, valid = project_gaussians(
            xyz, sc, rot, vm, pm, tanfovx, tanfovy, settings)
        op = op.to(torch.float32)
        idx, _ = select_macro_pairsort(mean2d, depths, cull_radii(rad, op, settings), valid,
                                       mth, mtw, settings)                    # [M, Kc] local
        safe = torch.clamp(idx, min=0).long()
        raw = pack_raw_table(mean2d, conics, op, col)[safe]                  # [M, Kc, 16]
        dep = torch.where(idx >= 0, depths[safe], torch.full_like(depths[safe], math.inf))
        if pad:
            raw = torch.cat([raw, raw.new_zeros((pad,) + raw.shape[1:])])
            dep = torch.cat([dep, dep.new_full((pad, dep.shape[1]), math.inf)])
        raws.append(raw)
        deps.append(dep)
        radii.append(rad)

    bg = torch.as_tensor(bg_color, dtype=torch.float32)
    strips = []
    for j, dev in enumerate(devices):
        # All-to-all: strip j of every shard, concatenated in shard order.
        rows = slice(j * per, (j + 1) * per)
        raw = torch.cat([r[rows].to(dev) for r in raws], dim=1)             # [per, dp Kc, 16]
        dep = torch.cat([d[rows].to(dev) for d in deps], dim=1)
        order = torch.sort(dep, dim=1, stable=True).indices                  # front to back
        raw = torch.take_along_dim(raw, order[..., None], dim=1).contiguous()
        counts = torch.isfinite(dep).sum(dim=1).to(torch.int32)
        planes = K.composite_macro_mxu(raw, counts, bg.to(dev), bs=bs, mtw=mtw,
                                       block0=j * per)                       # [per, 3, 1, P]
        strips.append(planes[:, :, 0, :].permute(0, 2, 1))
    blocks = gather(strips, home)[:n_blocks]
    img = blocks.reshape(mth, mtw, bs, bs, 3).permute(0, 2, 1, 3, 4)
    img = img.reshape(mth * bs, mtw * bs, 3)
    return img[: settings.image_height, : settings.image_width], gather(radii, home)
