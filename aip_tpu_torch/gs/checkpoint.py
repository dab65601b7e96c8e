"""Checkpoint/resume for 3DGS training.

Port of ``aip_tpu/gs/checkpoint.py`` (reference ``gaussians.capture()`` /
``restore`` and ``--start_checkpoint``, ``train.py:72-74,302-307``): the
whole trainer state (Gaussian parameters and statistics, colour field,
both Adam states with their counts, RVQ codebooks, the step) is written
with ``torch.save`` as nested dicts of tensors, and read back with
``weights_only=True``. ``train`` also stores the loop's random state (the
view-order generator, the torch generator, the pending view stack), so
that a resumed run continues exactly. The JAX package's orbax format is
not read.
"""

from __future__ import annotations

from pathlib import Path

import torch

from aip_tpu_torch.gs import gaussians as G
from aip_tpu_torch.gs import rvq as rvq_mod
from aip_tpu_torch.gs.colorfield import ColorFieldParams


def _adam_dict(opt) -> dict:
    return {"count": opt.count, "mu": dict(opt.mu), "nu": dict(opt.nu)}


def save_checkpoint(path, trainer, loop: dict | None = None) -> str:
    """Write the TrainerState (and the loop's random state) to ``path``.
    Returns the path."""
    path = Path(path).absolute()
    path.parent.mkdir(parents=True, exist_ok=True)
    cpu = lambda tree: G.tree_map(lambda t: t.detach().cpu(), tree)
    blob = {
        "gstate": cpu(trainer.gstate._asdict()),
        "field": cpu({k: v for k, v in trainer.field._asdict().items() if v is not None}),
        "opt_g": cpu(_adam_dict(trainer.opt_g)),
        "opt_net": cpu(_adam_dict(trainer.opt_net)),
        "rvq_scale": None if trainer.rvq_scale is None else trainer.rvq_scale.codebooks.cpu(),
        "rvq_rot": None if trainer.rvq_rot is None else trainer.rvq_rot.codebooks.cpu(),
        "step": int(trainer.step),
        "loop": loop,
    }
    torch.save(blob, path)
    return str(path)


def load_checkpoint(path, like):
    """Restore a TrainerState; ``like`` (a TrainerState) gives its types
    and device."""
    from aip_tpu_torch.gs.train import AdamState, TrainerState

    blob = torch.load(Path(path).absolute(), weights_only=True)
    dev = like.gstate.xyz.device
    to = lambda tree: G.tree_map(lambda t: t.to(dev) if t.ndim else t, tree)

    def adam(d):
        return AdamState(d["count"], to(d["mu"]), to(d["nu"]))

    field = blob["field"]
    books = lambda b: None if b is None else rvq_mod.RVQState(b.to(dev))
    return TrainerState(
        gstate=G.GaussianState(**to(blob["gstate"])),
        field=ColorFieldParams(**{k: None if field.get(k) is None else field[k].to(dev)
                                  for k in ColorFieldParams._fields}),
        opt_g=adam(blob["opt_g"]), opt_net=adam(blob["opt_net"]),
        rvq_scale=books(blob["rvq_scale"]), rvq_rot=books(blob["rvq_rot"]),
        step=int(blob["step"]))


def load_loop_state(path) -> dict | None:
    """The training loop's random state stored beside the trainer, or None."""
    return torch.load(Path(path).absolute(), weights_only=True).get("loop")
