"""Meshes, shardings and the sharded steps (port of ``aip_tpu.parallel``).

A mesh is a single-process grid of ``torch.device``s (``mesh``); the
collectives XLA inserts are tensor moves in a fixed shard order
(``sharding``). On it: batched AdaIN inference over ``dp`` (``infer``),
the AdaIN decoder's data- and tensor-parallel train step (``train``), and
3DGS training with the view batch or the Gaussians sharded and rendering
with the Gaussians sharded (``gs``). Devices may repeat: a mesh of
``[cuda:0, cuda:0]`` runs every sharded path on one card, a mesh of ``cpu``
devices on the CPU.
"""

from aip_tpu_torch.parallel.mesh import make_mesh, best_grid
from aip_tpu_torch.parallel.sharding import (
    conv_param_sharding,
    batch_sharding,
    replicated,
)
