"""Gaussian parameter state with fixed capacity + active mask.

Port of ``aip_tpu/gs/gaussians.py`` (reference ``scene/gaussian_model.py``).
The Gaussian set lives in capacity-sized arrays with an ``active`` mask, so
a state compares slot by slot with the JAX package's: clone and split write
into free slots in the same order (free slots by index, selected rows by
rank), prune only clears flags. Tensors keep the JAX layouts ([C, 3] means,
[C, 1] logits, [C] mask).

* activations (:54-71): exp scaling, sigmoid opacity, normalised rotation,
  the straight-through mask gate;
* ``create_from_pcd`` (:74): kNN-initialised log scales, identity quats,
  0.1 opacity, mask ones;
* densification (:112-230): ``add_densification_stats`` in NDC units,
  ``densify_and_clone``, ``densify_and_split`` (N=2, scale/1.6, rotated
  normal samples from a host ``torch.Generator`` or from ``samples``);
* ``prune``, ``mask_prune``, ``reset_opacity``, ``reset_stats``;
* capacity buckets (:267-311): ``recompact_order``, ``shrink_tree``,
  ``capacity_bucket``, ``grow_tree`` over any tree of NamedTuples, dicts,
  tuples and tensors (the trainer state and its Adam moments).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from aip_tpu_torch.ops.knn import mean_knn_sq_dist
from aip_tpu_torch.ops.quaternion import build_rotation, inverse_sigmoid
from aip_tpu_torch.ops.sh import rgb_to_sh


class GaussianState(NamedTuple):
    xyz: torch.Tensor        # [C, 3]
    scaling: torch.Tensor    # [C, 3] log-scale
    rotation: torch.Tensor   # [C, 4] unnormalized quaternion
    opacity: torch.Tensor    # [C, 1] logit
    mask: torch.Tensor       # [C, 1] learnable gate logits
    active: torch.Tensor     # [C] bool
    max_radii2d: torch.Tensor    # [C]
    xyz_grad_accum: torch.Tensor  # [C, 1]
    denom: torch.Tensor      # [C, 1]

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def n_active(self) -> torch.Tensor:
        return self.active.sum()

    def to(self, device) -> "GaussianState":
        return GaussianState(*(t.to(device) for t in self))


def get_scaling(state: GaussianState) -> torch.Tensor:
    return torch.exp(state.scaling)


def get_opacity(state: GaussianState) -> torch.Tensor:
    return torch.sigmoid(state.opacity)


def get_rotation(state: GaussianState) -> torch.Tensor:
    return state.rotation / torch.linalg.norm(state.rotation, dim=-1, keepdim=True)


def ste_mask(state: GaussianState) -> torch.Tensor:
    """Straight-through binary gate (renderer :78): hard > 0.01 forward,
    sigmoid gradient backward."""
    s = torch.sigmoid(state.mask)
    hard = (s > 0.01).to(s.dtype)
    return (hard - s).detach() + s


@torch.no_grad()
def create_from_pcd(points, colors, capacity: int, device=None):
    """State from a point cloud; returns (state, sh_dc [C, 3]). ``points``
    and ``colors`` are arrays or tensors; the state lands on ``device``
    (default: the points' device, the CPU for numpy input)."""
    points = torch.as_tensor(points, device=device).to(torch.float32)
    colors = torch.as_tensor(colors, device=points.device).to(torch.float32)
    dev = points.device
    n = points.shape[0]
    if n > capacity:
        points, colors, n = points[:capacity], colors[:capacity], capacity

    dist2 = mean_knn_sq_dist(points, k=3)
    scales = torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3)
    rots = torch.zeros((n, 4), device=dev)
    rots[:, 0] = 1.0
    opac = inverse_sigmoid(0.1 * torch.ones((n, 1), device=dev))

    def pad(x, fill=0.0):
        out = torch.full((capacity,) + tuple(x.shape[1:]), fill, dtype=x.dtype, device=dev)
        out[:n] = x
        return out

    rotation = pad(rots)
    rotation[n:, 0] = 1.0
    state = GaussianState(
        xyz=pad(points), scaling=pad(scales), rotation=rotation,
        opacity=pad(opac, -10.0), mask=pad(torch.ones((n, 1), device=dev)),
        active=torch.arange(capacity, device=dev) < n,
        max_radii2d=torch.zeros(capacity, device=dev),
        xyz_grad_accum=torch.zeros((capacity, 1), device=dev),
        denom=torch.zeros((capacity, 1), device=dev),
    )
    return state, pad(rgb_to_sh(colors))


@torch.no_grad()
def add_densification_stats(state: GaussianState, screenspace_grad: torch.Tensor,
                            radii: torch.Tensor, width: int | None = None,
                            height: int | None = None) -> GaussianState:
    """Accumulate ||dL/d mean2d|| of visible Gaussians (:658-660) and track
    the max screen radius. ``screenspace_grad`` arrives in pixel units;
    with the image dims it is scaled to the NDC units the reference's
    densify_grad_threshold (0.0002) is calibrated against."""
    visible = (radii > 0) & state.active
    g = screenspace_grad[:, :2]
    if width is not None and height is not None:
        g = g * torch.tensor([0.5 * width, 0.5 * height], dtype=g.dtype, device=g.device)
    gnorm = torch.linalg.norm(g, dim=-1, keepdim=True)
    zero = torch.zeros((), device=g.device)
    return state._replace(
        xyz_grad_accum=state.xyz_grad_accum + torch.where(visible[:, None], gnorm, zero),
        denom=state.denom + visible[:, None].to(torch.float32),
        max_radii2d=torch.maximum(state.max_radii2d, torch.where(visible, radii, zero)),
    )


def _append_slots(state: GaussianState, new_vals: dict, want: torch.Tensor):
    """Write ``new_vals`` rows (where ``want``) into free slots, the r-th
    selected row into the r-th free slot; rows past the free count are
    dropped. Returns (state, dest [C]) with dest = C for rows not written."""
    c = state.capacity
    dev = state.xyz.device
    slot_order = torch.sort(state.active.to(torch.int8), stable=True).indices  # free first
    want_rank = torch.cumsum(want.to(torch.int64), 0) - 1
    n_free = (~state.active).sum()
    dest = slot_order[torch.clamp(want_rank, 0, c - 1)]
    dest = torch.where(want & (want_rank < n_free), dest, torch.full_like(dest, c))
    keep = dest < c
    rows = dest[keep]

    def scatter(target, values):
        out = target.clone()
        out[rows] = values[keep].to(out.dtype)
        return out

    new_active = state.active.clone()
    new_active[rows] = True
    updated = {k: scatter(getattr(state, k), v) for k, v in new_vals.items()}
    zeros1 = torch.zeros((c, 1), device=dev)
    return state._replace(active=new_active, max_radii2d=torch.zeros(c, device=dev),
                          xyz_grad_accum=zeros1, denom=zeros1.clone(), **updated), dest


def avg_densify_grads(state: GaussianState) -> torch.Tensor:
    """Per-Gaussian mean accumulated screen-space grad norm [C, 1]. Taken
    once per densification event, before the appends reset the
    accumulators (gaussian_model.py:560-566)."""
    return torch.nan_to_num(state.xyz_grad_accum / torch.clamp(state.denom, min=1.0))


@torch.no_grad()
def densify_and_clone(state: GaussianState, grad_threshold: float, percent_dense: float,
                      scene_extent: float, grads: torch.Tensor | None = None):
    """:545-558. Returns (state, appended_slot_mask [C])."""
    if grads is None:
        grads = avg_densify_grads(state)
    sel = ((grads[:, 0] >= grad_threshold)
           & (torch.amax(get_scaling(state), dim=1) <= percent_dense * scene_extent)
           & state.active)
    new_state, dest = _append_slots(
        state, {"xyz": state.xyz, "scaling": state.scaling, "rotation": state.rotation,
                "opacity": state.opacity, "mask": state.mask}, sel)
    slot_mask = torch.zeros(state.capacity, dtype=torch.bool, device=state.xyz.device)
    slot_mask[dest[dest < state.capacity]] = True
    return new_state, slot_mask


@torch.no_grad()
def densify_and_split(state: GaussianState, grad_threshold: float, percent_dense: float,
                      scene_extent: float, n_split: int = 2, grads: torch.Tensor | None = None,
                      generator: torch.Generator | None = None, samples=None):
    """:520-543. Each selected Gaussian becomes ``n_split`` samples at
    scale / (0.8 n_split); the original is pruned. The i-th split's offsets
    are ``samples[i]`` ([C, 3] standard normals) when given, else drawn
    from ``generator``. Returns (state, appended_slot_mask)."""
    if grads is None:
        grads = avg_densify_grads(state)
    c = state.capacity
    dev = state.xyz.device
    scaling = get_scaling(state)
    sel = ((grads[:, 0] >= grad_threshold)
           & (torch.amax(scaling, dim=1) > percent_dense * scene_extent)
           & state.active)
    appended = torch.zeros(c, dtype=torch.bool, device=dev)
    for i in range(n_split):
        if samples is not None:
            noise = torch.as_tensor(samples[i], dtype=torch.float32, device=dev)
        else:
            noise = torch.randn((c, 3), generator=generator).to(dev)
        offset = torch.einsum("nij,nj->ni", build_rotation(state.rotation), noise * scaling)
        new_vals = {"xyz": state.xyz + offset, "scaling": torch.log(scaling / (0.8 * n_split)),
                    "rotation": state.rotation, "opacity": state.opacity, "mask": state.mask}
        state, dest = _append_slots(state, new_vals, sel)
        appended[dest[dest < c]] = True
    return state._replace(active=state.active & ~sel), appended


@torch.no_grad()
def prune(state: GaussianState, min_opacity: float, extent: float,
          max_screen_size: float) -> GaussianState:
    """:560-573 prune clause: mask gate off, low opacity, or too big."""
    p = ((torch.sigmoid(state.mask[:, 0]) <= 0.01)
         | (get_opacity(state)[:, 0] < min_opacity))
    if max_screen_size > 0:
        p = p | (state.max_radii2d > max_screen_size)
        p = p | (torch.amax(get_scaling(state), dim=1) > 0.1 * extent)
    return state._replace(active=state.active & ~p)


@torch.no_grad()
def mask_prune(state: GaussianState) -> GaussianState:
    """:575-578."""
    return state._replace(active=state.active & ~(torch.sigmoid(state.mask[:, 0]) <= 0.01))


@torch.no_grad()
def reset_opacity(state: GaussianState) -> GaussianState:
    """3DGS opacity reset: clamp to at most 0.01 (:434-438)."""
    cap = inverse_sigmoid(torch.tensor(0.01, device=state.opacity.device))
    return state._replace(opacity=torch.minimum(state.opacity, cap))


def reset_stats(state: GaussianState) -> GaussianState:
    c = state.capacity
    dev = state.xyz.device
    return state._replace(max_radii2d=torch.zeros(c, device=dev),
                          xyz_grad_accum=torch.zeros((c, 1), device=dev),
                          denom=torch.zeros((c, 1), device=dev))


def recompact_order(state: GaussianState) -> torch.Tensor:
    """Stable permutation that packs active slots to the front."""
    return torch.sort((~state.active).to(torch.int8), stable=True).indices


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor leaf of NamedTuples, dicts, tuples and
    lists; None and other leaves pass through."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, t) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return tree


def shrink_tree(tree, order: torch.Tensor, new_capacity: int):
    """Permute-and-slice every [C, ...] leaf to ``new_capacity`` rows (other
    leaves, e.g. step counts, pass through). Apply the same order to the
    trainer state and its Adam moments so slots stay aligned."""
    c = order.shape[0]
    return tree_map(lambda t: t[order][:new_capacity] if t.ndim >= 1 and t.shape[0] == c
                    else t, tree)


def capacity_bucket(n_active: int, floor: int = 8192, headroom: int = 2) -> int:
    """Power-of-2 capacity for ``n_active`` splats with densification
    headroom, at least ``floor``."""
    need = max(int(n_active) * headroom, floor)
    return 1 << (need - 1).bit_length()


def grow_tree(tree, old_capacity: int, new_capacity: int):
    """Zero-pad every [C, ...] leaf to ``new_capacity`` rows (the inverse of
    shrink_tree: padded slots are inactive, their Adam moments zero)."""
    def fix(t):
        if t.ndim >= 1 and t.shape[0] == old_capacity:
            pad = torch.zeros((new_capacity - old_capacity,) + tuple(t.shape[1:]),
                              dtype=t.dtype, device=t.device)
            return torch.cat([t, pad])
        return t

    return tree_map(fix, tree)
