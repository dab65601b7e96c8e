"""The TV-L1 kernel's decomposition, emulated in plain PyTorch on the CPU
(``kernels.tvl1.tvl1_inner_tiled_reference``), against the plain loop.

The CUDA kernel (``csrc/tvl1.cu``) runs k iterations a launch on tiles with
a k-pixel halo, the edge rules applied by global coordinates, or the whole
frame with k = iters. Every pixel's arithmetic is the plain loop's, so the
emulation must equal ``tvl1_inner_reference`` to the bit (``torch.equal``);
a halo one pixel short must not. Against ``tvl1_inner_pallas(interpret=True)``
the tolerance is tests/test_torch_port_flow.py's, 1e-5 absolute.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aip_tpu.ops.pallas.tvl1 import tvl1_inner_pallas
from aip_tpu_torch.kernels import tvl1 as ktvl1

torch.set_num_threads(2)

LAM, THETA, TAU = 0.15, 0.3, 0.25
CONSTS = (LAM * THETA, THETA, TAU / THETA)


def _inputs(seed, b, h, w, flat=False):
    """The ten [B, H, W] fields of a warp under way, from a numpy seed:
    grad2 = 0 everywhere with ``flat`` (the divided branch everywhere)."""
    g = np.random.default_rng(seed)

    def f(s):
        return (g.standard_normal((b, h, w)) * s).astype(np.float32)

    gx, gy = (f(0.0), f(0.0)) if flat else (f(0.5), f(0.5))
    return [f(0.1), gx, gy, gx * gx + gy * gy, f(0.5), f(0.5)] + [f(0.2) for _ in range(4)]


def _run(fn, a, iters, *extra):
    t = [torch.from_numpy(x) for x in a]
    u1, u2, p = fn(*t[:6], tuple(t[6:]), iters, *CONSTS, *extra)
    return (u1, u2, *p)


@pytest.mark.parametrize("b,h,w,iters,tile,k,flat", [
    (2, 2, 37, 10, 8, 3, False),            # H = 2
    (2, 29, 2, 10, 8, 3, False),            # W = 2
    (2, 37, 45, 13, 16, 4, False),          # iters not a multiple of k
    (2, 37, 45, 12, (10, 12), 3, False),    # tiles that divide neither side
    (1, 20, 20, 7, 8, 10, False),           # k > iters, B = 1
    (2, 16, 16, 0, 8, 4, False),            # iters 0
    (2, 16, 16, 1, 8, 4, False),            # iters 1
    (2, 33, 40, 9, 16, 4, True),            # grad2 = 0 everywhere
    (2, 32, 32, 20, 32, 20, False),         # the whole-frame form: one tile, k = iters
    (1, 100, 100, 20, ktvl1.TILE_SIDE - 2 * 8, 8, False),   # the kernel's tiles at k = 8
    (1, 70, 90, 11, ktvl1.TILE_SIDE - 2 * 4, 4, False),     # and at k = 4
])
def test_tiled_emulation_equals_the_plain_loop(b, h, w, iters, tile, k, flat):
    a = _inputs(h * 1000 + w, b, h, w, flat)
    want = _run(ktvl1.tvl1_inner_reference, a, iters)
    got = _run(ktvl1.tvl1_inner_tiled_reference, a, iters, tile, k)
    for x, y in zip(got, want):
        assert x.shape == y.shape == (b, h, w)
        assert torch.equal(x, y)


@pytest.mark.parametrize("h,w,tile,k,iters", [(100, 100, 48, 8, 20), (37, 45, 10, 4, 12)])
def test_a_halo_one_pixel_short_differs(h, w, tile, k, iters):
    """The same decomposition with a (k - 1)-pixel halo: the tiles' edge
    pixels miss a neighbour's contribution, so the check above can tell."""
    a = _inputs(7, 2, h, w)
    want = _run(ktvl1.tvl1_inner_reference, a, iters)
    got = _run(ktvl1.tvl1_inner_tiled_reference, a, iters, tile, k, k - 1)
    assert not all(torch.equal(x, y) for x, y in zip(got, want))
    assert max(float((x - y).abs().max()) for x, y in zip(got, want)) > 0


def test_tiled_emulation_matches_pallas_interpret():
    """One 32^2 case, tiles of 12 with k = 5 over 17 iterations, against the
    Pallas kernel in interpret mode."""
    a = _inputs(3, 2, 32, 32)
    ju1, ju2, jp = tvl1_inner_pallas(*[jnp.asarray(x) for x in a[:6]],
                                     tuple(jnp.asarray(x) for x in a[6:]), 17, *CONSTS,
                                     interpret=True)
    got = _run(ktvl1.tvl1_inner_tiled_reference, a, 17, 12, 5)
    for x, y in zip(got, (ju1, ju2, *jp)):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-5)


@pytest.mark.parametrize("h,w,iters,k,launches", [
    (32, 32, 300, 0, 1), (64, 64, 300, 0, 1), (256, 256, 300, 4, 75), (128, 128, 300, 8, 38),
    (16, 16, 0, 0, 0)])
def test_form_and_launches(h, w, iters, k, launches):
    """Frames up to FRAME_SIDE run whole (one launch a call); the video
    call's larger levels take the tile form at the k its sweep found
    fastest, ceil(iters / k) launches."""
    assert ktvl1.form(h, w) == k
    assert ktvl1.launches_per_call(h, w, iters) == launches


@pytest.mark.parametrize("h,w", [(65, 64), (64, 65), (3, 200), (1000, 9)])
def test_form_takes_a_built_k_above_the_whole_frame_limit(h, w):
    assert ktvl1.form(h, w) in ktvl1.TILE_KS
