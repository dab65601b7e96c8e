"""aip_tpu_torch.ops.flow / ops.farneback / kernels.tvl1 (plain version)
against aip_tpu's on the CPU.

The same numpy-seeded inputs go through JAX on the CPU and through the port
with CPU tensors (the plain PyTorch versions; the CUDA kernel is held
against them in tests/test_torch_port_cuda.py). Tolerances, each measured
well inside:

* elementwise ops, samplers and stencils: 1e-6 absolute (the same float32
  operations in the same order);
* the TV-L1 inner loop against ``tvl1_inner_pallas(interpret=True)``,
  20 iterations: 1e-5 absolute, as tests/test_flow_ops.py holds the Pallas
  kernel against the XLA loop;
* whole estimators on 32^2 pairs: TV-L1 (4 levels x 5 warps x 300
  iterations) mean abs <= 1e-4 px and max <= 1e-2 px (measured 3e-7 and
  1.2e-6: XLA and PyTorch round the pyramid's convolutions alike, and the
  loop's thresholds then take the same branches); Farneback the same
  bounds (measured 4e-7 / 3e-6); Lucas-Kanade mean <= 1e-3 px and max <=
  2e-2 px (measured 2.1e-4 / 5.2e-3: XLA's and oneDNN's convolutions add
  its 9x9 box sums in another order, 5e-7 relative, and the 2x2 solve
  with its small determinant, over six refinements a level, amplifies
  that).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from scipy.ndimage import gaussian_filter, map_coordinates

from aip_tpu.ops import farneback as jfb
from aip_tpu.ops import flow as jflow
from aip_tpu.ops.pallas.tvl1 import tvl1_inner_pallas
from aip_tpu_torch.kernels import tvl1 as ktvl1
from aip_tpu_torch.ops import farneback as tfb
from aip_tpu_torch.ops import flow as tflow

torch.set_num_threads(2)

LAM, THETA, TAU = 0.15, 0.3, 0.25


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _shifted_pair(rng, dx, dy, size=32):
    """A smooth texture and its integer translation (test_flow_ops.py)."""
    base = gaussian_filter(rng.random((size + 16, size + 16, 3)).astype(np.float32), (3, 3, 0))
    return (base[8:8 + size, 8:8 + size],
            base[8 - dy:8 - dy + size, 8 - dx:8 - dx + size])


def test_rgb_to_gray_and_blend_match_jax(rng):
    img = rng.random((2, 7, 9, 3)).astype(np.float32)
    np.testing.assert_allclose(tflow.rgb_to_gray(_t(img)).numpy(),
                               np.asarray(jflow.rgb_to_gray(jnp.asarray(img))), atol=1e-6)
    a, b = rng.random((2, 8, 8, 3)).astype(np.float32)
    np.testing.assert_allclose(tflow.blend_images(_t(a), _t(b), 0.7).numpy(),
                               np.asarray(jflow.blend_images(jnp.asarray(a), jnp.asarray(b), 0.7)),
                               atol=1e-6)


@pytest.mark.parametrize("channels", [None, 3])
def test_bilinear_sample_matches_jax_beyond_both_edges(rng, channels):
    """Coordinates from -2.5 H to 3.5 H: several reflections on both sides."""
    b, h, w = 2, 11, 14
    img = rng.random((b, h, w) + (() if channels is None else (channels,))).astype(np.float32)
    ys = ((rng.random((b, 9, 10)) * 6 - 2.5) * h).astype(np.float32)
    xs = ((rng.random((b, 9, 10)) * 6 - 2.5) * w).astype(np.float32)
    out = tflow.bilinear_sample(_t(img), _t(ys), _t(xs)).numpy()
    ref = np.stack([np.asarray(jflow.bilinear_sample(jnp.asarray(img[i]), jnp.asarray(ys[i]),
                                                     jnp.asarray(xs[i]))) for i in range(b)])
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-6)


def test_bilinear_sample_patch_equals_bilinear_sample_on_the_jax_side(rng):
    """Backs the port's choice of one bilinear_sample for the stacked TV-L1
    fields where aip_tpu uses its TPU patch gather."""
    fields = rng.standard_normal((19, 23, 3)).astype(np.float32)
    ys = (rng.random((19, 23)) * 40 - 10).astype(np.float32)
    xs = (rng.random((19, 23)) * 46 - 12).astype(np.float32)
    args = (jnp.asarray(fields), jnp.asarray(ys), jnp.asarray(xs))
    np.testing.assert_allclose(np.asarray(jflow.bilinear_sample_patch(*args)),
                               np.asarray(jflow.bilinear_sample(*args)), atol=1e-6)


def test_warp_image_matches_jax(rng):
    img = rng.random((3, 16, 20, 3)).astype(np.float32)
    flow = (rng.standard_normal((3, 16, 20, 2)) * 3).astype(np.float32)
    out = tflow.warp_image(_t(img), _t(flow)).numpy()
    ref = np.stack([np.asarray(jflow.warp_image(jnp.asarray(img[i]), jnp.asarray(flow[i])))
                    for i in range(3)])
    np.testing.assert_allclose(out, ref, atol=1e-6)


@pytest.mark.parametrize("hw", [(32, 32), (19, 23), (2, 5)])
def test_grad_fwd_and_div_match_jax(rng, hw):
    x, y = rng.standard_normal((2,) + hw).astype(np.float32)
    gx, gy = tflow._grad_fwd(_t(x)[None])
    jgx, jgy = jflow._grad_fwd(jnp.asarray(x))
    np.testing.assert_allclose(gx[0].numpy(), np.asarray(jgx), atol=1e-6)
    np.testing.assert_allclose(gy[0].numpy(), np.asarray(jgy), atol=1e-6)
    np.testing.assert_allclose(tflow._div(_t(x)[None], _t(y)[None])[0].numpy(),
                               np.asarray(jflow._div(jnp.asarray(x), jnp.asarray(y))), atol=1e-6)


def _inner_inputs(rng, b, h, w):
    f = lambda s: (rng.standard_normal((b, h, w)) * s).astype(np.float32)  # noqa: E731
    rho_c, i1wx, i1wy = f(0.1), f(0.5), f(0.5)
    return [rho_c, i1wx, i1wy, i1wx * i1wx + i1wy * i1wy, f(0.3), f(0.3)] + [f(0.1)
                                                                               for _ in range(4)]


@pytest.mark.parametrize("hw", [(32, 32), (19, 23)])
def test_tvl1_inner_reference_matches_pallas_interpret(rng, hw):
    a = _inner_inputs(rng, 2, *hw)
    consts = (20, LAM * THETA, THETA, TAU / THETA)
    ju1, ju2, jp = tvl1_inner_pallas(*[jnp.asarray(x) for x in a[:6]],
                                     tuple(jnp.asarray(x) for x in a[6:]), *consts,
                                     interpret=True)
    ktvl1.reset_launch_counts()
    tu1, tu2, tp = ktvl1.tvl1_inner(*[_t(x) for x in a[:6]], tuple(_t(x) for x in a[6:]), *consts)
    assert ktvl1.launch_counts() == {"tvl1": 0}        # a CPU tensor: the plain version
    for got, want in zip((tu1, tu2, *tp), (ju1, ju2, *jp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_tvl1_level_matches_jax(rng):
    """One pyramid level (3 warps x 40 iterations), as tests/test_flow_ops.py
    holds aip_tpu's against its numpy oracle."""
    base = gaussian_filter(rng.random((36, 30)), 2)
    base = (base - base.min()) / (base.max() - base.min())
    i0 = base[2:-2, 2:-2].astype(np.float32)
    i1 = np.roll(base, (1, -1), axis=(0, 1))[2:-2, 2:-2].astype(np.float32)
    want = np.asarray(jflow._tvl1_level(jnp.asarray(i0), jnp.asarray(i1),
                                        jnp.zeros((*i0.shape, 2), jnp.float32), 3, 40,
                                        LAM, THETA, TAU))
    got = tflow._tvl1_level(_t(i0)[None], _t(i1)[None], torch.zeros(1, *i0.shape, 2), 3, 40,
                            LAM, THETA, TAU)[0].numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def _flow_close(got, want, mean_tol, max_tol):
    err = np.abs(np.asarray(got) - np.asarray(want))
    assert got.shape == want.shape
    assert err.mean() <= mean_tol and err.max() <= max_tol, (err.mean(), err.max())


@pytest.mark.parametrize("method,mean_tol,max_tol", [("tvl1", 1e-4, 1e-2),
                                                     ("farneback", 1e-4, 1e-2),
                                                     ("lk", 1e-3, 2e-2)])
def test_estimators_match_jax(rng, method, mean_tol, max_tol):
    f1, f2 = _shifted_pair(rng, 2, 1)
    want = np.asarray(jflow.estimate_flow_method(jnp.asarray(f1), jnp.asarray(f2),
                                                 method=method))
    got = tflow.estimate_flow_method(_t(f1), _t(f2), method=method).numpy()
    _flow_close(got, want, mean_tol, max_tol)


def test_dispatch_names_and_batching(rng):
    """The same three names as aip_tpu; a batch of pairs gives each pair's
    single-pair flow (every pair runs through each level as one batch), to
    1e-3 px: oneDNN picks another summation order for a batch of
    convolutions than for one (4e-5 px measured on LK); a pair mixed up
    with another would be off by whole pixels."""
    assert set(tflow.FLOW_METHODS) == set(jflow.FLOW_METHODS) == {"lk", "tvl1", "farneback"}
    pairs = [_shifted_pair(rng, dx, dy, size=24) for dx, dy in ((1, 0), (0, 2), (-1, 1))]
    a, b = _t(np.stack([p[0] for p in pairs])), _t(np.stack([p[1] for p in pairs]))
    for method in ("lk", "farneback"):
        batch = tflow.estimate_flow_method(a, b, method=method)
        assert batch.shape == (3, 24, 24, 2)
        for i in range(3):
            single = tflow.estimate_flow_method(a[i], b[i], method=method)
            assert single.shape == (24, 24, 2)
            torch.testing.assert_close(batch[i], single, rtol=0, atol=1e-3)
    batch = tflow.estimate_flow_tvl1(a, b, iters=30)
    for i in range(3):
        torch.testing.assert_close(batch[i], tflow.estimate_flow_tvl1(a[i], b[i], iters=30),
                                   rtol=0, atol=1e-3)


def test_poly_expansion_matches_jax(rng):
    img = rng.random((40, 44)).astype(np.float32)
    ref = np.asarray(jfb.poly_expansion(jnp.asarray(img), 7, 1.5))
    np.testing.assert_allclose(tfb.poly_expansion(_t(img)[None], 7, 1.5)[0].numpy(), ref,
                               atol=1e-6)


def test_tvl1_endpoint_error_on_known_flow(rng):
    """The port's pyramidal TV-L1 against synthetic ground truth: mean EPE
    below 0.25 px on a sub-pixel translation (tests/test_flow_ops.py:392's
    bound for aip_tpu)."""
    dx, dy = 2.5, -1.5
    base = gaussian_filter(rng.random((100, 120)), 2.5)
    base = (base - base.min()) / (base.max() - base.min())
    ys, xs = np.meshgrid(np.arange(100, dtype=float), np.arange(120, dtype=float),
                         indexing="ij")
    # shifted(x) = base(x + d), so frame1(x) = frame2(x + flow) for flow = -d.
    shifted = map_coordinates(base, [ys + dy, xs + dx], order=3, mode="reflect")
    f1 = np.repeat(base[..., None], 3, -1)
    f2 = np.repeat(shifted[..., None], 3, -1)
    flow = tflow.estimate_flow_tvl1(_t(f1), _t(f2), iters=100).numpy()
    c = 12
    epe = np.linalg.norm(flow[c:-c, c:-c] - np.array([-dx, -dy]), axis=-1).mean()
    assert epe < 0.25, epe
