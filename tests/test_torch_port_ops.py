"""aip_tpu_torch.ops vs aip_tpu.ops on the CPU: the same numpy inputs
through both packages.

Tolerances: pad / upsample / pool / crop / nearest are data movement or a
max, so they must be bit-equal; the resizes are float32 products whose
summation order differs between XLA and PyTorch (atol 1e-5); the AdaIN
statistics rtol 1e-5; CORAL goes through an SVD and an inverse (atol 1e-4).
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aip_tpu_torch.ops import adain as tadain
from aip_tpu_torch.ops import depth as tdepth
from aip_tpu_torch.ops import image as timage

# aip_tpu.ops re-exports functions under its module names (ops.adain is
# the function), so the reference modules are fetched by full name.
jadain = importlib.import_module("aip_tpu.ops.adain")
jdepth = importlib.import_module("aip_tpu.ops.depth")
jimage = importlib.import_module("aip_tpu.ops.image")

torch.set_num_threads(2)


def _both(fn_j, fn_t, x, *args, **kw):
    a = np.asarray(fn_j(jnp.asarray(x), *args, **kw))
    b = fn_t(torch.from_numpy(x), *args, **kw).numpy()
    assert a.shape == b.shape
    return a, b


@pytest.mark.parametrize("shape", [(2, 7, 9, 5), (1, 2, 3, 4), (1, 16, 17, 3)])
def test_reflection_pad_upsample_pool_bit_equal(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    for fj, ft in [(jimage.reflection_pad_2d, timage.reflection_pad_2d),
                   (jimage.upsample_nearest_2x, timage.upsample_nearest_2x),
                   (jimage.max_pool_2x2_ceil, timage.max_pool_2x2_ceil)]:
        a, b = _both(fj, ft, x)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("src,dst", [((400, 400), (682, 682)), ((682, 341), (400, 200)),
                                     ((37, 45), (16, 90)), ((5, 6), (5, 6))])
def test_resize_nearest_bit_equal(rng, src, dst):
    """Includes the float32 index rule case (341 * 400/682 = 200)."""
    x = rng.random((1,) + src + (1,)).astype(np.float32)
    a, b = _both(jimage.resize_nearest, timage.resize_nearest, x, dst)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("src,dst", [((37, 45), (9, 11)), ((16, 16), (40, 23)),
                                     ((33, 20), (33, 20))])
def test_resize_bicubic_bilinear(rng, src, dst):
    x = rng.random((2,) + src + (3,)).astype(np.float32)
    a, b = _both(jimage.resize_bicubic, timage.resize_bicubic, x, dst)
    np.testing.assert_allclose(a, b, atol=1e-5)
    for kw in ({}, {"antialias": True}, {"align_corners": True}):
        a, b = _both(jimage.resize_bilinear, timage.resize_bilinear, x, dst, **kw)
        np.testing.assert_allclose(a, b, atol=1e-5, err_msg=str(kw))
    # HWC input
    a, b = _both(jimage.resize_bicubic, timage.resize_bicubic, x[0], dst)
    np.testing.assert_allclose(a, b, atol=1e-5)


@pytest.mark.parametrize("hw", [(40, 48), (48, 40), (31, 31), (700, 513)])
def test_smaller_edge_resize_and_center_crop(rng, hw):
    assert jimage.smaller_edge_size(*hw, 32) == timage.smaller_edge_size(*hw, 32)
    if hw[0] * hw[1] > 10000:
        return
    x = rng.random(hw + (3,)).astype(np.float32)
    a, b = _both(jimage.resize_smaller_edge, timage.resize_smaller_edge, x, 24)
    np.testing.assert_allclose(a, b, atol=1e-5)
    a, b = _both(jimage.center_crop, timage.center_crop, x, 20)
    np.testing.assert_array_equal(a, b)


def test_calc_mean_std_adain_style_loss(rng):
    c = rng.standard_normal((2, 5, 7, 16)).astype(np.float32)
    s = (rng.standard_normal((2, 6, 4, 16)) * 2 + 1).astype(np.float32)
    for a, b in zip(jadain.calc_mean_std(jnp.asarray(c)),
                    tadain.calc_mean_std(torch.from_numpy(c))):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(
        np.asarray(jadain.adain(jnp.asarray(c), jnp.asarray(s))),
        tadain.adain(torch.from_numpy(c), torch.from_numpy(s)).numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        float(jadain.style_loss_terms(jnp.asarray(c), jnp.asarray(s))),
        float(tadain.style_loss_terms(torch.from_numpy(c), torch.from_numpy(s))), rtol=1e-5)


def test_adain_keeps_bf16_dtype(rng):
    c = torch.from_numpy(rng.standard_normal((1, 4, 4, 8)).astype(np.float32)).bfloat16()
    assert tadain.adain(c, c).dtype == torch.bfloat16
    mean, std = tadain.calc_mean_std(c)
    assert mean.dtype == std.dtype == torch.float32


def test_coral(rng):
    src = rng.random((12, 10, 3)).astype(np.float32)
    tgt = (rng.random((9, 14, 3)) * np.array([0.5, 1.0, 0.2]) + 0.1).astype(np.float32)
    a = np.asarray(jadain.coral(jnp.asarray(src), jnp.asarray(tgt)))
    b = tadain.coral(torch.from_numpy(src), torch.from_numpy(tgt)).numpy()
    np.testing.assert_allclose(a, b, atol=1e-4)


@pytest.mark.parametrize("offset,prominence,size", [(0.15, 20.0, (8, 8)), (0.3, 17.0, (9, 11))])
def test_strength_map(rng, offset, prominence, size):
    d = (rng.random((37, 45)) * 5).astype(np.float32)
    a = np.asarray(jdepth.compute_stylization_strength_map(jnp.asarray(d), size, offset,
                                                            prominence))
    b = tdepth.compute_stylization_strength_map(torch.from_numpy(d), size, offset,
                                                prominence).numpy()
    np.testing.assert_allclose(a, b, atol=1e-5)


def test_strength_map_constant_is_zero():
    """A constant map gives zeros (reference test.py:139-143), as in
    aip_tpu's own test: 32x32 -> 8x8 keeps the resized map exactly flat."""
    const = tdepth.compute_stylization_strength_map(torch.ones(32, 32), (8, 8))
    np.testing.assert_array_equal(const.numpy(), 0.0)
