"""The fused AdaIN head/tail of the port against aip_tpu's.

On the CPU: the port's plain versions against the Pallas kernels in
interpret mode (with JAX's own weight packing) and against the XLA layer
chains, the wrapper's CPU path, the folded RGB conv, the recompute VJP, and
the wrapper's refusal to treat a CPU tensor as a kernel input. The CUDA
kernels are held against the plain versions in test_torch_port_cuda.py.

Tolerances: atol 5e-5 against the Pallas kernels, as aip_tpu's own tests
hold them; fp32 layer chains 1e-5 relative to the largest value.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aip_tpu.models.decoder import _tail_xla
from aip_tpu.models.vgg import _head_xla
from aip_tpu.ops.image import reflection_pad_2d
from aip_tpu.ops.pallas.adain_head import (decode_tail_pallas, encode_head_pallas,
                                           fold_rgb_conv as jfold, pack_pair_weights)
from aip_tpu_torch.kernels import _build
from aip_tpu_torch.kernels import adain_head as K

torch.set_num_threads(2)


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(w), (3, 2, 0, 1))))


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture
def enc_w(rng):
    """HWIO numpy weights of conv0 (1x1 3->3), conv1 (3->64), conv2 (64->64)."""
    return (rng.standard_normal((1, 1, 3, 3)).astype(np.float32) * .5,
            rng.standard_normal(3).astype(np.float32) * .1,
            rng.standard_normal((3, 3, 3, 64)).astype(np.float32) * .2,
            rng.standard_normal(64).astype(np.float32) * .1,
            rng.standard_normal((3, 3, 64, 64)).astype(np.float32) * .05,
            rng.standard_normal(64).astype(np.float32) * .1)


@pytest.fixture
def dec_w(rng):
    """HWIO numpy weights of the tail: conv 64->64 and conv 64->3."""
    return (rng.standard_normal((3, 3, 64, 64)).astype(np.float32) * .05,
            rng.standard_normal(64).astype(np.float32) * .1,
            rng.standard_normal((3, 3, 64, 3)).astype(np.float32) * .05,
            rng.standard_normal(3).astype(np.float32) * .1)


def _enc_torch(ws):
    w0, b0, w1, b1, w2, b2 = ws
    return _oihw(w0), _t(b0), _oihw(w1), _t(b1), _oihw(w2), _t(b2)


def _dec_torch(ws):
    w2, b2, w1, b1 = ws
    return _oihw(w2), _t(b2), _oihw(w1), _t(b1)


@pytest.mark.parametrize("hw,th", [((64, 96), 16), ((48, 48), 8), ((32, 40), 16)])
def test_encode_head_reference_matches_pallas_interpret(rng, enc_w, hw, th):
    w0, b0, w1, b1, w2, b2 = enc_w
    x = rng.random((2,) + hw + (3,)).astype(np.float32)
    we, be = jfold(jnp.asarray(w0), jnp.asarray(b0), jnp.asarray(w1), jnp.asarray(b1))
    ref = encode_head_pallas(
        reflection_pad_2d(jnp.asarray(x), 1), we.transpose(1, 0, 2, 3).reshape(3, 9, 64),
        be, pack_pair_weights(jnp.asarray(w2)), jnp.asarray(b2), th=th,
        out_dtype=jnp.float32, interpret=True)
    out = K.encode_head_reference(_t(x), *_enc_torch(enc_w))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=5e-5)


def test_decode_tail_reference_matches_pallas_interpret(rng, dec_w):
    w2, b2, w1, b1 = dec_w
    y = np.maximum(rng.standard_normal((3, 32, 48, 64)), 0).astype(np.float32)
    ref = decode_tail_pallas(
        jnp.asarray(y), pack_pair_weights(jnp.asarray(w2)), jnp.asarray(b2),
        pack_pair_weights(jnp.pad(jnp.asarray(w1), ((0, 0),) * 3 + ((0, 61),))),
        jnp.pad(jnp.asarray(b1), (0, 61)), th=16, out_dtype=jnp.float32, interpret=True)
    out = K.decode_tail_reference(_t(y), *_dec_torch(dec_w))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=5e-5)


def _rel_err(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-3)


@pytest.mark.parametrize("hw", [(37, 45), (2, 3), (16, 17)])
def test_encode_head_matches_xla_layers_odd_sizes(rng, enc_w, hw):
    """Odd sizes, which the Pallas kernel cannot take: ceil-mode pool."""
    x = rng.random((2,) + hw + (3,)).astype(np.float32)
    p = [{"w": jnp.asarray(enc_w[i]), "b": jnp.asarray(enc_w[i + 1])} for i in (0, 2, 4)]
    ref = np.asarray(_head_xla(jnp.float32, jnp.asarray(x), *p))
    out = K.encode_head(_t(x), *_enc_torch(enc_w)).numpy()
    assert out.shape == ref.shape == (2, (hw[0] + 1) // 2, (hw[1] + 1) // 2, 64)
    assert _rel_err(out, ref) < 1e-5


@pytest.mark.parametrize("hw", [(19, 23), (1, 1), (4, 3)])
def test_decode_tail_matches_xla_layers_odd_sizes(rng, dec_w, hw):
    y = np.maximum(rng.standard_normal((2,) + hw + (64,)), 0).astype(np.float32)
    p = [{"w": jnp.asarray(dec_w[i]), "b": jnp.asarray(dec_w[i + 1])} for i in (0, 2)]
    ref = np.asarray(_tail_xla(jnp.float32, jnp.asarray(y), *p))
    out = K.decode_tail(_t(y), *_dec_torch(dec_w)).numpy()
    assert out.shape == ref.shape == (2, 2 * hw[0], 2 * hw[1], 3)
    assert _rel_err(out, ref) < 1e-5


def test_fold_rgb_conv_matches_jax(enc_w):
    w0, b0, w1, b1 = enc_w[:4]
    we, be = jfold(jnp.asarray(w0), jnp.asarray(b0), jnp.asarray(w1), jnp.asarray(b1))
    twe, tbe = K.fold_rgb_conv(_oihw(w0), _t(b0), _oihw(w1), _t(b1))
    np.testing.assert_allclose(twe.numpy(), _oihw(we).numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tbe.numpy(), np.asarray(be), rtol=1e-5, atol=1e-6)


def test_wrappers_on_cpu_run_the_plain_version_and_count_nothing(rng, enc_w, dec_w):
    K.reset_launch_counts()
    x = _t(rng.random((1, 9, 10, 3)).astype(np.float32))
    torch.testing.assert_close(K.encode_head(x, *_enc_torch(enc_w)),
                               K.encode_head_reference(x, *_enc_torch(enc_w)), rtol=0, atol=0)
    y = _t(rng.random((1, 3, 4, 64)).astype(np.float32))
    torch.testing.assert_close(K.decode_tail(y, *_dec_torch(dec_w)),
                               K.decode_tail_reference(y, *_dec_torch(dec_w)), rtol=0, atol=0)
    assert K.launch_counts() == {"encode_head": 0, "decode_tail": 0}


def test_kernel_entry_refuses_cpu_tensors(rng, enc_w, dec_w):
    """The launch path never falls back: a CPU tensor there is an error."""
    x = _t(rng.random((1, 8, 8, 3)).astype(np.float32))
    with pytest.raises(ValueError, match="CUDA"):
        K._encode_head_cuda(x, *_enc_torch(enc_w))
    with pytest.raises(ValueError, match="CUDA"):
        K._decode_tail_cuda(_t(np.zeros((1, 2, 2, 64), np.float32)), *_dec_torch(dec_w))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("AIP_TPU_TORCH_BUILD", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build("adain_head")


def _grads(fn, inputs, seed):
    leaves = [t.clone().requires_grad_() for t in inputs]
    out = fn(*leaves)
    g = torch.from_numpy(np.random.default_rng(seed).standard_normal(out.shape)
                         .astype(np.float32))
    return torch.autograd.grad(out, leaves, g)


def test_autograd_functions_match_plain_gradients(rng, enc_w, dec_w):
    x = _t(rng.random((1, 11, 12, 3)).astype(np.float32))
    for a, b in zip(_grads(K.encode_head, (x,) + _enc_torch(enc_w), 1),
                    _grads(K.encode_head_reference, (x,) + _enc_torch(enc_w), 1)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    y = _t(np.maximum(rng.standard_normal((1, 5, 6, 64)), 0).astype(np.float32))
    for a, b in zip(_grads(K.decode_tail, (y,) + _dec_torch(dec_w), 2),
                    _grads(K.decode_tail_reference, (y,) + _dec_torch(dec_w), 2)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
