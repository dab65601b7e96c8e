"""The fused AdaIN head/tail of the port against aip_tpu's.

On the CPU: the port's plain versions against the Pallas kernels in
interpret mode (with JAX's own weight packing) and against the XLA layer
chains, the wrapper's CPU path, the folded RGB conv, the recompute VJP, and
the wrapper's refusal to treat a CPU tensor as a kernel input. The CUDA
kernels are held against the plain versions in test_torch_port_cuda.py.

The bf16 plain versions (those of the bf16 kernels) are held
against the Pallas kernels in interpret mode with bf16 weights; the packed
weights of the bf16 kernels round-trip to the OIHW weights, and their
cache repacks exactly when a weight changes.

Tolerances: atol 5e-5 against the Pallas kernels in fp32, as aip_tpu's own
tests hold them; fp32 layer chains 1e-5 relative to the largest value; the
bf16 ones are stated at their tests.
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


# ---------------------------------------------------------------------------
# The bf16 route: plain versions against the Pallas kernels, packed weights
# ---------------------------------------------------------------------------

BF = jnp.bfloat16


def _jbf(a):
    return jnp.asarray(a).astype(BF)


def _rel(out, ref):
    """(max, mean) abs error relative to the reference's largest value."""
    err = np.abs(np.asarray(out, np.float64) - np.asarray(ref, np.float64))
    scale = np.abs(np.asarray(ref)).max()
    return err.max() / scale, err.mean() / scale


def _bf16_t(t):
    return t.to(torch.bfloat16).float()


@pytest.mark.parametrize("hw,th", [((64, 96), 16), ((48, 48), 8), ((32, 40), 16)])
def test_encode_head_bf16_reference_matches_pallas_in_bf16(rng, enc_w, hw, th):
    """encode_head_pallas with bf16 weights (interpret mode), handed the
    folded conv1 as models/vgg.py:157-164 packs it, against
    encode_head_bf16_reference. The fold is computed in fp32 from the
    bf16-rounded weights and rounded to bf16 on both sides: XLA's bf16
    einsum on the CPU sums the bias's 27 products in an order of its own
    (29 of 64 biases a bf16 ulp apart, measured). Tolerance: max <= 1e-4 and
    mean <= 1e-6 of the largest value; the two sum conv1 in other orders, so
    a tie in relu1_1's bf16 rounding can flip (3.4e-5 at 48x48, measured;
    3e-7 elsewhere). The fp32 chain on the same bf16 inputs, without the
    intermediate rounding, misses that bound: the test pins the rounding."""
    w0, b0, w1, b1, w2, b2 = enc_w
    x = rng.random((2,) + hw + (3,)).astype(np.float32)
    f32 = lambda a: _jbf(a).astype(jnp.float32)
    we, be = jfold(f32(w0), f32(b0), f32(w1), f32(b1))
    ref = encode_head_pallas(
        reflection_pad_2d(_jbf(x), 1), we.astype(BF).transpose(1, 0, 2, 3).reshape(3, 9, 64),
        be.astype(BF), pack_pair_weights(_jbf(w2)), jnp.asarray(b2), th=th,
        out_dtype=jnp.float32, interpret=True)
    ws = _enc_torch(enc_w)
    err_max, err_mean = _rel(K.encode_head_bf16_reference(_t(x), *ws), ref)
    assert err_max <= 1e-4 and err_mean <= 1e-6, (err_max, err_mean)
    unrounded = K.encode_head_reference(_bf16_t(_t(x)), *map(_bf16_t, ws))
    assert _rel(unrounded, ref)[0] > 1e-3


def test_decode_tail_bf16_reference_matches_pallas_in_bf16(rng, dec_w):
    """decode_tail_pallas with bf16 weights and fp32 biases (interpret
    mode), packed as models/decoder.py does, against
    decode_tail_bf16_reference: max <= 1e-3 and mean <= 1e-5 of the largest
    value (a few bf16 ties of relu(z) flip under another fp32 sum order:
    1.7e-4 and 3.3e-7, measured). The unrounded fp32 chain misses it."""
    w2, b2, w1, b1 = dec_w
    y = np.maximum(rng.standard_normal((2, 16, 24, 64)), 0).astype(np.float32)
    ref = decode_tail_pallas(
        jnp.asarray(y), pack_pair_weights(_jbf(w2)), jnp.asarray(b2),
        pack_pair_weights(jnp.pad(_jbf(w1), ((0, 0),) * 3 + ((0, 61),))),
        jnp.pad(jnp.asarray(b1), (0, 61)), th=16, out_dtype=jnp.float32, interpret=True)
    ws = _dec_torch(dec_w)
    err_max, err_mean = _rel(K.decode_tail_bf16_reference(_t(y), *ws), ref)
    assert err_max <= 1e-3 and err_mean <= 1e-5, (err_max, err_mean)
    unrounded = K.decode_tail_reference(_bf16_t(_t(y)), *map(_bf16_t, ws))
    assert _rel(unrounded, ref)[0] > 1e-3


def _unfragment(frag):
    """Inverse of the B-fragment order: [S, NT, 32, 4] -> [8 NT, 16 S]. Lane
    l of n-tile j at k-step s holds n = 8j + l//4, k = 16s + 2(l%4) + (0, 1,
    8, 9)."""
    frag = frag.float().numpy()
    s_, nt, _, _ = frag.shape
    wk = np.full((8 * nt, 16 * s_), np.nan, np.float32)
    for s in range(s_):
        for j in range(nt):
            for lane in range(32):
                for e, dk in enumerate((0, 1, 8, 9)):
                    wk[8 * j + lane // 4, 16 * s + 2 * (lane % 4) + dk] = frag[s, j, lane, e]
    return wk


def _unswizzle_w2(w2p):
    """[9, 64, 8, 8] with chunk c of output n at c ^ (n % 8) -> OIHW."""
    a = w2p.float().numpy()
    w = np.empty((64, 64, 3, 3), np.float32)
    for tap in range(9):
        for n in range(64):
            for pos in range(8):
                w[n, 8 * (pos ^ (n % 8)):8 * (pos ^ (n % 8)) + 8, tap // 3, tap % 3] = a[tap, n, pos]
    return w


def test_packed_weights_round_trip_to_oihw(enc_w, dec_w):
    """Every packed element lands where the kernels read it: unpacking
    gives the bf16-rounded OIHW weights (conv1 folded), zero padding, fp32
    biases."""
    ws = _enc_torch(enc_w)
    w1f, b1f, w2p, b2f = K.pack_encode_head(*ws)
    assert w1f.shape == (2, 8, 32, 4) and w2p.shape == (9, 64, 8, 8)
    assert w1f.dtype == w2p.dtype == torch.bfloat16 and b1f.dtype == b2f.dtype == torch.float32
    w_eff, b_eff = K._fold_bf16(*ws[:4])
    wk = _unfragment(w1f)
    np.testing.assert_array_equal(wk[:, :27].reshape(64, 3, 3, 3).transpose(0, 3, 1, 2),
                                  w_eff.numpy())
    np.testing.assert_array_equal(wk[:, 27:], 0)
    np.testing.assert_array_equal(b1f.numpy(), b_eff.numpy())
    np.testing.assert_array_equal(_unswizzle_w2(w2p), _bf16_t(ws[4]).numpy())
    np.testing.assert_array_equal(b2f.numpy(), ws[5].numpy())

    dws = _dec_torch(dec_w)
    w2p, b2f, w1f, b1f = K.pack_decode_tail(*dws)
    assert w1f.shape == (36, 1, 32, 4)
    np.testing.assert_array_equal(_unswizzle_w2(w2p), _bf16_t(dws[0]).numpy())
    wk = _unfragment(w1f)
    np.testing.assert_array_equal(wk[:3].reshape(3, 3, 3, 64).transpose(0, 3, 1, 2),
                                  _bf16_t(dws[2]).numpy())
    np.testing.assert_array_equal(wk[3:], 0)
    np.testing.assert_array_equal(b2f.numpy(), dws[1].numpy())
    np.testing.assert_array_equal(b1f.numpy(), dws[3].numpy())


def test_packed_weights_cache_repacks_only_after_an_update(enc_w, dec_w):
    """An unchanged module packs once; an in-place update (a new _version)
    repacks, with the new values."""
    conv = torch.nn.Conv2d(64, 64, 3)
    ws = list(_enc_torch(enc_w))
    ws[4], ws[5] = conv.weight, conv.bias
    first = K.packed_weights("encode_head", *ws)
    assert K.packed_weights("encode_head", *ws) is first
    with torch.no_grad():
        conv.weight.mul_(2.0)
    second = K.packed_weights("encode_head", *ws)
    assert second is not first
    assert K.packed_weights("encode_head", *ws) is second
    np.testing.assert_array_equal(second[2].float().numpy(), 2 * first[2].float().numpy())
    dws = _dec_torch(dec_w)
    tail = K.packed_weights("decode_tail", *dws)
    assert K.packed_weights("decode_tail", *dws) is tail
    assert K.packed_weights("encode_head", *ws) is second


def test_wrappers_on_cpu_run_the_bf16_plain_version_for_bf16(rng, enc_w, dec_w):
    """A bf16 CPU tensor takes the bf16 route's plain version; no
    launch is counted on either route."""
    K.reset_launch_counts()
    x = _t(rng.random((2, 9, 10, 3)).astype(np.float32)).bfloat16()
    out = K.encode_head(x, *_enc_torch(enc_w))
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out, K.encode_head_bf16_reference(x, *_enc_torch(enc_w)),
                               rtol=0, atol=0)
    y = _t(np.maximum(rng.standard_normal((1, 3, 4, 64)), 0).astype(np.float32)).bfloat16()
    out = K.decode_tail(y, *_dec_torch(dec_w))
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out, K.decode_tail_bf16_reference(y, *_dec_torch(dec_w)),
                               rtol=0, atol=0)
    zero = {"encode_head": 0, "decode_tail": 0}
    assert K.launch_counts() == zero
    assert K.route_launch_counts() == {"bf16": zero, "fp32": zero}
