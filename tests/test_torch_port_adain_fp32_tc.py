"""The fp32 route of the AdaIN head and tail (``csrc/adain_head.cu``): its
packed weights and its arithmetic, on the CPU.

The kernels split each operand of the 64->64 conv into TF32 parts, hi =
tf32(v) and lo = tf32(v - hi), and sum three products, lo*hi + hi*lo +
hi*hi. Here the packs are unpacked and that arithmetic is emulated in
float64 with the packed weights (the activations split as the kernel
splits them in registers), then held against the chain in float64: within
1e-6 of the largest output, where one TF32 pass (hi*hi alone) is not.
The tensor cores round each step's fp32 sum toward zero; modelled so, a
fresh partial sum a tap holds the card's float64 limit (chip_smoke.py's
FP32_FLOAT64_TOL, 1.5e-6), where one partial over all 9 taps does not.
The emulated head and tail also agree with ``aip_tpu``'s XLA layer chains.
The kernels themselves run on the card (test_torch_port_cuda.py).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from aip_tpu.models.decoder import _tail_xla
from aip_tpu.models.vgg import _head_xla
from aip_tpu_torch.device import fp32_convs
from aip_tpu_torch.kernels import adain_head as K

torch.set_num_threads(2)


def _randn(g, shape, scale):
    return torch.from_numpy((g.standard_normal(shape) * scale).astype(np.float32))


@pytest.fixture
def head_w():
    """OIHW weights of conv0 (1x1), conv1 (3->64) and conv2 (64->64), He-scaled."""
    g = np.random.default_rng(5)
    return [_randn(g, (3, 3, 1, 1), .5), _randn(g, (3,), .1), _randn(g, (64, 3, 3, 3), .27),
            _randn(g, (64,), .1), _randn(g, (64, 64, 3, 3), (2 / 576) ** .5),
            _randn(g, (64,), .1)]


@pytest.fixture
def tail_w():
    """OIHW weights of the tail: conv 64->64 and conv 64->3, He-scaled."""
    g = np.random.default_rng(6)
    return [_randn(g, (64, 64, 3, 3), (2 / 576) ** .5), _randn(g, (64,), .1),
            _randn(g, (3, 64, 3, 3), (1 / 576) ** .5), _randn(g, (3,), .1)]


def _unpack_w2(w2p):
    """[9, 2, 2, 64, 8, 4] (tap, hi/lo, K-block, out, swizzled chunk, 4 in)
    -> (hi, lo), each OIHW [64, 64, 3, 3]."""
    n = torch.arange(64)[:, None]
    pos = torch.arange(8)[None, :] ^ (n % 8)          # where chunk c of output n lives
    w = w2p[:, :, :, n, pos]                          # [9, 2, 2, 64, 8, 4], chunks in order
    w = w.permute(1, 3, 2, 4, 5, 0).reshape(2, 64, 64, 3, 3)  # [part, out, in, tap]
    return w[0], w[1]


def _unfragment(w1f):
    """conv1's B fragments [4, 8, 32, 4] -> (hi, lo), each OIHW [64, 3, 3, 3]
    (the 27 real rows of K; the padding is returned apart, [64, 5] each)."""
    hi, lo = torch.zeros(64, 32), torch.zeros(64, 32)
    for s in range(4):
        for j in range(8):
            for lane in range(32):
                n, k = 8 * j + lane // 4, 8 * s + lane % 4
                hi[n, k], hi[n, k + 4], lo[n, k], lo[n, k + 4] = w1f[s, j, lane]
    oihw = lambda wk: wk[:, :27].reshape(64, 3, 3, 3).permute(0, 3, 1, 2)
    return oihw(hi), oihw(lo), hi[:, 27:], lo[:, 27:]


def _split(v):
    hi = K.tf32_round(v)
    return hi, K.tf32_round(v - hi)


def _conv_tf32(a, w_hi, w_lo, passes):
    """The VALID conv of fp32 NCHW ``a`` as the kernels sum it, the products
    and sums exact (float64): three TF32 products a multiply-add, or hi*hi
    alone."""
    a_hi, a_lo = _split(a)
    pairs = ((a_lo, w_hi), (a_hi, w_lo), (a_hi, w_hi)) if passes == 3 else ((a_hi, w_hi),)
    return sum(F.conv2d(x.double(), w.double()) for x, w in pairs)


def _round_toward_zero(v):
    """float64 -> float32, rounded toward zero."""
    r = v.float()
    return torch.where(r.double().abs() > v.abs(), torch.nextafter(r, torch.zeros_like(r)), r)


def _conv_tensor_cores(a, w_hi, w_lo, taps_per_partial):
    """The VALID 3x3 conv of fp32 NCHW ``a`` (64 channels) as the kernels'
    wgmma steps sum it, modelled: a step adds 8 channels' exact products of
    one TF32 pair (lo*hi, hi*lo, hi*hi in turn) to the fp32 partial,
    rounding toward zero; every ``taps_per_partial`` taps the partial joins
    the fp32 total (rounding to nearest)."""
    a_hi, a_lo = _split(a)
    ho, wo = a.shape[2] - 2, a.shape[3] - 2
    tot = part = torch.zeros(a.shape[0], w_hi.shape[0], ho, wo)
    for tap in range(9):
        dy, dx = divmod(tap, 3)
        if tap % taps_per_partial == 0:
            part = torch.zeros_like(part)
        for ks in range(8):
            c = slice(8 * ks, 8 * ks + 8)
            for x, w in ((a_lo, w_hi), (a_hi, w_lo), (a_hi, w_hi)):
                step = torch.einsum("bchw,oc->bohw", x[:, c, dy:dy + ho, dx:dx + wo].double(),
                                    w[:, c, dy, dx].double())
                part = _round_toward_zero(part.double() + step)
        if (tap + 1) % taps_per_partial == 0:
            tot = tot + part
    return tot.double()


def _conv2(a, w_hi, w_lo, passes, taps_per_partial):
    """The 64->64 conv: exact sums if ``taps_per_partial`` is None, else
    the tensor cores' sums modelled (three products)."""
    if taps_per_partial is None:
        return _conv_tf32(a, w_hi, w_lo, passes)
    return _conv_tensor_cores(a, w_hi, w_lo, taps_per_partial)


def _reflect(t):
    return F.pad(t, (1, 1, 1, 1), mode="reflect")


def _emulate_head(x, packs, passes, taps_per_partial=None):
    """The fp32 head kernel's arithmetic on x [B,H,W,3]: conv1 (folded) by
    ``_conv_tf32``, conv2 by ``_conv2``, relu1_1 in fp32, bias, ReLU,
    ceil-mode pool."""
    w1f, b1, w2p, b2 = packs
    c1_hi, c1_lo, _, _ = _unfragment(w1f)
    r1 = _conv_tf32(_reflect(x.permute(0, 3, 1, 2)), c1_hi, c1_lo, passes)
    r1 = torch.relu(r1 + b1.double()[:, None, None]).float()
    w_hi, w_lo = _unpack_w2(w2p)
    h = torch.relu(_conv2(_reflect(r1), w_hi, w_lo, passes, taps_per_partial)
                   + b2.double()[:, None, None])
    return F.max_pool2d(h, 2, 2, ceil_mode=True).permute(0, 2, 3, 1)


def _emulate_tail(y, packs, passes, taps_per_partial=None):
    """The fp32 tail kernel's arithmetic on y [B,h,w,64]: the 64->64 conv by
    ``_conv2`` on the upsampled y, relu(z) in fp32, the 64->3 conv."""
    w2p, b2, w1p, b1 = packs
    u = F.interpolate(y.permute(0, 3, 1, 2), scale_factor=2, mode="nearest")
    w_hi, w_lo = _unpack_w2(w2p)
    z = _conv2(_reflect(u), w_hi, w_lo, passes, taps_per_partial)
    z = torch.relu(z + b2.double()[:, None, None]).float()
    w1 = w1p.permute(2, 1, 3, 0).reshape(3, 64, 3, 3)   # [out, in, ky, kx]
    return F.conv2d(_reflect(z).double(), w1.double(), b1[:3].double()).permute(0, 2, 3, 1)


def _float64_rel_err(out, ref):
    return float((out.double() - ref).abs().max() / ref.abs().max())


def test_tf32_round_is_round_half_away_to_ten_bits():
    """Ties go away from zero for either sign, and the low 13 bits are 0."""
    x = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12, 1.5 + 2 ** -11,
                      -(1.5 + 2 ** -12), 0.0])
    out = K.tf32_round(x)
    assert out.tolist() == [1 + 2 ** -10, -(1 + 2 ** -10), 1.0, 1.5 + 2 ** -10, -1.5, 0.0]
    assert int((out.view(torch.int32) & 0x1FFF).abs().max()) == 0


def test_fp32_packs_split_and_round_trip(head_w, tail_w):
    """hi and lo are TF32 (low 13 bits 0); hi = tf32(w2) and hi + lo
    reconstructs w2 within 2^-22 relative; every pack round-trips to its
    OIHW weights (conv1's hi = tf32 of the fold, lo = tf32 of the rest)."""
    w1f, b1, w2p, b2 = K.pack_encode_head_fp32(*head_w)
    assert w2p.shape == (9, 2, 2, 64, 8, 4) and w2p.dtype == torch.float32
    assert w2p.is_contiguous() and w2p.numel() * 4 == 9 * 32768
    assert int((w2p.view(torch.int32) & 0x1FFF).abs().max()) == 0
    hi, lo = _unpack_w2(w2p)
    w2 = head_w[4]
    torch.testing.assert_close(hi, K.tf32_round(w2), rtol=0, atol=0)
    assert bool(((hi + lo).double() - w2.double()).abs().le(2 ** -22 * w2.double().abs()).all())
    w_eff, b_eff = K.fold_rgb_conv(*head_w[:4])
    assert w1f.shape == (4, 8, 32, 4)
    assert int((w1f.view(torch.int32) & 0x1FFF).abs().max()) == 0
    c1_hi, c1_lo, pad_hi, pad_lo = _unfragment(w1f)
    torch.testing.assert_close(c1_hi, K.tf32_round(w_eff), rtol=0, atol=0)
    torch.testing.assert_close(c1_lo, K.tf32_round(w_eff - c1_hi), rtol=0, atol=0)
    assert not pad_hi.any() and not pad_lo.any()
    torch.testing.assert_close(b1, b_eff, rtol=0, atol=0)
    torch.testing.assert_close(b2, head_w[5], rtol=0, atol=0)

    w2p, b2, w1p, b1 = K.pack_decode_tail_fp32(*tail_w)
    hi, lo = _unpack_w2(w2p)
    torch.testing.assert_close(hi, K.tf32_round(tail_w[0]), rtol=0, atol=0)
    torch.testing.assert_close(lo, K.tf32_round(tail_w[0] - hi), rtol=0, atol=0)
    assert w1p.shape == (9, 16, 3, 4)
    torch.testing.assert_close(w1p.permute(2, 1, 3, 0).reshape(3, 64, 3, 3), tail_w[2],
                               rtol=0, atol=0)
    torch.testing.assert_close(b1, F.pad(tail_w[3], (0, 1)), rtol=0, atol=0)
    torch.testing.assert_close(b2, tail_w[1], rtol=0, atol=0)


def test_fp32_packs_are_cached_until_an_in_place_update(head_w, tail_w):
    conv = torch.nn.Conv2d(64, 64, 3)
    ws = list(head_w)
    ws[4], ws[5] = conv.weight, conv.bias
    first = K.packed_weights("encode_head_fp32", *ws)
    assert K.packed_weights("encode_head_fp32", *ws) is first
    with torch.no_grad():
        conv.weight.mul_(2.0)
    second = K.packed_weights("encode_head_fp32", *ws)
    assert second is not first and K.packed_weights("encode_head_fp32", *ws) is second
    torch.testing.assert_close(second[2], 2 * first[2], rtol=0, atol=0)
    tail = K.packed_weights("decode_tail_fp32", *tail_w)
    assert K.packed_weights("decode_tail_fp32", *tail_w) is tail
    assert K.packed_weights("decode_tail", *tail_w) is not tail   # the bf16 route packs apart


@pytest.mark.parametrize("hw", [(24, 20), (9, 13)])
def test_three_tf32_products_hold_float64_where_one_pass_does_not(head_w, tail_w, hw):
    """The head on x [1,H,W,3] and the tail on y [1,H/2,W/2,64]: the
    emulated kernel within 1e-6 of the largest float64 output; one TF32
    pass off by more than 1e-5 (about 3e-4)."""
    g = np.random.default_rng(7)
    x = torch.from_numpy(g.random((1,) + hw + (3,)).astype(np.float32))
    y = torch.relu(_randn(g, (1, hw[0] // 2, hw[1] // 2, 64), 1.0))
    cases = ((x, head_w, K.pack_encode_head_fp32, _emulate_head, K.encode_head_reference),
             (y, tail_w, K.pack_decode_tail_fp32, _emulate_tail, K.decode_tail_reference))
    for inp, ws, pack, emulate, plain in cases:
        ref = plain(inp.double(), *[w.double() for w in ws])
        packs = pack(*ws)
        assert _float64_rel_err(emulate(inp, packs, 3), ref) <= 1e-6
        assert _float64_rel_err(emulate(inp, packs, 1), ref) > 1e-5


@pytest.mark.parametrize("hw", [(24, 20), (9, 13)])
def test_a_fresh_partial_a_tap_holds_the_float64_limit_under_truncating_sums(
        head_w, tail_w, hw):
    """The tensor cores' sums modelled (each step rounded toward zero): a
    fresh partial sum a tap, the kernels' design, keeps the head and the
    tail within 1.5e-6 of the largest float64 output (about 6e-7); one
    partial over all 9 taps (216 steps) drifts past it (about 5e-6)."""
    g = np.random.default_rng(7)
    x = torch.from_numpy(g.random((1,) + hw + (3,)).astype(np.float32))
    y = torch.relu(_randn(g, (1, hw[0] // 2, hw[1] // 2, 64), 1.0))
    cases = ((x, head_w, K.pack_encode_head_fp32, _emulate_head, K.encode_head_reference),
             (y, tail_w, K.pack_decode_tail_fp32, _emulate_tail, K.decode_tail_reference))
    for inp, ws, pack, emulate, plain in cases:
        ref = plain(inp.double(), *[w.double() for w in ws])
        packs = pack(*ws)
        assert _float64_rel_err(emulate(inp, packs, 3, taps_per_partial=1), ref) <= 1.5e-6
        assert _float64_rel_err(emulate(inp, packs, 3, taps_per_partial=9), ref) > 1.5e-6


def test_emulated_fp32_route_matches_the_xla_layers(head_w, tail_w):
    """The emulated head and tail against aip_tpu's _head_xla / _tail_xla in
    fp32 (HWIO weights), at 1e-5 of the largest value."""
    g = np.random.default_rng(8)
    x = g.random((2, 14, 18, 3)).astype(np.float32)
    hwio = lambda w: jnp.asarray(w.permute(2, 3, 1, 0).numpy())
    p = [{"w": hwio(head_w[i]), "b": jnp.asarray(head_w[i + 1].numpy())} for i in (0, 2, 4)]
    ref = np.asarray(_head_xla(jnp.float32, jnp.asarray(x), *p))
    out = _emulate_head(torch.from_numpy(x), K.pack_encode_head_fp32(*head_w), 3).numpy()
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()
    y = np.maximum(g.standard_normal((2, 7, 9, 64)), 0).astype(np.float32)
    p = [{"w": hwio(tail_w[i]), "b": jnp.asarray(tail_w[i + 1].numpy())} for i in (0, 2)]
    ref = np.asarray(_tail_xla(jnp.float32, jnp.asarray(y), *p))
    out = _emulate_tail(torch.from_numpy(y), K.pack_decode_tail_fp32(*tail_w), 3).numpy()
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("before", [True, False])
def test_fp32_convs_turns_cudnn_tf32_off_in_scope_only(before):
    """Inside the block cuDNN's TF32 is off; on exit, even through an
    exception, the flag is what it was, and no other cuDNN flag moves."""
    cudnn = torch.backends.cudnn
    saved = cudnn.allow_tf32
    cudnn.allow_tf32 = before
    others = (cudnn.enabled, cudnn.benchmark, cudnn.deterministic)
    try:
        with fp32_convs():
            assert cudnn.allow_tf32 is False
        assert cudnn.allow_tf32 is before
        with pytest.raises(RuntimeError):
            with fp32_convs():
                raise RuntimeError("inside")
        assert cudnn.allow_tf32 is before
        assert (cudnn.enabled, cudnn.benchmark, cudnn.deterministic) == others
    finally:
        cudnn.allow_tf32 = saved
