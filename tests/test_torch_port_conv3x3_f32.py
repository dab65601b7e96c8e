"""The fp32 walk conv (``kernels/conv3x3_f32.py``, ``csrc/conv3x3_f32.cu``)
on the CPU: its weight pack, its arithmetic and which walk calls take it.

* The pack splits each weight into TF32 parts, hi = tf32(w) and lo =
  tf32(w - hi), in the order the kernel streams them; unpacked, it gives the
  weights back.
* The kernel's arithmetic, emulated in float64 from the packed weights and
  the activations split as the kernel splits them in registers: three TF32
  products a multiply-add, each wgmma step's sum rounded toward zero into a
  fresh partial a (tap, 32 input channels), the partials added to an fp32
  total with a Kahan compensation kept in bf16. That holds every (Cin,
  Cout) pair of the walks within 1e-6 of the largest float64 output, where
  one TF32 pass (hi*hi alone) does not.
* Routing: fp32 walks that autograd does not record send every 3x3 conv of
  widths that are multiples of 64 to ``conv3x3_f32`` and count each in
  ``models.convs_f32_kernel``; bf16, recorded and tensor-parallel convs do
  not. On the CPU the route runs the plain version, the ``F.conv2d`` the
  walks ran before it, so the walks give the same bits as that chain.

The kernel itself runs on the card (test_torch_port_cuda.py).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from aip_tpu_torch.kernels import conv3x3_f32 as KF
from aip_tpu_torch.kernels.adain_head import tf32_round
from aip_tpu_torch.kernels.conv_epilogue import conv_epilogue_chain
from aip_tpu_torch.models import decoder as tdec
from aip_tpu_torch.models import vgg as tvgg
from aip_tpu_torch.utils import profiling as P

torch.set_num_threads(2)

# (Cin, Cout) of every walk conv: the encoder's from pool1 to relu4_1, the
# decoder's before its tail.
WALK_PAIRS = sorted({(c[1], c[2]) for c in tvgg.conv_specs()[3:10]}
                    | {(c[1], c[2]) for c in tdec.conv_specs()[:-2]})


def _weights(cin, cout, seed):
    g = np.random.default_rng(seed)
    return torch.from_numpy((g.standard_normal((cout, cin, 3, 3))
                             * (2 / (9 * cin)) ** .5).astype(np.float32))


def _bordered(b, h, w, cin, seed):
    """A ReLU'd [b, h, w, cin] map with its reflection border, NHWC."""
    g = np.random.default_rng(seed)
    x = torch.relu(torch.from_numpy(g.standard_normal((b, cin, h, w)).astype(np.float32)))
    return F.pad(x, (1, 1, 1, 1), mode="reflect").permute(0, 2, 3, 1)


def _unpack(packed):
    """[Cout/64, Cin/64, 9, 2, 2, 64, 8, 4] -> (hi, lo), each OIHW."""
    slices, chunks = packed.shape[:2]
    n = torch.arange(64)[:, None]
    w = packed[..., n, torch.arange(8)[None, :] ^ (n % 8), :]   # chunks in order
    # [slice, chunk, tap, half, part, out, c, 4] -> [part, slice, out, chunk, half, c, 4, tap]
    w = w.permute(4, 0, 5, 1, 3, 6, 7, 2).reshape(2, 64 * slices, 64 * chunks, 3, 3)
    return w[0], w[1]


def _split(v):
    hi = tf32_round(v)
    return hi, tf32_round(v - hi)


def _round_toward_zero(v):
    """float64 -> float32, rounded toward zero."""
    r = v.float()
    return torch.where(r.double().abs() > v.abs(), torch.nextafter(r, torch.zeros_like(r)), r)


def _emulate(x, packed, passes=3):
    """The kernel's arithmetic on the bordered NHWC ``x``: per (64-channel
    chunk, tap, 32-channel half) a fresh partial, to which each k-step of 8
    channels adds the exact products of one TF32 pair (lo*hi, hi*lo, hi*hi
    in turn; hi*hi alone if ``passes`` is 1), rounding toward zero; each
    partial joins the fp32 total with a Kahan compensation rounded to bf16,
    which the output subtracts."""
    w_hi, w_lo = _unpack(packed)
    a_hi, a_lo = _split(x.permute(0, 3, 1, 2))
    pairs = ((a_lo, w_hi), (a_hi, w_lo), (a_hi, w_hi)) if passes == 3 else ((a_hi, w_hi),)
    b, cin, hb, wb = a_hi.shape
    ho, wo = hb - 2, wb - 2
    tot = torch.zeros(b, w_hi.shape[0], ho, wo)
    comp = torch.zeros_like(tot)
    for c0 in range(0, cin, 64):
        for tap in range(9):
            dy, dx = divmod(tap, 3)
            for h0 in (c0, c0 + 32):
                part = torch.zeros(tot.shape, dtype=torch.float64)
                for k0 in range(h0, h0 + 32, 8):
                    c = slice(k0, k0 + 8)
                    for a, w in pairs:
                        step = torch.einsum("bchw,oc->bohw",
                                            a[:, c, dy:dy + ho, dx:dx + wo].double(),
                                            w[:, c, dy, dx].double())
                        part = _round_toward_zero(part + step).double()
                y = part.float() - comp
                s = tot + y
                comp = ((s - tot) - y).to(torch.bfloat16).float()
                tot = s
    return (tot - comp).permute(0, 2, 3, 1)


@pytest.mark.parametrize("cin,cout", WALK_PAIRS)
def test_pack_splits_into_tf32_parts_and_round_trips(cin, cout):
    w = _weights(cin, cout, 1)
    packed = KF.pack_weights(w)
    assert packed.shape == (cout // 64, cin // 64, 9, 2, 2, 64, 8, 4)
    assert packed.dtype == torch.float32 and packed.is_contiguous()
    assert packed.numel() * 4 == (cout // 64) * (cin // 64) * 18 * 16384
    assert int((packed.view(torch.int32) & 0x1FFF).abs().max()) == 0
    hi, lo = _unpack(packed)
    assert torch.equal(hi, tf32_round(w))
    assert torch.equal(lo, tf32_round(w - hi))
    assert bool(((hi + lo).double() - w.double()).abs().le(2 ** -22 * w.double().abs()).all())


@pytest.mark.parametrize("hw", [(6, 8), (5, 7)])
@pytest.mark.parametrize("cin,cout", WALK_PAIRS)
def test_three_tf32_products_hold_float64_where_one_pass_does_not(cin, cout, hw):
    """The emulated kernel within 1e-6 of the largest float64 output
    (2.2-3.4e-7); one TF32 pass off by more than 1e-5 (2-4e-4)."""
    x = _bordered(1, *hw, cin, 2)
    w = _weights(cin, cout, 3)
    ref = KF.conv3x3_f32_reference(x.double(), w.double())
    packed = KF.pack_weights(w)
    scale = float(ref.abs().max())
    err = lambda out: float((out.double() - ref).abs().max()) / scale
    assert err(_emulate(x, packed)) <= 1e-6
    assert err(_emulate(x, packed, passes=1)) > 1e-5


def test_plain_version_is_the_walks_conv_and_refuses_a_recorded_call():
    x = _bordered(2, 5, 7, 64, 4)
    w = _weights(64, 128, 5)
    out = KF.conv3x3_f32(x, w)
    assert out.shape == (2, 5, 7, 128)
    assert torch.equal(out, F.conv2d(x.permute(0, 3, 1, 2), w).permute(0, 2, 3, 1))
    with pytest.raises(ValueError):
        KF.conv3x3_f32(x, w.requires_grad_(True))
    with torch.no_grad():
        assert torch.equal(KF.conv3x3_f32(x, w), out)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports ``cuda:0`` as its device, so the kernel
    wrapper's refusals are reached here."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("case", ["dtype", "cin", "kernel_size", "no_border", "packed"])
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(case):
    x, w = torch.zeros(1, 6, 6, 64), torch.zeros(128, 64, 3, 3)
    packed = torch.zeros(2, 1, 9, 2, 2, 64, 8, 4)
    err = ValueError
    if case == "dtype":
        x, err = x.double(), TypeError
    elif case == "cin":
        x, w = torch.zeros(1, 6, 6, 32), torch.zeros(128, 32, 3, 3)
    elif case == "kernel_size":
        w = torch.zeros(128, 64, 5, 5)
    elif case == "no_border":
        x = torch.zeros(1, 2, 6, 64)
    else:
        packed = packed[:1]
    with pytest.raises(err):
        KF._conv3x3_f32_cuda(x.as_subclass(_OnCard), w, packed.as_subclass(_OnCard))


def test_tile_rows_fills_the_card_where_a_finer_grid_pays():
    """On 132 SMs at batch 1, 512x683: the 1/8-resolution 256->512 and the
    decoder's 256->128 take 8-row tiles (3 waves of 128-pixel items against
    2 of 256-pixel ones), every other walk shape 16."""
    picks = {(cin, cout, h, w): KF.tile_rows(1, h, w, cout, 132)
             for cin, cout, h, w in [(64, 128, 256, 342), (256, 256, 128, 171),
                                     (256, 512, 64, 86), (512, 256, 64, 86),
                                     (256, 128, 128, 172), (128, 64, 256, 344)]}
    assert [k for k, rows in picks.items() if rows == 8] == [(256, 512, 64, 86),
                                                            (256, 128, 128, 172)]
    assert KF.tile_rows(32, 64, 64, 512, 132) == 16
    assert KF.tile_rows(1, 2, 2, 64, 132) == 8


def test_packs_are_cached_on_the_module_until_an_in_place_update():
    conv = tvgg.init_vgg_params(0, device="cpu").convs[5]
    first = tvgg.conv_pack(conv)
    assert tvgg.conv_pack(conv) is first
    assert torch.equal(first, KF.pack_weights(conv.weight.detach()))
    w16, _ = tvgg.conv_weights(conv, torch.bfloat16)
    assert tvgg.conv_pack(conv) is first and tvgg.conv_weights(conv, torch.bfloat16)[0] is w16
    with torch.no_grad():
        conv.weight.mul_(0.5)
    second = tvgg.conv_pack(conv)
    assert second is not first and torch.equal(second, KF.pack_weights(conv.weight.detach()))


@pytest.fixture(scope="module")
def nets():
    """The encoder and decoder with nonzero biases."""
    enc, dec = tvgg.init_vgg_params(0, device="cpu"), tdec.init_decoder_params(1, device="cpu")
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for net in (enc, dec):
            for conv in net.convs:
                conv.bias.copy_(torch.randn(conv.bias.shape, generator=g) * 0.05)
    return enc, dec


def _counted(fn):
    """(fn's result, the walks' counters) under a profiler."""
    P.reset_spans()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            out = fn()
        stats = P.span_stats()
    finally:
        P.reset_spans()
    return out, {k: stats.get(k, 0) for k in ("models.convs_f32_kernel", "models.epilogues")}


def _spy(monkeypatch):
    calls = []
    real = tvgg.conv3x3_f32

    def spy(x, weight, packed=None):
        calls.append((x.shape[-1], weight.shape[0]))
        return real(x, weight, packed)

    monkeypatch.setattr(tvgg, "conv3x3_f32", spy)
    return calls


@pytest.mark.parametrize("dtype,grad,frozen,taken", [
    (torch.float32, False, False, 14),    # 7 encoder convs past the head, 7 decoder convs
    (torch.float32, True, True, 14),      # grad mode, but nothing requires a gradient
    (torch.float32, True, False, 0),      # recorded: cuDNN, which has a backward
    (torch.bfloat16, False, False, 0),    # bf16: cuDNN and the conv epilogue
])
def test_which_walk_calls_take_the_kernel(nets, monkeypatch, dtype, grad, frozen, taken):
    enc, dec = nets
    if frozen:
        enc = tvgg.init_vgg_params(0, device="cpu").requires_grad_(False)
        dec = tdec.init_decoder_params(1, device="cpu").requires_grad_(False)
    calls = _spy(monkeypatch)
    x = torch.rand(1, 24, 40, 3, generator=torch.Generator().manual_seed(8))

    def run():
        with torch.set_grad_enabled(grad):
            return tdec.decoder_apply(dec, tvgg.vgg_encode(enc, x, "relu4_1", dtype), dtype)

    out, counts = _counted(run)
    assert len(calls) == taken
    assert counts == {"models.convs_f32_kernel": taken, "models.epilogues": 14}
    assert out.requires_grad == (grad and not frozen)
    if taken:
        assert calls == [(c[1], c[2]) for c in tvgg.conv_specs()[3:10]] + \
            [(c[1], c[2]) for c in tdec.conv_specs()[:-2]]


@pytest.mark.parametrize("h,w", [(24, 40), (37, 45), (50, 33)])
def test_walk_conv_shapes_are_the_shapes_a_walk_sends_to_the_kernel(nets, monkeypatch, h, w):
    """``walk_conv_shapes`` of each net, at even and odd sizes (ceil-mode
    pools), against the (Cin, Cout, H_out, W_out) of the ``conv3x3_f32``
    calls of one fp32 no-grad encode and decode."""
    enc, dec = nets
    shapes = []
    real = tvgg.conv3x3_f32

    def spy(x, weight, packed=None):
        shapes.append((x.shape[-1], weight.shape[0], x.shape[1] - 2, x.shape[2] - 2))
        return real(x, weight, packed)

    monkeypatch.setattr(tvgg, "conv3x3_f32", spy)
    x = torch.rand(1, h, w, 3, generator=torch.Generator().manual_seed(9))
    with torch.no_grad():
        f = tvgg.vgg_encode(enc, x, "relu4_1")
        n_enc = len(shapes)
        tdec.decoder_apply(dec, f)
    assert shapes[:n_enc] == tvgg.walk_conv_shapes(h, w)
    assert shapes[n_enc:] == tdec.walk_conv_shapes(*f.shape[1:3])


@pytest.mark.parametrize("dtype,grad,frozen,route", [
    (torch.float32, False, False, "kernel"),
    (torch.float32, True, True, "kernel"),     # grad mode, but nothing requires a gradient
    (torch.float32, True, False, "chain"),     # recorded
    (torch.bfloat16, False, False, "epilogue"),
    (torch.bfloat16, True, False, "chain"),
    (torch.float16, False, False, "chain"),
])
def test_walk_route_is_decided_once_from_dtype_and_recording(nets, dtype, grad, frozen, route):
    enc, dec = nets
    if frozen:
        enc = tvgg.init_vgg_params(0, device="cpu").requires_grad_(False)
    x = torch.rand(1, 8, 8, 3)
    with torch.set_grad_enabled(grad):
        assert tvgg.walk_route(x, enc.convs, dtype) == route


def test_the_head_convs_and_tensor_parallel_convs_keep_cudnn(nets, monkeypatch):
    """A walk from the image (relu1_1 asked for) leaves the 1x1 RGB conv and
    the 3->64 conv to ``F.conv2d`` and sends the 64->64 and the rest to the
    kernel; a tensor-parallel decoder's split convs keep their own conv."""
    from aip_tpu_torch.parallel.train import tensor_parallel_decoder

    enc, dec = nets
    calls = _spy(monkeypatch)
    x = torch.rand(1, 24, 40, 3, generator=torch.Generator().manual_seed(9))
    with torch.no_grad():
        feats, counts = _counted(lambda: tvgg.vgg_encode_with_intermediate(
            enc, x, tvgg.STYLE_TAPS, torch.float32))
    assert counts == {"models.convs_f32_kernel": 8, "models.epilogues": 10}
    assert calls[0] == (64, 64) and len(calls) == 8
    tp = tensor_parallel_decoder(tdec.init_decoder_params(1, device="cpu"), ["cpu", "cpu"])
    calls.clear()
    with torch.no_grad():
        _, counts = _counted(lambda: tdec.decoder_apply(tp, feats["relu4_1"]))
    assert calls == [] and counts == {"models.convs_f32_kernel": 0, "models.epilogues": 7}


def _parent_encode(enc, x):
    """The fp32 encoder to relu4_1 as the walks ran it before the kernel:
    ``F.conv2d`` on the NHWC view's NCHW permute, then the op chain."""
    h = tvgg.encode_head(x, *[t for c in enc.convs[:3] for t in (c.weight, c.bias)])
    t, i, ci = h.contiguous(), 0, 3
    layers = tvgg.VGG_LAYERS[tvgg._POOL1 + 1:]
    t = conv_epilogue_chain(t)
    i = 1
    while True:
        conv = enc.convs[ci]
        raw = F.conv2d(t.permute(0, 3, 1, 2), conv.weight).permute(0, 2, 3, 1)
        relu, tap, resample, border, i = tvgg.epilogue_ops(layers, i)
        ci += 1
        if tap == "relu4_1":
            return conv_epilogue_chain(raw, conv.bias, relu, None, False)
        t = conv_epilogue_chain(raw, conv.bias, relu, resample, border)


def _parent_decode(dec, f):
    """The fp32 decoder as the walks ran it before the kernel."""
    t = conv_epilogue_chain(f.contiguous())
    i, ci = 1, 0
    while True:
        conv = dec.convs[ci]
        raw = F.conv2d(t.permute(0, 3, 1, 2), conv.weight).permute(0, 2, 3, 1)
        relu, _, resample, border, i = tvgg.epilogue_ops(tdec.DECODER_LAYERS, i)
        ci += 1
        if ci == len(dec.convs) - 2:
            y = conv_epilogue_chain(raw, conv.bias, relu, None, False).contiguous()
            c2, c1 = dec.convs[ci], dec.convs[ci + 1]
            return tdec.decode_tail(y, c2.weight, c2.bias, c1.weight, c1.bias)
        t = conv_epilogue_chain(raw, conv.bias, relu, resample, border)


@pytest.mark.parametrize("nhw", [(1, 40, 54), (2, 35, 29)])
@pytest.mark.parametrize("net", ["encoder", "decoder"])
def test_cpu_walks_give_the_bits_of_the_parents_conv2d_chain(nets, net, nhw):
    enc, dec = nets
    g = torch.Generator().manual_seed(10)
    with torch.no_grad():
        if net == "encoder":
            x = torch.rand(*nhw, 3, generator=g)
            out, want = tvgg.vgg_encode(enc, x), _parent_encode(enc, x)
        else:
            n, h, w = nhw
            f = torch.relu(torch.randn(n, h // 8, w // 8, 512, generator=g))
            out, want = tdec.decoder_apply(dec, f), _parent_decode(dec, f)
    assert out.dtype == torch.float32 and out.shape == want.shape
    assert torch.equal(out, want)
