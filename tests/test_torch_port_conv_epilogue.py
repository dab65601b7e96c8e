"""The conv epilogue (``kernels/conv_epilogue.py``) and the model walks that
call it, on the CPU.

* The epilogue's plain version, the kernel's arithmetic and per-pixel index
  maps, equals the PyTorch op chain it replaces (``conv_epilogue_chain``:
  bias add, ReLU, ceil-mode max pool or nearest upsample, reflect pad) bit
  for bit, in every mode.
* ``vgg_encode_with_intermediate`` and ``decoder_apply`` give the same bits
  whether autograd records the call (the op chain) or not (in bf16, one
  epilogue a conv; fp32 keeps the chain).
* A recorded call runs no epilogue, and its gradients are those of the
  chain with the bias inside ``F.conv2d``; which calls take the epilogue,
  and the counters they leave under a profiler.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from aip_tpu_torch.kernels import conv_epilogue as E
from aip_tpu_torch.models import decoder as tdec
from aip_tpu_torch.models import vgg as tvgg
from aip_tpu_torch.utils import profiling as P

torch.set_num_threads(2)

# mode -> (bias, relu, resample, border)
MODES = {
    "pad": (True, True, None, True),
    "pool_pad": (True, True, "pool", True),
    "up_pad": (True, True, "up", True),
    "pad_only": (False, False, None, True),
    "no_border": (True, True, None, False),
    "pool_only_pad": (False, False, "pool", True),
}


def _raw(seed, shape, dtype):
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.standard_normal(shape).astype(np.float32)).to(dtype)


@pytest.mark.parametrize("hw", [(8, 12), (7, 9), (3, 5)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mode", list(MODES))
def test_plain_version_equals_the_op_chain(mode, dtype, hw):
    has_bias, relu, resample, border = MODES[mode]
    raw = _raw(0, (2,) + hw + (24,), dtype)
    bias = _raw(1, (24,), dtype).float() if has_bias else None
    out = E.conv_epilogue_reference(raw, bias, relu, resample, border)
    want = E.conv_epilogue_chain(raw, bias, relu, resample, border)
    assert out.dtype == dtype and out.is_contiguous()
    assert torch.equal(out, want)
    assert torch.equal(E.conv_epilogue(raw, bias, relu, resample, border), want)


def test_plain_version_propagates_nan_as_the_chain():
    raw = _raw(2, (1, 5, 7, 8), torch.float32)
    raw[0, 1, 2, 3] = float("nan")
    raw[0, 4, 6, 0] = float("nan")
    bias = _raw(3, (8,), torch.float32)
    for resample in (None, "pool", "up"):
        out = E.conv_epilogue_reference(raw, bias, True, resample, True)
        want = E.conv_epilogue_chain(raw, bias, True, resample, True)
        assert torch.equal(out.isnan(), want.isnan())
        assert torch.equal(out.nan_to_num(), want.nan_to_num())


@pytest.mark.parametrize("case", ["grad_input", "bad_dtype", "small_border", "bad_bias",
                                  "bad_resample"])
def test_epilogue_refuses_what_it_does_not_take(case):
    raw = _raw(4, (1, 4, 4, 8), torch.float32)
    kw = {}
    if case == "grad_input":
        raw.requires_grad_(True)
    elif case == "bad_dtype":
        raw = raw.half()
    elif case == "small_border":
        raw = raw[:, :2, :3]
        kw = {"resample": "pool"}
    elif case == "bad_bias":
        kw = {"bias": torch.zeros(7)}
    else:
        kw = {"resample": "bilinear"}
    with pytest.raises((ValueError, TypeError)):
        E.conv_epilogue(raw, **kw)


@pytest.fixture(scope="module")
def nets():
    return tvgg.init_vgg_params(0, device="cpu"), tdec.init_decoder_params(1, device="cpu")


def _biased(nets):
    """The nets with nonzero biases (He init leaves them at zero), so the
    bias add's rounding shows."""
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for net in nets:
            for conv in net.convs:
                conv.bias.copy_(torch.randn(conv.bias.shape, generator=g) * 0.05)
    return nets


@pytest.fixture(scope="module")
def biased_nets():
    return _biased((tvgg.init_vgg_params(0, device="cpu"),
                    tdec.init_decoder_params(1, device="cpu")))


TAPS = {
    "relu4_1": ("relu4_1",),
    "style_taps": tvgg.STYLE_TAPS,
    "taps_before_pools": ("relu1_2", "relu2_2", "relu3_4", "relu4_1"),
    "past_relu4_1": ("relu2_1", "relu5_1"),
}


@pytest.mark.parametrize("nhw", [(1, 40, 54), (2, 32, 32)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("net", list(TAPS) + ["decoder"])
def test_walks_give_the_same_bits_recorded_or_not(biased_nets, net, dtype, nhw):
    enc, dec = biased_nets
    g = torch.Generator().manual_seed(6)
    if net == "decoder":
        n, h, w = nhw
        x = torch.relu(torch.randn(n, h // 8, w // 8, 512, generator=g))
        with torch.no_grad():
            fused = {"out": tdec.decoder_apply(dec, x, dtype)}
        chain = {"out": tdec.decoder_apply(dec, x, dtype)}
    else:
        x = torch.rand(*nhw, 3, generator=g)
        with torch.no_grad():
            fused = tvgg.vgg_encode_with_intermediate(enc, x, TAPS[net], dtype)
        chain = tvgg.vgg_encode_with_intermediate(enc, x, TAPS[net], dtype)
    assert fused.keys() == chain.keys()
    for k in fused:
        assert chain[k].requires_grad and not fused[k].requires_grad
        assert fused[k].dtype == dtype
        assert torch.equal(fused[k], chain[k].detach()), k


def _spy(monkeypatch):
    calls = []
    real = E.conv_epilogue

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(tvgg, "conv_epilogue", spy)
    monkeypatch.setattr(tdec, "conv_epilogue", spy)
    return calls


def _parent_chain_loss(enc, dec, x):
    """The encoder to relu4_1 and the decoder as the walks ran them before
    the epilogue: ``F.conv2d`` with its bias, OIHW weights, fp32."""
    h = tvgg.encode_head(x, *[t for c in enc.convs[:3] for t in (c.weight, c.bias)])
    t = h.permute(0, 3, 1, 2)
    ci = 3
    for layer in tvgg.VGG_LAYERS[tvgg._POOL1 + 1:]:
        if layer[0] == "conv":
            t = F.conv2d(F.pad(t, (1, 1, 1, 1), mode="reflect"), enc.convs[ci].weight,
                         enc.convs[ci].bias)
            ci += 1
        elif layer[0] == "pool":
            t = F.max_pool2d(t, 2, 2, ceil_mode=True)
        elif layer[0] == "relu":
            t = torch.relu(t)
            if layer[1] == "relu4_1":
                break
    for ci, layer in enumerate([l for l in tdec.DECODER_LAYERS if l[0] == "conv"][:-2]):
        conv = dec.convs[ci]
        t = torch.relu(F.conv2d(F.pad(t, (1, 1, 1, 1), mode="reflect"), conv.weight, conv.bias))
        if ci in (0, 4):
            t = F.interpolate(t, scale_factor=2, mode="nearest")
    c2, c1 = dec.convs[-2], dec.convs[-1]
    y = tdec.decode_tail(t.permute(0, 2, 3, 1).contiguous(), c2.weight, c2.bias, c1.weight,
                         c1.bias)
    return y.square().mean()


def test_a_recorded_call_runs_no_epilogue_and_keeps_its_gradients(biased_nets, monkeypatch):
    enc, dec = biased_nets
    calls = _spy(monkeypatch)
    x = torch.rand(1, 24, 40, 3, generator=torch.Generator().manual_seed(7))
    feat = tvgg.vgg_encode(enc, x, "relu4_1", torch.float32)
    loss = tdec.decoder_apply(dec, feat, torch.float32).square().mean()
    assert calls == []
    # The encoder's convs to relu4_1 (the head's 3 and 7 more) and the decoder's.
    params = [p for convs in (enc.convs[:10], dec.convs) for p in convs.parameters()]
    grads = torch.autograd.grad(loss, params)
    want = torch.autograd.grad(_parent_chain_loss(enc, dec, x), params)
    for g, gw in zip(grads, want):
        assert float((g - gw).abs().max()) <= 1e-5 * max(float(gw.abs().max()), 1e-12)


@pytest.mark.parametrize("dtype,grad,frozen,epilogues", [
    (torch.bfloat16, False, False, 16),   # one a conv past the head, one a net's input border
    (torch.bfloat16, True, True, 16),     # grad mode, but nothing requires a gradient
    (torch.bfloat16, True, False, 0),     # recorded
    (torch.float32, False, False, 0),     # fp32 keeps the chain (cuDNN's fp32 convs are NCHW)
])
def test_which_calls_take_the_epilogue(nets, monkeypatch, dtype, grad, frozen, epilogues):
    enc, dec = nets
    if frozen:
        enc = tvgg.init_vgg_params(0, device="cpu").requires_grad_(False)
        dec = tdec.init_decoder_params(1, device="cpu").requires_grad_(False)
    calls = _spy(monkeypatch)
    x = torch.rand(1, 16, 24, 3, generator=torch.Generator().manual_seed(8))
    with torch.set_grad_enabled(grad):
        out = tdec.decoder_apply(dec, tvgg.vgg_encode(enc, x, "relu4_1", dtype), dtype)
    assert len(calls) == epilogues
    assert out.requires_grad == (grad and not frozen)


@pytest.mark.parametrize("dtype,grad,fused", [(torch.bfloat16, False, 14),
                                              (torch.bfloat16, True, 0),
                                              (torch.float32, False, 0)])
def test_walks_count_their_epilogues_under_a_profiler(nets, dtype, grad, fused):
    enc, dec = nets
    x = torch.rand(1, 16, 24, 3, generator=torch.Generator().manual_seed(9))
    P.reset_spans()
    try:
        with profile(activities=[ProfilerActivity.CPU]), torch.set_grad_enabled(grad):
            feat = tvgg.vgg_encode(enc, x, "relu4_1", dtype)
            tdec.decoder_apply(dec, feat, dtype)
        stats = P.span_stats()
    finally:
        P.reset_spans()
    assert stats["models.epilogues"] == 14
    assert stats.get("models.epilogues_fused", 0) == fused


def test_conv_weights_are_cached_per_dtype_and_follow_updates(nets):
    conv = tvgg.init_vgg_params(0, device="cpu").convs[5]
    w16, b16 = tvgg.conv_weights(conv, torch.bfloat16)
    assert w16.dtype == torch.bfloat16 and b16.dtype == torch.float32
    assert w16.is_contiguous(memory_format=torch.channels_last)
    assert tvgg.conv_weights(conv, torch.bfloat16)[0] is w16
    w32, _ = tvgg.conv_weights(conv, torch.float32)
    assert torch.equal(w32, conv.weight.detach())
    assert tvgg.conv_weights(conv, torch.bfloat16)[0] is w16
    with torch.no_grad():
        conv.weight.mul_(2)
    w16b, _ = tvgg.conv_weights(conv, torch.bfloat16)
    assert w16b is not w16 and torch.equal(w16b, (conv.weight.detach() * 1).to(torch.bfloat16))
