"""The port's CUDA kernels on the card, against their plain versions.

Every test here is marked ``cuda`` and skips itself where CUDA is absent.
The file imports no JAX, so it also runs on a machine that has none:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

Tolerances, relative to the largest reference value: fp32 kernel against
the fp32 plain version with TF32 off, 1e-4 (sums in another order), and
against the plain version run in float64, 1.5e-6 (the kernels' three TF32
products and a fresh partial sum a tap keep fp32 accuracy, 5-7e-7 there;
one partial over all 9 taps reads 2.5-5.1e-6 and one TF32 pass 3e-4); bf16
kernel against the plain version run in fp32 on the same bf16-rounded
inputs and weights, 1e-2 (the kernel rounds its output to bf16); the
bf16 (tensor-core) kernels against their bf16 plain versions, 2^-7 (one
bf16 ulp at the largest value) with a mean of at most 1e-4: both round their
output to bf16, so an fp32 sum in another order can land one ulp away, and
a bf16 tie of the intermediate can flip (one such flip among the 180 values
of a 6x10 output is a mean of 1.1e-5).
"""

import math

import numpy as np
import pytest
import torch

from aip_tpu_torch.kernels import adain_head as K
from aip_tpu_torch.models import decoder as tdec
from aip_tpu_torch.models import vgg as tvgg


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, shape, scale):
    return torch.from_numpy((gen.standard_normal(shape) * scale).astype(np.float32))


@pytest.fixture
def weights(cuda):
    """OIHW weights of the head (conv0 1x1, conv1 3->64, conv2 64->64) and
    of the tail (conv 64->64, conv 64->3), on the card."""
    g = np.random.default_rng(0)
    enc = [_randn(g, (3, 3, 1, 1), .5), _randn(g, (3,), .1), _randn(g, (64, 3, 3, 3), .2),
           _randn(g, (64,), .1), _randn(g, (64, 64, 3, 3), .05), _randn(g, (64,), .1)]
    dec = [_randn(g, (64, 64, 3, 3), .05), _randn(g, (64,), .1), _randn(g, (3, 64, 3, 3), .05),
           _randn(g, (3,), .1)]
    return [t.to(cuda) for t in enc], [t.to(cuda) for t in dec]


def _max_rel_err(out, ref):
    return float((out.detach().float() - ref).abs().max() / ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("hw", [(64, 96), (37, 45), (2, 2), (3, 5)])
def test_kernels_match_plain(cuda, weights, dtype, tol, hw):
    ew, dw = weights
    g = np.random.default_rng(1)
    rnd = lambda t: t.to(dtype).float()
    x = torch.from_numpy(g.random((2,) + hw + (3,)).astype(np.float32)).to(cuda).to(dtype)
    out = K.encode_head(x, *ew)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (2, (hw[0] + 1) // 2, (hw[1] + 1) // 2, 64)
    assert _max_rel_err(out, K.encode_head_reference(x.float(), *map(rnd, ew))) <= tol
    y = torch.relu(_randn(g, (2, max(hw[0] // 2, 1), max(hw[1] // 2, 1), 64), 1.0))
    y = y.to(cuda).to(dtype)
    out = K.decode_tail(y, *dw)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (2, 2 * y.shape[1], 2 * y.shape[2], 3)
    assert _max_rel_err(out, K.decode_tail_reference(y.float(), *map(rnd, dw))) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w", [(2, 64, 96), (2, 37, 45), (2, 2, 2), (2, 3, 5), (3, 17, 33)])
def test_tensor_core_kernels_match_bf16_plain(cuda, weights, b, h, w):
    """The head on x [b,h,w,3] and the tail on y [b,h,w,64], each one
    tensor-core launch, within one bf16 ulp of the largest value of the
    bf16 plain version (2^-7 of it), with a mean error of at most 1e-4 of
    it."""
    ew, dw = weights
    g = np.random.default_rng(3)
    x = torch.from_numpy(g.random((b, h, w, 3)).astype(np.float32)).to(cuda).bfloat16()
    y = torch.relu(_randn(g, (b, h, w, 64), 1.0)).to(cuda).bfloat16()
    K.reset_launch_counts()
    enc = K.encode_head(x, *ew)
    dec = K.decode_tail(y, *dw)
    torch.cuda.synchronize()
    assert K.route_launch_counts()["bf16"] == K.launch_counts() == {"encode_head": 1,
                                                                    "decode_tail": 1}
    for out, ref in ((enc, K.encode_head_bf16_reference(x, *ew)),
                     (dec, K.decode_tail_bf16_reference(y, *dw))):
        assert out.dtype == ref.dtype == torch.bfloat16 and out.shape == ref.shape
        err = (out.float() - ref.float()).abs()
        scale = float(ref.float().abs().max())
        assert float(err.max()) <= 2 ** -7 * scale and float(err.mean()) <= 1e-4 * scale


@pytest.mark.cuda
def test_bf16_models_on_the_card_take_the_tensor_core_route(cuda):
    """vgg_encode + decoder_apply in bf16 raise route_launch_counts()["bf16"]
    by one each; in fp32 they launch the fp32 kernels and leave it alone."""
    vgg, dec = tvgg.init_vgg_params(0, cuda), tdec.init_decoder_params(1, cuda)
    x = torch.rand(2, 40, 56, 3, generator=torch.Generator().manual_seed(4)).to(cuda)
    for dtype, route in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        routes, total = K.route_launch_counts(), K.launch_counts()
        out = tdec.decoder_apply(dec, tvgg.vgg_encode(vgg, x, compute_dtype=dtype),
                                 compute_dtype=dtype)
        torch.cuda.synchronize()
        assert K.route_launch_counts() == {
            r: {k: n + (r == route) for k, n in c.items()} for r, c in routes.items()}
        assert K.launch_counts() == {k: n + 1 for k, n in total.items()}
        assert out.dtype == dtype and out.shape == (2, 40, 56, 3)
        assert bool(torch.isfinite(out.float()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w", [(2, 2, 2), (2, 3, 5), (2, 37, 45), (3, 17, 33),
                                   (1, 512, 683)])
def test_fp32_kernels_hold_float64(cuda, weights, b, h, w):
    """The head on x [b,h,w,3] and the tail on y [b,ceil(h/2),ceil(w/2),64],
    each one launch on the fp32 route, within 1.5e-6 of the largest value
    of the plain version run in float64."""
    ew, dw = weights
    g = np.random.default_rng(4)
    x = torch.from_numpy(g.random((b, h, w, 3)).astype(np.float32)).to(cuda)
    y = torch.relu(_randn(g, (b, (h + 1) // 2, (w + 1) // 2, 64), 1.0)).to(cuda)
    K.reset_launch_counts()
    enc = K.encode_head(x, *ew)
    dec = K.decode_tail(y, *dw)
    torch.cuda.synchronize()
    assert K.route_launch_counts()["fp32"] == K.launch_counts() == {"encode_head": 1,
                                                                    "decode_tail": 1}
    errs = {}
    for name, out, ref in (
            ("head", enc, K.encode_head_reference(x.double(), *[t.double() for t in ew])),
            ("tail", dec, K.decode_tail_reference(y.double(), *[t.double() for t in dw]))):
        assert out.dtype == torch.float32 and out.shape == ref.shape
        errs[name] = _max_rel_err(out.double(), ref)
    assert max(errs.values()) <= 1.5e-6, errs


@pytest.mark.cuda
def test_fp32_kernels_take_batches_above_65535(cuda, weights):
    """The persistent grid walks (image, tile) items, so no grid dimension
    caps the batch: 65,536 images of the smallest sizes, every one right."""
    ew, dw = weights
    g = np.random.default_rng(5)
    x = torch.from_numpy(g.random((65536, 2, 3, 3)).astype(np.float32)).to(cuda)
    y = torch.relu(_randn(g, (65536, 1, 2, 64), 1.0)).to(cuda)
    enc = K.encode_head(x, *ew)
    dec = K.decode_tail(y, *dw)
    torch.cuda.synchronize()
    assert _max_rel_err(enc, K.encode_head_reference(x, *ew)) <= 1e-4
    assert _max_rel_err(dec, K.decode_tail_reference(y, *dw)) <= 1e-4


@pytest.mark.cuda
def test_fp32_packs_are_cached_on_the_card(cuda):
    """A second fp32 call packs nothing; an in-place update of a weight
    repacks, and the kernel then follows the new weights."""
    vgg, dec = tvgg.init_vgg_params(0, cuda), tdec.init_decoder_params(1, cuda)
    head = [t for c in vgg.convs[:3] for t in (c.weight, c.bias)]
    tail = [t for c in dec.convs[-2:] for t in (c.weight, c.bias)]
    x = torch.rand(1, 20, 24, 3, generator=torch.Generator().manual_seed(6)).to(cuda)
    y = torch.relu(torch.randn(1, 10, 12, 64, generator=torch.Generator().manual_seed(7))).to(cuda)
    K.encode_head(x, *head)
    K.decode_tail(y, *tail)
    packs = [K.packed_weights("encode_head_fp32", *head), K.packed_weights("decode_tail_fp32", *tail)]
    K.encode_head(x, *head)
    K.decode_tail(y, *tail)
    assert K.packed_weights("encode_head_fp32", *head) is packs[0]
    assert K.packed_weights("decode_tail_fp32", *tail) is packs[1]
    with torch.no_grad():
        vgg.convs[2].weight.mul_(0.5)
    out = K.encode_head(x, *head)
    torch.cuda.synchronize()
    assert K.packed_weights("encode_head_fp32", *head) is not packs[0]
    ref = K.encode_head_reference(x, *[t.detach() for t in head])
    assert _max_rel_err(out, ref) <= 1e-4


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda, weights):
    ew, dw = weights
    bad_inputs = [
        (TypeError, torch.zeros(1, 8, 8, 3, device=cuda, dtype=torch.float16)),
        (ValueError, torch.zeros(1, 8, 8, 4, device=cuda)),
        (ValueError, torch.zeros(1, 1, 8, 3, device=cuda)),
        (ValueError, torch.zeros(1, 8, 3, 8, device=cuda).permute(0, 1, 3, 2)),
    ]
    for err, x in bad_inputs:
        with pytest.raises(err):
            K.encode_head(x, *ew)
    with pytest.raises(ValueError):
        K.encode_head(torch.zeros(1, 8, 8, 3, device=cuda), *ew[:4], ew[4][:32], ew[5])
    with pytest.raises(ValueError):
        K.decode_tail(torch.zeros(1, 4, 4, 32, device=cuda), *dw)
    with pytest.raises(ValueError):
        K.decode_tail(torch.zeros(1, 4, 4, 64, device=cuda), *[t.cpu() for t in dw])


@pytest.mark.cuda
def test_models_on_the_card_go_through_the_kernels(cuda):
    """vgg_encode and decoder_apply launch one kernel each on a CUDA tensor,
    and agree with the same modules on the CPU (plain path)."""
    vgg, dec = tvgg.init_vgg_params(0, cuda), tdec.init_decoder_params(1, cuda)
    x = torch.rand(1, 37, 45, 3, generator=torch.Generator().manual_seed(2))
    K.reset_launch_counts()
    f = tvgg.vgg_encode(vgg, x.to(cuda))
    out = tdec.decoder_apply(dec, f)
    assert K.launch_counts() == {"encode_head": 1, "decode_tail": 1}
    ref_f = tvgg.vgg_encode(vgg.cpu(), x)
    ref = tdec.decoder_apply(dec.cpu(), ref_f)
    assert _max_rel_err(f.cpu(), ref_f) <= 1e-4
    assert _max_rel_err(out.cpu(), ref) <= 1e-4


@pytest.mark.cuda
def test_fp32_models_hold_fp32_under_pytorchs_default_tf32_flags(cuda):
    """With cuDNN's TF32 on, as PyTorch starts, the fp32 encoder and decoder
    still agree with the CPU at 1e-4 of the largest value (their convs run
    under ``fp32_convs``), and the process's flag is as it was after them."""
    vgg, dec = tvgg.init_vgg_params(0, cuda), tdec.init_decoder_params(1, cuda)
    x = torch.rand(1, 64, 72, 3, generator=torch.Generator().manual_seed(8))
    torch.backends.cudnn.allow_tf32 = True
    try:
        out = tdec.decoder_apply(dec, tvgg.vgg_encode(vgg, x.to(cuda)))
        torch.cuda.synchronize()
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = False
    ref = tdec.decoder_apply(dec.cpu(), tvgg.vgg_encode(vgg.cpu(), x))
    assert _max_rel_err(out.cpu(), ref) <= 1e-4


@pytest.mark.cuda
def test_fp32_convs_outside_adain_hold_fp32_under_pytorchs_default_tf32_flags(cuda, monkeypatch):
    """With cuDNN's TF32 on, as PyTorch starts, the fp32 convs of the video
    path run in fp32 (``fp32_convs``): Lucas-Kanade and Farneback flows of
    two moved frames within 1e-4 px mean abs of the CPU's, the depth proxy
    within 1e-5 max abs, and one magenta frame of the committed checkpoint
    within 1e-6 mean abs (phase 24's magenta gate); the process's flag is as
    it was after them. The control: with ``fp32_convs`` undone in those
    modules, cuDNN's TF32 moves the magenta frame past 1e-6, so the gate
    catches the fault it guards against."""
    import contextlib
    from pathlib import Path

    from aip_tpu_torch.models import depthnet, magenta, mobilenet
    from aip_tpu_torch.ops import farneback, flow

    g = np.random.default_rng(30)
    a = torch.from_numpy(g.random((2, 64, 64, 3)).astype(np.float32))
    a = torch.nn.functional.avg_pool2d(a.permute(0, 3, 1, 2), 5, 1, 2).permute(0, 2, 3, 1)
    b = torch.roll(a, shifts=(1, 2), dims=(1, 2)).contiguous()
    style = torch.from_numpy(g.random((64, 64, 3)).astype(np.float32))
    ckpt = Path(__file__).resolve().parent.parent / "docs" / "examples" / "magenta" / \
        "magenta_distilled.npz"

    def run(dev):
        with torch.no_grad():
            return (flow.estimate_flow(a.to(dev), b.to(dev)).cpu(),
                    farneback.estimate_flow_farneback(a.to(dev), b.to(dev)).cpu(),
                    depthnet.estimate_proximity(a[0].to(dev)).cpu(),
                    magenta.stylize(magenta.load_magenta_npz(ckpt, device=dev), a[:1].to(dev),
                                    style.to(dev)).cpu())

    def on_card_with_tf32():
        torch.backends.cudnn.allow_tf32 = True
        try:
            out = run(cuda)
            torch.cuda.synchronize()
            assert torch.backends.cudnn.allow_tf32
        finally:
            torch.backends.cudnn.allow_tf32 = False
        return out

    lk, fb, prox, frame = on_card_with_tf32()
    lk_c, fb_c, prox_c, frame_c = run("cpu")
    assert float((lk - lk_c).abs().mean()) <= 1e-4
    assert float((fb - fb_c).abs().mean()) <= 1e-4
    assert float((prox - prox_c).abs().max()) <= 1e-5
    assert float((frame - frame_c).abs().mean()) <= 1e-6
    for mod in (flow, farneback, magenta, mobilenet):
        monkeypatch.setattr(mod, "fp32_convs", contextlib.nullcontext)
    *_, frame_tf32 = on_card_with_tf32()
    assert float((frame_tf32 - frame_c).abs().mean()) > 1e-6


@pytest.mark.cuda
def test_depth_proxy_repeats_within_its_gate_with_the_allocator_empty_and_full(cuda):
    """The depth proxy (the default depth of ``adain_inference`` and of the
    pixel-art page) 24 times in one process under PyTorch's default TF32
    flags, on new shapes with the 9-tap blur, with the caching allocator
    emptied and with all but 64 MiB of the card held: each within 1e-5 max
    abs of the CPU, the gate of the test above."""
    from aip_tpu_torch.models import depthnet

    for i in range(24):
        g = np.random.default_rng(200 + i)
        img = torch.from_numpy(g.random((64 + i % 16, 64 + (7 * i) % 16, 3)).astype(np.float32))
        ref = depthnet.estimate_proximity(img)
        torch.cuda.empty_cache()
        held = None
        if i % 2:
            free = torch.cuda.mem_get_info()[0]
            held = torch.empty(free - (64 << 20), dtype=torch.uint8, device=cuda)
        torch.backends.cudnn.allow_tf32 = True
        try:
            out = depthnet.estimate_proximity(img.to(cuda)).cpu()
        finally:
            torch.backends.cudnn.allow_tf32 = False
            del held
            torch.cuda.empty_cache()  # cuBLAS's handles need memory outside the cache
        assert float((out - ref).abs().max()) <= 1e-5, (i, img.shape)


@pytest.mark.cuda
def test_backward_recomputes_through_the_plain_version(cuda, weights):
    ew, _ = weights
    x = torch.rand(1, 12, 14, 3, device=cuda, requires_grad=True)
    g = torch.randn(1, 6, 7, 64, device=cuda)
    (gk,) = torch.autograd.grad(K.encode_head(x, *ew), x, g)
    (gp,) = torch.autograd.grad(K.encode_head_reference(x, *ew), x, g)
    torch.testing.assert_close(gk, gp, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# Macro-block compositors (kernels/composite.py)
# ---------------------------------------------------------------------------

def _raw_rows(g, n, bs, mtw, mth):
    """Packed [n, 16] rows whose means fall over a mth x mtw grid of bs-px
    blocks: [mx, my, conic a, b, c, log(opacity), r, g, b, pad x7]."""
    raw = np.zeros((n, 16), np.float32)
    raw[:, 0] = g.random(n) * mtw * bs
    raw[:, 1] = g.random(n) * mth * bs
    sig = g.random(n) * 6 + 1.5
    raw[:, 2] = 1.0 / sig ** 2
    raw[:, 3] = (g.random(n) - 0.5) * 0.2 / sig ** 2
    raw[:, 4] = 1.0 / (sig * (g.random(n) + 0.5)) ** 2
    raw[:, 5] = np.log(g.random(n) * 0.9 + 0.05)
    raw[:, 6:9] = g.random((n, 3))
    return raw


def _assert_composite_close(out, ref):
    """max abs <= 1e-3 * max(1, max|ref|) and mean abs <= 1e-5: the kernel's
    sequential product and the reference's exp(cumsum(log1p)) round
    differently, so the 1e-4 transmittance cutoff can flip at single
    pixels."""
    assert out.shape == ref.shape
    err = (out.cpu() - ref.cpu()).abs()
    assert float(err.max()) <= 1e-3 * max(1.0, float(ref.abs().max())), float(err.max())
    assert float(err.mean()) <= 1e-5, float(err.mean())


@pytest.mark.cuda
@pytest.mark.parametrize("bs", [16, 32, 64])
def test_composite_kernels_match_plain_on_edge_cases(cuda, bs):
    """Both compositors against their plain versions: an empty block,
    counts that are not multiples of 64, segments that start mid-group, a
    count above kc (clipped), and a block that saturates after a few rows
    (the block-wide early exit)."""
    from aip_tpu_torch.kernels import composite as C

    g = np.random.default_rng(3)
    mtw, mth, kc = 3, 2, 200
    n_blocks = mtw * mth
    rows = _raw_rows(g, 1400, bs, mtw, mth)
    # Block 4's segment opens with ten wide opaque splats.
    bx, by = (4 % mtw + 0.5) * bs, (4 // mtw + 0.5) * bs
    rows[700:710, 0:6] = [bx, by, 1e-4, 0.0, 1e-4, 0.0]
    starts = np.array([0, 5, 250, 450, 700, 1000], np.int32)     # 5, 250, 450: mid-group
    counts = np.array([0, 37, 200, 129, 200, 260], np.int32)     # 260 > kc: clipped
    bg = torch.tensor([0.2, 0.1, 0.3], device=cuda)
    table, st, ct = (torch.from_numpy(a).to(cuda) for a in (rows, starts, counts))
    C.reset_launch_counts()
    out = C.composite_macro_mxu_seg(table, st, ct, bg, n_blocks=n_blocks, kc=kc, bs=bs, mtw=mtw)
    torch.cuda.synchronize()
    ref = C.composite_macro_mxu_seg_reference(table, st, ct, bg, n_blocks, kc, bs, mtw)
    _assert_composite_close(out, ref)
    torch.testing.assert_close(out[0, :, 0].cpu(), bg.cpu()[:, None].expand(3, bs * bs))

    window = C._segment_window(table, st, torch.clamp(ct, max=kc), kc).contiguous()
    win_counts = torch.clamp(ct, max=kc)
    out_w = C.composite_macro_mxu(window, win_counts, bg, bs=bs, mtw=mtw)
    torch.cuda.synchronize()
    _assert_composite_close(out_w, C.composite_macro_mxu_reference(window, win_counts, bg, bs,
                                                                   mtw))
    _assert_composite_close(out_w, out)
    assert C.launch_counts() == {"composite_macro_mxu_seg": 1, "composite_macro_mxu": 1,
                                 "composite_tiles": 0, "composite_from_macro": 0,
                                 "composite_macro_blocks": 0}
    walked = C.walked_rows(window, win_counts, bg, bs, mtw)
    assert walked < int(win_counts.sum())  # block 4 stopped early


@pytest.mark.cuda
def test_composite_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from aip_tpu_torch.kernels import composite as C

    raw = torch.zeros(2, 64, 16, device=cuda)
    counts = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        C.composite_macro_mxu(raw, counts.long(), torch.zeros(3), bs=64, mtw=2)
    with pytest.raises(ValueError):
        C.composite_macro_mxu(raw, counts, torch.zeros(3), bs=48, mtw=2)
    with pytest.raises(ValueError):
        C.composite_macro_mxu(raw[..., :9].contiguous(), counts, torch.zeros(3), bs=64, mtw=2)
    with pytest.raises(ValueError):
        C.composite_macro_mxu_seg(raw[0], counts.cpu(), counts, torch.zeros(3), n_blocks=2,
                                  kc=64, bs=64, mtw=2)
    with pytest.raises(ValueError):   # a layout the kernel is not built for
        C.composite_macro_mxu(raw, counts, torch.zeros(3), bs=32, mtw=2, layout=(16, 2))
    with pytest.raises(ValueError):
        C.composite_macro_mxu(raw, counts, torch.zeros(3), bs=64, mtw=2, layout=(16, 1))
    table = raw[0]
    idx = torch.zeros(2, 64, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):    # the index is int32
        C.composite_macro_mxu_indexed(table, idx.long(), counts, torch.zeros(3), bs=64, mtw=2)
    with pytest.raises(ValueError):   # the index lies on the table's card
        C.composite_macro_mxu_indexed(table, idx.cpu(), counts, torch.zeros(3), bs=64, mtw=2)
    with pytest.raises(ValueError):   # the table is [N, 16]
        C.composite_macro_mxu_seg_indexed(raw, idx[0], counts, counts, torch.zeros(3),
                                          n_blocks=2, kc=64, bs=64, mtw=2)


def _seg_case(cuda, bs, kc=200):
    """The edge case's table, starts and counts on the card, mtw 3 x mth 2."""
    g = np.random.default_rng(3)
    mtw, mth = 3, 2
    rows = _raw_rows(g, 1400, bs, mtw, mth)
    rows[700:710, 0:6] = [(4 % mtw + 0.5) * bs, (4 // mtw + 0.5) * bs, 1e-4, 0.0, 1e-4, 0.0]
    starts = np.array([0, 5, 250, 450, 700, 1000], np.int32)
    counts = np.array([0, 37, 200, 129, 200, 260], np.int32)
    return [torch.from_numpy(a).to(cuda) for a in (rows, starts, counts)] + [mtw, kc]


@pytest.mark.cuda
@pytest.mark.parametrize("bs", [16, 32, 64])
def test_composite_kernels_saturate_with_a_background(cuda, bs):
    """bg != 0 and blocks that saturate early: block 0 behind four wide
    opaque splats (every sub-tile saturates within the first group, so the
    block leaves at row 64 and the background sees T there), block 1 with
    opaque splats over its left half only (no exit: its right half walks
    on); against the plain version."""
    from aip_tpu_torch.kernels import composite as C

    g = np.random.default_rng(8)
    mtw, kc = 2, 256
    window = np.stack([_raw_rows(g, kc, bs, 1, 1) for _ in range(2)])
    window[1, :, 0] += bs
    window[0, :4, 0:6] = [bs / 2, bs / 2, 1e-5, 0.0, 1e-5, 0.0]
    window[1, :6, 0:6] = [bs + bs / 4, bs / 2, 4.0 / bs ** 2, 0.0, 1e-5, 0.0]
    counts = torch.tensor([kc, kc], dtype=torch.int32, device=cuda)
    raw = torch.from_numpy(window).to(cuda)
    bg = torch.tensor([0.7, 0.2, 0.9], device=cuda)
    out = C.composite_macro_mxu(raw, counts, bg, bs=bs, mtw=mtw)
    torch.cuda.synchronize()
    ref = C.composite_macro_mxu_reference(raw, counts, bg, bs, mtw)
    _assert_composite_close(out, ref)
    walked = C._windowed(raw, counts, bg, bs, mtw, 0, 1 << 31)[1]
    assert int(walked[0]) == 64 and int(walked[1]) > 64


@pytest.mark.cuda
@pytest.mark.parametrize("bs", [16, 32, 64])
def test_composite_segment_longer_than_kc(cuda, bs):
    """A segment of 3 kc + 5 rows walks its first kc, as the plain version
    clips it; the windowed walk of the same kc rows agrees."""
    from aip_tpu_torch.kernels import composite as C

    g = np.random.default_rng(12)
    kc = 100
    rows = torch.from_numpy(_raw_rows(g, 3 * kc + 5, bs, 1, 1)).to(cuda)
    starts = torch.tensor([0], dtype=torch.int32, device=cuda)
    counts = torch.tensor([3 * kc + 5], dtype=torch.int32, device=cuda)
    bg = torch.tensor([0.3, 0.3, 0.3], device=cuda)
    out = C.composite_macro_mxu_seg(rows, starts, counts, bg, n_blocks=1, kc=kc, bs=bs, mtw=1)
    torch.cuda.synchronize()
    _assert_composite_close(out, C.composite_macro_mxu_seg_reference(rows, starts, counts, bg,
                                                                     1, kc, bs, 1))
    clipped = torch.tensor([kc], dtype=torch.int32, device=cuda)
    out_w = C.composite_macro_mxu(rows[:kc].reshape(1, kc, 16).contiguous(), clipped, bg, bs=bs,
                                  mtw=1)
    assert torch.equal(out_w, out)


@pytest.mark.cuda
@pytest.mark.parametrize("bs", [16, 32, 64])
def test_composite_indexed_entries_equal_gather_then_kernel(cuda, bs):
    """The kernel reading rows through gid_s or macro_idx writes the planes
    of the kernel on the gathered rows (max abs 0), for both walks; an
    index outside the table is an empty row."""
    from aip_tpu_torch.kernels import composite as C

    table, starts, counts, mtw, kc = _seg_case(cuda, bs)
    g = np.random.default_rng(5)
    perm = torch.from_numpy(g.permutation(table.shape[0]).astype(np.int32)).to(cuda)
    shuffled = table[perm.long()].contiguous()
    inverse = torch.argsort(perm.long()).to(torch.int32)        # shuffled[inverse] = table
    bg = torch.tensor([0.2, 0.1, 0.3], device=cuda)
    C.reset_launch_counts()
    got = C.composite_macro_mxu_seg_indexed(shuffled, inverse, starts, counts, bg, n_blocks=6,
                                            kc=kc, bs=bs, mtw=mtw)
    want = C.composite_macro_mxu_seg(table, starts, counts, bg, n_blocks=6, kc=kc, bs=bs, mtw=mtw)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) == 0.0
    clipped = torch.clamp(counts, max=kc)
    slot = torch.arange(kc, device=cuda)
    idx = torch.where(slot[None, :] < clipped[:, None],
                      inverse[torch.clamp(starts.long()[:, None] + slot[None, :],
                                          max=table.shape[0] - 1)],
                      torch.full((), -1, dtype=torch.int32, device=cuda)).to(torch.int32)
    got_w = C.composite_macro_mxu_indexed(shuffled, idx.contiguous(), clipped, bg, bs=bs, mtw=mtw)
    window = shuffled[torch.clamp(idx, min=0).long()].contiguous()
    want_w = C.composite_macro_mxu(window, clipped, bg, bs=bs, mtw=mtw)
    torch.cuda.synchronize()
    assert float((got_w - want_w).abs().max()) == 0.0
    assert float((got_w - got).abs().max()) == 0.0
    assert C.launch_counts()["composite_macro_mxu_seg"] == 2
    assert C.launch_counts()["composite_macro_mxu"] == 2
    # Block 2's rows through an index with one id past the table: that row
    # is empty, as if its opacity were 0.
    bad = idx.clone()
    bad[2, 3] = table.shape[0] + 7
    empty = window.clone()
    empty[2, 3, 5] = -float("inf")
    got_b = C.composite_macro_mxu_indexed(shuffled, bad, clipped, bg, bs=bs, mtw=mtw)
    want_b = C.composite_macro_mxu(empty, clipped, bg, bs=bs, mtw=mtw)
    torch.cuda.synchronize()
    assert float((got_b - want_b).abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("bs", [16, 32, 64])
def test_composite_kernel_equals_its_emulation(cuda, bs):
    """The kernel against its walk emulated in plain torch on the card
    (``composite_macro_walk_reference``): equal, max abs 0, since both
    round every operation alike; the emulation over each sub-tile's live
    rows too."""
    from aip_tpu_torch.kernels import composite as C

    table, starts, counts, mtw, kc = _seg_case(cuda, bs)
    bg = torch.tensor([0.2, 0.1, 0.3], device=cuda)
    out = C.composite_macro_mxu_seg(table, starts, counts, bg, n_blocks=6, kc=kc, bs=bs, mtw=mtw)
    torch.cuda.synchronize()
    window = C._segment_window(table, starts, torch.clamp(counts, max=kc), kc)
    for sh in (None, 16):
        emulated = C.composite_macro_walk_reference(window, counts, bg, bs, mtw, sh=sh)
        assert float((out - emulated).abs().max()) == 0.0, sh


@pytest.mark.cuda
def test_composite_layouts_agree_bit_for_bit(cuda):
    """Every sub-tile height and P the kernel is built for at bs 64 writes
    the default layout's planes (each pixel's walk rounds alike)."""
    from aip_tpu_torch.kernels import composite as C

    table, starts, counts, mtw, kc = _seg_case(cuda, 64)
    bg = torch.tensor([0.2, 0.1, 0.3], device=cuda)
    outs = {lay: C.composite_macro_mxu_seg(table, starts, counts, bg, n_blocks=6, kc=kc, bs=64,
                                           mtw=mtw, layout=lay) for lay in C.LAYOUTS[64]}
    torch.cuda.synchronize()
    base = outs[C.DEFAULT_LAYOUT]
    for lay, out in outs.items():
        assert float((out - base).abs().max()) == 0.0, lay


# ---------------------------------------------------------------------------
# Per-tile, fused and coefficient walks (kernels/composite.py,
# csrc/composite_walk.cu): bit for bit with their plain versions
# ---------------------------------------------------------------------------

def _walk_slots(g, rows, k, x0, y0, spread=20.0):
    """Slot arrays [rows, k, .] around each row's origin (x0, y0), float32:
    mean, conic, colour, opacity [rows, k], valid [rows, k] (a prefix)."""
    mean = np.stack([x0[:, None] + g.random((rows, k)) * spread - 2,
                     y0[:, None] + g.random((rows, k)) * spread - 2], -1)
    sig = g.random((rows, k)) * 4 + 1.5
    conic = np.stack([1 / sig ** 2, (g.random((rows, k)) - 0.5) * 0.3 / sig ** 2,
                      1 / (sig * (g.random((rows, k)) + 0.6)) ** 2], -1)
    op = g.random((rows, k)) * 0.7 + 0.1
    valid = np.ones((rows, k))
    valid[:, k - k // 4:] = 0.0
    return [a.astype(np.float32) for a in (mean, conic, g.random((rows, k, 3)), op, valid)]


def _walk_edge_tiles(g, k, tile_w=4, n_tiles=8):
    """Tile 1 empty, tile 2 saturating below T = 1e-4, tile 3 a splat at the
    0.99 clamp and one of opacity below 1/255, tile 4 invalid slots between
    valid ones, tile 5 only its first slot valid."""
    t = np.arange(n_tiles)
    x0, y0 = (t % tile_w) * 16.0, (t // tile_w) * 16.0
    mean, conic, color, op, valid = _walk_slots(g, n_tiles, k, x0, y0)
    valid[1] = 0.0
    conic[2, :, 0] = conic[2, :, 2] = 1e-3
    conic[2, :, 1] = 0.0
    op[2], valid[2] = 0.98, 1.0
    mean[3, 0] = [x0[3] + 7.5, y0[3] + 7.5]
    op[3, 0], op[3, 1] = 1.0, 0.003
    valid[4, ::3] = 0.0
    valid[5, 1:] = 0.0
    return mean, conic, color, op, valid


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 40, 300])
def test_composite_tiles_kernel_matches_plain(cuda, k):
    from aip_tpu_torch.kernels import composite as C

    g = np.random.default_rng(20 + k)
    arrays = [torch.from_numpy(a).to(cuda) for a in _walk_edge_tiles(g, k)] if k > 1 else \
        [torch.from_numpy(a).to(cuda) for a in _walk_slots(g, 8, 1, np.zeros(8), np.zeros(8))]
    bg = torch.tensor([0.2, 0.5, 0.1], device=cuda)
    C.reset_launch_counts()
    out = C.composite_tiles(*arrays, bg, 4)
    torch.cuda.synchronize()
    assert C.launch_counts()["composite_tiles"] == 1
    ref = C.composite_tiles_reference(*arrays, bg, 4)
    assert out.shape == ref.shape == (8, 3, 16, 16)
    assert float((out - ref).abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("kc", [64, 700])
def test_composite_from_macro_kernel_matches_plain(cuda, kc):
    """5 x 7 tiles in blocks of 2 x 2 tiles, an empty block, a block whose
    list ends early, a saturating block, a splat at the 0.99 clamp next to
    one below 1/255, invalid slots between valid ones, lists longer than
    one 256-slot chunk."""
    from aip_tpu_torch.kernels import composite as C

    g = np.random.default_rng(21)
    th, tw, macro = 5, 7, 2
    mth, mtw = 3, 4
    b = np.arange(mth * mtw)
    arrays = _walk_slots(g, mth * mtw, kc, (b % mtw) * 32.0, (b // mtw) * 32.0, spread=36.0)
    mean, conic, _, op, valid = arrays
    valid[3] = 0.0
    valid[5, 7:] = 0.0
    conic[2, :, 0] = conic[2, :, 2] = 1e-3
    conic[2, :, 1] = 0.0
    op[2], valid[2] = 0.98, 1.0
    mean[6, 0] = [2 * 32 + 7.5, 32 + 7.5]
    op[6, 0], op[6, 1] = 1.0, 0.003
    valid[7, ::3] = 0.0
    arrays = [torch.from_numpy(a).to(cuda) for a in arrays]
    bg = torch.tensor([0.05, 0.05, 0.1], device=cuda)
    kw = dict(n_tiles=th * tw, tile_w=tw, macro=macro, macro_tile_w=mtw)
    C.reset_launch_counts()
    out = C.composite_from_macro(*arrays, bg, **kw)
    torch.cuda.synchronize()
    assert C.launch_counts()["composite_from_macro"] == 1
    ref = C.composite_from_macro_reference(*arrays, bg, **kw)
    assert out.shape == ref.shape == (th * tw, 3, 16, 16)
    assert float((out - ref).abs().max()) == 0.0


def _fused_lists(g, th, tw, macro, kc):
    """Fused-walk lists of a th x tw tile grid in macro blocks of ``macro``
    tiles: slots scattered up to 40 px around each block (the first at its
    centre), sizes 0.5-12 px, any rotation, opacities 0.002-1, valid a
    prefix of random length; the first list empty, the last with invalid
    slots between valid ones."""
    mth, mtw = -(-th // macro), -(-tw // macro)
    m, bs = mth * mtw, 16 * macro
    b = np.arange(m)
    cx = ((b % mtw) * bs + bs / 2)[:, None]
    cy = ((b // mtw) * bs + bs / 2)[:, None]
    mean = np.stack([cx + (g.random((m, kc)) - 0.5) * (bs + 80),
                     cy + (g.random((m, kc)) - 0.5) * (bs + 80)], -1)
    mean[:, 0] = np.concatenate([cx, cy], -1)
    s1, s2, th_ = g.uniform(0.5, 12, (m, kc)), g.uniform(0.5, 12, (m, kc)), g.uniform(0, 3.2,
                                                                                      (m, kc))
    c, s = np.cos(th_), np.sin(th_)
    conic = np.stack([c * c / s1 ** 2 + s * s / s2 ** 2, c * s * (1 / s1 ** 2 - 1 / s2 ** 2),
                      s * s / s1 ** 2 + c * c / s2 ** 2], -1)
    op = np.exp(g.uniform(math.log(0.002), 0, (m, kc)))
    op[:, 0] = 0.8
    valid = (np.arange(kc)[None, :] < g.integers(1, kc + 1, (m, 1))).astype(np.float32)
    valid[0] = 0.0
    valid[-1, ::3] = 0.0
    arrays = [mean, conic, g.random((m, kc, 3)), op, valid]
    return ([torch.from_numpy(x.astype(np.float32)) for x in arrays],
            dict(n_tiles=th * tw, tile_w=tw, macro=macro, macro_tile_w=mtw))


@pytest.mark.cuda
@pytest.mark.parametrize("macro", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("kc", [2, 200, 5120])
def test_composite_from_macro_kernel_is_bit_exact(cuda, kc, macro):
    """The fused walk (one block a macro block, its list staged once, each
    tile walking the slots its cull keeps) against the plain version, max
    abs 0, on grids whose last macro-block column and row hold fewer tiles
    (macro 5 splits a macro block over two blocks)."""
    from aip_tpu_torch.kernels import composite as C

    g = np.random.default_rng(100 * macro + kc % 97)
    arrays, kw = _fused_lists(g, 2 * macro + 1, 2 * macro + 3, macro, kc)
    arrays = [a.to(cuda) for a in arrays]
    bg = torch.tensor([0.2, 0.1, 0.3], device=cuda)
    C.reset_launch_counts()
    out = C.composite_from_macro(*arrays, bg, **kw)
    torch.cuda.synchronize()
    assert C.launch_counts()["composite_from_macro"] == 1
    ref = C.composite_from_macro_reference(*arrays, bg, **kw)
    assert out.shape == ref.shape == (kw["n_tiles"], 3, 16, 16)
    assert float((out - ref).abs().max()) == 0.0
    assert float((ref - bg[None, :, None, None]).abs().max()) > 0   # something was drawn


@pytest.mark.cuda
@pytest.mark.parametrize("bs,kc", [(16, 40), (32, 100), (64, 70), (64, 1000)])
def test_composite_macro_blocks_kernel_matches_plain(cuda, bs, kc):
    """Count 0, a count of 37, a block opaque within its first 32-row
    group, a block drawn near its origin only (its far pixels keep T = 1 and
    hold the block in the walk) and full blocks, sharp splats included."""
    from aip_tpu_torch.kernels import composite as C

    g = np.random.default_rng(22 + bs)
    m = 6
    mx, my = g.random((m, kc)) * bs, g.random((m, kc)) * bs
    mx[3], my[3] = g.random(kc) * bs * 0.2, g.random(kc) * bs * 0.2
    sig = g.random((m, kc)) * 6 + 1.5
    ca, cc = 1 / sig ** 2, 1 / (sig * (g.random((m, kc)) + 0.6)) ** 2
    cb = (g.random((m, kc)) - 0.5) * 0.3 / sig ** 2
    ca[2, :10], cc[2, :10], cb[2, :10] = 1e-4, 1e-4, 0.0
    op = g.random((m, kc)) * 0.8 + 0.1
    op[2, :10] = 0.99
    counts = np.array([0, min(37, kc), kc, kc, kc, kc // 2], np.int32)
    coeff = np.stack([-0.5 * (ca * mx * mx + cc * my * my) - cb * mx * my, ca * mx + cb * my,
                      cc * my + cb * mx, -0.5 * ca, -0.5 * cc, -cb, op, 0 * op], -1)
    colors = np.concatenate([g.random((m, kc, 3)), np.zeros((m, kc, 1))], -1)
    args = [torch.from_numpy(a.astype(np.float32)).to(cuda) for a in (coeff, colors)]
    args.append(torch.from_numpy(counts).to(cuda))
    bg = torch.tensor([0.2, 0.1, 0.3], device=cuda)
    C.reset_launch_counts()
    out = C.composite_macro_blocks(*args, bg, bs=bs)
    torch.cuda.synchronize()
    assert C.launch_counts()["composite_macro_blocks"] == 1
    ref = C.composite_macro_blocks_reference(*args, bg, bs=bs)
    assert out.shape == ref.shape == (m, 3, 1, bs * bs)
    assert float((out - ref).abs().max()) == 0.0
    torch.testing.assert_close(out[0, :, 0].cpu(), bg.cpu()[:, None].expand(3, bs * bs))


_SWEEP_EPS = (-1e-2, -1e-4, -1e-6, 0.0, 1e-6, 1e-4, 1e-2, 1e-1)
_SWEEP_SHAPES = ((3.0, 3.0, 0.0), (2.0, 5.0, 0.0), (0.35, 40.0, 0.0), (60.0, 45.0, 0.0),
                 (1.5, 9.0, 0.6), (0.4, 25.0, 2.3))   # (sigma 1, sigma 2, rotation)
_SWEEP_OPS = (1.0, 0.05, 0.0045)


def _contour_splats(corner):
    """Splats up and left of pixel (corner, corner) on the diagonal, where
    q(corner - mean) = L (1 + eps) and L = 2 ln(255 op) is the 1/255
    contour, for every shape, opacity and eps: (mean, conic, op) float64."""
    u = np.array([-1.0, -1.0]) / math.sqrt(2.0)
    mean, conic, op = [], [], []
    for s1, s2, theta in _SWEEP_SHAPES:
        c, s = math.cos(theta), math.sin(theta)
        i1, i2 = 1 / s1 ** 2, 1 / s2 ** 2
        abc = [c * c * i1 + s * s * i2, c * s * (i1 - i2), s * s * i1 + c * c * i2]
        qu = abc[0] * u[0] ** 2 + 2 * abc[1] * u[0] * u[1] + abc[2] * u[1] ** 2
        for o in _SWEEP_OPS:
            for e in _SWEEP_EPS:
                d = math.sqrt(max(2 * math.log(255 * o) * (1 + e), 0.0) / qu)
                mean.append([corner + d * u[0], corner + d * u[1]])
                conic.append(abc)
                op.append(o)
    return np.asarray(mean), np.asarray(conic), np.asarray(op)


def _blocks_cases(cuda):
    """Coefficient rows packed by the rasterizer's ``_macro_coeffs``: the
    1/255 contour sweep at pixel (32, 32) of a 64 px block (the corner of
    sub-tile (2, 2)), rows near and far at bs 16, 32 and 64 (counts 0, 37
    and full), and rows that are not finite or not concave."""
    from aip_tpu_torch.gs import rasterizer as R

    def pack(mean, conic, op, idx, mtw, bs, g):
        f = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
        coeff, gcol, gop, counts = R._macro_coeffs(
            torch.from_numpy(idx.astype(np.int32)), f(mean), f(conic), f(g.random((len(op), 3))),
            f(op), idx.shape[0], mtw, bs)
        zero = torch.zeros_like(gop[..., None])
        return (torch.cat([coeff, gop[..., None], zero], -1).contiguous().to(cuda),
                torch.cat([gcol, zero], -1).contiguous().to(cuda), counts.to(cuda))

    g = np.random.default_rng(31)
    mean, conic, op = _contour_splats(32.0)
    cases = {"contour sweep": (pack(mean, conic, op, np.arange(len(op))[None], 1, 64, g), 64)}
    for bs in (16, 32, 64):
        n, kc = 600, 300
        far = np.where(np.arange(n) % 2, 150.0, 0.0)
        mean = np.stack([g.uniform(-far, 2 * bs + far), g.uniform(-far, 2 * bs + far)], -1)
        s1, s2, th = g.uniform(0.3, 12, n), g.uniform(0.3, 12, n), g.uniform(0, 3.2, n)
        c, s = np.cos(th), np.sin(th)
        conic = np.stack([c * c / s1 ** 2 + s * s / s2 ** 2, c * s * (1 / s1 ** 2 - 1 / s2 ** 2),
                          s * s / s1 ** 2 + c * c / s2 ** 2], -1)
        idx = np.stack([g.permutation(n)[:kc] for _ in range(4)])
        idx[0], idx[1, 37:] = -1, -1
        cases[f"near and far, bs={bs}"] = (
            pack(mean, conic, np.exp(g.uniform(math.log(0.003), 0, n)), idx, 2, bs, g), bs)
    odd = np.zeros((1, 12, 8), np.float32)
    odd[0, :, 0], odd[0, :, 3:5], odd[0, :, 6] = -500.0, -0.1, 0.5
    odd[0, 0, 3], odd[0, 1, 4], odd[0, 2, 5], odd[0, 3, 5] = 0.0, 0.2, 0.2, 0.3
    odd[0, 4, 0], odd[0, 5, 1], odd[0, 6, 6], odd[0, 7, 6] = np.nan, np.inf, np.nan, np.inf
    odd[0, 8, 6], odd[0, 9, 6] = 0.0, -0.5
    cases["not finite or not concave"] = (
        (torch.from_numpy(odd).to(cuda), torch.ones(1, 12, 4, device=cuda),
         torch.tensor([12], dtype=torch.int32, device=cuda)), 32)
    return cases


@pytest.mark.cuda
def test_composite_macro_blocks_kernel_equals_its_dense_twin(cuda):
    """The culled coefficient walk against its twin with the cull off, bit
    for bit (NaN for NaN), on the contour sweep, lists of near and far
    splats and rows that are not finite or not concave; and against the
    plain version, max abs 0, where every row is finite (for a NaN power
    the kernel's fminf gives 0.99 where torch.clamp gives NaN)."""
    from aip_tpu_torch.kernels import composite as C

    bg = torch.tensor([0.2, 0.1, 0.3], device=cuda)
    for case, (args, bs) in _blocks_cases(cuda).items():
        out = C.composite_macro_blocks(*args, bg, bs=bs)
        dense = C.composite_macro_blocks(*args, bg, bs=bs, _dense=True)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, dense, rtol=0, atol=0, equal_nan=True, msg=case)
        if case.startswith("not"):
            continue
        ref = C.composite_macro_blocks_reference(*args, bg, bs=bs)
        assert float((out - ref).abs().max()) == 0.0, case
        keep = C.blocks_sub_tile_live(*args[::2], bs)
        assert 0 < int(keep.sum()) < keep.numel(), case


def _tiles_contour(cuda):
    """16 tiles of a 4-tile row, each listing the 1/255 contour sweep at
    pixel (48, 48), the corner of tile (3, 3)."""
    mean, conic, op = _contour_splats(48.0)
    k = len(op)
    rep = lambda a: np.broadcast_to(a[None], (16,) + a.shape).astype(np.float32)  # noqa: E731
    arrays = [rep(mean), rep(conic), rep(np.random.default_rng(5).random((k, 3))), rep(op),
              np.ones((16, k), np.float32)]
    return [torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["K=1", "K=40", "K=300", "contour sweep"])
def test_composite_tiles_kernel_equals_its_dense_twin(cuda, case):
    """The culled per-tile walk against its twin with the cull off and the
    plain version, max abs 0, on test_composite_tiles_kernel_matches_plain's
    edge tiles (K = 300 spans two staged chunks) and on the contour
    sweep."""
    from aip_tpu_torch.kernels import composite as C

    if case == "contour sweep":
        arrays = _tiles_contour(cuda)
    else:
        k = int(case[2:])
        g = np.random.default_rng(20 + k)
        arrays = [torch.from_numpy(a).to(cuda) for a in _walk_edge_tiles(g, k)] if k > 1 else \
            [torch.from_numpy(a).to(cuda) for a in _walk_slots(g, 8, 1, np.zeros(8), np.zeros(8))]
    bg = torch.tensor([0.2, 0.5, 0.1], device=cuda)
    out = C.composite_tiles(*arrays, bg, 4)
    dense = C.composite_tiles(*arrays, bg, 4, _dense=True)
    torch.cuda.synchronize()
    ref = C.composite_tiles_reference(*arrays, bg, 4)
    assert float((out - dense).abs().max()) == 0.0
    assert float((out - ref).abs().max()) == 0.0


@pytest.mark.cuda
def test_walk_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from aip_tpu_torch.kernels import composite as C

    g = np.random.default_rng(23)
    arrays = [torch.from_numpy(a).to(cuda) for a in _walk_slots(g, 4, 8, np.zeros(4),
                                                                 np.zeros(4))]
    bg = torch.zeros(3, device=cuda)
    with pytest.raises(TypeError):
        C.composite_tiles(arrays[0].double(), *arrays[1:], bg, 2)
    with pytest.raises(ValueError):
        C.composite_tiles(*arrays[:3], arrays[3][:, :4].contiguous(), arrays[4], bg, 2)
    with pytest.raises(ValueError):
        C.composite_tiles(*arrays[:4], arrays[4].cpu(), bg, 2)
    with pytest.raises(ValueError):
        C.composite_tiles(arrays[0], arrays[1].transpose(0, 1), *arrays[2:], bg, 2)
    with pytest.raises(ValueError):   # 16 tiles of a 4-tile row need 4 blocks of 2 x 2 tiles
        C.composite_from_macro(*[a[:2] for a in arrays], bg, n_tiles=16, tile_w=4, macro=2,
                               macro_tile_w=2)
    fused = dict(n_tiles=4, tile_w=2, macro=2, macro_tile_w=1)
    with pytest.raises(ValueError, match="macro blocks of 1 to"):
        C.composite_from_macro(*arrays, bg, **{**fused, "macro": C.MAX_MACRO + 1})
    with pytest.raises(ValueError, match="macro blocks of 1 to"):
        C.composite_from_macro(*arrays, bg, **{**fused, "macro": 0})
    with pytest.raises(TypeError):
        C.composite_from_macro(arrays[0], arrays[1].double(), *arrays[2:], bg, **fused)
    with pytest.raises(ValueError):
        C.composite_from_macro(*arrays[:4], arrays[4].cpu(), bg, **fused)
    coeff = torch.zeros(2, 8, 8, device=cuda)
    colors = torch.zeros(2, 8, 4, device=cuda)
    counts = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="macro 8"):
        C.composite_macro_blocks(coeff, colors, counts, bg, bs=128)
    with pytest.raises(TypeError):
        C.composite_macro_blocks(coeff, colors, counts.long(), bg, bs=64)
    with pytest.raises(ValueError):
        C.composite_macro_blocks(coeff[:, :, :6].contiguous(), colors, counts, bg, bs=64)


@pytest.mark.cuda
def test_walk_paths_on_the_card_launch_their_kernels_and_match_the_cpu(cuda):
    """rasterize_fast, rasterize_fused and rasterize_matmul("pallas") on a
    40-splat 64^2 scene, macro 2: one launch of their kernel each, and the
    image of the same call on the CPU (plain versions) within 1e-5 mean abs
    (the projection's exp and divisions may round otherwise on the card,
    and a hard threshold can then flip at a pixel)."""
    from aip_tpu_torch.gs import rasterizer as R
    from aip_tpu_torch.gs.cameras import Camera
    from aip_tpu_torch.kernels import composite as C

    g = np.random.default_rng(24)
    n = 40
    scene = [(g.random((n, 3)) * 2 - 1), g.random((n, 3)) * 0.15 + 0.05,
             g.standard_normal((n, 4)), g.random(n) * 0.8 + 0.1, g.random((n, 3))]
    cam = Camera(colmap_id=0, R=np.eye(3), T=np.array([0.0, 0.0, 4.0]), FoVx=np.pi / 3,
                 FoVy=np.pi / 3, image=np.zeros((64, 64, 3), np.float32), image_name="t", uid=0)
    cpu = [torch.from_numpy(np.asarray(a, np.float32)) for a in
           scene + [cam.world_view_transform, cam.full_proj_transform, [0.05, 0.1, 0.2]]]
    tan = math.tan(cam.FoVx * 0.5)
    s = R.RasterSettings(64, 64, max_per_tile=40, chunk=16, macro=2, macro_capacity=64)
    for fn, settings, kernel in ((R.rasterize_fast, s, "composite_tiles"),
                                 (R.rasterize_fused, s, "composite_from_macro"),
                                 (R.rasterize_matmul, s._replace(composite_backend="pallas"),
                                  "composite_macro_blocks")):
        C.reset_launch_counts()
        on_card, _ = fn(*[a.to(cuda) for a in cpu], settings, tanfovx=tan, tanfovy=tan)
        torch.cuda.synchronize()
        counts = C.launch_counts()
        assert counts[kernel] == 1 and sum(counts.values()) == 1, counts
        on_cpu, _ = fn(*cpu, settings, tanfovx=tan, tanfovy=tan)
        assert float((on_card.cpu() - on_cpu).abs().mean()) <= 1e-5, kernel


# ---------------------------------------------------------------------------
# Differentiable per-tile compositor (kernels A and B) and the hash-table
# gradient (kernel C)
# ---------------------------------------------------------------------------

def _gathered(g, n_tiles=8, k=48, tile_w=4):
    """Gathered per-tile arrays around each tile's pixels, with edge cases:
    tile 1 empty (every slot invalid), tile 2 saturating (T falls below
    1e-4), tile 3 a splat at the 0.99 clamp and one of opacity 0, tile 4
    invalid slots between valid ones, tile 5 all valid and all on top of
    each other (every slot on the live list, one shared mean)."""
    t = np.arange(n_tiles)
    x0 = ((t % tile_w) * 16).astype(np.float32)[:, None]
    y0 = ((t // tile_w) * 16).astype(np.float32)[:, None]
    mean = np.stack([x0 + g.random((n_tiles, k)) * 20 - 2,
                     y0 + g.random((n_tiles, k)) * 20 - 2], -1).astype(np.float32)
    sig = g.random((n_tiles, k)) * 4 + 1.5
    conic = np.stack([1 / sig ** 2, (g.random((n_tiles, k)) - 0.5) * 0.3 / sig ** 2,
                      1 / (sig * (g.random((n_tiles, k)) + 0.6)) ** 2], -1).astype(np.float32)
    color = g.random((n_tiles, k, 3)).astype(np.float32)
    op = (g.random((n_tiles, k, 1)) * 0.7 + 0.1).astype(np.float32)
    valid = np.ones((n_tiles, k, 1), np.float32)
    valid[1] = 0.0
    conic[2, :, 0] = conic[2, :, 2] = 1e-3
    conic[2, :, 1] = 0.0
    op[2] = 0.98
    mean[3, 0] = [x0[3, 0] + 7.5, y0[3, 0] + 7.5]
    op[3, 0] = 1.0
    op[3, 1] = 0.0
    valid[4, ::3] = 0.0
    mean[5] = [x0[5, 0] + 6.3, y0[5, 0] + 9.1]
    conic[5] = [0.02, 0.004, 0.03]
    op[5] = 0.05
    return [torch.from_numpy(a) for a in (mean, conic, color, op, valid)]


@pytest.mark.cuda
@pytest.mark.parametrize("p", [1, 2, 4, 8])
@pytest.mark.parametrize("k", [2, 48, 128, 200])
def test_composite_ad_kernels_match_plain(cuda, k, p):
    """Kernel A's image and final transmittance equal to the plain
    version's (the same float32 walk, rounded alike; the culled slots add
    exactly nothing), kernel B's four gradients at 1e-4 of each one's
    largest value (B sums the 256 pixels in another order, with one suffix
    division) and exactly 0 on the empty tile, at every P."""
    from aip_tpu_torch.kernels import composite_ad as AD

    g = np.random.default_rng(4)
    args = [a.to(cuda) for a in _gathered(g, k=k)]
    packed = AD.pack(*args[:4])
    bg = torch.tensor([0.2, 0.5, 0.1], device=cuda)
    g_out = torch.from_numpy(g.standard_normal((8, 3, 16, 16)).astype(np.float32)).to(cuda)
    AD.reset_launch_counts()
    out, tf = AD.composite_ad_fwd_packed(packed, args[4], bg, 4, p=p)
    d_g = AD.composite_ad_bwd_packed(packed, args[4], bg, tf, g_out, 4, p=p)
    torch.cuda.synchronize()
    assert AD.launch_counts() == {"composite_ad_fwd": 1, "composite_ad_bwd": 1}
    ref_out, ref_tf = AD.composite_ad_fwd_reference(*args, bg, 4)
    assert torch.equal(out, ref_out)
    assert torch.equal(tf, ref_tf)
    ref_grads = AD.composite_ad_bwd_reference(*args, bg, ref_tf, g_out, 4)
    for a, b in zip(AD._unpack(d_g), ref_grads):
        scale = max(float(b.abs().max()), 1e-8)
        assert float((a - b).abs().max()) / scale < 1e-4
        assert float(a[1].abs().max()) == 0.0          # the empty tile


@pytest.mark.cuda
def test_composite_ad_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from aip_tpu_torch.kernels import composite_ad as AD

    g = torch.zeros(2, 8, 9, device=cuda)
    valid = torch.ones(2, 8, 1, device=cuda)
    bg = torch.zeros(3, device=cuda)
    with pytest.raises(TypeError):
        AD.composite_ad_fwd_packed(g.double(), valid, bg, 2)
    with pytest.raises(ValueError):
        AD.composite_ad_fwd_packed(g[..., :8].contiguous(), valid, bg, 2)
    with pytest.raises(ValueError):
        AD.composite_ad_fwd_packed(g, valid.cpu(), bg, 2)
    with pytest.raises(ValueError):
        AD.composite_ad_fwd_packed(g.transpose(0, 1).contiguous().transpose(0, 1), valid, bg, 2)
    with pytest.raises(ValueError):   # a P the kernels are not built for
        AD.composite_ad_fwd_packed(g, valid, bg, 2, p=3)
    # The shared-memory limit is the kernels' own: 48 B a staged row and a
    # ballot word per 32 slots; B adds 4 B a slot for its list and, with
    # more than one warp a tile, [warps, K, 9] partial sums.
    lib = AD._lib()
    assert lib.aip_composite_ad_smem(128, 4, 0) == 128 * 48 + 16
    assert lib.aip_composite_ad_smem(128, 8, 1) == 128 * 52 + 16
    assert lib.aip_composite_ad_smem(128, 1, 1) == 128 * (52 + 8 * 36) + 16
    k_over = next(k for k in range(128, 4096)
                  if lib.aip_composite_ad_smem(k, AD.BWD_P, 1) > AD.MAX_SMEM)
    big = torch.zeros(1, k_over, 9, device=cuda)
    big_valid = torch.ones(1, k_over, 1, device=cuda)
    t_final = torch.ones(1, 16, 16, device=cuda)
    with pytest.raises(ValueError):
        AD.composite_ad_bwd_packed(big, big_valid, bg, t_final, torch.zeros(1, 3, 16, 16,
                                                                            device=cuda), 1)
    d_g = AD.composite_ad_bwd_packed(big[:, :k_over - 1].contiguous(),
                                     big_valid[:, :k_over - 1].contiguous(), bg, t_final,
                                     torch.zeros(1, 3, 16, 16, device=cuda), 1)
    torch.cuda.synchronize()
    assert float(d_g.abs().max()) == 0.0   # opacity 0 everywhere: every slot culled


@pytest.mark.cuda
def test_composite_ad_function_on_the_card_matches_the_cpu(cuda):
    from aip_tpu_torch.kernels import composite_ad as AD

    g = np.random.default_rng(5)
    cpu = _gathered(g)
    bg = torch.tensor([0.1, 0.1, 0.2])
    g_out = torch.from_numpy(g.standard_normal((8, 3, 16, 16)).astype(np.float32))
    res = []
    for dev in ("cpu", cuda):
        leaves = [a.to(dev, copy=True).requires_grad_(i < 4) for i, a in enumerate(cpu)]
        out = AD.composite_tiles_ad(*leaves, 4, bg.to(dev))
        out.backward(g_out.to(dev))
        res.append([out.detach().cpu()] + [a.grad.cpu() for a in leaves[:4]])
    for a, b in zip(*res):
        assert float((a - b).abs().max()) <= 1e-4 * max(float(b.abs().max()), 1e-8)


@pytest.mark.cuda
@pytest.mark.parametrize("log2,n", [(16, 5000), (19, 131072)])
def test_hash_grad_kernel_matches_index_add(cuda, log2, n):
    """Kernel C against its plain version (one index_add_), both fp32;
    atomics add in another order, so 1e-5 of the largest entry. A wrong
    corner index would be off by whole contributions."""
    from aip_tpu_torch.kernels import hashgrad as KH

    g = np.random.default_rng(6)
    x = torch.from_numpy((g.random((n, 3)) * 0.5 + 0.25).astype(np.float32)).to(cuda)
    go = torch.from_numpy(g.standard_normal((n, 32)).astype(np.float32)).to(cuda)
    shape = (16, 1 << log2, 2)
    KH.reset_launch_counts()
    out = KH.hash_grad(x, go, shape)
    torch.cuda.synchronize()
    assert KH.launch_counts() == {"hash_grad": 1}
    ref = KH.hash_grad_reference(x, go, shape)
    assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def _hash_inputs(g, n, l, f, cuda):
    """Positions in [0.25, 0.75]^3 and an upstream gradient [n, l f] that is
    0 at every tenth point."""
    x = torch.from_numpy((g.random((n, 3)) * 0.5 + 0.25).astype(np.float32)).to(cuda)
    go = g.standard_normal((n, l * f)).astype(np.float32)
    go[::10] = 0.0
    return x, torch.from_numpy(go).to(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("l,log2", [(16, 16), (15, 16), (3, 16), (16, 10)])
@pytest.mark.parametrize("f", [1, 2, 4])
def test_hash_grad_kernel_features_and_level_layouts(cuda, f, l, log2):
    """F = 1, 2 and 4 over tables that reach each of the kernel's paths: at
    2^16 rows level 0 (4,920 rows) is summed in shared memory at F = 1 and
    2 and every level goes to global memory at F = 4; 15 and 3 levels leave
    a short last phase (two levels a phase); at 2^10 rows every level is
    summed in shared memory, both levels of each phase. 1e-5 of the largest
    entry, one launch a call."""
    from aip_tpu_torch.kernels import hashgrad as KH

    x, go = _hash_inputs(np.random.default_rng(7 + f), 6000, l, f, cuda)
    shape = (l, 1 << log2, f)
    KH.reset_launch_counts()
    out = KH.hash_grad(x, go, shape)
    torch.cuda.synchronize()
    assert KH.launch_counts() == {"hash_grad": 1}
    ref = KH.hash_grad_reference(x, go, shape)
    assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.cuda
def test_hash_grad_kernel_writes_every_entry_after_a_poisoned_allocation(cuda):
    """The table comes from torch.empty: after a NaN-filled block of its
    size is freed, the kernel gets that block and must write every entry.
    Rows no contribution touches are exactly 0, every entry is finite; with
    no points at all the whole table is 0."""
    from aip_tpu_torch.gs.colorfield import _encode_terms
    from aip_tpu_torch.kernels import hashgrad as KH

    l, t, f = shape = (16, 1 << 16, 2)
    x, go = _hash_inputs(np.random.default_rng(8), 5000, l, f, cuda)
    for pts in (x.shape[0], 0):
        torch.cuda.synchronize()
        poison = torch.full(shape, float("nan"), device=cuda)
        ptr = poison.data_ptr()
        del poison
        out = KH.hash_grad(x[:pts], go[:pts], shape)
        torch.cuda.synchronize()
        assert out.data_ptr() == ptr
        assert bool(torch.isfinite(out).all())
        idx, _ = _encode_terms(shape, x[:pts])
        touched = torch.zeros(l * t, dtype=torch.bool, device=cuda)
        touched[idx[(go[:pts].reshape(pts, l, f) != 0).any(-1)]] = True
        assert bool(touched.any()) == (pts > 0)
        assert not bool((out.reshape(l * t, f)[~touched] != 0).any())
        ref = KH.hash_grad_reference(x[:pts], go[:pts], shape)
        assert float((out - ref).abs().max()) <= 1e-5 * max(float(ref.abs().max()), 1e-30)


@pytest.mark.cuda
def test_hash_grad_kernel_repeats_within_the_gate(cuda):
    """20 calls in a row on one stream (the level counters left at 0 by each
    launch for the next), each within 1e-5 of the largest entry, and 20
    launches counted."""
    from aip_tpu_torch.kernels import hashgrad as KH

    x, go = _hash_inputs(np.random.default_rng(9), 20000, 16, 2, cuda)
    shape = (16, 1 << 18, 2)
    ref = KH.hash_grad_reference(x, go, shape)
    KH.reset_launch_counts()
    outs = [KH.hash_grad(x, go, shape) for _ in range(20)]
    torch.cuda.synchronize()
    assert KH.launch_counts() == {"hash_grad": 20}
    for out in outs:
        assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.cuda
def test_hash_grad_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    from aip_tpu_torch.kernels import hashgrad as KH

    x, go = _hash_inputs(np.random.default_rng(10), 100, 16, 2, cuda)
    with pytest.raises(ValueError):                  # a table that is no power of two
        KH.hash_grad(x, go, (16, 3000, 2))
    with pytest.raises(ValueError):                  # 3 features
        KH.hash_grad(x, torch.zeros(100, 48, device=cuda), (16, 1024, 3))
    with pytest.raises(ValueError):                  # more levels than the kernel counts
        KH.hash_grad(x, torch.zeros(100, 66, device=cuda), (33, 1024, 2))
    with pytest.raises(TypeError):
        KH.hash_grad(x.double(), go, (16, 1024, 2))
    with pytest.raises(ValueError):                  # on the CPU
        KH.hash_grad(x, go.cpu(), (16, 1024, 2))
    with pytest.raises(ValueError):                  # not 16-byte aligned
        KH.hash_grad(x, torch.zeros(100 * 32 + 1, device=cuda)[1:].view(100, 32),
                     (16, 1024, 2))
    with pytest.raises(ValueError):                  # g_out of the wrong width
        KH.hash_grad(x, go[:, :30].contiguous(), (16, 1024, 2))


def _tiny_training(dev, log2_hashmap=16):
    """A trainer on 300 points and one 64x48 camera looking at them."""
    from aip_tpu_torch.gs import train as T
    from aip_tpu_torch.gs.cameras import Camera

    g = np.random.default_rng(7)
    pts = (g.random((300, 3)) * 2 - 1).astype(np.float32)
    cols = g.random((300, 3)).astype(np.float32)
    cam = Camera(colmap_id=0, R=np.eye(3), T=np.array([0.0, 0.0, 4.0]), FoVx=0.9, FoVy=0.7,
                 image=g.random((48, 64, 3)).astype(np.float32), image_name="v", uid=0)
    cfg = T.GSTrainConfig(capacity=512, log2_hashmap=log2_hashmap, style_dim=0,
                          max_per_tile=32, raster_chunk=256)
    trainer = T.init_trainer(cfg, pts, cols, 1.0, seed=0, device="cpu")
    # Anisotropic, rotated splats: every parameter group gets a gradient.
    gs = trainer.gstate
    gs = gs._replace(scaling=gs.scaling + torch.from_numpy(g.normal(0, 0.3, (512, 3)).astype(
        np.float32)), rotation=torch.from_numpy(g.standard_normal((512, 4)).astype(np.float32)))
    return T, cfg, trainer._replace(gstate=gs), cam


@pytest.mark.cuda
def test_train_step_on_the_card_launches_a_b_c_and_matches_the_cpu(cuda):
    """One photometric step from the same trainer on the card and on the
    CPU: the loss at 1e-5 relative, every parameter group's gradient (Adam's
    first moment after one step is 0.1 g) at 1e-3 of its largest entry
    (float sums in other orders; the colour field's table gradient through
    atomics)."""
    from aip_tpu_torch.gs import gaussians as G
    from aip_tpu_torch.kernels import composite_ad as AD
    from aip_tpu_torch.kernels import hashgrad as KH

    T, cfg, trainer, cam = _tiny_training(cuda)
    res = {}
    for dev in ("cpu", cuda):
        tr = G.tree_map(lambda t: t.to(dev) if t.ndim else t, trainer)
        step = T.make_train_step(cfg, 1.0, "photometric", 48, 64)
        AD.reset_launch_counts()
        KH.reset_launch_counts()
        new, metrics = step(tr, T.camera_to_arrays(cam, device=dev), None,
                            torch.zeros(3, device=dev))
        if dev != "cpu":
            torch.cuda.synchronize()
            assert AD.launch_counts() == {"composite_ad_fwd": 1, "composite_ad_bwd": 1}
            assert KH.launch_counts() == {"hash_grad": 1}
        res[str(dev)] = (float(metrics["loss"]), new)
    (l_cpu, t_cpu), (l_gpu, t_gpu) = res["cpu"], res["cuda"]
    assert abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu)
    for opt_c, opt_g in ((t_cpu.opt_g, t_gpu.opt_g), (t_cpu.opt_net, t_gpu.opt_net)):
        for name, mu in opt_c.mu.items():
            ref = mu
            got = opt_g.mu[name].cpu()
            assert float((got - ref).abs().max()) <= 1e-3 * max(float(ref.abs().max()), 1e-12), \
                name


# ---------------------------------------------------------------------------
# TV-L1 primal-dual inner loop (kernels/tvl1.py)
# ---------------------------------------------------------------------------

def _tvl1_inputs(g, b, h, w, cuda, flat=False):
    """The ten [B, H, W] fields of one warp: a linearised data term, warped
    gradients, their squared norm (0 everywhere with ``flat``), a flow and
    dual fields under way."""
    f = lambda s: torch.from_numpy((g.standard_normal((b, h, w)) * s).astype(np.float32))  # noqa
    gx, gy = (f(0.0), f(0.0)) if flat else (f(0.5), f(0.5))
    args = [f(0.1), gx, gy, gx * gx + gy * gy, f(0.5), f(0.5)]
    return [a.to(cuda) for a in args], tuple(f(0.2).to(cuda) for _ in range(4))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,iters,flat", [
    ((3, 64, 96), 1, False), ((3, 64, 96), 30, False), ((2, 256, 256), 300, False),
    ((2, 2, 9), 30, False), ((2, 11, 2), 30, False), ((1, 37, 45), 30, False),
    ((2, 33, 40), 30, True), ((1, 16, 16), 0, False),
    ((2, 65, 64), 300, False), ((2, 64, 65), 300, False),    # just above the whole frame
    ((2, 3, 150), 30, False), ((2, 150, 5), 30, False),      # H or W below the halo
    ((2, 100, 100), 29, False),                              # iters not a multiple of k
    ((95, 128, 128), 300, False), ((95, 64, 64), 300, False)])
def test_tvl1_kernel_matches_plain(cuda, shape, iters, flat):
    """tvl1_inner against tvl1_inner_reference on the card. Both round every
    operation alike (the kernel with _rn intrinsics in the plain version's
    order), so they agree to the bit even after 300 iterations. Frames up to
    FRAME_SIDE take one launch a call, larger ones ceil(iters / k)."""
    from aip_tpu_torch.kernels import tvl1 as KT

    g = np.random.default_rng(9)
    args, p = _tvl1_inputs(g, *shape, cuda, flat)
    consts = (iters, 0.15 * 0.3, 0.3, 0.25 / 0.3)
    KT.reset_launch_counts()
    got = KT.tvl1_inner(*args, p, *consts)
    torch.cuda.synchronize()
    assert KT.launch_counts() == {"tvl1": KT.launches_per_call(*shape[1:], iters)}
    assert KT.iteration_counts() == {"tvl1": iters}
    want = KT.tvl1_inner_reference(*args, p, *consts)
    for a, b in zip((got[0], got[1], *got[2]), (want[0], want[1], *want[2])):
        assert a.shape == b.shape == shape
        assert torch.equal(a, b)
    for a, b in zip(args[4:] + list(p), (got[0], got[1], *got[2])):   # inputs untouched
        assert a.data_ptr() != b.data_ptr()


@pytest.mark.cuda
def test_tvl1_flow_on_the_card_matches_the_cpu(cuda):
    """estimate_flow_tvl1 on the card (kernel) and on the CPU (plain
    version) for a batch of 3 pairs at 48^2: mean abs <= 1e-4 px."""
    from aip_tpu_torch.kernels import tvl1 as KT
    from aip_tpu_torch.ops.flow import estimate_flow_tvl1

    g = np.random.default_rng(10)
    a = torch.from_numpy(g.random((3, 48, 48, 3)).astype(np.float32))
    b = torch.roll(a, shifts=(1, 1), dims=(1, 2))
    KT.reset_launch_counts()
    on_card = estimate_flow_tvl1(a.to(cuda), b.to(cuda), iters=50).cpu()
    assert KT.iteration_counts() == {"tvl1": 4 * 5 * 50}  # levels x warps x iterations
    assert KT.launch_counts() == {"tvl1": 4 * 5}          # 48^2 and below: the whole frame
    on_cpu = estimate_flow_tvl1(a, b, iters=50)
    assert float((on_card - on_cpu).abs().mean()) <= 1e-4


@pytest.mark.cuda
def test_tvl1_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    from aip_tpu_torch.kernels import tvl1 as KT

    args, p = _tvl1_inputs(np.random.default_rng(11), 1, 8, 8, cuda)
    consts = (3, 0.045, 0.3, 0.8)
    with pytest.raises(TypeError):
        KT.tvl1_inner(*args[:5], args[5].double(), p, *consts)
    with pytest.raises(ValueError):
        KT.tvl1_inner(*args[:5], args[5][:, :4], p, *consts)
    with pytest.raises(ValueError):
        KT.tvl1_inner(*args[:5], args[5].cpu(), p, *consts)
    with pytest.raises(ValueError):
        KT.tvl1_inner(*args[:5], args[5].transpose(1, 2), p, *consts)
    with pytest.raises(ValueError):
        KT.tvl1_inner(*args, p[:3], *consts)
    with pytest.raises(ValueError):   # a k the kernel is not built for
        KT._launch(*args, p, *consts, k=5)
    big, big_p = _tvl1_inputs(np.random.default_rng(12), 1, 80, 8, cuda)
    with pytest.raises(ValueError):   # more than FRAME_SIDE rows cannot run whole
        KT._launch(*big, big_p, *consts, k=0)


# ---------------------------------------------------------------------------
# Localized style transfer and 3DGS evaluation (DeepLab, LPIPS, the mask)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_deeplab_holds_fp32_under_pytorchs_default_tf32_flags(cuda, monkeypatch):
    """DeepLabV3-ResNet101 at full depth (the port's deterministic init) on a
    97x129 image: with cuDNN's TF32 on, as PyTorch starts, the card's logits
    stay within 1e-4 of the largest |logit| of the CPU's (every conv runs
    under ``fp32_convs``; chip_smoke phase 32's gate), and the process's
    flag is as it was. The control: with ``fp32_convs`` undone in the
    DeepLab and ResNet modules, TF32 moves the logits past that gate."""
    import contextlib
    import copy

    from aip_tpu_torch.models import deeplab, resnet

    params_cpu = deeplab.get_deeplab_params(device="cpu")
    params = copy.deepcopy(params_cpu).to(cuda)
    g = np.random.default_rng(32)
    x = torch.from_numpy(g.standard_normal((1, 97, 129, 3)).astype(np.float32))
    with torch.no_grad():
        ref = deeplab.deeplab_logits(params_cpu, x)

        def on_card_with_tf32():
            torch.backends.cudnn.allow_tf32 = True
            try:
                out = deeplab.deeplab_logits(params, x.to(cuda)).cpu()
                assert torch.backends.cudnn.allow_tf32
            finally:
                torch.backends.cudnn.allow_tf32 = False
            return out

        assert _max_rel_err(on_card_with_tf32(), ref) <= 1e-4
        for mod in (deeplab, resnet):
            monkeypatch.setattr(mod, "fp32_convs", contextlib.nullcontext)
        assert _max_rel_err(on_card_with_tf32(), ref) > 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("net,hw", [("vgg", (160, 136)), ("alex", (129, 96)),
                                    ("squeeze", (97, 130))])
def test_lpips_card_matches_cpu_under_pytorchs_default_tf32_flags(cuda, net, hw):
    """LPIPS of two image pairs, card against CPU within 1e-5 relative
    (chip_smoke phase 33's gate), with cuDNN's TF32 on as PyTorch starts."""
    import copy

    from aip_tpu_torch.models import lpips

    if net == "squeeze":
        params_cpu = lpips.init_squeezenet_params(torch.Generator().manual_seed(0), "cpu")
    else:
        init = lpips.init_vgg16_params if net == "vgg" else lpips.init_alexnet_params
        params_cpu = init(torch.Generator().manual_seed(0), "cpu")
    params = copy.deepcopy(params_cpu).to(cuda)
    g = np.random.default_rng(33)
    a = torch.from_numpy(g.random((2, *hw, 3)).astype(np.float32))
    b = torch.clamp(a + torch.from_numpy(g.normal(0, 0.1, a.shape).astype(np.float32)), 0, 1)
    lins = [torch.rand(c, generator=torch.Generator().manual_seed(c))
            for c in lpips.NET_CHANNELS[net]]
    with torch.no_grad():
        ref = lpips.lpips(a, b, params_cpu, lin_weights=lins, net=net)
        torch.backends.cudnn.allow_tf32 = True
        try:
            out = lpips.lpips(a.to(cuda), b.to(cuda), params, net=net,
                              lin_weights=[w.to(cuda) for w in lins]).cpu()
        finally:
            torch.backends.cudnn.allow_tf32 = False
    assert float(((out - ref).abs() / ref.abs()).max()) <= 1e-5


@pytest.mark.cuda
def test_background_mask_and_harmonization_card_match_cpu(cuda):
    """The classical mask on the card equals the CPU's wherever the
    background probability lies more than 1e-4 from 0.5, and the localized
    composite (harmonization included) on the card is within 1e-3 mean abs
    of the CPU's on the same mask."""
    from aip_tpu_torch.models import segmenter
    from aip_tpu_torch.pipelines import localized

    g = np.random.default_rng(31)
    img = np.empty((90, 120, 3), np.float32)
    img[:] = (0.3, 0.5, 0.7)
    img[25:70, 30:90] = (0.8, 0.3, 0.2)
    img = np.clip(img + g.normal(0, 0.03, img.shape), 0, 1).astype(np.float32)
    prob = segmenter.background_probability(torch.from_numpy(img)).numpy()
    mask = segmenter.extract_background_mask(img, device=cuda).cpu().numpy()
    ref = segmenter.extract_background_mask(img, device="cpu").numpy()
    far = np.abs(prob - 0.5) > 1e-4
    assert np.array_equal(mask[far], ref[far])
    stylized = g.random((72, 96, 3)).astype(np.float32)
    out = localized.composite_localized(img, stylized, ref, device=cuda)
    cpu = localized.composite_localized(img, stylized, ref, device="cpu")
    assert np.abs(out - cpu).mean() <= 1e-3


# ---------------------------------------------------------------------------
# The pixel-art page and optimisation NST (no kernel of their own)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(64, 96), (1, 9), (37, 1), (192, 256)])
def test_floyd_steinberg_and_recolor_rgb_on_the_card_equal_the_cpu(cuda, h, w):
    """The wavefront rounds each operation on its own and argmin keeps the
    first index, on the card as on the CPU: equal, as RGB's integer
    distances make ``recolor_rgb``."""
    from aip_tpu_torch.ops import palette

    g = np.random.default_rng(h * w)
    img = torch.from_numpy((g.random((h, w, 3)) * 255).astype(np.uint8))
    pal = torch.from_numpy((g.random((16, 3)) * 255).astype(np.uint8))
    pal[9] = pal[2]
    for fn in (palette.floyd_steinberg, palette.recolor_rgb):
        out = fn(img.to(cuda), pal.to(cuda)).cpu()
        assert torch.equal(out, fn(img, pal)), fn.__name__


@pytest.mark.cuda
def test_nst_gradient_holds_fp32_under_pytorchs_default_tf32_flags(cuda, monkeypatch):
    """NST's step 1 at 512^2 on the port's VGG-19, with cuDNN's TF32 on as
    PyTorch starts: the loss within 1e-4 relative of the CPU's; the image
    gradient of the conv1_1 style term, which crosses no max pool, within
    1e-4 of its largest entry (the backward convs run inside ``fp32_convs``
    too; chip_smoke.py phase 36's gate). The whole gradient is compared by
    its loss only: near-ties of a 2x2 max send a few entries' gradient to a
    neighbour, and fp32 on the CPU is as far from float64 as the card is.
    The control: with the backward outside ``fp32_convs``, the conv1_1
    gradient misses 1e-4."""
    import contextlib
    import copy

    from aip_tpu_torch.models import vgg19_std
    from aip_tpu_torch.pipelines import nst

    params_cpu = vgg19_std.init_vgg19_params(torch.Generator().manual_seed(0), "cpu")
    params = copy.deepcopy(params_cpu).to(cuda)
    g = np.random.default_rng(36)
    c = torch.from_numpy(g.random((1, 512, 512, 3)).astype(np.float32))
    s = torch.from_numpy(g.random((1, 512, 512, 3)).astype(np.float32))

    def step(dev, layers):
        targets = nst.nst_targets(params if dev == cuda else params_cpu, c.to(dev), s.to(dev),
                                  torch.ones(1, device=dev), layers, layers[0])
        loss, grad = nst.nst_loss_and_grad(params if dev == cuda else params_cpu, *targets,
                                           style_layers=layers, content_layer=layers[0])
        return loss.item(), grad.cpu()

    def on_card_with_tf32(layers):
        torch.backends.cudnn.allow_tf32 = True
        try:
            out = step(cuda, layers)
            assert torch.backends.cudnn.allow_tf32
        finally:
            torch.backends.cudnn.allow_tf32 = False
        return out

    full = vgg19_std.NST_STYLE_LAYERS
    loss, _ = on_card_with_tf32(full)
    loss_ref, _ = step("cpu", full)
    assert abs(loss - loss_ref) <= 1e-4 * abs(loss_ref)
    _, grad_ref = step("cpu", ("conv1_1",))
    assert _max_rel_err(on_card_with_tf32(("conv1_1",))[1], grad_ref) <= 1e-4
    monkeypatch.setattr(nst, "fp32_convs", contextlib.nullcontext)
    assert _max_rel_err(on_card_with_tf32(("conv1_1",))[1], grad_ref) > 1e-4


def _fp32_gate(ref, ref64):
    """A check of a gradient dict against the CPU's ``ref``: each parameter's
    relative L2 error within 1e-5 plus 4 times the CPU's own fp32 distance
    from float64 (``ref`` from ``ref64``) there (chip_smoke.py's
    ``_fp32_gate``). The floor differs by parameter: the decoder's deep
    convs read 1e-4 (per-channel style statistics make their sums cancel),
    the rest 1e-6. A parameter whose float64 gradient is below 1e-6 of the
    largest (a CIN beta before another CIN: 0 in exact arithmetic) is left
    out. Returns the largest error over its gate."""
    norm = {k: float(v.double().norm()) for k, v in ref64.items()}
    keep = [k for k in norm if norm[k] >= 1e-6 * max(norm.values())]

    def errors(grads, against):
        return {k: float((grads[k].double().cpu() - against[k].double().cpu()).norm()) / norm[k]
                for k in keep}

    floor = errors(ref, ref64)
    return lambda grads: max(e / (1e-5 + 4 * floor[k]) for k, e in errors(grads, ref).items())


def _on_card_with_tf32(fn):
    torch.backends.cudnn.allow_tf32 = True
    try:
        out = fn()
        torch.cuda.synchronize()
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = False
    return out


@pytest.mark.cuda
def test_decoder_train_step_holds_fp32_under_pytorchs_default_tf32_flags(cuda, monkeypatch):
    """The decoder trainer's forward and backward (``train_loss_and_grads``,
    what each step runs) at 2 x 64^2 with cuDNN's TF32 on, as PyTorch
    starts: the loss within 1e-5 relative of the CPU's; the gradient of the
    relu1_1 style term, which reaches no max pool, within ``_fp32_gate``
    (chip_smoke.py phase 38's gate), the fp32 head and tail kernels
    launched. The control: with the backward outside ``fp32_convs``, the
    gradient misses the gate."""
    import contextlib
    import copy

    from aip_tpu_torch.parallel import train as ptrain

    vgg_c, dec_c = tvgg.init_vgg_params(0, "cpu"), tdec.init_decoder_params(1, "cpu")
    vgg, dec = copy.deepcopy(vgg_c).to(cuda), copy.deepcopy(dec_c).to(cuda)
    g = np.random.default_rng(38)
    c = torch.from_numpy(g.random((2, 64, 64, 3)).astype(np.float32))
    s = torch.from_numpy(g.random((2, 64, 64, 3)).astype(np.float32))
    term = dict(style_weight=1.0, content_weight=0.0, style_taps=("relu1_1",))

    loss_ref, _, _ = ptrain.train_loss_and_grads(dec_c, vgg_c, c, s)
    _, _, ref = ptrain.train_loss_and_grads(dec_c, vgg_c, c, s, **term)
    _, _, ref64 = ptrain.train_loss_and_grads(copy.deepcopy(dec_c).double(),
                                              copy.deepcopy(vgg_c).double(), c.double(),
                                              s.double(), compute_dtype=torch.float64, **term)
    held = _fp32_gate(ref, ref64)
    K.reset_launch_counts()
    loss, _, _ = _on_card_with_tf32(lambda: ptrain.train_loss_and_grads(
        dec, vgg, c.to(cuda), s.to(cuda)))
    assert K.route_launch_counts()["fp32"] == {"encode_head": 1, "decode_tail": 1}
    assert abs(loss.item() - loss_ref.item()) <= 1e-5 * abs(loss_ref.item())
    _, _, grads = _on_card_with_tf32(lambda: ptrain.train_loss_and_grads(
        dec, vgg, c.to(cuda), s.to(cuda), **term))
    assert held(grads) <= 1.0
    monkeypatch.setattr(ptrain, "fp32_convs", contextlib.nullcontext)
    _, _, grads = _on_card_with_tf32(lambda: ptrain.train_loss_and_grads(
        dec, vgg, c.to(cuda), s.to(cuda), **term))
    assert held(grads) > 1.0


@pytest.mark.cuda
def test_distillation_step_holds_fp32_under_pytorchs_default_tf32_flags(cuda, monkeypatch):
    """The distillation's forward and backward (``distill_loss_and_grads``)
    at 2 x 64^2, one style, with cuDNN's TF32 on: the loss within 1e-5
    relative of the CPU's, the fp32 head kernel launched 4 times (teacher
    content and style, student, teacher features) and the tail once; the
    gradient of the pixel term (``lambda_feat=0``: the stylizer alone, no
    max pool) within ``_fp32_gate``. The control: with the backward outside
    ``fp32_convs``, it misses."""
    import contextlib
    import copy

    from aip_tpu_torch.models import magenta
    from aip_tpu_torch.models import magenta_train as mt

    vgg_c, dec_c = tvgg.init_vgg_params(0, "cpu"), tdec.init_decoder_params(1, "cpu")
    vgg, dec = copy.deepcopy(vgg_c).to(cuda), copy.deepcopy(dec_c).to(cuda)
    stu_c = magenta.init_magenta_params(device="cpu")
    stu = magenta.MagentaParams(*(copy.deepcopy(m).to(cuda) for m in stu_c))
    g = np.random.default_rng(39)
    c = torch.from_numpy(g.random((2, 64, 64, 3)).astype(np.float32))
    s = torch.from_numpy(g.random((64, 64, 3)).astype(np.float32))

    loss_ref, _ = mt.distill_loss_and_grads(stu_c, vgg_c, dec_c, c, s)
    _, ref = mt.distill_loss_and_grads(stu_c, vgg_c, dec_c, c, s, lambda_feat=0.0)
    stu64 = magenta.MagentaParams(*(copy.deepcopy(m).double() for m in stu_c))
    _, ref64 = mt.distill_loss_and_grads(stu64, copy.deepcopy(vgg_c).double(),
                                         copy.deepcopy(dec_c).double(), c.double(), s.double(),
                                         lambda_feat=0.0)
    held = _fp32_gate(ref, ref64)
    K.reset_launch_counts()
    loss, _ = _on_card_with_tf32(lambda: mt.distill_loss_and_grads(
        stu, vgg, dec, c.to(cuda), s.to(cuda)))
    assert K.route_launch_counts()["fp32"] == {"encode_head": 4, "decode_tail": 1}
    assert abs(loss.item() - loss_ref.item()) <= 1e-5 * abs(loss_ref.item())
    run = lambda: mt.distill_loss_and_grads(stu, vgg, dec, c.to(cuda), s.to(cuda),  # noqa: E731
                                            lambda_feat=0.0)
    assert held(_on_card_with_tf32(run)[1]) <= 1.0
    monkeypatch.setattr(mt, "fp32_convs", contextlib.nullcontext)
    assert held(_on_card_with_tf32(run)[1]) > 1.0


@pytest.mark.cuda
def test_midas_on_the_card_matches_the_cpu(cuda):
    """MiDaS-small at full width from the seeded init, 1 x 256^2, with
    cuDNN's TF32 on: within 1e-4 of the CPU's largest |value|; the depth
    estimator on a 40x52 image likewise, on the card."""
    import copy

    from aip_tpu_torch.models import midas

    net_c = midas.init_midas_params(device="cpu")
    net = copy.deepcopy(net_c).to(cuda)
    x = torch.from_numpy(np.random.default_rng(40).random((1, 256, 256, 3)).astype(np.float32))
    ref = midas.midas_inverse_depth(net_c, x)
    out = _on_card_with_tf32(lambda: midas.midas_inverse_depth(net, x.to(cuda)))
    assert _max_rel_err(out.cpu(), ref) <= 1e-4
    img = np.random.default_rng(41).random((40, 52, 3)).astype(np.float32)
    ref = midas.make_depth_estimator(net_c)(img)
    out = _on_card_with_tf32(lambda: midas.make_depth_estimator(net)(img))
    assert out.device.type == "cuda" and _max_rel_err(out.cpu(), ref) <= 1e-4


@pytest.mark.cuda
def test_midas_estimator_refuses_a_tensor_on_another_device(cuda):
    """Weights on the card, the image on the CPU: the estimator raises
    rather than move either."""
    from aip_tpu_torch.models import depthnet, midas

    est = midas.make_depth_estimator(midas.init_midas_params(device=cuda))
    with pytest.raises(ValueError, match="move one of them"):
        est(torch.zeros(40, 52, 3))
    depthnet.register_depth_model(est)
    try:
        with pytest.raises(ValueError, match="move one of them"):
            depthnet.estimate_proximity(torch.zeros(40, 52, 3))
    finally:
        depthnet.register_depth_model(None)
