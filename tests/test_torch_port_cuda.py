"""The port's CUDA kernels on the card, against their plain versions.

Every test here is marked ``cuda`` and skips itself where CUDA is absent.
The file imports no JAX, so it also runs on a machine that has none:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

Tolerances, relative to the largest reference value: fp32 kernel against
the fp32 plain version with TF32 off, 1e-4 (sums in another order); bf16
kernel against the plain version run in fp32 on the same bf16-rounded
inputs and weights, 1e-2 (the kernel rounds its output to bf16).
"""

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
    assert C.launch_counts() == {"composite_macro_mxu_seg": 1, "composite_macro_mxu": 1}
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
