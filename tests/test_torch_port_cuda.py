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
