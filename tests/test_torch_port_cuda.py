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


# ---------------------------------------------------------------------------
# Differentiable per-tile compositor (kernels A and B) and the hash-table
# gradient (kernel C)
# ---------------------------------------------------------------------------

def _gathered(g, n_tiles=8, k=48, tile_w=4):
    """Gathered per-tile arrays around each tile's pixels, with edge cases:
    tile 1 empty (every slot invalid), tile 2 saturating (T falls below
    1e-4), tile 3 a splat at the 0.99 clamp and one of opacity 0, tile 4
    invalid slots between valid ones."""
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
    return [torch.from_numpy(a) for a in (mean, conic, color, op, valid)]


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 48, 128])
def test_composite_ad_kernels_match_plain(cuda, k):
    """Kernel A's image and final transmittance at 1e-5 absolute, kernel
    B's four gradients at 1e-4 of each one's largest value (the same fp32
    walks; B sums the 256 pixels in another order)."""
    from aip_tpu_torch.kernels import composite_ad as AD

    g = np.random.default_rng(4)
    args = [a.to(cuda) for a in _gathered(g, k=k)]
    bg = torch.tensor([0.2, 0.5, 0.1], device=cuda)
    g_out = torch.from_numpy(g.standard_normal((8, 3, 16, 16)).astype(np.float32)).to(cuda)
    AD.reset_launch_counts()
    out, tf = AD.composite_ad_fwd(*args, bg, 4)
    grads = AD.composite_ad_bwd(*args, bg, tf, g_out, 4)
    torch.cuda.synchronize()
    assert AD.launch_counts() == {"composite_ad_fwd": 1, "composite_ad_bwd": 1}
    ref_out, ref_tf = AD.composite_ad_fwd_reference(*args, bg, 4)
    torch.testing.assert_close(out, ref_out, rtol=0, atol=1e-5)
    torch.testing.assert_close(tf, ref_tf, rtol=0, atol=1e-5)
    ref_grads = AD.composite_ad_bwd_reference(*args, bg, ref_tf, g_out, 4)
    for a, b in zip(grads, ref_grads):
        scale = max(float(b.abs().max()), 1e-8)
        assert float((a - b).abs().max()) / scale < 1e-4
        assert float(a[1].abs().max()) == 0.0          # the empty tile


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
