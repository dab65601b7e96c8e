"""The per-tile, fused and coefficient-walk compositors of
aip_tpu_torch.kernels.composite and the render paths that reach them,
against aip_tpu's, on the CPU.

Inputs are drawn with numpy from a seed (or taken from the committed
bed_0037 model) and handed to both packages. The JAX side runs its Pallas
kernels in interpret mode; the port's wrappers take their plain versions on
CPU tensors.

Tolerances: each plain version against its Pallas kernel at 1e-5 absolute
(the same float32 walk; XLA may fuse a multiply and an add where PyTorch
rounds each); the three rasterize paths at 1e-5 absolute on the scenes of
tests/test_gs_rasterizer.py; frames of the committed model at mean abs
<= 1e-5 with >= 99.9 % of values within 1e-4 (the coefficient walk's
quadratic terms cancel for sharp splats, so a rounding step more or less
moves a few pixels by more); PNGs within one 8-bit step.
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aip_tpu.gs import colorfield as JF
from aip_tpu.gs import compress as JCMP
from aip_tpu.gs import gaussians as JG
from aip_tpu.gs import rasterizer as JR
from aip_tpu.gs import render as JRN
from aip_tpu.gs import rvq as jrvq
from aip_tpu.ops.pallas import composite as JP
from aip_tpu_torch.gs import rasterizer as TR
from aip_tpu_torch.gs import render as TRN
from aip_tpu_torch.kernels import composite as TK
from test_torch_port_gs_render import _look_at, _state_np, bed_subset  # noqa: F401

torch.set_num_threads(2)

TOL = 1e-5


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture
def jax_interpret(monkeypatch):
    """The JAX rasterizer's Pallas compositors in interpret mode, as its
    own tests run them on the CPU (its render() passes interpret=False)."""
    for name in ("composite_tiles_pallas", "composite_from_macro_pallas",
                 "composite_macro_blocks_pallas"):
        orig = getattr(JP, name)
        monkeypatch.setattr(JP, name, lambda *a, _f=orig, **kw: _f(*a, **{**kw, "interpret": True}))


# ---------------------------------------------------------------------------
# The plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

def _slots(g, rows, k, origin_x, origin_y, spread=20.0):
    """Gathered slot arrays [rows, k, .] with means around each row's
    16 px origin: mean, conic, colour, opacity, valid (a prefix)."""
    mean = np.stack([origin_x[:, None] + g.random((rows, k)) * spread - 2,
                     origin_y[:, None] + g.random((rows, k)) * spread - 2], -1)
    sig = g.random((rows, k)) * 4 + 1.5
    conic = np.stack([1 / sig ** 2, (g.random((rows, k)) - 0.5) * 0.3 / sig ** 2,
                      1 / (sig * (g.random((rows, k)) + 0.6)) ** 2], -1)
    color = g.random((rows, k, 3))
    op = g.random((rows, k)) * 0.7 + 0.1
    valid = np.ones((rows, k))
    valid[:, k - k // 4:] = 0.0
    return [a.astype(np.float32) for a in (mean, conic, color, op, valid)]


def _tile_edge_cases(g, k, tile_w=4, n_tiles=8):
    """Per-tile slots with edge cases: tile 1 empty (no valid slot), tile 2
    saturating below T = 1e-4, tile 3 a splat at the 0.99 clamp and one of
    opacity below 1/255, tile 4 invalid slots between valid ones."""
    t = np.arange(n_tiles)
    x0, y0 = ((t % tile_w) * 16).astype(np.float32), ((t // tile_w) * 16).astype(np.float32)
    mean, conic, color, op, valid = _slots(g, n_tiles, k, x0, y0)
    valid[1] = 0.0
    conic[2, :, 0] = conic[2, :, 2] = 1e-3
    conic[2, :, 1] = 0.0
    op[2] = 0.98
    valid[2] = 1.0
    mean[3, 0] = [x0[3] + 7.5, y0[3] + 7.5]
    op[3, 0] = 1.0
    op[3, 1] = 0.003
    valid[4, ::3] = 0.0
    return mean, conic, color, op, valid


@pytest.mark.parametrize("case,k", [("random", 48), ("edge", 40), ("random", 1), ("random", 130)])
def test_composite_tiles_plain_matches_pallas(case, k):
    g = np.random.default_rng(11 + k)
    tile_w, n_tiles = 4, 8
    if case == "edge":
        arrays = _tile_edge_cases(g, k, tile_w, n_tiles)
    else:
        t = np.arange(n_tiles)
        arrays = _slots(g, n_tiles, k, (t % tile_w) * 16.0, (t // tile_w) * 16.0)
    bg = np.array([0.2, 0.5, 0.1], np.float32)
    ref = np.asarray(JP.composite_tiles_pallas(*map(jnp.asarray, arrays), jnp.asarray(bg),
                                               tile_w=tile_w, interpret=True))
    TK.reset_launch_counts()
    out = TK.composite_tiles(*map(_t, arrays), _t(bg), tile_w).numpy()
    assert TK.launch_counts()["composite_tiles"] == 0        # the plain version ran
    assert out.shape == ref.shape == (n_tiles, 3, 16, 16)
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL)
    if case == "edge":
        np.testing.assert_array_equal(out[1], np.broadcast_to(bg[:, None, None], (3, 16, 16)))


@pytest.mark.parametrize("k", [64, 300])
def test_composite_from_macro_plain_matches_pallas(k):
    """A 5 x 7 tile grid in macro blocks of 2 tiles (3 x 4 blocks), with an
    empty block, a block whose list ends early, a saturating block, a
    splat at the 0.99 clamp next to one below 1/255, and invalid slots
    between valid ones."""
    g = np.random.default_rng(12)
    th, tw, macro = 5, 7, 2
    mth, mtw = math.ceil(th / macro), math.ceil(tw / macro)
    b = np.arange(mth * mtw)
    arrays = _slots(g, mth * mtw, k, (b % mtw) * 32.0, (b // mtw) * 32.0, spread=36.0)
    mean, conic, _, op, valid = arrays
    valid[3] = 0.0
    valid[5, 7:] = 0.0
    conic[2, :, 0] = conic[2, :, 2] = 1e-3
    conic[2, :, 1] = 0.0
    op[2], valid[2] = 0.98, 1.0
    mean[6, 0] = [2 * 32 + 7.5, 32 + 7.5]
    op[6, 0], op[6, 1] = 1.0, 0.003
    valid[7, ::3] = 0.0
    bg = np.array([0.05, 0.05, 0.1], np.float32)
    kw = dict(n_tiles=th * tw, tile_w=tw, macro=macro, macro_tile_w=mtw)
    ref = np.asarray(JP.composite_from_macro_pallas(*map(jnp.asarray, arrays), jnp.asarray(bg),
                                                    interpret=True, **kw))
    out = TK.composite_from_macro(*map(_t, arrays), _t(bg), **kw).numpy()
    assert out.shape == ref.shape == (th * tw, 3, 16, 16)
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL)
    np.testing.assert_array_equal(
        TK.macro_of_tile(th * tw, tw, macro, mtw).numpy(),
        [(i // tw // macro) * mtw + (i % tw) // macro for i in range(th * tw)])


def _block_rows(g, m, kc, bs, counts, sigma):
    """Coefficient rows [m, kc, 8] and colours [m, kc, 4] as _macro_coeffs
    builds them, from splats of ``sigma`` = (least, span) px spread over
    each block (block-local coordinates): block 0 count 0, block 1 a count
    that is no multiple of 32, block 2 opaque within its first group, block
    3 drawn only near its origin (so the far pixels keep T = 1, as pixels
    past an image edge do)."""
    mx = g.random((m, kc)) * bs
    my = g.random((m, kc)) * bs
    mx[3], my[3] = g.random(kc) * bs * 0.2, g.random(kc) * bs * 0.2
    sig = g.random((m, kc)) * sigma[1] + sigma[0]
    ca, cc = 1 / sig ** 2, 1 / (sig * (g.random((m, kc)) + 0.6)) ** 2
    cb = (g.random((m, kc)) - 0.5) * 0.3 / sig ** 2
    ca[3], cc[3], cb[3] = 0.1, 0.1, 0.0
    ca[2, :10], cc[2, :10], cb[2, :10] = 1e-4, 1e-4, 0.0
    op = g.random((m, kc)) * 0.8 + 0.1
    op[2, :10] = 0.99
    coeff = np.stack([-0.5 * (ca * mx * mx + cc * my * my) - cb * mx * my, ca * mx + cb * my,
                      cc * my + cb * mx, -0.5 * ca, -0.5 * cc, -cb, op, np.zeros_like(op)], -1)
    for i, c in enumerate(counts):
        coeff[i, c:, 6] = 0.0      # empty slots carry opacity 0, as _macro_coeffs writes
    colors = np.concatenate([g.random((m, kc, 3)), np.zeros((m, kc, 1))], -1)
    return coeff.astype(np.float32), colors.astype(np.float32)


@pytest.mark.parametrize("bs,kc,splats", [(16, 40, "wide"), (32, 100, "wide"), (64, 70, "wide"),
                                          (32, 100, "sharp"), (64, 70, "sharp"),
                                          (128, 40, "sharp")])
def test_composite_macro_blocks_plain_matches_pallas(bs, kc, splats):
    """Every block of bs x bs pixels, with count 0, a count of 37 (no
    multiple of 32), a block opaque within its first group, a block drawn
    near its origin only and full blocks. bs 128 (macro 8) is held here on
    the plain version; the CUDA kernel takes 16, 32 and 64 and refuses 128
    (tests/test_torch_port_cuda.py).

    Wide splats (sigma 6-16 px) at 1e-5. Sharp ones (sigma 1.5-6.5 px) at
    max abs 2e-4 and mean abs 1e-6: XLA on the CPU fuses the quadratic
    form's multiply-adds (``c + a * b`` rounds once; measured on every draw
    of a jitted ``c + a * b``), where the port rounds each product in the
    order the TPU kernel writes them, as the CUDA kernel does. For a sharp
    splat far from the block origin the terms (cxx px^2 reaches ~1e3)
    cancel, so that rounding step moves a pixel by up to 1.1e-4 (measured
    at bs 128; 2.4e-5 at bs 64, 5.2e-6 at bs 32)."""
    g = np.random.default_rng(13 + bs)
    m = 6
    counts = np.array([0, min(37, kc), kc, kc, kc, kc // 2], np.int32)
    coeff, colors = _block_rows(g, m, kc, bs, counts, (6, 10) if splats == "wide" else (1.5, 5))
    bg = np.array([0.2, 0.1, 0.3], np.float32)
    ref = np.asarray(JP.composite_macro_blocks_pallas(
        jnp.asarray(coeff), jnp.asarray(colors), jnp.asarray(counts), jnp.asarray(bg), bs=bs,
        interpret=True))
    out = TK.composite_macro_blocks(_t(coeff), _t(colors), _t(counts), _t(bg), bs=bs).numpy()
    assert out.shape == (m, 3, 1, bs * bs)
    err = np.abs(out.reshape(ref.shape) - ref)
    if splats == "wide":
        assert err.max() <= TOL, err.max()
    else:
        assert err.max() <= 2e-4 and err.mean() <= 1e-6, (err.max(), err.mean())
    np.testing.assert_array_equal(out[0, :, 0], np.broadcast_to(bg[:, None], (3, bs * bs)))
    np.testing.assert_array_equal(out[3, :, 0].reshape(3, bs, bs)[:, -1, -1], bg)


def test_blocks_walked_rows_counts_the_early_exit():
    """Rows walked: 0 for count 0, all 37 of a dim block, and one group of
    32 for a block that is opaque within it (of its 90)."""
    coeff = np.zeros((3, 90, 8), np.float32)
    coeff[:, :, 6] = 0.05
    coeff[2, :10, 6] = 0.99
    colors = np.ones((3, 90, 4), np.float32)
    counts = torch.tensor([0, 37, 90], dtype=torch.int32)
    assert TK.blocks_walked_rows(_t(coeff), _t(colors), counts, bs=32) == 37 + 32


def test_valid_ends():
    valid = torch.tensor([[1, 1, 0, 0], [0, 0, 0, 0], [1, 0, 1, 0], [1, 1, 1, 1.0]])
    assert TK.valid_ends(valid).tolist() == [2, 0, 3, 4]
    assert TK.valid_ends(torch.zeros(3, 0)).tolist() == [0, 0, 0]


# ---------------------------------------------------------------------------
# The render paths (scenes of tests/test_gs_rasterizer.py)
# ---------------------------------------------------------------------------

def _camera(w, h, dist=4.0):
    from aip_tpu_torch.gs.cameras import Camera
    return Camera(colmap_id=0, R=np.eye(3), T=np.array([0.0, 0.0, dist]), FoVx=np.pi / 3,
                  FoVy=np.pi / 3, image=np.zeros((h, w, 3), np.float32), image_name="t", uid=0)


def _scene(rng, n):
    means = (rng.random((n, 3)) * 2 - 1).astype(np.float32)
    scales = (rng.random((n, 3)) * 0.15 + 0.05).astype(np.float32)
    quats = rng.standard_normal((n, 4)).astype(np.float32)
    opac = (rng.random(n) * 0.8 + 0.1).astype(np.float32)
    colors = rng.random((n, 3)).astype(np.float32)
    return means, scales, quats, opac, colors


def _both(rng, n, size, bg):
    cam = _camera(size, size)
    arrays = list(_scene(rng, n)) + [cam.world_view_transform, cam.full_proj_transform, bg]
    tan = math.tan(cam.FoVx * 0.5), math.tan(cam.FoVy * 0.5)
    return ([jnp.asarray(np.asarray(a, np.float32)) for a in arrays],
            [_t(np.asarray(a, np.float32)) for a in arrays], tan)


@pytest.mark.parametrize("size,n,macro", [(32, 10, 1), (64, 40, 2)])
def test_rasterize_fast_matches_jax(rng, size, n, macro):
    jargs, targs, (tx, ty) = _both(rng, n, size, np.array([0.1, 0.2, 0.3]))
    kw = dict(max_per_tile=16 if macro == 1 else 48, chunk=16)
    if macro > 1:
        kw.update(macro=macro, macro_capacity=64)
    ref, _ = JR.rasterize_fast(*jargs, JR.RasterSettings(size, size, **kw), tanfovx=tx,
                               tanfovy=ty, interpret=True)
    out, radii = TR.rasterize_fast(*targs, TR.RasterSettings(size, size, **kw), tanfovx=tx,
                                   tanfovy=ty)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=TOL)
    flat, _ = TR.rasterize(*targs, TR.RasterSettings(size, size, **kw), tanfovx=tx, tanfovy=ty)
    np.testing.assert_allclose(out.numpy(), flat.detach().numpy(), rtol=0, atol=TOL)
    assert radii.shape == (n,)


def test_rasterize_fused_matches_jax(rng):
    jargs, targs, (tx, ty) = _both(rng, 30, 64, np.array([0.05, 0.05, 0.1]))
    kw = dict(max_per_tile=40, chunk=16, macro=2, macro_capacity=64)
    ref, _ = JR.rasterize_fused(*jargs, JR.RasterSettings(64, 64, **kw), tanfovx=tx, tanfovy=ty,
                                interpret=True)
    out, _ = TR.rasterize_fused(*targs, TR.RasterSettings(64, 64, **kw), tanfovx=tx, tanfovy=ty)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=TOL)
    flat, _ = TR.rasterize(*targs, TR.RasterSettings(64, 64, max_per_tile=40, chunk=16),
                           tanfovx=tx, tanfovy=ty)
    np.testing.assert_allclose(out.numpy(), flat.detach().numpy(), rtol=0, atol=TOL)


@pytest.mark.parametrize("select_backend", ["pairsort", "merge"])
def test_rasterize_matmul_pallas_backend_matches_jax(rng, select_backend):
    """composite_backend="pallas" is always the windowed selection into the
    coefficient walk (the segment rule is for "mxu" only). Against JAX at
    max abs 1e-4 and mean abs 1e-6: the scene's splats are a few pixels
    wide, so XLA's fused multiply-adds in the quadratic form (see
    test_composite_macro_blocks_plain_matches_pallas) move single pixels by
    up to 2.6e-5 (measured). Against the port's flat ``rasterize`` at 2e-4,
    the JAX package's own tolerance for the macro-block composites."""
    jargs, targs, (tx, ty) = _both(rng, 30, 64, np.array([0.05, 0.1, 0.05]))
    kw = dict(max_per_tile=40, chunk=16, macro=2, macro_capacity=64,
              composite_backend="pallas", select_backend=select_backend)
    ref, _ = JR.rasterize_matmul(*jargs, JR.RasterSettings(64, 64, **kw), tanfovx=tx,
                                 tanfovy=ty, interpret=True)
    ts = TR.RasterSettings(64, 64, **kw)
    assert not TR.uses_segment_path(30, ts)
    out, _ = TR.rasterize_matmul(*targs, ts, tanfovx=tx, tanfovy=ty)
    err = np.abs(out.numpy() - np.asarray(ref))
    assert err.max() <= 1e-4 and err.mean() <= 1e-6, (err.max(), err.mean())
    flat, _ = TR.rasterize(*targs, TR.RasterSettings(64, 64, max_per_tile=40, chunk=16),
                           tanfovx=tx, tanfovy=ty)
    np.testing.assert_allclose(out.numpy(), flat.detach().numpy(), rtol=0, atol=2e-4)


@pytest.mark.parametrize("backend", ["Pallas", "cuda", "xla"])
def test_rasterize_matmul_refuses_an_unknown_backend(rng, backend):
    _, targs, (tx, ty) = _both(rng, 10, 64, np.zeros(3))
    s = TR.RasterSettings(64, 64, max_per_tile=40, chunk=16, macro=2, macro_capacity=64,
                          composite_backend=backend)
    with pytest.raises(ValueError, match="composite_backend"):
        TR.rasterize_matmul(*targs, s, tanfovx=tx, tanfovy=ty)


def test_macro_coeffs_match_jax(rng):
    jargs, targs, (tx, ty) = _both(rng, 40, 64, np.zeros(3))
    s = TR.RasterSettings(64, 64, max_per_tile=40, chunk=16, macro=2, macro_capacity=64)
    m2d, depth, conic, radii, valid = TR.project_gaussians(*targs[:3], *targs[5:7], tx, ty, s)
    idx, _ = TR._macro_select(m2d, depth, radii, valid, s, 2, 2)
    ref = JR._macro_coeffs(jnp.asarray(idx.numpy()), jnp.asarray(m2d.numpy()),
                           jnp.asarray(conic.numpy()), jargs[4], jargs[3], 4, 2, 32)
    out = TR._macro_coeffs(idx, m2d, conic, targs[4], targs[3], 4, 2, 32)
    for a, b in zip(out, ref[:4]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# render() and the serving frame on the committed model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("how", ["renderer", "use_pallas", "frame_fn"])
def test_pallas_renders_of_the_committed_model_match_jax(bed_subset, rng, jax_interpret, how):
    """render(renderer="pallas"), render(use_pallas=True) (both
    rasterize_fast, the per-tile walk) and make_inference_frame_fn with
    composite_backend="pallas" at macro 4 (the coefficient walk) on 4096
    splats of bed_0037 at 96 x 128: mean abs <= 1e-5, and >= 99.9 % of
    values within 1e-4 for the per-tile walk. The coefficient walk keeps
    the mean, with >= 99.5 % within 1e-4 and max abs <= 1e-2: the model's
    sharp splats make its quadratic terms cancel (ROADMAP queue 3), and
    XLA's fused multiply-adds on the CPU round them once where the port
    rounds twice, which moves 0.23 % of values by more than 1e-4 (max
    5.2e-3, measured)."""
    js, jf, ts, tf, center, dist = bed_subset
    cam = _look_at(center, dist, 0.7, 0.45, 128, 96)
    style = (rng.standard_normal((1, 512)) * 0.5).astype(np.float32)
    bg = np.array([0.1, 0.0, 0.2], np.float32)
    sel = json.loads((Path(__file__).resolve().parent.parent / "docs" / "examples"
                      / "bed_0037_r5" / "cfg_args.json").read_text())["selection"]
    TK.reset_launch_counts()
    if how == "frame_fn":
        extra = dict(macro=4, composite_backend="pallas")
        jset = JRN.settings_from_selection(sel, 96, 128, **extra)
        tset = TRN.settings_from_selection(sel, 96, 128, **extra)
        ref = JRN.render_frame(JRN.make_inference_frame_fn(
            js, jf, jset, jnp.asarray(bg), style_f=jnp.asarray(style), interpret=True), cam)
        fn = TRN.make_inference_frame_fn(ts, tf, tset, _t(bg), style_f=_t(style))
        assert fn.settings.composite_backend == "pallas" and fn.settings.macro == 4
        out = TRN.render_frame(fn, cam)
    else:
        kw = dict(renderer="pallas") if how == "renderer" else dict(use_pallas=True)
        jset = JRN.settings_from_selection(sel, 96, 128, max_per_tile=64)
        tset = TRN.settings_from_selection(sel, 96, 128, max_per_tile=64)
        ref = JRN.render(cam, js, jf, jnp.asarray(bg), style_f=jnp.asarray(style),
                         mode="inference", settings=jset, **kw).render
        out = TRN.render(cam, ts, tf, _t(bg), style_f=_t(style), mode="inference",
                         settings=tset, **kw).render
    assert sum(TK.launch_counts().values()) == 0
    err = np.abs(out.numpy().astype(np.float64) - np.asarray(ref, np.float64))
    within = 0.995 if how == "frame_fn" else 0.999
    assert err.mean() <= 1e-5 and (err <= 1e-4).mean() >= within, (err.mean(), err.max())
    assert err.max() <= 1e-2
    assert np.abs(np.asarray(ref) - bg).max(axis=-1).mean() > 0.02   # splats drawn


def test_run_3dgs_rendering_pallas_matches_jax(tmp_path, rng, jax_interpret):
    """run_3dgs_rendering(renderer="pallas") of both packages on a seeded
    model (no style branch) over a 2-view 32^2 Blender scene."""
    from PIL import Image

    from aip_tpu.gs.pipeline import run_3dgs_rendering as j_render
    from aip_tpu_torch.gs.pipeline import run_3dgs_rendering as t_render

    model = _tiny_model(tmp_path, rng)
    jgif = j_render(None, str(model), output_dir=str(tmp_path / "j"), max_per_tile=16,
                    renderer="pallas")
    TK.reset_launch_counts()
    tgif = t_render(None, str(model), output_dir=str(tmp_path / "t"), max_per_tile=16,
                    renderer="pallas", device="cpu")
    assert Path(jgif).is_file() and Path(tgif).is_file()
    for i in range(2):
        a = np.asarray(Image.open(tmp_path / "j" / f"{i:05d}.png"), np.int16)
        b = np.asarray(Image.open(tmp_path / "t" / f"{i:05d}.png"), np.int16)
        assert a.shape == b.shape == (32, 32, 3)
        assert np.abs(a - b).max() <= 1 and a.max() > 10


def _tiny_model(tmp_path, rng, n_views=2, size=32, style_dim=None):
    """A seeded model saved by aip_tpu's save_npz over a Blender scene of
    ``n_views`` cameras on an orbit around the origin."""
    from PIL import Image

    scene = tmp_path / "scene"
    (scene / "images").mkdir(parents=True)
    frames = []
    for i in range(n_views):
        ang = i * 2.0
        c2w = np.eye(4)
        c2w[0, 3], c2w[2, 3] = 3 * math.sin(ang), 3 * math.cos(ang)
        c2w[:3, :3] = [[math.cos(ang), 0, math.sin(ang)], [0, 1, 0],
                       [-math.sin(ang), 0, math.cos(ang)]]
        frames.append({"file_path": f"./images/r_{i}", "transform_matrix": c2w.tolist()})
        Image.fromarray(np.zeros((size, size, 3), np.uint8)).save(scene / "images" / f"r_{i}.png")
    (scene / "transforms_train.json").write_text(
        json.dumps({"camera_angle_x": 0.8, "frames": frames}))
    state_np = _state_np(rng, 120)
    state_np["xyz"] *= 0.6
    field = JF.init_colorfield(jax.random.PRNGKey(1), style_dim=style_dim, log2_hashmap=10)
    field = field._replace(hash_tables=field.hash_tables * 1e3)

    def books(d):
        return jrvq.RVQState(jnp.asarray(rng.standard_normal((2, 8, d)) * 0.3, jnp.float32))

    model = tmp_path / "model"
    JCMP.save_npz(model / "model.npz", JG.GaussianState(**{k: jnp.asarray(v) for k, v in
                                                           state_np.items()}),
                  field, books(3), books(4))
    (model / "cfg_args.json").write_text(json.dumps({"source_path": str(scene),
                                                     "white_background": False}))
    return model
