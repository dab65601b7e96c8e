"""The fused walk's kernel, emulated in plain torch on the CPU
(``kernels/composite.py``: ``from_macro_live``,
``composite_from_macro_culled_reference`` and ``from_macro_work``).

The CUDA kernel (``from_macro_kernel`` of ``csrc/composite_walk.cu``)
cannot run here; its emulation shows what the design rests on:
* the cull drops no (tile, slot) where alpha >= 1/255 at a pixel of the
  tile (by the plain version's float32 arithmetic), over macro blocks of 2,
  3 and 4 tiles with edge blocks, random lists, a sweep of splats placed
  just inside and just outside the 1/255 contour at a tile's corner pixel
  (round, thin, large and rotated conics, four opacities), conics that are
  not positive definite and the committed model's lists at 128^2 and
  192^2; and it does drop splats 1e-4 outside the contour, so the margin is
  not vacuous;
* so each tile's walk over its live slots equals the plain version's walk
  over every slot (``torch.equal``);
* the culled walk agrees with the JAX package's ``composite_from_macro_pallas``
  in interpret mode at the tolerance of tests/test_torch_port_gs_walk.py,
  1e-5 (the same float32 walk; XLA may fuse a multiply and an add);
* ``from_macro_work`` counts the pairs behind the kernel's bounds.

Inputs come from numpy seeds or the committed model.
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aip_tpu.ops.pallas import composite as JP
from aip_tpu_torch.gs import colorfield as TF
from aip_tpu_torch.gs import compress as TCMP
from aip_tpu_torch.gs import rasterizer as TR
from aip_tpu_torch.gs import render as TRN
from aip_tpu_torch.kernels import composite as TK
from test_torch_port_composite_macro_cull import EPS, OPS, SHAPES, _conics, _look_at

torch.set_num_threads(2)

BED = Path(__file__).resolve().parent.parent / "docs" / "examples" / "bed_0037_r5"
ALPHA_MIN = 1.0 / 255.0
TOL = 1e-5  # tests/test_torch_port_gs_walk.py's, against the Pallas kernel


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _grid(th, tw, macro):
    """(kw, macro blocks a side) of a th x tw tile grid."""
    mth, mtw = math.ceil(th / macro), math.ceil(tw / macro)
    return dict(n_tiles=th * tw, tile_w=tw, macro=macro, macro_tile_w=mtw), mth, mtw


def _random(seed, th, tw, macro, kc=120):
    """Slots scattered up to 40 px around each macro block (many far from
    most of its tiles), sizes 0.5-12 px, any rotation, opacities 0.002-1,
    valid a prefix of random length; one empty list and one list with
    invalid slots between valid ones."""
    g = np.random.default_rng(seed)
    kw, mth, mtw = _grid(th, tw, macro)
    m, bs = mth * mtw, 16 * macro
    b = np.arange(m)
    cx = ((b % mtw) * bs + bs / 2)[:, None]
    cy = ((b // mtw) * bs + bs / 2)[:, None]
    mean = np.stack([cx + (g.random((m, kc)) - 0.5) * (bs + 80),
                     cy + (g.random((m, kc)) - 0.5) * (bs + 80)], -1)
    conic = _conics(g.uniform(0.5, 12, (m, kc)), g.uniform(0.5, 12, (m, kc)),
                    g.uniform(0, math.pi, (m, kc)))
    op = np.exp(g.uniform(math.log(0.002), 0, (m, kc)))
    valid = (np.arange(kc)[None, :] < g.integers(0, kc + 1, (m, 1))).astype(np.float32)
    valid[0] = 0.0
    valid[-1, ::3] = 0.0
    arrays = [mean, conic, g.random((m, kc, 3)), op, valid]
    return [_t(a.astype(np.float32)) for a in arrays], kw


def _edge():
    """tests/test_torch_port_gs_walk.py's 5 x 7 tiles in macro blocks of 2:
    an empty block, a list that ends early, a saturating block, a splat at
    the 0.99 clamp next to one below 1/255, invalid slots between valid
    ones."""
    g = np.random.default_rng(12)
    kw, mth, mtw = _grid(5, 7, 2)
    b = np.arange(mth * mtw)
    kc = 64
    x0, y0 = (b % mtw) * 32.0, (b // mtw) * 32.0
    mean = np.stack([x0[:, None] + g.random((12, kc)) * 36 - 2,
                     y0[:, None] + g.random((12, kc)) * 36 - 2], -1)
    sig = g.random((12, kc)) * 4 + 1.5
    conic = np.stack([1 / sig ** 2, (g.random((12, kc)) - 0.5) * 0.3 / sig ** 2,
                      1 / (sig * (g.random((12, kc)) + 0.6)) ** 2], -1)
    op = g.random((12, kc)) * 0.7 + 0.1
    valid = np.ones((12, kc))
    valid[:, kc - kc // 4:] = 0.0
    valid[3] = 0.0
    valid[5, 7:] = 0.0
    conic[2, :, 0] = conic[2, :, 2] = 1e-3
    conic[2, :, 1] = 0.0
    op[2], valid[2] = 0.98, 1.0
    mean[6, 0] = [2 * 32 + 7.5, 32 + 7.5]
    op[6, 0], op[6, 1] = 1.0, 0.003
    valid[7, ::3] = 0.0
    arrays = [mean, conic, g.random((12, kc, 3)), op, valid]
    return [_t(a.astype(np.float32)) for a in arrays], kw


CORNER = 48.0   # the top-left pixel of tile (3, 3) of an 8 x 8 grid


def _contour_sweep(kind):
    """One macro block of 4 x 4 tiles in a 4 x 4 grid, listing for each
    opacity in OPS one splat per EPS: its mean up and left of pixel (48,
    48), the top-left pixel of tile (3, 3), on the diagonal, where
    q(corner - mean) = L (1 + eps) and L = 2 ln(255 op) is the 1/255
    contour. Negative eps is just inside, positive just outside (for an
    unrotated conic the corner is the tile's nearest pixel)."""
    s1, s2, theta = SHAPES[kind]
    a, b, c = _conics(np.float64(s1), np.float64(s2), np.float64(theta))
    u = np.array([-1.0, -1.0]) / math.sqrt(2.0)
    qu = a * u[0] ** 2 + 2 * b * u[0] * u[1] + c * u[1] ** 2
    mean, conic, op = [], [], []
    for o in OPS:
        level = 2 * math.log(255 * o)
        for e in EPS:
            d = math.sqrt(max(level * (1 + e), 0.0) / qu)
            mean.append([CORNER + d * u[0], CORNER + d * u[1]])
            conic.append([a, b, c])
            op.append(o)
    k = len(op)
    color = np.random.default_rng(5).random((1, k, 3))
    arrays = [np.asarray(mean)[None], np.asarray(conic)[None], color, np.asarray(op)[None],
              np.ones((1, k))]
    return ([_t(x.astype(np.float32)) for x in arrays],
            dict(n_tiles=16, tile_w=4, macro=4, macro_tile_w=1))


def _not_positive_definite():
    """Conics with b^2 >= a c, a <= 0 or c <= 0 around one macro block of 2:
    every one stays on every tile's list."""
    g = np.random.default_rng(9)
    n = 24
    mean = g.random((1, n, 2)) * 200 - 80
    a, c = g.uniform(-0.2, 0.3, n), g.uniform(-0.2, 0.3, n)
    b = np.sqrt(np.abs(a * c)) * g.uniform(1, 2, n)
    b[::3], a[::3] = 0.0, -0.01
    arrays = [mean, np.stack([a, b, c], -1)[None], g.random((1, n, 3)),
              g.uniform(0.01, 1, (1, n)), np.ones((1, n))]
    return ([_t(x.astype(np.float32)) for x in arrays],
            dict(n_tiles=4, tile_w=2, macro=2, macro_tile_w=1))


def _cases():
    cases = {"edge": _edge(), "npd": _not_positive_definite()}
    for seed, (th, tw, macro) in enumerate([(5, 7, 2), (7, 8, 3), (6, 9, 4), (9, 7, 4)]):
        cases[f"random_m{macro}_{th}x{tw}"] = _random(100 + seed, th, tw, macro)
    for kind in SHAPES:
        cases[f"sweep_{kind}"] = _contour_sweep(kind)
    return cases


CASES = _cases()


def _alpha_live(arrays, kw):
    """[T, n, 256]: valid slots of each tile's list with alpha >= 1/255 at
    each pixel, by the plain version's float32 expressions."""
    g, valid = TK._macro_gathered(*arrays, **kw)
    n_tiles = g.shape[0]
    t = torch.arange(n_tiles)
    p = torch.arange(256)
    px = (((t % kw["tile_w"]) * 16)[:, None] + (p % 16)[None, :]).float()[:, None, :]
    py = (((t // kw["tile_w"]) * 16)[:, None] + (p // 16)[None, :]).float()[:, None, :]
    dx = px - g[..., 0:1]
    dy = py - g[..., 1:2]
    power = -0.5 * (g[..., 2:3] * dx * dx + g[..., 4:5] * dy * dy) - g[..., 3:4] * dx * dy
    alpha = torch.clamp(g[..., 8:9] * torch.exp(torch.clamp(power, max=0.0)), max=0.99)
    return (alpha >= ALPHA_MIN) & (valid > 0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_cull_drops_no_live_slot(case):
    arrays, kw = CASES[case]
    keep = TK.from_macro_live(*arrays, **kw)
    live = _alpha_live(arrays, kw).any(-1)
    wrong = live & ~keep
    assert not wrong.any(), f"{int(wrong.sum())} culled (tile, slot) pairs are live"
    if case.startswith("random") or case == "edge":
        _, valid = TK._macro_gathered(*arrays, **kw)
        assert 0 < int(keep.sum()) < int((valid[..., 0] > 0).sum())
    if case == "npd":
        assert keep.all()


@pytest.mark.parametrize("kind", sorted(SHAPES))
def test_cull_straddles_the_contour(kind):
    """At tile (3, 3), whose top-left pixel is the corner, every splat
    1e-6 or more inside the contour is kept (closer in, the float32
    rounding of the mean and conic can move a thin splat's contour past the
    corner: the plain version's alpha then falls below 1/255 there too, and
    test_cull_drops_no_live_slot holds the cull to that); for the
    unrotated conics, whose nearest pixel of that tile is the corner, every
    splat 1e-4 or more outside is culled: the margin costs less."""
    arrays, kw = _contour_sweep(kind)
    keep = TK.from_macro_live(*arrays, **kw)[15].reshape(len(OPS), len(EPS))
    inside = torch.tensor([e <= -1e-6 for e in EPS])
    assert keep[:, inside].all()
    if SHAPES[kind][2] == 0.0:
        far = torch.tensor([e >= 1e-4 for e in EPS])
        assert not keep[:, far].any()


@pytest.mark.parametrize("case", sorted(CASES))
def test_culled_walk_equals_the_full_walk(case):
    arrays, kw = CASES[case]
    bg = torch.tensor([0.2, 0.1, 0.3])
    full = TK.composite_from_macro_reference(*arrays, bg, **kw)
    culled = TK.composite_from_macro_culled_reference(*arrays, bg, **kw)
    assert culled.shape == (kw["n_tiles"], 3, 16, 16)
    assert torch.equal(culled, full)


@pytest.mark.parametrize("case", ["edge", "random_m3_7x8", "random_m4_9x7", "sweep_rotated"])
def test_culled_walk_matches_jax_pallas_kernel(case):
    arrays, kw = CASES[case]
    bg = np.array([0.05, 0.05, 0.1], np.float32)
    ref = np.asarray(JP.composite_from_macro_pallas(
        *(jnp.asarray(a.numpy()) for a in arrays), jnp.asarray(bg), interpret=True, **kw))
    got = TK.composite_from_macro_culled_reference(*arrays, _t(bg), **kw).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


def test_work_counts_the_walked_kept_and_visible_pairs():
    """``from_macro_work`` on an edge-block grid, in (slot, pixel) pairs:
    walked, each tile's list up to its last valid slot at every pixel; kept,
    the cull's slots at every pixel of their tile; visible, those with
    alpha >= 1/255."""
    arrays, kw = CASES["random_m3_7x8"]
    walked, kept, visible = TK.from_macro_work(*arrays, **kw, tiles_per_chunk=5)
    ends = TK.valid_ends(arrays[4]).long()
    rows = TK.macro_of_tile(kw["n_tiles"], kw["tile_w"], kw["macro"], kw["macro_tile_w"])
    assert walked == int(ends[rows].sum()) * 256
    assert kept == int(TK.from_macro_live(*arrays, **kw).sum()) * 256
    assert visible == int(_alpha_live(arrays, kw).sum())
    assert 0 < visible < kept < walked


# The committed model: (size, selection), as tests/test_torch_port_gs_render.py
# takes them, at macro 2, 3 and 4 (at 128^2 and macro 3 the last block
# column and row hold 2 of 3 tiles: 8 is no multiple of 3).
_FRAME_CASES = {
    128: json.loads((BED / "cfg_args.json").read_text())["selection"],
    192: {"macro_capacity": 1024, "dup_span": 2, "giant_capacity": 128,
          "giant_backend": "merge"},
}
MACROS = (2, 3, 4)


@pytest.fixture(scope="module")
def bed_lists():
    """The lists ``rasterize_fused`` hands its compositor: 4096 splats of
    the committed model from one orbit camera, at each size and macro."""
    state, field, _, _ = TCMP.load_npz(BED / "model.npz", device="cpu")
    idx = torch.from_numpy(np.sort(np.random.default_rng(7).choice(state.xyz.shape[0], 4096,
                                                                   replace=False)))
    state = type(state)(*(t[idx] for t in state))
    xyz = state.xyz.double().numpy()
    center = np.median(xyz, axis=0)
    dist = np.percentile(np.linalg.norm(xyz - center, axis=1), 80) / math.tan(0.4)
    style = _t((np.random.default_rng(1).standard_normal((1, 512)) * 0.5).astype(np.float32))
    with torch.no_grad():
        sh = TF.predict_sh(field, state.xyz, style)
        scales, rotations, opacity = TRN._inference_activations(state)
    bg = torch.tensor([0.1, 0.0, 0.2])
    out = {}
    for size, sel in _FRAME_CASES.items():
        cam = _look_at(center, dist, 0.7, 0.45, size, size)
        vm, pm, campos = TRN._camera_tensors(cam, "cpu")
        colors = TRN._sh_colors(sh, state.xyz, campos)
        tan = math.tan(cam.FoVx * 0.5)
        for macro in MACROS:
            settings = TRN.settings_from_selection(sel, size, size, macro=macro)
            calls = []
            orig = TK.composite_from_macro

            def spy(*args, **kw):
                calls.append((args, kw))
                return orig(*args, **kw)

            TK.composite_from_macro = spy
            try:
                TR.rasterize_fused(state.xyz, scales, rotations, opacity, colors, vm, pm, bg,
                                   settings, tanfovx=tan, tanfovy=tan)
            finally:
                TK.composite_from_macro = orig
            (args, kw), = calls
            out[size, macro] = (list(args[:5]), args[5], kw)
    return out


@pytest.mark.parametrize("macro", MACROS)
@pytest.mark.parametrize("size", sorted(_FRAME_CASES))
def test_cull_on_the_committed_model(bed_lists, size, macro):
    """No live (tile, slot) dropped on the frame's own lists, some slots
    dropped, and the culled walk equal to the full walk."""
    arrays, bg, kw = bed_lists[size, macro]
    tiles = size // 16
    assert kw["n_tiles"] == tiles * tiles and kw["macro"] == macro
    assert (tiles % macro != 0) == ((size, macro) == (128, 3))
    keep = TK.from_macro_live(*arrays, **kw)
    live = _alpha_live(arrays, kw).any(-1)
    assert not (live & ~keep).any()
    _, valid = TK._macro_gathered(*arrays, **kw)
    assert 0 < int(keep.sum()) < int((valid[..., 0] > 0).sum())
    full = TK.composite_from_macro_reference(*arrays, bg, **kw)
    assert torch.equal(TK.composite_from_macro_culled_reference(*arrays, bg, **kw), full)
