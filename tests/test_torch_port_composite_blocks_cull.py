"""The coefficient walk's and the per-tile walk's kernels, emulated in plain
torch on the CPU (``kernels/composite.py``: ``blocks_sub_tile_live``,
``composite_macro_blocks_culled_reference``, ``blocks_work``, ``tiles_live``,
``composite_tiles_culled_reference`` and ``tiles_work``).

The CUDA kernels (``macro_blocks_kernel`` and ``walk_tiles_kernel`` of
``csrc/composite_walk.cu``) cannot run here; their emulations show what the
designs rest on:
* the coefficient cull drops no (row, 16 x 16 sub-tile) where a pixel of
  the sub-tile has alpha >= 1/255 by the plain version's float32
  arithmetic (brute force at bs 16, 32 and 64, wide splats and sharp ones
  far from the block's origin, a sweep of splats just inside and just
  outside the 1/255 contour at a sub-tile's corner), keeps every row that
  is not finite or not concave and drops rows of opacity <= 0; and it does
  drop rows well outside the contour, so the margin is not vacuous;
* so each sub-tile's walk over its kept rows equals the plain walk
  (``torch.equal``), group exit included, and the rows walked do not move;
* each tile's walk over the slots kernel A's cull keeps equals the plain
  per-tile walk (``torch.equal``);
* both hold on the committed model's own rows and lists at 128^2;
* the culled coefficient walk agrees with the JAX package's
  ``composite_macro_blocks_pallas`` in interpret mode at the tolerance of
  tests/test_torch_port_gs_walk.py, 1e-5 (wide splats).

Rows are packed by the rasterizer's own ``_macro_coeffs`` from splats drawn
with numpy from a seed, or come from the committed model.
"""

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


def _pack(mean, conic, color, op, idx, mtw, bs):
    """Coefficient rows [M, Kc, 8] and colours [M, Kc, 4] of the splats
    listed by idx [M, Kc] (-1 past each block's count), packed as the
    rasterizer packs them (``_macro_coeffs``), and counts [M]."""
    m = idx.shape[0]
    coeff, gcol, gop, counts = TR._macro_coeffs(
        _t(idx.astype(np.int32)), _t(mean.astype(np.float32)), _t(conic.astype(np.float32)),
        _t(color.astype(np.float32)), _t(op.astype(np.float32)), m, mtw, bs)
    zero = torch.zeros_like(gop[..., None])
    return (torch.cat([coeff, gop[..., None], zero], -1).contiguous(),
            torch.cat([gcol, zero], -1).contiguous(), counts)


def _random(seed, bs, kind, mtw=2, mth=2, kc=96):
    """Splats over an mtw x mth grid of bs px blocks, each block listing kc
    of them in a random order (counts 0, 37 and full where there are 3
    blocks or more, else full): "wide" sigma 3-12
    px up to 40 px around the blocks; "sharp" sigma 0.3-2 px, half on the
    blocks and half up to 150 px past them (where the terms of the
    quadratic cancel)."""
    g = np.random.default_rng(seed)
    n = 400
    spread = np.where(np.arange(n) % 2, 40.0 if kind == "wide" else 150.0, 0.0)
    mean = np.stack([g.uniform(-spread, mtw * bs + spread),
                     g.uniform(-spread, mth * bs + spread)], -1)
    lo, hi = (3.0, 12.0) if kind == "wide" else (0.3, 2.0)
    conic = _conics(g.uniform(lo, hi, n), g.uniform(lo, hi, n), g.uniform(0, math.pi, n))
    op = np.exp(g.uniform(math.log(0.003), 0, n))
    m = mtw * mth
    idx = np.stack([g.permutation(n)[:kc] for _ in range(m)])
    if m > 2:
        idx[0, :] = -1
        idx[1, 37:] = -1
    return _pack(mean, conic, g.random((n, 3)), op, idx, mtw, bs), bs, mtw


CORNER = 32.0   # the top-left pixel of sub-tile (2, 2) of a 64 px block
CORNER_SUB = 10


def _contour_sweep(kind):
    """One 64 px block listing, for each opacity in OPS, one splat per EPS:
    its mean up and left of pixel (32, 32), the top-left pixel of sub-tile
    (2, 2), on the diagonal, where q(corner - mean) = L (1 + eps) and L = 2
    ln(255 op) is the 1/255 contour: just inside for eps < 0, just outside
    for eps > 0."""
    s1, s2, theta = SHAPES[kind]
    a, b, c = _conics(np.float64(s1), np.float64(s2), np.float64(theta))
    u = np.array([-1.0, -1.0]) / math.sqrt(2.0)
    qu = a * u[0] ** 2 + 2 * b * u[0] * u[1] + c * u[1] ** 2
    mean, op = [], []
    for o in OPS:
        level = 2 * math.log(255 * o)
        for e in EPS:
            d = math.sqrt(max(level * (1 + e), 0.0) / qu)
            mean.append([CORNER + d * u[0], CORNER + d * u[1]])
            op.append(o)
    n = len(op)
    conic = np.tile(np.array([a, b, c]), (n, 1))
    color = np.random.default_rng(5).random((n, 3))
    return _pack(np.asarray(mean), conic, color, np.asarray(op), np.arange(n)[None], 1, 64), 64, 1


def _odd_rows():
    """One 32 px block: rows whose quadratic is not concave (cxx >= 0, cyy
    >= 0, or 4 cxx cyy <= cxy^2), rows with a coefficient or opacity NaN or
    infinite, rows of opacity 0 and -0.5, and two ordinary rows, all far
    from the block."""
    n = 12
    coeff = np.zeros((1, n, 8), np.float32)
    coeff[0, :, 0] = -500.0                        # far: the quadratic is very negative
    coeff[0, :, 3:5] = -0.1
    coeff[0, :, 6] = 0.5
    coeff[0, 0, 3] = 0.0                           # cxx = 0
    coeff[0, 1, 4] = 0.2                           # cyy > 0
    coeff[0, 2, 5] = 0.2                           # 4 cxx cyy = 0.04 = cxy^2
    coeff[0, 3, 5] = 0.3                           # indefinite
    coeff[0, 4, 0] = np.nan
    coeff[0, 5, 1] = np.inf
    coeff[0, 6, 6] = np.nan                        # alpha is 0.99 through fminf
    coeff[0, 7, 6] = np.inf
    coeff[0, 8, 6] = 0.0
    coeff[0, 9, 6] = -0.5
    colors = np.ones((1, n, 4), np.float32)
    return (_t(coeff), _t(colors), torch.tensor([n], dtype=torch.int32)), 32, 1


def _cases():
    cases = {"odd": _odd_rows()}
    for i, (bs, kind) in enumerate([(16, "wide"), (32, "wide"), (64, "wide"), (16, "sharp"),
                                    (32, "sharp"), (64, "sharp")]):
        cases[f"{kind}_bs{bs}"] = _random(30 + i, bs, kind)
    for kind in SHAPES:
        cases[f"sweep_{kind}"] = _contour_sweep(kind)
    return cases


CASES = _cases()


def _alpha_live(coeff, counts, bs):
    """[M, Kc, sub-tiles]: rows inside the count with alpha >= 1/255 at a
    pixel of the sub-tile, by the plain version's float32 expressions."""
    flat = torch.arange(bs * bs)
    px, py = (flat % bs).float(), (flat // bs).float()
    c = coeff.float()
    power = (c[..., 0:1] + c[..., 1:2] * px + c[..., 2:3] * py + c[..., 3:4] * (px * px)
             + c[..., 4:5] * (py * py) + c[..., 5:6] * (px * py))
    alpha = torch.clamp(c[..., 6:7] * torch.exp(torch.clamp(power, max=0.0)), max=0.99)
    live = alpha >= ALPHA_MIN                                             # [M, Kc, P]
    cols = bs // 16
    sub_of = (flat // bs // 16) * cols + (flat % bs) // 16
    per_sub = torch.zeros(live.shape[:2] + (cols * cols,), dtype=torch.bool)
    for s in range(cols * cols):
        per_sub[..., s] = live[..., sub_of == s].any(-1)
    in_count = torch.arange(coeff.shape[1])[None, :] < counts.long()[:, None]
    return per_sub & in_count[..., None]


@pytest.mark.parametrize("case", sorted(CASES))
def test_coefficient_cull_drops_no_live_pair(case):
    (coeff, _, counts), bs, _ = CASES[case]
    keep = TK.blocks_sub_tile_live(coeff, counts, bs)
    assert keep.shape == coeff.shape[:2] + ((bs // 16) ** 2,)
    live = _alpha_live(coeff, counts, bs)
    wrong = live & ~keep
    assert not wrong.any(), f"{int(wrong.sum())} culled (row, sub-tile) pairs are live"
    if not case.startswith("odd"):
        in_count = int(counts.long().sum()) * keep.shape[2]
        assert 0 < int(keep.sum()) < in_count


def test_coefficient_cull_keeps_odd_rows():
    """Rows that are not concave or not finite stay on every sub-tile's
    list, though the walk's alpha is below 1/255 for most of them; rows of
    opacity 0 and -0.5 go, and so do the two ordinary rows as far away."""
    (coeff, _, counts), bs, _ = CASES["odd"]
    keep = TK.blocks_sub_tile_live(coeff, counts, bs)[0]
    assert keep[:8].all()
    assert not keep[8:].any()


@pytest.mark.parametrize("kind", sorted(SHAPES))
def test_coefficient_cull_straddles_the_contour(kind):
    """At sub-tile (2, 2), whose top-left pixel is the corner: every splat
    1e-2 or more inside the contour is kept, and, for the unrotated conics
    (whose nearest pixel of the sub-tile is the corner), every splat 1e-1
    or more outside is culled. The margin is wider than kernel A's (1e-4
    outside): it bounds the float32 rounding of a quadratic whose terms
    cancel, which moves the float32 contour itself here (the plain walk's
    alpha at the corner is >= 1/255 for some splats 1e-6 outside and below
    it for some 1e-4 inside); the thin splat's rows are kept up to 1e-2
    outside."""
    (coeff, _, counts), bs, _ = CASES[f"sweep_{kind}"]
    keep = TK.blocks_sub_tile_live(coeff, counts, bs)[0, :, CORNER_SUB].reshape(len(OPS), len(EPS))
    inside = torch.tensor([e <= -1e-2 for e in EPS])
    assert keep[:, inside].all()
    if SHAPES[kind][2] == 0.0:
        far = torch.tensor([e >= 1e-1 for e in EPS])
        assert not keep[:, far].any()


@pytest.mark.parametrize("case", sorted(CASES))
def test_culled_coefficient_walk_equals_the_plain_walk(case):
    (coeff, colors, counts), bs, _ = CASES[case]
    bg = torch.tensor([0.2, 0.1, 0.3])
    full = TK.composite_macro_blocks_reference(coeff, colors, counts, bg, bs)
    culled = TK.composite_macro_blocks_culled_reference(coeff, colors, counts, bg, bs)
    assert culled.shape == (coeff.shape[0], 3, 1, bs * bs)
    assert torch.equal(culled, full)
    work = TK.blocks_work(coeff, colors, counts, bs)
    assert work["walked_rows"] == TK.blocks_walked_rows(coeff, colors, counts, bs)
    assert work["dense_pairs"] == work["walked_rows"] * bs * bs
    assert work["live_pairs"] <= work["kept_pairs"] <= work["dense_pairs"]


def test_coefficient_walk_exits_at_the_same_group():
    """A block opaque within its first group leaves at the second group
    start whether or not its sub-tiles walk culled lists: the rows walked
    (32 of 90) and the kept pairs counted only up to the exit."""
    (coeff, colors, counts), bs, _ = _random(7, 32, "wide", mtw=1, mth=1, kc=90)
    coeff[0, :10, :6] = torch.tensor([-0.1, 0.0, 0.0, -1e-5, -1e-5, 0.0])
    coeff[0, :10, 6] = 0.99
    work = TK.blocks_work(coeff, colors, counts, bs)
    assert work["walked_rows"] == 32
    keep = TK.blocks_sub_tile_live(coeff, counts, bs)
    assert work["kept_pairs"] == int(keep[0, :32].sum()) * 256
    bg = torch.tensor([0.2, 0.1, 0.3])
    assert torch.equal(TK.composite_macro_blocks_culled_reference(coeff, colors, counts, bg, bs),
                       TK.composite_macro_blocks_reference(coeff, colors, counts, bg, bs))


def test_culled_coefficient_walk_matches_jax_pallas_kernel():
    (coeff, colors, counts), bs, _ = CASES["wide_bs32"]
    bg = np.array([0.05, 0.05, 0.1], np.float32)
    ref = np.asarray(JP.composite_macro_blocks_pallas(
        jnp.asarray(coeff.numpy()), jnp.asarray(colors.numpy()), jnp.asarray(counts.numpy()),
        jnp.asarray(bg), bs=bs, interpret=True))
    got = TK.composite_macro_blocks_culled_reference(coeff, colors, counts, _t(bg), bs).numpy()
    np.testing.assert_allclose(got.reshape(ref.shape), ref, rtol=0, atol=TOL)


def _tile_lists(seed, k, n_tiles=12, tile_w=4):
    """Per-tile lists: slots scattered up to 40 px around each tile, sizes
    0.5-12 px, any rotation, opacities 0.002-1, valid a prefix of random
    length; one empty list, one with invalid slots between valid ones, one
    slot at the 0.99 clamp."""
    g = np.random.default_rng(seed)
    t = np.arange(n_tiles)
    cx = ((t % tile_w) * 16 + 8.0)[:, None]
    cy = ((t // tile_w) * 16 + 8.0)[:, None]
    mean = np.stack([cx + (g.random((n_tiles, k)) - 0.5) * 96,
                     cy + (g.random((n_tiles, k)) - 0.5) * 96], -1)
    conic = _conics(g.uniform(0.5, 12, (n_tiles, k)), g.uniform(0.5, 12, (n_tiles, k)),
                    g.uniform(0, math.pi, (n_tiles, k)))
    op = np.exp(g.uniform(math.log(0.002), 0, (n_tiles, k)))
    op[2, 0], mean[2, 0] = 0.999, [cx[2, 0], cy[2, 0]]
    valid = (np.arange(k)[None, :] < g.integers(1, k + 1, (n_tiles, 1))).astype(np.float32)
    valid[0] = 0.0
    valid[-1, ::3] = 0.0
    arrays = [mean, conic, g.random((n_tiles, k, 3)), op, valid]
    return [_t(a.astype(np.float32)) for a in arrays], tile_w


TILE_CASES = {f"k{k}": _tile_lists(40 + k, k) for k in (1, 48, 300)}


@pytest.mark.parametrize("case", sorted(TILE_CASES))
def test_culled_tile_walk_equals_the_plain_walk(case):
    arrays, tile_w = TILE_CASES[case]
    bg = torch.tensor([0.2, 0.1, 0.3])
    full = TK.composite_tiles_reference(*arrays, bg, tile_w)
    culled = TK.composite_tiles_culled_reference(*arrays, bg, tile_w)
    assert torch.equal(culled, full)
    keep = TK.tiles_live(*arrays, tile_w)
    assert not (keep & ~(arrays[4] > 0)).any()
    if case != "k1":
        assert 0 < int(keep.sum()) < int((arrays[4] > 0).sum())


def test_tiles_work_counts_the_walked_kept_and_visible_pairs():
    arrays, tile_w = TILE_CASES["k48"]
    walked, kept, visible = TK.tiles_work(*arrays, tile_w, tiles_per_chunk=5)
    assert walked == int(TK.valid_ends(arrays[4]).long().sum()) * 256
    assert kept == int(TK.tiles_live(*arrays, tile_w).sum()) * 256
    assert 0 < visible < kept < walked


@pytest.fixture(scope="module")
def bed_rows():
    """The coefficient rows ``rasterize_matmul(composite_backend="pallas")``
    and the per-tile lists ``rasterize_fast`` hand their compositors: 4096
    splats of the committed model from one orbit camera at 128^2, macro 2
    and 4."""
    import json

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
    sel = json.loads((BED / "cfg_args.json").read_text())["selection"]
    cam = _look_at(center, dist, 0.7, 0.45, 128, 128)
    vm, pm, campos = TRN._camera_tensors(cam, "cpu")
    colors = TRN._sh_colors(sh, state.xyz, campos)
    tan = math.tan(cam.FoVx * 0.5)
    out = {}
    for name, raster, macro, backend in (("composite_macro_blocks", TR.rasterize_matmul, 2, "pallas"),
                                         ("composite_macro_blocks", TR.rasterize_matmul, 4, "pallas"),
                                         ("composite_tiles", TR.rasterize_fast, 2, "mxu")):
        settings = TRN.settings_from_selection(sel, 128, 128, macro=macro)
        settings = settings._replace(composite_backend=backend)
        calls = []
        orig = getattr(TK, name)

        def spy(*args, _orig=orig, **kw):
            calls.append((args, kw))
            return _orig(*args, **kw)

        setattr(TK, name, spy)
        try:
            raster(state.xyz, scales, rotations, opacity, colors, vm, pm, bg, settings,
                   tanfovx=tan, tanfovy=tan)
        finally:
            setattr(TK, name, orig)
        (args, kw), = calls
        out[name, macro] = (args, kw)
    return out


@pytest.mark.parametrize("macro", [2, 4])
def test_coefficient_cull_on_the_committed_model(bed_rows, macro):
    """No live (row, sub-tile) dropped on the frame's own rows, some rows
    dropped, and the culled walk equal to the plain walk."""
    (coeff, colors, counts, bg), kw = bed_rows["composite_macro_blocks", macro]
    bs = kw["bs"]
    assert bs == 16 * macro
    keep = TK.blocks_sub_tile_live(coeff, counts, bs)
    assert not (_alpha_live(coeff, counts, bs) & ~keep).any()
    assert 0 < int(keep.sum()) < int(counts.long().sum()) * keep.shape[2]
    assert torch.equal(TK.composite_macro_blocks_culled_reference(coeff, colors, counts, bg, bs),
                       TK.composite_macro_blocks_reference(coeff, colors, counts, bg, bs))


def test_tile_cull_on_the_committed_model(bed_rows):
    (*arrays, bg, tile_w), _ = bed_rows["composite_tiles", 2]
    keep = TK.tiles_live(*arrays, tile_w)
    assert 0 < int(keep.sum()) < int((arrays[4] > 0).sum())
    assert torch.equal(TK.composite_tiles_culled_reference(*arrays, bg, tile_w),
                       TK.composite_tiles_reference(*arrays, bg, tile_w))
