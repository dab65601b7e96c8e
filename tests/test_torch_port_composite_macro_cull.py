"""The macro-block kernel's walk over each sub-tile's live rows, emulated in
plain torch on the CPU (``kernels/composite.py``: ``sub_tile_live``,
``composite_macro_walk_reference``, and the indexed entries).

The CUDA kernel cannot run here; its emulation shows what the design rests
on:
* the cull drops no (row, 16 x sh sub-tile) where alpha >= 1/255 at a
  pixel (by the plain version's float32 arithmetic), over edge blocks,
  random blocks, a sweep of splats placed just inside and just outside the
  1/255 contour of a sub-tile's corner (round, thin, large and rotated
  conics), conics that are not positive definite, and the committed
  model's rows at 128^2 and 192^2; and it does drop splats 1e-4 outside
  the contour, so the margin is not vacuous;
* so the walk over the live rows equals the walk over every row
  (``torch.equal``), with the same group-start exit, at every sub-tile
  height the kernel is built for;
* the sequential walk agrees with the plain version (exp(cumsum(log1p))
  transmittance) within the card check's tolerance;
* the culled walk agrees with the JAX package's windowed Pallas kernel
  (interpret mode) at its own tolerance, 2e-4;
* the indexed entries give the planes of gather-then-walk on both paths.

Inputs come from numpy seeds or the committed model.
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aip_tpu.ops.pallas import composite as JC
from aip_tpu_torch.gs import compress as TCMP
from aip_tpu_torch.gs import rasterizer as TR
from aip_tpu_torch.gs import render as TRN
from aip_tpu_torch.gs.cameras import Camera
from aip_tpu_torch.kernels import composite as TK

torch.set_num_threads(2)

BED = Path(__file__).resolve().parent.parent / "docs" / "examples" / "bed_0037_r5"
SUB_HEIGHTS = sorted({sh for sh, _ in TK.LAYOUTS[64]})
ALPHA_MIN = 1.0 / 255.0


def _t(x):
    return torch.from_numpy(np.array(x))


def _rows(g, n, bs, mtw, mth):
    """Packed rows scattered over an mtw x mth grid of bs px blocks, sizes
    1.5-7.5 px, a small shear, opacities 0.05-0.95."""
    rows = np.zeros((n, 16), np.float32)
    rows[:, 0] = g.random(n) * mtw * bs
    rows[:, 1] = g.random(n) * mth * bs
    sig = g.random(n) * 6 + 1.5
    rows[:, 2] = 1.0 / sig ** 2
    rows[:, 3] = (g.random(n) - 0.5) * 0.2 / sig ** 2
    rows[:, 4] = 1.0 / (sig * (g.random(n) + 0.5)) ** 2
    rows[:, 5] = np.log(g.random(n) * 0.9 + 0.05)
    rows[:, 6:9] = g.random((n, 3))
    return rows


def _edge(bs=64, mtw=3, mth=2, kc=200):
    """Segments with counts 0, 37 and 129, segments that start mid-group, a
    count above kc, and a block that is opaque after ten rows (chip_smoke's
    edge case), as the windowed walk sees them: (window, counts, bs, mtw)."""
    g = np.random.default_rng(3)
    rows = _rows(g, 1400, bs, mtw, mth)
    rows[700:710, 0:6] = [(4 % mtw + 0.5) * bs, (4 // mtw + 0.5) * bs, 1e-4, 0.0, 1e-4, 0.0]
    starts = torch.tensor([0, 5, 250, 450, 700, 1000], dtype=torch.int32)
    counts = torch.clamp(torch.tensor([0, 37, 200, 129, 200, 260], dtype=torch.int32), max=kc)
    window = TK._segment_window(_t(rows), starts, counts, kc)
    return window, counts, bs, mtw


def _random(seed, bs=32, mtw=3, mth=2, kc=150):
    """Rows scattered up to 40 px around each block (many far outside its
    sub-tiles' contours), sizes 0.5-12 px, any rotation, opacities
    0.002-1; counts from 0 to kc."""
    g = np.random.default_rng(seed)
    m = mtw * mth
    b = np.arange(m)
    cx = ((b % mtw) * bs + bs / 2)[:, None]
    cy = ((b // mtw) * bs + bs / 2)[:, None]
    window = np.zeros((m, kc, 16), np.float32)
    window[..., 0] = cx + (g.random((m, kc)) - 0.5) * (bs + 80)
    window[..., 1] = cy + (g.random((m, kc)) - 0.5) * (bs + 80)
    window[..., 2:5] = _conics(g.uniform(0.5, 12, (m, kc)), g.uniform(0.5, 12, (m, kc)),
                               g.uniform(0, math.pi, (m, kc)))
    window[..., 5] = g.uniform(math.log(0.002), 0, (m, kc))
    window[..., 6:9] = g.random((m, kc, 3))
    counts = torch.from_numpy(g.integers(0, kc + 1, m).astype(np.int32))
    return _t(window), counts, bs, mtw


def _conics(s1, s2, theta):
    """Conic (a, b, c) of the covariance R diag(s1^2, s2^2) R^T."""
    c, s = np.cos(theta), np.sin(theta)
    i1, i2 = 1 / s1 ** 2, 1 / s2 ** 2
    return np.stack([c * c * i1 + s * s * i2, c * s * (i1 - i2), s * s * i1 + c * c * i2], -1)


EPS = (-1e-2, -1e-4, -1e-6, -1e-7, 0.0, 1e-7, 1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1)
SHAPES = {  # (sigma 1, sigma 2, rotation) of the sweep's splats
    "round": (3.0, 3.0, 0.0),
    "axis": (2.0, 5.0, 0.0),
    "thin": (0.35, 40.0, 0.0),
    "large": (60.0, 45.0, 0.0),
    "rotated": (1.5, 9.0, 0.6),
    "thin_rotated": (0.4, 25.0, 2.3),
}
OPS = (1.0, 0.5, 0.05, 0.0045)
CORNER = 32.0   # the corner pixel of a sub-tile of every sweep layout, 64 px block


def _contour_sweep(kind):
    """One 64 px block (mtw 1) listing, for each opacity in OPS, one splat
    per EPS: its mean beyond pixel (32, 32), the top-left pixel of a
    sub-tile at every sub-tile height, on the diagonal away from it, where
    q(corner - mean) = L (1 + eps) and L = 2 ln(255 op) is the 1/255
    contour. Negative eps is just inside, positive just outside (for an
    unrotated conic the corner is the sub-tile's nearest pixel)."""
    s1, s2, theta = SHAPES[kind]
    a, b, c = _conics(np.float64(s1), np.float64(s2), np.float64(theta))
    u = np.array([-1.0, -1.0]) / math.sqrt(2.0)
    qu = a * u[0] ** 2 + 2 * b * u[0] * u[1] + c * u[1] ** 2
    rows = []
    for op in OPS:
        level = 2 * math.log(255 * op)
        for e in EPS:
            d = math.sqrt(max(level * (1 + e), 0.0) / qu)
            rows.append([CORNER + d * u[0], CORNER + d * u[1], a, b, c, math.log(op),
                         *np.random.default_rng(len(rows)).random(3), *[0.0] * 7])
    window = _t(np.asarray(rows, np.float32))[None]
    return window, torch.tensor([window.shape[1]], dtype=torch.int32), 64, 1


def _not_positive_definite():
    """Conics with b^2 >= a c, a <= 0 or c <= 0 around one 32 px block: the
    kernel must walk every one of them everywhere."""
    g = np.random.default_rng(9)
    n = 24
    window = np.zeros((1, n, 16), np.float32)
    window[0, :, 0:2] = g.random((n, 2)) * 200 - 80
    window[0, :, 2] = g.uniform(-0.2, 0.3, n)
    window[0, :, 4] = g.uniform(-0.2, 0.3, n)
    window[0, :, 3] = np.sqrt(np.abs(window[0, :, 2] * window[0, :, 4])) * g.uniform(1, 2, n)
    window[0, ::3, 3] = 0.0
    window[0, ::3, 2] = -0.01
    window[0, :, 5] = np.log(g.uniform(0.01, 1, n))
    window[0, :, 6:9] = g.random((n, 3))
    return _t(window), torch.tensor([n], dtype=torch.int32), 32, 1


def _cases():
    cases = {"edge": _edge(), "npd": _not_positive_definite()}
    for seed in range(3):
        cases[f"random{seed}"] = _random(100 + seed)
    for kind in SHAPES:
        cases[f"sweep_{kind}"] = _contour_sweep(kind)
    return cases


CASES = _cases()


def _alpha_live(window, bs, mtw):
    """[M, Kc, bs^2]: alpha >= 1/255 at each pixel of the row's block, by
    the plain version's float32 expressions."""
    m = window.shape[0]
    flat = torch.arange(bs * bs)
    bids = torch.arange(m)
    px = ((bids % mtw) * bs)[:, None].float() + (flat % bs).float()[None, :]
    py = ((bids // mtw) * bs)[:, None].float() + (flat // bs).float()[None, :]
    dx = px[:, None, :] - window[..., 0:1]
    dy = py[:, None, :] - window[..., 1:2]
    power = (-0.5 * (window[..., 2:3] * dx * dx + window[..., 4:5] * dy * dy)
             - window[..., 3:4] * dx * dy + window[..., 5:6])
    alpha = torch.clamp(torch.exp(torch.clamp(power, max=0.0)), max=0.99)
    return alpha >= ALPHA_MIN


def _live_anywhere(window, counts, bs, mtw, sh):
    """[M, Kc, S]: rows inside the count with alpha >= 1/255 at some pixel
    of the sub-tile."""
    m, kc, _ = window.shape
    flat = torch.arange(bs * bs)
    live = _alpha_live(window, bs, mtw)
    sub_of = (flat // bs // sh) * (bs // 16) + (flat % bs) // 16
    n_sub = (bs // 16) * (bs // sh)
    out = torch.zeros((m, kc, n_sub), dtype=torch.bool)
    for s in range(n_sub):
        out[..., s] = live[..., sub_of == s].any(-1)
    in_count = torch.arange(kc)[None, :] < counts.long().clamp(max=kc)[:, None]
    return out & in_count[..., None]


@pytest.mark.parametrize("sh", SUB_HEIGHTS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_cull_drops_no_live_row(case, sh):
    window, counts, bs, mtw = CASES[case]
    if sh > bs:
        sh = bs
    keep = TK.sub_tile_live(window, counts, bs, mtw, sh)
    live = _live_anywhere(window, counts, bs, mtw, sh)
    wrong = live & ~keep
    assert not wrong.any(), f"{int(wrong.sum())} culled (row, sub-tile) pairs are live"
    if case.startswith("random") or case == "edge":
        in_count = (torch.arange(window.shape[1])[None, :, None]
                    < counts.long()[:, None, None]).expand_as(live)
        assert 0 < int((in_count & ~keep).sum()) < int(in_count.sum())
    if case == "npd":
        assert keep.all()


@pytest.mark.parametrize("kind", sorted(SHAPES))
def test_cull_straddles_the_contour(kind):
    """At the corner's sub-tile (rows 32-47, columns 32-47 at sh 16) every
    splat just inside the contour is kept; for the unrotated conics, whose
    nearest pixel there is the corner, every splat 1e-4 or more outside is
    culled: the margin costs less."""
    window, counts, bs, mtw = _contour_sweep(kind)
    keep = TK.sub_tile_live(window, counts, bs, mtw, 16)[0, :, 2 * 4 + 2].reshape(len(OPS),
                                                                                   len(EPS))
    inside = torch.tensor([e < 0 for e in EPS])
    assert keep[:, inside].all()
    if SHAPES[kind][2] == 0.0:
        far = torch.tensor([e >= 1e-4 for e in EPS])
        assert not keep[:, far].any()


@pytest.mark.parametrize("sh", SUB_HEIGHTS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_culled_walk_equals_the_full_walk(case, sh):
    window, counts, bs, mtw = CASES[case]
    bg = torch.tensor([0.2, 0.1, 0.3])
    full = TK.composite_macro_walk_reference(window, counts, bg, bs, mtw)
    culled = TK.composite_macro_walk_reference(window, counts, bg, bs, mtw, sh=min(sh, bs))
    assert torch.equal(culled, full)


@pytest.mark.parametrize("case", sorted(CASES))
def test_walk_agrees_with_the_plain_version(case):
    """The sequential product against exp(cumsum(log1p)): the card check's
    tolerance, max abs <= 1e-3 max(1, |ref|) and mean abs <= 1e-5; and the
    early exit walks the rows ``walked_rows`` counts (the background weights
    agree)."""
    window, counts, bs, mtw = CASES[case]
    bg = torch.tensor([0.2, 0.1, 0.3])
    got = TK.composite_macro_walk_reference(window, counts, bg, bs, mtw, sh=16)
    want = TK.composite_macro_mxu_reference(window, counts, bg, bs, mtw)
    err = (got - want).abs()
    assert float(err.max()) <= 1e-3 * max(1.0, float(want.abs().max()))
    assert float(err.mean()) <= 1e-5


@pytest.mark.parametrize("case", ["edge", "random0"])
def test_culled_walk_matches_jax_pallas_kernel(case):
    """The culled walk against ``composite_macro_mxu_pallas`` in interpret
    mode on the same window: 2e-4, the JAX package's tolerance for its
    macro-block composites (its kernel's transmittance is a prefix product
    on the MXU). Not on the contour sweep: the JAX kernel evaluates the
    quadratic in block-local coefficients, whose float32 terms cancel, so
    splats placed on the 1/255 contour flip there."""
    window, counts, bs, mtw = CASES[case]
    bg = np.array([0.2, 0.1, 0.3], np.float32)
    ref = JC.composite_macro_mxu_pallas(jnp.asarray(window.numpy()), jnp.asarray(counts.numpy()),
                                        jnp.asarray(bg), bs=bs, mtw=mtw, interpret=True)
    got = TK.composite_macro_walk_reference(window, counts, _t(bg), bs, mtw, sh=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4)


def test_edge_block_stops_at_its_group_start():
    """Block 4 of the edge case is opaque after ten rows: both walks stop at
    row 64 of its 200, and the live pairs are those of the walked rows."""
    window, counts, bs, mtw = CASES["edge"]
    bg = torch.tensor([0.2, 0.1, 0.3])
    walked = TK.walked_rows(window, counts, bg, bs, mtw)
    assert walked == int(counts.sum()) - 200 + 64
    pairs = TK.live_pairs(window, counts, bg, bs, mtw)
    assert 0 < pairs < walked * bs * bs
    # Block 4 alone (block ids from 0: place it at the grid's origin).
    block4 = window[4:5].clone()
    block4[..., 0] -= (4 % mtw) * bs
    block4[..., 1] -= (4 // mtw) * bs
    assert TK.live_pairs(block4, counts[4:5], bg, bs, mtw) == int(
        _alpha_live(block4[:, :64], bs, mtw).sum())


def test_indexed_entries_equal_gather_then_walk():
    """Both indexed entries on CPU tensors against the JAX-signature
    wrappers on the gathered rows: equal."""
    g = np.random.default_rng(4)
    bs, mtw, mth, kc, n = 32, 3, 2, 120, 500
    table = _t(_rows(g, n, bs, mtw, mth))
    bg = torch.tensor([0.1, 0.4, 0.2])
    gid = torch.from_numpy(g.integers(0, n, 900).astype(np.int32))
    starts = torch.tensor([0, 3, 130, 400, 600, 899], dtype=torch.int32)
    counts = torch.tensor([3, 120, 77, 120, 0, 1], dtype=torch.int32)
    got = TK.composite_macro_mxu_seg_indexed(table, gid, starts, counts, bg, n_blocks=6, kc=kc,
                                             bs=bs, mtw=mtw)
    want = TK.composite_macro_mxu_seg(table[gid.long()], starts, counts, bg, n_blocks=6, kc=kc,
                                      bs=bs, mtw=mtw)
    assert torch.equal(got, want)
    idx = torch.full((6, kc), -1, dtype=torch.int32)
    for b in range(6):
        idx[b, :counts[b]] = gid[starts[b]:starts[b] + counts[b]]
    got = TK.composite_macro_mxu_indexed(table, idx, counts, bg, bs=bs, mtw=mtw)
    window = table[torch.clamp(idx, min=0).long()]
    assert torch.equal(got, TK.composite_macro_mxu(window, counts, bg, bs=bs, mtw=mtw))
    assert torch.equal(got, want)


def test_layouts_the_kernel_takes():
    """Threads a block, blocks a macro block (a cluster of at most 8) and
    warps a sub-tile of every layout built; others raise."""
    assert TK.macro_layout(64, 16, 2) == {"threads": 256, "cluster": 8, "sub_tiles_per_block": 2,
                                          "warps_per_sub_tile": 4}
    assert TK.macro_layout(16, 16, 4)["cluster"] == 1
    for bs, layouts in TK.LAYOUTS.items():
        for sh, p in layouts:
            lay = TK.macro_layout(bs, sh, p)
            assert lay["threads"] % 32 == 0 and lay["cluster"] <= 8
            assert lay["threads"] * p * lay["cluster"] == bs * bs
            assert lay["sub_tiles_per_block"] * lay["warps_per_sub_tile"] * 32 == lay["threads"]
    with pytest.raises(ValueError):
        TK.macro_layout(32, 32, 2)
    with pytest.raises(ValueError):
        TK.macro_layout(64, 16, 1)


# The committed model: (size, selection, segment branch), as the serving
# frame tests of tests/test_torch_port_gs_render.py take them.
_FRAME_CASES = {
    "windowed": (128, json.loads((BED / "cfg_args.json").read_text())["selection"], False),
    "segment": (192, {"macro_capacity": 1024, "dup_span": 2, "giant_capacity": 128,
                      "giant_backend": "merge"}, True),
}


def _look_at(center, dist, azimuth, elev, w, h, fovx=0.8):
    pos = center + dist * np.array([math.cos(azimuth) * math.cos(elev),
                                    math.sin(azimuth) * math.cos(elev), math.sin(elev)])
    fwd = (center - pos) / np.linalg.norm(center - pos)
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, np.cross(right, fwd), -fwd, pos
    c2w[:3, 1:3] *= -1  # OpenGL -> COLMAP axes
    w2c = np.linalg.inv(c2w)
    fovy = 2 * math.atan(math.tan(fovx / 2) * h / w)
    return Camera(colmap_id=0, R=w2c[:3, :3].T, T=w2c[:3, 3], FoVx=fovx, FoVy=fovy,
                  image=np.zeros((h, w, 3), np.float32), image_name="orbit", uid=0)


@pytest.fixture(scope="module")
def bed_windows():
    """The windows the serving frame hands its compositor: 4096 splats of
    the committed model from one orbit camera, each frame case."""
    state, field, _, _ = TCMP.load_npz(BED / "model.npz", device="cpu")
    idx = torch.from_numpy(np.sort(np.random.default_rng(7).choice(state.xyz.shape[0], 4096,
                                                                   replace=False)))
    state = type(state)(*(t[idx] for t in state))
    xyz = state.xyz.double().numpy()
    center = np.median(xyz, axis=0)
    dist = np.percentile(np.linalg.norm(xyz - center, axis=1), 80) / math.tan(0.4)
    style = _t((np.random.default_rng(1).standard_normal((1, 512)) * 0.5).astype(np.float32))
    out = {}
    for case, (size, sel, seg) in _FRAME_CASES.items():
        fn = TRN.make_inference_frame_fn(state, field, TRN.settings_from_selection(sel, size, size),
                                         torch.tensor([0.1, 0.0, 0.2]), style_f=style)
        assert TR.uses_segment_path(4096, fn.settings) == seg
        name = "composite_macro_mxu_seg_indexed" if seg else "composite_macro_mxu_indexed"
        calls = []
        orig = getattr(TK, name)

        def spy(*args, **kw):
            calls.append((args, kw))
            return orig(*args, **kw)

        setattr(TK, name, spy)
        try:
            TRN.render_frame(fn, _look_at(center, dist, 0.7, 0.45, size, size))
        finally:
            setattr(TK, name, orig)
        (args, kw), = calls
        if seg:
            table, gid, starts, counts, _ = args
            window = TK._segment_window(table[gid.long()], starts, counts, kw["kc"])
        else:
            table, macro_idx, counts, _ = args
            window = table[torch.clamp(macro_idx, min=0).long()]
        out[case] = (window, counts, kw["bs"], kw["mtw"])
    return out


@pytest.mark.parametrize("sh", SUB_HEIGHTS)
@pytest.mark.parametrize("case", sorted(_FRAME_CASES))
def test_cull_on_the_committed_model(bed_windows, case, sh):
    """No live (row, sub-tile) dropped on the frame's own rows, some rows
    dropped, and the culled walk equal to the full walk."""
    window, counts, bs, mtw = bed_windows[case]
    keep = TK.sub_tile_live(window, counts, bs, mtw, sh)
    live = _live_anywhere(window, counts, bs, mtw, sh)
    assert not (live & ~keep).any()
    assert int(keep.sum()) < int((counts.long().clamp(max=window.shape[1])).sum()) * keep.shape[2]
    bg = torch.tensor([0.1, 0.0, 0.2])
    full = TK.composite_macro_walk_reference(window, counts, bg, bs, mtw)
    assert torch.equal(TK.composite_macro_walk_reference(window, counts, bg, bs, mtw, sh=sh),
                       full)
