"""Kernels A and B's walks over each tile's live list, emulated in plain
torch on the CPU (``kernels/composite_ad.py``: ``live_slots``,
``composite_ad_fwd_culled_reference``, ``composite_ad_bwd_culled_reference``).

The CUDA kernels cannot run here; their emulation shows what the design
rests on:
* the cull drops no slot that is live at any pixel of its tile (alpha >=
  1/255 by the plain version's float32 arithmetic), over a sweep of splats
  placed just inside and just outside the 1/255 contour of a tile's corner
  and over thin, large and rotated conics; and it does drop splats 1e-4
  outside the contour, so the margin is not vacuous;
* so the culled forward walk is equal (``torch.equal``) to the plain walk
  over every slot, on the edge tiles, on random tiles and on the sweep;
* the culled backward, with its sums per thread of P pixels, per warp and
  across warps and its one suffix division, is within 1e-4 of each
  gradient's largest entry of the JAX Pallas kernels (interpret mode) and
  of the plain version, and exactly 0 for every slot it does not walk.

Inputs come from numpy seeds.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aip_tpu.ops.pallas import composite_ad as JAD
from aip_tpu_torch.kernels import composite_ad as AD

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _edge_tiles(rng, n_tiles=6, k=24, tile_w=3):
    """Splats around each tile: tile 1 empty (every slot invalid), tile 2
    saturating below T = 1e-4, tile 3 a splat at the 0.99 clamp and one of
    opacity 0, tile 4 invalid slots between valid ones, tile 5 only its
    first slot valid."""
    t = np.arange(n_tiles)
    x0 = ((t % tile_w) * 16).astype(np.float32)[:, None]
    y0 = ((t // tile_w) * 16).astype(np.float32)[:, None]
    mean = np.stack([x0 + rng.random((n_tiles, k)) * 20 - 2,
                     y0 + rng.random((n_tiles, k)) * 20 - 2], -1)
    sig = rng.random((n_tiles, k)) * 4 + 1.5
    conic = np.stack([1 / sig ** 2, (rng.random((n_tiles, k)) - 0.5) * 0.3 / sig ** 2,
                      1 / (sig * (rng.random((n_tiles, k)) + 0.6)) ** 2], -1)
    color = rng.random((n_tiles, k, 3))
    op = rng.random((n_tiles, k, 1)) * 0.7 + 0.1
    valid = np.ones((n_tiles, k, 1))
    valid[1] = 0.0
    conic[2, :, 0] = conic[2, :, 2] = 1e-3
    conic[2, :, 1] = 0.0
    op[2] = 0.98
    mean[3, 0] = [x0[3, 0] + 7.5, y0[3, 0] + 7.5]
    op[3, 0] = 1.0
    op[3, 1] = 0.0
    valid[4, ::3] = 0.0
    valid[5, 1:] = 0.0
    return [_t(a) for a in (mean, conic, color, op, valid)], tile_w


def _random_tiles(rng, n_tiles=8, k=40, tile_w=4):
    """Splats scattered up to 40 px around each tile (many far outside its
    1/255 contour), sizes from 0.5 to 12 px, any rotation, opacities from
    0.002 to 1, a fifth of the slots invalid at random."""
    t = np.arange(n_tiles)
    x0 = ((t % tile_w) * 16).astype(np.float32)[:, None]
    y0 = ((t // tile_w) * 16).astype(np.float32)[:, None]
    mean = np.stack([x0 + 8 + (rng.random((n_tiles, k)) - 0.5) * 80,
                     y0 + 8 + (rng.random((n_tiles, k)) - 0.5) * 80], -1)
    conic = _conics(rng.uniform(0.5, 12, (n_tiles, k)), rng.uniform(0.5, 12, (n_tiles, k)),
                    rng.uniform(0, math.pi, (n_tiles, k)))
    color = rng.random((n_tiles, k, 3))
    op = np.exp(rng.uniform(math.log(0.002), 0, (n_tiles, k, 1)))
    valid = (rng.random((n_tiles, k, 1)) > 0.2).astype(np.float64)
    return [_t(a) for a in (mean, conic, color, op, valid)], tile_w


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


def _contour_sweep(kind, ops=(1.0, 0.5, 0.05, 0.0045)):
    """One tile per opacity (tile_w = 4), each holding one splat per
    EPS: the splat's mean sits beyond the tile's top-left pixel, on the
    diagonal away from the tile, where q(corner - mean) = L (1 + eps) and
    L = 2 ln(255 op) is the 1/255 contour. Negative eps is just inside,
    positive just outside (for an unrotated conic the corner is the
    tile's nearest pixel; for a rotated one another pixel may be nearer)."""
    s1, s2, theta = SHAPES[kind]
    n_tiles, k = len(ops), len(EPS)
    conic1 = _conics(np.float64(s1), np.float64(s2), np.float64(theta))
    a, b, c = conic1
    u = np.array([-1.0, -1.0]) / math.sqrt(2.0)
    qu = a * u[0] ** 2 + 2 * b * u[0] * u[1] + c * u[1] ** 2
    mean = np.zeros((n_tiles, k, 2))
    op = np.zeros((n_tiles, k, 1))
    for t, o in enumerate(ops):
        level = 2 * math.log(255 * o)
        for i, e in enumerate(EPS):
            d = math.sqrt(max(level * (1 + e), 0.0) / qu)
            mean[t, i] = [(t % 4) * 16 + d * u[0], (t // 4) * 16 + d * u[1]]
            op[t, i] = o
    conic = np.tile(conic1, (n_tiles, k, 1))
    color = np.random.default_rng(11).random((n_tiles, k, 3))
    valid = np.ones((n_tiles, k, 1))
    return [_t(x) for x in (mean, conic, color, op, valid)], 4


def _cases():
    rng = np.random.default_rng(21)
    cases = {"edge": _edge_tiles(rng)}
    for seed in range(3):
        cases[f"random{seed}"] = _random_tiles(np.random.default_rng(100 + seed))
    for kind in SHAPES:
        cases[f"sweep_{kind}"] = _contour_sweep(kind)
    return cases


CASES = _cases()


def _culled_but_live(arrays, tile_w):
    """(culled valid slots, of them those with alpha >= 1/255 at a pixel)."""
    mean, conic, color, op, valid = arrays
    keep = AD.live_slots(AD.pack(mean, conic, color, op), valid, tile_w)
    px, py = AD._pixels(mean.shape[0], tile_w, "cpu")
    culled = (valid[..., 0] > 0) & ~keep
    live_anywhere = torch.stack([AD._alpha_terms(mean, conic, op, valid, i, px, py)[2].any(1)
                                 for i in range(mean.shape[1])], 1)
    return culled, culled & live_anywhere


@pytest.mark.parametrize("case", sorted(CASES))
def test_cull_drops_no_live_slot(case):
    arrays, tile_w = CASES[case]
    culled, wrong = _culled_but_live(arrays, tile_w)
    assert not wrong.any(), f"{int(wrong.sum())} culled slots are live"
    if case.startswith("random"):
        assert 0 < int(culled.sum()) < int((arrays[4] > 0).sum())


@pytest.mark.parametrize("kind", sorted(SHAPES))
def test_cull_straddles_the_contour(kind):
    """In each sweep some splat just inside the contour is live and
    kept; for the unrotated conics, whose nearest pixel is the corner,
    every splat 1e-4 or more outside is culled: the margin costs less."""
    arrays, tile_w = _contour_sweep(kind)
    mean, conic, color, op, valid = arrays
    keep = AD.live_slots(AD.pack(mean, conic, color, op), valid, tile_w)
    culled, wrong = _culled_but_live(arrays, tile_w)
    assert not wrong.any()
    inside = torch.tensor([e < 0 for e in EPS])
    assert keep[:, inside].all()
    if SHAPES[kind][2] == 0.0:
        far = torch.tensor([e >= 1e-4 for e in EPS])
        assert culled[:, far].all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_culled_forward_equals_the_plain_walk(case):
    arrays, tile_w = CASES[case]
    mean, conic, color, op, valid = arrays
    bg = torch.tensor([0.2, 0.5, 0.1])
    want = AD.composite_ad_fwd_reference(*arrays, bg, tile_w)
    got = AD.composite_ad_fwd_culled_reference(AD.pack(mean, conic, color, op), valid, bg,
                                               tile_w)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _rel_errs(got, want):
    return [float((got[..., a:b] - want[..., a:b]).abs().max())
            / max(float(want[..., a:b].abs().max()), 1e-8)
            for a, b in ((0, 2), (2, 5), (5, 8), (8, 9))]


@pytest.mark.parametrize("p", AD.PIXELS_PER_THREAD)
@pytest.mark.parametrize("case", ["edge", "random0", "sweep_rotated", "sweep_thin"])
def test_culled_backward_matches_the_plain_walk(case, p):
    """1e-4 of each gradient's largest entry; 0 for every slot off the
    list (the empty tile, invalid and culled slots)."""
    arrays, tile_w = CASES[case]
    mean, conic, color, op, valid = arrays
    g = np.random.default_rng(5)
    bg = torch.tensor([0.2, 0.5, 0.1])
    g_out = _t(g.standard_normal((mean.shape[0], 3, 16, 16)))
    _, t_final = AD.composite_ad_fwd_reference(*arrays, bg, tile_w)
    want = torch.cat(AD.composite_ad_bwd_reference(*arrays, bg, t_final, g_out, tile_w), -1)
    packed = AD.pack(mean, conic, color, op)
    got = AD.composite_ad_bwd_culled_reference(packed, valid, bg, t_final, g_out, tile_w, p)
    assert max(_rel_errs(got, want)) < 1e-4
    off = ~AD.live_slots(packed, valid, tile_w)
    assert float(got[off].abs().sum()) == 0.0


@pytest.fixture(scope="module")
def jax_edge():
    """The JAX Pallas kernels (interpret mode) on the edge tiles: image,
    T_final and the four gradients."""
    (mean, conic, color, op, valid), tile_w = CASES["edge"]
    g_out = np.random.default_rng(6).standard_normal((mean.shape[0], 3, 16, 16)).astype(
        np.float32)
    bg = np.asarray([0.2, 0.5, 0.1], np.float32)
    args = [jnp.asarray(a.numpy()) for a in (mean, conic, color, op, valid)]
    bgj = jnp.asarray(bg)[None, :]
    out, t_final = JAD._pallas_fwd(*args, bgj, tile_w, True)
    grads = JAD._pallas_bwd(*args, bgj, t_final, jnp.asarray(g_out), tile_w, True)
    return (np.asarray(out), np.asarray(t_final), np.concatenate([np.asarray(x) for x in grads], -1),
            g_out, bg)


def test_culled_forward_matches_jax_pallas_kernel(jax_edge):
    (mean, conic, color, op, valid), tile_w = CASES["edge"]
    ref_out, ref_tf, _, _, bg = jax_edge
    out, tf = AD.composite_ad_fwd_culled_reference(AD.pack(mean, conic, color, op), valid,
                                                   _t(bg), tile_w)
    np.testing.assert_allclose(out.numpy(), ref_out, atol=1e-5)
    np.testing.assert_allclose(tf.numpy(), ref_tf, atol=1e-5)


@pytest.mark.parametrize("p", AD.PIXELS_PER_THREAD)
def test_culled_backward_matches_jax_pallas_kernel(jax_edge, p):
    (mean, conic, color, op, valid), tile_w = CASES["edge"]
    _, ref_tf, ref_grads, g_out, bg = jax_edge
    got = AD.composite_ad_bwd_culled_reference(AD.pack(mean, conic, color, op), valid, _t(bg),
                                               _t(ref_tf), _t(g_out), tile_w, p)
    assert max(_rel_errs(got, torch.from_numpy(ref_grads))) < 1e-4
    assert float(got[1].abs().max()) == 0.0       # the empty tile


@pytest.mark.parametrize("p", AD.PIXELS_PER_THREAD)
def test_thread_sums_follow_the_kernels_order(p):
    """``_thread_sums`` against the kernel's order written out thread by
    thread: thread j holds column j % 16 and rows (j // 16) P + i, adds its
    P values in row order, each warp's butterfly adds lane ^ 16, ^ 8, ...,
    then the warps add in order. Equal to the bit."""
    v = _t(np.random.default_rng(p).standard_normal((2, 3, 256)))
    got = AD._thread_sums(v, p)
    n_threads = 256 // p
    per_thread = []
    for j in range(n_threads):
        col, row0 = j % 16, (j // 16) * p
        acc = v[:, :, row0 * 16 + col]
        for i in range(1, p):
            acc = acc + v[:, :, (row0 + i) * 16 + col]
        per_thread.append(acc)
    warps = []
    for w in range(n_threads // 32):
        lanes = per_thread[32 * w:32 * w + 32]
        for off in (16, 8, 4, 2, 1):
            lanes = [lanes[i] + lanes[i ^ off] for i in range(32)]
        warps.append(lanes[0])
    want = warps[0]
    for w in warps[1:]:
        want = want + w
    assert torch.equal(got, want)
