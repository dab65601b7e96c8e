"""The port's differentiable rasterizer pieces vs aip_tpu's, on the CPU:
the per-tile compositor Function (kernels A and B's plain versions), the
hash-table gradient (kernel C's plain version), hierarchical selection and
the differentiable ``rasterize``.

Inputs are drawn with numpy from a seed and handed to both packages. The
JAX side runs its Pallas kernels in interpret mode (``composite_ad``) or
through its XLA branch (``hash_encode_mxu`` on the CPU).

Tolerances, with their reasons:
* compositor forward at 1e-5 absolute and its backward at 1e-4 of the
  largest gradient: the same float32 walk, with sums over the 256 pixels
  taken in another order;
* float64 ``gradcheck`` of the Function at its defaults, on inputs away
  from the 1/255, 0.99 and 1e-4 thresholds (where the function is not
  differentiable);
* hash-table gradient against JAX's float32 scatter autodiff at 1e-6 of
  the largest entry (float32 sums of the same contributions in another
  order), and against ``hash_encode_mxu``'s gradient at 5e-3 (the JAX
  package rounds each contribution to bf16, the port does not);
* selections compared for identity (same ids, same order);
* rasterized images at 1e-5 absolute and gradients at 1e-4 of each
  parameter's largest gradient (the JAX package's own bound between its
  two backends).
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aip_tpu.gs import colorfield as JF
from aip_tpu.gs import rasterizer as JR
from aip_tpu.gs.cameras import Camera
from aip_tpu.ops.pallas import composite_ad as JAD
from aip_tpu_torch.gs import colorfield as TF
from aip_tpu_torch.gs import rasterizer as TR
from aip_tpu_torch.kernels import composite_ad as TAD
from aip_tpu_torch.kernels import hashgrad as TH

torch.set_num_threads(2)


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def _gathered(rng, n_tiles=6, k=24, tile_w=3, edge_cases=True):
    """Gathered per-tile arrays around each tile's pixels. Tile 1 is empty
    (every slot invalid), tile 2 saturates (opaque splats pile up until T
    falls below 1e-4), tile 3 has a splat at the 0.99 clamp and one of
    opacity 0, tile 4 has invalid slots between valid ones."""
    t = np.arange(n_tiles)
    x0 = ((t % tile_w) * 16).astype(np.float32)[:, None]
    y0 = ((t // tile_w) * 16).astype(np.float32)[:, None]
    mean = np.stack([x0 + rng.random((n_tiles, k)) * 20 - 2,
                     y0 + rng.random((n_tiles, k)) * 20 - 2], -1).astype(np.float32)
    sig = rng.random((n_tiles, k)) * 4 + 1.5
    conic = np.stack([1 / sig ** 2, (rng.random((n_tiles, k)) - 0.5) * 0.3 / sig ** 2,
                      1 / (sig * (rng.random((n_tiles, k)) + 0.6)) ** 2], -1).astype(np.float32)
    color = rng.random((n_tiles, k, 3)).astype(np.float32)
    op = (rng.random((n_tiles, k, 1)) * 0.7 + 0.1).astype(np.float32)
    valid = np.ones((n_tiles, k, 1), np.float32)
    if edge_cases:
        valid[1] = 0.0
        conic[2, :, 0] = conic[2, :, 2] = 1e-3
        conic[2, :, 1] = 0.0
        op[2] = 0.98
        mean[3, 0] = [x0[3, 0] + 7.5, y0[3, 0] + 7.5]
        op[3, 0] = 1.0
        op[3, 1] = 0.0
        valid[4, ::3] = 0.0
    return mean, conic, color, op, valid


def _jax_pallas(mean, conic, color, op, valid, bg, tile_w, g_out):
    args = [jnp.asarray(a) for a in (mean, conic, color, op, valid)]
    bgj = jnp.asarray(bg)[None, :]
    out, t_final = JAD._pallas_fwd(*args, bgj, tile_w, True)
    _, vjp = jax.vjp(lambda m, c, col, o: JAD.composite_tiles_ad(m, c, col, o, args[4], tile_w,
                                                                  True, bgj), *args[:4])
    return np.asarray(out), np.asarray(t_final), [np.asarray(g) for g in vjp(jnp.asarray(g_out))]


@pytest.mark.parametrize("bg", [(0.0, 0.0, 0.0), (0.2, 0.5, 0.1)])
def test_composite_ad_matches_jax_pallas_kernels(rng, bg):
    """Forward, t_final and all four gradients against the two Pallas
    kernels (interpret), with the edge-case tiles."""
    arrays = _gathered(rng)
    g_out = rng.standard_normal((6, 3, 16, 16)).astype(np.float32)
    bg = np.asarray(bg, np.float32)
    ref_out, ref_tf, ref_grads = _jax_pallas(*arrays, bg, 3, g_out)
    targs = [_t(a) for a in arrays]
    out, tf = TAD.composite_ad_fwd(*targs, _t(bg), 3)
    np.testing.assert_allclose(out.numpy(), ref_out, atol=1e-5)
    np.testing.assert_allclose(tf.numpy(), ref_tf, atol=1e-5)
    assert float(tf[2].max()) < 1e-4            # the saturated tile
    np.testing.assert_allclose(out[1].numpy(), np.broadcast_to(bg[:, None, None], (3, 16, 16)))
    grads = TAD.composite_ad_bwd(*targs, _t(bg), tf, _t(g_out), 3)
    for name, a, b in zip(("mean", "conic", "color", "opacity"), grads, ref_grads):
        scale = max(np.abs(b).max(), 1e-8)
        assert np.abs(a.numpy() - b).max() / scale < 1e-4, name
        assert np.abs(a[1].numpy()).max() == 0.0   # the empty tile
    assert grads[3][3, 1, 0] != 0.0 or np.abs(ref_grads[3][3, 1, 0]) == 0.0
    # The splat at the 0.99 clamp gets no opacity gradient where it clamps.
    np.testing.assert_allclose(grads[3][3, 0, 0].item(), ref_grads[3][3, 0, 0], atol=1e-5)


def test_composite_ad_function_matches_jax_autodiff_of_composite_tiles(rng):
    """The Function with the per-Gaussian gather (whose backward is the
    scatter-add) against jax.grad of the dense ``composite_tiles``."""
    n, k, tile_w = 40, 16, 2
    settings_j = JR.RasterSettings(32, 32, max_per_tile=k)
    mean2d = (rng.random((n, 2)) * 36 - 2).astype(np.float32)
    sig = rng.random(n) * 4 + 2
    conics = np.stack([1 / sig ** 2, np.zeros(n), 1 / sig ** 2], 1).astype(np.float32)
    colors = rng.random((n, 3)).astype(np.float32)
    opac = (rng.random(n) * 0.6 + 0.2).astype(np.float32)
    sel = np.full((4, k), -1, np.int32)
    for t in range(4):
        ids = rng.permutation(n)[:rng.integers(6, k)]
        sel[t, :len(ids)] = ids
    bg = np.asarray([0.1, 0.2, 0.3], np.float32)
    gt = rng.random((32, 32, 3)).astype(np.float32)

    def jloss(m, c, col, o):
        img = JR.composite_tiles(jnp.asarray(sel), None, m, c, col, o, jnp.asarray(bg),
                                 settings_j)
        return jnp.sum((img - gt) ** 2)

    jargs = [jnp.asarray(a) for a in (mean2d, conics, colors, opac)]
    ref = jax.grad(jloss, argnums=(0, 1, 2, 3))(*jargs)
    targs = [_t(a).requires_grad_() for a in (mean2d, conics, colors, opac)]
    safe = _t(np.maximum(sel, 0)).long()
    valid = _t(sel >= 0).float()[:, :, None]
    tiles = TAD.composite_tiles_ad(targs[0][safe], targs[1][safe], targs[2][safe],
                                   targs[3][safe][:, :, None], valid, tile_w, _t(bg))
    img = TR._tiles_to_image(tiles, TR.RasterSettings(32, 32, max_per_tile=k))
    torch.sum((img - _t(gt)) ** 2).backward()
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(JR.composite_tiles(
        jnp.asarray(sel), None, *jargs, jnp.asarray(bg), settings_j)), atol=1e-5)
    for a, b in zip(targs, ref):
        b = np.asarray(b)
        assert np.abs(a.grad.numpy() - b).max() / max(np.abs(b).max(), 1e-8) < 1e-4


def test_composite_ad_gradcheck_float64(rng):
    mean, conic, color, op, valid = _gathered(rng, n_tiles=2, k=5, tile_w=2, edge_cases=False)
    # Keep every alpha away from the 1/255 and 0.99 thresholds at every
    # pixel: wide splats of moderate opacity, centred in the tiles.
    mean[..., 0] = np.arange(2)[:, None] * 16 + 6 + rng.random((2, 5)) * 4
    mean[..., 1] = 6 + rng.random((2, 5)) * 4
    conic[..., 0] = conic[..., 2] = 1 / 30.0
    conic[..., 1] = 1 / 300.0
    op[:] = (rng.random((2, 5, 1)) * 0.3 + 0.3)
    args = [_t(a, torch.float64).requires_grad_(i < 4)
            for i, a in enumerate((mean, conic, color, op, valid))]
    bg = torch.tensor([0.3, 0.1, 0.2], dtype=torch.float64)
    assert torch.autograd.gradcheck(
        lambda m, c, col, o: TAD.composite_tiles_ad(m, c, col, o, args[4], 2, bg),
        tuple(args[:4]))


def _mixed_field(log2, seed=0):
    jf = JF.init_colorfield(jax.random.PRNGKey(seed), style_dim=None, log2_hashmap=log2)
    return jf, _t(np.asarray(jf.hash_tables))


def test_hash_grad_plain_matches_jax_scatter_autodiff(rng):
    """Dense and hashed levels (2^13: level 0 dense, the rest hashed)."""
    sizes = JF.level_table_sizes_for_cap(1 << 13)
    assert sizes[0] < (1 << 13) and sizes[1] == (1 << 13)
    jf, tables = _mixed_field(13)
    x = rng.random((257, 3)).astype(np.float32)
    g = rng.standard_normal((257, 32)).astype(np.float32)
    ref = np.asarray(jax.grad(lambda tb: jnp.sum(JF.hash_encode(tb, jnp.asarray(x)) * g))(
        jf.hash_tables))
    out = TH.hash_grad(_t(x), _t(g), tuple(tables.shape)).numpy()
    assert np.abs(out - ref).max() <= 1e-6 * np.abs(ref).max()
    # The autograd Function (kernel C's route) and plain autograd agree.
    t1 = tables.clone().requires_grad_()
    (TF.hash_encode_mxu(t1, _t(x)) * _t(g)).sum().backward()
    t2 = tables.clone().requires_grad_()
    (TF.hash_encode(t2, _t(x)) * _t(g)).sum().backward()
    np.testing.assert_allclose(t1.grad.numpy(), t2.grad.numpy(), atol=1e-6 * np.abs(ref).max())


def test_hash_grad_plain_matches_jax_mxu_at_bf16(rng):
    jf, tables = _mixed_field(13, seed=1)
    x = rng.random((200, 3)).astype(np.float32)
    g = rng.standard_normal((200, 32)).astype(np.float32)
    ref = np.asarray(jax.grad(lambda tb: jnp.sum(JF.hash_encode_mxu(tb, jnp.asarray(x)) * g))(
        jf.hash_tables))
    out = TH.hash_grad(_t(x), _t(g), tuple(tables.shape)).numpy()
    assert np.abs(out - ref).max() / np.abs(ref).max() < 5e-3
    for lvl, s in enumerate(JF.level_table_sizes_for_cap(1 << 13)):
        assert np.abs(out[lvl, s:]).max(initial=0.0) == 0.0


def test_predict_sh_takes_kernel_route_for_large_tables(rng, monkeypatch):
    """Tables of 2^16 rows and more route the table gradient through
    ``hash_grad`` (kernel C on a card); smaller ones through autograd."""
    calls = []
    orig = TH.hash_grad
    monkeypatch.setattr(TH, "hash_grad", lambda *a: calls.append(1) or orig(*a))
    xyz = _t(rng.standard_normal((50, 3)).astype(np.float32))
    for log2, routed in ((16, 1), (12, 0)):
        field = TF.init_colorfield(seed=0, style_dim=None, log2_hashmap=log2)
        tables = field.hash_tables.requires_grad_()
        TF.predict_sh(field._replace(hash_tables=tables), xyz).sum().backward()
        assert len(calls) == routed and tables.grad.abs().max() > 0
        calls.clear()


def _camera(w=64, h=64, dist=4.0):
    return Camera(colmap_id=0, R=np.eye(3), T=np.array([0.0, 0.0, dist]), FoVx=np.pi / 3,
                  FoVy=np.pi / 3, image=np.zeros((h, w, 3), np.float32), image_name="t", uid=0)


def _scene(rng, n, scale_lo=0.05, scale_hi=0.2):
    means = (rng.random((n, 3)) * 2 - 1).astype(np.float32)
    scales = (rng.random((n, 3)) * (scale_hi - scale_lo) + scale_lo).astype(np.float32)
    quats = rng.standard_normal((n, 4)).astype(np.float32)
    opac = (rng.random(n) * 0.8 + 0.1).astype(np.float32)
    colors = rng.random((n, 3)).astype(np.float32)
    return means, scales, quats, opac, colors


@pytest.mark.parametrize("backend", ["pairsort", "merge"])
def test_hierarchical_selection_identical_to_jax(rng, backend):
    cam = _camera(w=144, h=112)
    means, scales, quats, opac, _ = _scene(rng, 400, 0.02, 0.12)
    kw = dict(image_height=112, image_width=144, max_per_tile=24, chunk=128, macro=4,
              macro_capacity=96, select_backend=backend, dup_span=2, giant_capacity=32)
    js, ts = JR.RasterSettings(**kw), TR.RasterSettings(**kw)
    tx = ty = math.tan(cam.FoVx * 0.5)
    m2, d, _c, r, v = (np.asarray(a) for a in JR.project_gaussians(
        jnp.asarray(means), jnp.asarray(scales), jnp.asarray(quats),
        jnp.asarray(cam.world_view_transform), jnp.asarray(cam.full_proj_transform), tx, ty, js))
    r = np.asarray(JR.selection_radii(jnp.asarray(r), jnp.asarray(opac)))
    ji, jd = JR.select_per_tile_hierarchical(jnp.asarray(m2), jnp.asarray(d), jnp.asarray(r),
                                             jnp.asarray(v), js)
    ti, td = TR.select_per_tile_hierarchical(_t(m2), _t(d), _t(r), _t(v), ts)
    assert (np.asarray(ji) >= 0).sum() > 200
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("jax_backend", ["xla", "pallas"])
@pytest.mark.parametrize("macro", [1, 2])
def test_rasterize_image_and_gradients_match_jax(rng, jax_backend, macro):
    """Image and gradients for means3d, scales, rotations, opacities,
    colours and the screen-space offset; the port on the CPU with both of
    its composite routes, against the JAX package with ``ad_backend`` set
    as parametrised."""
    cam = _camera(w=48, h=32)
    means, scales, quats, opac, colors = _scene(rng, 24)
    bg = np.asarray([0.05, 0.1, 0.05], np.float32)
    gt = rng.random((32, 48, 3)).astype(np.float32)
    offs = np.zeros((24, 2), np.float32)
    kw = dict(image_height=32, image_width=48, max_per_tile=16, chunk=16, macro=macro,
              macro_capacity=32)
    tx = ty = math.tan(cam.FoVx * 0.5)
    vm, pm = cam.world_view_transform, cam.full_proj_transform
    js = JR.RasterSettings(**kw, ad_backend=jax_backend)

    def jloss(m, s, q, o, c, off):
        img, _ = JR.rasterize(m, s, q, o, c, jnp.asarray(vm), jnp.asarray(pm), jnp.asarray(bg),
                              js, tanfovx=tx, tanfovy=ty, screenspace_offset=off)
        return jnp.mean(jnp.abs(img - gt)), img

    jargs = [jnp.asarray(a) for a in (means, scales, quats, opac, colors, offs)]
    (_, jimg), jgrads = jax.value_and_grad(jloss, argnums=tuple(range(6)), has_aux=True)(*jargs)
    for port_backend in ("xla", "pallas"):
        targs = [_t(a).requires_grad_() for a in (means, scales, quats, opac, colors, offs)]
        img, radii = TR.rasterize(*targs[:5], _t(vm).float(), _t(pm).float(), _t(bg),
                                  TR.RasterSettings(**kw, ad_backend=port_backend),
                                  tanfovx=tx, tanfovy=ty, screenspace_offset=targs[5])
        np.testing.assert_allclose(img.detach().numpy(), np.asarray(jimg), atol=1e-5)
        torch.mean(torch.abs(img - _t(gt))).backward()
        for name, a, b in zip(("means", "scales", "rotations", "opacities", "colors", "offset"),
                              targs, jgrads):
            b = np.asarray(b)
            assert np.abs(b).max() > 0, name
            err = np.abs(a.grad.numpy() - b).max() / np.abs(b).max()
            assert err < 1e-4, (port_backend, name, err)
