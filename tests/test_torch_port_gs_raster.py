"""aip_tpu_torch.gs.rasterizer and kernels.composite vs aip_tpu's, on the CPU.

Scenes are drawn with numpy from a seed (the scenes of
tests/test_gs_rasterizer.py) and handed to both packages. The JAX side runs
its Pallas compositors in interpret mode; the port's wrappers take their
plain versions on CPU tensors.

Tolerances: selections are compared for identity (same ids, same order,
same ranges), given the same projected inputs; projections at 1e-5
relative (float32 elementwise, XLA may fuse differently); images at
2e-4 absolute (the JAX package's own tolerance for the macro-block
composites, whose transmittance products round differently), 1e-5 where
both sides run the same dense per-tile formula, and 2e-3 against the
brute-force per-pixel oracle (as the JAX test holds it).
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aip_tpu.gs import rasterizer as JR
from aip_tpu.gs.cameras import Camera
from aip_tpu.ops.pallas import composite as JC
from aip_tpu_torch.gs import rasterizer as TR
from aip_tpu_torch.kernels import composite as TK

torch.set_num_threads(2)


def _camera(w=64, h=64, dist=4.0):
    return Camera(colmap_id=0, R=np.eye(3), T=np.array([0.0, 0.0, dist]),
                  FoVx=np.pi / 3, FoVy=np.pi / 3, image=np.zeros((h, w, 3), np.float32),
                  image_name="t", uid=0)


def _tanfov(cam):
    return math.tan(cam.FoVx * 0.5), math.tan(cam.FoVy * 0.5)


def _t(x):
    return torch.from_numpy(np.array(x))


def _scene(rng, n, scale_lo=0.05, scale_hi=0.2):
    means = (rng.random((n, 3)) * 2 - 1).astype(np.float32)
    scales = (rng.random((n, 3)) * (scale_hi - scale_lo) + scale_lo).astype(np.float32)
    quats = rng.standard_normal((n, 4)).astype(np.float32)
    opac = (rng.random(n) * 0.8 + 0.1).astype(np.float32)
    colors = rng.random((n, 3)).astype(np.float32)
    return means, scales, quats, opac, colors


def _settings_pair(**kw):
    return JR.RasterSettings(**kw), TR.RasterSettings(**kw)


def _project_both(cam, means, scales, quats, js, ts):
    tx, ty = _tanfov(cam)
    jout = JR.project_gaussians(jnp.asarray(means), jnp.asarray(scales), jnp.asarray(quats),
                                jnp.asarray(cam.world_view_transform),
                                jnp.asarray(cam.full_proj_transform), tx, ty, js)
    tout = TR.project_gaussians(_t(means), _t(scales), _t(quats),
                                _t(cam.world_view_transform).float(),
                                _t(cam.full_proj_transform).float(), tx, ty, ts)
    return [np.asarray(a) for a in jout], tout


def test_project_gaussians_matches_jax(rng):
    cam = _camera(w=96, h=64)
    means, scales, quats, _, _ = _scene(rng, 200)
    means[:5, 2] = -6.0  # behind the camera
    js, ts = _settings_pair(image_height=64, image_width=96)
    jout, tout = _project_both(cam, means, scales, quats, js, ts)
    for a, b, name in zip(jout, tout, ("mean2d", "depth", "conic", "radius", "valid")):
        if name == "valid":
            np.testing.assert_array_equal(b.numpy(), a)
        else:
            np.testing.assert_allclose(b.numpy(), a, rtol=1e-5, atol=1e-5, err_msg=name)
    assert not tout[4][:5].any()


# Scenes of tests/test_gs_rasterizer.py's pair-sort tests: (n, giant scales,
# settings). "unpacked" has more than 2^15 blocks, so (block, depth) no
# longer packs into one int32 key and the sort is lexicographic.
_GIANT_CASES = {
    "merge": (60, [(slice(0, 6), 0.5, 2.0)],
              dict(image_height=96, image_width=128, max_per_tile=32, chunk=32, macro=2,
                   macro_capacity=80, dup_span=2, giant_capacity=32)),
    "merge_pooled": (160, [(slice(0, 6), 0.5, 2.0)],
                     dict(image_height=96, image_width=128, max_per_tile=32, chunk=32, macro=2,
                          macro_capacity=160, dup_span=2, giant_capacity=32, giant_pool=10)),
    "direct": (160, [(slice(0, 8), 0.3, 1.1), (slice(8, 10), 6.0, 6.0)],
               dict(image_height=96, image_width=128, max_per_tile=32, chunk=32, macro=2,
                    macro_capacity=192, dup_span=2, giant_backend="direct", giant_span=2,
                    giant_pool=64, giant_pool_full=16, giant_capacity=64)),
    "tiers": (160, [(slice(0, 6), 0.15, 0.55), (slice(6, 10), 0.5, 1.4), (slice(10, 12), 6.0, 6.0)],
              dict(image_height=96, image_width=128, max_per_tile=32, chunk=32, macro=2,
                   macro_capacity=192, dup_span=2, giant_backend="direct",
                   giant_tiers=((2, 32), (3, 32)), giant_pool_full=16, giant_capacity=64)),
    "unpacked": (60, [(slice(0, 4), 0.5, 2.0)],
                 dict(image_height=6016, image_width=6016, max_per_tile=32, chunk=32, macro=2,
                      macro_capacity=64, dup_span=2, giant_backend="direct", giant_span=3,
                      giant_pool=16, giant_pool_full=8)),
}


def _giant_scene(rng, n, giants):
    means = (rng.random((n, 3)) * 2 - 1).astype(np.float32)
    scales = (rng.random((n, 3)) * 0.05 + 0.01).astype(np.float32)
    for sl, lo, hi in giants:
        k = sl.stop - sl.start
        scales[sl] = (rng.random((k, 3)) * (hi - lo) + lo).astype(np.float32)
    quats = rng.standard_normal((n, 4)).astype(np.float32)
    return means, scales, quats


@pytest.mark.parametrize("case", sorted(_GIANT_CASES))
def test_select_macro_pairsort_identical_to_jax(rng, case):
    """Same projected inputs -> identical sorted pair ids, block ranges,
    counts, and windowed [M, Kc] ids and depths."""
    n, giants, kw = _GIANT_CASES[case]
    w, h = kw["image_width"], kw["image_height"]
    cam = _camera(w=w, h=h)
    means, scales, quats = _giant_scene(rng, n, giants)
    js, ts = _settings_pair(**kw)
    (m2d, depth, _, radius, valid), _ = _project_both(cam, means, scales, quats, js, ts)
    th, tw = JR._tile_grid(js)
    mth, mtw = math.ceil(th / js.macro), math.ceil(tw / js.macro)
    packed = 31 - max(1, math.ceil(math.log2(mth * mtw + 2))) >= 16
    assert packed == (case != "unpacked")

    jargs = (jnp.asarray(m2d), jnp.asarray(depth), jnp.asarray(radius), jnp.asarray(valid))
    targs = (_t(m2d), _t(depth), _t(radius), _t(valid))
    jg, jst, jct = JR.select_macro_pairsort(*jargs, mth, mtw, js, segments=True)
    tg, tst, tct = TR.select_macro_pairsort(*targs, mth, mtw, ts, segments=True)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
    np.testing.assert_array_equal(tct.numpy(), np.asarray(jct))
    assert int(tct.sum()) > 0

    ji, jd = JR._macro_select(*jargs, js, mth, mtw)
    ti, td = TR._macro_select(*targs, ts, mth, mtw)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_select_per_tile_identical_to_jax(rng):
    """The chunked top-K merge, with duplicated depths so that ties must go
    to the lower index as lax.top_k sends them."""
    cam = _camera(w=64, h=48)
    means, scales, quats, _, _ = _scene(rng, 90)
    js, ts = _settings_pair(image_height=48, image_width=64, max_per_tile=12, chunk=16)
    (m2d, depth, _, radius, valid), _ = _project_both(cam, means, scales, quats, js, ts)
    depth = np.round(depth, 1)  # many exact ties
    ji, jd = JR.select_per_tile(jnp.asarray(m2d), jnp.asarray(depth), jnp.asarray(radius),
                                jnp.asarray(valid), js)
    ti, td = TR.select_per_tile(_t(m2d), _t(depth), _t(radius), _t(valid), ts)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def _oracle_composite(m2d, depths, conics, radii, valid, colors, opac, bg, w, h):
    """Per-pixel brute force with the same tile-inclusion rule
    (tests/test_gs_rasterizer.py:81)."""
    order = np.argsort(depths)
    img = np.zeros((h, w, 3), np.float32)
    for py in range(h):
        for px in range(w):
            tx0, ty0 = (px // 16) * 16, (py // 16) * 16
            t, c = 1.0, np.zeros(3)
            for gi in order:
                if not valid[gi] or radii[gi] <= 0:
                    continue
                mx, my = m2d[gi]
                r = radii[gi]
                if not (mx + r >= tx0 and mx - r < tx0 + 16 and my + r >= ty0 and my - r < ty0 + 16):
                    continue
                dx, dy = px - mx, py - my
                power = min(0.0, -0.5 * (conics[gi, 0] * dx * dx + conics[gi, 2] * dy * dy)
                            - conics[gi, 1] * dx * dy)
                alpha = min(0.99, opac[gi] * np.exp(power))
                if alpha < 1.0 / 255.0:
                    continue
                if t <= 1e-4:
                    break
                c += alpha * t * colors[gi]
                t *= 1.0 - alpha
            img[py, px] = c + t * bg
    return img


def test_rasterize_matches_bruteforce_and_jax(rng):
    cam = _camera(w=32, h=32)
    means, scales, quats, opac, colors = _scene(rng, 12)
    js, ts = _settings_pair(image_height=32, image_width=32, max_per_tile=32, chunk=16)
    tx, ty = _tanfov(cam)
    bg = np.array([0.1, 0.2, 0.05], np.float32)
    vm, pm = cam.world_view_transform, cam.full_proj_transform
    img, radii = TR.rasterize(_t(means), _t(scales), _t(quats), _t(opac), _t(colors),
                              _t(vm).float(), _t(pm).float(), _t(bg), ts,
                              tanfovx=tx, tanfovy=ty)
    ref, _ = JR.rasterize(jnp.asarray(means), jnp.asarray(scales), jnp.asarray(quats),
                          jnp.asarray(opac), jnp.asarray(colors), jnp.asarray(vm),
                          jnp.asarray(pm), jnp.asarray(bg), js, tanfovx=tx, tanfovy=ty)
    np.testing.assert_allclose(img.numpy(), np.asarray(ref), atol=1e-5)
    m2d, depth, conic, rad, valid = TR.project_gaussians(
        _t(means), _t(scales), _t(quats), _t(vm).float(), _t(pm).float(), tx, ty, ts)
    expect = _oracle_composite(m2d.numpy(), depth.numpy(), conic.numpy(), rad.numpy(),
                               valid.numpy(), colors, opac, bg, 32, 32)
    np.testing.assert_allclose(img.numpy(), expect, atol=2e-3)
    assert radii.shape == (12,)


def _matmul_args(rng, n, giant_rows, cluster=False):
    means, scales, quats, opac, colors = _scene(rng, n, 0.02, 0.1)
    if cluster:
        means[:, :2] *= 0.2
    scales[:giant_rows] = (rng.random((giant_rows, 3)) * 1.0 + 0.3).astype(np.float32)
    return means, scales, quats, opac, colors


# (scene, settings, expected branch): "segment" is the truncation scene of
# tests/test_gs_rasterizer.py:794 (kc below demand); "windowed" emits
# direct giants with deep pools, so S > 3 * M * kc.
_MATMUL_CASES = {
    "segment": ((400, 6, True),
                dict(image_height=96, image_width=128, max_per_tile=48, chunk=64, macro=2,
                     macro_capacity=64, dup_span=2, giant_backend="direct",
                     giant_tiers=((3, 32),), giant_pool_full=8, giant_capacity=64,
                     composite_backend="mxu"), True),
    "windowed": ((80, 5, False),
                 dict(image_height=96, image_width=128, max_per_tile=64, chunk=32, macro=2,
                      macro_capacity=128, dup_span=3, giant_backend="direct", giant_span=8,
                      giant_pool=16384, giant_pool_full=1024, composite_backend="mxu"), False),
    "matmul_backend": ((80, 5, False),
                       dict(image_height=96, image_width=128, max_per_tile=64, chunk=32,
                            macro=2, macro_capacity=128, dup_span=3, giant_capacity=32),
                       False),
}


@pytest.mark.parametrize("case", sorted(_MATMUL_CASES))
def test_rasterize_matmul_matches_jax(rng, case):
    (n, giants, cluster), kw, seg = _MATMUL_CASES[case]
    cam = _camera(w=kw["image_width"], h=kw["image_height"])
    means, scales, quats, opac, colors = _matmul_args(rng, n, giants, cluster)
    js, ts = _settings_pair(**kw)
    th, tw = JR._tile_grid(js)
    mth, mtw = math.ceil(th / js.macro), math.ceil(tw / js.macro)
    # The branch the JAX package's static rule takes (rasterizer.py:1089).
    jax_seg = (js.composite_backend == "mxu"
               and JR._pairsort_slots(n, js, mth, mtw)
               <= JR._SEG_SLOT_RATIO * mth * mtw * js.macro_capacity)
    assert jax_seg == seg == TR.uses_segment_path(n, ts)
    tx, ty = _tanfov(cam)
    bg = np.array([0.05, 0.1, 0.2], np.float32)
    vm, pm = cam.world_view_transform, cam.full_proj_transform
    ref, _ = JR.rasterize_matmul(jnp.asarray(means), jnp.asarray(scales), jnp.asarray(quats),
                                 jnp.asarray(opac), jnp.asarray(colors), jnp.asarray(vm),
                                 jnp.asarray(pm), jnp.asarray(bg), js, tanfovx=tx,
                                 tanfovy=ty, interpret=True)
    TK.reset_launch_counts()
    img, _ = TR.rasterize_matmul(_t(means), _t(scales), _t(quats), _t(opac), _t(colors),
                                 _t(vm).float(), _t(pm).float(), _t(bg), ts,
                                 tanfovx=tx, tanfovy=ty)
    assert TK.launch_counts() == {"composite_macro_mxu_seg": 0, "composite_macro_mxu": 0,
                                  "composite_tiles": 0, "composite_from_macro": 0,
                                  "composite_macro_blocks": 0}
    np.testing.assert_allclose(img.numpy(), np.asarray(ref), atol=2e-4)
    assert np.abs(np.asarray(ref) - bg).max() > 0.1  # splats drawn


def _raw_table(rng, n, bs, mtw, mth):
    """Packed rows whose means fall over a mth x mtw grid of bs-px blocks."""
    raw = np.zeros((n, 16), np.float32)
    raw[:, 0] = rng.random(n) * mtw * bs
    raw[:, 1] = rng.random(n) * mth * bs
    sig = rng.random(n) * 6 + 1.5
    raw[:, 2] = 1.0 / sig ** 2
    raw[:, 3] = (rng.random(n) - 0.5) * 0.2 / sig ** 2
    raw[:, 4] = 1.0 / (sig * (rng.random(n) + 0.5)) ** 2
    raw[:, 5] = np.log(rng.random(n) * 0.9 + 0.05)
    raw[:, 6:9] = rng.random((n, 3))
    return raw


def test_segment_reference_matches_jax_kernel(rng):
    """The plain segment composite against composite_macro_mxu_seg_pallas in
    interpret mode, with an empty block, a segment starting mid-group, and
    counts that are not multiples of 64."""
    bs, mtw, mth, kc = 32, 3, 2, 150
    n_blocks = mtw * mth
    counts = np.array([0, 37, 150, 65, 1, 120], np.int32)
    starts = np.array([0, 5, 50, 210, 300, 301], np.int32)   # 5, 50, 210: mid-group
    raw = _raw_table(rng, 450, bs, mtw, mth)
    bg = np.array([0.2, 0.1, 0.3], np.float32)
    ref = JC.composite_macro_mxu_seg_pallas(jnp.asarray(raw), jnp.asarray(starts),
                                            jnp.asarray(counts), jnp.asarray(bg),
                                            n_blocks=n_blocks, kc=kc, bs=bs, mtw=mtw,
                                            interpret=True)
    out = TK.composite_macro_mxu_seg(_t(raw), _t(starts), _t(counts), _t(bg), n_blocks=n_blocks,
                                     kc=kc, bs=bs, mtw=mtw)
    assert out.shape == (n_blocks, 3, 1, bs * bs)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4)
    np.testing.assert_allclose(out[0, :, 0].numpy(), np.broadcast_to(bg[:, None], (3, bs * bs)))


def test_window_reference_matches_jax_kernel_and_saturates(rng):
    """The plain windowed composite against composite_macro_mxu_pallas in
    interpret mode; one block is opaque after a few rows, so the kernels'
    early exit walks one group of it, not its count."""
    bs, mtw, mth, kc = 32, 2, 2, 200
    raw = np.stack([_raw_table(rng, kc, bs, 1, 1) for _ in range(mtw * mth)])
    for b in range(mtw * mth):
        raw[b, :, 0] += (b % mtw) * bs
        raw[b, :, 1] += (b // mtw) * bs
    # Block 3: ten wide opaque splats first.
    raw[3, :10, 0:2] = [bs * 1.5, bs * 1.5]
    raw[3, :10, 2:5] = [1e-4, 0.0, 1e-4]
    raw[3, :10, 5] = 0.0
    counts = np.array([200, 0, 77, 200], np.int32)
    bg = np.array([0.0, 0.5, 1.0], np.float32)
    ref = JC.composite_macro_mxu_pallas(jnp.asarray(raw), jnp.asarray(counts), jnp.asarray(bg),
                                        bs=bs, mtw=mtw, interpret=True)
    out = TK.composite_macro_mxu(_t(raw), _t(counts), _t(bg), bs=bs, mtw=mtw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4)
    walked = TK.walked_rows(_t(raw), _t(counts), _t(bg), bs, mtw)
    assert walked == 200 + 0 + 77 + 64


def test_wrappers_take_the_plain_version_only_on_the_cpu(rng):
    """A CPU tensor runs the plain version and counts no launch; the
    kernel-only checks (dtype, block size) are not consulted there."""
    raw = _t(_raw_table(rng, 64, 32, 1, 1))[None]
    counts = torch.tensor([64], dtype=torch.int32)
    TK.reset_launch_counts()
    out = TK.composite_macro_mxu(raw, counts, torch.zeros(3), bs=32, mtw=1)
    assert out.shape == (1, 3, 1, 1024)
    assert TK.launch_counts() == {"composite_macro_mxu_seg": 0, "composite_macro_mxu": 0,
                                  "composite_tiles": 0, "composite_from_macro": 0,
                                  "composite_macro_blocks": 0}
    with pytest.raises(ValueError, match="CUDA tensor"):
        TK.check(raw, "raw", torch.float32, 3)      # the wrappers' shared check
