"""The port's Gaussian state and model storage vs aip_tpu's, on the CPU:
metrics, kNN and Morton order, densification, pruning and the capacity
buckets, the RVQ training half, and the npz / PLY save path across the two
packages.

Inputs are drawn with numpy from a seed and handed to both packages; where
the JAX package draws its own random numbers (split offsets, k-means
starts) the test replays its key splits and hands the draws to the port.

Tolerances, with their reasons:
* metrics at 1e-6 .. 1e-5 (float32, sums in another order; SSIM's window
  is applied as two banded products instead of one 2D conv), SSIM's
  gradient at 1e-4 of its largest entry;
* kNN at 1e-5 relative and 1e-6 absolute (|a|^2 + |b|^2 - 2 a.b cancels),
  and the log scales made from it at 1e-5;
* densification, pruning and buckets exactly, or at 1e-6 where the values
  went through float32 arithmetic on the same slots (the same ops;
  selections by the same comparisons);
* saved files compared array by array, exactly.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from aip_tpu.gs import compress as JC
from aip_tpu.gs import gaussians as JG
from aip_tpu.gs import rvq as JQ
from aip_tpu.ops import knn as jknn
from aip_tpu.ops import metrics as jmet
from aip_tpu.ops import morton as jmor
from aip_tpu_torch.gs import compress as TC
from aip_tpu_torch.gs import gaussians as TG
from aip_tpu_torch.gs import rvq as TQ
from aip_tpu_torch.gs.state import from_jax_arrays
from aip_tpu_torch.ops import knn as tknn
from aip_tpu_torch.ops import metrics as tmet
from aip_tpu_torch.ops import morton as tmor

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np_tree(state):
    return {k: np.asarray(v) for k, v in state._asdict().items()}


# ---------------------------------------------------------------------------
# Metrics, kNN, Morton
# ---------------------------------------------------------------------------

def test_metrics_match_jax(rng):
    a = rng.random((2, 37, 29, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    np.testing.assert_allclose(float(tmet.l1_loss(_t(a), _t(b))),
                               float(jmet.l1_loss(a, b)), rtol=1e-6)
    np.testing.assert_allclose(tmet.psnr(_t(a), _t(b)).numpy(), np.asarray(jmet.psnr(a, b)),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tmet.ssim(_t(a), _t(b))), float(jmet.ssim(a, b)),
                               atol=1e-6)
    # SSIM's gradient drives the photometric loss.
    ref = np.asarray(jax.grad(lambda x: jmet.ssim(x, jnp.asarray(b)))(jnp.asarray(a)))
    x = _t(a).requires_grad_()
    tmet.ssim(x, _t(b)).backward()
    assert np.abs(x.grad.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()


def test_knn_matches_jax_across_blocks(rng):
    pts = (rng.random((700, 3)) * 2 - 1).astype(np.float32)
    pts[5] = pts[6]           # a duplicate: distance 0 clamps to 1e-7
    ref = np.asarray(jknn.mean_knn_sq_dist(jnp.asarray(pts), k=3, block_size=128))
    out = tknn.mean_knn_sq_dist(_t(pts), k=3, block_size=96).numpy()
    # |a|^2 + |b|^2 - 2 a.b cancels: absolute float32 noise ~ eps * |a|^2.
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_morton_matches_jax(rng):
    grid = rng.integers(0, 1 << 21, (500, 3)).astype(np.uint64)
    codes = tmor.morton_encode_np(grid)
    from aip_tpu.ops.morton import morton_encode_np

    np.testing.assert_array_equal(codes, morton_encode_np(grid))
    np.testing.assert_array_equal(tmor.morton_encode(_t(grid.astype(np.int64))).numpy(),
                                  codes.astype(np.int64))
    pos = rng.random((600, 3)).astype(np.float32)
    pos[10:20] = pos[0]       # ties keep their order
    lo, hi = pos.min(0), pos.max(0)
    ref = np.asarray(jmor.morton_argsort(jnp.asarray(pos), jnp.asarray(lo), jnp.asarray(hi)))
    np.testing.assert_array_equal(tmor.morton_argsort(_t(pos), _t(lo), _t(hi)).numpy(), ref)


# ---------------------------------------------------------------------------
# Gaussian state: densification, pruning, capacity buckets
# ---------------------------------------------------------------------------

def _assert_states_equal(ts, js, atol=0.0):
    for name, a in ts._asdict().items():
        b = np.asarray(getattr(js, name))
        if a.dtype == torch.bool:
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
        else:
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=atol, err_msg=name)


def test_create_from_pcd_matches_jax(rng):
    pts = (rng.random((90, 3)) * 2 - 1).astype(np.float32)
    cols = rng.random((90, 3)).astype(np.float32)
    js, jdc = JG.create_from_pcd(jnp.asarray(pts), jnp.asarray(cols), 128)
    ts, tdc = TG.create_from_pcd(pts, cols, 128, device="cpu")
    _assert_states_equal(ts, js, atol=1e-5)       # log scales carry the kNN's noise
    np.testing.assert_allclose(tdc.numpy(), np.asarray(jdc), atol=1e-7)


def _stats_state(rng, cap=96, n=70):
    """A state with accumulated densification statistics: some Gaussians
    over the gradient threshold, small and large, a few pruned by mask or
    opacity."""
    pts = (rng.random((n, 3)) * 2 - 1).astype(np.float32)
    js, _ = JG.create_from_pcd(jnp.asarray(pts), jnp.asarray(rng.random((n, 3))), cap)
    scal = np.asarray(js.scaling).copy()
    scal[:n] = np.log(rng.random((n, 3)) * 0.08 + 0.002)
    mask = np.asarray(js.mask).copy()
    mask[:5] = -6.0                          # gate off
    opac = np.asarray(js.opacity).copy()
    opac[5:9] = -7.0                         # below min opacity
    rot = np.asarray(js.rotation).copy()
    rot[:n] = rng.standard_normal((n, 4))
    js = js._replace(scaling=jnp.asarray(scal), mask=jnp.asarray(mask),
                     opacity=jnp.asarray(opac), rotation=jnp.asarray(rot))
    for _ in range(3):
        g = (rng.standard_normal((cap, 2)) * 2e-4).astype(np.float32)
        radii = (rng.random(cap) * 30).astype(np.float32)
        radii[rng.random(cap) < 0.2] = 0.0
        js = JG.add_densification_stats(js, jnp.asarray(g), jnp.asarray(radii), 64, 48)
    return js


def test_densify_prune_recompact_and_grow_match_jax(rng):
    """One densification event as ``train`` runs it (stats -> clone ->
    split with the JAX draws -> prune -> reset), then opacity reset, mask
    prune and the capacity buckets applied to the state and an Adam
    moment tree; every slot of the port's state equals the JAX one."""
    js = _stats_state(rng)
    ts, _ = from_jax_arrays(_np_tree(js), None, "cpu")
    g = (rng.standard_normal((96, 2)) * 2e-4).astype(np.float32)
    radii = (rng.random(96) * 30).astype(np.float32)
    js = JG.add_densification_stats(js, jnp.asarray(g), jnp.asarray(radii), 64, 48)
    ts = TG.add_densification_stats(ts, _t(g), _t(radii), width=64, height=48)
    _assert_states_equal(ts, js, atol=1e-9)

    extent = 1.5
    jgrads, tgrads = JG.avg_densify_grads(js), TG.avg_densify_grads(ts)
    js, jc = JG.densify_and_clone(js, 2e-4, 0.01 * 3, extent, grads=jgrads)
    ts, tc = TG.densify_and_clone(ts, 2e-4, 0.01 * 3, extent, grads=tgrads)
    assert int(jc.sum()) > 0
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    _assert_states_equal(ts, js)

    key = jax.random.PRNGKey(3)
    samples, k = [], key
    for _ in range(2):                      # densify_and_split's own key splits
        k, sub = jax.random.split(k)
        samples.append(np.array(jax.random.normal(sub, js.xyz.shape)))
    js, jsplit = JG.densify_and_split(js, key, 2e-4, 0.01 * 3, extent, grads=jgrads)
    ts, tsplit = TG.densify_and_split(ts, 2e-4, 0.01 * 3, extent, grads=tgrads, samples=samples)
    assert int(jsplit.sum()) > 0
    np.testing.assert_array_equal(tsplit.numpy(), np.asarray(jsplit))
    _assert_states_equal(ts, js, atol=1e-6)

    js = JG.reset_stats(JG.prune(js, 0.005, extent, 20.0))
    ts = TG.reset_stats(TG.prune(ts, 0.005, extent, 20.0))
    js, ts = JG.reset_opacity(js), TG.reset_opacity(ts)
    js, ts = JG.mask_prune(js), TG.mask_prune(ts)
    _assert_states_equal(ts, js, atol=1e-6)

    n = int(js.n_active)
    assert TG.capacity_bucket(n, floor=16) == JG.capacity_bucket(n, floor=16)
    bucket = TG.capacity_bucket(n, floor=16, headroom=1)
    assert bucket < 96
    mom = {"xyz": rng.random((96, 3)).astype(np.float32), "count": np.int32(4)}
    jorder = JG.recompact_order(js)
    torder = TG.recompact_order(ts)
    np.testing.assert_array_equal(torder.numpy(), np.asarray(jorder))
    js2 = JG.shrink_tree(js, jorder, bucket)
    ts2 = TG.shrink_tree(ts, torder, bucket)
    _assert_states_equal(ts2, js2, atol=1e-6)
    jm = JG.shrink_tree({"xyz": jnp.asarray(mom["xyz"]), "count": jnp.asarray(mom["count"])},
                        jorder, bucket)
    tm = TG.shrink_tree({"xyz": _t(mom["xyz"]), "count": torch.tensor(4)}, torder, bucket)
    np.testing.assert_array_equal(tm["xyz"].numpy(), np.asarray(jm["xyz"]))
    assert int(tm["count"]) == 4
    _assert_states_equal(TG.grow_tree(ts2, bucket, 128), JG.grow_tree(js2, bucket, 128),
                         atol=1e-6)


def test_rvq_training_half_matches_jax(rng):
    """k-means seeding from the JAX package's random rows, quantisation
    (indices and the straight-through value) and one masked codebook step."""
    data = (rng.standard_normal((300, 3)) * 0.5).astype(np.float32)
    key = jax.random.PRNGKey(5)
    ref = JQ.kmeans_init(key, jnp.asarray(data), 3, 16, iters=2)
    starts, k = [], key
    for _ in range(3):                      # kmeans_init's own key splits
        k, sub = jax.random.split(k)
        starts.append(np.array(jax.random.choice(sub, 300, (16,), replace=False)))
    out = TQ.kmeans_init(_t(data), 3, 16, iters=2, starts=starts)
    np.testing.assert_allclose(out.codebooks.numpy(), np.asarray(ref.codebooks), atol=1e-6)

    jq, jidx = JQ.quantize(ref, jnp.asarray(data))
    tq, tidx = TQ.quantize(out, _t(data))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-6)
    mask = rng.random(300) < 0.7
    jb = JQ.update_codebooks(ref, jnp.asarray(data), jnp.asarray(mask))
    tb = TQ.update_codebooks(out, _t(data), _t(mask))
    np.testing.assert_allclose(tb.codebooks.numpy(), np.asarray(jb.codebooks), atol=1e-6)
    # Without starts the port draws distinct rows from its generator.
    drawn = TQ.kmeans_init(_t(data), 2, 16, generator=torch.Generator().manual_seed(0))
    assert drawn.codebooks.shape == (2, 16, 3)


# ---------------------------------------------------------------------------
# The save path
# ---------------------------------------------------------------------------

def test_npz_saved_by_either_package_loads_in_the_other(tmp_path, rng):
    js = _stats_state(rng, cap=96, n=80)
    js = js._replace(active=js.active.at[3].set(False))
    from aip_tpu.gs.colorfield import init_colorfield

    jf = init_colorfield(jax.random.PRNGKey(4), style_dim=16, log2_hashmap=10)
    jf = jf._replace(hash_tables=jf.hash_tables * 1e3)
    act = np.asarray(js.active)
    jrs = JQ.kmeans_init(jax.random.PRNGKey(0), JG.get_scaling(js)[act], 2, 8)
    jrr = JQ.kmeans_init(jax.random.PRNGKey(1), JG.get_rotation(js)[act], 2, 8)
    ts, tf = from_jax_arrays(_np_tree(js), _np_tree(jf), "cpu")
    trs, trr = TQ.RVQState(_t(jrs.codebooks)), TQ.RVQState(_t(jrr.codebooks))

    jrep = JC.save_npz(tmp_path / "j" / "model.npz", js, jf, jrs, jrr)
    trep = TC.save_npz(tmp_path / "t" / "model.npz", ts, tf, trs, trr)
    assert trep.splitlines()[0] == "Storage" and len(trep.splitlines()) == len(jrep.splitlines())
    with np.load(tmp_path / "j" / "model.npz") as a, np.load(tmp_path / "t" / "model.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for name in ("xyz", "opacity", "hash_packed", "sc_books", "mlp_mlp_w1", "style_w"):
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    for src in ("j", "t"):
        path = tmp_path / src / "model.npz"
        ref = JC.load_npz(path)
        out = TC.load_npz(path, device="cpu")
        _assert_states_equal(out[0], ref[0], atol=1e-6)
        for name in ("hash_tables", "mlp_w1", "style_b"):
            np.testing.assert_array_equal(getattr(out[1], name).numpy(),
                                          np.asarray(getattr(ref[1], name)))
    assert TC.huffman_size_bytes(np.array([1, 1, 2, 3])) == JC.huffman_size_bytes(
        np.array([1, 1, 2, 3]))
    np.testing.assert_array_equal(TC.sort_active_by_morton(ts), JC.sort_active_by_morton(js))


def test_ply_roundtrip(tmp_path, rng):
    js = _stats_state(rng, cap=64, n=50)
    ts, _ = from_jax_arrays(_np_tree(js), None, "cpu")
    TC.save_ply(tmp_path / "p.ply", ts)
    ref, _ = JC.load_ply(tmp_path / "p.ply", capacity=64)
    out, sh = TC.load_ply(tmp_path / "p.ply", capacity=64, device="cpu")
    assert sh is None
    _assert_states_equal(out, ref)
    np.testing.assert_array_equal(out.xyz[:50].numpy(), ts.xyz[:50].numpy())
