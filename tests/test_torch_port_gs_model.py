"""The port's SH, quaternion, camera, colour-field and model-loading code vs
aip_tpu's, on the CPU.

Inputs are drawn with numpy from a seed and handed to both packages.
Tolerances: SH and the projection math at 1e-5 relative (float32
elementwise, fused differently by XLA); hash encodings at 1e-6 absolute
(eight weighted table reads per level, same order); predicted SH at 1e-5
(three float32 matmuls); the committed model loads bitwise equal (both
packages decode the same streams with the same numpy arithmetic).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aip_tpu.gs import cameras as jcam
from aip_tpu.gs import colorfield as JF
from aip_tpu.gs import compress as JCMP
from aip_tpu.gs import gaussians as JG
from aip_tpu.gs import rvq as jrvq
from aip_tpu.ops import quaternion as jq
from aip_tpu.ops import sh as jsh
from aip_tpu_torch.gs import cameras as tcam
from aip_tpu_torch.gs import colorfield as TF
from aip_tpu_torch.gs import compress as TCMP
from aip_tpu_torch.gs import gaussians as TG
from aip_tpu_torch.gs import rvq as trvq
from aip_tpu_torch.gs.state import from_jax_arrays
from aip_tpu_torch.ops import quaternion as tq
from aip_tpu_torch.ops import sh as tsh
from aip_tpu_torch.runtime import bitcodec as tbit

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
BED = ROOT / "docs" / "examples" / "bed_0037_r5" / "model.npz"


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_eval_sh_matches_jax(rng, deg):
    sh = rng.standard_normal((50, 3, 25)).astype(np.float32)
    dirs = rng.standard_normal((50, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    ref = np.asarray(jsh.eval_sh(deg, jnp.asarray(sh), jnp.asarray(dirs)))
    out = tsh.eval_sh(deg, _t(sh), _t(dirs)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_sh_rgb_and_quaternion_match_jax(rng):
    rgb = rng.random((20, 3)).astype(np.float32)
    np.testing.assert_allclose(tsh.rgb_to_sh(_t(rgb)).numpy(),
                               np.asarray(jsh.rgb_to_sh(jnp.asarray(rgb))), rtol=1e-6)
    np.testing.assert_allclose(tsh.sh_to_rgb(_t(rgb)).numpy(),
                               np.asarray(jsh.sh_to_rgb(jnp.asarray(rgb))), rtol=1e-6)
    q = rng.standard_normal((30, 4)).astype(np.float32)
    np.testing.assert_allclose(tq.build_rotation(_t(q)).numpy(),
                               np.asarray(jq.build_rotation(jnp.asarray(q))), rtol=1e-5,
                               atol=1e-6)
    x = (rng.random(30) * 0.98 + 0.01).astype(np.float32)
    np.testing.assert_allclose(tq.inverse_sigmoid(_t(x)).numpy(),
                               np.asarray(jq.inverse_sigmoid(jnp.asarray(x))), rtol=1e-5,
                               atol=1e-6)


def test_cameras_are_the_same_host_code(rng):
    r = np.linalg.qr(rng.standard_normal((3, 3)))[0]
    t = rng.standard_normal(3)
    kw = dict(colmap_id=0, R=r, T=t, FoVx=0.9, FoVy=0.7,
              image=np.zeros((20, 30, 3), np.float32), image_name="c", uid=0)
    a, b = jcam.Camera(**kw), tcam.Camera(**kw)
    for name in ("world_view_transform", "projection_matrix", "full_proj_transform",
                 "camera_center"):
        np.testing.assert_array_equal(getattr(b, name), getattr(a, name))
    assert tcam.fov2focal(0.9, 30) == jcam.fov2focal(0.9, 30)
    assert tcam.focal2fov(25.0, 30) == jcam.focal2fov(25.0, 30)


def test_gaussian_activations_and_rvq_decode_match_jax(rng):
    n = 40
    state_np = dict(
        xyz=rng.standard_normal((n, 3)).astype(np.float32),
        scaling=rng.standard_normal((n, 3)).astype(np.float32),
        rotation=rng.standard_normal((n, 4)).astype(np.float32),
        opacity=rng.standard_normal((n, 1)).astype(np.float32),
        mask=np.ones((n, 1), np.float32), active=rng.random(n) > 0.2,
        max_radii2d=np.zeros(n, np.float32), xyz_grad_accum=np.zeros((n, 1), np.float32),
        denom=np.zeros((n, 1), np.float32))
    js = JG.GaussianState(**{k: jnp.asarray(v) for k, v in state_np.items()})
    ts, _ = from_jax_arrays(state_np, None, "cpu")
    for jf, tf in ((JG.get_scaling, TG.get_scaling), (JG.get_opacity, TG.get_opacity),
                   (JG.get_rotation, TG.get_rotation)):
        np.testing.assert_allclose(tf(ts).numpy(), np.asarray(jf(js)), rtol=1e-6, atol=1e-7)
    assert int(ts.n_active) == int(js.n_active) and ts.capacity == n
    books = rng.standard_normal((6, 64, 3)).astype(np.float32)
    idx = rng.integers(0, 64, (n, 6))
    np.testing.assert_array_equal(
        trvq.decode(trvq.RVQState(_t(books)), _t(idx)).numpy(),
        np.asarray(jrvq.decode(jrvq.RVQState(jnp.asarray(books)), jnp.asarray(idx))))


def _field(style_dim, log2_hashmap):
    jf = JF.init_colorfield(jax.random.PRNGKey(3), style_dim=style_dim,
                            log2_hashmap=log2_hashmap)
    jf = jf._replace(hash_tables=jf.hash_tables * 1e3)  # features well above the init scale
    field_np = {k: None if v is None else np.asarray(v) for k, v in jf._asdict().items()}
    return jf, from_jax_arrays({k: np.zeros(1) for k in TG.GaussianState._fields},
                               field_np, "cpu")[1]


@pytest.mark.parametrize("log2_hashmap,n_dense", [(10, 0), (14, 2)])
def test_hash_encode_matches_jax_dense_and_hashed_levels(rng, log2_hashmap, n_dense):
    """At 2^10 every level hashes; at 2^14 the first two are dense."""
    sizes = JF.level_table_sizes_for_cap(2 ** log2_hashmap)
    assert TF.level_table_sizes_for_cap(2 ** log2_hashmap) == sizes
    assert sum(s < 2 ** log2_hashmap for s in sizes) == n_dense
    jf, tf = _field(None, log2_hashmap)
    xyz = (rng.standard_normal((300, 3)) * 1.5).astype(np.float32)
    x01 = np.asarray(JF.contract_to_unisphere(jnp.asarray(xyz)))
    np.testing.assert_allclose(TF.contract_to_unisphere(_t(xyz)).numpy(), x01, rtol=1e-6,
                               atol=1e-7)
    ref = np.asarray(JF.hash_encode(jf.hash_tables, jnp.asarray(x01)))
    out = TF.hash_encode(tf.hash_tables, _t(x01)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6)
    assert np.abs(ref).max() > 1e-2


@pytest.mark.parametrize("with_style", [False, True])
def test_predict_sh_matches_jax(rng, with_style):
    jf, tf = _field(256 if with_style else None, 12)
    xyz = rng.standard_normal((200, 3)).astype(np.float32)
    style = rng.standard_normal((1, 512)).astype(np.float32) if with_style else None
    ref = np.asarray(JF.predict_sh(jf, jnp.asarray(xyz),
                                   None if style is None else jnp.asarray(style)))
    out = TF.predict_sh(tf, _t(xyz), None if style is None else _t(style)).numpy()
    assert out.shape == (200, 16, 3)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    enc = TF.precompute_features(tf, _t(xyz))
    np.testing.assert_array_equal(
        TF.predict_sh(tf, _t(xyz), None if style is None else _t(style),
                      precomputed_enc=enc).numpy(), out)


@pytest.fixture(scope="module")
def bed_models():
    return JCMP.load_npz(BED), TCMP.load_npz(BED, device="cpu")


def test_load_npz_of_the_committed_model_is_bitwise_equal(bed_models):
    (js, jf, jrs, jrr), (ts, tf, trs, trr) = bed_models
    assert ts.capacity == 130968
    for name in js._fields:
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                      err_msg=name)
    for name in jf._fields:
        np.testing.assert_array_equal(getattr(tf, name).numpy(), np.asarray(getattr(jf, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(trs.codebooks.numpy(), np.asarray(jrs.codebooks))
    np.testing.assert_array_equal(trr.codebooks.numpy(), np.asarray(jrr.codebooks))


def test_from_jax_arrays_carries_the_committed_model(bed_models):
    (js, jf, _, _), (ts, tf, _, _) = bed_models
    state, field = from_jax_arrays({k: np.asarray(v) for k, v in js._asdict().items()},
                                   {k: np.asarray(v) for k, v in jf._asdict().items()}, "cpu")
    for a, b in zip(state, ts):
        assert torch.equal(a, b)
    for a, b in zip(field, tf):
        assert torch.equal(a, b)


def test_load_npz_pads_capacity_and_refuses_legacy_streams(tmp_path, bed_models):
    (js, _, _, _), _ = bed_models
    ts, _, _, _ = TCMP.load_npz(BED, capacity=131072, device="cpu")
    jsp, _, _, _ = JCMP.load_npz(BED, capacity=131072)
    np.testing.assert_array_equal(ts.rotation.numpy(), np.asarray(jsp.rotation))
    assert int(ts.n_active) == 130968
    # A full [L, T, F] stream at a cap (2^14) where the coarse levels are dense.
    d = dict(np.load(BED))
    d["hash_shape"] = np.array([16, 1 << 14, 2])
    stream = JCMP._encode_stream(np.zeros(16 << 15, np.int64))
    d.update({f"hash_{k}": v for k, v in stream.items()})
    np.savez(tmp_path / "legacy.npz", **d)
    with pytest.raises(ValueError, match="legacy full-table"):
        TCMP.load_npz(tmp_path / "legacy.npz", device="cpu")


def test_bitcodec_round_trip_and_truncation(rng):
    symbols = np.concatenate([np.zeros(300, np.int64), rng.integers(0, 32, 200)])
    lengths = {s: l for s, (_c, l) in JCMP.huffman_build(symbols).items()}
    codes, tables = tbit.canonical_codes(lengths)
    packed, bits = tbit.pack(symbols, codes)
    jpacked, _, _, jbits = JCMP.huffman_encode(symbols)
    assert bits == jbits
    np.testing.assert_array_equal(packed, jpacked)
    np.testing.assert_array_equal(tbit.unpack(packed, len(symbols), tables), symbols)
    np.testing.assert_array_equal(TCMP.huffman_decode(packed, codes, len(symbols)), symbols)
    saved = tbit._LIB
    try:
        tbit._LIB = None
        np.testing.assert_array_equal(tbit.unpack(packed, len(symbols), tables), symbols)
        with pytest.raises(ValueError):
            tbit.unpack(packed[: len(packed) // 4], len(symbols), tables)
    finally:
        tbit._LIB = saved
    with pytest.raises(ValueError):
        tbit.unpack(packed[: len(packed) // 4], len(symbols), tables)
