"""The port's ``parallel/`` (meshes, placements, the sharded AdaIN and
distillation steps, batched inference, frame-sharded video, view- and
Gaussian-sharded 3DGS training and Gaussian-sharded rendering) against
aip_tpu's, on the CPU.

JAX runs on the conftest's 8-device virtual CPU mesh; the port on meshes
of repeated ``cpu`` devices of the same shapes, which run every split,
gather and shard-order sum of the sharded paths. Where aip_tpu's own
sharded call needs minutes to compile on the CPU (the gradient of a
``shard_map``: its tests of those are in the slow tier), the port's
sharded path is held against aip_tpu's one-device path, which those JAX
tests hold equal to its sharded one.

Tolerances, with their reasons:
* the AdaIN train step: aip_tpu's rule for its own (dp, tp) step
  (tests/test_parallel_train.py): the loss at 1e-5 relative; Adam's first
  update is +-lr per entry, so an entry whose gradient is within rounding
  of 0 may step the other way: every entry within 2 lr, and fewer than
  1e-4 of them off by more than 1e-6;
* batched inference: the AdaIN fp32 gate of the pipeline tests (mean abs
  1e-3, max abs 1e-2);
* distillation: the loss at 1e-5 relative (1e-6 against the port's one
  device), one step's parameters within 2 lr and their mean within 1e-2 lr
  (the one-device test's rule, against both);
* video: the PNG gate of the video tests (mean abs 1e-3, max one 8-bit
  step);
* 3DGS steps: the one-view step's gates (loss 1e-5 relative, first
  moments 1e-4 of their largest entry, 1e-3 for the hash table); the
  sharded loop against the unsharded one at aip_tpu's 1e-4 relative and
  1e-6 absolute;
* ``predict_sh_sharded``: aip_tpu's gates (values 1e-5, field gradients
  1e-4 relative and absolute);
* rendering: the render gate of 2e-4 (ROADMAP queue 3), radii equal.
"""

import copy
import functools
import math

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from aip_tpu.gs import train as JT
from aip_tpu.models import magenta as jmag
from aip_tpu.models import magenta_train as jmt
from aip_tpu.parallel import infer as jinfer
from aip_tpu.parallel import mesh as jmesh
from aip_tpu.parallel import sharding as jsharding
from aip_tpu.parallel import train as jtrain
from aip_tpu.pipelines import adain_infer as jadain
from aip_tpu.pipelines import video as jvideo
from aip_tpu_torch.gs import train as TT
from aip_tpu_torch.gs.state import from_jax_arrays
from aip_tpu_torch.models import decoder as tdec
from aip_tpu_torch.models import magenta as tmag
from aip_tpu_torch.models import magenta_train as tmt
from aip_tpu_torch.models import vgg as tvgg
from aip_tpu_torch.models import weights as tweights
from aip_tpu_torch.parallel import gs as tgs
from aip_tpu_torch.parallel import infer as tinfer
from aip_tpu_torch.parallel import mesh as tmesh
from aip_tpu_torch.parallel import sharding as tsharding
from aip_tpu_torch.parallel import train as ttrain
from aip_tpu_torch.pipelines import video as tvideo

torch.set_num_threads(2)
LR = 1e-4


def _t(x):
    return torch.from_numpy(np.array(x))


def _cpu_mesh(shape, axes):
    return tmesh.make_mesh(["cpu"] * math.prod(shape), axes, shape)


def _jax_mesh(shape, axes):
    return jmesh.make_mesh(jax.devices()[:math.prod(shape)], axes, shape)


# ---------------------------------------------------------------------------
# Meshes and placements
# ---------------------------------------------------------------------------

def test_best_grid_and_make_mesh_match_jax():
    for n in range(1, 9):
        for axes in (1, 2):
            assert tmesh.best_grid(n, axes) == jmesh.best_grid(n, axes)
    for shape, axes in (((8,), ("dp",)), ((4, 2), ("dp", "tp")), (None, ("dp", "tp"))):
        j = jmesh.make_mesh(jax.devices()[:8], axes, shape)
        t = tmesh.make_mesh(["cpu"] * 8, axes, shape)
        assert dict(t.shape) == dict(j.shape) and t.axis_names == j.axis_names
        assert t.size == j.size == 8 and t.devices.shape == j.devices.shape
    for mod, devs in ((jmesh, jax.devices()[:8]), (tmesh, ["cpu"] * 8)):
        with pytest.raises(ValueError, match="mesh shape"):
            mod.make_mesh(devs, ("dp", "tp"), (3, 2))
    assert _cpu_mesh((4, 2), ("dp", "tp")).axis_devices("tp") == [torch.device("cpu")] * 2


def test_make_dp_mesh_takes_the_first_cards_and_never_fewer(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tmesh.make_dp_mesh(0) is None and tmesh.make_dp_mesh(1) is None
    with pytest.raises(ValueError, match="needs 2 CUDA cards, 1 are visible"):
        tmesh.make_dp_mesh(2)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    mesh = tmesh.make_dp_mesh(2)
    assert list(mesh.devices) == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert dict(mesh.shape) == {"dp": 2} and mesh.home == torch.device("cuda", 0)
    assert list(tmesh.make_dp_mesh(3, device="cpu").devices) == [torch.device("cpu")] * 3


def test_placements_match_jax():
    jm, tm = _jax_mesh((4, 2), ("dp", "tp")), _cpu_mesh((4, 2), ("dp", "tp"))
    dec = tdec.init_decoder_params(1, device="cpu")
    hwio = tweights.hwio_params(dec)
    jspecs = jsharding.conv_param_sharding(jm, jax.tree.map(jnp.asarray, hwio))
    tspecs = tsharding.conv_param_sharding(tm, hwio)
    assert [{k: tuple(s.spec) for k, s in p.items()} for p in jspecs] == \
        [{k: s.spec for k, s in p.items()} for p in tspecs]
    assert any(p["w"].spec == (None, None, None, "tp") for p in tspecs)
    # The module form names the same split on the port's OIHW weights.
    for by_hwio, by_module in zip(tspecs, tsharding.conv_param_sharding(tm, dec)):
        assert by_module["w"].spec == (("tp", None, None, None) if by_hwio["w"].spec else ())
        assert by_module["b"].spec == by_hwio["b"].spec
    assert tuple(jsharding.batch_sharding(jm).spec) == tsharding.batch_sharding(tm).spec
    assert tuple(jsharding.replicated(jm).spec) == tsharding.replicated(tm).spec


# ---------------------------------------------------------------------------
# The AdaIN decoder's (dp, tp) train step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def adain():
    vt = tvgg.init_vgg_params(0, device="cpu")
    dt = tdec.init_decoder_params(1, device="cpu")
    g = np.random.default_rng(0)
    c = g.random((8, 32, 32, 3)).astype(np.float32)
    s = g.random((8, 32, 32, 3)).astype(np.float32)
    return vt, dt, c, s


def _jax_nets(vt, dt):
    return [jax.tree.map(jnp.asarray, tweights.hwio_params(m)) for m in (vt, dt)]


def _assert_adam_rule(pairs):
    for name, a, b in pairs:
        diff = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
        assert diff.max() <= 2 * LR + 1e-6, (name, diff.max())
        assert (diff > 1e-6).mean() < 1e-4, (name, (diff > 1e-6).mean())


def test_dp_tp_step_matches_jax(adain):
    vt, dt, c, s = adain
    vj, dj = _jax_nets(vt, dt)
    jm = _jax_mesh((4, 2), ("dp", "tp"))
    jopt = jtrain.make_optimizer()
    vj_r, jstate = jtrain.shard_train_setup(jm, vj, dj, jopt)
    jstep = jtrain.compile_train_step(jm, jopt, vj_r)
    bs = jsharding.batch_sharding(jm)
    jstate, jmet = jstep(jstate, jax.device_put(jnp.asarray(c), bs),
                         jax.device_put(jnp.asarray(s), bs))

    tm = _cpu_mesh((4, 2), ("dp", "tp"))
    topt = ttrain.make_optimizer()
    vt_r, tstate = ttrain.shard_train_setup(tm, copy.deepcopy(vt), copy.deepcopy(dt), topt)
    tstep = ttrain.compile_train_step(tm, topt, vt_r)
    tstate, tmet = tstep(tstate, tsharding.shard_batch(tm, _t(c)), _t(s))
    assert abs(tmet["loss"].item() - float(jmet["loss"])) <= 1e-5 * float(jmet["loss"])
    got = tweights.hwio_params(tstate.params)
    _assert_adam_rule([(f"{i}{k}", g[k], np.asarray(p[k]))
                       for i, (g, p) in enumerate(zip(got, jstate.params)) for k in ("w", "b")])
    assert tstate.step == int(jstate.step) == 1


def test_tp_actually_shards_conv_channels(adain):
    """Every conv that aip_tpu splits over tp is a ``ColumnParallelConv``
    whose slices (O / tp output channels each) lie on the tp devices of the
    mesh's first row, before and after a step; the 64 -> 3 conv is not."""
    vt, dt, c, s = adain
    tm = _cpu_mesh((4, 2), ("dp", "tp"))
    specs = tsharding.conv_param_sharding(tm, dt)
    opt = ttrain.make_optimizer()
    vt_r, state = ttrain.shard_train_setup(tm, copy.deepcopy(vt), copy.deepcopy(dt), opt)

    def check(dec):
        wide = 0
        for conv, spec in zip(dec.convs, specs):
            o = conv.weight.shape[0]
            if spec["w"].spec:
                wide += 1
                assert isinstance(conv, ttrain.ColumnParallelConv), o
                assert conv.devices == list(tm.devices[0])
                assert [tuple(w.shape) for w in conv.weight_shards] == [(o // 2, *conv.weight.shape[1:])] * 2
                assert [b.shape[0] for b in conv.bias_shards] == [o // 2] * 2
            else:
                assert isinstance(conv, torch.nn.Conv2d)
        assert wide == 8

    check(state.params)
    step = ttrain.compile_train_step(tm, opt, vt_r)
    state, _ = step(state, _t(c), _t(s))
    check(state.params)


def test_distillation_on_a_mesh_matches_one_device_and_jax(adain, tmp_path, monkeypatch):
    """One distillation step with the content batch over a (2,) mesh: the
    port against its one-device step and against aip_tpu's step on
    content sharded over its (2,) mesh (teacher in fp32, as the port's)."""
    vt, dt, _, _ = adain
    vj, dj = _jax_nets(vt, dt)
    monkeypatch.setattr(jadain, "stylize_simple",
                        functools.partial(jadain.stylize_simple, compute_dtype=jnp.float32))
    g = np.random.default_rng(2)
    c = g.random((2, 32, 32, 3)).astype(np.float32)
    s = g.random((32, 32, 3)).astype(np.float32)
    path = tmp_path / "m.npz"
    tmag.save_magenta_npz(tmag.init_magenta_params(device="cpu"), path)
    lr = 1e-3

    jopt = jtrain.make_optimizer(lr)
    pj = jmag.load_magenta_npz(path)
    jm = _jax_mesh((2,), ("dp",))
    from jax.sharding import NamedSharding, PartitionSpec as P

    c_j = jax.device_put(jnp.asarray(c), NamedSharding(jm, P("dp", None, None, None)))
    pj1, _, lj = jmt.make_distill_step(jopt, vj, dj)(pj, jopt.init(pj), c_j, jnp.asarray(s))
    jmag.save_magenta_npz(pj1, tmp_path / "j1.npz")

    outs = {}
    for name, devices in (("one", None), ("mesh", [torch.device("cpu")] * 2)):
        topt = ttrain.make_optimizer(lr)
        pt = tmag.load_magenta_npz(path, "cpu")
        step = tmt.make_distill_step(topt, copy.deepcopy(vt), copy.deepcopy(dt),
                                     devices=devices)
        state = topt.init({k: p.detach() for k, p in tmt._named(pt)})
        pt, state, loss = step(pt, state, _t(c), _t(s))
        tmag.save_magenta_npz(pt, tmp_path / f"{name}.npz")
        outs[name] = loss.item()
        assert int(state.count) == 1
    assert abs(outs["mesh"] - outs["one"]) <= 1e-6 * outs["one"]
    assert abs(outs["mesh"] - float(lj)) <= 1e-5 * float(lj)
    with np.load(tmp_path / "mesh.npz") as a, np.load(tmp_path / "one.npz") as b, \
            np.load(tmp_path / "j1.npz") as j:
        assert set(a.files) == set(b.files) == set(j.files)
        for other in (b, j):
            total = n = 0
            for k in a.files:
                diff = np.abs(a[k].astype(np.float64) - other[k])
                assert diff.max() <= 2 * lr + 1e-6, k
                total, n = total + diff.sum(), n + diff.size
            assert total / n <= 1e-2 * lr


def test_compile_batch_stylize_matches_jax(adain):
    vt, dt, c, s = adain
    vj, dj = _jax_nets(vt, dt)
    ref = jinfer.compile_batch_stylize(_jax_mesh((4, 1), ("dp", "tp")), 0.5, jnp.float32)(
        vj, dj, jnp.asarray(c[:4]), jnp.asarray(s[:4]))
    fn = tinfer.compile_batch_stylize(_cpu_mesh((4,), ("dp",)), 0.5, torch.float32)
    out = fn(vt, dt, _t(c[:4]), _t(s[:4]))
    err = np.abs(out.numpy() - np.asarray(ref))
    assert out.shape == (4, 32, 32, 3)
    assert err.mean() <= 1e-3 and err.max() <= 1e-2, (err.mean(), err.max())
    with pytest.raises(ValueError, match="does not split"):
        fn(vt, dt, _t(c[:3]), _t(s[:3]))


# ---------------------------------------------------------------------------
# Video: frames over four devices
# ---------------------------------------------------------------------------

def test_video_sharded_over_four_devices(adain, tmp_path, monkeypatch):
    """8 frames at 32^2, one style, fp32: aip_tpu with ``shard=True`` over
    its 8 CPU devices (its frame-parallel mesh runs: 8 divides 8), the port
    over 4 devices of ``local_devices`` (2 frames each, 3 pairs across a
    boundary), and the port on one device."""
    vt, dt, _, _ = adain
    vj, dj = _jax_nets(vt, dt)
    g = np.random.default_rng(4)
    frames = tmp_path / "frames"
    frames.mkdir()
    base = g.random((40, 40, 3))
    for i in range(8):
        Image.fromarray((base[i % 4:i % 4 + 32, 0:32] * 255).astype(np.uint8)).save(
            frames / f"f_{i:03d}.png")
    styles = tmp_path / "styles"
    styles.mkdir()
    Image.fromarray((g.random((32, 32, 3)) * 255).astype(np.uint8)).save(styles / "s.png")
    kw = dict(target_resolution=(32, 32), use_depth=True)
    ref = jvideo.apply_style_transfer_multi_ada(frames, styles, tmp_path / "j", vgg_params=vj,
                                                dec_params=dj, compute_dtype=jnp.float32,
                                                shard=True, **kw)
    one = tvideo.apply_style_transfer_multi_ada(frames, styles, tmp_path / "one", vgg_params=vt,
                                                dec_params=dt, compute_dtype=torch.float32,
                                                device="cpu", **kw)
    seen = []
    monkeypatch.setattr(tmesh, "local_devices",
                        lambda dev: seen.append(dev) or [torch.device("cpu")] * 4)
    trace = {}
    out = tvideo.apply_style_transfer_multi_ada(frames, styles, tmp_path / "four", vgg_params=vt,
                                                dec_params=dt, compute_dtype=torch.float32,
                                                device="cpu", trace=trace, **kw)
    assert seen and len(out) == 8 and trace["flows"].shape == (7, 32, 32, 2)
    assert tvideo._frame_shards(8, [0, 1, 2, 3]) == [(0, 0, 2), (1, 2, 4), (2, 4, 6), (3, 6, 8)]
    for a_paths, b_paths in ((out, ref), (out, one)):
        assert [p.name for p in a_paths] == [p.name for p in b_paths]
        a = np.stack([np.asarray(Image.open(p), np.float64) for p in a_paths]) / 255.0
        b = np.stack([np.asarray(Image.open(p), np.float64) for p in b_paths]) / 255.0
        assert a.shape == (8, 32, 32, 3)
        err = np.abs(a - b)
        assert err.mean() <= 1e-3 and err.max() <= 1.0 / 255 + 1e-9, (err.mean(), err.max())


# ---------------------------------------------------------------------------
# 3DGS: view-sharded and Gaussian-sharded steps, the loop on a mesh
# ---------------------------------------------------------------------------

def _recovery(style_dim=8):
    """aip_tpu's batched-step scene (tests/test_gs_training.py
    ``_recovery_setup``): 4 cameras on a circle, 150 points, capacity 256,
    here with a style-conditioned field (style_dim 8)."""
    from aip_tpu.gs.cameras import Camera

    rng = np.random.default_rng(0)
    cams = []
    for i in range(4):
        a = i * 2 * np.pi / 4
        R = np.array([[np.cos(a), 0, -np.sin(a)], [0, 1, 0], [np.sin(a), 0, np.cos(a)]])
        cams.append(Camera(colmap_id=i, R=R, T=np.array([0.0, 0.0, 2.5]), FoVx=1.1, FoVy=1.1,
                           image=rng.random((32, 32, 3)).astype(np.float32),
                           image_name=f"c{i}", uid=i))
    kw = dict(capacity=256, max_per_tile=32, raster_chunk=256, style_dim=style_dim,
              log2_hashmap=10, rvq_size=8, rvq_num=2, net_lr_step=(10 ** 6,),
              densify_from_iter=10 ** 6)
    jcfg, tcfg = JT.GSTrainConfig(**kw), TT.GSTrainConfig(**kw)
    pts = (rng.random((150, 3)) * 2 - 1).astype(np.float32)
    cols = rng.random((150, 3)).astype(np.float32)
    jtr = JT.init_trainer(jcfg, jnp.asarray(pts), jnp.asarray(cols), 3.0)
    np_tree = lambda st: {k: None if v is None else np.asarray(v) for k, v in st._asdict().items()}
    ts, tf = from_jax_arrays(np_tree(jtr.gstate), np_tree(jtr.field), "cpu")
    style = (rng.standard_normal((1, 512)) * 0.3).astype(np.float32) if style_dim else None
    return jcfg, tcfg, cams, jtr, TT.make_trainer(ts, tf), style


def _mu(opt_state_j):
    leaves = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(opt_state_j):
        names = [getattr(p, "key", getattr(p, "name", None)) for p in path]
        if "mu" in names:
            leaves[next(n for n in reversed(names) if isinstance(n, str) and n != "mu")] = leaf
    return leaves


def _assert_step_close(tnew, tm, jnew, jm):
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5 * abs(float(jm["loss"]))
    jmu = {**_mu(jnew.opt_g), **_mu(jnew.opt_net)}
    tmu = {**tnew.opt_g.mu, **tnew.opt_net.mu}
    assert set(tmu) == set(jmu)
    for name, ref in jmu.items():
        ref = np.asarray(ref)
        err = np.abs(tmu[name].numpy() - ref).max() / max(np.abs(ref).max(), 1e-30)
        assert err < (1e-3 if name == "hash_tables" else 1e-4), (name, err)
    np.testing.assert_array_equal(tnew.gstate.denom.numpy(), np.asarray(jnew.gstate.denom))


def test_view_and_gaussian_sharded_step_matches_jax():
    """B = 4 views over a (4,) mesh, the colour field's Gaussians over it
    too (aip_tpu's tests/test_gs_training.py:692, shrunk, with a style),
    against aip_tpu's one-device B = 4 step; and the view-sharded step
    alone against the port's unsharded step."""
    jcfg, tcfg, cams, jtr, ttr, style = _recovery()
    jstep = JT.make_train_step(jcfg, 3.0, "photometric", 32, 32, views_per_step=4)
    jnew, jm = jstep(jtr, JT.stack_cameras([JT.camera_to_arrays(c) for c in cams]),
                     None if style is None else jnp.asarray(style), jnp.zeros(3))
    mesh = _cpu_mesh((4,), ("dp",))
    batch = TT.stack_cameras([TT.camera_to_arrays(c, device="cpu") for c in cams])
    sty = None if style is None else _t(style)
    bg = tgs.replicated_scalars(mesh, torch.zeros(3))
    outs = {}
    for name, gshard in (("views", None), ("views+gaussians", (mesh, "dp"))):
        step = TT.make_train_step(tcfg, 3.0, "photometric", 32, 32, views_per_step=4,
                                  view_chunk=4, gaussian_shard=gshard)
        outs[name] = step(tgs.replicate_trainer(mesh, ttr), tgs.shard_view_batch(mesh, batch),
                          sty, bg)
        _assert_step_close(*outs[name], jnew, jm)
        assert outs[name][0].step == 4
    flat = TT.make_train_step(tcfg, 3.0, "photometric", 32, 32, views_per_step=4)(
        ttr, batch, sty, torch.zeros(3))[0]
    for a, b in zip(outs["views"][0].gstate, flat.gstate):
        assert torch.equal(a, b)


def test_gaussian_sharded_single_view_step_matches_jax():
    jcfg, tcfg, cams, jtr, ttr, style = _recovery()
    jnew, jm = JT.make_train_step(jcfg, 3.0, "photometric", 32, 32)(
        jtr, JT.camera_to_arrays(cams[0]), jnp.asarray(style), jnp.zeros(3))
    mesh = _cpu_mesh((8,), ("dp",))
    step = TT.make_train_step(tcfg, 3.0, "photometric", 32, 32, gaussian_shard=(mesh, "dp"))
    tnew, tm = step(tgs.replicate_trainer(mesh, ttr), TT.camera_to_arrays(cams[0], device="cpu"),
                    _t(style), torch.zeros(3))
    _assert_step_close(tnew, tm, jnew, jm)
    with pytest.raises(ValueError, match="do not split"):
        tgs.predict_sh_sharded(_cpu_mesh((3,), ("dp",)), ttr.field, ttr.gstate.xyz)


def test_train_loop_on_mesh_matches_single_device(tmp_path, monkeypatch):
    """The whole loop with ``mesh`` (B = 4 over a (4,) mesh, the colour
    field Gaussian-sharded) against the loop without one (aip_tpu's
    tests/test_gs_training.py:769, shrunk); and its refusals."""
    from aip_tpu_torch.gs.dataset import Scene
    from aip_tpu_torch.models import weights as tw

    monkeypatch.setattr(tw, "DEFAULT_WEIGHTS_DIR", tmp_path / "w")
    from test_torch_port_multiview import _blender_scene

    scene = Scene(_blender_scene(tmp_path / "scene", n_views=4), shuffle=False)
    scene.scene_info.point_cloud.points = scene.scene_info.point_cloud.points[:64]
    scene.scene_info.point_cloud.colors = scene.scene_info.point_cloud.colors[:64]
    g = np.random.default_rng(3)
    Image.fromarray((g.random((32, 32, 3)) * 255).astype(np.uint8)).save(tmp_path / "s.png")
    cfg = TT.GSTrainConfig(iterations=8, freeze_iters=8, capacity=128, max_per_tile=32,
                           raster_chunk=256, style_dim=8, log2_hashmap=10, rvq_size=8,
                           rvq_num=2, densify_from_iter=10 ** 6, mask_prune_iter=10 ** 6,
                           recompact_floor=8, net_lr_step=(10 ** 6,))
    kw = dict(img_size=32, guide_dir=str(tmp_path / "g"), views_per_step=4, seed=3,
              device="cpu")
    ref, _ = TT.train(scene, str(tmp_path / "s.png"), cfg, **kw)
    mesh = _cpu_mesh((4,), ("dp",))
    got, _ = TT.train(scene, str(tmp_path / "s.png"), cfg, mesh=mesh, gaussian_shard=True, **kw)
    for a, b in ((got.gstate.xyz, ref.gstate.xyz), (got.field.hash_tables, ref.field.hash_tables),
                 (got.field.mlp_w1, ref.field.mlp_w1)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-6)
    assert got.step == 8
    for bad, match in ((dict(views_per_step=2, mesh=_cpu_mesh((4,), ("dp",))), "multiple"),
                       (dict(gaussian_shard=True, mesh=_cpu_mesh((3,), ("dp",))), "power-of-two"),
                       (dict(gaussian_shard=True), "requires a mesh")):
        with pytest.raises(ValueError, match=match):
            TT.train(scene, str(tmp_path / "s.png"), cfg,
                     **{**kw, "views_per_step": 1, **bad})


@pytest.mark.parametrize("style", [False, True])
def test_predict_sh_sharded_matches_jax(style):
    from aip_tpu.gs.colorfield import init_colorfield as jinit, predict_sh as jpredict

    rng = np.random.default_rng(1)
    field_j = jinit(jax.random.PRNGKey(0), log2_hashmap=8, style_dim=8 if style else None)
    xyz = (rng.random((32, 3)) * 2 - 1).astype(np.float32)
    sf = rng.random((1, 512)).astype(np.float32) if style else None
    ref = jpredict(field_j, jnp.asarray(xyz), None if sf is None else jnp.asarray(sf))
    g_ref = jax.grad(lambda f: jnp.sum(jpredict(f, jnp.asarray(xyz), None if sf is None
                                                else jnp.asarray(sf)) ** 2))(field_j)
    from aip_tpu_torch.gs.colorfield import ColorFieldParams

    field = ColorFieldParams(**{k: None if v is None else _t(v)
                                for k, v in field_j._asdict().items()})
    leaves = {k: v.requires_grad_() for k, v in field._asdict().items() if v is not None}
    mesh = _cpu_mesh((8,), ("dp",))
    got = tgs.predict_sh_sharded(mesh, field, _t(xyz), None if sf is None else _t(sf))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=1e-5)
    grads = torch.autograd.grad((got ** 2).sum(), list(leaves.values()))
    for (k, _), g in zip(leaves.items(), grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(getattr(g_ref, k)), rtol=1e-4,
                                   atol=1e-4)


# ---------------------------------------------------------------------------
# Gaussian-sharded rendering
# ---------------------------------------------------------------------------

def _splats(n=512):
    rng = np.random.default_rng(0)
    xyz = (rng.random((n, 3)) * 2 - 1).astype(np.float32)
    scales = (rng.random((n, 3)) * 0.05 + 0.02).astype(np.float32)
    q = rng.standard_normal((n, 4)).astype(np.float32)
    rots = q / np.linalg.norm(q, axis=1, keepdims=True)
    ops = (rng.random(n) * 0.9).astype(np.float32)
    cols = rng.random((n, 3)).astype(np.float32)
    return xyz, scales, rots, ops, cols


def _camera(size=128):
    from aip_tpu_torch.gs.cameras import Camera

    a = 0.3
    R = np.array([[np.cos(a), 0, -np.sin(a)], [0, 1, 0], [np.sin(a), 0, np.cos(a)]], np.float32)
    return Camera(colmap_id=0, R=R, T=np.array([0.0, 0.0, 2.5]), FoVx=1.1, FoVy=1.1,
                  image=np.zeros((size, size, 3), np.float32), image_name="c", uid=0)


@pytest.mark.parametrize("dp", [2, 4])
def test_rasterize_sharded_matches_jax_and_the_replicated_render(dp):
    """512 Gaussians at 128^2, macro 2 (kc = N): the port's
    ``rasterize_sharded`` on a (dp,) mesh of CPU devices against aip_tpu's
    replicated ``rasterize_matmul`` (which aip_tpu's slow-tier
    tests/test_parallel_train.py:97 holds its ``rasterize_sharded`` to) and
    the port's."""
    from aip_tpu.gs.rasterizer import RasterSettings as JSettings
    from aip_tpu.gs.rasterizer import rasterize_matmul as jrasterize_matmul
    from aip_tpu_torch.gs.rasterizer import RasterSettings, rasterize_matmul

    arrays = _splats()
    cam = _camera()
    vm, pm = np.asarray(cam.world_view_transform), np.asarray(cam.full_proj_transform)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    tanf = math.tan(0.55)
    kw = dict(image_height=128, image_width=128, macro=2, macro_capacity=512,
              composite_backend="matmul")
    want, jr = jrasterize_matmul(*map(jnp.asarray, arrays), jnp.asarray(vm), jnp.asarray(pm),
                                 jnp.asarray(bg), JSettings(**kw), tanfovx=tanf, tanfovy=tanf)
    tm = _cpu_mesh((dp,), ("dp",))
    got, tr = tgs.rasterize_sharded(tm, *tgs.shard_gaussian_arrays(tm, *map(_t, arrays)), _t(vm),
                                    _t(pm), _t(bg), RasterSettings(**kw), tanfovx=tanf,
                                    tanfovy=tanf)
    rep, rr = rasterize_matmul(*map(_t, arrays), _t(vm), _t(pm), _t(bg), RasterSettings(**kw),
                               tanfovx=tanf, tanfovy=tanf)
    assert got.shape == (128, 128, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)
    np.testing.assert_allclose(got.numpy(), rep.numpy(), atol=2e-4)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tr.numpy(), rr.numpy())


def test_render_entrypoint_sharded_matches_replicated():
    """``render(mesh=...)`` on a state with a colour field (aip_tpu's
    tests/test_parallel_train.py:147): against the port's replicated
    render and aip_tpu's."""
    from aip_tpu.gs import gaussians as JG
    from aip_tpu.gs.colorfield import init_colorfield
    from aip_tpu.gs.rasterizer import RasterSettings as JSettings
    from aip_tpu.gs.render import render as jrender
    from aip_tpu_torch.gs.rasterizer import RasterSettings
    from aip_tpu_torch.gs.render import render

    rng = np.random.default_rng(2)
    pts = (rng.random((128, 3)) * 2 - 1).astype(np.float32)
    cols = rng.random((128, 3)).astype(np.float32)
    js, _ = JG.create_from_pcd(jnp.asarray(pts), jnp.asarray(cols), capacity=128)
    jf = init_colorfield(jax.random.PRNGKey(0), style_dim=0, log2_hashmap=10)
    ts, tf = from_jax_arrays({k: np.asarray(v) for k, v in js._asdict().items()},
                             {k: None if v is None else np.asarray(v)
                              for k, v in jf._asdict().items()}, "cpu")
    cam = _camera(64)
    kw = dict(image_height=64, image_width=64, max_per_tile=32, macro=2, macro_capacity=128,
              composite_backend="matmul")
    want = jrender(cam, js, jf, jnp.zeros(3), mode="inference", settings=JSettings(**kw),
                   renderer="matmul")
    rep = render(cam, ts, tf, torch.zeros(3), mode="inference", settings=RasterSettings(**kw),
                 renderer="matmul")
    got = render(cam, ts, tf, torch.zeros(3), mode="inference", settings=RasterSettings(**kw),
                 mesh=_cpu_mesh((8,), ("dp",)))
    np.testing.assert_allclose(got.render.numpy(), rep.render.numpy(), atol=2e-4)
    np.testing.assert_allclose(got.render.numpy(), np.asarray(want.render), atol=2e-4)
    np.testing.assert_array_equal(got.radii.numpy(), np.asarray(want.radii))
    np.testing.assert_array_equal(got.visibility.numpy(), rep.visibility.numpy())
