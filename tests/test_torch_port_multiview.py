"""The port's multi-view 3DGS step and loop (``views_per_step``,
``view_chunk``, ``stack_cameras``) against aip_tpu's, on the CPU.

Both packages start from one JAX ``init_trainer`` carried across with
``from_jax_arrays`` (the scene, the 200-point cloud and the symmetry
breaking of ``tests/test_torch_port_gs_train.py``'s ``step_setup``).

Tolerances, with their reasons (the one-view step's gates):
* a batched step against JAX: the loss and the L1 term at 1e-5 relative;
  each group's first moment (0.1 g after one Adam step) at 1e-4 of its
  largest entry (1e-3 for the hash table, whose rows sum many
  contributions of both signs), ``xyz_grad_accum`` at 1e-4 of its largest
  entry, ``denom`` equal: the same float32 graph, reduced in another order
  (JAX differentiates the mean loss through a vmap, the port sums
  per-view backward passes);
* the port's chunked step against its one-chunk step at 1e-6 of each
  tensor's largest entry (only the order of the chunk sums differs);
* the batched step's first moments against the mean of B one-view steps'
  at 1e-5 of the largest entry (the same per-view graphs, summed in
  another order).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from aip_tpu.gs import gaussians as JG
from aip_tpu.gs import rvq as JQ
from aip_tpu.gs import train as JT
from aip_tpu.gs.dataset import Scene as JScene
from aip_tpu_torch.gs import rvq as TQ
from aip_tpu_torch.gs import train as TT
from aip_tpu_torch.gs.dataset import Scene as TScene
from aip_tpu_torch.gs.state import from_jax_arrays

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.array(x))


def _blender_scene(root: Path, n_views=3, size=32):
    """The tiny Blender scene of tests/test_gs_training.py."""
    (root / "images").mkdir(parents=True)
    frames = []
    for i in range(n_views):
        angle = i * 2 * np.pi / n_views
        c2w = np.eye(4)
        c2w[0, 3] = 3 * np.sin(angle)
        c2w[2, 3] = 3 * np.cos(angle)
        frames.append({"file_path": f"./images/r_{i}", "transform_matrix": c2w.tolist()})
        img = np.zeros((size, size, 4), np.uint8)
        img[8:24, 8:24, 0] = 200
        img[12:20, 12:20, 1] = 180
        img[..., 3] = 255
        Image.fromarray(img).save(root / "images" / f"r_{i}.png")
    (root / "transforms_train.json").write_text(
        json.dumps({"camera_angle_x": 0.8, "frames": frames}))
    return str(root)


def _cfg(mod, **kw):
    base = dict(iterations=24, freeze_iters=16, capacity=256, max_per_tile=32,
                raster_chunk=256, densify_from_iter=4, densification_interval=8,
                densify_until_iter=20, opacity_reset_interval=1000, mask_prune_iter=4,
                style_dim=256, rvq_size=8, rvq_num=2, net_lr_step=(1000,), log2_hashmap=12)
    base.update(kw)
    return mod.GSTrainConfig(**base)


def _np_tree(state):
    return {k: np.asarray(v) for k, v in state._asdict().items()}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    rng = np.random.default_rng(11)
    root = _blender_scene(tmp_path_factory.mktemp("scene"))
    scene = JScene(root, shuffle=False)
    pcd = scene.point_cloud
    jcfg, tcfg = _cfg(JT), _cfg(TT)
    jtr = JT.init_trainer(jcfg, pcd.points[:200], pcd.colors[:200], scene.cameras_extent)
    gs = jtr.gstate
    jtr = jtr._replace(gstate=gs._replace(
        scaling=gs.scaling + jnp.asarray(rng.normal(0, 0.2, (256, 3)), jnp.float32),
        rotation=jnp.asarray(rng.standard_normal((256, 4)), jnp.float32)))
    ts, tf = from_jax_arrays(_np_tree(jtr.gstate), _np_tree(jtr.field), "cpu")
    ttr = TT.make_trainer(ts, tf)
    act = np.asarray(jtr.gstate.active)
    jrs = JQ.kmeans_init(jax.random.PRNGKey(2), JG.get_scaling(jtr.gstate)[act], 2, 8)
    jrr = JQ.kmeans_init(jax.random.PRNGKey(3), JG.get_rotation(jtr.gstate)[act], 2, 8)
    cams = scene.getTrainCameras()
    guides = [np.clip(c.image * 0.5 + rng.random(c.image.shape) * 0.5, 0, 1).astype(np.float32)
              for c in cams]
    style = (rng.standard_normal((1, 512)) * 0.3).astype(np.float32)
    return dict(scene=scene, jcfg=jcfg, tcfg=tcfg, jtr=jtr, ttr=ttr, cams=cams, guides=guides,
                style=style, rvq=(jrs, jrr))


def _mu(opt_state_j):
    leaves = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(opt_state_j):
        names = [getattr(p, "key", getattr(p, "name", None)) for p in path]
        if "mu" in names:
            leaves[next(n for n in reversed(names) if isinstance(n, str) and n != "mu")] = leaf
    return leaves


def _views(s, phase, b):
    """b views cycling over the scene's three, with ground truth or guides."""
    out = []
    for i in range(b):
        cam = s["cams"][i % 3]
        out.append((cam, cam.image if phase == "photometric" else s["guides"][i % 3]))
    return out


def _trainers(s, rvq):
    jtr, ttr = s["jtr"], s["ttr"]
    if rvq:
        jtr = jtr._replace(rvq_scale=s["rvq"][0], rvq_rot=s["rvq"][1])
        ttr = ttr._replace(rvq_scale=TQ.RVQState(_t(s["rvq"][0].codebooks)),
                           rvq_rot=TQ.RVQState(_t(s["rvq"][1].codebooks)))
    return jtr, ttr


def _port_step(s, phase, b, chunk, rvq, trainer=None):
    cam = s["cams"][0]
    step = TT.make_train_step(s["tcfg"], s["scene"].cameras_extent, phase, cam.image_height,
                              cam.image_width, use_rvq=rvq, views_per_step=b, view_chunk=chunk)
    batch = TT.stack_cameras([TT.camera_to_arrays(c, image=img, device="cpu")
                              for c, img in _views(s, phase, b)])
    trainer = trainer or _trainers(s, rvq)[1]
    return step(trainer, batch, _t(s["style"]), torch.zeros(3))


@pytest.mark.parametrize("b,chunk,phase,rvq", [(2, None, "photometric", False),
                                               (2, 1, "style", False),
                                               (4, None, "photometric", True),
                                               (4, 2, "photometric", False)])
def test_batched_step_matches_jax(setup, b, chunk, phase, rvq):
    s = setup
    jtr, _ = _trainers(s, rvq)
    cam = s["cams"][0]
    jstep = JT.make_train_step(s["jcfg"], s["scene"].cameras_extent, phase, cam.image_height,
                               cam.image_width, use_rvq=rvq, views_per_step=b, view_chunk=chunk)
    jbatch = JT.stack_cameras([JT.camera_to_arrays(c, image=img) for c, img in _views(s, phase, b)])
    jnew, jm = jstep(jtr, jbatch, jnp.asarray(s["style"]), jnp.zeros(3))
    tnew, tm = _port_step(s, phase, b, chunk, rvq)
    for k in ("loss", "l1"):
        assert abs(float(tm[k]) - float(jm[k])) <= 1e-5 * abs(float(jm[k])), k
    jmu = {**_mu(jnew.opt_g), **_mu(jnew.opt_net)}
    tmu = {**tnew.opt_g.mu, **tnew.opt_net.mu}
    assert set(tmu) == set(jmu)
    for name, ref in jmu.items():
        ref = np.asarray(ref)
        assert np.abs(ref).max() > 0, name
        err = np.abs(tmu[name].numpy() - ref).max() / np.abs(ref).max()
        assert err < (1e-3 if name == "hash_tables" else 1e-4), (name, err)
    ref = np.asarray(jnew.gstate.xyz_grad_accum)
    np.testing.assert_allclose(tnew.gstate.xyz_grad_accum.numpy(), ref,
                               atol=1e-4 * float(np.abs(ref).max()))
    np.testing.assert_array_equal(tnew.gstate.denom.numpy(), np.asarray(jnew.gstate.denom))
    assert int(tnew.opt_g.count) == int(tnew.opt_net.count) == 1 and tnew.step == b


@pytest.mark.parametrize("chunk", [1, 2])
def test_chunked_step_equals_one_chunk(setup, chunk):
    whole, mw = _port_step(setup, "photometric", 4, 4, False)
    part, mp = _port_step(setup, "photometric", 4, chunk, False)
    assert abs(float(mp["loss"]) - float(mw["loss"])) <= 1e-6 * abs(float(mw["loss"]))
    pairs = [*zip(part.opt_g.mu.values(), whole.opt_g.mu.values()),
             *zip(part.opt_net.mu.values(), whole.opt_net.mu.values()),
             (part.gstate.xyz, whole.gstate.xyz),
             (part.gstate.xyz_grad_accum, whole.gstate.xyz_grad_accum)]
    for a, b in pairs:
        assert (a - b).abs().max() <= 1e-6 * max(b.abs().max().item(), 1e-30)


def test_batched_step_is_the_mean_of_one_view_steps(setup):
    """One step of B = 3 views: its first moments are the mean of three
    one-view steps' from the same state, its statistics their sum."""
    s = setup
    tnew, tm = _port_step(s, "photometric", 3, None, False)
    cam = s["cams"][0]
    one = TT.make_train_step(s["tcfg"], s["scene"].cameras_extent, "photometric",
                             cam.image_height, cam.image_width)
    mus, accum, losses = [], 0, []
    for c, img in _views(s, "photometric", 3):
        t1, m1 = one(s["ttr"], TT.camera_to_arrays(c, image=img, device="cpu"),
                     _t(s["style"]), torch.zeros(3))
        mus.append({**t1.opt_g.mu, **t1.opt_net.mu})
        accum = accum + t1.gstate.xyz_grad_accum
        losses.append(float(m1["loss"]))
    assert abs(float(tm["loss"]) - np.mean(losses)) <= 1e-6 * abs(np.mean(losses))
    for name, got in {**tnew.opt_g.mu, **tnew.opt_net.mu}.items():
        ref = sum(m[name] for m in mus) / 3
        assert (got - ref).abs().max() <= 1e-5 * ref.abs().max(), name
    assert (tnew.gstate.xyz_grad_accum - accum).abs().max() <= 1e-5 * accum.abs().max()


def test_stack_cameras_matches_jax_and_refuses_mixed_sizes(setup):
    s = setup
    pairs = _views(s, "photometric", 3)
    j = JT.stack_cameras([JT.camera_to_arrays(c, image=img) for c, img in pairs])
    t = TT.stack_cameras([TT.camera_to_arrays(c, image=img, device="cpu") for c, img in pairs])
    for name in ("world_view", "full_proj", "campos", "image", "tanfovx", "tanfovy"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)))
    assert (t.height, t.width) == (j.height, j.width)
    small = TT.camera_to_arrays(pairs[0][0], image=np.zeros((16, 16, 3), np.float32),
                                device="cpu")._replace(height=16, width=16)
    with pytest.raises(ValueError, match="one resolution"):
        TT.stack_cameras([TT.camera_to_arrays(pairs[0][0], device="cpu"), small])


# ---------------------------------------------------------------------------
# The loop: window-domain events, refusals, resume with another B
# ---------------------------------------------------------------------------

def _jax_window_events(cfg, b):
    """The events aip_tpu's ``train`` fires over its windows (its guards,
    copied): steps per phase, densifications, opacity resets, mask prunes
    and the QAT start."""
    rvq_start = min(cfg.rvq_iter, cfg.iterations - max(1, cfg.iterations // 30))
    ev = {}

    def add(k):
        ev[k] = ev.get(k, 0) + 1

    for it in range(b, cfg.iterations + 1, b):
        prev = it - b
        if prev < rvq_start + 1 <= it:
            add("rvq_qat_start")
        add("photometric_steps" if prev + 1 < cfg.freeze_iters else "style_steps")
        if it < cfg.densify_until_iter:
            if it > cfg.densify_from_iter and it // cfg.densification_interval > \
                    prev // cfg.densification_interval:
                add("densify_events")
            if it // cfg.opacity_reset_interval > prev // cfg.opacity_reset_interval:
                add("opacity_reset")
        elif it // cfg.mask_prune_iter > prev // cfg.mask_prune_iter:
            add("mask_prune_events")
    return ev


@pytest.fixture
def loop_scene(tmp_path, monkeypatch):
    from aip_tpu_torch.models import weights as tweights

    monkeypatch.setattr(tweights, "DEFAULT_WEIGHTS_DIR", tmp_path / "w")
    scene = TScene(_blender_scene(tmp_path / "scene"), shuffle=False)
    scene.scene_info.point_cloud.points = scene.scene_info.point_cloud.points[:150]
    scene.scene_info.point_cloud.colors = scene.scene_info.point_cloud.colors[:150]
    rng = np.random.default_rng(5)
    Image.fromarray((rng.random((32, 32, 3)) * 255).astype(np.uint8)).save(tmp_path / "s.png")
    return scene, str(tmp_path / "s.png")


WINDOW_KEYS = ("photometric_steps", "style_steps", "densify_events", "opacity_reset",
               "mask_prune_events", "rvq_qat_start")


def test_train_views_per_step_fires_events_in_the_window_domain(tmp_path, loop_scene):
    scene, style = loop_scene
    cfg = _cfg(TT, iterations=16, freeze_iters=9, densify_from_iter=2, densification_interval=3,
               densify_until_iter=12, opacity_reset_interval=5, mask_prune_iter=3,
               densify_grad_threshold=1e-7, percent_dense=0.05, recompact_floor=64,
               capacity=1024, style_dim=8)
    traces = {}
    for b in (1, 2, 4):
        trace = {}
        trainer, _ = TT.train(scene, style, cfg, img_size=32, guide_dir=str(tmp_path / "g"),
                              device="cpu", views_per_step=b, trace=trace)
        traces[b] = trace
        ev = {k: v for k, v in trace["events"].items() if k in WINDOW_KEYS}
        assert ev == _jax_window_events(cfg, b), (b, ev)
        assert trainer.step == 16 and int(trainer.opt_g.count) == 16 // b
        assert len(trace["steps"]) == 16 // b
        assert [it for it, *_ in trace["steps"]] == list(range(b, 17, b))
        assert trainer.rvq_scale is not None
        assert np.isfinite([loss for _, _, loss, _ in trace["steps"]]).all()
    # At B = 1 the window guards are the per-iteration ones.
    assert traces[1]["events"]["photometric_steps"] == 8
    # The phase is the window's first iteration's: at B = 4 the window
    # (8, 12] starts at iteration 9, freeze_iters, and is a style step.
    assert traces[4]["events"]["photometric_steps"] == 2


def test_train_views_per_step_refusals(tmp_path, loop_scene):
    scene, style = loop_scene
    kw = dict(img_size=32, guide_dir=str(tmp_path / "g"), device="cpu")
    with pytest.raises(ValueError, match="multiples of views_per_step"):
        TT.train(scene, style, _cfg(TT, iterations=23), views_per_step=2, **kw)
    cams = scene.getTrainCameras()
    cams[1].image = cams[1].image[:16, :16]
    cams[1].image_height = cams[1].image_width = 16
    with pytest.raises(ValueError, match="one resolution"):
        TT.train(scene, style, _cfg(TT, iterations=4), views_per_step=2, **kw)


def test_resume_with_another_views_per_step_rebases_the_counts(tmp_path, loop_scene):
    """A run of 8 iterations at B = 1 checkpointed at 4, resumed at B = 2:
    both Adam counts restart from 4 // 2 and end at 2 + 2, and the
    resumed steps read the schedules at iterations 4 and 6 (count times B,
    the iterations done before each step)."""
    scene, style = loop_scene
    cfg = _cfg(TT, iterations=8, freeze_iters=6, densify_from_iter=100, style_dim=8,
               recompact_floor=0)
    kw = dict(img_size=32, guide_dir=str(tmp_path / "g"), device="cpu", seed=3)
    TT.train(scene, style, cfg, checkpoint_iterations=(4,), checkpoint_dir=str(tmp_path / "ck"),
             **kw)
    seen = []
    orig = TT.net_lr
    TT.net_lr = lambda c, count: seen.append(count) or orig(c, count)
    try:
        resumed, _ = TT.train(scene, style, cfg, views_per_step=2,
                              start_checkpoint=str(tmp_path / "ck" / "chkpnt4"), **kw)
    finally:
        TT.net_lr = orig
    assert resumed.step == 8
    assert int(resumed.opt_g.count) == int(resumed.opt_net.count) == 4
    assert seen == [4, 6]
