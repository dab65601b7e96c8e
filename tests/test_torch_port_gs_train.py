"""The port's training path vs aip_tpu's, on the CPU: one train step in
each mode, a short loss curve, the learning-rate schedules and Adam,
checkpoint resume, the schedule's events, and the training entry points
end to end.

Both packages start from one JAX ``init_trainer``, carried across with
``from_jax_arrays``; images are drawn with numpy from a seed.

Tolerances, with their reasons:
* one train step: the loss at 1e-5 relative and each parameter group's
  gradient (Adam's first moment after one step is exactly 0.1 g in both)
  at 1e-4 of its largest entry (1e-3 for the hash table, whose rows sum
  many contributions of both signs): the same float32 graph, reduced in
  another order;
* a 12-step loss curve at 1e-3 relative: Adam's early steps are about
  lr * sign(g), so float noise on near-zero gradients moves single
  parameters by 2 lr and the curves drift apart slowly;
* the schedules at 1e-6 and Adam over 70 updates at 1e-5 (float32);
* a resumed run against an uninterrupted one, exactly.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from aip_tpu.gs import compress as JC
from aip_tpu.gs import gaussians as JG
from aip_tpu.gs import rvq as JQ
from aip_tpu.gs import train as JT
from aip_tpu.gs.dataset import Scene as JScene
from aip_tpu_torch.gs import compress as TC
from aip_tpu_torch.gs import rvq as TQ
from aip_tpu_torch.gs import train as TT
from aip_tpu_torch.gs.checkpoint import load_checkpoint, save_checkpoint
from aip_tpu_torch.gs.dataset import Scene as TScene
from aip_tpu_torch.gs.state import from_jax_arrays

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np_tree(state):
    return {k: np.asarray(v) for k, v in state._asdict().items()}


# ---------------------------------------------------------------------------
# Train steps and a short loop
# ---------------------------------------------------------------------------

def _blender_scene(root: Path, rng, n_views=3, size=32):
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


@pytest.fixture(scope="module")
def step_setup(tmp_path_factory):
    """Both packages' trainers from one JAX init (200 points of the seeded
    Blender cloud), the three views with ground truth and stand-in guides,
    a style feature and RVQ codebooks."""
    rng = np.random.default_rng(11)
    root = _blender_scene(tmp_path_factory.mktemp("scene"), rng)
    scene = JScene(root, shuffle=False)
    pcd = scene.point_cloud
    jcfg, tcfg = _cfg(JT), _cfg(TT)
    jtr = JT.init_trainer(jcfg, pcd.points[:200], pcd.colors[:200], scene.cameras_extent)
    # Break the initial symmetry (identity rotations, isotropic scales) so
    # every parameter group has a gradient.
    gs = jtr.gstate
    jtr = jtr._replace(gstate=gs._replace(
        scaling=gs.scaling + jnp.asarray(rng.normal(0, 0.2, (256, 3)), jnp.float32),
        rotation=jnp.asarray(rng.standard_normal((256, 4)), jnp.float32)))
    ts, tf = from_jax_arrays(_np_tree(jtr.gstate), _np_tree(jtr.field), "cpu")
    ttr = TT.make_trainer(ts, tf)
    key = jax.random.PRNGKey(2)
    act = np.asarray(jtr.gstate.active)
    jrs = JQ.kmeans_init(key, JG.get_scaling(jtr.gstate)[act], 2, 8)
    jrr = JQ.kmeans_init(jax.random.PRNGKey(3), JG.get_rotation(jtr.gstate)[act], 2, 8)
    cams = scene.getTrainCameras()
    guides = [np.clip(c.image * 0.5 + rng.random(c.image.shape) * 0.5, 0, 1).astype(np.float32)
              for c in cams]
    style = (rng.standard_normal((1, 512)) * 0.3).astype(np.float32)
    return dict(scene=scene, jcfg=jcfg, tcfg=tcfg, jtr=jtr, ttr=ttr, cams=cams, guides=guides,
                style=style, rvq=(jrs, jrr))


def _mu(opt_state_j):
    """The first moments of an optax state (multi_transform or plain adam)."""
    leaves = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(opt_state_j):
        names = [getattr(p, "key", getattr(p, "name", None)) for p in path]
        if "mu" in names:
            leaves[next(n for n in reversed(names) if isinstance(n, str) and n != "mu")] = leaf
    return leaves


@pytest.mark.parametrize("phase,rvq", [("photometric", False), ("style", False),
                                       ("photometric", True)])
def test_train_step_matches_jax(step_setup, phase, rvq):
    s = step_setup
    cam, guide = s["cams"][0], s["guides"][0]
    img = cam.image if phase == "photometric" else guide
    jtr, ttr = s["jtr"], s["ttr"]
    if rvq:
        jtr = jtr._replace(rvq_scale=s["rvq"][0], rvq_rot=s["rvq"][1])
        ttr = ttr._replace(rvq_scale=TQ.RVQState(_t(s["rvq"][0].codebooks)),
                           rvq_rot=TQ.RVQState(_t(s["rvq"][1].codebooks)))
    ext = s["scene"].cameras_extent
    h, w = cam.image_height, cam.image_width
    jstep = JT.make_train_step(s["jcfg"], ext, phase, h, w, use_rvq=rvq)
    tstep = TT.make_train_step(s["tcfg"], ext, phase, h, w, use_rvq=rvq)
    jnew, jm = jstep(jtr, JT.camera_to_arrays(cam, image=img), jnp.asarray(s["style"]),
                     jnp.zeros(3))
    tnew, tm = tstep(ttr, TT.camera_to_arrays(cam, image=img, device="cpu"), _t(s["style"]),
                     torch.zeros(3))
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5 * abs(float(jm["loss"]))
    assert abs(float(tm["l1"]) - float(jm["l1"])) <= 1e-5 * abs(float(jm["l1"]))
    jmu = {**_mu(jnew.opt_g), **_mu(jnew.opt_net)}
    tmu = {**tnew.opt_g.mu, **tnew.opt_net.mu}
    assert set(tmu) == set(jmu)
    for name, b in jmu.items():
        b = np.asarray(b)
        assert np.abs(b).max() > 0, name
        err = np.abs(tmu[name].numpy() - b).max() / np.abs(b).max()
        # A table row sums many points' contributions of both signs
        # (cancellation), scattered in another order.
        assert err < (1e-3 if name == "hash_tables" else 1e-4), (name, err)
    # The densification statistics (dL/d mean2d through the offset).
    np.testing.assert_allclose(tnew.gstate.xyz_grad_accum.numpy(),
                               np.asarray(jnew.gstate.xyz_grad_accum),
                               atol=1e-4 * float(np.abs(jnew.gstate.xyz_grad_accum).max()))
    np.testing.assert_array_equal(tnew.gstate.denom.numpy(), np.asarray(jnew.gstate.denom))
    assert int(tnew.opt_g.count) == 1 and tnew.step == 1


def test_short_loss_curve_matches_jax(step_setup):
    """Eight photometric steps over the three views, then four style steps,
    in both packages from the same trainer."""
    s = step_setup
    ext = s["scene"].cameras_extent
    h, w = s["cams"][0].image_height, s["cams"][0].image_width
    jtr, ttr = s["jtr"], s["ttr"]
    losses = []
    for phase, n in (("photometric", 8), ("style", 4)):
        jstep = JT.make_train_step(s["jcfg"], ext, phase, h, w)
        tstep = TT.make_train_step(s["tcfg"], ext, phase, h, w)
        for i in range(n):
            cam = s["cams"][i % 3]
            img = cam.image if phase == "photometric" else s["guides"][i % 3]
            jtr, jm = jstep(jtr, JT.camera_to_arrays(cam, image=img), jnp.asarray(s["style"]),
                            jnp.zeros(3))
            ttr, tm = tstep(ttr, TT.camera_to_arrays(cam, image=img, device="cpu"),
                            _t(s["style"]), torch.zeros(3))
            losses.append((float(jm["loss"]), float(tm["loss"])))
    ref, out = np.array(losses).T
    np.testing.assert_allclose(out, ref, rtol=1e-3)
    assert ref[5:8].mean() < ref[:3].mean()     # the photometric loss falls


def test_lr_schedules_match_jax():
    cfg_j, cfg_t = _cfg(JT, net_lr_step=(30, 60)), _cfg(TT, net_lr_step=(30, 60))
    for count in (0, 1, 50, 99, 100, 2999, 30000, 40000):
        ref = float(JT.expon_lr(count, 1.6e-4, 1.6e-6, 0.01, 30000))
        assert abs(float(TT.expon_lr(count, 1.6e-4, 1.6e-6, 0.01, 30000)) - ref) <= 1e-6 * ref
    opt = JT.make_net_optimizer(cfg_j)
    params = {"w": jnp.ones(3)}
    st = opt.init(params)
    state = TT.adam_init({"w": torch.ones(3)})
    p_t = {"w": torch.ones(3)}
    for count in range(70):
        g = np.full(3, (-1.0) ** count * (count + 1) * 1e-3, np.float32)
        upd, st = opt.update({"w": jnp.asarray(g)}, st, params)
        params = jax.tree.map(lambda a, b: a + b, params, upd)
        p_t, state = TT.adam_update(p_t, {"w": _t(g)}, state,
                                    {"w": TT.net_lr(cfg_t, int(state.count))})
    np.testing.assert_allclose(p_t["w"].numpy(), np.asarray(params["w"]), rtol=1e-5)


# ---------------------------------------------------------------------------
# Checkpoints and the entry points
# ---------------------------------------------------------------------------

@pytest.fixture
def weights_dir(tmp_path, monkeypatch):
    from aip_tpu_torch.models import weights as tweights

    monkeypatch.setattr(tweights, "DEFAULT_WEIGHTS_DIR", tmp_path / "w")
    return tmp_path / "w"


def _style_png(path, rng):
    Image.fromarray((rng.random((32, 32, 3)) * 255).astype(np.uint8)).save(path)
    return str(path)


def _trace_states(trainer):
    return [t.clone() for t in trainer.gstate] + [trainer.field.hash_tables.clone()]


def test_checkpoint_resume_continues_exactly(tmp_path, rng, weights_dir):
    """A run of 12 iterations (a densification event at 8, the style phase
    from 10) against one that stops at 6, saves and resumes: every tensor
    of the final trainer is identical."""
    scene = TScene(_blender_scene(tmp_path / "scene", rng), shuffle=False)
    scene.scene_info.point_cloud.points = scene.scene_info.point_cloud.points[:150]
    scene.scene_info.point_cloud.colors = scene.scene_info.point_cloud.colors[:150]
    style = _style_png(tmp_path / "s.png", rng)
    cfg = _cfg(TT, iterations=12, freeze_iters=10, densify_from_iter=4, densification_interval=4,
               densify_until_iter=10, style_dim=8, rvq_iter=9, recompact_floor=0)
    full, _ = TT.train(scene, style, cfg, img_size=32, guide_dir=str(tmp_path / "g"),
                       seed=3, device="cpu")
    TT.train(scene, style, cfg, img_size=32,
             guide_dir=str(tmp_path / "g"), seed=3, device="cpu",
             checkpoint_iterations=(6,), checkpoint_dir=str(tmp_path / "ck"))
    resumed, _ = TT.train(scene, style, cfg, img_size=32, guide_dir=str(tmp_path / "g"),
                          seed=3, device="cpu", start_checkpoint=str(tmp_path / "ck" / "chkpnt6"))
    assert resumed.step == full.step == 12
    for a, b in zip(_trace_states(resumed), _trace_states(full)):
        assert torch.equal(a, b)
    for a, b in zip(resumed.opt_net.mu.values(), full.opt_net.mu.values()):
        assert torch.equal(a, b)
    assert torch.equal(resumed.rvq_scale.codebooks, full.rvq_scale.codebooks)
    # A checkpoint restores into a trainer of the same types.
    back = load_checkpoint(save_checkpoint(tmp_path / "again", full), full)
    assert back.step == 12 and int(back.opt_g.count) == int(full.opt_g.count)


def test_train_fires_every_event_and_raises_for_later_slices(tmp_path, rng, weights_dir):
    scene = TScene(_blender_scene(tmp_path / "scene", rng), shuffle=False)
    scene.scene_info.point_cloud.points = scene.scene_info.point_cloud.points[:150]
    scene.scene_info.point_cloud.colors = scene.scene_info.point_cloud.colors[:150]
    style = _style_png(tmp_path / "s.png", rng)
    cfg = _cfg(TT, iterations=16, freeze_iters=10, densify_from_iter=2, densification_interval=4,
               densify_until_iter=12, opacity_reset_interval=8, mask_prune_iter=2,
               densify_grad_threshold=1e-7, percent_dense=0.05, recompact_floor=64,
               capacity=1024, style_dim=8)
    trace = {}
    trainer, style_f = TT.train(scene, style, cfg, img_size=32, guide_dir=str(tmp_path / "g"),
                                device="cpu", trace=trace)
    ev = trace["events"]
    for name in ("photometric_steps", "style_steps", "cloned", "split", "densify_events",
                 "opacity_reset", "recompact", "rvq_qat_start", "mask_prune_events"):
        assert ev.get(name, 0) > 0, (name, ev)
    assert ev["photometric_steps"] == 9 and ev["style_steps"] == 7
    assert len(trace["steps"]) == 16 and trainer.rvq_scale.codebooks.shape == (2, 8, 3)
    assert style_f.shape == (1, 512)
    for kw in ({"views_per_step": 2}, {"gaussian_shard": True}, {"network_gui": object()}):
        with pytest.raises(NotImplementedError, match="slice"):
            TT.train(scene, style, cfg, device="cpu", **kw)


def test_run_3dgs_training_and_cli_end_to_end(tmp_path, rng, weights_dir):
    """``run_3dgs_training`` writes a model that both packages load, with
    the selection record; the CLI trains and renders."""
    from aip_tpu_torch.cli import run_3dgs as cli
    from aip_tpu_torch.gs.pipeline import run_3dgs_training

    src = _blender_scene(tmp_path / "scene", rng, n_views=2)
    style = _style_png(tmp_path / "s.png", rng)
    out = run_3dgs_training(src, style, model_path=str(tmp_path / "m"), iterations=6,
                            freeze_iters=4, capacity=512, log2_hashmap=10, img_size=32,
                            progress_every=0, max_per_tile=32, device="cpu")
    args = json.loads((Path(out) / "cfg_args.json").read_text())
    assert args["selection"]["max_per_tile"] == 32 and args["iterations"] == 6
    assert (Path(out) / "storage").read_text().startswith("Storage")
    js, _jf, _, _ = JC.load_npz(Path(out) / "model.npz")
    ts, _tf, _, _ = TC.load_npz(Path(out) / "model.npz", device="cpu")
    assert js.xyz.shape[0] == ts.xyz.shape[0] > 0
    gif = cli.main(["--content", src, "--style", style, "--output", str(tmp_path / "cli"),
                    "--iterations", "4", "--freeze_iters", "2", "--capacity", "512",
                    "--log2_hashmap", "10", "--img_size", "32", "--device", "cpu"])
    assert Path(gif).is_file() and (tmp_path / "cli" / "model.npz").is_file()
    with pytest.raises(NotImplementedError, match="slice 6"):
        run_3dgs_training(src, style, model_path=str(tmp_path / "x"), mesh_dp=2, device="cpu")


def test_settings_and_view_bytes_match_jax():
    """make_settings_from_dims and _per_view_bytes (the JAX package's
    view-chunk budget) for flat and hierarchical sizes."""
    for h, w in ((32, 48), (256, 256), (800, 800)):
        for kw in ({}, {"max_per_tile": 192, "macro_capacity": 2048}):
            jcfg, tcfg = JT.GSTrainConfig(**kw), TT.GSTrainConfig(**kw)
            js, ts = JT.make_settings_from_dims(h, w, jcfg), TT.make_settings_from_dims(h, w, tcfg)
            assert ts._asdict() == js._asdict()
            assert TT._per_view_bytes(h, w, tcfg, ts) == JT._per_view_bytes(h, w, jcfg, js)


def test_config_copy_matches_jax(tmp_path):
    """The port's copy of config.py builds the same argument groups and
    merges a saved cfg_args the same way."""
    import argparse

    from aip_tpu import config as jcfg
    from aip_tpu_torch import config as tcfg

    argv = ["--source_path", "scene", "--iterations", "77", "--model_path", str(tmp_path)]
    out = []
    for mod in (jcfg, tcfg):
        parser = argparse.ArgumentParser()
        groups = [mod.ModelParams(), mod.PipelineParams(), mod.OptimizationParams()]
        for g, name in zip(groups, ("model", "pipeline", "opt")):
            g.add_to_parser(parser, name)
        args = parser.parse_args(argv)
        mod.save_cfg_args(tmp_path, args)
        merged = mod.get_combined_args(parser, ["--model_path", str(tmp_path)])
        out.append((vars(args), [g.extract(args).to_dict() for g in groups], vars(merged)))
    assert out[0] == out[1]
