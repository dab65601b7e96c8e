"""The trainers of slice 7 (AdaIN decoder training, magenta distillation,
the data loader, both CLIs): aip_tpu_torch against aip_tpu on the CPU, on
inputs drawn with numpy from a seed, weights carried across with
``from_jax_params`` and ``save_magenta_npz``.

Tolerances:
- losses: 1e-5 relative (both read 2e-7 apart at 2 x 64^2);
- the decoder's gradient of the whole loss: 1e-3 of its largest entry. Its
  max pools' near-ties move a few entries: both packages sit 5e-5 to 1e-4
  of the largest entry from a float64 run of the port, and from each
  other; the test prints the port's float64 distance beside the gate;
- the gradient of the relu1_1 style term, which reaches no pool: 1e-5 of
  the largest entry plus 4 times the port's own distance from float64
  (the term's conditioning depends on the weights; see its test);
- Adam on the same gradients: 1e-6 relative to the parameters' scale; the
  learning rate at each step equal to optax's schedule to 1e-7 relative;
- one step from the same state, the parameters: Adam moves an entry by
  about lr whatever its gradient's size, so an entry whose gradient is
  within rounding of 0 may step the other way: each entry within 2 lr,
  the mean within 1e-2 lr;
- the data stream: exactly equal.
"""

import copy
import functools
import json

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp
import optax

from aip_tpu.data import images as jimages
from aip_tpu.models import decoder as jdec
from aip_tpu.models import magenta as jmag
from aip_tpu.models import magenta_train as jmt
from aip_tpu.models import vgg as jvgg
from aip_tpu.models import weights as jweights
from aip_tpu.ops.adain import adain as j_adain, style_loss_terms as j_style_loss
from aip_tpu.parallel import train as jtrain
from aip_tpu.pipelines import adain_infer as jinfer
from aip_tpu_torch.cli import train_adain as tcli_adain
from aip_tpu_torch.cli import train_magenta as tcli_magenta
from aip_tpu_torch.data import images as timages
from aip_tpu_torch.models import decoder as tdec
from aip_tpu_torch.models import magenta as tmag
from aip_tpu_torch.models import magenta_train as tmt
from aip_tpu_torch.models import vgg as tvgg
from aip_tpu_torch.models import weights as tweights
from aip_tpu_torch.ops.adain import adain as t_adain, style_loss_terms as t_style_loss
from aip_tpu_torch.parallel import train as ttrain

torch.set_num_threads(4)

LOSS_TOL = 1e-5
GRAD_TOL = 1e-3
NO_POOL_GRAD_TOL = 1e-5
LR = 1e-4


@pytest.fixture(scope="module")
def nets():
    """A seeded VGG and decoder as HWIO trees of JAX arrays, and the port's
    copies (drawn by the port: the JAX package's own init takes seconds op
    by op)."""
    vt = tvgg.init_vgg_params(0, device="cpu")
    dt = tdec.init_decoder_params(1, device="cpu")
    vj, dj = (jax.tree.map(jnp.asarray, tweights.hwio_params(m)) for m in (vt, dt))
    return vj, dj, vt, dt


@pytest.fixture(scope="module")
def batch():
    g = np.random.default_rng(0)
    return (g.random((2, 64, 64, 3)).astype(np.float32),
            g.random((2, 64, 64, 3)).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.array(a))


def _oihw_grads(tree):
    """JAX HWIO decoder gradients as numpy arrays in the port's order."""
    out = []
    for p in tree:
        out += [np.transpose(np.asarray(p["w"]), (3, 2, 0, 1)), np.asarray(p["b"])]
    return out


def _rel(a, b, scale):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / scale)


def test_adain_train_loss_and_gradients_match_jax(nets, batch):
    vj, dj, vt, dt = nets
    c, s = batch
    (loss_j, (lc_j, ls_j)), g_j = jax.jit(jax.value_and_grad(
        jtrain.adain_train_loss, has_aux=True))(dj, vj, jnp.asarray(c), jnp.asarray(s))
    loss, (lc, ls) = ttrain.adain_train_loss(dt, vt, _t(c), _t(s))
    grads = torch.autograd.grad(loss, list(dt.parameters()))
    for a, b in ((loss, loss_j), (lc, lc_j), (ls, ls_j)):
        assert abs(a.item() - float(b)) <= LOSS_TOL * abs(float(b))
    d64, v64 = copy.deepcopy(dt).double(), copy.deepcopy(vt).double()
    loss64, _ = ttrain.adain_train_loss(d64, v64, _t(c).double(), _t(s).double(),
                                        compute_dtype=torch.float64)
    g64 = torch.autograd.grad(loss64, list(d64.parameters()))
    for i, (g, gj, r) in enumerate(zip(grads, _oihw_grads(g_j), g64)):
        scale = r.abs().max().item()
        err, floor = _rel(g.numpy(), gj, scale), _rel(g.numpy(), r.numpy(), scale)
        print(f"decoder grad {i}: port-jax {err:.2e}, port-float64 {floor:.2e}")
        assert err <= GRAD_TOL, (i, err, floor)


def _port_relu1_1_term(vgg, dec, c, s, dtype=torch.float32):
    sf = tvgg.vgg_encode_with_intermediate(vgg, s.to(dtype), ("relu1_1", "relu4_1"), dtype)
    cf = tvgg.vgg_encode(vgg, c.to(dtype), "relu4_1", dtype)
    g_t = tdec.decoder_apply(dec, t_adain(cf, sf["relu4_1"]), dtype)
    return t_style_loss(tvgg.vgg_encode(vgg, g_t, "relu1_1", dtype), sf["relu1_1"])


@pytest.mark.parametrize("seeds", [(0, 1), (3, 4)])
def test_gradient_of_a_term_without_pools_matches_jax(batch, seeds):
    """The relu1_1 style term: g_t's first two convs and no max pool. Its
    fp32 rounding depends on the weights (a near-dead relu1_1 channel's std
    is ill-conditioned): the port's fallback weights (seeds 0, 1) sit 3e-4
    to 1e-3 of the largest entry from float64, seeds 3, 4 5e-7. Gate: 1e-5
    plus 4 times the port's own distance from float64."""
    vt = tvgg.init_vgg_params(seeds[0], device="cpu")
    dt = tdec.init_decoder_params(seeds[1], device="cpu")
    vj, dj = (jax.tree.map(jnp.asarray, tweights.hwio_params(m)) for m in (vt, dt))
    c, s = batch

    def jterm(d, c, s):
        sf = jvgg.vgg_encode_with_intermediate(vj, s, ("relu1_1", "relu4_1"))
        cf = jvgg.vgg_encode(vj, c, "relu4_1", jnp.float32)
        g_t = jdec.decoder_apply(d, j_adain(cf, sf["relu4_1"]), jnp.float32)
        return j_style_loss(jvgg.vgg_encode(vj, g_t, "relu1_1", jnp.float32), sf["relu1_1"])

    grads = torch.autograd.grad(_port_relu1_1_term(vt, dt, _t(c), _t(s)), list(dt.parameters()))
    d64, v64 = copy.deepcopy(dt).double(), copy.deepcopy(vt).double()
    g64 = torch.autograd.grad(_port_relu1_1_term(v64, d64, _t(c), _t(s), torch.float64),
                              list(d64.parameters()))
    g_j = jax.jit(jax.grad(jterm))(dj, jnp.asarray(c), jnp.asarray(s))
    for i, (g, gj, r) in enumerate(zip(grads, _oihw_grads(g_j), g64)):
        scale = r.abs().max().item()
        err, floor = _rel(g.numpy(), gj, scale), _rel(g.numpy(), r.numpy(), scale)
        print(f"relu1_1 term grad {i}: port-jax {err:.2e}, port-float64 {floor:.2e}")
        assert err <= NO_POOL_GRAD_TOL + 4 * floor, (i, err, floor)


def test_optimizer_matches_optax_over_three_steps():
    """The written-out Adam against ``aip_tpu``'s ``make_optimizer`` on the
    same gradients, and its learning rate against optax's schedule."""
    g = np.random.default_rng(1)
    params = {"w": g.standard_normal((4, 5)).astype(np.float32),
              "b": g.standard_normal(5).astype(np.float32)}
    lr, decay = 1e-3, 0.2  # a decay large enough to move the rate
    jopt = jtrain.make_optimizer(lr, decay)
    probe = optax.inject_hyperparams(optax.adam)(
        learning_rate=lambda count: lr / (1.0 + decay * count))
    topt = ttrain.make_optimizer(lr, decay)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: _t(v) for k, v in params.items()}
    jstate, pstate, tstate = jopt.init(jp), probe.init(jp), topt.init(tp)
    for step in range(3):
        grads = {k: g.standard_normal(v.shape).astype(np.float32) * 10.0 ** -step
                 for k, v in params.items()}
        lr_t = topt.schedule(tstate.count).item()
        upd, jstate = jopt.update({k: jnp.asarray(v) for k, v in grads.items()}, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        _, pstate = probe.update({k: jnp.asarray(v) for k, v in grads.items()}, pstate, jp)
        lr_j = float(pstate.hyperparams["learning_rate"])
        assert abs(lr_t - lr_j) <= 1e-7 * lr_j, (step, lr_t, lr_j)
        tp, tstate = topt.update({k: _t(v) for k, v in grads.items()}, tstate, tp)
        for k in params:
            assert _rel(tp[k].numpy(), jp[k], 1.0) <= 1e-6, (step, k)
    assert int(tstate.count) == 3
    assert topt.schedule(torch.tensor(0)).item() == pytest.approx(lr, rel=1e-7)


def _assert_adam_close(pairs, lr):
    """One Adam step from the same state, ``pairs`` of (port, JAX) arrays:
    each entry within 2 lr (an entry whose gradient is within rounding of 0
    may step the other way), and the mean over all entries within 1e-2 lr."""
    total, n = 0.0, 0
    for name, a, b in pairs:
        diff = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
        assert diff.max() <= 2 * lr + 1e-6, (name, diff.max())
        total, n = total + diff.sum(), n + diff.size
    print(f"mean {total / n / lr:.3e} lr over {n} entries")
    assert total / n <= 1e-2 * lr


def _decoder_pairs(port_module, jax_tree):
    return [(i, a.detach().numpy(), b) for i, (a, b) in
            enumerate(zip(port_module.parameters(), _oihw_grads(jax_tree)))]


def _hwio_tree(arrays):
    """The port's decoder-ordered OIHW tensors as the JAX package's tree."""
    it = iter(arrays)
    # Copies: jnp.asarray may alias a numpy view of the port's tensors, which
    # the port's step then updates in place.
    return [{"w": jnp.array(np.transpose(w.numpy(), (2, 3, 1, 0)), copy=True),
             "b": jnp.array(b.numpy(), copy=True)} for w, b in zip(it, it)]


def _jax_state(state):
    """The port's ``TrainState`` as the JAX package's (params, optax.adam's
    chained state, step)."""
    names = [k for k, _ in state.params.named_parameters()]
    count = jnp.asarray(int(state.opt_state.count), jnp.int32)
    adam = optax.ScaleByAdamState(count=count,
                                  mu=_hwio_tree([state.opt_state.mu[k] for k in names]),
                                  nu=_hwio_tree([state.opt_state.nu[k] for k in names]))
    params = _hwio_tree([p.detach() for p in state.params.parameters()])
    return jtrain.TrainState(params, (adam, optax.ScaleByScheduleState(count=count)),
                             jnp.asarray(state.step, jnp.int32))


def test_three_train_steps_match_jax(nets, batch):
    """Three steps; before each, the JAX step starts from the port's state
    (parameters, Adam moments, count). The loss is steep here (lr 1e-4
    moves it from 200 to 292), so two runs that part by Adam's few flipped
    entries drift 3e-4 apart in loss within a step: each step is held on its
    own."""
    vj, dj, vt, _ = nets
    c, s = batch
    jopt = jtrain.make_optimizer()
    jstep = jax.jit(jtrain.make_train_step(jopt, vj))
    dec = tweights.from_jax_params(dj, "cpu")
    topt = ttrain.make_optimizer()
    vgg, state = ttrain.shard_train_setup(["cpu"], copy.deepcopy(vt), dec, topt)
    tstep = ttrain.compile_train_step(["cpu"], topt, vgg)
    assert not any(p.requires_grad for p in vgg.parameters())
    for i in range(3):
        jstate, jm = jstep(_jax_state(state), jnp.asarray(c), jnp.asarray(s))
        state, m = tstep(state, _t(c), _t(s))
        assert m["lr"].item() == pytest.approx(LR / (1 + 5e-5 * i), rel=1e-7)
        for k in ("loss", "loss_content", "loss_style"):
            assert abs(m[k].item() - float(jm[k])) <= LOSS_TOL * abs(float(jm[k])), (i, k)
        _assert_adam_close(_decoder_pairs(state.params, jstate.params), LR)
        assert int(jstate.step) == state.step == i + 1
    assert int(state.opt_state.count) == 3


def test_a_mesh_of_two_devices_raises(nets):
    _, _, vt, dt = nets
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        ttrain.shard_train_setup(["cpu", "cpu"], vt, dt, ttrain.make_optimizer())
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        ttrain.compile_train_step(["cpu", "cpu"], ttrain.make_optimizer(), vt)


# ---------------------------------------------------------------------------
# Magenta distillation
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def magenta(tmp_path_factory):
    """A seeded stylizer, drawn by the port, as the JAX package reads it, and
    the npz that carries it across."""
    path = tmp_path_factory.mktemp("magenta") / "m.npz"
    tmag.save_magenta_npz(tmag.init_magenta_params(device="cpu"), path)
    return jmag.load_magenta_npz(path), path


def _fp32_teacher(monkeypatch):
    """The JAX distillation with its teacher in fp32, as the port's runs
    (the JAX package's default is bf16: ROADMAP queue 3)."""
    monkeypatch.setattr(jinfer, "stylize_simple",
                        functools.partial(jinfer.stylize_simple, compute_dtype=jnp.float32))


def test_distill_loss_refuses_a_crop_the_decoder_cannot_return(nets, magenta):
    _, _, vt, dt = nets
    pt = tmag.load_magenta_npz(magenta[1], "cpu")
    with pytest.raises(ValueError, match="multiple of 8"):
        tmt.distill_loss(pt, vt, dt, torch.rand(1, 36, 36, 3), torch.rand(32, 32, 3))


def test_distill_loss_and_one_step_match_jax(nets, magenta, monkeypatch):
    vj, dj, vt, dt = nets
    pj, path = magenta
    g = np.random.default_rng(2)
    c = g.random((2, 64, 64, 3)).astype(np.float32)
    s = g.random((64, 64, 3)).astype(np.float32)
    _fp32_teacher(monkeypatch)
    loss_j = float(jax.jit(jmt.distill_loss)(pj, vj, dj, jnp.asarray(c), jnp.asarray(s)))
    pt = tmag.load_magenta_npz(path, "cpu")
    loss_t = tmt.distill_loss(pt, vt, dt, _t(c), _t(s)).item()
    assert abs(loss_t - loss_j) <= LOSS_TOL * loss_j, (loss_t, loss_j)

    lr = 1e-3
    jopt = jtrain.make_optimizer(lr)
    jstep = jmt.make_distill_step(jopt, vj, dj)
    pj1, _, lj = jstep(pj, jopt.init(pj), jnp.asarray(c), jnp.asarray(s))
    topt = ttrain.make_optimizer(lr)
    tstep = tmt.make_distill_step(topt, copy.deepcopy(vt), copy.deepcopy(dt))
    state = topt.init({k: p.detach() for k, p in tmt._named(pt)})
    pt1, state, lt = tstep(pt, state, _t(c), _t(s))
    assert abs(lt.item() - float(lj)) <= LOSS_TOL * float(lj)
    assert int(state.count) == 1
    tmag.save_magenta_npz(pt1, path.parent / "port_step1.npz")
    with np.load(path.parent / "port_step1.npz") as a:
        jmag.save_magenta_npz(pj1, path.parent / "jax_step1.npz")
        with np.load(path.parent / "jax_step1.npz") as b:
            assert set(a.files) == set(b.files)
            _assert_adam_close([(k, a[k], b[k]) for k in a.files], lr)


def _folder(root, name, n, size, seed):
    g = np.random.default_rng(seed)
    d = root / name
    d.mkdir()
    for i in range(n):
        Image.fromarray((g.random((size, size, 3)) * 255).astype(np.uint8)).save(d / f"{i}.png")
    return d


def test_train_magenta_distill_npz_stylizes_the_same_in_jax(tmp_path, nets, magenta,
                                                            monkeypatch):
    vj, dj, _, _ = nets
    pj, path = magenta
    wdir = tmp_path / "w"
    jweights.save_params_npz(jvgg_params_np(vj), wdir / "vgg_normalised.npz")
    jweights.save_params_npz(jvgg_params_np(dj), wdir / "adain_decoder.npz")
    monkeypatch.setattr(tweights, "DEFAULT_WEIGHTS_DIR", wdir)
    content = _folder(tmp_path, "content", 3, 80, 4)
    style = _folder(tmp_path, "style", 3, 80, 5)
    save = tmp_path / "out.npz"
    params, loss = tmt.train_magenta_distill(
        str(content), str(style), steps=3, batch_size=2, crop=64, lr=3e-3, save_path=save,
        save_every=3, log_every=0, params=tmag.load_magenta_npz(path, "cpu"), device="cpu")
    assert np.isfinite(loss)
    g = np.random.default_rng(6)
    c = g.random((1, 64, 64, 3)).astype(np.float32)
    s = g.random((64, 64, 3)).astype(np.float32)
    out_j = np.asarray(jax.jit(jmag.stylize)(jmag.load_magenta_npz(save), jnp.asarray(c),
                                             jnp.asarray(s)))
    with torch.no_grad():
        out_t = tmag.stylize(params, _t(c), _t(s)).numpy()
    assert np.abs(out_t - out_j).max() <= 1e-5
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        tmt.train_magenta_distill(str(content), str(style), steps=1, mesh=["cpu", "cpu"])


def jvgg_params_np(tree):
    return [{"w": np.asarray(p["w"]), "b": np.asarray(p["b"])} for p in tree]


# ---------------------------------------------------------------------------
# The data stream
# ---------------------------------------------------------------------------

def _take(it, n):
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("workers", [1, 8])
def test_infinite_batches_equal_the_jax_single_worker_stream(tmp_path, workers):
    """Three batches of 2 from 5 images cross an epoch; the port's stream is
    the JAX package's ``num_workers=1`` stream at every worker count, and
    repeats itself."""
    root = _folder(tmp_path, "imgs", 5, 48, 7)
    ref = _take(jimages.infinite_batches(jimages.FlatFolderDataset(root), 2, seed=3, crop=32,
                                         num_workers=1), 3)
    ds = timages.FlatFolderDataset(root)
    for _ in range(2):
        got = _take(timages.infinite_batches(ds, 2, seed=3, crop=32, num_workers=workers), 3)
        for a, b in zip(got, ref):
            assert a.shape == (2, 32, 32, 3) and a.dtype == np.float32
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("workers", [1, 8])
def test_infinite_batches_raise_a_decode_error_in_the_consumer(tmp_path, workers):
    """An unreadable image stops the stream with its error instead of
    leaving the consumer waiting."""
    root = _folder(tmp_path, "imgs", 1, 40, 14)
    (root / "broken.png").write_bytes(b"not an image")
    it = timages.infinite_batches(timages.FlatFolderDataset(root), 2, crop=16,
                                  num_workers=workers)
    with pytest.raises(OSError):
        for _ in range(3):
            next(it)


def test_flat_folder_dataset_matches_jax(tmp_path):
    root = _folder(tmp_path, "imgs", 2, 40, 8)
    (root / "notes.txt").write_text("skipped")
    a, b = timages.FlatFolderDataset(root), jimages.FlatFolderDataset(root)
    assert [p.name for p in a.paths] == [p.name for p in b.paths] and len(a) == 2
    np.testing.assert_array_equal(a.load(1, np.random.default_rng(0), crop=24),
                                  b.load(1, np.random.default_rng(0), crop=24))
    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError, match="no images"):
        timages.FlatFolderDataset(tmp_path / "empty")


# ---------------------------------------------------------------------------
# CLIs
# ---------------------------------------------------------------------------

def test_train_adain_cli_writes_jax_checkpoints_and_log(tmp_path, nets, monkeypatch):
    vj, dj, vt, _ = nets
    wdir = tmp_path / "w"
    jweights.save_params_npz(jvgg_params_np(vj), wdir / "vgg_normalised.npz")
    monkeypatch.setattr(tweights, "DEFAULT_WEIGHTS_DIR", wdir)
    monkeypatch.setattr(tdec, "init_decoder_params",
                        lambda seed, device=None: tweights.from_jax_params(dj, device))
    content = _folder(tmp_path, "content", 3, 40, 9)
    style = _folder(tmp_path, "style", 3, 40, 10)
    out = tcli_adain.main(["--content_dir", str(content), "--style_dir", str(style),
                           "--save_dir", str(tmp_path / "exp"), "--log_dir",
                           str(tmp_path / "logs"), "--max_iter", "100", "--batch_size", "1",
                           "--crop", "16", "--save_model_interval", "20", "--n_threads", "2",
                           "--device", "cpu"])
    assert out == str(tmp_path / "exp")
    assert sorted(p.name for p in (tmp_path / "exp").iterdir()) == sorted(
        f"decoder_iter_{n}.npz" for n in (20, 40, 60, 80, 100))
    recs = [json.loads(l) for l in (tmp_path / "logs" / "train_log.jsonl").read_text().splitlines()]
    assert [sorted(r) for r in recs] == [["iter", "loss_content", "loss_style"]]
    assert recs[0]["iter"] == 100

    # The checkpoint is the JAX package's layout, and it is the port's own
    # step on the port's stream (the step is held against JAX above).
    saved = jweights.load_params_npz(tmp_path / "exp" / "decoder_iter_20.npz")
    assert [p["w"].shape for p in saved] == [tuple(p["w"].shape) for p in dj]
    assert jdec.decoder_apply(saved, jnp.zeros((1, 2, 2, 512))).shape == (1, 16, 16, 3)
    topt = ttrain.make_optimizer()
    vgg, state = ttrain.shard_train_setup(["cpu"], copy.deepcopy(vt),
                                          tweights.from_jax_params(dj, "cpu"), topt)
    step = ttrain.compile_train_step(["cpu"], topt, vgg)
    c_it = timages.infinite_batches(timages.FlatFolderDataset(content), 1, seed=0, crop=16)
    s_it = timages.infinite_batches(timages.FlatFolderDataset(style), 1, seed=1, crop=16)
    for _ in range(20):
        state, _ = step(state, _t(next(c_it)), _t(next(s_it)))
    for a, b in zip(saved, tweights.hwio_params(state.params)):
        np.testing.assert_array_equal(a["w"], b["w"])
        np.testing.assert_array_equal(a["b"], b["b"])


def test_train_magenta_cli(tmp_path, nets, monkeypatch):
    vj, dj, _, _ = nets
    wdir = tmp_path / "w"
    jweights.save_params_npz(jvgg_params_np(vj), wdir / "vgg_normalised.npz")
    jweights.save_params_npz(jvgg_params_np(dj), wdir / "adain_decoder.npz")
    monkeypatch.setattr(tweights, "DEFAULT_WEIGHTS_DIR", wdir)
    content = _folder(tmp_path, "content", 2, 72, 11)
    style = _folder(tmp_path, "style", 2, 72, 12)
    save = tmp_path / "out" / "m.npz"
    args = ["--content_dir", str(content), "--style_dir", str(style), "--save_path", str(save),
            "--max_iter", "2", "--batch_size", "2", "--crop", "64", "--device", "cpu"]
    assert tcli_magenta.main(args) == str(save) and save.exists()
    params = jmag.load_magenta_npz(save)
    out = jax.jit(jmag.stylize)(params, jnp.full((1, 64, 64, 3), 0.5),
                                jnp.full((64, 64, 3), 0.25))
    assert np.isfinite(np.asarray(out)).all()
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        tcli_magenta.main(args + ["--mesh_dp", "2"])


def test_trainer_entry_points_without_cuda_raise(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    content = _folder(tmp_path, "content", 1, 40, 13)
    for call in (lambda: tcli_adain.main(["--content_dir", str(content), "--style_dir",
                                          str(content), "--save_dir", str(tmp_path / "e"),
                                          "--log_dir", str(tmp_path / "l")]),
                 lambda: tmt.train_magenta_distill(str(content), str(content), steps=1)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
