"""3DGS scene evaluation: LPIPS (VGG16, AlexNet, SqueezeNet), ``evaluate``,
its CLI and ``run_full_eval`` — aip_tpu_torch against aip_tpu on the CPU.

Extractor weights and lin weights are drawn with numpy from a seed and
handed to both packages (``from_jax_params``, or the npz caches both
packages' weights directories point at). Tolerances: LPIPS distances within
1e-5 relative; the json files of ``evaluate`` with the same keys, the same
provenance and every number within 1e-5 relative (PSNR, SSIM, LPIPS).
"""

import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from aip_tpu.gs import full_eval as jfull
from aip_tpu.gs import metrics_cli as jmetrics
from aip_tpu.models import lpips as jlpips
from aip_tpu.models import vgg as jvgg
from aip_tpu.models import weights as jweights
from aip_tpu_torch.gs import full_eval as tfull
from aip_tpu_torch.gs import metrics_cli as tmetrics
from aip_tpu_torch.gs import pipeline as tpipe
from aip_tpu_torch.models import lpips as tlpips
from aip_tpu_torch.models import weights as tweights

torch.set_num_threads(2)

LPIPS_TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _conv(rng, k, cin, cout):
    return {"w": (rng.standard_normal((k, k, cin, cout), dtype=np.float32)
                  * np.float32((2.0 / (k * k * cin)) ** 0.5)),
            "b": (rng.standard_normal(cout) * 0.05).astype(np.float32)}


def _extractor(rng, net):
    """JAX-layout extractor parameters (HWIO)."""
    if net == "vgg":
        return [_conv(rng, 3, cin, cout) for _, cin, cout, _ in jlpips.conv_specs()]
    if net == "alex":
        return [_conv(rng, k, cin, cout) for _, cin, cout, k, *_r in jlpips.ALEX_CONVS]
    fires, cin = [], 64
    for _idx, sq, ex in jlpips.SQUEEZE_FIRES:
        fires.append({"squeeze": _conv(rng, 1, cin, sq), "e1": _conv(rng, 1, sq, ex),
                      "e3": _conv(rng, 3, sq, ex)})
        cin = 2 * ex
    return {"stem": _conv(rng, 3, 3, 64), "fires": fires}


def _close(out, ref, tol=LPIPS_TOL):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert np.all(np.abs(out - ref) <= tol * np.maximum(np.abs(ref), 1e-3)), (out, ref)


# ---------------------------------------------------------------------------
# models/lpips.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw", [(11, 11), (12, 13), (14, 15), (9, 16)])
@pytest.mark.parametrize("ceil", [False, True])
def test_max_pool_3x3s2_matches_jax_at_odd_and_even_sizes(rng, hw, ceil):
    x = rng.standard_normal((1, *hw, 3)).astype(np.float32)
    ref = np.asarray(jlpips._max_pool_3x3s2(jnp.asarray(x), ceil_mode=ceil))
    out = tlpips._max_pool_3x3s2(_t(x).permute(0, 3, 1, 2), ceil_mode=ceil).permute(0, 2, 3, 1)
    assert out.shape == ref.shape
    assert np.array_equal(out.numpy(), ref)


@pytest.mark.parametrize("net,hw", [("vgg", (32, 32)), ("vgg", (33, 27)),
                                    ("alex", (64, 64)), ("alex", (67, 71)),
                                    ("squeeze", (64, 64)), ("squeeze", (65, 66))])
@pytest.mark.parametrize("learned", [False, True])
def test_lpips_matches_jax(rng, net, hw, learned):
    """Two images a side; odd and even sizes (SqueezeNet's ceil-mode pools
    pad at 65 and 66, not at 64)."""
    params = _extractor(rng, net)
    a = rng.random((2, *hw, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    lins = ([rng.random(c).astype(np.float32) for c in jlpips.NET_CHANNELS[net]]
            if learned else None)
    ref = jlpips.lpips(jnp.asarray(a), jnp.asarray(b), params,
                       lin_weights=None if lins is None else [jnp.asarray(w) for w in lins],
                       net=net)
    out = tlpips.lpips(_t(a), _t(b), tlpips.from_jax_params(params, "cpu"),
                       lin_weights=None if lins is None else [_t(w) for w in lins], net=net)
    assert out.shape == (2,)
    _close(out.numpy(), ref)


def test_lpips_caches_and_checkpoints_cross_packages(rng, tmp_path, monkeypatch):
    """The lin weights from a richzhang-layout checkpoint (cached as npz in
    each package's weights directory), the SqueezeNet and VGG16 npz caches:
    both packages read the same weights."""
    for mod, d in ((jweights, tmp_path / "j"), (tweights, tmp_path / "t")):
        monkeypatch.setattr(mod, "DEFAULT_WEIGHTS_DIR", d)
    assert tlpips.get_lin_weights("vgg", device="cpu") is None
    lins = [rng.random(c).astype(np.float32) for c in jlpips.LPIPS_CHANNELS]
    ckpt = tmp_path / "vgg.pth"
    torch.save({f"lin{i}.model.1.weight": _t(w.reshape(1, -1, 1, 1))
                for i, w in enumerate(lins)} | {"pad": torch.zeros(2048)}, ckpt)
    jl = jlpips.get_lin_weights("vgg", str(ckpt))
    tl = tlpips.get_lin_weights("vgg", str(ckpt), device="cpu")
    assert (tmp_path / "t" / "lpips_lin_vgg.npz").is_file()
    for a, b, w in zip(tl, jl, lins):
        assert np.array_equal(a.numpy(), np.asarray(b)) and np.array_equal(a.numpy(), w)
    again = tlpips.get_lin_weights("vgg", device="cpu")  # from the cache now
    assert all(torch.equal(a, b) for a, b in zip(again, tl))

    sq = _extractor(rng, "squeeze")
    flat = {"stem_w": sq["stem"]["w"], "stem_b": sq["stem"]["b"]}
    for i, f in enumerate(sq["fires"]):
        for k in ("squeeze", "e1", "e3"):
            flat[f"f{i}_{k}_w"], flat[f"f{i}_{k}_b"] = f[k]["w"], f[k]["b"]
    vgg = _extractor(rng, "vgg")
    for d in (tmp_path / "j", tmp_path / "t"):
        np.savez(d / "squeezenet_fires.npz", **flat)
        jweights.save_params_npz(vgg, d / "vgg16_imagenet.npz")
    x = rng.random((1, 40, 40, 3)).astype(np.float32)
    y = rng.random((1, 40, 40, 3)).astype(np.float32)
    for net in ("squeeze", "vgg"):
        ref = jlpips.lpips(jnp.asarray(x), jnp.asarray(y), jlpips.get_extractor_params(net),
                           net=net)
        out = tlpips.lpips(_t(x), _t(y), tlpips.get_extractor_params(net, device="cpu"),
                           net=net)
        _close(out.numpy(), ref)
    with pytest.raises(ValueError, match="unknown LPIPS net"):
        tlpips.get_extractor_params("resnet", device="cpu")


def test_default_extractors_have_the_jax_layout(rng, tmp_path, monkeypatch):
    """Without caches or checkpoints: the port's deterministic init, in
    the JAX package's layout (OIHW convs)."""
    monkeypatch.setattr(tweights, "DEFAULT_WEIGHTS_DIR", tmp_path)
    for net in ("vgg", "alex", "squeeze"):
        want = jax_shapes(_extractor(rng, net))
        got = tlpips.get_extractor_params(net, device="cpu")
        assert port_shapes(got) == want, net
    g = tlpips.init_alexnet_params(torch.Generator().manual_seed(4), "cpu")
    h = tlpips.init_alexnet_params(torch.Generator().manual_seed(4), "cpu")
    assert torch.equal(g[0]["w"], h[0]["w"])


def jax_shapes(tree):
    if isinstance(tree, dict):
        return {k: jax_shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [jax_shapes(v) for v in tree]
    s = tuple(np.shape(tree))
    return s if len(s) != 4 else (s[3], s[2], s[0], s[1])


def port_shapes(mod):
    if isinstance(mod, torch.nn.Parameter):
        return tuple(mod.shape)
    if isinstance(mod, (torch.nn.ModuleList, torch.nn.ParameterList)):
        return [port_shapes(m) for m in mod]
    return {k: port_shapes(v) for k, v in
            list(mod._parameters.items()) + list(mod._modules.items())}


# ---------------------------------------------------------------------------
# gs/metrics_cli.py
# ---------------------------------------------------------------------------

@pytest.fixture
def vgg16_cache(rng, tmp_path, monkeypatch):
    """One VGG16 npz cache both packages read (lin weights absent: the
    uniform fallback)."""
    d = tmp_path / "weights"
    jweights.save_params_npz(_extractor(np.random.default_rng(2), "vgg"),
                             d / "vgg16_imagenet.npz")
    monkeypatch.setattr(jweights, "DEFAULT_WEIGHTS_DIR", d)
    monkeypatch.setattr(tweights, "DEFAULT_WEIGHTS_DIR", d)
    return d


def _test_layout(root: Path, rng, methods=("ours_7", "ours_30"), n=2, hw=(36, 44)):
    for m in methods:
        for sub in ("renders", "gt"):
            (root / "test" / m / sub).mkdir(parents=True)
        for i in range(n):
            gt = rng.random((*hw, 3))
            r = np.clip(gt + rng.normal(0, 0.05 * (i + 1), gt.shape), 0, 1)
            for sub, img in (("gt", gt), ("renders", r)):
                Image.fromarray((img * 255).astype(np.uint8)).save(
                    root / "test" / m / sub / f"{i:05d}.png")
    (root / "test" / "notes.txt").write_text("not a method")
    return root


def _same_json(a, b):
    assert type(a) is type(b), (a, b)
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same_json(a[k], b[k])
    elif isinstance(a, float):
        assert abs(a - b) <= LPIPS_TOL * max(abs(b), 1e-3), (a, b)
    else:
        assert a == b


@pytest.mark.parametrize("use_lpips", [True, False])
def test_evaluate_writes_the_jax_json(vgg16_cache, rng, tmp_path, use_lpips):
    j = _test_layout(tmp_path / "j" / "scene", rng)
    t = tmp_path / "t" / "scene"
    t.parent.mkdir()
    import shutil

    shutil.copytree(j, t)
    ref = jmetrics.evaluate([str(j)], use_lpips=use_lpips)
    out = tmetrics.evaluate([str(t)], use_lpips=use_lpips, device="cpu")
    _same_json(out[str(t)], ref[str(j)])
    for name in ("results.json", "per_view.json"):
        _same_json(json.loads((t / name).read_text()), json.loads((j / name).read_text()))
    res = json.loads((t / "results.json").read_text())
    assert sorted(res) == ["ours_30", "ours_7"]
    if use_lpips:
        assert res["ours_7"]["lpips_weights"] == "uniform-fallback"
        assert res["ours_7"]["LPIPS"] > 0
    else:
        assert "lpips_weights" not in res["ours_7"] and res["ours_7"]["LPIPS"] is None


def test_evaluate_with_learned_lin_weights_and_the_cli(vgg16_cache, rng, tmp_path, capsys):
    lins = [rng.random(c).astype(np.float32) for c in jlpips.LPIPS_CHANNELS]
    np.savez(vgg16_cache / "lpips_lin_vgg.npz", **{f"l{i}": w for i, w in enumerate(lins)})
    j = _test_layout(tmp_path / "j", rng, methods=("ours_5",), n=1)
    ref = jmetrics.evaluate([str(j)])
    out = tmetrics.main(["-m", str(j), "--device", "cpu"])
    assert out[str(j)]["ours_5"]["lpips_weights"] == "learned"
    _same_json(out, ref)
    assert json.loads(capsys.readouterr().out) == out
    (tmp_path / "nothing").mkdir()
    assert tmetrics.evaluate([str(tmp_path / "nothing")], use_lpips=False,
                             device="cpu") == {str(tmp_path / "nothing"): {}}


# ---------------------------------------------------------------------------
# gs/full_eval.py
# ---------------------------------------------------------------------------

def _blender_scene(root: Path, rng, n_views=2, size=32):
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


def test_run_full_eval_with_no_scene_evaluates_nothing(vgg16_cache, tmp_path):
    style = tmp_path / "s.png"
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(style)
    assert jfull.run_full_eval(str(style), str(tmp_path / "e")) == {}
    assert tfull.run_full_eval(str(style), str(tmp_path / "e"), device="cpu") == {}
    assert tfull.run_full_eval(str(style), str(tmp_path / "e"), skip_metrics=True,
                               device="cpu") == {}


def test_run_full_eval_on_a_tiny_scene_returns_empty_metrics(vgg16_cache, rng, tmp_path,
                                                             monkeypatch):
    """Deep Blending's two scene names over one tiny Blender scene: the port
    trains (4 iterations, small capacity) and renders both, then aip_tpu
    renders the port's models and evaluates. Both metrics steps read
    ``<model>/test`` while rendering wrote ``<model>/renders``: {model: {}}."""
    jweights.save_params_npz(
        [_conv(rng, k, cin, cout) for _, cin, cout, k, _ in jvgg.conv_specs()],
        vgg16_cache / "vgg_normalised.npz")
    db = tmp_path / "db"
    src = _blender_scene(db / "drjohnson", rng)
    import shutil

    shutil.copytree(src, db / "playroom")
    style = tmp_path / "s.png"
    Image.fromarray((rng.random((32, 32, 3)) * 255).astype(np.uint8)).save(style)
    monkeypatch.setattr(tpipe, "run_3dgs_training", functools.partial(
        tpipe.run_3dgs_training, capacity=512, log2_hashmap=10, img_size=32,
        progress_every=0, max_per_tile=32))
    out = tfull.run_full_eval(str(style), str(tmp_path / "eval"), deepblending=str(db),
                              iterations=4, freeze_iters=2, device="cpu")
    models = [str(tmp_path / "eval" / s) for s in ("drjohnson", "playroom")]
    assert out == {m: {} for m in models}
    for m in models:
        assert (Path(m) / "model.npz").is_file() and (Path(m) / "renders" / "render.gif").is_file()
    ref = jfull.run_full_eval(str(style), str(tmp_path / "eval"), deepblending=str(db),
                              skip_training=True)
    assert ref == out
    # views_per_step=2: two views a step (4 iterations, 2 steps per scene).
    out2 = tfull.run_full_eval(str(style), str(tmp_path / "x"), deepblending=str(db),
                               iterations=4, freeze_iters=2, views_per_step=2, device="cpu")
    assert out2 == {str(tmp_path / "x" / s): {} for s in ("drjohnson", "playroom")}
    for m in out2:
        assert (Path(m) / "model.npz").is_file()


def test_eval_entry_points_without_cuda_raise(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tmetrics.evaluate([str(tmp_path)]),
                 lambda: tmetrics.main(["-m", str(tmp_path)]),
                 lambda: tfull.run_full_eval("s.png", str(tmp_path)),
                 lambda: tfull.main(["--style", "s.png", "--output_path", str(tmp_path)]),
                 lambda: tlpips.get_extractor_params("vgg"),
                 lambda: tlpips.get_lin_weights("vgg")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
