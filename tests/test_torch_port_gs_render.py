"""aip_tpu_torch.gs.render and gs.pipeline vs aip_tpu's, on the CPU.

Inputs are drawn with numpy from a seed (or taken from the committed
bed_0037 model) and handed to both packages. The JAX side runs its Pallas
compositors in interpret mode; the port's wrappers take their plain
versions on CPU tensors.

Tolerances: ``fit_selection`` dicts are equal (host integer arithmetic on
the same projected footprints); serving frames at 2e-4 absolute, the JAX
package's own tolerance for the macro-block composites, on >= 99 % of
values, and the port's composite at 2e-4 against float64 everywhere (the
frame test's docstring says why); rendered PNGs within 1/255 on >= 99.9 %
of pixels, since uint8 quantisation can flip a value that sits on a
rounding boundary.
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aip_tpu.gs import colorfield as JF
from aip_tpu.gs import compress as JCMP
from aip_tpu.gs import gaussians as JG
from aip_tpu.gs import render as JRN
from aip_tpu.gs import rvq as jrvq
from aip_tpu.gs.cameras import Camera
from aip_tpu_torch.gs import compress as TCMP
from aip_tpu_torch.gs import rasterizer as TR
from aip_tpu_torch.gs import render as TRN
from aip_tpu_torch.gs.state import from_jax_arrays
from aip_tpu_torch.kernels import composite as TK

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
BED = ROOT / "docs" / "examples" / "bed_0037_r5" / "model.npz"


def _t(x):
    return torch.from_numpy(np.array(x))


def _look_at(center, dist, azimuth, elev, w, h, fovx=0.8):
    """A camera on an orbit around ``center`` (z up), as the Blender reader
    would build it."""
    pos = center + dist * np.array([math.cos(azimuth) * math.cos(elev),
                                    math.sin(azimuth) * math.cos(elev), math.sin(elev)])
    fwd = (center - pos) / np.linalg.norm(center - pos)
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, np.cross(right, fwd), -fwd, pos
    c2w[:3, 1:3] *= -1  # OpenGL -> COLMAP axes
    w2c = np.linalg.inv(c2w)
    fovy = 2 * math.atan(math.tan(fovx / 2) * h / w)
    return Camera(colmap_id=0, R=w2c[:3, :3].T, T=w2c[:3, 3], FoVx=fovx, FoVy=fovy,
                  image=np.zeros((h, w, 3), np.float32), image_name="orbit", uid=0)


def _state_np(rng, n, giant_rows=0):
    scales = rng.random((n, 3)) * 0.06 + 0.01
    scales[:giant_rows] = rng.random((giant_rows, 3)) * 0.8 + 0.4
    op = rng.random(n) * 0.8 + 0.1
    return dict(
        xyz=(rng.random((n, 3)) * 2 - 1).astype(np.float32),
        scaling=np.log(scales).astype(np.float32),
        rotation=rng.standard_normal((n, 4)).astype(np.float32),
        opacity=np.log(op / (1 - op)).astype(np.float32)[:, None],
        mask=np.ones((n, 1), np.float32), active=np.ones(n, bool),
        max_radii2d=np.zeros(n, np.float32), xyz_grad_accum=np.zeros((n, 1), np.float32),
        denom=np.zeros((n, 1), np.float32))


def _jstate(state_np):
    return JG.GaussianState(**{k: jnp.asarray(v) for k, v in state_np.items()})


def test_fit_selection_dicts_equal(rng):
    """The same scene and cameras fit the same selection in both packages,
    giant tiers and pools included."""
    state_np = _state_np(rng, 600, giant_rows=40)
    state_np["active"][-30:] = False
    cams = [_look_at(np.zeros(3), 3.0, a, 0.4, 384, 256) for a in (0.0, 1.3, 2.6)]
    ts, _ = from_jax_arrays(state_np, None, "cpu")
    ref = JRN.fit_selection(_jstate(state_np), cams, sample=2, lo=64)
    out = TRN.fit_selection(ts, cams, sample=2, lo=64)
    assert out == ref
    assert out["giant_tiers"] and out["giant_backend"] == "direct"


def test_fit_macro_capacity_matches_jax(rng):
    """``fit_macro_capacity`` of both packages on the scenes of
    tests/test_gs_rasterizer.py's test_fit_macro_capacity: 50 points spread
    out keep the floor; 1800 points in one tiny region raise the capacity to
    the measured demand times the margin, a multiple of 64; ``hi`` clamps.
    The same integer in both packages each time."""
    cam = Camera(colmap_id=0, R=np.eye(3), T=np.array([0.0, 0.0, 4.0]), FoVx=np.pi / 3,
                 FoVy=np.pi / 3, image=np.zeros((256, 256, 3), np.float32), image_name="t",
                 uid=0)

    def both(n, spread, capacity, **kw):
        pts = jnp.asarray((rng.random((n, 3)) * spread - (spread > 1)).astype(np.float32))
        cols = jnp.asarray(rng.random((n, 3)).astype(np.float32))
        js, _ = JG.create_from_pcd(pts, cols, capacity=capacity)
        ts, _ = from_jax_arrays({k: np.asarray(v) for k, v in js._asdict().items()}, None,
                                "cpu")
        ref = JRN.fit_macro_capacity(js, [cam], **kw)
        out = TRN.fit_macro_capacity(ts, [cam], **kw)
        assert out == ref
        return out

    assert both(50, 2.0, 64) == 1024
    cap = both(1800, 0.01, 2048)
    assert cap % 64 == 0 and 1800 <= cap <= int(1800 * 1.15) + 64
    assert both(1800, 0.01, 2048, hi=1280) == 1280


@pytest.fixture(scope="module")
def bed_subset():
    """4096 splats of the committed model, loaded by both packages."""
    js, jf, _, _ = JCMP.load_npz(BED)
    ts, tf, _, _ = TCMP.load_npz(BED, device="cpu")
    idx = np.sort(np.random.default_rng(7).choice(js.xyz.shape[0], 4096, replace=False))
    js = JG.GaussianState(*(a[idx] for a in js))
    ts = type(ts)(*(t[torch.from_numpy(idx)] for t in ts))
    xyz = np.asarray(js.xyz, np.float64)
    center = np.median(xyz, axis=0)
    dist = np.percentile(np.linalg.norm(xyz - center, axis=1), 80) / math.tan(0.4)
    return js, jf, ts, tf, center, dist


# (size, selection, expected branch): the recorded selection of the model
# takes the windowed compositor; a merge-giant selection at 192^2 emits few
# enough pair slots for the segment walk.
_FRAME_CASES = {
    "windowed": (128, json.loads((BED.parent / "cfg_args.json").read_text())["selection"],
                 False),
    "segment": (192, {"macro_capacity": 1024, "dup_span": 2, "giant_capacity": 128,
                      "giant_backend": "merge"}, True),
}


def _oracle_planes(name, args, kw):
    """The captured compositor call evaluated per pixel in float64."""
    if name == "composite_macro_mxu_seg":
        table, starts, counts, bg = args
        window = TK._segment_window(table.double(), starts, counts, kw["kc"])
    else:
        window, counts, bg = args
        window = window.double()
    planes, _ = TK._composite_chunk(window, counts, bg.double(),
                                    torch.arange(window.shape[0]), kw["bs"], kw["mtw"])
    return planes[:, :, None, :]


@pytest.mark.parametrize("case", sorted(_FRAME_CASES))
def test_inference_frame_matches_jax_on_the_committed_model(bed_subset, rng, monkeypatch, case):
    """The serving frame of both packages on the trained model. The JAX
    macro composites evaluate each Gaussian as a quadratic in block-local
    pixel coordinates, whose float32 terms cancel; for the model's sharp
    splats that is off the float64 value by up to ~7e-3 at a few pixels,
    where the port's per-pixel form stays within 1e-4. So the port's
    composite is held to 2e-4 against a float64 evaluation of the very
    inputs it was given, and the frames to 2e-4 at >= 99 % of values (max
    1e-2)."""
    js, jf, ts, tf, center, dist = bed_subset
    size, sel, seg = _FRAME_CASES[case]
    cam = _look_at(center, dist, 0.7, 0.45, size, size)
    style = (rng.standard_normal((1, 512)) * 0.5).astype(np.float32)
    bg = np.array([0.1, 0.0, 0.2], np.float32)
    jset = JRN.settings_from_selection(sel, size, size)
    tset = TRN.settings_from_selection(sel, size, size)
    ref = np.asarray(JRN.render_frame(JRN.make_inference_frame_fn(
        js, jf, jset, jnp.asarray(bg), style_f=jnp.asarray(style), interpret=True), cam))
    fn = TRN.make_inference_frame_fn(ts, tf, tset, _t(bg), style_f=_t(style))
    assert TR.uses_segment_path(4096, fn.settings) == seg

    name = "composite_macro_mxu_seg" if seg else "composite_macro_mxu"
    wrapper, calls = getattr(TK, name), []

    def spy(*args, **kw):
        calls.append((args, kw))
        return wrapper(*args, **kw)

    monkeypatch.setattr(TK, name, spy)
    TK.reset_launch_counts()
    out = TRN.render_frame(fn, cam).numpy()
    assert len(calls) == 1 and sum(TK.launch_counts().values()) == 0
    planes = wrapper(*calls[0][0], **calls[0][1])
    np.testing.assert_allclose(planes.double().numpy(),
                               _oracle_planes(name, *calls[0]).numpy(), atol=2e-4)
    err = np.abs(out - ref)
    assert (err <= 2e-4).mean() >= 0.99 and err.max() <= 1e-2, (err.max(), (err > 2e-4).mean())
    assert np.abs(ref - bg).max(axis=-1).mean() > 0.02  # splats drawn


def test_run_3dgs_rendering_matches_jax(tmp_path, rng, monkeypatch):
    """A seeded model saved by aip_tpu's save_npz, rendered by both
    packages' run_3dgs_rendering on the tiny Blender scene of
    tests/test_gs_compress.py, with one shared VGG weight cache."""
    from PIL import Image

    from aip_tpu.gs.pipeline import run_3dgs_rendering as j_render
    from aip_tpu.models import vgg as jvgg
    from aip_tpu.models import weights as jweights
    from aip_tpu_torch.gs.pipeline import run_3dgs_rendering as t_render
    from aip_tpu_torch.models import weights as tweights

    wdir = tmp_path / "w"
    jweights.save_params_npz(jvgg.init_vgg_params(jax.random.PRNGKey(0)),
                             wdir / "vgg_normalised.npz")
    monkeypatch.setattr(jweights, "DEFAULT_WEIGHTS_DIR", wdir)
    monkeypatch.setattr(tweights, "DEFAULT_WEIGHTS_DIR", wdir)

    scene = tmp_path / "scene"
    (scene / "images").mkdir(parents=True)
    frames = []
    for i in range(2):
        c2w = np.eye(4)
        c2w[2, 3] = 3.0 - i * 0.5
        frames.append({"file_path": f"./images/r_{i}", "transform_matrix": c2w.tolist()})
        img = np.zeros((32, 32, 4), np.uint8)
        img[10:22, 10:22] = (200, 60, 60, 255)
        img[..., 3] = 255
        Image.fromarray(img).save(scene / "images" / f"r_{i}.png")
    (scene / "transforms_train.json").write_text(
        json.dumps({"camera_angle_x": 0.8, "frames": frames}))
    Image.fromarray((rng.random((32, 32, 3)) * 255).astype(np.uint8)).save(tmp_path / "style.png")

    state_np = _state_np(rng, 120)
    state_np["xyz"] *= 0.6
    field = JF.init_colorfield(jax.random.PRNGKey(1), style_dim=256, log2_hashmap=10)
    field = field._replace(hash_tables=field.hash_tables * 1e3)
    books = lambda d: jrvq.RVQState(jnp.asarray(rng.standard_normal((2, 8, d)) * 0.3,
                                                jnp.float32))
    model = tmp_path / "model"
    JCMP.save_npz(model / "model.npz", _jstate(state_np), field, books(3), books(4))
    (model / "cfg_args.json").write_text(json.dumps({"source_path": str(scene),
                                                     "white_background": False}))

    jgif = Path(j_render(str(tmp_path / "style.png"), str(model), output_dir=str(tmp_path / "j"),
                         max_per_tile=16))
    tgif = Path(t_render(str(tmp_path / "style.png"), str(model), output_dir=str(tmp_path / "t"),
                         max_per_tile=16, device="cpu"))
    assert jgif.is_file() and tgif.is_file()
    for i in range(2):
        a = np.asarray(Image.open(tmp_path / "j" / f"{i:05d}.png"), np.int16)
        b = np.asarray(Image.open(tmp_path / "t" / f"{i:05d}.png"), np.int16)
        assert a.shape == b.shape == (32, 32, 3)
        assert (np.abs(a - b) <= 1).mean() >= 0.999
        assert a.max() > 10  # something was drawn
    # mesh_dp=2 renders with the Gaussians split over two CPU devices, the
    # macro-block selection of the replicated macro renderer (aip_tpu's
    # render(mesh=) is held to that renderer by its own test).
    t_render(str(tmp_path / "style.png"), str(model), output_dir=str(tmp_path / "tr"),
             max_per_tile=16, renderer="matmul", device="cpu")
    t_render(str(tmp_path / "style.png"), str(model), output_dir=str(tmp_path / "tm"),
             max_per_tile=16, mesh_dp=2, device="cpu")
    for i in range(2):
        a = np.asarray(Image.open(tmp_path / "tr" / f"{i:05d}.png"), np.int16)
        b = np.asarray(Image.open(tmp_path / "tm" / f"{i:05d}.png"), np.int16)
        assert np.abs(a - b).max() <= 1 and a.max() > 10


@pytest.mark.parametrize("kw", [dict(renderer="rasterize"), dict(mode="eval")])
def test_render_refuses_an_unknown_renderer_or_mode(kw):
    """A deliberate difference: the port's ``render`` raises ValueError on a
    renderer or a mode it does not name, before any work. aip_tpu's
    ``render`` runs ``rasterize`` for any renderer but "matmul" and
    "pallas" (aip_tpu/gs/render.py:477-483) and renders any mode but
    "inference" as training (:398-413)."""
    with pytest.raises(ValueError, match="unknown render"):
        TRN.render(None, None, None, None, **kw)


@pytest.mark.parametrize("recorded", [True, False], ids=["recorded", "legacy"])
@pytest.mark.parametrize("mesh_dp", [0, 2], ids=["one_device", "mesh"])
@pytest.mark.parametrize("renderer", ["auto", "matmul", "pallas", "xla"])
@pytest.mark.parametrize("hw", [(511, 512), (512, 512)], ids=["511x512", "512x512"])
def test_render_views_routes_each_view_by_the_one_rule(tmp_path, rng, monkeypatch, hw, renderer,
                                                       mesh_dp, recorded):
    """How a trained scene's view renders, with every rasterizer and the
    fit replaced by spies (nothing renders at 512^2): a view of at least
    MACRO_ROUTE_PIXELS with no mesh and renderer auto or matmul goes through
    one make_inference_frame_fn; every other view through render, which
    takes the sharded rasterizer on a mesh, else the renderer's own. The
    macro-block rasterizers get macro 4, at least 1024 candidates a block
    and the "mxu" compositors; the others the selection's settings as they
    are. The selection is the recorded one, else on the macro-block route
    the fitted one with the legacy spans, else the per-tile defaults."""
    from aip_tpu_torch.gs import colorfield as TCF
    from aip_tpu_torch.gs import pipeline as TP
    from aip_tpu_torch.parallel import gs as TPG
    from aip_tpu_torch.parallel.mesh import make_dp_mesh

    h, w = hw
    ts, _ = from_jax_arrays(_state_np(rng, 64), None, "cpu")
    field = TCF.init_colorfield(0, style_dim=None, log2_hashmap=10, device="cpu")
    cam = _look_at(np.zeros(3), 3.0, 0.3, 0.4, w, h)
    mesh = make_dp_mesh(mesh_dp, device="cpu")
    seen, frame_fns = [], []
    fitted = {"macro_capacity": 2048, "dup_span": 2, "giant_capacity": 256,
              "giant_backend": "direct", "giant_tiers": ((2, 128),), "giant_pool_full": 64,
              "max_per_tile": 96}
    fits = []

    def rasterizer(name):
        def spy(*args, **kw):
            settings = next(a for a in args if isinstance(a, TR.RasterSettings))
            seen.append((name, settings))
            return torch.zeros(h, w, 3), torch.zeros(ts.xyz.shape[0])
        return spy

    for name in ("rasterize", "rasterize_fast", "rasterize_matmul"):
        monkeypatch.setattr(TRN, name, rasterizer(name))
    monkeypatch.setattr(TPG, "rasterize_sharded", rasterizer("rasterize_sharded"))
    make_frame_fn = TRN.make_inference_frame_fn
    monkeypatch.setattr(TRN, "make_inference_frame_fn",
                        lambda *a, **kw: frame_fns.append(a) or make_frame_fn(*a, **kw))
    monkeypatch.setattr(TRN, "fit_selection", lambda *a, **kw: fits.append(a) or dict(fitted))

    sel = {"max_per_tile": 64, "macro_capacity": 512, "dup_span": 2, "giant_capacity": 128,
           "giant_backend": "merge"} if recorded else None
    paths = TP.render_views([cam], ts, field, torch.zeros(3), None, tmp_path, sel, 32,
                            renderer=renderer, mesh=mesh)
    assert [p.name for p in paths] == ["00000.png"] and paths[0].is_file()

    macro_route = TRN.takes_macro_route(h, w)
    assert macro_route == (h * w >= 512 * 512) and TRN.MACRO_ROUTE_PIXELS == 512 * 512
    takes_fit = not recorded and macro_route and renderer in ("auto", "matmul")
    assert len(fits) == takes_fit
    if recorded:
        want_sel = sel
    elif takes_fit:
        want_sel = dict(fitted, dup_span=3, giant_capacity=128, giant_backend="merge")
    else:
        want_sel = {"macro_capacity": 1024, "dup_span": 2, "giant_capacity": 128}
    assert TP.default_selection(ts, [cam], renderer) == (
        dict(fitted, dup_span=3, giant_capacity=128, giant_backend="merge")
        if macro_route and renderer in ("auto", "matmul")
        else {"macro_capacity": 1024, "dup_span": 2, "giant_capacity": 128})
    base = TRN.settings_from_selection(want_sel, h, w, max_per_tile=32)

    frame_fn = mesh is None and renderer in ("auto", "matmul") and macro_route
    assert len(frame_fns) == frame_fn
    if mesh is not None:
        want = "rasterize_sharded"
    elif renderer == "auto":
        want = "rasterize_matmul" if macro_route else "rasterize"
    else:
        want = {"matmul": "rasterize_matmul", "pallas": "rasterize_fast",
                "xla": "rasterize"}[renderer]
    (name, got), = seen
    assert name == want
    if want in ("rasterize_matmul", "rasterize_sharded"):
        assert got == base._replace(macro=4, macro_capacity=max(base.macro_capacity, 1024),
                                    composite_backend="mxu")
        assert TRN.inference_settings(got) == got      # a macro grid is kept as it is
    else:
        assert got == base
