"""aip_tpu_torch.gs.pose_paths, gs.render_video and cli.render_video
against aip_tpu's, on the CPU.

Pose paths are host numpy in both packages: every function at 1e-6 on the
same cameras. The renderers run a seeded model saved by aip_tpu's save_npz
(tests/test_torch_port_gs_walk.py's ``_tiny_model``) over a small Blender
scene; their PNGs agree within one 8-bit step (uint8 quantisation can
flip a value that sits on a rounding boundary).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from aip_tpu.gs import pose_paths as JPP
from aip_tpu.gs import render_video as JRV
from aip_tpu.gs.cameras import Camera as JCamera
from aip_tpu_torch.gs import pose_paths as TPP
from aip_tpu_torch.gs import render_video as TRV
from aip_tpu_torch.gs.cameras import Camera as TCamera
from aip_tpu_torch.kernels import composite as TK
from test_torch_port_gs_walk import _tiny_model

torch.set_num_threads(2)


def _orbit(cls, n=8, radius=3.0, wobble=0.3):
    """n cameras of class ``cls`` on a tilted orbit, looking at the origin."""
    views = []
    for i in range(n):
        ang = 2 * np.pi * i / n
        pos = np.array([radius * np.sin(ang), wobble * np.cos(3 * ang), radius * np.cos(ang)])
        z = -pos / np.linalg.norm(pos)
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        r_c2w = np.stack([x, np.cross(z, x), z], 1)
        views.append(cls(colmap_id=i, R=r_c2w, T=-r_c2w.T @ pos, FoVx=0.8, FoVy=0.7,
                         image=np.zeros((12, 16, 3), np.float32), image_name=f"v{i}", uid=i))
    return views


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=0, atol=1e-6)


def _cams_close(a, b):
    for name in ("world_view_transform", "full_proj_transform", "camera_center"):
        _close(getattr(a, name), getattr(b, name))


@pytest.mark.parametrize("name,kw", [
    ("generate_ellipse_path", dict(n_frames=12)),
    ("generate_ellipse_path", dict(n_frames=7, const_speed=False, z_variation=0.5,
                                   z_phase=0.25)),
    ("generate_spherical_sample_path", dict(n=3)),
    ("generate_spherify_path", dict(n_frames=9)),
    ("generate_spiral_path", dict(n_frames=10, zrate=0.5, rots=2)),
])
def test_paths_match_jax(name, kw):
    ref = getattr(JPP, name)(_orbit(JCamera), **kw)
    out = getattr(TPP, name)(_orbit(TCamera), **kw)
    assert len(out) == len(ref) > 0
    for a, b in zip(out, ref):
        _close(a, b)


def test_pose_helpers_match_jax():
    jv, tv = _orbit(JCamera), _orbit(TCamera)
    _close(TPP._poses_from_views(tv), JPP._poses_from_views(jv))
    poses = JPP._poses_from_views(jv)
    _close(TPP.focus_point_fn(poses), JPP.focus_point_fn(poses))
    for a, b in zip(TPP.transform_poses_pca(poses), JPP.transform_poses_pca(poses)):
        _close(a, b)
    _close(TPP.viewmatrix(np.array([0.2, 0.1, 1.0]), np.array([0.0, 1.0, 0.1]), np.ones(3)),
           JPP.viewmatrix(np.array([0.2, 0.1, 1.0]), np.array([0.0, 1.0, 0.1]), np.ones(3)))
    pose = JPP.generate_ellipse_path(jv, n_frames=4)[1]
    _cams_close(TPP.apply_pose(tv[2], pose), JPP.apply_pose(jv[2], pose))
    _cams_close(TPP.circular_pose(tv[1], 0.5, 1.1), JPP.circular_pose(jv[1], 0.5, 1.1))
    _cams_close(TPP.gaussian_pose(tv[3], np.random.default_rng(4), 0.0, 0.03),
                JPP.gaussian_pose(jv[3], np.random.default_rng(4), 0.0, 0.03))


@pytest.fixture
def model(tmp_path, rng):
    return _tiny_model(tmp_path, rng, n_views=3)


def _pngs_close(dir_a, dir_b, n):
    from PIL import Image

    a_paths, b_paths = sorted(Path(dir_a).glob("*.png")), sorted(Path(dir_b).glob("*.png"))
    assert len(a_paths) == len(b_paths) == n
    drawn = 0
    for pa, pb in zip(a_paths, b_paths):
        a = np.asarray(Image.open(pa), np.int16)
        b = np.asarray(Image.open(pb), np.int16)
        assert a.shape == b.shape and np.abs(a - b).max() <= 1
        drawn = max(drawn, int(a.max()))
    assert drawn > 10


def _moved(path, to):
    """Rename a renderer's output directory, so the other package's run
    writes a fresh one."""
    path = Path(path)
    path.rename(to)
    return to


def test_render_circular_video_matches_jax(model, tmp_path):
    j_dir = _moved(JRV.render_circular_video(str(model), radius=0.4, n_frames=3),
                   tmp_path / "j")
    TK.reset_launch_counts()
    t_dir = TRV.render_circular_video(str(model), radius=0.4, n_frames=3, device="cpu")
    assert t_dir == str(model / "circular")
    _pngs_close(j_dir, t_dir, 3)


def test_gaussian_render_matches_jax(model, tmp_path):
    j_root = _moved(JRV.gaussian_render(str(model), n_views=2, n_jitter=2, seed=3),
                    tmp_path / "j")
    t_root = Path(TRV.gaussian_render(str(model), n_views=2, n_jitter=2, seed=3,
                                      device="cpu"))
    assert t_root.name == "gaussians_std0.03"
    for i in range(2):
        _pngs_close(j_root / f"view_{i}", t_root / f"view_{i}", 1)
        _pngs_close(j_root / f"view_{i}" / "jitter", t_root / f"view_{i}" / "jitter", 2)


def test_render_video_with_a_style_matches_jax(tmp_path, rng, monkeypatch):
    """The ellipse video of a style-conditioned model (the style embedding
    through each package's VGG, one shared weight cache): the frames and a
    readable mp4 of as many frames."""
    cv2 = pytest.importorskip("cv2")
    from PIL import Image

    from aip_tpu.models import vgg as jvgg
    from aip_tpu.models import weights as jweights
    from aip_tpu_torch.models import weights as tweights

    wdir = tmp_path / "w"
    jweights.save_params_npz(jvgg.init_vgg_params(jax.random.PRNGKey(0)),
                             wdir / "vgg_normalised.npz")
    monkeypatch.setattr(jweights, "DEFAULT_WEIGHTS_DIR", wdir)
    monkeypatch.setattr(tweights, "DEFAULT_WEIGHTS_DIR", wdir)
    style = tmp_path / "style.png"
    Image.fromarray((rng.random((32, 32, 3)) * 255).astype(np.uint8)).save(style)
    model = _tiny_model(tmp_path, rng, n_views=3, style_dim=256)

    j_mp4 = JRV.render_video(str(model), str(style), n_frames=4, fps=5)
    _moved(Path(j_mp4).parent / "ellipse", tmp_path / "j")
    t_mp4 = TRV.render_video(str(model), str(style), n_frames=4, fps=5, device="cpu")
    assert t_mp4 == str(model / "video" / "ellipse.mp4")
    _pngs_close(tmp_path / "j", model / "video" / "ellipse", 4)
    cap = cv2.VideoCapture(t_mp4)
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    assert n == 4
    with pytest.raises(NotImplementedError, match="slice 6"):
        TRV.render_video(str(model), str(style), n_frames=2, mesh_dp=2, device="cpu")


def test_render_video_cli_main_runs_every_mode(model, capsys):
    """cli.render_video.main with --video (where cv2 imports), --circular
    and --gaussians on the CPU: one output each, printed."""
    from aip_tpu_torch.cli import render_video as cli

    args = ["-m", str(model), "--circular", "--gaussians", "--n_frames", "2", "--std", "0.02",
            "--device", "cpu"]
    try:
        import cv2  # noqa: F401
        args.append("--video")
    except ImportError:
        pass
    outs = cli.main(args)
    printed = capsys.readouterr().out
    assert len(outs) == 2 + ("--video" in args)
    for o in outs:
        assert Path(o).exists() and o in printed
    assert len(list((model / "circular").glob("*.png"))) == 2
    assert (model / "video" / "gaussians_std0.02" / "view_2" / "jitter").is_dir()
    with pytest.raises(NotImplementedError, match="slice 6"):
        cli.main(["-m", str(model), "--video", "--mesh_dp", "2", "--device", "cpu"])


def test_entry_points_default_to_the_card(model, monkeypatch):
    """device=None means CUDA: without a card the renderers raise before
    loading anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (TRV.render_circular_video, TRV.gaussian_render):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(str(model))
