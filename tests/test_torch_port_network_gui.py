"""The port's remote-viewer bridge (``gs/network_gui.py``) and its poll in
``gs.train.train`` against aip_tpu's, on the CPU, over loopback sockets.

* The protocol: one JSON request (non-identity matrices) decoded by each
  package's ``NetworkGUI`` into equal ``MiniCam``s (matrices bit for bit,
  the camera centre within 1e-6, one float32 inverse in each), the same
  bytes sent back, resolution 0 and a viewer that hangs up mid-message
  handled alike.
* The viewer's frame: a JAX trainer's state carried across with
  ``from_jax_arrays``, rendered by each package from the camera its
  ``receive`` decoded (``mode="inference"``, scaling modifier 0.8), at 16^2
  (the differentiable rasterizer) and 512^2 (the macro-block path, the
  plain compositors on the CPU): uint8 frames within 1 level (float32
  renders of one state, summed in another order, may straddle a rounding
  edge).
* The loop: the port's ``train`` with a loopback viewer connected before it
  starts, one view a step and two, and a viewer that hangs up.
"""

import functools
import json
import socket
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from aip_tpu.gs import network_gui as JN
from aip_tpu.gs import rasterizer as JR
from aip_tpu.gs import train as JT
from aip_tpu.gs.dataset import Scene as JScene
from aip_tpu.gs.rasterizer import RasterSettings as JRS
from aip_tpu.gs.render import render as jrender
from aip_tpu_torch.gs import network_gui as TN
from aip_tpu_torch.gs import train as TT
from aip_tpu_torch.gs.dataset import Scene as TScene
from aip_tpu_torch.gs.rasterizer import RasterSettings as TRS
from aip_tpu_torch.gs.render import render as trender
from aip_tpu_torch.gs.state import from_jax_arrays

torch.set_num_threads(2)

VIEW = np.array([[0.8, -0.36, 0.48, 0.0], [0.0, 0.8, 0.6, 0.0], [-0.6, -0.48, 0.64, 0.0],
                 [0.1, -0.2, 3.0, 1.0]])
PROJ = np.array([[1.7, 0.1, 0.0, 0.0], [0.0, 1.9, 0.2, 0.0], [0.05, 0.0, 1.0001, 1.0],
                 [0.0, 0.0, -0.010001, 0.3]])


def _message(width=24, height=16, view=VIEW, proj=PROJ, keep_alive=1, scaling=0.8):
    return {"resolution_x": width, "resolution_y": height, "train": 1, "fov_y": 0.7,
            "fov_x": 0.9, "z_near": 0.01, "z_far": 100.0, "shs_python": 0,
            "rot_scale_python": 0, "keep_alive": keep_alive, "scaling_modifier": scaling,
            "view_matrix": [float(v) for v in np.ravel(view)],
            "view_projection_matrix": [float(v) for v in np.ravel(proj)]}


def _frame(payload: dict) -> bytes:
    data = json.dumps(payload).encode()
    return len(data).to_bytes(4, "little") + data


def _recv_exact(s, n):
    buf = b""
    while len(buf) < n:
        chunk = s.recv(n - len(buf))
        if not chunk:
            raise ConnectionError
        buf += chunk
    return buf


def _accept(gui):
    for _ in range(200):
        gui.try_connect()
        if gui.conn is not None:
            return
        time.sleep(0.01)
    raise AssertionError("the viewer never connected")


def _exchange(mod, raw: bytes, reply=None, reply_len=0):
    """Connect a client to ``mod.NetworkGUI(port=0)``, send ``raw``, let the
    server ``receive`` and (if ``reply``) ``send(*reply)``; returns what
    ``receive`` returned (or raised) and the bytes the client read."""
    gui = mod.NetworkGUI(port=0)
    port = gui.listener.getsockname()[1]
    got = {}

    def client():
        with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
            s.sendall(raw)
            if reply is not None:
                got["bytes"] = _recv_exact(s, reply_len)

    t = threading.Thread(target=client, daemon=True)
    t.start()
    try:
        _accept(gui)
        try:
            out = gui.receive()
        except ConnectionError as e:
            out = e
        if reply is not None:
            gui.send(*reply)
        t.join(timeout=10)
        assert not t.is_alive()
    finally:
        gui.close()
    return out, got.get("bytes")


def test_receive_decodes_the_same_camera_and_send_writes_the_same_bytes():
    rng = np.random.default_rng(0)
    frame = rng.integers(0, 256, (16, 24, 3), dtype=np.uint8)
    verify = "scene/points3d.ply"
    n = frame.nbytes + 4 + len(verify)
    (jcam, *jflags), jbytes = _exchange(JN, _frame(_message()), (frame, verify), n)
    (tcam, *tflags), tbytes = _exchange(TN, _frame(_message()), (frame, verify), n)
    assert jflags == tflags == [True, True, 0.8]
    for f in ("image_width", "image_height", "FoVy", "FoVx", "znear", "zfar"):
        assert getattr(tcam, f) == getattr(jcam, f), f
    for f in ("world_view_transform", "full_proj_transform"):
        a, b = getattr(tcam, f), getattr(jcam, f)
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b), f
    # The Y/Z sign flips: view columns 1-2, projection column 1.
    np.testing.assert_array_equal(tcam.world_view_transform[:, 1:3],
                                  -VIEW[:, 1:3].astype(np.float32))
    np.testing.assert_array_equal(tcam.full_proj_transform[:, 1], -PROJ[:, 1].astype(np.float32))
    np.testing.assert_allclose(tcam.camera_center, jcam.camera_center, atol=1e-6)
    assert tbytes == jbytes
    assert tbytes[:frame.nbytes] == frame.tobytes()
    assert tbytes[frame.nbytes:frame.nbytes + 4] == len(verify).to_bytes(4, "little")


def test_send_without_a_frame_writes_the_same_bytes():
    out = [_exchange(mod, _frame(_message(0, 0)), (None, "v"), 5) for mod in (JN, TN)]
    assert out[0][0] == out[1][0] == (None, None, None, None)
    assert out[0][1] == out[1][1] == (1).to_bytes(4, "little") + b"v"


def test_a_viewer_that_hangs_up_mid_message_raises_connection_error():
    raw = _frame(_message())
    for cut in (2, 4, len(raw) // 2):
        res = [_exchange(mod, raw[:cut])[0] for mod in (JN, TN)]
        assert all(isinstance(r, ConnectionError) for r in res), (cut, res)


def test_try_connect_without_a_viewer_and_close():
    gui = TN.NetworkGUI(port=0)
    gui.try_connect()
    assert gui.conn is None
    gui.disconnect()
    gui.close()


# ---------------------------------------------------------------------------
# The viewer's frame, both packages from one JAX state
# ---------------------------------------------------------------------------

def _blender_scene(root, size=32, n_views=2):
    (root / "images").mkdir(parents=True)
    frames = []
    for i in range(n_views):
        angle = i * 2 * np.pi / n_views
        c2w = np.eye(4)
        c2w[0, 3] = 3 * np.sin(angle)
        c2w[2, 3] = 3 * np.cos(angle)
        frames.append({"file_path": f"./images/r_{i}", "transform_matrix": c2w.tolist()})
        img = np.zeros((size, size, 4), np.uint8)
        img[8:24, 8:24] = (200, 40, 0, 255)
        img[12:20, 12:20, 1] = 180
        img[..., 3] = 255
        Image.fromarray(img).save(root / "images" / f"r_{i}.png")
    (root / "transforms_train.json").write_text(
        json.dumps({"camera_angle_x": 0.8, "frames": frames}))
    return str(root)


@pytest.fixture(scope="module")
def jax_state(tmp_path_factory):
    rng = np.random.default_rng(5)
    scene = JScene(_blender_scene(tmp_path_factory.mktemp("scene")), shuffle=False)
    pcd = scene.point_cloud
    cfg = JT.GSTrainConfig(capacity=256, log2_hashmap=12, style_dim=256)
    jtr = JT.init_trainer(cfg, pcd.points[:200], pcd.colors[:200], scene.cameras_extent)
    gs = jtr.gstate
    jtr = jtr._replace(gstate=gs._replace(
        scaling=gs.scaling + jnp.asarray(rng.normal(0, 0.2, (256, 3)), jnp.float32),
        rotation=jnp.asarray(rng.standard_normal((256, 4)), jnp.float32)))
    style = (rng.standard_normal((1, 512)) * 0.3).astype(np.float32)
    return scene.getTrainCameras()[0], jtr, style


def _viewer_message(cam, size):
    """The request a viewer sends for ``cam`` at ``size``^2: the matrices
    with the signs ``receive`` flips already flipped."""
    view = np.array(cam.world_view_transform, np.float64)
    view[:, 1:3] *= -1
    proj = np.array(cam.full_proj_transform, np.float64)
    proj[:, 1] *= -1
    return _frame({**_message(size, size, view, proj), "fov_x": cam.FoVx, "fov_y": cam.FoVy})


def _u8(img):
    return (np.clip(np.asarray(img), 0, 1) * 255).astype(np.uint8)


@pytest.mark.parametrize("size", [16, 512])
def test_the_viewer_frame_matches_jax(jax_state, size, monkeypatch):
    cam, jtr, style = jax_state
    # From 512^2 up aip_tpu's render takes rasterize_matmul, whose Pallas
    # compositor runs on the CPU in interpret mode, as aip_tpu's tests run it.
    monkeypatch.setattr(JR, "rasterize_matmul",
                        functools.partial(JR.rasterize_matmul, interpret=True))
    raw = _viewer_message(cam, size)
    (jcam, _, _, jscale), _ = _exchange(JN, raw)
    (tcam, _, _, tscale), _ = _exchange(TN, raw)
    np.testing.assert_array_equal(tcam.world_view_transform, cam.world_view_transform)
    bg = np.zeros(3, np.float32)
    jout = jrender(jcam, jtr.gstate, jtr.field, jnp.asarray(bg), style_f=jnp.asarray(style),
                   mode="inference", scaling_modifier=jscale,
                   settings=JRS(size, size, max_per_tile=128))
    ts, tf = from_jax_arrays({k: np.asarray(v) for k, v in jtr.gstate._asdict().items()},
                             {k: None if v is None else np.asarray(v)
                              for k, v in jtr.field._asdict().items()}, "cpu")
    tout = trender(tcam, ts, tf, torch.from_numpy(bg), style_f=torch.from_numpy(style),
                   mode="inference", scaling_modifier=tscale,
                   settings=TRS(size, size, max_per_tile=128))
    jimg, timg = _u8(jout.render), _u8(tout.render.numpy())
    assert jimg.shape == timg.shape == (size, size, 3)
    assert (jimg > 0).mean() > 0.05     # the splats are in view
    diff = np.abs(jimg.astype(int) - timg.astype(int))
    assert diff.max() <= 1, (diff.max(), (diff > 0).mean())


# ---------------------------------------------------------------------------
# The poll in train
# ---------------------------------------------------------------------------

@pytest.fixture
def weights_dir(tmp_path, monkeypatch):
    from aip_tpu_torch.models import weights as tweights

    monkeypatch.setattr(tweights, "DEFAULT_WEIGHTS_DIR", tmp_path / "w")
    return tmp_path / "w"


def _tiny_scene(tmp_path, rng):
    """aip_tpu's viewer-test scene (a red square, 60 points) seen from a
    second camera half a unit aside: with one camera the scene's extent is
    0, and in both packages the first step then turns the state to NaN."""
    (tmp_path / "scene" / "images").mkdir(parents=True)
    img = np.zeros((32, 32, 4), np.uint8)
    img[..., 3] = 255
    img[8:24, 8:24] = (200, 0, 0, 255)
    frames = []
    for i, x in enumerate((0.0, 0.5)):
        c2w = np.eye(4)
        c2w[0, 3], c2w[2, 3] = x, 3.0
        frames.append({"file_path": f"./images/r_{i}", "transform_matrix": c2w.tolist()})
        Image.fromarray(img).save(tmp_path / "scene" / "images" / f"r_{i}.png")
    (tmp_path / "scene" / "transforms_train.json").write_text(json.dumps(
        {"camera_angle_x": 0.8, "frames": frames}))
    Image.fromarray((rng.random((32, 32, 3)) * 255).astype(np.uint8)).save(tmp_path / "s.png")
    scene = TScene(str(tmp_path / "scene"), shuffle=False)
    assert scene.cameras_extent > 0
    scene.scene_info.point_cloud.points = scene.scene_info.point_cloud.points[:60]
    scene.scene_info.point_cloud.colors = scene.scene_info.point_cloud.colors[:60]
    return scene


def _cfg(**kw):
    return TT.GSTrainConfig(**{**dict(
        iterations=3, freeze_iters=2, capacity=64, max_per_tile=16, raster_chunk=64,
        densify_from_iter=100, log2_hashmap=10, rvq_size=8, rvq_num=2, net_lr_step=(100,),
        style_dim=0), **kw})


class _Viewer:
    """A loopback viewer: connects at once, then sends ``requests`` one at
    a time, reading each frame and verify string, until the trainer stops
    answering (its listener closes)."""

    def __init__(self, gui, requests, size=16):
        self.sock = socket.create_connection(("127.0.0.1", gui.listener.getsockname()[1]),
                                             timeout=60)
        self.requests, self.size = requests, size
        self.frames, self.verify = [], []
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        try:
            for req in self.requests:
                self.sock.sendall(req)
                self.frames.append(_recv_exact(self.sock, self.size * self.size * 3))
                n = int.from_bytes(_recv_exact(self.sock, 4), "little")
                self.verify.append(_recv_exact(self.sock, n).decode())
        except (ConnectionError, OSError):
            pass
        finally:
            self.sock.close()

    def join(self):
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()


def _identity_request(keep_alive):
    return _frame(_message(16, 16, np.eye(4), np.eye(4), keep_alive=keep_alive, scaling=1.0))


def test_train_serves_a_connected_viewer(tmp_path, rng, weights_dir):
    """The first loop pass serves the viewer (connected before train
    starts) a 16^2 frame of the initial state, and the scene's ply path;
    keep_alive 0 drops it."""
    scene = _tiny_scene(tmp_path, rng)
    cfg = _cfg()
    gui = TN.NetworkGUI(port=0)
    viewer = _Viewer(gui, [_identity_request(0), _identity_request(0)])
    try:
        trainer, _ = TT.train(scene, str(tmp_path / "s.png"), cfg, img_size=32,
                              guide_dir=str(tmp_path / "g"), network_gui=gui, device="cpu")
    finally:
        gui.close()
    viewer.join()
    assert len(viewer.frames) == 1 and len(viewer.frames[0]) == 16 * 16 * 3
    assert viewer.verify == [scene.scene_info.ply_path]
    assert gui.conn is None and int(trainer.step) == 3
    # The frame is the inference render of the state train starts from.
    pcd = scene.point_cloud
    start = TT.init_trainer(cfg, pcd.points, pcd.colors, scene.cameras_extent, 0, device="cpu")
    view, proj = np.eye(4, dtype=np.float32), np.eye(4, dtype=np.float32)
    view[:, 1:3] *= -1
    proj[:, 1] *= -1
    cam = TN.MiniCam(16, 16, 0.7, 0.9, 0.01, 100.0, view, proj)
    ref = trender(cam, start.gstate, start.field, torch.zeros(3), mode="inference",
                  settings=TRS(16, 16, max_per_tile=cfg.max_per_tile)).render
    assert viewer.frames[0] == _u8(ref.numpy()).tobytes()


@pytest.mark.parametrize("views_per_step,passes", [(1, 4), (2, 2)])
def test_train_serves_one_frame_a_loop_pass(tmp_path, rng, weights_dir, views_per_step, passes):
    """With keep_alive the viewer gets one frame each loop pass: each
    iteration at one view a step, each two-view window at two."""
    scene = _tiny_scene(tmp_path, rng)
    gui = TN.NetworkGUI(port=0)
    viewer = _Viewer(gui, [_identity_request(1)] * 8)
    try:
        trainer, _ = TT.train(scene, str(tmp_path / "s.png"), _cfg(iterations=4), img_size=32,
                              guide_dir=str(tmp_path / "g"), network_gui=gui,
                              views_per_step=views_per_step, device="cpu")
        assert gui.conn is not None     # kept alive
    finally:
        gui.close()
    viewer.join()
    assert all(bool(torch.isfinite(t).all()) for t in trainer.gstate if t.is_floating_point())
    assert len(viewer.frames) == passes
    assert viewer.verify == [scene.scene_info.ply_path] * passes


def test_train_goes_on_when_the_viewer_hangs_up(tmp_path, rng, weights_dir):
    scene = _tiny_scene(tmp_path, rng)
    gui = TN.NetworkGUI(port=0)
    sock = socket.create_connection(("127.0.0.1", gui.listener.getsockname()[1]), timeout=10)
    sock.sendall(_identity_request(1)[:10])
    sock.close()
    try:
        with pytest.warns(RuntimeWarning, match="remote viewer dropped"):
            trainer, _ = TT.train(scene, str(tmp_path / "s.png"), _cfg(), img_size=32,
                                  guide_dir=str(tmp_path / "g"), network_gui=gui,
                                  device="cpu")
    finally:
        gui.close()
    assert gui.conn is None and int(trainer.step) == 3
