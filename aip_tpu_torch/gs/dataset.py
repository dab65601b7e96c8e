"""Scene loading: COLMAP & Blender readers, PLY IO, the Scene container.

A copy of ``aip_tpu/gs/dataset.py`` (host code; the port imports nothing
of the JAX package). Parity with reference `Style_3DGS/scene/dataset_readers.py` and
`scene/__init__.py`:
* ``read_colmap_scene`` (:132-177) — PINHOLE/SIMPLE_PINHOLE cameras, llffhold
  eval split (every 8th), nerf++ normalization (center + 1.1x diagonal);
* ``read_blender_scene`` (:229-263) — transforms_train.json, OpenGL->COLMAP
  axis flip, alpha-composite onto bg, 100k random init points;
* minimal binary-little-endian PLY read/write (plyfile replacement);
* ``Scene`` (scene/__init__.py:26-107) — auto-detect loader, shuffled train
  cameras, ``cameras_extent``, resolution-scaled camera loading
  (camera_utils.py:19-52 downscale rules incl. the 1.6K auto-rescale).
"""

from __future__ import annotations

import json
import os
import random
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import NamedTuple

import numpy as np

from aip_tpu_torch.gs import colmap
from aip_tpu_torch.gs.cameras import Camera, focal2fov, fov2focal, get_world2view2


@dataclass
class BasicPointCloud:
    points: np.ndarray
    colors: np.ndarray
    normals: np.ndarray


class CameraInfo(NamedTuple):
    uid: int
    R: np.ndarray
    T: np.ndarray
    FovY: float
    FovX: float
    image: "object"
    image_path: str
    image_name: str
    width: int
    height: int


class SceneInfo(NamedTuple):
    point_cloud: BasicPointCloud
    train_cameras: list
    test_cameras: list
    nerf_normalization: dict
    ply_path: str


# ---------------------------------------------------------------------------
# PLY IO (binary little-endian, vertex x/y/z nx/ny/nz red/green/blue)
# ---------------------------------------------------------------------------

_PLY_TYPES = {
    "float": ("f4", 4), "float32": ("f4", 4), "double": ("f8", 8),
    "uchar": ("u1", 1), "uint8": ("u1", 1), "int": ("i4", 4),
    "uint": ("u4", 4), "short": ("i2", 2), "ushort": ("u2", 2), "char": ("i1", 1),
}


def read_ply(path):
    """Minimal PLY reader -> {prop_name: np.ndarray} for the vertex element."""
    with open(path, "rb") as f:
        assert f.readline().strip() == b"ply"
        fmt = f.readline().split()[1]
        n_vertex = 0
        props = []
        while True:
            line = f.readline().split()
            if line[0] == b"end_header":
                break
            if line[0] == b"element" and line[1] == b"vertex":
                n_vertex = int(line[2])
            elif line[0] == b"property" and n_vertex:
                props.append((line[2].decode(), _PLY_TYPES[line[1].decode()][0]))
        if fmt == b"ascii":
            data = np.loadtxt(f, max_rows=n_vertex)
            return {name: data[:, i] for i, (name, _) in enumerate(props)}
        dtype = np.dtype([(name, ("<" if b"little" in fmt else ">") + t) for name, t in props])
        arr = np.frombuffer(f.read(dtype.itemsize * n_vertex), dtype=dtype)
        return {name: np.ascontiguousarray(arr[name]) for name, _ in props}


def write_ply(path, xyz: np.ndarray, rgb: np.ndarray = None, extra: dict = None) -> None:
    """Minimal binary PLY writer (storePly parity when rgb given)."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    cols = [("x", xyz[:, 0], "float"), ("y", xyz[:, 1], "float"), ("z", xyz[:, 2], "float")]
    normals = np.zeros_like(xyz)
    cols += [("nx", normals[:, 0], "float"), ("ny", normals[:, 1], "float"), ("nz", normals[:, 2], "float")]
    if rgb is not None:
        rgb = rgb.astype(np.uint8)
        cols += [("red", rgb[:, 0], "uchar"), ("green", rgb[:, 1], "uchar"), ("blue", rgb[:, 2], "uchar")]
    if extra:
        cols += [(k, v, "float") for k, v in extra.items()]
    dtype = np.dtype([
        (name, {"float": "<f4", "uchar": "u1"}[t]) for name, _, t in cols
    ])
    arr = np.empty(xyz.shape[0], dtype=dtype)
    for name, v, _ in cols:
        arr[name] = v
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {xyz.shape[0]}\n".encode())
        for name, _, t in cols:
            f.write(f"property {t} {name}\n".encode())
        f.write(b"end_header\n")
        f.write(arr.tobytes())


def fetch_ply(path) -> BasicPointCloud:
    d = read_ply(path)
    pts = np.stack([d["x"], d["y"], d["z"]], axis=1)
    colors = np.stack([d["red"], d["green"], d["blue"]], axis=1) / 255.0
    normals = (
        np.stack([d["nx"], d["ny"], d["nz"]], axis=1)
        if "nx" in d else np.zeros_like(pts)
    )
    return BasicPointCloud(pts, colors, normals)


# ---------------------------------------------------------------------------
# Scene readers
# ---------------------------------------------------------------------------

def get_nerfpp_norm(cam_infos) -> dict:
    """dataset_readers.py:45-66 parity."""
    centers = []
    for cam in cam_infos:
        w2c = get_world2view2(cam.R, cam.T)
        centers.append(np.linalg.inv(w2c)[:3, 3:4])
    centers = np.hstack(centers)
    avg = centers.mean(axis=1, keepdims=True)
    diagonal = np.max(np.linalg.norm(centers - avg, axis=0))
    return {"translate": -avg.flatten(), "radius": diagonal * 1.1}


def _read_colmap_cameras(extrinsics, intrinsics, images_folder):
    from PIL import Image

    infos = []
    for key in extrinsics:
        extr = extrinsics[key]
        intr = intrinsics[extr.camera_id]
        R = np.transpose(colmap.qvec2rotmat(extr.qvec))
        T = np.array(extr.tvec)
        if intr.model == "SIMPLE_PINHOLE":
            fx = intr.params[0]
            fovy = focal2fov(fx, intr.height)
            fovx = focal2fov(fx, intr.width)
        elif intr.model == "PINHOLE":
            fovy = focal2fov(intr.params[1], intr.height)
            fovx = focal2fov(intr.params[0], intr.width)
        else:
            raise ValueError(f"unsupported COLMAP camera model {intr.model} (undistort first)")
        image_path = os.path.join(images_folder, os.path.basename(extr.name))
        infos.append(CameraInfo(
            uid=intr.id, R=R, T=T, FovY=fovy, FovX=fovx,
            image=Image.open(image_path), image_path=image_path,
            image_name=Path(image_path).stem, width=intr.width, height=intr.height,
        ))
    return infos


def read_colmap_scene(path, images="images", eval_split=False, llffhold=8) -> SceneInfo:
    sparse = Path(path) / "sparse" / "0"
    cams, imgs, (xyz, rgb, _err) = colmap.read_model(sparse)
    cam_infos = sorted(_read_colmap_cameras(imgs, cams, str(Path(path) / images)),
                       key=lambda c: c.image_name)
    if eval_split:
        train = [c for i, c in enumerate(cam_infos) if i % llffhold != 0]
        test = [c for i, c in enumerate(cam_infos) if i % llffhold == 0]
    else:
        train, test = cam_infos, []

    ply_path = str(Path(path) / "sparse" / "0" / "points3D.ply")
    if not os.path.exists(ply_path):
        write_ply(ply_path, xyz, rgb)
    pcd = fetch_ply(ply_path)
    return SceneInfo(pcd, train, test, get_nerfpp_norm(train), ply_path)


def read_blender_scene(path, white_background=False, eval_split=False,
                       extension=".png") -> SceneInfo:
    from PIL import Image

    from aip_tpu_torch.ops.sh import sh_to_rgb

    with open(Path(path) / "transforms_train.json") as f:
        contents = json.load(f)
    fovx = contents["camera_angle_x"]
    infos = []
    for idx, frame in enumerate(contents["frames"]):
        rel = frame["file_path"]
        img_path = Path(path) / (rel.lstrip("./") + extension)
        if not img_path.exists():
            # Some capture sets store machine-absolute (even Windows)
            # file_path entries (e.g. input/3dgs/bathtub_0121); recover by
            # basename next to the json.
            base = rel.replace("\\", "/").rstrip("/").rsplit("/", 1)[-1]
            img_path = Path(path) / (base + extension)
        c2w = np.array(frame["transform_matrix"])
        c2w[:3, 1:3] *= -1  # OpenGL -> COLMAP axes
        w2c = np.linalg.inv(c2w)
        R = np.transpose(w2c[:3, :3])
        T = w2c[:3, 3]
        image = Image.open(img_path)
        data = np.array(image.convert("RGBA")) / 255.0
        bg = np.ones(3) if white_background else np.zeros(3)
        arr = data[:, :, :3] * data[:, :, 3:4] + bg * (1 - data[:, :, 3:4])
        image = Image.fromarray((arr * 255).astype(np.uint8), "RGB")
        fovy = focal2fov(fov2focal(fovx, image.size[0]), image.size[1])
        infos.append(CameraInfo(idx, R, T, fovy, fovx, image, str(img_path),
                                img_path.stem, image.size[0], image.size[1]))

    ply_path = str(Path(path) / "points3d.ply")
    if not os.path.exists(ply_path):
        if not os.access(path, os.W_OK):
            # Read-only source dir (e.g. the reference inputs): cache the
            # random init cloud under a per-scene tmp path instead.
            import hashlib
            import tempfile

            tag = hashlib.sha1(str(Path(path).resolve()).encode()).hexdigest()[:12]
            ply_path = str(Path(tempfile.gettempdir()) / f"aip_points3d_{tag}.ply")
        if not os.path.exists(ply_path):
            # Deterministic local generator, NOT the global np.random the
            # reference uses (`dataset_readers.py:253-256` under safe_state's
            # seed): library behavior must not depend on ambient RNG state —
            # a drifting global state made test data execution-order-
            # dependent.
            rng = np.random.default_rng(0)
            num_pts = 100_000
            xyz = rng.random((num_pts, 3)) * 2.6 - 1.3
            shs = rng.random((num_pts, 3)) / 255.0
            write_ply(ply_path, xyz, np.asarray(sh_to_rgb(shs)) * 255)
    pcd = fetch_ply(ply_path)
    return SceneInfo(pcd, infos, [], get_nerfpp_norm(infos), ply_path)


# ---------------------------------------------------------------------------
# Camera loading at working resolution (camera_utils.py parity)
# ---------------------------------------------------------------------------

WARNED = [False]


def load_camera(info: CameraInfo, resolution_scale: float = 1.0, resolution: int = -1,
                uid: int = 0) -> Camera:
    """camera_utils.py:19-52: downscale rules, incl. >1.6K auto-rescale."""
    orig_w, orig_h = info.image.size
    if resolution in (1, 2, 4, 8):
        scale = resolution_scale * resolution
        res = (round(orig_w / scale), round(orig_h / scale))
    else:
        if resolution == -1:
            if orig_w > 1600:
                if not WARNED[0]:
                    WARNED[0] = True
                global_down = orig_w / 1600
            else:
                global_down = 1
        else:
            global_down = orig_w / resolution
        scale = float(global_down) * resolution_scale
        res = (int(orig_w / scale), int(orig_h / scale))

    resized = info.image.resize(res)
    arr = np.asarray(resized, np.float32) / 255.0
    alpha = None
    if arr.ndim == 3 and arr.shape[2] == 4:
        alpha = arr[..., 3]
        arr = arr[..., :3]
    return Camera(
        colmap_id=info.uid, R=info.R, T=info.T, FoVx=info.FovX, FoVy=info.FovY,
        image=arr, gt_alpha_mask=alpha, image_name=info.image_name, uid=uid,
    )


class Scene:
    """Scene container (scene/__init__.py parity, sans GUI/network concerns)."""

    def __init__(self, source_path, images="images", white_background=False,
                 eval_split=False, resolution=-1, shuffle=True,
                 resolution_scales=(1.0,)):
        if os.path.exists(os.path.join(source_path, "sparse")):
            self.scene_info = read_colmap_scene(source_path, images, eval_split)
        elif os.path.exists(os.path.join(source_path, "transforms_train.json")):
            self.scene_info = read_blender_scene(source_path, white_background, eval_split)
        else:
            raise ValueError(f"Could not recognize scene type for {source_path}")

        if shuffle:
            random.shuffle(self.scene_info.train_cameras)
            random.shuffle(self.scene_info.test_cameras)

        self.cameras_extent = self.scene_info.nerf_normalization["radius"]
        self.train_cameras = {}
        self.test_cameras = {}
        for scale in resolution_scales:
            self.train_cameras[scale] = [
                load_camera(c, scale, resolution, uid=i)
                for i, c in enumerate(self.scene_info.train_cameras)
            ]
            self.test_cameras[scale] = [
                load_camera(c, scale, resolution, uid=i)
                for i, c in enumerate(self.scene_info.test_cameras)
            ]

    @property
    def point_cloud(self) -> BasicPointCloud:
        return self.scene_info.point_cloud

    def getTrainCameras(self, scale=1.0):
        return self.train_cameras[scale]

    def getTestCameras(self, scale=1.0):
        return self.test_cameras[scale]
