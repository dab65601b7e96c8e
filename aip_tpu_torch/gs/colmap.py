"""COLMAP sparse-reconstruction reader (binary and text models).

A copy of ``aip_tpu/gs/colmap.py`` (host code). Functional parity with
reference `Style_3DGS/scene/colmap_loader.py` — reads ``cameras.bin/.txt``, ``images.bin/.txt``, ``points3D.bin/.txt`` per the
COLMAP model format spec. Host-side, pure Python + numpy.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np

# COLMAP camera model ids -> (name, num_params).
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


@dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str
    xys: np.ndarray
    point3D_ids: np.ndarray


def qvec2rotmat(qvec: np.ndarray) -> np.ndarray:
    """(w, x, y, z) quaternion -> rotation matrix (colmap_loader.py:43 parity)."""
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _read(fid, fmt):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, fid.read(size))


def read_cameras_binary(path) -> dict:
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, w, h = _read(f, "<iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{n_params}d"))
            cams[cam_id] = ColmapCamera(cam_id, name, int(w), int(h), params)
    return cams


def read_images_binary(path) -> dict:
    images = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            img_id = _read(f, "<i")[0]
            qvec = np.array(_read(f, "<4d"))
            tvec = np.array(_read(f, "<3d"))
            cam_id = _read(f, "<i")[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n_pts,) = _read(f, "<Q")
            # Each POINT2D record is (double x, double y, int64 point3D_id):
            # read with a structured dtype so the id bits are not
            # reinterpreted as a double (-1 would become NaN).
            rec = np.dtype([("xy", "<f8", (2,)), ("id", "<i8")])
            data = np.fromfile(f, rec, count=n_pts)
            xys = data["xy"].reshape(-1, 2)
            ids = data["id"].astype(np.int64)
            images[img_id] = ColmapImage(img_id, qvec, tvec, cam_id, name.decode(), xys, ids)
    return images


def read_points3d_binary(path):
    """Returns (xyz [N,3], rgb [N,3] uint8, errors [N])."""
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        xyz = np.empty((n, 3))
        rgb = np.empty((n, 3), np.uint8)
        err = np.empty(n)
        for i in range(n):
            _pt_id = _read(f, "<Q")[0]
            xyz[i] = _read(f, "<3d")
            rgb[i] = _read(f, "<3B")
            err[i] = _read(f, "<d")[0]
            (track_len,) = _read(f, "<Q")
            f.seek(8 * track_len, 1)
    return xyz, rgb, err


def _iter_text_lines(path):
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                yield line


def read_cameras_text(path) -> dict:
    cams = {}
    for line in _iter_text_lines(path):
        parts = line.split()
        cam_id = int(parts[0])
        cams[cam_id] = ColmapCamera(
            cam_id, parts[1], int(parts[2]), int(parts[3]),
            np.array([float(p) for p in parts[4:]]),
        )
    return cams


def read_images_text(path) -> dict:
    images = {}
    lines = list(_iter_text_lines(path))
    for i in range(0, len(lines), 2):
        parts = lines[i].split()
        img_id = int(parts[0])
        qvec = np.array([float(p) for p in parts[1:5]])
        tvec = np.array([float(p) for p in parts[5:8]])
        cam_id = int(parts[8])
        name = parts[9]
        elems = lines[i + 1].split() if i + 1 < len(lines) else []
        xys = np.array([float(e) for e in elems]).reshape(-1, 3)[:, :2] if elems else np.zeros((0, 2))
        ids = (
            np.array([float(e) for e in elems]).reshape(-1, 3)[:, 2].astype(np.int64)
            if elems else np.zeros(0, np.int64)
        )
        images[img_id] = ColmapImage(img_id, qvec, tvec, cam_id, name, xys, ids)
    return images


def read_points3d_text(path):
    rows = [line.split() for line in _iter_text_lines(path)]
    n = len(rows)
    xyz = np.empty((n, 3))
    rgb = np.empty((n, 3), np.uint8)
    err = np.empty(n)
    for i, parts in enumerate(rows):
        xyz[i] = [float(p) for p in parts[1:4]]
        rgb[i] = [int(p) for p in parts[4:7]]
        err[i] = float(parts[7])
    return xyz, rgb, err


def read_model(sparse_dir):
    """Read binary if present, else text. Returns (cameras, images, points)."""
    d = Path(sparse_dir)
    if (d / "cameras.bin").exists():
        return (
            read_cameras_binary(d / "cameras.bin"),
            read_images_binary(d / "images.bin"),
            read_points3d_binary(d / "points3D.bin"),
        )
    return (
        read_cameras_text(d / "cameras.txt"),
        read_images_text(d / "images.txt"),
        read_points3d_text(d / "points3D.txt"),
    )
