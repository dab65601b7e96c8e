"""Cameras and projection math for Gaussian splatting.

A copy of ``aip_tpu/gs/cameras.py`` (host numpy; the port imports nothing
of the JAX package). Parity with reference `Style_3DGS/scene/cameras.py` and
`utils/graphics_utils.py:30-78`: world-to-view from (R, t) with optional
recentering, OpenGL-style perspective projection with z_sign=+1, matrices
stored TRANSPOSED (row-vector convention: ``p_hom = p @ M``), camera center
from the inverse view transform. All host-side numpy; the render path
consumes plain arrays.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np


def get_world2view2(R: np.ndarray, t: np.ndarray,
                    translate=np.zeros(3), scale: float = 1.0) -> np.ndarray:
    """graphics_utils.py:38-49: world->view with camera-center recentering."""
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = R.transpose()
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    C2W = np.linalg.inv(Rt)
    cam_center = (C2W[:3, 3] + translate) * scale
    C2W[:3, 3] = cam_center
    return np.float32(np.linalg.inv(C2W))


def get_projection_matrix(znear: float, zfar: float, fovx: float, fovy: float) -> np.ndarray:
    """graphics_utils.py:51-71 parity (note the sign conventions)."""
    tan_y = math.tan(fovy / 2)
    tan_x = math.tan(fovx / 2)
    top, right = tan_y * znear, tan_x * znear
    bottom, left = -top, -right
    P = np.zeros((4, 4), np.float32)
    P[0, 0] = 2.0 * znear / (right - left)
    P[1, 1] = 2.0 * znear / (top - bottom)
    P[0, 2] = (right + left) / (right - left)
    P[1, 2] = (top + bottom) / (top - bottom)
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def fov2focal(fov: float, pixels: int) -> float:
    return pixels / (2 * math.tan(fov / 2))


def focal2fov(focal: float, pixels: int) -> float:
    return 2 * math.atan(pixels / (2 * focal))


@dataclass
class Camera:
    """A posed training/eval camera (scene/cameras.py:17-57 parity).

    ``image`` is [H, W, 3] float32 in [0,1] (NHWC, unlike the
    reference's CHW); matrices are stored transposed (row-vector form).
    """

    colmap_id: int
    R: np.ndarray
    T: np.ndarray
    FoVx: float
    FoVy: float
    image: np.ndarray
    image_name: str
    uid: int
    gt_alpha_mask: np.ndarray | None = None
    trans: np.ndarray = field(default_factory=lambda: np.zeros(3))
    scale: float = 1.0
    znear: float = 0.01
    zfar: float = 100.0

    def __post_init__(self):
        self.image = np.clip(self.image, 0.0, 1.0).astype(np.float32)
        if self.gt_alpha_mask is not None:
            self.image = self.image * self.gt_alpha_mask[..., None]
        self.image_height, self.image_width = self.image.shape[:2]
        self.world_view_transform = get_world2view2(self.R, self.T, self.trans, self.scale).T
        self.projection_matrix = get_projection_matrix(self.znear, self.zfar, self.FoVx, self.FoVy).T
        self.full_proj_transform = self.world_view_transform @ self.projection_matrix
        self.camera_center = np.linalg.inv(self.world_view_transform)[3, :3]


@dataclass
class MiniCam:
    """Viewer camera without an image (scene/cameras.py:59-71 parity)."""

    image_width: int
    image_height: int
    FoVy: float
    FoVx: float
    znear: float
    zfar: float
    world_view_transform: np.ndarray
    full_proj_transform: np.ndarray

    def __post_init__(self):
        self.camera_center = np.linalg.inv(self.world_view_transform)[3, :3]
