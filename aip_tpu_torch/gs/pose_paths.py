"""Novel-view camera paths for video rendering of trained scenes.

A copy of ``aip_tpu/gs/pose_paths.py`` (host numpy; the port imports
nothing of the JAX package). Functional parity with reference
`Style_3DGS/utils/pose_utils.py` (the subset `render_video.py` uses):
PCA-aligned ellipse path with constant-speed resampling (:261-323), circular
orbit offsets (:464-473), Gaussian pose jitter (:433-461), a spherical
sweep (:475-516), a spherified orbit (:325-390) and a simple spiral path
(:518-551).
"""

from __future__ import annotations

import copy

import numpy as np

from aip_tpu_torch.gs.cameras import get_world2view2


def _normalize(x):
    return x / np.linalg.norm(x)


def viewmatrix(z, up, pos):
    """Camera-to-world 3x4 from forward/up/position (pose_utils.py:10-16)."""
    vec2 = _normalize(z)
    vec1_avg = up
    vec0 = _normalize(np.cross(vec1_avg, vec2))
    vec1 = _normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], 1)


def _poses_from_views(views):
    """Camera-to-world OpenGL-style poses from our Camera objects."""
    poses = []
    for view in views:
        m = np.eye(4)
        m[:3] = np.concatenate([view.R.T, view.T[:, None]], 1)
        m = np.linalg.inv(m)
        m[:, 1:3] *= -1
        poses.append(m)
    return np.stack(poses, 0)


def focus_point_fn(poses):
    """Closest point to all camera z-axes (pose_utils.py:103-110)."""
    directions, origins = poses[:, :3, 2:3], poses[:, :3, 3:4]
    m = np.eye(3) - directions * np.transpose(directions, [0, 2, 1])
    mt_m = np.transpose(m, [0, 2, 1]) @ m
    # pinv: parallel view axes (e.g. straight-line captures) make the normal
    # matrix singular; the least-squares focus point is still well defined.
    return np.squeeze(
        np.linalg.pinv(mt_m.mean(0)) @ (mt_m @ origins).mean(0)
    )


def transform_poses_pca(poses):
    """Align world axes to the PCA of camera positions, scale to fit
    (pose_utils.py:224-258). Returns (new_poses, transform)."""
    t = poses[:, :3, 3]
    t_mean = t.mean(axis=0)
    t = t - t_mean
    # eigh: t^T t is symmetric; guarantees an orthonormal basis even with
    # degenerate eigenvalues (e.g. a perfectly circular capture).
    eigval, eigvec = np.linalg.eigh(t.T @ t)
    inds = np.argsort(eigval)[::-1]
    eigvec = eigvec[:, inds]
    rot = eigvec.T
    if np.linalg.det(rot) < 0:
        rot = np.diag(np.array([1, 1, -1])) @ rot
    transform = np.concatenate([rot, rot @ -t_mean[:, None]], -1)
    poses_recentered = np.einsum("ij,njk->nik", transform,
                                 np.concatenate([poses[:, :3], poses[:, 3:4]], 1))
    poses_recentered = np.concatenate(
        [poses_recentered[:, :3], poses[:, 3:4]], 1)
    if poses_recentered.mean(axis=0)[2, 1] < 0:
        poses_recentered = np.diag(np.array([1, -1, -1, 1]))[None] @ poses_recentered
        transform = np.diag(np.array([1, -1, -1, 1]))[:3] @ np.concatenate(
            [transform, np.array([[0, 0, 0, 1.0]])], 0)
        transform = np.concatenate([transform, np.array([[0, 0, 0, 1.0]])], 0)
    else:
        transform = np.concatenate([transform, np.array([[0, 0, 0, 1.0]])], 0)
    scale = 1.0 / np.max(np.abs(poses_recentered[:, :3, 3]))
    poses_recentered[:, :3, 3] *= scale
    transform = np.diag(np.array([scale] * 3 + [1.0])) @ transform
    return poses_recentered, transform


def generate_ellipse_path(views, n_frames: int = 600, const_speed: bool = True,
                          z_variation: float = 0.0, z_phase: float = 0.0):
    """PCA-aligned elliptical orbit around the scene focus point
    (pose_utils.py:261-323). Returns a list of 4x4 world-to-camera poses."""
    poses = _poses_from_views(views)
    poses, transform = transform_poses_pca(poses)

    center = focus_point_fn(poses)
    offset = np.array([center[0], center[1], center[2] * 0])
    sc = np.percentile(np.abs(poses[:, :3, 3] - offset), 90, axis=0)
    low, high = -sc + offset, sc + offset
    z_low = np.percentile(poses[:, :3, 3], 10, axis=0)
    z_high = np.percentile(poses[:, :3, 3], 90, axis=0)

    def get_positions(theta):
        return np.stack([
            low[0] + (high - low)[0] * (np.cos(theta) * 0.5 + 0.5),
            low[1] + (high - low)[1] * (np.sin(theta) * 0.5 + 0.5),
            z_variation * (z_low[2] + (z_high - z_low)[2]
                           * (np.cos(theta + 2 * np.pi * z_phase) * 0.5 + 0.5)),
        ], -1)

    theta = np.linspace(0, 2 * np.pi, n_frames + 1, endpoint=True)
    positions = get_positions(theta)
    if const_speed:
        # Arc-length reparameterization for near-constant velocity.
        lengths = np.linalg.norm(positions[1:] - positions[:-1], axis=-1)
        cum = np.concatenate([[0], np.cumsum(lengths)])
        cum /= cum[-1]
        theta = np.interp(np.linspace(0, 1, n_frames + 1), cum, theta)
        positions = get_positions(theta)
    positions = positions[:-1]

    avg_up = _normalize(poses[:, :3, 1].mean(0))
    ind_up = np.argmax(np.abs(avg_up))
    up = np.eye(3)[ind_up] * np.sign(avg_up[ind_up])

    render_poses = []
    for p in positions:
        rp = np.eye(4)
        rp[:3] = viewmatrix(p - center, up, p)
        rp = np.linalg.inv(transform) @ rp
        rp[:3, 1:3] *= -1
        render_poses.append(np.linalg.inv(rp))
    return render_poses


def apply_pose(camera, pose4x4):
    """Return a copy of ``camera`` moved to a world-to-camera pose
    (render_video.py:66-69 update rule)."""
    cam = copy.copy(camera)
    R = pose4x4[:3, :3].T
    T = pose4x4[:3, 3]
    cam.world_view_transform = get_world2view2(R, T, camera.trans, camera.scale).T
    cam.full_proj_transform = cam.world_view_transform @ camera.projection_matrix
    cam.camera_center = np.linalg.inv(cam.world_view_transform)[3, :3]
    return cam


def circular_pose(camera, radius: float, angle: float = 0.0):
    """Offset the camera on an xy circle (pose_utils.py:464-473)."""
    cam = copy.copy(camera)
    translate = np.array([radius * np.cos(angle), radius * np.sin(angle), 0.0])
    cam.world_view_transform = get_world2view2(camera.R, camera.T, translate,
                                               camera.scale).T
    cam.full_proj_transform = cam.world_view_transform @ camera.projection_matrix
    cam.camera_center = np.linalg.inv(cam.world_view_transform)[3, :3]
    return cam


def _rot(axis: str, a: float):
    c, s = np.cos(a), np.sin(a)
    if axis == "x":
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    if axis == "y":
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def gaussian_pose(camera, rng: np.random.Generator, mean: float = 0.0,
                  std_translation: float = 0.03, std_rotation: float = 0.01):
    """Random pose jitter (pose_utils.py:433-461)."""
    cam = copy.copy(camera)
    translate = rng.normal(mean, std_translation, 3)
    angles = rng.normal(mean, std_rotation, 3)
    combined = _rot("z", angles[2]) @ _rot("y", angles[1]) @ _rot("x", angles[0])
    rotated_R = camera.R @ combined
    cam.world_view_transform = get_world2view2(rotated_R, camera.T, translate,
                                               camera.scale).T
    cam.full_proj_transform = cam.world_view_transform @ camera.projection_matrix
    cam.camera_center = np.linalg.inv(cam.world_view_transform)[3, :3]
    return cam


def generate_spherical_sample_path(views, azimuthal_rots: float = 1.0,
                                   polar_rots: float = 0.75, n: int = 10):
    """Spherical-coordinate sampling sweep (pose_utils.py:475-516)."""
    poses = _poses_from_views(views)
    c2w = poses.mean(0)
    up = _normalize(poses[:, :3, 1].sum(0))
    rads = np.append(np.percentile(np.abs(poses[:, :3, 3]), 90, 0), 1.0)
    focal_range = np.linspace(0.5, 3, n * n + 1)
    render_poses = []
    index = 0
    for theta in np.linspace(0.0, 2.0 * np.pi * azimuthal_rots, n + 1)[:-1]:
        for phi in np.linspace(0.0, np.pi * polar_rots, n + 1)[:-1]:
            c = c2w[:3, :4] @ (rads * np.array([
                np.sin(phi) * np.cos(theta),
                np.sin(phi) * np.sin(theta),
                np.cos(phi), 1.0,
            ]))
            z = _normalize(c - c2w[:3, :4] @ np.array([0, 0, -focal_range[index], 1.0]))
            rp = np.eye(4)
            rp[:3] = viewmatrix(z, up, c)
            rp[:3, 1:3] *= -1
            render_poses.append(np.linalg.inv(rp))
            index += 1
    return render_poses


def generate_spherify_path(views, n_frames: int = 120):
    """LLFF-style spherified orbit (pose_utils.py:325-390 behavior): recenter
    so cameras sit on a sphere, then orbit at the mean radius/height."""
    poses = _poses_from_views(views)

    # Point minimizing distance to all camera z-axes == new origin.
    center = focus_point_fn(poses)
    positions = poses[:, :3, 3] - center
    radius = np.mean(np.linalg.norm(positions, axis=1))
    up = _normalize(poses[:, :3, 1].mean(0))
    zh = float(np.mean(positions @ up))
    radcircle = max(np.sqrt(max(radius**2 - zh**2, 1e-6)), 1e-3)

    # Orthonormal frame with 'up' as the axis.
    a = np.array([1.0, 0, 0]) if abs(up[0]) < 0.9 else np.array([0, 1.0, 0])
    u = _normalize(np.cross(up, a))
    v = np.cross(up, u)

    render_poses = []
    for th in np.linspace(0.0, 2.0 * np.pi, n_frames, endpoint=False):
        pos = center + radcircle * (np.cos(th) * u + np.sin(th) * v) + zh * up
        z = _normalize(pos - center)
        rp = np.eye(4)
        rp[:3] = viewmatrix(z, up, pos)
        rp[:3, 1:3] *= -1
        render_poses.append(np.linalg.inv(rp))
    return render_poses


def generate_spiral_path(views, focal: float = 1.5, zrate: float = 0.0,
                         rots: int = 1, n_frames: int = 600):
    """Forward-facing spiral (pose_utils.py:518-551)."""
    poses = _poses_from_views(views)
    c2w = poses.mean(0)
    up = _normalize(poses[:, :3, 1].sum(0))
    rads = np.percentile(np.abs(poses[:, :3, 3]), 90, 0)
    render_poses = []
    for theta in np.linspace(0.0, 2.0 * np.pi * rots, n_frames + 1)[:-1]:
        c = c2w[:3, :4] @ (np.array([np.cos(theta), -np.sin(theta),
                                     -np.sin(theta * zrate), 1.0]) * np.append(rads, 1.0))
        z = _normalize(c - c2w[:3, :4] @ np.array([0, 0, -focal, 1.0]))
        rp = np.eye(4)
        rp[:3] = viewmatrix(z, up, c)
        rp[:3, 1:3] *= -1
        render_poses.append(np.linalg.inv(rp))
    return render_poses
