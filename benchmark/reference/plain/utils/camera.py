"""Hemisphere camera rig (numpy).

Counterpart of ``partmanip_tpu/utils/camera.py``, line for line: look-at
camera poses on a hemisphere around the workspace (α sweeps [-45°, 225°] for
3 views, β = 40°, radius from the task config), as world-from-camera 4×4
matrices in the OpenCV convention the renderer and the TSDF tables use
(x right, y down, z forward); intrinsics with fx = fy from the horizontal
field of view; the Kabsch fit of a rigid transform.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np


def look_at_pose(position: np.ndarray, target: np.ndarray,
                 up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """World-from-camera pose, camera looks at target; OpenCV convention
    (+z forward into the scene, +y down)."""
    position = np.asarray(position, np.float64)
    target = np.asarray(target, np.float64)
    up = np.asarray(up, np.float64)
    z = target - position
    z = z / np.linalg.norm(z)
    x = np.cross(z, up)
    n = np.linalg.norm(x)
    if n < 1e-8:  # looking straight down: pick x along world x
        x = np.array([1.0, 0, 0])
    else:
        x = x / n
    y = np.cross(z, x)
    pose = np.eye(4)
    pose[:3, 0] = x
    pose[:3, 1] = y
    pose[:3, 2] = z
    pose[:3, 3] = position
    return pose


def gen_camera_poses(
    look_at,
    radius: float,
    num_views: int = 3,
    alpha_range: Tuple[float, float] = (-45 * math.pi / 180,
                                        225 * math.pi / 180),
    beta: float = 40 * math.pi / 180,
    rng: np.random.RandomState = None,
    angle_noise_deg: float = 0.0,
    trans_noise: float = 0.0,
) -> np.ndarray:
    """[V, 4, 4] hemisphere poses; optional extrinsics noise
    (≙ ``add_noise_to_transformation_matrix``, ``camera.py:92-101``)."""
    look_at = np.asarray(look_at, np.float64)
    poses = []
    for i in range(num_views):
        alpha = (alpha_range[0]
                 + (alpha_range[1] - alpha_range[0]) * i / max(num_views - 1, 1))
        x = radius * math.sin(beta) * math.cos(alpha)
        y = radius * math.sin(beta) * math.sin(alpha)
        z = radius * math.cos(beta)
        pose = look_at_pose(look_at + np.array([x, y, z]), look_at)
        if rng is not None and (angle_noise_deg > 0 or trans_noise > 0):
            axis = rng.rand(3)
            axis /= np.linalg.norm(axis)
            ang = rng.uniform(0, angle_noise_deg) * math.pi / 180
            K = np.array([[0, -axis[2], axis[1]],
                          [axis[2], 0, -axis[0]],
                          [-axis[1], axis[0], 0]])
            R = np.eye(3) + math.sin(ang) * K + (1 - math.cos(ang)) * K @ K
            pose[:3, :3] = R @ pose[:3, :3]
            d = rng.rand(3)
            d /= np.linalg.norm(d)
            pose[:3, 3] += d * rng.uniform(0, trans_noise)
        poses.append(pose)
    return np.stack(poses).astype(np.float32)


def camera_intrinsics(width: int, height: int,
                      horizontal_fov_deg: float = 69.75) -> np.ndarray:
    """3×3 intrinsics with fx = fy from the horizontal FOV
    (≙ ``hand_base.py:179-182``)."""
    fx = width / 2.0 / math.tan(horizontal_fov_deg * math.pi / 360.0)
    return np.array([[fx, 0, width // 2],
                     [0, fx, height // 2],
                     [0, 0, 1]], np.float32)


