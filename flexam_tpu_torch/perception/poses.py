"""Pose-head post-processing of the external perception models.

A copy of `flexam_tpu/perception/poses.py` (numpy): VGGT's camera-head
encoding (absT + quatR + FoV) and Pi3's camera-to-world poses become
extrinsics / intrinsics, and recorded pose fixtures in any of these forms
drive the camera path. Quaternions are (w, x, y, z), the pytorch3d / vggt
layout.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np

from flexam_tpu_torch.conditioning.camera import se3_inverse


def quat_to_rotmat(quat: np.ndarray) -> np.ndarray:
    """[..., 4] (w, x, y, z) unit quaternion -> [..., 3, 3]."""
    q = np.asarray(quat, np.float64)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    m = np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], axis=-1)
    return m.reshape(q.shape[:-1] + (3, 3)).astype(np.float32)


def rotmat_to_quat(R: np.ndarray) -> np.ndarray:
    """[..., 3, 3] -> [..., 4] (w, x, y, z); for fixture authoring/tests."""
    R = np.asarray(R, np.float64)
    w = np.sqrt(np.maximum(0, 1 + R[..., 0, 0] + R[..., 1, 1]
                           + R[..., 2, 2])) / 2
    w = np.maximum(w, 1e-12)
    x = (R[..., 2, 1] - R[..., 1, 2]) / (4 * w)
    y = (R[..., 0, 2] - R[..., 2, 0]) / (4 * w)
    z = (R[..., 1, 0] - R[..., 0, 1]) / (4 * w)
    return np.stack([w, x, y, z], axis=-1).astype(np.float32)


def pose_encoding_to_extri_intri(
    pose_encoding: np.ndarray,          # [T, 9] = t(3) + quat wxyz(4) + fov(2)
    image_size_hw: Tuple[int, int],
) -> Tuple[np.ndarray, np.ndarray]:
    """VGGT camera-head output -> OpenCV camera-from-world extrinsics
    [T, 3, 4] + intrinsics [T, 3, 3] (consumed at `demo.py:319`,
    `cam_motion.set_intr/set_extr` :323-324). fov order (fov_h, fov_w)."""
    enc = np.asarray(pose_encoding, np.float32)
    if enc.ndim == 3:            # [B, T, 9] -> first batch
        enc = enc[0]
    t = enc[:, :3]
    R = quat_to_rotmat(enc[:, 3:7])
    fov_h, fov_w = enc[:, 7], enc[:, 8]
    H, W = image_size_hw
    extr = np.concatenate([R, t[:, :, None]], axis=-1).astype(np.float32)
    fy = (H / 2.0) / np.tan(fov_h / 2.0)
    fx = (W / 2.0) / np.tan(fov_w / 2.0)
    n = len(enc)
    intr = np.zeros((n, 3, 3), np.float32)
    intr[:, 0, 0] = fx
    intr[:, 1, 1] = fy
    intr[:, 0, 2] = W / 2.0
    intr[:, 1, 2] = H / 2.0
    intr[:, 2, 2] = 1.0
    return extr, intr


def pi3_poses_to_extri_intri(
    poses_c2w: np.ndarray,              # [T, 4, 4] camera-to-world
    width: int, height: int, fov_deg: float = 55.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Pi3 post-processing (`pipelines.py:260-321`): c2w -> w2c via
    se3_inverse; intrinsics from the default 55-degree FoV assumption
    (fx = (W/2)/tan(fov/2), principal point at the center)."""
    poses_c2w = np.asarray(poses_c2w, np.float32)
    extr = np.stack([se3_inverse(p)[:3] for p in poses_c2w])
    fx = (width / 2.0) / math.tan(math.radians(fov_deg) / 2.0)
    n = len(poses_c2w)
    intr = np.zeros((n, 3, 3), np.float32)
    intr[:, 0, 0] = fx
    intr[:, 1, 1] = fx
    intr[:, 0, 2] = width / 2.0
    intr[:, 1, 2] = height / 2.0
    intr[:, 2, 2] = 1.0
    return extr, intr


def poses_npz_to_extri_intri(path_or_dict, width: int, height: int
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """Load a recorded pose fixture in any of the formats the perception
    stack produces:
      * extrinsics [T,3,4] (+ optional intrinsics) — direct;
      * pose_encoding [T,9] (+ optional image_size) — VGGT camera head;
      * camera_poses / c2w [T,4,4] — Pi3 output.
    """
    data: Dict = (dict(np.load(path_or_dict))
                  if isinstance(path_or_dict, str) else dict(path_or_dict))
    if "extrinsics" in data:
        extr = np.asarray(data["extrinsics"], np.float32)
        if "intrinsics" in data:
            return extr, np.asarray(data["intrinsics"], np.float32)
        _, intr = pi3_poses_to_extri_intri(
            np.concatenate([extr, np.tile(np.array([[[0, 0, 0, 1]]],
                                                   np.float32),
                                          (len(extr), 1, 1))], axis=1),
            width, height)
        return extr, intr
    if "pose_encoding" in data:
        hw = tuple(int(v) for v in data.get("image_size", (height, width)))
        return pose_encoding_to_extri_intri(data["pose_encoding"], hw)
    for key in ("camera_poses", "c2w", "poses"):
        if key in data:
            return pi3_poses_to_extri_intri(data[key], width, height)
    raise ValueError(
        f"pose fixture needs extrinsics/pose_encoding/camera_poses; "
        f"got keys {sorted(data)}")
