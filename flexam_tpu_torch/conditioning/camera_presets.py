"""CameraCtrl-style preset camera poses (ChaoJie node pack math).

Behavioral reference: the reference's `comfyui/camera_utils.py:1-79` —
preset angle/translation templates interpolated over frames, relative-pose
composition, and join of two trajectories. Vectorized over frames instead
of the reference's per-frame python loop. The port's own copy of
`flexam_tpu/conditioning/camera_presets.py`.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

BASE_T_NORM = 1.5
BASE_ANGLE = np.pi / 3

CAMERA_PRESETS = {
    "Static":    {"angle": [0., 0., 0.],  "T": [0., 0., 0.]},
    "Pan Up":    {"angle": [0., 0., 0.],  "T": [0., 1., 0.]},
    "Pan Down":  {"angle": [0., 0., 0.],  "T": [0., -1., 0.]},
    "Pan Left":  {"angle": [0., 0., 0.],  "T": [1., 0., 0.]},
    "Pan Right": {"angle": [0., 0., 0.],  "T": [-1., 0., 0.]},
    "Zoom In":   {"angle": [0., 0., 0.],  "T": [0., 0., -2.]},
    "Zoom Out":  {"angle": [0., 0., 0.],  "T": [0., 0., 2.]},
    "ACW":       {"angle": [0., 0., 1.],  "T": [0., 0., 0.]},
    "CW":        {"angle": [0., 0., -1.], "T": [0., 0., 0.]},
}

PRESET_NAMES = list(CAMERA_PRESETS)


def rotation_from_angles(angles: np.ndarray) -> np.ndarray:
    """Rz @ Ry @ Rx from [..., 3] xyz radians
    (`compute_R_form_rad_angle`, `camera_utils.py:22-37`)."""
    angles = np.asarray(angles, np.float64)
    tx, ty, tz = angles[..., 0], angles[..., 1], angles[..., 2]
    cx, sx = np.cos(tx), np.sin(tx)
    cy, sy = np.cos(ty), np.sin(ty)
    cz, sz = np.cos(tz), np.sin(tz)
    zero = np.zeros_like(tx)
    one = np.ones_like(tx)
    rx = np.stack([one, zero, zero,
                   zero, cx, -sx,
                   zero, sx, cx], -1).reshape(angles.shape[:-1] + (3, 3))
    ry = np.stack([cy, zero, sy,
                   zero, one, zero,
                   -sy, zero, cy], -1).reshape(angles.shape[:-1] + (3, 3))
    rz = np.stack([cz, -sz, zero,
                   sz, cz, zero,
                   zero, zero, one], -1).reshape(angles.shape[:-1] + (3, 3))
    return rz @ ry @ rx


def get_camera_motion(angle: Sequence[float], T: Sequence[float],
                      speed: float, n: int) -> np.ndarray:
    """[n, 3, 4] pose trajectory (`get_camera_motion`,
    `camera_utils.py:39-50`): linear ramp i/n over rotation (scaled by
    BASE_ANGLE) and translation (scaled by BASE_T_NORM)."""
    i = np.arange(n, dtype=np.float64)[:, None] / n * speed
    R = rotation_from_angles(i * BASE_ANGLE * np.asarray(angle, np.float64))
    t = (i * BASE_T_NORM * np.asarray(T, np.float64))[..., None]   # [n,3,1]
    return np.concatenate([R, t], axis=-1).astype(np.float32)


def preset_camera_motion(name: str, speed: float, n: int) -> np.ndarray:
    p = CAMERA_PRESETS[name]
    return get_camera_motion(p["angle"], p["T"], speed, n)


def combine_presets(names: Sequence[str], speed: float, n: int) -> np.ndarray:
    """Sum of preset angle/T vectors, one trajectory
    (`CameraCombineFromChaoJie.run`, `comfyui_nodes.py:334-337`)."""
    angle = np.sum([CAMERA_PRESETS[m]["angle"] for m in names], axis=0)
    T = np.sum([CAMERA_PRESETS[m]["T"] for m in names], axis=0)
    return get_camera_motion(angle, T, speed, n)


def join_camera_motion(rt0: np.ndarray, rt1: np.ndarray) -> np.ndarray:
    """Concatenate trajectory rt1 after rt0, re-anchored at rt0's final
    pose (`combine_camera_motion`, `camera_utils.py:65-79`)."""
    rt0 = np.asarray(rt0, np.float64)
    rt1 = np.asarray(rt1, np.float64)
    anchor = rt0[-1]
    R, T = anchor[:, :3], anchor[:, 3]
    new_R = rt1[:, :, :3] @ R                                   # [n,3,3]
    new_T = rt1[:, :, 3] + (new_R @ R.T) @ T
    joined = np.concatenate([new_R, new_T[..., None]], axis=-1)
    return np.concatenate([rt0, joined], axis=0).astype(np.float32)


def trajectory_json(rt: np.ndarray, fx: float, fy: float,
                    cx: float, cy: float) -> str:
    """CameraCtrl txt-line format as JSON
    (`CameraTrajectoryFromChaoJie.run`, `comfyui_nodes.py:380-389`)."""
    import json
    trajs = []
    for pose in np.asarray(rt).tolist():
        row = [fx, fy, cx, cy, 0, 0]
        row.extend(pose[0])
        row.extend(pose[1])
        row.extend(pose[2])
        trajs.append(row)
    return json.dumps(trajs)
