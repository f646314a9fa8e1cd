"""Object motion editing: move masked track subsets with SE(3) ramps.

Behavioral reference: `pipelines.py:852-1038` (`ObjectMotionGenerator`):
24 translation templates + 6 rotations about the masked points' centroid,
linear ramp over frames. Vectorized over frames (the reference loops).
The port's own copy of `flexam_tpu/conditioning/object_motion.py`."""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

_S2 = math.sqrt(2)
_S3 = math.sqrt(3)

# (`pipelines.py:884-928`)
MOTION_TEMPLATES = {
    "up": ("trans", (0, -1, 0)),
    "down": ("trans", (0, 1, 0)),
    "left": ("trans", (-1, 0, 0)),
    "right": ("trans", (1, 0, 0)),
    "front": ("trans", (0, 0, 1)),
    "back": ("trans", (0, 0, -1)),
    "up_left": ("trans", (-1 / _S2, -1 / _S2, 0)),
    "up_right": ("trans", (1 / _S2, -1 / _S2, 0)),
    "down_left": ("trans", (-1 / _S2, 1 / _S2, 0)),
    "down_left2": ("trans", (-1 / _S2, 0.5 / _S2, 0)),
    "down_right": ("trans", (1 / _S2, 1 / _S2, 0)),
    "up_front": ("trans", (0, -1 / _S2, 1 / _S2)),
    "up_back": ("trans", (0, -1 / _S2, -1 / _S2)),
    "down_front": ("trans", (0, 1 / _S2, 1 / _S2)),
    "down_back": ("trans", (0, 1 / _S2, -1 / _S2)),
    "left_front": ("trans", (-1 / _S2, 0, 1 / _S2)),
    "left_back": ("trans", (-1 / _S2, 0, -1 / _S2)),
    "right_front": ("trans", (1 / _S2, 0, 1 / _S2)),
    "right_back": ("trans", (1 / _S2, 0, -1 / _S2)),
    "up_left_front": ("trans", (-1 / _S3, -1 / _S3, 1 / _S3)),
    "up_left_back": ("trans", (-1 / _S3, -1 / _S3, -1 / _S3)),
    "up_right_front": ("trans", (1 / _S3, -1 / _S3, 1 / _S3)),
    "up_right_back": ("trans", (1 / _S3, -1 / _S3, -1 / _S3)),
    "down_left_front": ("trans", (-1 / _S3, 1 / _S3, 1 / _S3)),
    "down_left_back": ("trans", (-1 / _S3, 1 / _S3, -1 / _S3)),
    "down_right_front": ("trans", (1 / _S3, 1 / _S3, 1 / _S3)),
    "down_right_back": ("trans", (1 / _S3, 1 / _S3, -1 / _S3)),
    "rot": ("rot", None),
    "rot_ccw": ("rot_ccw", None),
    "pitch_up": ("rot_x", None),
    "pitch_down": ("rot_x_ccw", None),
    "roll_left": ("rot_z", None),
    "roll_right": ("rot_z_ccw", None),
}


def _rot_mats(kind: str, angles_rad: np.ndarray) -> np.ndarray:
    """[T, 4, 4] rotations for the 6 rotation kinds (`pipelines.py:952-1005`)."""
    t = len(angles_rad)
    c, s = np.cos(angles_rad), np.sin(angles_rad)
    m = np.tile(np.eye(4, dtype=np.float64), (t, 1, 1))
    if kind == "rot":            # y axis, clockwise
        m[:, 0, 0], m[:, 0, 2], m[:, 2, 0], m[:, 2, 2] = c, s, -s, c
    elif kind == "rot_ccw":
        m[:, 0, 0], m[:, 0, 2], m[:, 2, 0], m[:, 2, 2] = c, -s, s, c
    elif kind == "rot_x":        # pitch up
        m[:, 1, 1], m[:, 1, 2], m[:, 2, 1], m[:, 2, 2] = c, -s, s, c
    elif kind == "rot_x_ccw":
        m[:, 1, 1], m[:, 1, 2], m[:, 2, 1], m[:, 2, 2] = c, s, -s, c
    elif kind == "rot_z":        # roll left
        m[:, 0, 0], m[:, 0, 1], m[:, 1, 0], m[:, 1, 1] = c, -s, s, c
    elif kind == "rot_z_ccw":
        m[:, 0, 0], m[:, 0, 1], m[:, 1, 0], m[:, 1, 1] = c, s, -s, c
    else:
        raise ValueError(kind)
    return m


class ObjectMotionGenerator:
    """`ObjectMotionGenerator` (`pipelines.py:852-1038`), numpy/vectorized."""

    def points_in_mask(self, pred_tracks: np.ndarray,
                       mask: np.ndarray) -> np.ndarray:
        """Frame-0 points inside a binary [H, W] mask (`:857-876`)."""
        xy = np.round(pred_tracks[0, :, :2]).astype(np.int64)
        xy[:, 0] = np.clip(xy[:, 0], 0, mask.shape[1] - 1)
        xy[:, 1] = np.clip(xy[:, 1], 0, mask.shape[0] - 1)
        return mask[xy[:, 1], xy[:, 0]].astype(bool)

    def _motions(self, kind: str, base_vec, distance: float, center,
                 num_frames: int) -> np.ndarray:
        ts = np.arange(num_frames, dtype=np.float64) / (num_frames - 1)
        if kind == "trans":
            mats = np.tile(np.eye(4, dtype=np.float64), (num_frames, 1, 1))
            mats[:, :3, 3] = np.asarray(base_vec)[None] * ts[:, None]
        else:
            mats = _rot_mats(kind, np.radians(distance * ts))
        # conjugate about centroid: M' = T(center) @ M @ T(-center)
        out = mats.copy()
        out[:, :3, 3] = (mats[:, :3, 3]
                         - np.einsum("tij,j->ti", mats[:, :3, :3], center)
                         + center)
        return out

    def apply_motion(self, pred_tracks: np.ndarray, mask: np.ndarray,
                     motion_type: str, distance: float, num_frames: int = 49,
                     tracking_method: str = "DELTA") -> np.ndarray:
        """Apply a template motion to the masked subset of tracks.

        DELTA format: tracks [T, N, 3]; moge: [T, H, W, 3] normalized, with
        the translation divided by (W, H) per frame (`:1010-1025`)."""
        if motion_type not in MOTION_TEMPLATES:
            raise ValueError(f"unknown motion type: {motion_type}")
        kind, base = MOTION_TEMPLATES[motion_type]
        base_vec = (np.asarray(base, np.float64) * distance
                    if base is not None else None)
        tracks = np.asarray(pred_tracks, np.float64)

        if tracking_method == "moge":
            t, h, w, _ = tracks.shape
            flat = tracks.reshape(t, -1, 3)
            valid = (~np.any(np.isnan(tracks[0]), axis=2)) & mask.astype(bool)
            valid = valid.reshape(-1)
            pts0 = flat[0, valid]
            center = pts0.mean(axis=0)
            motions = self._motions(kind, base_vec, distance, center,
                                    num_frames)
            if w > 1:   # normalized coords: scale translation (`:1013-1016`)
                motions = motions.copy()
                motions[:, 0, 3] /= w
                motions[:, 1, 3] /= h
            out = flat.copy()
            hom = np.concatenate(
                [flat[:, valid], np.ones((t, valid.sum(), 1))], axis=-1)
            moved = np.einsum("tnj,tij->tni", hom, motions)[..., :3]
            out[:, valid] = moved
            return out.reshape(t, h, w, 3).astype(pred_tracks.dtype)

        sel = self.points_in_mask(tracks, np.asarray(mask))
        center = tracks[0, sel].mean(axis=0)
        motions = self._motions(kind, base_vec, distance, num_frames=num_frames,
                                center=center)
        out = tracks.copy()
        t = tracks.shape[0]
        hom = np.concatenate(
            [tracks[:, sel], np.ones((t, sel.sum(), 1))], axis=-1)
        moved = np.einsum("tnj,tij->tni", hom, motions[:t])[..., :3]
        out[:, sel] = moved
        return out.astype(pred_tracks.dtype)
