"""Camera poses from 3D tracks: the no-checkpoint replacement for the
VGGT / Pi3 pose step of the camera-control path.

A copy of `flexam_tpu/perception/pose_solver.py` (numpy). With (u, v,
metric depth) tracks each frame's visible points unproject to camera space,
and frame t's world->camera transform is the rigid map aligning frame 0's
points to frame t's: weighted Kabsch (SVD) per frame, with trimmed re-fits
that reject independently moving objects.

Output follows `conditioning/camera.py`'s VGGT convention: extrinsics
[T, 3, 4] world-to-camera (x_cam = R x_world + t, frame 0 = identity),
intrinsics [T, 3, 3].
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def default_intrinsics(width: int, height: int,
                       focal: Optional[float] = None) -> np.ndarray:
    """Pinhole prior when no calibration is available: principal point at
    the center, focal = 0.7 * diagonal — the same prior UniDepth's camera
    head is parameterized around (`decoder.py:95-100`)."""
    f = focal or 0.7 * float(np.hypot(width, height))
    return np.asarray([[f, 0, width / 2.0],
                       [0, f, height / 2.0],
                       [0, 0, 1.0]], np.float32)


def unproject_tracks(tracks: np.ndarray, intrinsics: np.ndarray
                     ) -> np.ndarray:
    """[T, N, 3] (u, v, depth) -> camera-space points [T, N, 3]."""
    t, n, _ = tracks.shape
    k = np.asarray(intrinsics, np.float64)
    if k.ndim == 2:
        k = np.tile(k[None], (t, 1, 1))
    uv1 = np.concatenate([tracks[..., :2],
                          np.ones((t, n, 1))], axis=-1).astype(np.float64)
    k_inv = np.linalg.inv(k)
    rays = np.einsum("tnj,tij->tni", uv1, k_inv)
    return (rays * tracks[..., 2:3]).astype(np.float64)


def _kabsch(src: np.ndarray, dst: np.ndarray, w: np.ndarray
            ) -> Tuple[np.ndarray, np.ndarray]:
    """Weighted rigid fit dst ~= R @ src + t (SVD, det-corrected)."""
    w = w / max(w.sum(), 1e-9)
    cs = (w[:, None] * src).sum(0)
    cd = (w[:, None] * dst).sum(0)
    h = ((src - cs) * w[:, None]).T @ (dst - cd)
    u, _, vt = np.linalg.svd(h)
    d = np.sign(np.linalg.det(vt.T @ u.T))
    r = vt.T @ np.diag([1.0, 1.0, d]) @ u.T
    return r, cd - r @ cs


def solve_camera_poses(
    tracks: np.ndarray,                    # [T, N, 3] (u, v, metric depth)
    visibility: Optional[np.ndarray],      # [T, N] bool
    intrinsics: Optional[np.ndarray] = None,   # [3,3] or [T,3,3]
    width: Optional[int] = None,
    height: Optional[int] = None,
    trim_rounds: int = 2,
    trim_quantile: float = 0.7,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-frame world->camera extrinsics from 3D tracks.

    World frame = frame 0's camera. Each refit round keeps the
    `trim_quantile` best-aligned points, rejecting independently moving
    objects (the static background dominates typical track grids).
    Returns (extrinsics [T, 3, 4] float32, intrinsics [T, 3, 3] float32).
    """
    tracks = np.asarray(tracks, np.float64)
    t, n, _ = tracks.shape
    if intrinsics is None:
        if not (width and height):
            raise ValueError("need intrinsics= or width=/height=")
        intrinsics = default_intrinsics(width, height)
    k = np.asarray(intrinsics, np.float64)
    k_all = np.tile(k[None], (t, 1, 1)) if k.ndim == 2 else k
    vis = (np.ones((t, n), bool) if visibility is None
           else np.asarray(visibility).astype(bool))
    valid = vis & (tracks[..., 2] > 1e-6)

    cam = unproject_tracks(tracks, k_all)          # [T, N, 3]
    world = cam[0]                                 # frame-0 camera = world
    extr = np.zeros((t, 3, 4), np.float64)
    extr[0, :, :3] = np.eye(3)
    base = valid[0]
    for i in range(1, t):
        keep = base & valid[i]
        if keep.sum() < 4:                         # untrackable: hold pose
            extr[i] = extr[i - 1]
            continue
        w = keep.astype(np.float64)
        r_i, t_i = _kabsch(world, cam[i], w)
        for _ in range(max(0, trim_rounds)):
            res = np.linalg.norm(
                (world @ r_i.T + t_i) - cam[i], axis=-1)
            thresh = np.quantile(res[keep], trim_quantile)
            w = (keep & (res <= max(thresh, 1e-9))).astype(np.float64)
            if w.sum() < 4:
                break
            r_i, t_i = _kabsch(world, cam[i], w)
        extr[i, :, :3] = r_i
        extr[i, :, 3] = t_i
    return extr.astype(np.float32), k_all.astype(np.float32)
