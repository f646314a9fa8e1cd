"""Camera motion synthesis + world/screen projections.

Behavioral reference: `pipelines.py:195-850` (`CameraMotionGenerator`),
`pipelines.py:41-107` (`get_relative_pose`, `ray_condition`, `Camera`).

The port's own copy of `flexam_tpu/conditioning/camera.py` (numpy only):
the reference runs per-frame python loops over numpy matrices (`s2w_vggt`
:392-418, `w2s_moge` :512-530); here every projection is one batched einsum
over [T, N, 3] points. All pose math stays host-side numpy (tiny).
`process_video_file` (a video as the camera path) runs the Pi3 perception
model (`perception/pi3.py`) on the generator's `device` and reads the
video's `.npz` frame dump, as the port reads no `.mp4`.
"""

from __future__ import annotations

import math
import os
from typing import List, Optional, Sequence

import numpy as np


def se3_inverse(mat: np.ndarray) -> np.ndarray:
    """Inverse of a rigid 4x4 transform."""
    out = np.eye(4, dtype=mat.dtype)
    r = mat[:3, :3]
    t = mat[:3, 3]
    out[:3, :3] = r.T
    out[:3, 3] = -r.T @ t
    return out


class Camera:
    """CameraCtrl pose-file row (`pipelines.py:93-106`): entry =
    [frame_id, fx, fy, cx, cy, 0, 0, w2c(3x4 flattened)]."""

    def __init__(self, entry: Sequence[float]):
        self.fx, self.fy, self.cx, self.cy = entry[1:5]
        w2c = np.eye(4)
        w2c[:3, :] = np.array(entry[7:]).reshape(3, 4)
        self.w2c_mat = w2c
        self.c2w_mat = np.linalg.inv(w2c)


def get_relative_pose(cam_params: List[Camera]) -> np.ndarray:
    """Relative c2w chain anchored at identity (`pipelines.py:41-56`)."""
    abs_w2cs = [c.w2c_mat for c in cam_params]
    abs_c2ws = [c.c2w_mat for c in cam_params]
    target = np.eye(4)
    abs2rel = target @ abs_w2cs[0]
    poses = [target] + [abs2rel @ c2w for c2w in abs_c2ws[1:]]
    return np.asarray(poses, dtype=np.float32)


def ray_condition(K: np.ndarray, c2w: np.ndarray, H: int, W: int) -> np.ndarray:
    """Plucker ray embedding [B, V, H, W, 6] (`pipelines.py:58-91`).
    K: [B, V, 4] (fx, fy, cx, cy); c2w: [B, V, 4, 4]. Vectorized."""
    B, V = K.shape[:2]
    j, i = np.meshgrid(np.arange(H, dtype=np.float64),
                       np.arange(W, dtype=np.float64), indexing="ij")
    i = i.reshape(1, 1, H * W) + 0.5
    j = j.reshape(1, 1, H * W) + 0.5
    fx, fy, cx, cy = [K[..., k:k + 1] for k in range(4)]
    zs = np.ones_like(np.broadcast_to(i, (B, V, H * W)))
    xs = (i - cx) / fx * zs
    ys = (j - cy) / fy * zs
    directions = np.stack([xs, ys, zs], axis=-1)
    directions = directions / np.linalg.norm(directions, axis=-1,
                                             keepdims=True)
    rays_d = directions @ np.swapaxes(c2w[..., :3, :3], -1, -2)
    rays_o = np.broadcast_to(c2w[..., None, :3, 3], rays_d.shape)
    rays_dxo = np.cross(rays_o, rays_d)
    plucker = np.concatenate([rays_dxo, rays_d], axis=-1)
    return plucker.reshape(B, V, H, W, 6).astype(np.float32)


def process_pose_params(cam_params: np.ndarray, width: int = 672,
                        height: int = 384,
                        original_pose_width: int = 1280,
                        original_pose_height: int = 720) -> np.ndarray:
    """CameraCtrl pose rows -> Plucker embedding video [T, H, W, 6]
    (`FlexAM/data/dataset_image_video.py:229-258`, consumed by the
    ComfyUI sampler's `camera_conditions` input at
    `wan2_2_fun_flexam/nodes.py:577-583`): aspect-corrected focal
    rescale, pixel intrinsics, relative c2w chain, ray embedding."""
    cams = [Camera(e) for e in np.asarray(cam_params, np.float64)]
    sample_wh = width / height
    pose_wh = original_pose_width / original_pose_height
    if pose_wh > sample_wh:
        for c in cams:
            c.fx = (height * pose_wh) * c.fx / width
    else:
        for c in cams:
            c.fy = (width / pose_wh) * c.fy / height
    K = np.asarray([[c.fx * width, c.fy * height, c.cx * width,
                     c.cy * height] for c in cams], np.float32)[None]
    c2ws = get_relative_pose(cams)[None]
    return ray_condition(K, c2ws, height, width)[0]       # [T, H, W, 6]


def camera_inputs_from_trajectory(camera_conditions, video_length: int,
                                  height: int, width: int):
    """The ComfyUI sampler's `camera_conditions` contract
    (`wan2_2_fun_flexam/nodes.py:577-583`), shared by the graph node and
    the serve API: trajectory JSON (or an already-parsed pose list) ->
    (camera_video [1, 6, T, H, W], zeros video [1, 3, T, H, W],
    all-generate mask [1, 1, T, H, W]) — generation is camera-driven."""
    import json

    poses = (json.loads(camera_conditions)
             if isinstance(camera_conditions, str) else camera_conditions)
    cam_params = np.array([[float(x) for x in p] for p in poses])
    cam_params = np.concatenate(
        [np.zeros_like(cam_params[:, :1]), cam_params], 1)
    plucker = process_pose_params(cam_params, width=width, height=height)
    cam = plucker[:video_length].transpose(3, 0, 1, 2)[None]
    video = np.zeros((1, 3, video_length, height, width), np.float32)
    mask = np.ones((1, 1, video_length, height, width), np.float32)
    return cam, video, mask


def fold_camera_video(cam: np.ndarray) -> np.ndarray:
    """Plucker camera video [B, 6, T, H, W] (T = 4k+1) -> the camera
    adapter's input [B, 24, (T+3)/4, H, W]: first frame repeated 4x,
    then 4-frame groups folded into channels — the reference pipeline's
    control_camera_latents transform
    (`pipeline_wan2_2_fun_control_FlexAM.py:697-707`)."""
    cam = np.asarray(cam, np.float32)
    x = np.concatenate([np.repeat(cam[:, :, :1], 4, axis=2),
                        cam[:, :, 1:]], axis=2)
    x = x.transpose(0, 2, 1, 3, 4)                 # b f c h w
    b, f, c, h, w = x.shape
    x = x.reshape(b, f // 4, 4, c, h, w).transpose(0, 1, 3, 2, 4, 5)
    x = x.reshape(b, f // 4, c * 4, h, w).transpose(0, 2, 1, 3, 4)
    return np.ascontiguousarray(x)


class CameraMotionGenerator:
    """Pose-DSL parser + projections (`pipelines.py:195-850`).

    DSL: 'trans dx dy dz [s e]; rot axis deg [s e]; spiral r [s e]; path'
    producing per-frame w2c matrices [T, 4, 4]; linear ramp inside [s, e],
    held after e; sequential composition via right-multiplication.
    """

    def __init__(self, motion_type: str, frame_num: int = 49, H: int = 480,
                 W: int = 720, fx: Optional[float] = None,
                 fy: Optional[float] = None, fov: float = 55,
                 pose_file: Optional[str] = None, device="cuda"):
        self.motion_type = motion_type
        self.frame_num = frame_num
        self.W, self.H = W, H
        self.pose_file = pose_file
        self.device = device       # where a video pose source's Pi3 runs
        if not fx or not fy:
            fx = fy = (W / 2) / math.tan(math.radians(fov) / 2)
        self.intr = np.array([[fx, 0, W / 2], [0, fy, H / 2], [0, 0, 1]],
                             dtype=np.float32)
        self.extr = np.eye(4, dtype=np.float32)

    # -- pose synthesis ------------------------------------------------------

    def rot_poses(self, angle_deg: float, axis: str = "y") -> np.ndarray:
        a = math.radians(angle_deg)
        c, s = math.cos(a), math.sin(a)
        m = np.eye(4, dtype=np.float32)
        if axis == "x":
            m[1:3, 1:3] = [[c, -s], [s, c]]
        elif axis == "y":
            m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
        elif axis == "z":
            m[0:2, 0:2] = [[c, -s], [s, c]]
        else:
            raise ValueError(f"invalid axis {axis}")
        return m

    def trans_poses(self, dx: float, dy: float, dz: float) -> np.ndarray:
        t = np.linspace(0, 1, self.frame_num, dtype=np.float32)
        mats = np.tile(np.eye(4, dtype=np.float32), (self.frame_num, 1, 1))
        mats[:, 0, 3] = t * dx
        mats[:, 1, 3] = t * dy
        mats[:, 2, 3] = t * dz
        return mats

    def _look_at(self, cam_pos: np.ndarray, target: np.ndarray) -> np.ndarray:
        d = target - cam_pos
        d = d / np.linalg.norm(d)
        up = np.array([0, 1, 0], dtype=np.float64)
        right = np.cross(up, d)
        right /= np.linalg.norm(right)
        up = np.cross(d, right)
        return np.linalg.inv(np.vstack([right, up, d]))

    def spiral_poses(self, radius: float, forward_ratio: float = 0.5,
                     backward_ratio: float = 0.5, rotation_times: float = 0.1,
                     look_at_times: float = 0.5) -> np.ndarray:
        """(`pipelines.py:620-659`)"""
        t = np.linspace(0, 1, self.frame_num)
        r = np.sin(np.pi * t) * radius * rotation_times
        theta = 2 * np.pi * t
        y = r * np.cos(theta) * 0.15
        x = r * np.sin(theta) * 0.5
        z = -r
        z[z < 0] *= forward_ratio
        z[z > 0] *= backward_ratio
        target = np.array([0, 0, radius * look_at_times])
        poses = []
        for pos in np.stack([x, y, z], axis=1):
            m = np.eye(4)
            m[:3, :3] = self._look_at(pos, target)
            m[:3, 3] = pos
            poses.append(m)
        return np.asarray(poses, dtype=np.float32)

    # -- DSL -----------------------------------------------------------------

    def _ramped(self, build_frame, start: int, end: int) -> np.ndarray:
        """Per-frame matrices: identity before start, ramp in [start, end],
        held after end (`pipelines.py:723-737`)."""
        mats = np.tile(np.eye(4, dtype=np.float32), (self.frame_num, 1, 1))
        for f in range(self.frame_num):
            if f < start:
                continue
            if f <= end:
                t = (f - start) / (end - start) if end > start else 1.0
                mats[f] = build_frame(t)
            else:
                mats[f] = mats[end]
        return mats

    def get_default_motion(self) -> np.ndarray:
        """Parse the DSL -> w2c poses [T, 4, 4] (`pipelines.py:661-850`)."""
        if not isinstance(self.motion_type, str):
            raise ValueError(
                f"camera_motion must be a string, got {type(self.motion_type)}")
        final = np.tile(np.eye(4, dtype=np.float32), (self.frame_num, 1, 1))
        for transform in self.motion_type.split(";"):
            params = transform.strip().lower().split()
            if not params:
                continue
            kind = params[0]
            start, end = 0, self.frame_num - 1

            def parse_range(a, b):
                s = max(0, min(self.frame_num - 1, int(a)))
                e = max(0, min(self.frame_num - 1, int(b)))
                return (e, s) if s > e else (s, e)

            if kind == "trans":
                if len(params) not in (4, 6):
                    raise ValueError(f"bad trans spec: {transform}")
                dx, dy, dz = map(float, params[1:4])
                if len(params) == 6:
                    start, end = parse_range(params[4], params[5])
                vec = np.array([dx, dy, dz], dtype=np.float32)

                def mk(t, vec=vec):
                    m = np.eye(4, dtype=np.float32)
                    m[:3, 3] = vec * t
                    return m
                cur = self._ramped(mk, start, end)
            elif kind == "rot":
                if len(params) not in (3, 5):
                    raise ValueError(f"bad rot spec: {transform}")
                axis = params[1]
                if axis not in ("x", "y", "z"):
                    raise ValueError(f"invalid rotation axis {axis}")
                angle = float(params[2])
                if len(params) == 5:
                    start, end = parse_range(params[3], params[4])
                cur = self._ramped(
                    lambda t: self.rot_poses(angle * t, axis), start, end)
            elif kind == "spiral":
                if len(params) not in (2, 4):
                    raise ValueError(f"bad spiral spec: {transform}")
                radius = float(params[1])
                if len(params) == 4:
                    start, end = parse_range(params[2], params[3])
                spiral = self.spiral_poses(radius)

                def mk(t, spiral=spiral):
                    return spiral[int(t * (len(spiral) - 1))]
                cur = self._ramped(mk, start, end)
            elif kind == "path":
                if self.pose_file is None:
                    raise ValueError("pose_file required for 'path' motion")
                ext = os.path.splitext(self.pose_file)[1].lower()
                if ext == ".txt":
                    cams = self.process_pose_file(self.pose_file,
                                                  return_poses=True)
                elif ext in (".mp4", ".avi", ".mov", ".mkv", ".webm"):
                    # reference `pipelines.py:778-787`: a video pose
                    # source runs the Pi3 pose model (native port)
                    cams = self.process_video_file(self.pose_file)
                else:
                    raise ValueError(
                        f"pose source {ext} must be a CameraCtrl .txt or "
                        "a video file (native Pi3 pose estimation)")
                rel_c2ws = get_relative_pose(cams)
                w2cs = np.stack([se3_inverse(m) for m in rel_c2ws])
                w2cs = _fit_frames(w2cs, self.frame_num)
                return w2cs.astype(np.float32)
            else:
                raise ValueError(f"unknown camera_motion type {kind}")
            final = final @ cur
        return final

    # -- pose files ------------------------------------------------------------

    def process_pose_file(self, path: str, width: int = 672,
                          height: int = 384,
                          original_pose_width: int = 1280,
                          original_pose_height: int = 720,
                          return_poses: bool = False):
        """CameraCtrl txt format (`pipelines.py:219-258`)."""
        with open(path) as f:
            lines = [ln.strip().split(" ") for ln in f.readlines()[1:]]
        cams = [Camera([float(x) for x in ln]) for ln in lines]
        if return_poses:
            return cams
        sample_ratio = width / height
        pose_ratio = original_pose_width / original_pose_height
        if pose_ratio > sample_ratio:
            resized_w = height * pose_ratio
            for c in cams:
                c.fx = resized_w * c.fx / width
        else:
            resized_h = width / pose_ratio
            for c in cams:
                c.fy = resized_h * c.fy / height
        c0 = cams[0]
        K = np.array([[c0.fx, 0, c0.cx], [0, c0.fy, c0.cy], [0, 0, 1]],
                     dtype=np.float32)
        self.set_intr(K)
        return cams

    def process_video_file(self, video_file_path: str, width: int = 672,
                           height: int = 384, device=None, model=None):
        """Camera parameters from a video through the Pi3 perception model
        (`pipelines.py:259-321`): Pi3(imgs[None]) -> c2w poses -> w2c Camera
        entries with a 55-degree-FoV intrinsic. The frames come from the
        video's `.npz` frame dump (`perception.pi3.load_images_as_tensor`:
        `<name>.mp4.npz` when only the dump exists); without `model`,
        `Pi3.from_pretrained` on `device` (the generator's, CUDA unless it
        was asked for the CPU). Returns List[Camera]."""
        from flexam_tpu_torch.perception.pi3 import (Pi3,
                                                     load_images_as_tensor)

        imgs = load_images_as_tensor(video_file_path, interval=1)
        model = model or Pi3.from_pretrained(device=device or self.device)
        pred = model(imgs[None])
        poses_c2w = np.asarray(pred["camera_poses"][0])      # [N, 4, 4]

        fx = (width / 2) / math.tan(math.radians(55) / 2)
        cams = []
        for i, c2w in enumerate(poses_c2w):
            w2c = se3_inverse(c2w)
            entry = ([i, fx, fx, width / 2, height / 2, 0, 0]
                     + w2c[:3, :].flatten().tolist())
            cams.append(Camera(entry))
        K = np.array([[fx, 0, width / 2], [0, fx, height / 2], [0, 0, 1]],
                     np.float32)
        self.set_intr(K)
        return cams

    def convert_cameras_to_poses(self, extrinsics: Sequence[np.ndarray]
                                 ) -> np.ndarray:
        """3x4 extrinsics list -> [frame_num, 4, 4] (`pipelines.py:323-354`)."""
        poses = []
        for ext in extrinsics:
            m = np.eye(4)
            m[:3, :4] = np.asarray(ext)
            poses.append(m)
        return _fit_frames(np.asarray(poses), self.frame_num).astype(np.float32)

    def set_intr(self, K: np.ndarray):
        self.intr = np.asarray(K, np.float32)

    def set_extr(self, extr: np.ndarray):
        self.extr = np.asarray(extr, np.float32)

    # -- projections (vectorized) ----------------------------------------------

    def s2w_vggt(self, points: np.ndarray, extrinsics: np.ndarray,
                 intrinsics: np.ndarray) -> np.ndarray:
        """Pixel (u,v,z) -> world, batched over frames (`pipelines.py:356-418`,
        reference loops frames; here one einsum)."""
        points = np.asarray(points, np.float64)
        extrinsics = _strip_batch(extrinsics)
        intrinsics = _strip_batch(intrinsics)
        T, N, _ = points.shape
        valid = points[..., 2] > 0
        uv1 = np.concatenate([points[..., :2], np.ones((T, N, 1))], axis=-1)
        K_inv = np.linalg.inv(intrinsics)                     # [T, 3, 3]
        xyz_cam = np.einsum("tnj,tij->tni", uv1, K_inv)
        xyz_cam = xyz_cam * points[..., 2:3]
        R = extrinsics[:, :, :3]
        t = extrinsics[:, :, 3]
        R_inv = np.linalg.inv(R)
        world = np.einsum("tnj,tij->tni", xyz_cam - t[:, None, :], R_inv)
        world = np.where(valid[..., None], world, 0.0)
        return world.astype(np.float32)

    def w2s_vggt(self, world_points: np.ndarray, extrinsics: np.ndarray,
                 intrinsics: np.ndarray, poses: Optional[np.ndarray] = None,
                 override_extrinsics: bool = True) -> np.ndarray:
        """World -> pixel under new poses; translation scaled by 1/5
        (`pipelines.py:419-510`, quirk at :462-464)."""
        world_points = np.asarray(world_points, np.float64)
        extrinsics = _strip_batch(extrinsics)
        intrinsics = _strip_batch(intrinsics)
        T, N, _ = world_points.shape
        if poses is None:
            pose1 = np.eye(4)
            pose1[:3, :3] = extrinsics[0, :, :3]
            pose1[:3, 3] = extrinsics[0, :, 3]
            cam = np.tile(pose1[None], (T, 1, 1))
        else:
            cam = np.asarray(poses, np.float64).copy()
            cam[:, :3, 3] = cam[:, :3, 3] / 5.0
            if not override_extrinsics:
                ext = np.tile(np.eye(4), (T, 1, 1))
                ext[:, :3, :4] = extrinsics
                cam = cam @ ext
        hom = np.concatenate([world_points, np.ones((T, N, 1))], axis=-1)
        pts_cam = np.einsum("tnj,tij->tni", hom, cam)[..., :3]
        depths = pts_cam[..., 2:3]
        valid = depths[..., 0] > 0
        normalized = pts_cam / (depths + 1e-10)
        pix = np.einsum("tnj,tij->tni", normalized, intrinsics)
        u = np.where(valid, pix[..., 0], 0.0)
        v = np.where(valid, pix[..., 1], 0.0)
        d = np.where(valid, depths[..., 0], 0.0)
        return np.stack([u, v, d], axis=-1).astype(np.float32)

    def w2s_moge(self, pts: np.ndarray, poses: np.ndarray) -> np.ndarray:
        """World -> (u, v, depth) with the generator's intrinsics
        (`pipelines.py:512-530`)."""
        pts = np.asarray(pts, np.float64)
        poses = np.asarray(poses, np.float64)
        assert poses.shape[0] == self.frame_num
        T, N, _ = pts.shape
        hom = np.concatenate([pts, np.ones((T, N, 1))], axis=-1)
        cam = np.einsum("tij,tnj->tni", poses, hom)[..., :3]
        pix = np.einsum("tni,tji->tnj", cam,
                        np.broadcast_to(self.intr.astype(np.float64),
                                        (T, 3, 3)))
        uv = pix[..., :2] / pix[..., 2:3]
        return np.concatenate([uv, cam[..., 2:3]], axis=-1).astype(np.float32)


def _strip_batch(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a, np.float64)
    return a[0] if a.ndim == 4 else a


def _fit_frames(poses: np.ndarray, n: int) -> np.ndarray:
    if len(poses) < n:
        pad = np.repeat(poses[-1:], n - len(poses), axis=0)
        poses = np.concatenate([poses, pad], axis=0)
    return poses[:n]
