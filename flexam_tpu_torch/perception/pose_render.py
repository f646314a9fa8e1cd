"""DWPose / OpenPose skeleton rendering: the post-ONNX half of the
reference's `VideoToPose` annotator.

Port of `flexam_tpu/perception/pose_render.py`. The reference pipeline is
RTMPose (ONNX) -> raw COCO-WholeBody keypoints [persons, 133, (x, y)] and
scores -> the mmpose -> openpose re-indexing with a synthesized neck ->
the per-part threshold and split -> the OpenPose skeleton drawing that the
DiT is conditioned on (`comfyui/annotator/dwpose_utils/__init__.py:16-27`,
`wholebody.py:60-129`, `util.py:72-215`).

JAX draws with `cv2.ellipse2Poly` + `cv2.fillConvexPoly`, `cv2.line`,
filled `cv2.circle` and matplotlib's `hsv_to_rgb`; the port draws with
their rebuilds in `utils/cv.py`, in the same order (limbs, joints, hand
edges, hand joints, face), so the canvas is the same pixel for pixel.
Host work, as JAX's.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np

from flexam_tpu_torch.utils.cv import (
    draw_line,
    ellipse2poly,
    fill_circle,
    fill_convex_poly,
    hsv_to_rgb,
)

# mmpose -> openpose joint order fix + neck synthesis
# (`wholebody.py:63-82`)
_MMPOSE_IDX = [17, 6, 8, 10, 7, 9, 12, 14, 16, 13, 15, 2, 1, 4, 3]
_OPENPOSE_IDX = [1, 2, 3, 4, 6, 7, 8, 9, 10, 12, 13, 14, 15, 16, 17]

# body limb graph + OpenPose colors (`util.py:86-100`)
_LIMB_SEQ = [
    [2, 3], [2, 6], [3, 4], [4, 5], [6, 7], [7, 8], [2, 9], [9, 10],
    [10, 11], [2, 12], [12, 13], [13, 14], [2, 1], [1, 15], [15, 17],
    [1, 16], [16, 18],
]
_COLORS = [
    [255, 0, 0], [255, 85, 0], [255, 170, 0], [255, 255, 0],
    [170, 255, 0], [85, 255, 0], [0, 255, 0], [0, 255, 85],
    [0, 255, 170], [0, 255, 255], [0, 170, 255], [0, 85, 255],
    [0, 0, 255], [85, 0, 255], [170, 0, 255], [255, 0, 255],
    [255, 0, 170], [255, 0, 85],
]
_HAND_EDGES = [
    [0, 1], [1, 2], [2, 3], [3, 4], [0, 5], [5, 6], [6, 7], [7, 8],
    [0, 9], [9, 10], [10, 11], [11, 12], [0, 13], [13, 14], [14, 15],
    [15, 16], [0, 17], [17, 18], [18, 19], [19, 20],
]
_EPS = 0.01


def wholebody_to_openpose(keypoints: np.ndarray, scores: np.ndarray
                          ) -> np.ndarray:
    """Raw RTMPose output -> openpose-ordered keypoints_info
    [persons, 134, 3], `Wholebody.__call__`'s postprocess
    (`wholebody.py:62-82`): append scores, synthesize the neck as the
    shoulder mean with a joint visibility gate, swap mmpose -> openpose
    indices."""
    kp = np.asarray(keypoints, np.float64)
    sc = np.asarray(scores, np.float64)
    info = np.concatenate([kp, sc[..., None]], axis=-1)    # [P, 133, 3]
    neck = info[:, [5, 6]].mean(axis=1)
    neck[:, 2:] = np.logical_and(info[:, 5, 2:] > 0.3,
                                 info[:, 6, 2:] > 0.3).astype(float)
    out = np.insert(info, 17, neck, axis=1)                # [P, 134, 3]
    out[:, _OPENPOSE_IDX] = out[:, _MMPOSE_IDX]
    return out


def split_parts(info_person: np.ndarray):
    """`Wholebody.format_result` (`wholebody.py:85-129`) as arrays:
    {part: [K, 3] with NaN rows where score < 0.3, or None if the whole
    part is below threshold}. Face gets the 2 eye body joints appended
    (68 -> 70 points, openpose face convention)."""
    def part(a):
        a = np.asarray(a, np.float64).copy()
        bad = a[:, 2] < 0.3
        if bad.all():
            return None
        a[bad] = np.nan
        return a

    body = part(info_person[:18])
    if body is None:
        body = np.full((18, 3), np.nan)
    face = part(info_person[24:92])
    if face is not None:
        face = np.concatenate([face, body[14:15], body[15:16]], axis=0)
    return {"body": body,
            "left_hand": part(info_person[92:113]),
            "right_hand": part(info_person[113:134]),
            "face": face}


def _is_normalized(pts: np.ndarray, normalized: Optional[bool]) -> bool:
    """Coordinate-convention decision. Callers that know the convention
    (dwpose_video emits pixel coords) pass `normalized` explicitly; the
    data-value heuristic is only the default for unknown sources, where a
    degenerate pixel-space detection entirely inside [0, 1] would otherwise
    be misclassified and scaled by (w, h)."""
    if normalized is not None:
        return normalized
    ok = pts[np.isfinite(pts[:, 0])]
    return len(ok) > 0 and bool((np.abs(ok[:, :2]) <= 1.0).all())


def draw_pose(poses: List[dict], h: int, w: int,
              normalized: Optional[bool] = None) -> np.ndarray:
    """`draw_pose` + `util.draw_{body,hand,face}pose` (`util.py:72-215`):
    limbs as 0.6-dimmed filled ellipses (stickwidth 4), joints as radius-4
    discs, hand edges HSV-coloured lines with radius-4 (0, 0, 255) joints,
    face as radius-3 white dots. Returns a uint8 canvas [h, w, 3]."""
    canvas = np.zeros((h, w, 3), np.uint8)
    for pose in poses:
        body = pose.get("body")
        if body is not None:
            sw, sh = ((float(w), float(h))
                      if _is_normalized(body, normalized)
                      else (1.0, 1.0))
            for (i1, i2), color in zip(_LIMB_SEQ, _COLORS):
                k1, k2 = body[i1 - 1], body[i2 - 1]
                if not (np.isfinite(k1[0]) and np.isfinite(k2[0])):
                    continue
                # JAX's names: yy holds the x coordinates, xx the y ones
                yy = np.array([k1[0], k2[0]]) * sw
                xx = np.array([k1[1], k2[1]]) * sh
                m_x, m_y = xx.mean(), yy.mean()
                length = float(np.hypot(xx[0] - xx[1], yy[0] - yy[1]))
                angle = math.degrees(math.atan2(xx[0] - xx[1],
                                                yy[0] - yy[1]))
                poly = ellipse2poly((int(m_y), int(m_x)),
                                    (int(length / 2), 4), int(angle),
                                    0, 360, 1)
                fill_convex_poly(canvas, poly,
                                 [int(float(c) * 0.6) for c in color])
            for kpt, color in zip(body, _COLORS):
                if not np.isfinite(kpt[0]):
                    continue
                fill_circle(canvas, (int(kpt[0] * sw), int(kpt[1] * sh)),
                            4, color)
        for hand_key in ("left_hand", "right_hand"):
            hand = pose.get(hand_key)
            if hand is None:
                continue
            sw, sh = ((float(w), float(h))
                      if _is_normalized(hand, normalized)
                      else (1.0, 1.0))
            for ie, (e1, e2) in enumerate(_HAND_EDGES):
                k1, k2 = hand[e1], hand[e2]
                if not (np.isfinite(k1[0]) and np.isfinite(k2[0])):
                    continue
                x1, y1 = int(k1[0] * sw), int(k1[1] * sh)
                x2, y2 = int(k2[0] * sw), int(k2[1] * sh)
                if min(x1, y1, x2, y2) > _EPS:
                    col = hsv_to_rgb(
                        [ie / float(len(_HAND_EDGES)), 1.0, 1.0]) * 255
                    draw_line(canvas, (x1, y1), (x2, y2), col, thickness=2)
            for kpt in hand:
                if not np.isfinite(kpt[0]):
                    continue
                x, y = int(kpt[0] * sw), int(kpt[1] * sh)
                if x > _EPS and y > _EPS:
                    fill_circle(canvas, (x, y), 4, (0, 0, 255))
        face = pose.get("face")
        if face is not None:
            sw, sh = ((float(w), float(h))
                      if _is_normalized(face, normalized)
                      else (1.0, 1.0))
            for kpt in face:
                if not np.isfinite(kpt[0]):
                    continue
                x, y = int(kpt[0] * sw), int(kpt[1] * sh)
                if x > _EPS and y > _EPS:
                    fill_circle(canvas, (x, y), 3, (255, 255, 255))
    return canvas


def render_pose_video(keypoints: np.ndarray, scores: np.ndarray,
                      h: int, w: int,
                      normalized: Optional[bool] = None) -> np.ndarray:
    """Raw per-frame wholebody keypoints [T, P, 133, 2] (normalized or
    pixel) + scores [T, P, 133] -> control video [T, H, W, 3] float 0..1,
    the whole post-ONNX half of `VideoToPose`."""
    t = keypoints.shape[0]
    out = np.zeros((t, h, w, 3), np.float32)
    for i in range(t):
        info = wholebody_to_openpose(keypoints[i], scores[i])
        poses = [split_parts(p) for p in info]
        out[i] = draw_pose(poses, h, w,
                           normalized=normalized
                           ).astype(np.float32) / 255.0
    return out
