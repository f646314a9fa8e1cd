"""DWPose: person detection and whole-body pose, the native `VideoToPose`.

Port of `flexam_tpu/perception/dwpose.py`. The reference's DWPose runs two
ONNX models (`dwpose_utils/wholebody.py:41-55`) with numpy pre- and
post-processing:

  * YOLOX person detector: 114-letterbox to 640x640, anchor-grid decode
    over strides (8, 16, 32), class-aware NMS, score / class filtering
    (`dwpose_utils/onnxdet.py`);
  * RTMPose wholebody estimator: bbox -> (center, scale * 1.25) ->
    aspect-fixed top-down affine crop to 288x384, ImageNet normalization,
    SimCC argmax decode with split ratio 2.0, back-projection to image
    coordinates (`dwpose_utils/onnxpose.py`);
  * then the mmpose -> openpose transform and the OpenPose rendering
    (`perception/pose_render.py`).

JAX runs the two graphs through `cv2.dnn`; the port reads the same files
with `io/onnx.py` and runs them with `perception/onnx_graph.py` on
`device` (the card unless the caller asks for the CPU). Pre- and
post-processing stay numpy on the host, as in JAX, with OpenCV's resize,
affine matrix and warp rebuilt in `utils/cv.py` (equal to OpenCV's).
Given the two files (FLEXAM_DWPOSE_DET / FLEXAM_DWPOSE_POSE: yolox_l.onnx
and dw-ll_ucoco_384.onnx), the whole pose annotator runs.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from flexam_tpu_torch.utils.cv import (
    get_affine_transform,
    resize_u8_linear,
    warp_affine_u8,
)


# ---------------------------------------------------------------------------
# YOLOX person detection (onnxdet.py semantics, vectorized)
# ---------------------------------------------------------------------------


def letterbox(img: np.ndarray, size: Tuple[int, int] = (640, 640)
              ) -> Tuple[np.ndarray, float]:
    """Pad-to-114 letterbox, CHW float32 (`onnxdet.py:78-94`)."""
    canvas = np.full((size[0], size[1], 3), 114, np.uint8)
    r = min(size[0] / img.shape[0], size[1] / img.shape[1])
    rh, rw = int(img.shape[0] * r), int(img.shape[1] * r)
    canvas[:rh, :rw] = resize_u8_linear(img[None], (rh, rw))[0]
    return np.ascontiguousarray(canvas.transpose(2, 0, 1), np.float32), r


def yolox_decode(raw: np.ndarray, size: Tuple[int, int],
                 strides=(8, 16, 32)) -> np.ndarray:
    """Anchor-free grid decode (`onnxdet.py:56-76`): xy = (pred + grid) *
    stride, wh = exp(pred) * stride."""
    cells = []
    for s in strides:
        h, w = size[0] // s, size[1] // s
        gx, gy = np.meshgrid(np.arange(w), np.arange(h))
        cells.append(np.stack(
            [gx.reshape(-1), gy.reshape(-1),
             np.full(h * w, s), np.full(h * w, s)], axis=1))
    grid = np.concatenate(cells, axis=0).astype(np.float32)   # [A, 4]
    out = raw.copy()
    out[..., :2] = (out[..., :2] + grid[:, :2]) * grid[:, 2:3]
    out[..., 2:4] = np.exp(out[..., 2:4]) * grid[:, 2:3]
    return out


def nms_xyxy(boxes: np.ndarray, scores: np.ndarray,
             thresh: float) -> List[int]:
    """Greedy IoU NMS with the +1 box-area convention (`onnxdet.py:4-31`)."""
    x1, y1, x2, y2 = boxes.T
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size:
        i = order[0]
        keep.append(int(i))
        rest = order[1:]
        iw = np.maximum(
            0.0, np.minimum(x2[i], x2[rest]) - np.maximum(x1[i], x1[rest])
            + 1)
        ih = np.maximum(
            0.0, np.minimum(y2[i], y2[rest]) - np.maximum(y1[i], y1[rest])
            + 1)
        inter = iw * ih
        iou = inter / (areas[i] + areas[rest] - inter)
        order = rest[iou <= thresh]
    return keep


def detect_people(raw: np.ndarray, ratio: float, nms_thr: float = 0.45,
                  score_thr: float = 0.1, keep_thr: float = 0.3,
                  size=(640, 640)) -> Optional[np.ndarray]:
    """Raw YOLOX head output [A, 5 + classes] -> person boxes [N, 4] xyxy
    in original image coordinates, `inference_detector`'s post
    (`onnxdet.py:109-128`, person = class 0)."""
    pred = yolox_decode(raw, size)
    boxes_cxcywh = pred[:, :4]
    scores = pred[:, 4:5] * pred[:, 5:]
    xyxy = np.empty_like(boxes_cxcywh)
    xyxy[:, 0] = boxes_cxcywh[:, 0] - boxes_cxcywh[:, 2] / 2
    xyxy[:, 1] = boxes_cxcywh[:, 1] - boxes_cxcywh[:, 3] / 2
    xyxy[:, 2] = boxes_cxcywh[:, 0] + boxes_cxcywh[:, 2] / 2
    xyxy[:, 3] = boxes_cxcywh[:, 1] + boxes_cxcywh[:, 3] / 2
    xyxy /= ratio
    dets = []
    for cls in range(scores.shape[1]):
        m = scores[:, cls] > score_thr
        if not m.any():
            continue
        keep = nms_xyxy(xyxy[m], scores[m, cls], nms_thr)
        if keep:
            d = np.concatenate(
                [xyxy[m][keep], scores[m, cls][keep, None],
                 np.full((len(keep), 1), cls, np.float32)], axis=1)
            dets.append(d)
    if not dets:
        return None
    dets = np.concatenate(dets, axis=0)
    m = (dets[:, 4] > keep_thr) & (dets[:, 5] == 0)
    return dets[m, :4]


# ---------------------------------------------------------------------------
# RTMPose top-down crop + SimCC decode (onnxpose.py semantics)
# ---------------------------------------------------------------------------

_MEAN = np.asarray([123.675, 116.28, 103.53], np.float32)
_STD = np.asarray([58.395, 57.12, 57.375], np.float32)


def bbox_center_scale(bbox: np.ndarray, padding: float = 1.25
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """(x1, y1, x2, y2) -> (center, scale * padding)
    (`onnxpose.py:120-153`)."""
    b = np.asarray(bbox, np.float32)
    center = np.asarray([b[0] + b[2], b[1] + b[3]]) * 0.5
    scale = np.asarray([b[2] - b[0], b[3] - b[1]]) * padding
    return center, scale


def fix_aspect(scale: np.ndarray, aspect: float) -> np.ndarray:
    w, h = float(scale[0]), float(scale[1])
    if w > h * aspect:
        return np.asarray([w, w / aspect], np.float32)
    return np.asarray([h * aspect, h], np.float32)


def warp_matrix(center: np.ndarray, scale: np.ndarray,
                out_size: Tuple[int, int]) -> np.ndarray:
    """Top-down affine (rot=0) src -> dst 2x3 matrix
    (`onnxpose.py:208-256`)."""
    w, h = out_size
    src_dir = np.asarray([0.0, -0.5 * scale[0]])
    dst_dir = np.asarray([0.0, -0.5 * w])

    def third(a, b):
        d = a - b
        return b + np.asarray([-d[1], d[0]])

    src = np.zeros((3, 2), np.float32)
    src[0] = center
    src[1] = center + src_dir
    src[2] = third(src[0], src[1])
    dst = np.zeros((3, 2), np.float32)
    dst[0] = [w * 0.5, h * 0.5]
    dst[1] = dst[0] + dst_dir
    dst[2] = third(dst[0], dst[1])
    return get_affine_transform(src, dst)


def crop_person(img: np.ndarray, bbox: np.ndarray,
                input_size: Tuple[int, int] = (288, 384)
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """bbox -> normalized model input [h, w, 3] + (center, fixed scale)."""
    center, scale = bbox_center_scale(bbox)
    scale = fix_aspect(scale, input_size[0] / input_size[1])
    mat = warp_matrix(center, scale, input_size)
    crop = warp_affine_u8(img, mat, (int(input_size[0]),
                                     int(input_size[1])))
    return (crop.astype(np.float32) - _MEAN) / _STD, center, scale


def simcc_decode(simcc_x: np.ndarray, simcc_y: np.ndarray,
                 split_ratio: float = 2.0
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Argmax decode with min(x, y) confidence and -1 for non-positive
    maxima (`onnxpose.py:297-360`)."""
    n, k, _ = simcc_x.shape
    sx = simcc_x.reshape(n * k, -1)
    sy = simcc_y.reshape(n * k, -1)
    locs = np.stack([sx.argmax(1), sy.argmax(1)], axis=-1
                    ).astype(np.float32)
    vals = np.minimum(sx.max(1), sy.max(1))
    locs[vals <= 0.0] = -1
    return (locs.reshape(n, k, 2) / split_ratio,
            vals.reshape(n, k).astype(np.float32))


def keypoints_from_simcc(simcc_x, simcc_y, center, scale,
                         input_size=(288, 384), split_ratio: float = 2.0):
    """Decode + map back to original image coordinates
    (`onnxpose.py:86-117`)."""
    kpts, scores = simcc_decode(simcc_x, simcc_y, split_ratio)
    kpts = (kpts / np.asarray(input_size, np.float32) * scale
            + center - scale / 2)
    return kpts, scores


# ---------------------------------------------------------------------------
# the detector (the two graphs on the device)
# ---------------------------------------------------------------------------


class DWPoseDetector:
    """The full pipeline over the two ONNX graphs, run on `device` by
    `perception/onnx_graph.py`. Produces raw wholebody keypoints and
    scores; compose with `pose_render.render_pose_video` for the control
    video."""

    def __init__(self, det_onnx: str, pose_onnx: str,
                 pose_input: Tuple[int, int] = (288, 384), device="cuda"):
        from flexam_tpu_torch.perception.onnx_graph import OnnxGraph
        self.det = OnnxGraph(det_onnx, device=device)
        self.pose = OnnxGraph(pose_onnx, device=device)
        self.pose_input = pose_input

    def _run(self, net, x: np.ndarray) -> List[np.ndarray]:
        return [o.float().cpu().numpy() for o in net(x)]

    def __call__(self, img: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """img [H, W, 3] uint8 / float -> (keypoints [P, 133, 2] pixel,
        scores [P, 133])."""
        img = np.asarray(img)
        if img.dtype != np.uint8:
            img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        x, ratio = letterbox(img)
        raw = self._run(self.det, x[None])[0]
        boxes = detect_people(np.asarray(raw)[0], ratio)
        if boxes is None:
            # reference: no detection at all -> no poses -> black frame
            # (`Wholebody.__call__` returns None, `wholebody.py:57-59`)
            return (np.zeros((0, 133, 2), np.float32),
                    np.zeros((0, 133), np.float32))
        if len(boxes) == 0:
            # person-filtered-empty: the reference's pose preprocess
            # falls back to the full image (`onnxpose.py:23-25`)
            boxes = np.asarray([[0, 0, img.shape[1], img.shape[0]]],
                               np.float32)
        all_k, all_s = [], []
        for bbox in boxes:
            crop, center, scale = crop_person(img, bbox, self.pose_input)
            out = self._run(self.pose, crop.transpose(2, 0, 1)[None])
            kpts, scores = keypoints_from_simcc(
                out[0], out[1], center, scale, self.pose_input)
            all_k.append(kpts[0])
            all_s.append(scores[0])
        return np.stack(all_k), np.stack(all_s)


def dwpose_video(video: np.ndarray,
                 det_onnx: Optional[str] = None,
                 pose_onnx: Optional[str] = None,
                 device="cuda") -> np.ndarray:
    """[T, H, W, 3] 0..1 -> rendered pose control video [T, H, W, 3], the
    whole `VideoToPose` path (the graphs on `device`)."""
    from flexam_tpu_torch.perception.pose_render import render_pose_video
    det_onnx = det_onnx or os.environ.get("FLEXAM_DWPOSE_DET")
    pose_onnx = pose_onnx or os.environ.get("FLEXAM_DWPOSE_POSE")
    if not (det_onnx and pose_onnx):
        raise RuntimeError("set FLEXAM_DWPOSE_DET / FLEXAM_DWPOSE_POSE to "
                           "the yolox + RTMPose .onnx files")
    detector = DWPoseDetector(det_onnx, pose_onnx, device=device)
    t, h, w = video.shape[:3]
    frames = []
    for i in range(t):
        kpts, scores = detector(video[i])
        # DWPose emits pixel coordinates: say so explicitly instead of
        # letting the value heuristic guess (a degenerate detection inside
        # [0, 1] pixels would otherwise be rescaled by (w, h))
        frames.append(render_pose_video(kpts[None], scores[None], h, w,
                                        normalized=False)[0])
    return np.stack(frames)
