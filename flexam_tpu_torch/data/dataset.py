"""FlexAM control-video training datasets.

Port of `flexam_tpu/data/dataset.py` (reference
`FlexAM/data/dataset_dasv2_enhanced.py`, `ImageVideoControlDataset`,
get_batch :975-1315, __getitem__ :1319-1376, and
`dataset_image_video.py:336-513`, `ImageVideoDataset`). Schema per
annotation row (CSV or JSON list of dicts): file_path, text,
control_file_path, depth_file_path, cos_file_paths (missing levels
inferred from the `_cos_i_{i}` pattern, :1212-1216), mask_file_path,
density (the sample carries 1/density, :1340), generate_type in
{full_tracking, fg_tracking, bg_tracking} (:979); `type` in {image, video}
for the joint dataset. A bad sample is replaced by a random one
(:1322-1352).

JAX reads videos through cv2 and images through PIL; the port reads its
own media formats (`utils.media`): videos as `.npz` frame dumps or 4-dim
`.npy`, images as `.npy` / `.npz`, resized as OpenCV's INTER_LINEAR and
PIL's bicubic resize do, and raises on `.mp4` / `.png`, naming the decoder
it lacks. Samples are host numpy arrays.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Dict, List, Optional

import numpy as np

from flexam_tpu_torch.utils.media import (_read_video, _rgb, read_image,
                                          resize_image_u8)


def get_random_mask(shape, rng: np.random.RandomState,
                    image_start_only: bool = True) -> np.ndarray:
    """Random inpaint-mask synthesis (`dataset_dasv2_enhanced.py:31-116`);
    the FlexAM trainer takes the image_start_only branch: frame 0 known,
    every later frame masked."""
    f, c, h, w = shape
    mask = np.zeros((f, 1, h, w), np.uint8)
    if image_start_only:
        mask[1:] = 1
        return mask
    choice = rng.choice(10, p=[0.05, 0.2, 0.2, 0.2, 0.05, 0.05, 0.05,
                               0.1, 0.05, 0.05]) if f != 1 \
        else rng.choice([0, 1], p=[0.2, 0.8])
    if choice == 0:
        cx, cy = rng.randint(0, w), rng.randint(0, h)
        bx = rng.randint(w // 4, w // 4 * 3)
        by = rng.randint(h // 4, h // 4 * 3)
        mask[:, :, max(cy - by // 2, 0):min(cy + by // 2, h),
             max(cx - bx // 2, 0):min(cx + bx // 2, w)] = 1
    elif choice == 2 and f > 1:
        mask[rng.randint(1, 5):] = 1
    elif choice == 3 and f > 1:
        i = rng.randint(1, 5)
        mask[i:-i] = 1
    else:
        mask[:] = 1
    return mask


def _annotations(ann_path: str) -> List[Dict]:
    with open(ann_path) as f:
        if ann_path.endswith(".json"):
            return json.load(f)
        return list(csv.DictReader(f))


class _Annotated:
    """Rows of an annotation file, paths relative to `data_root`, and the
    retry-on-bad-sample loop (`:1322-1352`)."""

    def __init__(self, ann_path: str, data_root: Optional[str], seed: int):
        self.data_root = data_root or os.path.dirname(ann_path)
        self.dataset: List[Dict] = _annotations(ann_path)
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.dataset)

    def _path(self, p: str) -> str:
        return p if os.path.isabs(p) else os.path.join(self.data_root, p)

    def get_batch(self, idx: int) -> Dict:
        raise NotImplementedError

    def __getitem__(self, idx: int) -> Dict:
        for _ in range(64):
            try:
                return self.get_batch(idx)
            except Exception as e:
                print(f"dataset: sample {idx} failed ({e}); resampling")
                idx = int(self.rng.randint(0, len(self)))
        raise RuntimeError("too many consecutive bad samples")


def _unit_range(frames: np.ndarray) -> np.ndarray:
    """uint8 [F, H, W, 3] -> float32 [3, F, H, W] in [-1, 1]."""
    return (frames.transpose(3, 0, 1, 2).astype(np.float32)
            / 255.0) * 2.0 - 1.0


class ImageVideoControlDataset(_Annotated):
    """Annotation-driven dataset for FlexAM control training."""

    def __init__(self, ann_path: str, data_root: Optional[str] = None,
                 video_sample_size=(512, 896), video_sample_n_frames=49,
                 cos_level: int = 4, enable_inpaint: bool = True,
                 seed: int = 0):
        super().__init__(ann_path, data_root, seed)
        self.sample_size = tuple(video_sample_size)
        self.n_frames = video_sample_n_frames
        self.cos_level = cos_level
        self.enable_inpaint = enable_inpaint

    def _frames(self, path: str) -> np.ndarray:
        return _read_video(self._path(path), self.sample_size,
                           self.n_frames, fps=None)

    def _video(self, path: str) -> np.ndarray:
        """[3, T, H, W] float in [-1, 1] (training normalization)."""
        return _unit_range(self._frames(path))

    def _cos_paths(self, info: Dict) -> List[str]:
        """Missing cos levels inferred from the `_cos_i_{i}` pattern
        (`dataset_dasv2_enhanced.py:1212-1216`)."""
        paths = info.get("cos_file_paths")
        if isinstance(paths, str):
            paths = json.loads(paths) if paths.startswith("[") else [paths]
        paths = list(paths or [])
        if paths and len(paths) < self.cos_level:
            for i in range(len(paths), self.cos_level):
                paths.append(paths[0].replace("_cos_i_0", f"_cos_i_{i}"))
        return paths[: self.cos_level]

    def get_batch(self, idx: int) -> Dict:
        info = self.dataset[idx]
        generate_type = info.get("generate_type", "full_tracking")
        sample = {
            "text": info["text"],
            "pixel_values": self._video(info["file_path"]),
            "control_pixel_values": self._video(info["control_file_path"]),
            "generate_type": generate_type,
        }
        if info.get("depth_file_path"):
            sample["depth_pixel_values"] = self._video(
                info["depth_file_path"])
        cos = [self._video(p) for p in self._cos_paths(info)]
        if cos:
            sample["cos_pixel_values_list"] = cos
        if info.get("density"):
            # stored as 1/density (`:1340`)
            sample["density"] = np.float32(1.0 / float(info["density"]))
        mask = None
        if info.get("mask_file_path"):
            arr = self._frames(info["mask_file_path"])
            mask = (arr.mean(-1) > 127).astype(np.float32)[:, None]
        if generate_type in ("fg_tracking", "bg_tracking") and mask is None:
            raise ValueError(
                f"mask_file_path required for generate_type {generate_type}")
        if generate_type == "full_tracking" and self.enable_inpaint:
            f = sample["pixel_values"].shape[1]
            h, w = sample["pixel_values"].shape[2:]
            mask = get_random_mask((f, 1, h, w), self.rng).astype(
                np.float32).transpose(1, 0, 2, 3)
        elif mask is not None:
            mask = mask.transpose(1, 0, 2, 3)
            if generate_type == "bg_tracking":
                mask = 1.0 - mask
            mask[:, 0] = 0.0       # frame 0 always known
        sample["mask"] = mask
        return sample


class ImageVideoDataset(_Annotated):
    """Joint image + video dataset (the Fun-dataset family,
    `dataset_image_video.py:336-513`): rows carry `type` in {image, video};
    images come back as 1-frame clips at `image_sample_size`, videos as
    `video_sample_n_frames` clips at `video_sample_size`; optional random
    inpaint masks (the non-image_start_only branch) and per-video colour
    jitter. Batches must hold one type: `type_separated_batches`."""

    def __init__(self, ann_path: str, data_root: Optional[str] = None,
                 image_sample_size=(512, 512),
                 video_sample_size=(512, 896), video_sample_n_frames=49,
                 enable_inpaint: bool = True, enable_jitter: bool = False,
                 seed: int = 0):
        super().__init__(ann_path, data_root, seed)
        self.image_sample_size = tuple(image_sample_size)
        self.video_sample_size = tuple(video_sample_size)
        self.n_frames = video_sample_n_frames
        self.enable_inpaint = enable_inpaint
        self.enable_jitter = enable_jitter

    def sample_type(self, idx: int) -> str:
        return self.dataset[idx].get("type", "image")

    def get_batch(self, idx: int) -> Dict:
        info = self.dataset[idx]
        dtype_tag = info.get("type", "image")
        if dtype_tag == "video":
            arr = _read_video(self._path(info["file_path"]),
                              self.video_sample_size, self.n_frames,
                              fps=None)                          # [T,H,W,3]
        else:
            img = _rgb(read_image(self._path(info["file_path"])))
            arr = resize_image_u8(img, self.image_sample_size)[None]
        if self.enable_jitter:
            from flexam_tpu_torch.data.augment import video_color_jitter
            arr = video_color_jitter(arr, rng=self.rng)
        pixel = _unit_range(arr)                                  # [3,F,H,W]
        sample = {"text": info.get("text", ""), "pixel_values": pixel,
                  "data_type": dtype_tag}
        if self.enable_inpaint:
            f, h, w = pixel.shape[1:]
            m = get_random_mask((f, 1, h, w), self.rng,
                                image_start_only=False)
            sample["mask"] = m.astype(np.float32).transpose(1, 0, 2, 3)
        return sample


def type_separated_batches(dataset: ImageVideoDataset, batch_size: int,
                           rng: Optional[np.random.RandomState] = None):
    """Index batches of one sample type each (the `ImageVideoSampler`
    contract, `dataset_image_video.py:260-306`): image and video samples
    never share a batch (their shapes differ)."""
    r = rng or np.random
    buckets: Dict[str, List[int]] = {"image": [], "video": []}
    for idx in r.permutation(len(dataset)):
        kind = dataset.sample_type(int(idx))
        buckets[kind].append(int(idx))
        if len(buckets[kind]) == batch_size:
            yield buckets[kind]
            buckets[kind] = []
    for bucket in buckets.values():
        if bucket:
            yield bucket
