"""Media input and output: videos and images <-> numpy arrays.

Port of `flexam_tpu/utils/media.py` (`get_video_input`,
`get_image_to_video_input`, `get_maskvideo_input`, `get_image_latent`,
`save_video`, and the writers `save_videos_grid`,
`save_videos_comparison`, `merge_video_audio`, `color_transfer`).
Tensors are numpy [B, C, T, H, W] float32 in [0, 1]; `sample_size` is
(height, width).

JAX decodes files with OpenCV and PIL, which the card's machine lacks and
the port does not import. The readers here take what needs no decoder:

  * numpy arrays, as JAX's readers do;
  * `.npy` files (a video [T, H, W, 3], an image [H, W, 3] or [H, W]);
  * `.npz` frame dumps as JAX's own `save_video` writes them when no
    encoder is present (`video` uint8 [T, H, W, 3] and `fps`), and images
    saved the same way (`image`).

Any other file raises, naming the decoder it would need. Resizing, where a
file is not at `sample_size` already, is the port's own: images follow
PIL's `resize` (bicubic, antialiased when shrinking) in PIL's own 22-bit
fixed point, so equal to it; video frames follow OpenCV's `INTER_LINEAR`
in its own 11-bit fixed point (`utils.cv.resize_u8_linear`), so equal to
it. At `sample_size` both
return the frames unchanged, as PIL and OpenCV do.

`save_video` writes through `imageio` when it imports, else the `.npz`
frame dump (JAX's order, without its OpenCV step). The writers' OpenCV
steps are rebuilt in numpy: `save_videos_comparison` resizes as
`cv2.resize` (INTER_LINEAR, half-pixel centres) does float frames, and
`color_transfer` converts RGB <-> LAB as `cv2.cvtColor` does uint8 images,
in OpenCV's fixed point and scaling of L, a and b (within one level).
`merge_video_audio` runs the same `ffmpeg` command as JAX.
"""

from __future__ import annotations

import functools
import math
import os
import subprocess
from typing import Optional, Tuple, Union

import numpy as np

VIDEO_EXTENSIONS = (".mp4", ".avi", ".mov", ".mkv", ".webm", ".m4v", ".flv",
                    ".wmv")
_PRECISION_BITS = 32 - 8 - 2       # PIL's fixed point for 8-bit images


def _no_decoder(path: str, what: str):
    return ValueError(
        f"cannot read {path}: decoding this {what} needs "
        f"{'OpenCV or imageio' if what == 'video' else 'PIL'}, which the "
        "PyTorch port does not use. Pass a numpy array, an .npy file, or an "
        ".npz frame dump (keys video [T, H, W, 3] uint8 and fps, as "
        "save_video writes without an encoder)")


def is_video_path(path: Optional[str]) -> bool:
    """A video file by extension, an .npz frame dump with a `video` key, or
    an .npy of 4 dims."""
    if not path:
        return False
    low = path.lower()
    if low.endswith(VIDEO_EXTENSIONS):
        return True
    if low.endswith(".npz"):
        with np.load(path) as z:
            return "video" in z.files
    if low.endswith(".npy"):
        return np.load(path, mmap_mode="r").ndim == 4
    return False


# ---------------------------------------------------------------------------
# Resampling
# ---------------------------------------------------------------------------

def _bicubic(x: np.ndarray) -> np.ndarray:
    """PIL's bicubic filter (a = -0.5)."""
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0,
                    np.where(x < 2.0, (((x - 5.0) * x + 8.0) * x - 4.0) * a,
                             0.0))


def _pil_coeffs(in_n: int, out_n: int):
    """PIL's `precompute_coeffs` for the bicubic filter and its 8-bit fixed
    point (`normalize_coeffs_8bpc`): per output pixel the first input index
    and the integer weights [out_n, k]."""
    scale = in_n / out_n
    fscale = max(scale, 1.0)
    support = 2.0 * fscale
    ksize = int(np.ceil(support)) * 2 + 1
    bounds = np.zeros(out_n, np.int64)
    kk = np.zeros((out_n, ksize), np.int64)
    for xx in range(out_n):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_n) - xmin
        w = _bicubic((np.arange(xmax) + xmin - center + 0.5) * (1.0 / fscale))
        total = 0.0
        for v in w:          # PIL sums in order
            total += v
        if total != 0.0:
            w = w / total
        scaled = w * (1 << _PRECISION_BITS)
        kk[xx, :xmax] = np.where(w < 0, (-0.5 + scaled).astype(np.int64),
                                 (0.5 + scaled).astype(np.int64))
        bounds[xx] = xmin
    return bounds, kk


def _pil_pass(img: np.ndarray, out_n: int, axis: int) -> np.ndarray:
    """One PIL resampling pass over `axis` of a uint8 array."""
    in_n = img.shape[axis]
    bounds, kk = _pil_coeffs(in_n, out_n)
    x = np.moveaxis(img, axis, -1).astype(np.int64)
    idx = np.clip(bounds[:, None] + np.arange(kk.shape[1]), 0, in_n - 1)
    acc = (x[..., idx] * kk).sum(-1) + (1 << (_PRECISION_BITS - 1))
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, -1, axis)


def resize_image_u8(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """PIL's `Image.resize((w, h))` (default bicubic) of a uint8 [H, W] or
    [H, W, C] image, to `size` = (h, w): the horizontal pass first, each
    pass rounded to uint8, as PIL does."""
    h, w = size
    out = np.asarray(img, np.uint8)
    if out.shape[:2] == (h, w):
        return out.copy()
    if out.shape[1] != w:
        out = _pil_pass(out, w, 1)
    if out.shape[0] != h:
        out = _pil_pass(out, h, 0)
    return out


def resize_frames_linear(frames: np.ndarray, size: Tuple[int, int]
                         ) -> np.ndarray:
    """`cv2.resize(frame, (w, h))` (INTER_LINEAR) of float frames
    [T, H, W, C], in the frames' dtype: OpenCV's taps (`utils.cv.linear_taps`
    at float64 positions: half-pixel centres, clamped borders, no
    antialiasing), rows after columns."""
    from flexam_tpu_torch.utils.cv import linear_taps
    h, w = size
    x = np.asarray(frames)
    lo, hi, fr = linear_taps(x.shape[2], w, dtype=np.float64)
    fr = fr.astype(x.dtype)[None, None, :, None]
    x = x[:, :, lo] * (1 - fr) + x[:, :, hi] * fr
    lo, hi, fr = linear_taps(x.shape[1], h, dtype=np.float64)
    fr = fr.astype(x.dtype)[None, :, None, None]
    return x[:, lo] * (1 - fr) + x[:, hi] * fr


def _cubic_taps(in_n: int, out_n: int):
    """OpenCV's INTER_CUBIC taps (`interpolateCubic`, a = -0.75): half-pixel
    centres, four taps from floor(f) - 1, indices clamped to the border
    (replicated pixels), no antialiasing; the weights computed in float64
    and stored as float32, as OpenCV 5 does. ([out_n, 4] indices,
    [out_n, 4] weights)."""
    f = (np.arange(out_n) + 0.5) * (in_n / out_n) - 0.5
    lo = np.floor(f)
    x = f - lo
    a = -0.75
    c0 = ((a * (x + 1) - 5 * a) * (x + 1) + 8 * a) * (x + 1) - 4 * a
    c1 = ((a + 2) * x - (a + 3)) * x * x + 1
    c2 = ((a + 2) * (1 - x) - (a + 3)) * (1 - x) * (1 - x) + 1
    c3 = 1 - c0 - c1 - c2
    idx = np.clip(lo.astype(np.int64)[:, None] + np.arange(-1, 3), 0,
                  in_n - 1)
    return idx, np.stack([c0, c1, c2, c3], axis=1).astype(np.float32)


def resize_frames_cubic(frames: np.ndarray, size: Tuple[int, int]
                        ) -> np.ndarray:
    """`cv2.resize(frame, (w, h), interpolation=cv2.INTER_CUBIC)` of float32
    frames [T, H, W, C]: columns first, then rows, each a sum of four taps
    in order, in float32 (OpenCV's vectorized row pass may round its sums
    otherwise by an ulp)."""
    h, w = size
    x = np.asarray(frames, np.float32)
    idx, wt = _cubic_taps(x.shape[2], w)
    acc = x[:, :, idx[:, 0]] * wt[None, None, :, 0, None]
    for k in range(1, 4):
        acc = acc + x[:, :, idx[:, k]] * wt[None, None, :, k, None]
    idx, wt = _cubic_taps(x.shape[1], h)
    out = acc[:, idx[:, 0]] * wt[None, :, 0, None, None]
    for k in range(1, 4):
        out = out + acc[:, idx[:, k]] * wt[None, :, k, None, None]
    return out


def _area_taps(in_n: int, out_n: int):
    """OpenCV's INTER_AREA table for a shrink (`computeResizeAreaTab`): each
    output pixel averages the input cells it covers, the partial cells at
    its ends weighted by their covered fraction. ([out_n, k] indices,
    [out_n, k] float32 weights, zero-padded to the longest run)."""
    scale = in_n / out_n
    rows = []
    for d in range(out_n):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, in_n - f1)
        s2 = min(math.floor(f2), in_n - 1)
        s1 = min(math.ceil(f1), s2)
        taps = []
        if s1 - f1 > 1e-3:
            taps.append((s1 - 1, (s1 - f1) / cell))
        taps += [(s, 1.0 / cell) for s in range(s1, s2)]
        if f2 - s2 > 1e-3:
            taps.append((s2, min(min(f2 - s2, 1.0), cell) / cell))
        rows.append(taps)
    k = max(len(r) for r in rows)
    idx = np.zeros((out_n, k), np.int64)
    wt = np.zeros((out_n, k), np.float32)
    for d, taps in enumerate(rows):
        for j, (s, a) in enumerate(taps):
            idx[d, j], wt[d, j] = s, a
    return idx, wt


def _area_grow_taps(in_n: int, out_n: int):
    """OpenCV's INTER_AREA where a side does not shrink (`resize`'s
    `area_mode` branch): two linear taps a pixel, from floor(d * scale)
    with the fraction (d + 1) - (s + 1) / scale, the last input pixel
    alone at the border."""
    scale = in_n / out_n
    d = np.arange(out_n)
    s = np.floor(d * scale).astype(np.int64)
    f = (d + 1) - (s + 1) * (out_n / in_n)
    f = np.where(f <= 0, 0.0, f - np.floor(f)).astype(np.float32)
    f = np.where(s >= in_n - 1, 0.0, f).astype(np.float32)
    s = np.minimum(s, in_n - 1)
    idx = np.stack([s, np.minimum(s + 1, in_n - 1)], axis=1)
    return idx, np.stack([1 - f, f], axis=1).astype(np.float32)


def resize_frames_area(frames: np.ndarray, size: Tuple[int, int]
                       ) -> np.ndarray:
    """`cv2.resize(frame, (w, h), interpolation=cv2.INTER_AREA)` of frames
    [T, H, W, C] (uint8 or float32). A shrink of both sides takes OpenCV's
    area path (factors that need not be integers): a row's weighted sum
    over its columns, then the rows' weighted sum, both accumulated in
    float32 in OpenCV's order, so equal to it; uint8 results are rounded
    half to even, as `saturate_cast` does. Otherwise OpenCV interpolates
    linearly with area-mode fractions (`_area_grow_taps`), which here runs
    in float32 (OpenCV's uint8 version in 11-bit fixed point lands within
    one level of it)."""
    h, w = size
    x = np.asarray(frames)
    src = x.astype(np.float32)
    shrink = h <= x.shape[1] and w <= x.shape[2]
    taps = _area_taps if shrink else _area_grow_taps
    idx, wt = taps(x.shape[2], w)
    acc = np.zeros(src.shape[:2] + (w, src.shape[3]), np.float32)
    for k in range(idx.shape[1]):
        acc = acc + src[:, :, idx[:, k]] * wt[None, None, :, k, None]
    idx, wt = taps(x.shape[1], h)
    out = acc[:, idx[:, 0]] * wt[None, :, 0, None, None]
    for k in range(1, idx.shape[1]):
        out = out + acc[:, idx[:, k]] * wt[None, :, k, None, None]
    if x.dtype == np.uint8:
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out


def resize_frames_u8(frames: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """OpenCV's `cv2.resize(frame, (w, h))` (INTER_LINEAR) of uint8 frames
    [T, H, W, C], equal to it: `utils.cv.resize_u8_linear`, OpenCV's 11-bit
    fixed point."""
    from flexam_tpu_torch.utils.cv import resize_u8_linear
    return resize_u8_linear(frames, tuple(size))


def to_gray_u8(img: np.ndarray) -> np.ndarray:
    """PIL's convert("L") of an RGB uint8 image (ITU-R 601-2 luma in its
    16-bit fixed point)."""
    img = np.asarray(img)
    if img.ndim == 2:
        return img.astype(np.uint8)
    rgb = img[..., :3].astype(np.int64)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471
             + 0x8000) >> 16).astype(np.uint8)


# ---------------------------------------------------------------------------
# Readers
# ---------------------------------------------------------------------------

def _as_u8(a: np.ndarray) -> np.ndarray:
    """Stored frames as uint8: booleans become 0 / 255, floats in [0, 1]
    are scaled, other types are taken as levels."""
    a = np.asarray(a)
    if a.dtype == np.bool_:
        return a.astype(np.uint8) * 255
    if np.issubdtype(a.dtype, np.floating):
        return np.clip(np.rint(a * 255.0), 0, 255).astype(np.uint8)
    return a.astype(np.uint8)


def read_video_frames(path: str) -> Tuple[np.ndarray, Optional[float]]:
    """(frames uint8 [T, H, W, 3], fps or None) of an .npz frame dump or a
    4-dim .npy."""
    low = path.lower()
    if low.endswith(".npz"):
        with np.load(path) as z:
            if "video" not in z.files:
                raise ValueError(f"{path}: no `video` array in the .npz")
            fps = float(z["fps"]) if "fps" in z.files else None
            return _as_u8(z["video"]), fps
    if low.endswith(".npy"):
        frames = np.load(path)
        if frames.ndim != 4:
            raise ValueError(f"{path}: a video .npy is [T, H, W, 3]")
        return _as_u8(frames), None
    raise _no_decoder(path, "video")


def _read_video(path: str, sample_size, video_length: Optional[int],
                fps: Optional[float]) -> np.ndarray:
    """JAX's `_read_video_cv2`: frames at `sample_size`, every
    (original fps // fps)-th frame when `fps` is given, the first
    `video_length` of them."""
    frames, original_fps = read_video_frames(path)
    if fps is not None and original_fps:
        frames = frames[::max(1, int(original_fps // fps))]
    frames = resize_frames_u8(frames, tuple(sample_size))
    if video_length is not None:
        frames = frames[:video_length]
    return frames


def read_image(path: str) -> np.ndarray:
    """A uint8 image [H, W] or [H, W, C] from an .npy, or an .npz with an
    `image` (or single-frame `video`) array."""
    low = path.lower()
    if low.endswith(".npy"):
        return _as_u8(np.load(path))
    if low.endswith(".npz"):
        with np.load(path) as z:
            if "image" in z.files:
                return _as_u8(z["image"])
            if "video" in z.files:
                return _as_u8(z["video"][0])
        raise ValueError(f"{path}: no `image` array in the .npz")
    raise _no_decoder(path, "image")


def _rgb(img: np.ndarray) -> np.ndarray:
    """PIL's convert("RGB"): grey repeated, alpha dropped."""
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=2)
    if img.shape[2] == 1:
        return np.repeat(img, 3, axis=2)
    return img[..., :3]


def _load_image(img, sample_size) -> np.ndarray:
    """An RGB uint8 image [H, W, 3] at `sample_size`."""
    if isinstance(img, str):
        arr = _rgb(read_image(img))
    else:
        arr = np.asarray(img, np.uint8)
    return resize_image_u8(arr, tuple(sample_size))


def load_mask_image(path: str, sample_size) -> np.ndarray:
    """A grey uint8 mask image at `sample_size` (PIL's convert("L") and
    resize)."""
    return resize_image_u8(to_gray_u8(read_image(path)), tuple(sample_size))


def get_video_input(
    input_video: Union[str, np.ndarray, None],
    video_length: Optional[int],
    sample_size: Tuple[int, int],
    fps: Optional[float] = None,
    validation_video_mask: Optional[str] = None,
    ref_image: Union[str, np.ndarray, None] = None,
):
    """`get_video_to_video_latent`. Returns (video [1,3,T,H,W] in [0,1] |
    None, mask [1,1,T,H,W] in {0,255} | None, ref [1,3,1,H,W] | None)."""
    video = mask = ref = None
    if input_video is not None:
        if isinstance(input_video, str):
            arr = _read_video(input_video, sample_size, video_length, fps)
        else:
            arr = np.asarray(input_video)[:video_length]
        video = (arr.transpose(3, 0, 1, 2)[None].astype(np.float32) / 255.0)
        if validation_video_mask is not None:
            m = load_mask_image(validation_video_mask, sample_size)
            m = np.where(m < 240, 0, 255).astype(np.float32)
            mask = np.tile(m[None, None, None], (1, 1, video.shape[2], 1, 1))
        else:
            mask = np.full((1, 1) + video.shape[2:], 255.0, np.float32)
    if ref_image is not None:
        ref = get_image_latent(ref_image, sample_size)
    return video, mask, ref


def get_image_to_video_input(
    image_start: Union[str, np.ndarray],
    video_length: int,
    sample_size: Tuple[int, int],
    image_end: Union[str, np.ndarray, None] = None,
):
    """`get_image_to_video_latent` (single-image branch): the start frame
    tiled, mask 0 on frame 0 and 255 after."""
    start = _load_image(image_start, sample_size)      # [H, W, 3] uint8
    video = np.tile(start.transpose(2, 0, 1)[None, :, None],
                    (1, 1, video_length, 1, 1)).astype(np.float32) / 255.0
    mask = np.zeros((1, 1, video_length) + start.shape[:2], np.float32)
    mask[:, :, 1:] = 255.0
    if image_end is not None:
        end = _load_image(image_end, sample_size)
        video[:, :, -1] = end.transpose(2, 0, 1).astype(np.float32) / 255.0
        mask[:, :, -1] = 0.0
    return video, mask


def get_maskvideo_input(mask_path: str, video_length: int,
                        sample_size: Tuple[int, int],
                        fps: Optional[float] = None) -> np.ndarray:
    """`get_maskvideo_to_video_latent`: a mask video -> [T, 3, H, W] float
    in [0, 1]."""
    arr = _read_video(mask_path, sample_size, video_length, fps)
    return arr.transpose(0, 3, 1, 2).astype(np.float32) / 255.0


def _pad_image(img: np.ndarray, new_width: int, new_height: int) -> np.ndarray:
    """`padding_image`: aspect-preserving letterbox on white."""
    h, w = img.shape[:2]
    ratio = min(new_width / w, new_height / h)
    rw, rh = int(w * ratio), int(h * ratio)
    resized = resize_image_u8(img, (rh, rw))
    canvas = np.full((new_height, new_width, 3), 255, np.uint8)
    top, left = (new_height - rh) // 2, (new_width - rw) // 2
    canvas[top:top + rh, left:left + rw] = resized
    return canvas


def get_image_latent(ref_image, sample_size,
                     padding: bool = False) -> np.ndarray:
    """`get_image_latent`: -> [1, 3, 1, H, W] in [0, 1]."""
    if isinstance(ref_image, str):
        img = _rgb(read_image(ref_image))
    else:
        img = np.asarray(np.asarray(ref_image), np.uint8)
    if padding:
        img = _pad_image(img, sample_size[1], sample_size[0])
    img = resize_image_u8(img, tuple(sample_size))
    arr = img.astype(np.float32) / 255.0
    return arr.transpose(2, 0, 1)[None, :, None]


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

def save_video(video: np.ndarray, path: str, fps: int = 16):
    """Save [1, 3, T, H, W] or [3, T, H, W] float [0, 1] to `path` through
    imageio; without it, or where it fails, a .npz frame dump at
    `path + ".npz"` (keys video uint8 [T, H, W, 3] and fps), which the
    readers here take. Returns the path written."""
    v = np.asarray(video)
    if v.ndim == 5:
        v = v[0]
    frames = (np.clip(v.transpose(1, 2, 3, 0), 0, 1) * 255).astype(np.uint8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    try:
        import imageio
        imageio.mimsave(path, list(frames), fps=fps)
        return path
    except Exception as e:
        alt = path + ".npz"
        np.savez_compressed(alt, video=frames, fps=fps)
        print(f"video encoders unavailable ({e}); saved raw frames to {alt}")
        return alt


# ---------------------------------------------------------------------------
# Writers of grids, comparisons and audio; colour transfer
# ---------------------------------------------------------------------------

def save_videos_grid(videos: np.ndarray, path: str, n_rows: int = 6,
                     fps: int = 12, rescale: bool = False):
    """`save_videos_grid` (:59-88): [B, C, T, H, W] -> tiled grid video."""
    v = np.asarray(videos)
    b, c, t, h, w = v.shape
    if rescale:
        v = (v + 1.0) / 2.0
    cols = min(n_rows, b)
    rows = (b + cols - 1) // cols
    grid = np.zeros((c, t, rows * h, cols * w), v.dtype)
    for i in range(b):
        r, cc = divmod(i, cols)
        grid[:, :, r * h:(r + 1) * h, cc * w:(cc + 1) * w] = v[i]
    save_video(grid[None], path, fps=fps)


def save_videos_comparison(videos, path: str, fps: int = 16,
                           labels=None):
    """Side-by-side comparison grid (`save_videos_comparison`,
    `utils.py:90-241`): [1, 3, T, H, W]-shaped videos stacked horizontally
    (tracking | original | generated | ...), each cut to the shortest clip
    and resized to the tallest (keeping its aspect, width truncated)."""
    vs = [np.asarray(v) for v in videos]
    t = min(v.shape[2] for v in vs)
    h = max(v.shape[3] for v in vs)

    def fit(v):
        if v.shape[3] != h:
            w = int(v.shape[4] * (h / v.shape[3]))
            frames = resize_frames_linear(
                v[0, :, :t].transpose(1, 2, 3, 0), (h, w))
            return frames.transpose(3, 0, 1, 2)[None]
        return v[:, :, :t]

    grid = np.concatenate([fit(v) for v in vs], axis=4)
    return save_video(grid, path, fps=fps)


def merge_video_audio(video_path: str, audio_path: str):
    """ffmpeg mux (`utils.py:243-301`); best-effort host-side: the muxed
    path, or `video_path` where ffmpeg is missing or fails."""
    out = video_path.replace(".mp4", "_with_audio.mp4")
    cmd = ["ffmpeg", "-y", "-i", video_path, "-i", audio_path, "-c:v",
           "copy", "-c:a", "aac", "-shortest", out]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        return out
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        print(f"audio mux failed ({e}); keeping silent video")
        return video_path


# OpenCV's 8-bit RGB <-> CIE L*a*b* (sRGB, D65), rebuilt in its integer
# arithmetic: the matrices and white point it uses, its fixed-point shifts
# and its tables (`initLabTabs`). LAB -> RGB equals cv2.cvtColor on every
# one of the 256^3 inputs; RGB -> LAB is within one level of it (1,675 of
# the 256^3 colours differ by one, in a or b).
_RGB2XYZ = np.array([[0.412453, 0.357580, 0.180423],
                     [0.212671, 0.715160, 0.072169],
                     [0.019334, 0.119193, 0.950227]])
_XYZ2RGB = np.array([[3.240479, -1.53715, -0.498535],
                     [-0.969256, 1.875991, 0.041556],
                     [0.055648, -0.204043, 1.057311]])
_D65 = np.array([0.950456, 1.0, 1.088754])
_XYZ_SHIFT, _LAB_SHIFT2, _GAMMA_SHIFT = 12, 15, 3
_LAB_BASE, _INV_GAMMA_SHIFT, _MIN_AB = 1 << 14, 12, -8145


def _descale(v, n):
    return (v + (1 << (n - 1))) >> n


@functools.lru_cache(maxsize=1)
def _lab_tables():
    x = np.arange(256) / 255.0
    lin = np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)
    gamma = np.rint(255.0 * (1 << _GAMMA_SHIFT) * lin).astype(np.int64)
    t = np.arange(256 * 3 // 2 * (1 << _GAMMA_SHIFT)) / (
        255.0 * (1 << _GAMMA_SHIFT))
    cbrt = np.rint((1 << _LAB_SHIFT2) * np.where(
        t < 0.008856, t * 7.787 + 16.0 / 116.0, np.cbrt(t))).astype(np.int64)
    to_xyz = np.rint((1 << _XYZ_SHIFT) * _RGB2XYZ
                     / _D65[:, None]).astype(np.int64)
    # LAB -> RGB: y and f(y) by L, x and z by f, linear RGB -> sRGB
    base = _LAB_BASE
    li = np.arange(256) * 100.0 / 255.0
    low = np.arange(256) <= 20
    y = np.rint(base * np.where(low, li / 903.3, ((li + 16) / 116) ** 3))
    fy = np.rint(base * np.where(low, 7.787 * li / 903.3 + 16 / 116,
                                 (li + 16) / 116))
    v = np.arange(_MIN_AB, base * 9 // 4 + _MIN_AB)
    lin_seg = (np.sign(v * 108) * (np.abs(v * 108) // 841)
               - base * 16 // 116 * 108 // 841)
    cube = v * v // base * v
    xz = np.where(v <= 3390, lin_seg, np.sign(cube) * (np.abs(cube) // base))
    to_rgb = np.rint((1 << _XYZ_SHIFT) * _XYZ2RGB
                     * _D65[None, :]).astype(np.int64)
    n = 1 << _INV_GAMMA_SHIFT
    g = np.arange(n) / n
    inv = np.rint(255.0 * np.where(g <= 0.0031308, g * 12.92,
                                   1.055 * g ** (1 / 2.4) - 0.055))
    return (gamma, cbrt, to_xyz, y.astype(np.int64), fy.astype(np.int64),
            xz, to_rgb, inv.astype(np.int64))


def rgb_to_lab_u8(img: np.ndarray) -> np.ndarray:
    """`cv2.cvtColor(img, cv2.COLOR_RGB2LAB)` of uint8 RGB [..., 3]: the
    sRGB curve, XYZ over the D65 white, CIE L*a*b* with OpenCV's 8-bit
    scaling (L * 255 / 100, a + 128, b + 128)."""
    gamma, cbrt, to_xyz = _lab_tables()[:3]
    xyz = _descale(gamma[np.asarray(img, np.int64)] @ to_xyz.T, _XYZ_SHIFT)
    fx, fy, fz = (cbrt[xyz[..., i]] for i in range(3))
    s = _LAB_SHIFT2
    lab = np.stack([
        _descale((116 * 255 + 50) // 100 * fy
                 - (16 * 255 * (1 << s) + 50) // 100, s),
        _descale(500 * (fx - fy) + 128 * (1 << s), s),
        _descale(200 * (fy - fz) + 128 * (1 << s), s)], axis=-1)
    return np.clip(lab, 0, 255).astype(np.uint8)


def lab_to_rgb_u8(lab: np.ndarray) -> np.ndarray:
    """`cv2.cvtColor(lab, cv2.COLOR_LAB2RGB)` of uint8 LAB [..., 3]: the
    inverse of `rgb_to_lab_u8`, linear RGB clipped to [0, 1]."""
    *_, y_tab, fy_tab, xz, to_rgb, inv = _lab_tables()
    lab = np.asarray(lab, np.int64)
    base = _LAB_BASE
    y, fy = y_tab[lab[..., 0]], fy_tab[lab[..., 0]]
    adiv = ((5 * lab[..., 1] * 53687 + (1 << 7)) >> 13) - 128 * base // 500
    bdiv = (((lab[..., 2] * 41943 + (1 << 4)) >> 9)
            - 128 * base // 200 + 1)
    xyz = np.stack([xz[fy + adiv - _MIN_AB], y, xz[fy - bdiv - _MIN_AB]],
                   axis=-1)
    shift = _XYZ_SHIFT + 14 - _INV_GAMMA_SHIFT
    rgb = np.clip(_descale(xyz @ to_rgb.T, shift), 0,
                  (1 << _INV_GAMMA_SHIFT) - 1)
    return inv[rgb].astype(np.uint8)


def color_transfer(source: np.ndarray, target: np.ndarray) -> np.ndarray:
    """LAB-space mean/std transfer (`utils.py:31-57`). [H,W,3] uint8."""
    sc = rgb_to_lab_u8(source).astype(np.float32)
    dc = rgb_to_lab_u8(target).astype(np.float32)
    s_mean, s_std = sc.mean((0, 1)), sc.std((0, 1))
    d_mean, d_std = dc.mean((0, 1)), dc.std((0, 1))
    out = (sc - s_mean) / (s_std + 1e-6) * d_std + d_mean
    out = np.clip(out, 0, 255).astype(np.uint8)
    return lab_to_rgb_u8(out)
