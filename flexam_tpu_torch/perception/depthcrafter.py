"""The DepthCrafter video-depth surface (reference `pipelines.py:1307-1360`,
`predict_depthcrafter`).

Port of `flexam_tpu/perception/depthcrafter.py`: the 64-multiple resize
rules with the `max_res` cap, the windowed diffusion driver
(`window_size=110, overlap=25, guidance_scale=1.2, num_inference_steps=25`;
windows cross-faded linearly over the shared frames), the three-channel ->
mono reduction, the whole-video min-max normalization and the nearest
restore to the original size. The denoiser is injectable; with
FLEXAM_DEPTHCRAFTER_CKPT + FLEXAM_SVD_VAE the registry's backend runs the
SVD UNet (`perception/depthcrafter_model.py`), otherwise JAX's substitute
(the depth stack, tiled to three channels).

JAX resizes float frames with `cv2.resize` (INTER_LINEAR); the port with
`utils/media.resize_frames_linear`, OpenCV's taps in numpy.
"""

from __future__ import annotations

import sys
from typing import Callable, Optional

import numpy as np


def _resize_dims(orig_h: int, orig_w: int, max_res: int) -> tuple:
    """The reference's sizing rules (`pipelines.py:1311-1327`): each side
    rounded to a multiple of 64; above `max_res`, rescaled from the
    ORIGINAL size before rounding."""
    height = round(orig_h / 64) * 64
    width = round(orig_w / 64) * 64
    if max(height, width) > max_res:
        scale = max_res / max(orig_h, orig_w)
        height = round(orig_h * scale / 64) * 64
        width = round(orig_w * scale / 64) * 64
    if width <= 0 or height <= 0:
        raise ValueError(f"Invalid dimensions: {width}x{height}")
    return height, width


def _substitute_denoiser(frames: np.ndarray, guidance_scale: float,
                         num_inference_steps: int) -> np.ndarray:
    """Stand-in for the external DepthCrafter pipe: the depth stack, tiled
    to the pipe's 3-channel output."""
    from flexam_tpu_torch.perception.depth import estimate_depth
    print("WARNING: DepthCrafter checkpoint is external (the reference "
          "ships it as a disabled branch); using the native depth stack "
          "as the denoiser substitute", file=sys.stderr)
    d = estimate_depth(frames).astype(np.float32)
    return np.repeat(d[..., None], 3, axis=-1)


def predict_depthcrafter(
    video: np.ndarray,
    denoiser: Optional[Callable] = None,
    max_res: int = 1024,
    guidance_scale: float = 1.2,
    num_inference_steps: int = 25,
    window_size: int = 110,
    overlap: int = 25,
) -> np.ndarray:
    """The reference's DepthCrafter surface (`pipelines.py:1307-1360`).

    video: [T, 3, H, W] or [T, H, W, 3], [0, 255] or [0, 1] floats (the
    /255 only for inputs that look like pixel bytes). Returns depth
    [T, H, W] float32 in [0, 1], nearest-resized to the original size."""
    from flexam_tpu_torch.utils.media import resize_frames_linear

    v = np.asarray(video)
    if v.ndim != 4:
        raise ValueError(f"expected 4D video, got {v.shape}")
    if v.shape[1] == 3 and v.shape[-1] != 3:
        v = v.transpose(0, 2, 3, 1)
    ori_h, ori_w = v.shape[1], v.shape[2]
    height, width = _resize_dims(ori_h, ori_w, max_res)
    frames = resize_frames_linear(np.asarray(v, np.float32),
                                  (height, width)).astype(np.float32)
    if frames.max() > 1.5:            # pixel-byte input, as the reference
        frames = frames / 255.0       # always has (`frame.astype/255`)

    fn = denoiser if denoiser is not None else _substitute_denoiser
    t = frames.shape[0]
    if t <= window_size:
        res = np.asarray(fn(frames, guidance_scale=guidance_scale,
                            num_inference_steps=num_inference_steps),
                         np.float32)
    else:
        # overlap-blend windows: a linear cross-fade over the shared frames
        res = None
        start = 0
        while True:
            end = min(start + window_size, t)
            piece = np.asarray(
                fn(frames[start:end], guidance_scale=guidance_scale,
                   num_inference_steps=num_inference_steps), np.float32)
            if res is None:
                res = piece
            else:
                ov = res.shape[0] - start          # shared frame count
                w_new = (np.arange(1, ov + 1, dtype=np.float32)
                         / (ov + 1))[:, None, None, None]
                res[start:] = res[start:] * (1 - w_new) + piece[:ov] * w_new
                res = np.concatenate([res, piece[ov:]], axis=0)
            if end == t:
                break
            start = end - overlap
    # three channels -> mono, whole-video min-max, nearest restore
    # (`pipelines.py:1353-1358`)
    res = res.sum(-1) / res.shape[-1]
    res = (res - res.min()) / (res.max() - res.min())
    # torch F.interpolate(mode="nearest") semantics: the floor index
    ih = np.minimum((np.arange(ori_h) * (height / ori_h)).astype(np.int64),
                    height - 1)
    iw = np.minimum((np.arange(ori_w) * (width / ori_w)).astype(np.int64),
                    width - 1)
    return np.ascontiguousarray(res[:, ih[:, None], iw[None, :]]
                                ).astype(np.float32)


def _depthcrafter_backend(video: np.ndarray, device="cuda", dtype=None,
                          **kw) -> np.ndarray:
    """Registry adapter: video [T, H, W, 3] float 0..1 -> depth [T, H, W].
    With FLEXAM_DEPTHCRAFTER_CKPT (+ FLEXAM_SVD_VAE) set, the denoiser is
    the SVD UNet's diffusion loop, loaded for the call (as JAX's) onto
    `device` in `dtype` (the loader's bfloat16 unless given); otherwise the
    substitute. Other keywords go to `predict_depthcrafter`."""
    import os
    if kw.get("denoiser") is None and os.environ.get(
            "FLEXAM_DEPTHCRAFTER_CKPT"):
        from flexam_tpu_torch.perception.depthcrafter_model import \
            load_depthcrafter_denoiser
        kw["denoiser"] = load_depthcrafter_denoiser(
            device=device, **({} if dtype is None else {"dtype": dtype}))
    return predict_depthcrafter(video, **kw)
