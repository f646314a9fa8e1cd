"""Video colour-jitter augmentation.

Port of `flexam_tpu/data/augment.py` (reference
`FlexAM/data/dataset_dasv2_enhanced.py:388-456`, `video_color_jitter` and
the four adjust_* helpers): one factor set is drawn per video and applied
to every frame, vectorized over frames. The hue rotation goes through HSV
as JAX's does with `cv2.cvtColor`, here `utils.cv.rgb_to_hsv_u8` /
`hsv_to_rgb_u8`, which equal OpenCV 5 byte for byte.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from flexam_tpu_torch.utils.cv import hsv_to_rgb_u8, rgb_to_hsv_u8


def adjust_brightness(img: np.ndarray, factor: float) -> np.ndarray:
    """[..., H, W, C] uint8 -> uint8 (`:388-390`)."""
    return np.clip(img * factor, 0, 255).astype(np.uint8)


def adjust_contrast(img: np.ndarray, factor: float) -> np.ndarray:
    """Per-frame channel mean anchor (`:392-395`)."""
    mean = img.mean(axis=(-3, -2), keepdims=True).astype(np.float32)
    return np.clip((img.astype(np.float32) - mean) * factor + mean,
                   0, 255).astype(np.uint8)


def adjust_saturation(img: np.ndarray, factor: float) -> np.ndarray:
    """Grayscale anchor (`:397-402`)."""
    gray = np.mean(img, axis=-1, keepdims=True).astype(np.float32)
    return np.clip((img.astype(np.float32) - gray) * factor + gray,
                   0, 255).astype(np.uint8)


def adjust_hue(img: np.ndarray, factor: float) -> np.ndarray:
    """HSV hue rotation by factor * 180 over the 0..179 H range
    (`:404-411`), the rotated hue truncated to uint8 as numpy stores it."""
    hsv = rgb_to_hsv_u8(img)
    hsv[..., 0] = (hsv[..., 0] + factor * 180) % 180
    return hsv_to_rgb_u8(hsv)


def video_color_jitter(video: np.ndarray,
                       brightness: float = 0.2, contrast: float = 0.2,
                       saturation: float = 0.2, hue: float = 0.1,
                       rng: Optional[np.random.RandomState] = None
                       ) -> np.ndarray:
    """[F, H, W, C] uint8 -> jittered uint8; one factor set per video
    (`video_color_jitter`, `:413-456`)."""
    assert video.ndim == 4 and video.dtype == np.uint8
    r = rng or np.random
    bf = r.uniform(1 - brightness, 1 + brightness)
    cf = r.uniform(1 - contrast, 1 + contrast)
    sf = r.uniform(1 - saturation, 1 + saturation)
    hf = r.uniform(-hue, hue)
    out = adjust_brightness(video, bf)
    out = adjust_contrast(out, cf)
    out = adjust_saturation(out, sf)
    return adjust_hue(out, hf)
