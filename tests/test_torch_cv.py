"""The node pack's OpenCV steps rebuilt without OpenCV
(`flexam_tpu_torch/utils/cv.py`) against `cv2` itself, pixel for pixel:
`rgb_to_gray_cv` against `cv2.cvtColor(RGB2GRAY)` on every colour,
`canny_u8` against `cv2.Canny` on random, textured and flat frames with
several threshold pairs (`low > high` among them, and fractional ones),
`fill_circle` against `cv2.circle(..., -1)` for radii 1-99 on the
KJNodes heatmap's 200x200 canvas and on canvases the circle leaves, and
`rgb_to_hsv_u8` / `hsv_to_rgb_u8` against `cv2.cvtColor` RGB2HSV /
HSV2RGB on all 256^3 inputs (HSV2RGB in rows that OpenCV takes in its
vector loop and in rows that it takes in its scalar tail)."""

import cv2
import numpy as np
import pytest

from flexam_tpu_torch.utils.cv import (HSV_SIMD_COLUMNS, canny_u8,
                                       fill_circle, hsv_to_rgb_u8,
                                       rgb_to_gray_cv, rgb_to_hsv_u8)

THRESHOLDS = [(100, 200), (50, 150), (200, 100), (0, 0), (30.7, 90.2),
              (10, 255), (255, 255)]


def _textured(h, w, seed):
    """A smooth random field with fine noise: long edge chains and many
    weak pixels, the case that exercises the hysteresis."""
    rs = np.random.RandomState(seed)
    base = rs.rand(h // 8 + 1, w // 8 + 1)
    x = cv2.resize(base, (w, h), interpolation=cv2.INTER_CUBIC)
    x = x + 0.1 * rs.randn(h, w)
    return np.clip(x * 255, 0, 255).astype(np.uint8)


def _frames():
    rs = np.random.RandomState(0)
    flat = np.full((20, 30), 7, np.uint8)
    step = np.zeros((24, 40), np.uint8)
    step[:, 17:] = 200
    step[9:, 5:11] = 90
    return {"random": rs.randint(0, 256, (48, 64), np.uint8),
            "textured": _textured(96, 128, 1),
            "textured_odd": _textured(57, 83, 2),
            "flat": flat, "step": step,
            "one_row": rs.randint(0, 256, (1, 16), np.uint8)}


def test_gray_equals_opencv_on_every_colour():
    c = np.arange(256, dtype=np.uint8)
    rgb = np.stack(np.meshgrid(c, c, c, indexing="ij"), -1).reshape(
        -1, 1, 3)
    np.testing.assert_array_equal(rgb_to_gray_cv(rgb)[:, 0],
                                  cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY)[:, 0])


@pytest.mark.parametrize("name", list(_frames()))
def test_canny_equals_opencv(name):
    g = _frames()[name]
    for low, high in THRESHOLDS:
        want = cv2.Canny(g, low, high)
        got = canny_u8(g, low, high)
        assert got.dtype == np.uint8 and got.shape == g.shape
        np.testing.assert_array_equal(got, want,
                                      err_msg=f"{name} {low} {high}")


def test_canny_batch_equals_frames():
    """[T, H, W] in one call: the frames do not link across each other."""
    frames = np.stack([_textured(40, 56, s) for s in range(3)])
    got = canny_u8(frames, 60, 120)
    for f, e in zip(frames, got):
        np.testing.assert_array_equal(e, cv2.Canny(f, 60, 120))
    assert got[0].any()


def test_fill_circle_equals_opencv():
    for r in range(1, 100):
        for center, shape in (((100, 100), (200, 200)), ((3, 5), (40, 50)),
                              ((45, -2), (40, 50)), ((20, 20), (41, 43)),
                              ((-30, 10), (30, 30))):
            got = fill_circle(np.zeros(shape, np.float32), center, r, 1)
            want = cv2.circle(np.zeros(shape, np.float32), center, r, 1, -1)
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{r} {center} {shape}")
    # the KJNodes heatmap's disc, on a uint8 canvas too
    np.testing.assert_array_equal(
        fill_circle(np.zeros((200, 200), np.uint8), (100, 100), 99, 255),
        cv2.circle(np.zeros((200, 200), np.uint8), (100, 100), 99, 255, -1))


def _cube():
    c = np.arange(256, dtype=np.uint8)
    return np.stack(np.meshgrid(c, c, c, indexing="ij"), -1).reshape(-1, 3)


def test_rgb_to_hsv_equals_opencv_on_every_colour():
    rgb = _cube().reshape(4096, 4096, 3)
    np.testing.assert_array_equal(rgb_to_hsv_u8(rgb),
                                  cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV))


@pytest.mark.parametrize("width", [4096, HSV_SIMD_COLUMNS // 2],
                         ids=["vector_loop", "scalar_tail"])
def test_hsv_to_rgb_equals_opencv_on_every_triple(width):
    """Every (h, s, v) byte triple, h past 179 too: rows of 4096 run
    OpenCV's vector loop (truncating), rows of 16 its scalar tail
    (rounding)."""
    hsv = _cube().reshape(-1, width, 3)
    np.testing.assert_array_equal(hsv_to_rgb_u8(hsv),
                                  cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))


def test_hsv_row_split_equals_opencv():
    """Rows whose width is not a multiple of the vector loop's 32 pixels:
    the loop's columns truncate, the tail's round."""
    hsv = np.random.RandomState(3).randint(0, 256, (40, 77, 3), np.uint8)
    np.testing.assert_array_equal(hsv_to_rgb_u8(hsv),
                                  cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))
