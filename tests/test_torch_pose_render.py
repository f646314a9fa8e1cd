"""The pose renderer and OpenCV's drawing and geometry, rebuilt without
OpenCV (`flexam_tpu_torch/utils/cv.py`, `perception/pose_render.py`).

Each primitive against `cv2` itself, `np.array_equal` on seeded random
cases: `ellipse2poly` (angles and arcs over -400..400 degrees, zero axes),
`fill_convex_poly` (the limbs' ellipses, triangles, polygons leaving the
canvas), `draw_line` at thicknesses 1-3 (lengths 0-200, ends off the
canvas and on its edges), `hsv_to_rgb` against matplotlib, and DWPose's
`resize_u8_linear`, `get_affine_transform` and `warp_affine_u8` (random
affine maps and DWPose's crops), with `media.resize_frames_u8`.

Then the renderer against the JAX package's, pixel for pixel (JAX's draws
with cv2 and matplotlib): `wholebody_to_openpose`, `split_parts`,
`draw_pose` and `render_pose_video` on seeded keypoints, normalized and in
pixels, persons missing a body, hands or face, 3 frames at 96x128. JAX's
own test (`tests/test_pose_render.py`) holds it to the vendored reference,
which this repository does not carry; `test_split_parts_thresholds` is
mirrored here.
"""

import cv2
import matplotlib.colors
import numpy as np
import pytest
import torch

from flexam_tpu.perception import pose_render as jpr
from flexam_tpu_torch.perception import pose_render as tpr
from flexam_tpu_torch.utils import cv as tcv
from flexam_tpu_torch.utils.media import resize_frames_u8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops: beside the other test workers, torch's
    intra-op threads would oversubscribe the cores and stall at every op's
    barrier (tests/test_torch_video_tracking.py), so one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


H, W = 60, 80


def _canvases():
    a = np.zeros((H, W, 3), np.uint8)
    return a, a.copy()


@pytest.mark.parametrize("seed", range(4))
def test_ellipse2poly_equals_opencv(seed):
    rs = np.random.RandomState(seed)
    for i in range(300):
        center = tuple(int(v) for v in rs.randint(-50, 300, 2))
        axes = (int(rs.randint(0, 120)), int(rs.randint(0, 10)))
        angle = int(rs.randint(-400, 400))
        arc = ((0, 360) if i % 2 else
               tuple(int(v) for v in rs.randint(-400, 400, 2)))
        delta = int(rs.randint(1, 30)) if i % 3 else 1
        want = cv2.ellipse2Poly(center, axes, angle, *arc, delta)
        got = tcv.ellipse2poly(center, axes, angle, *arc, delta)
        np.testing.assert_array_equal(got, want.reshape(-1, 2))


@pytest.mark.parametrize("seed", range(4))
def test_fill_convex_poly_equals_opencv(seed):
    """The limbs' ellipses (stickwidth 4, any angle, centres off the
    canvas too) and random triangles."""
    rs = np.random.RandomState(10 + seed)
    for i in range(200):
        if i % 2:
            center = tuple(int(v) for v in rs.randint(-30, 110, 2))
            pts = cv2.ellipse2Poly(center, (int(rs.randint(0, 100)), 4),
                                   int(rs.randint(-180, 180)), 0, 360, 1)
        else:
            pts = rs.randint(-40, 120, (3, 2)).astype(np.int32)
        color = [int(v) for v in rs.randint(0, 256, 3)]
        want, got = _canvases()
        cv2.fillConvexPoly(want, pts, color)
        tcv.fill_convex_poly(got, pts, color)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("thickness", [1, 2, 3])
def test_draw_line_equals_opencv(thickness):
    """Float colours (rounded half to even), lengths 0-200, ends off the
    canvas, on its edges and equal (a zero-length limb)."""
    rs = np.random.RandomState(thickness)
    edges = [(0, 0), (W - 1, H - 1), (0, H - 1), (W - 1, 0)]
    for i in range(400):
        p1 = (edges[i % 4] if i % 7 == 0 else
              tuple(int(v) for v in rs.randint(-60, 140, 2)))
        p2 = (p1 if i % 5 == 0 else
              tuple(int(v) for v in np.asarray(p1) + rs.randint(-100, 100, 2)))
        color = rs.rand(3) * 255
        want, got = _canvases()
        cv2.line(want, p1, p2, color, thickness=thickness)
        tcv.draw_line(got, p1, p2, color, thickness=thickness)
        np.testing.assert_array_equal(got, want, err_msg=f"{p1} {p2}")


def test_hsv_to_rgb_equals_matplotlib():
    for ie in range(20):
        hsv = [ie / 20.0, 1.0, 1.0]
        np.testing.assert_array_equal(tcv.hsv_to_rgb(hsv),
                                      matplotlib.colors.hsv_to_rgb(hsv))
    for hsv in np.random.RandomState(0).rand(50, 3):
        np.testing.assert_array_equal(tcv.hsv_to_rgb(hsv),
                                      matplotlib.colors.hsv_to_rgb(hsv))


@pytest.mark.parametrize("channels", [1, 3])
def test_resize_u8_linear_equals_opencv(channels):
    """Random sizes both ways, the exact 2x shrink (OpenCV's area branch),
    the identity and one-pixel images."""
    rs = np.random.RandomState(channels)
    sizes = [((int(a), int(b)), (int(c), int(d)))
             for a, b, c, d in rs.randint(1, 160, (40, 4))]
    sizes += [((100, 64), (50, 32)), ((480, 832), (369, 640)),
              ((7, 9), (7, 9)), ((1, 1), (5, 5)), ((5, 5), (1, 1))]
    for (sh, sw), (dh, dw) in sizes:
        img = rs.randint(0, 256, (2, sh, sw, channels)).astype(np.uint8)
        want = np.stack([cv2.resize(f, (dw, dh)).reshape(dh, dw, channels)
                         for f in img])
        np.testing.assert_array_equal(tcv.resize_u8_linear(img, (dh, dw)),
                                      want)
        np.testing.assert_array_equal(resize_frames_u8(img, (dh, dw)), want)


def test_get_affine_transform_equals_opencv():
    rs = np.random.RandomState(0)
    for _ in range(200):
        src = (rs.rand(3, 2) * 500).astype(np.float32)
        dst = (rs.rand(3, 2) * 300).astype(np.float32)
        np.testing.assert_array_equal(tcv.get_affine_transform(src, dst),
                                      cv2.getAffineTransform(src, dst))


@pytest.mark.parametrize("kind", ["affine", "crop"])
def test_warp_affine_u8_equals_opencv(kind):
    """Random affine maps, and DWPose's crops (a scale and a shift to
    288x384)."""
    rs = np.random.RandomState(0 if kind == "affine" else 1)
    for _ in range(8):
        h, w = (int(v) for v in rs.randint(20, 300, 2))
        img = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
        if kind == "affine":
            src = (rs.rand(3, 2) * [w, h]).astype(np.float32)
            dst = (rs.rand(3, 2) * [288, 384]).astype(np.float32)
        else:
            c, s = rs.rand(2) * [w, h], rs.rand() * 200 + 10
            src = np.asarray([c, c + [0, -0.5 * s], c + [-0.5 * s, -0.5 * s]],
                             np.float32)
            dst = np.asarray([[144, 192], [144, 48], [0, 48]], np.float32)
        mat = cv2.getAffineTransform(src, dst)
        np.testing.assert_array_equal(
            tcv.warp_affine_u8(img, mat, (288, 384)),
            cv2.warpAffine(img, mat, (288, 384), flags=cv2.INTER_LINEAR))


# ---------------------------------------------------------------------------
# the renderer against JAX's
# ---------------------------------------------------------------------------


def _keypoints(seed, persons=2, normalized=True):
    """Wholebody keypoints with mixed confidence: person 0's left hand and
    person 1's face below threshold (JAX's test's fixture), in [0.05, 0.95]
    or in pixels reaching past a 96x128 canvas."""
    rs = np.random.RandomState(seed)
    kp = (rs.uniform(0.05, 0.95, (persons, 133, 2)) if normalized
          else rs.uniform(-20, 150, (persons, 133, 2)))
    sc = rs.uniform(0.0, 1.0, (persons, 133))
    sc[0, 91:112] = 0.1
    if persons > 1:
        sc[1, 23:91] = 0.05
    return kp, sc


def test_wholebody_to_openpose_matches_jax():
    kp, sc = _keypoints(0)
    np.testing.assert_array_equal(tpr.wholebody_to_openpose(kp, sc),
                                  jpr.wholebody_to_openpose(kp, sc))


def test_split_parts_thresholds():
    kp, sc = _keypoints(3)
    info = tpr.wholebody_to_openpose(kp, sc)
    parts0 = tpr.split_parts(info[0])
    assert parts0["left_hand"] is None          # suppressed below 0.3
    parts1 = tpr.split_parts(info[1])
    assert parts1["face"] is None
    assert parts0["body"].shape == (18, 3)
    if parts1["left_hand"] is not None:
        assert parts1["left_hand"].shape == (21, 3)
    jinfo = jpr.wholebody_to_openpose(kp, sc)
    for ours, theirs in zip(info, jinfo):
        a, b = tpr.split_parts(ours), jpr.split_parts(theirs)
        assert a.keys() == b.keys()
        for k in a:
            assert (a[k] is None) == (b[k] is None)
            if a[k] is not None:
                np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("normalized", [True, False],
                         ids=["normalized", "pixels"])
def test_render_pose_video_matches_jax(normalized):
    """3 frames at 96x128, each with a different person mix."""
    frames = [_keypoints(s, normalized=normalized) for s in range(3)]
    kp = np.stack([k for k, _ in frames])
    sc = np.stack([s for _, s in frames])
    sc[1, 0, :18] = 0.0                      # person 0 of frame 1: no body
    sc[2, 1, 91:133] = 0.0                   # person 1 of frame 2: no hands
    got = tpr.render_pose_video(kp, sc, 96, 128)
    want = jpr.render_pose_video(kp, sc, 96, 128)
    assert got.dtype == np.float32 and got.shape == (3, 96, 128, 3)
    assert got.max() > 0
    np.testing.assert_array_equal(got, want)


def test_draw_pose_matches_jax():
    """`draw_pose` with the convention given (DWPose's pixel keypoints),
    parts missing and a person whose every part is missing."""
    kp, sc = _keypoints(5, persons=3, normalized=False)
    sc[2] = 0.0
    info = tpr.wholebody_to_openpose(kp, sc)
    poses = [tpr.split_parts(p) for p in info]
    jposes = [jpr.split_parts(p) for p in jpr.wholebody_to_openpose(kp, sc)]
    for normalized in (False, None):
        np.testing.assert_array_equal(
            tpr.draw_pose(poses, 96, 128, normalized=normalized),
            jpr.draw_pose(jposes, 96, 128, normalized=normalized))
