"""OpenCV's Farneback in the port (`perception/farneback.py`) and the flow
tracker on it (`perception/tracking.py track_video_flow`), against `cv2`
and the JAX package.

  * `calc_optical_flow_farneback` against `cv2.calcOpticalFlowFarneback`
    with the tracker's arguments, on textured pairs under a sub-pixel
    translation and a small rotation, at 256x256 (all three pyramid levels
    run) and at 64x96 (the level count clamps to one: a side would fall
    below 32 px). The end-point difference stays within MAX_EPE and
    MEAN_EPE px (the tests' pairs measure 4.0e-6 max and 1.7e-7 mean; the
    summation orders differ from OpenCV's vectorized code);
  * `track_video_flow` against JAX's (OpenCV's Farneback) on a 4-frame
    clip: tracks within TRACK_TOL px, visibility equal except for points
    whose forward-backward error lies within TRACK_TOL of `fb_thresh`,
    which the test counts (and bounds by the number of such points);
  * JAX's three `tests/test_tracking_quality.py` cases on the port;
  * `dispatch_tracking`'s three flow routes: FLEXAM_FLOW=host and a CPU
    device run the Farneback tracker, FLEXAM_FLOW=device the LK tracker,
    each equal to JAX's same route.
"""

import cv2
import numpy as np
import pytest
import torch

from flexam_tpu.perception import tracking as jtrack
from flexam_tpu_torch.perception import tracking as ttrack
from flexam_tpu_torch.perception.farneback import calc_optical_flow_farneback

MAX_EPE = 1e-4
MEAN_EPE = 1e-5
TRACK_TOL = 1e-3
FLOW_KW = dict(pyr_scale=0.5, levels=3, winsize=15, iterations=3, poly_n=5,
               poly_sigma=1.2, flags=0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops: one intra-op thread beside the other test
    workers (see tests/test_torch_video_tracking.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _luminance_depth(monkeypatch):
    for k in ("FLEXAM_DEPTH_BACKEND", "FLEXAM_UNIDEPTH_CKPT",
              "FLEXAM_DAV2_CKPT", "FLEXAM_ZOE_CKPT", "FLEXAM_FLOW",
              "FLEXAM_DELTA_CKPT"):
        monkeypatch.delenv(k, raising=False)


def _texture(h, w, seed):
    """A smooth random field with fine detail, in [0, 1]."""
    rs = np.random.RandomState(seed)
    base = rs.rand(h // 8 + 1, w // 8 + 1)
    x = cv2.resize(base, (w, h), interpolation=cv2.INTER_CUBIC)
    x = x + 0.15 * cv2.GaussianBlur(rs.rand(h, w), (0, 0), 1.0)
    return x / 1.15


def _pair(h, w, seed, shift, angle):
    """uint8 frames of one texture, the second moved by `shift` px and
    rotated by `angle` degrees about the centre."""
    big = _texture(h + 40, w + 40, seed)
    m = cv2.getRotationMatrix2D(((w + 40) / 2, (h + 40) / 2), angle, 1.0)
    m[:, 2] += np.asarray(shift) - 20
    a = cv2.warpAffine(big, np.float64([[1, 0, -20], [0, 1, -20]]), (w, h),
                       flags=cv2.INTER_CUBIC)
    b = cv2.warpAffine(big, m, (w, h), flags=cv2.INTER_CUBIC)
    u8 = lambda x: np.clip(x * 255, 0, 255).astype(np.uint8)
    return u8(a), u8(b)


@pytest.mark.parametrize("size", [(256, 256), (64, 96)],
                         ids=["three_levels", "clamped"])
@pytest.mark.parametrize("motion", ["translation", "rotation"])
def test_farneback_matches_opencv(size, motion):
    h, w = size
    a, b = _pair(h, w, 1, (0.6, -0.35),
                 0.0 if motion == "translation" else 2.0)
    want = cv2.calcOpticalFlowFarneback(a, b, None, **FLOW_KW)
    got = calc_optical_flow_farneback(a, b, **FLOW_KW)
    assert got.dtype == torch.float32 and got.shape == (h, w, 2)
    epe = np.linalg.norm(got.numpy() - want, axis=-1)
    assert np.linalg.norm(want, axis=-1).mean() > 0.3      # real motion
    assert epe.max() <= MAX_EPE and epe.mean() <= MEAN_EPE, (
        epe.max(), epe.mean())


def test_farneback_refuses_other_flags():
    a, b = _pair(64, 96, 2, (0.5, 0.5), 0.0)
    with pytest.raises(NotImplementedError, match="flags"):
        calc_optical_flow_farneback(a, b, **dict(FLOW_KW, flags=256))


def _clip(t=4, h=64, w=96, seed=3):
    """A texture drifting by a sub-pixel step and turning a little each
    frame, [T, H, W, 3] in [0, 1]."""
    big = _texture(h + 40, w + 40, seed)
    frames = []
    for i in range(t):
        m = cv2.getRotationMatrix2D(((w + 40) / 2, (h + 40) / 2), 0.7 * i,
                                    1.0)
        m[:, 2] += np.asarray([0.8 * i, -0.45 * i]) - 20
        f = cv2.warpAffine(big, m, (w, h), flags=cv2.INTER_CUBIC)
        frames.append(np.repeat(np.clip(f, 0, 1)[..., None], 3, -1))
    return np.stack(frames).astype(np.float32)


def _jax_fb_errors(video, density, fb_thresh=1.5):
    """JAX's tracker's forward-backward errors [T - 1, N] (its own loop,
    OpenCV's flows), to find the points near the threshold."""
    gray = [(f @ np.array([0.299, 0.587, 0.114], np.float32) * 255
             ).astype(np.uint8) for f in video]
    h, w = gray[0].shape
    ys = np.arange(density // 2, h, density, dtype=np.float32)
    xs = np.arange(density // 2, w, density, dtype=np.float32)
    gy, gx = np.meshgrid(ys, xs, indexing="ij")
    cur = np.stack([gx.reshape(-1), gy.reshape(-1)], axis=1)
    errs = []
    for i in range(len(gray) - 1):
        fwd = cv2.calcOpticalFlowFarneback(gray[i], gray[i + 1], None,
                                           **FLOW_KW)
        bwd = cv2.calcOpticalFlowFarneback(gray[i + 1], gray[i], None,
                                           **FLOW_KW)
        step = jtrack._sample_bilinear(fwd, cur)
        nxt = cur + step
        errs.append(np.linalg.norm(
            step + jtrack._sample_bilinear(bwd, nxt), axis=1))
        cur = nxt
    return np.stack(errs)


@pytest.mark.parametrize("fb_thresh", [1.5, 0.02],
                         ids=["default", "tight"])
def test_track_video_flow_matches_jax(fb_thresh):
    """The tight threshold kills tracks over the clip, so the visibility
    comparison has both outcomes to hold."""
    video = _clip()
    got_t, got_v = ttrack.track_video_flow(video, density=6,
                                           fb_thresh=fb_thresh, device="cpu")
    want_t, want_v = jtrack.track_video_flow(video, density=6,
                                             fb_thresh=fb_thresh)
    assert got_t.shape == want_t.shape == (4, 176, 3)
    np.testing.assert_allclose(got_t, want_t, rtol=0, atol=TRACK_TOL)
    near = np.abs(_jax_fb_errors(video, 6) - fb_thresh) <= TRACK_TOL
    near = np.cumsum(near, axis=0) > 0           # once near, may differ on
    differ = got_v[1:] != want_v[1:]
    assert not (differ & ~near).any()
    assert differ.sum() <= near.sum()
    np.testing.assert_array_equal(got_v[0], want_v[0])
    assert 0 < want_v[-1].mean() <= 1


# JAX's tests/test_tracking_quality.py on the port


def _textured(h, w, seed):
    rng = np.random.RandomState(seed)
    base = rng.rand(h // 4, w // 4, 3).astype(np.float32)
    return cv2.resize(base, (w, h), interpolation=cv2.INTER_CUBIC).clip(0, 1)


def _translating_scene(t=10, h=96, w=128, dx=1.5, dy=-1.0, seed=0):
    big = _textured(h + 2 * 16, w + 2 * 16, seed)
    frames = np.zeros((t, h, w, 3), np.float32)
    for i in range(t):
        m = np.float32([[1, 0, dx * i], [0, 1, dy * i]])
        shifted = cv2.warpAffine(big, m, (big.shape[1], big.shape[0]),
                                 flags=cv2.INTER_LINEAR)
        frames[i] = shifted[16:16 + h, 16:16 + w]
    return frames


def test_flow_tracker_uniform_translation():
    dx, dy, t = 1.5, -1.0, 8
    video = _translating_scene(t=t, dx=dx, dy=dy)
    tracks, vis = ttrack.track_video_flow(video, density=12, device="cpu")
    start = tracks[0, :, :2]
    end_true = start + np.asarray([dx, dy]) * (t - 1)
    interior = ((start[:, 0] > 16) & (start[:, 0] < 128 - 16 - dx * t)
                & (start[:, 1] > 16 + abs(dy) * t)
                & (start[:, 1] < 96 - 16))
    interior &= vis[t - 1]
    assert interior.sum() > 10
    err = np.linalg.norm(tracks[t - 1, interior, :2] - end_true[interior],
                         axis=1)
    assert np.median(err) < 1.5, f"median endpoint error {np.median(err)}"
    assert np.mean(err) < 3.0


def test_flow_tracker_batches_pairs_in_chunks(monkeypatch):
    """FLOW_PAIRS pairs a batch: 5 pairs in chunks of 2 (three calls) give
    the tracks of one batch of all 5, bit for bit."""
    from flexam_tpu_torch.perception import farneback as tfb
    video = _translating_scene(t=6, h=64, w=96)
    calls = []
    orig = tfb.farneback_pairs

    def spy(frames, prev, nxt, **kw):
        calls.append(len(prev))
        return orig(frames, prev, nxt, **kw)

    monkeypatch.setattr(tfb, "farneback_pairs", spy)
    outs = []
    for chunk in (100, 2):
        monkeypatch.setattr(ttrack, "FLOW_PAIRS", chunk)
        outs.append(ttrack.track_video_flow(video, density=12, device="cpu"))
    assert calls == [10, 4, 4, 2]
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_flow_tracker_static_scene_zero_motion():
    video = np.tile(_textured(80, 112, 1)[None], (6, 1, 1, 1))
    tracks, vis = ttrack.track_video_flow(video, density=10, device="cpu")
    drift = np.linalg.norm(tracks[-1, :, :2] - tracks[0, :, :2], axis=1)
    assert np.median(drift[vis[-1]]) < 0.5
    assert vis[-1].mean() > 0.8


def test_flow_tracker_occlusion_detection():
    t, h, w = 8, 96, 128
    video = _translating_scene(t=t, h=h, w=w, dx=8.0, dy=0.0, seed=2)
    tracks, vis = ttrack.track_video_flow(video, density=12, device="cpu")
    exiting = tracks[0, :, 0] > w - 8.0 * (t - 2)
    assert exiting.sum() >= 3
    assert vis[t - 1, exiting].mean() < 0.6


@pytest.mark.parametrize("route", ["host", "device", "cpu"])
def test_dispatch_tracking_flow_routes_match_jax(monkeypatch, tmp_path,
                                                 route):
    """FLEXAM_FLOW=host: the Farneback tracker; =device: the LK tracker;
    unset, on the CPU: the Farneback tracker (JAX's rule, its CPU backend
    here). No DELTA checkpoint is found."""
    monkeypatch.chdir(tmp_path)
    if route != "cpu":
        monkeypatch.setenv("FLEXAM_FLOW", route)
    video = _clip(t=3, h=48, w=64)
    got = ttrack.dispatch_tracking(video, "flow", density=8, device="cpu")
    want = jtrack.dispatch_tracking(video, "flow", density=8)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=TRACK_TOL)
    np.testing.assert_array_equal(got[1], want[1])
    if route != "device":     # the Farneback tracker, not the LK one
        np.testing.assert_allclose(got[0], jtrack.track_video_flow(
            video, density=8)[0], rtol=0, atol=TRACK_TOL)
