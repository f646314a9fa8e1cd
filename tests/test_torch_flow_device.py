"""The port's device flow tracker (`flexam_tpu_torch/perception/
flow_device.py`) and its resize (`core/resize.py`) against the JAX
package's `perception/flow_jax.py` and `jax.image.resize`, on the CPU, and
the behavioural cases of `tests/test_flow_device.py` on the port.

Inputs come from numpy seeds. Module outputs in fp32 are held at rtol 2e-4
/ atol 1e-5; tracks to 1e-3 px with equal visibility (a flip would have to
be a tie of the forward-backward threshold, and none occurs here)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexam_tpu.perception import flow_jax as jf
from flexam_tpu_torch.core.resize import bilinear_gather, resize
from flexam_tpu_torch.perception import flow_device as tf

TOL = dict(rtol=2e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These modules run thousands of small torch ops; beside the other
    test workers, torch's intra-op threads would oversubscribe the cores
    and stall at every op's barrier, so they run on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pattern(h, w, seed=0):
    """Smooth random pattern (LK needs texture and differentiability)."""
    rng = np.random.RandomState(seed)
    base = rng.rand(h // 4 + 2, w // 4 + 2).astype(np.float32)
    img = jax.image.resize(jnp.asarray(base), (h + 8, w + 8), "bicubic")
    return np.asarray(img)


def _translating(h, w, t, shift, seed):
    big = _pattern(h + 4 * t, w + 4 * t, seed=seed)
    frames = np.stack([big[4:4 + h, 4 + shift * i:4 + w + shift * i]
                       for i in range(t)])
    return np.repeat(frames[..., None], 3, axis=-1)    # [T, H, W, 3]


@pytest.mark.parametrize("shape,out,method,antialias", [
    ((2, 13, 17, 3), (2, 7, 29, 3), "bilinear", True),    # down x, up y
    ((2, 13, 17, 3), (2, 7, 29, 3), "bilinear", False),
    ((3, 40, 56), (3, 24, 33), "bilinear", True),          # non-integer
    ((1, 9, 9, 4), (1, 25, 16, 4), "bilinear", True),      # up only
    ((1, 5, 5, 8), (1, 9, 3, 8), "bicubic", False),        # Keys a=-0.5
    ((1, 37, 37, 6), (1, 41, 71, 6), "bicubic", False),    # pos-embed grid
], ids=["down_aa", "down_noaa", "ratio_aa", "up", "cubic", "cubic_grid"])
def test_resize_matches_jax_image_resize(shape, out, method, antialias):
    x = np.random.RandomState(0).rand(*shape).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), out, method, antialias=antialias)
    got = resize(torch.from_numpy(x), out, method, antialias)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_pyramid_helpers_match_jax():
    """2x2 pooling truncating odd sizes, the edge-padded box filter over
    cumulative sums, central differences and the clamped bilinear gather."""
    rng = np.random.RandomState(1)
    x = rng.rand(2, 15, 21).astype(np.float32)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    np.testing.assert_allclose(tf._avg_pool2(xt).numpy(),
                               np.asarray(jf._avg_pool2(xj)), **TOL)
    assert tuple(tf._avg_pool2(xt).shape) == (2, 7, 10)
    np.testing.assert_allclose(tf._box_filter(xt, 3).numpy(),
                               np.asarray(jf._box_filter(xj, 3)), **TOL)
    for a, b in zip(tf._grad(xt), jf._grad(xj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    y = rng.uniform(-2, 17, (2, 40)).astype(np.float32)
    xs = rng.uniform(-2, 23, (2, 40)).astype(np.float32)
    np.testing.assert_allclose(
        bilinear_gather(xt[..., None], torch.from_numpy(xs),
                        torch.from_numpy(y))[..., 0].numpy(),
        np.asarray(jf._bilinear(xj, jnp.asarray(y), jnp.asarray(xs))), **TOL)
    assert tf._clamp_levels(4, 48, 64, 7) == jf._clamp_levels(4, 48, 64, 7)


def test_dense_flow_matches_jax():
    video = _translating(48, 64, 3, 2, seed=4)[..., 0]
    prev, nxt = video[:-1], video[1:]
    want = jf.dense_flow(jnp.asarray(prev), jnp.asarray(nxt), 3, 7, 4)
    got = tf.dense_flow(torch.from_numpy(prev), torch.from_numpy(nxt), 3, 7,
                        4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=1e-4)


@pytest.mark.parametrize("downscale", [1, 2])
def test_track_video_flow_device_matches_jax(downscale):
    """The whole tracker (luminance depth, fp16 gray and depth inputs,
    chaining, forward-backward kills) on a translating clip with an
    occluded band: tracks to 1e-3 px, visibility equal."""
    video = _translating(48, 64, 6, 2, seed=7)
    video[3:, 10:20] = 0.0                      # an occluder kills tracks
    want_t, want_v = jf.track_video_flow_device(video, density=8,
                                                downscale=downscale)
    got_t, got_v = tf.track_video_flow_device(video, density=8,
                                              downscale=downscale,
                                              device="cpu")
    assert got_t.shape == want_t.shape and got_v.dtype == bool
    np.testing.assert_allclose(got_t, want_t, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(got_v, want_v)
    assert not want_v.all() and want_v.any()    # both outcomes occur


def test_dense_flow_recovers_translation():
    h, w, shift = 64, 80, 3
    big = _pattern(h, w)
    prev = torch.from_numpy(np.ascontiguousarray(big[4:4 + h, 4:4 + w]))
    flow0 = tf.dense_flow(prev[None], prev[None])
    assert float(flow0.abs().max()) < 0.5
    nxt = torch.from_numpy(np.ascontiguousarray(
        big[4:4 + h, 4 - shift:4 + w - shift]))   # scene moved +x by shift
    flow = tf.dense_flow(prev[None], nxt[None])[0].numpy()
    inner = flow[16:-16, 16:-16]
    assert abs(inner[..., 0].mean() - shift) < 0.35, inner[..., 0].mean()
    assert abs(inner[..., 1].mean()) < 0.35


def test_track_device_contract_and_straight_motion():
    """A uniformly translating scene: tracks advance by the shift per
    frame, in the contract of the rasterizers (tracks [T, N, 3], vis bool)."""
    h, w, t, shift = 48, 64, 5, 2
    video = _translating(h, w, t, shift, seed=1)
    tracks, vis = tf.track_video_flow_device(video, density=8, device="cpu")
    assert tracks.shape[0] == t and tracks.shape[2] == 3
    assert vis.shape == tracks.shape[:2] and vis.dtype == bool
    alive = vis.all(axis=0)
    inner = alive & (tracks[0, :, 0] > 12) & (tracks[0, :, 0] < w - 12) \
        & (tracks[0, :, 1] > 12) & (tracks[0, :, 1] < h - 12)
    assert inner.sum() >= 4
    dx = tracks[-1, inner, 0] - tracks[0, inner, 0]
    assert abs(np.median(dx) + shift * (t - 1)) < 1.5, np.median(dx)
    assert abs(np.median(tracks[-1, inner, 1] - tracks[0, inner, 1])) < 1.0


def test_static_scene_keeps_points():
    """Zero motion: every point stays at its query position, visible (the
    JAX test holds its host tracker to the same)."""
    h, w, t = 40, 56, 4
    frame = _pattern(h, w, seed=2)[:h, :w]
    video = np.repeat(np.stack([frame] * t)[..., None], 3, axis=-1)
    tracks, vis = tf.track_video_flow_device(video, density=8, device="cpu")
    np.testing.assert_allclose(tracks[..., :2], tracks[:1, :, :2]
                               .repeat(t, 0), atol=0.5)
    assert vis.all()


def test_downscale_matches_full_res_tracks():
    h, w, t, shift = 64, 80, 5, 2
    video = _translating(h, w, t, shift, seed=5)
    t1, v1 = tf.track_video_flow_device(video, density=8, downscale=1,
                                        device="cpu")
    t2, v2 = tf.track_video_flow_device(video, density=8, downscale=2,
                                        device="cpu")
    assert t1.shape == t2.shape
    both = v1.all(axis=0) & v2.all(axis=0)
    inner = both & (t1[0, :, 0] > 12) & (t1[0, :, 0] < w - 12) \
        & (t1[0, :, 1] > 12) & (t1[0, :, 1] < h - 12)
    assert inner.sum() >= 4
    d1 = t1[-1, inner, :2] - t1[0, inner, :2]
    d2 = t2[-1, inner, :2] - t2[0, inner, :2]
    assert np.median(np.abs(d1 - d2)) < 1.0


def test_occlusion_kills_tracks():
    h, w, t = 48, 64, 3
    frame = _pattern(h, w, seed=3)[:h, :w]
    frames = [frame.copy() for _ in range(t)]
    frames[1][:, : w // 2] = 0.0               # half the scene blanks out
    frames[2][:, : w // 2] = 0.0
    video = np.repeat(np.stack(frames)[..., None], 3, axis=-1)
    tracks, vis = tf.track_video_flow_device(video, density=8, device="cpu")
    left = tracks[0, :, 0] < w // 2 - 8
    right = tracks[0, :, 0] > w // 2 + 8
    assert vis[-1, right].mean() > 0.6
    assert vis[-1, left].mean() < vis[-1, right].mean()


def test_entry_point_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        tf.track_video_flow_device(np.zeros((2, 16, 16, 3), np.float32))


def test_flow_accuracy_tool(capsys):
    """`tools.flow_accuracy`: the textured clip moves by exactly -shift a
    frame, and the tool reports the tracker's errors on it."""
    import json

    from flexam_tpu_torch.tools import flow_accuracy
    clip = flow_accuracy.textured_clip(3, 40, 56, (2, 1), seed=3)
    np.testing.assert_array_equal(clip[1, :-1, :-2], clip[0, 1:, 2:])
    flow_accuracy.main(["--platform", "cpu", "--frames", "5", "--size",
                        "64", "96", "--shift", "1", "1", "--density", "8"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["tracks"] == [5, 8 * 12, 3]
    assert out["median_end_point_error_px"] < 3.0
    assert 0.0 < out["visible_share"] <= 1.0
