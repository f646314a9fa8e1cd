"""The port's conditioning modules against the JAX package, on the CPU.

The numpy modules (`tracks`, `rasterize`, `camera`, `camera_presets`,
`object_motion`) are own copies and must give exactly the JAX package's
numbers. The device rasterizer on the CPU must give the numpy rasterizer's
pixels bit for bit, and JAX's `DeviceRasterizer`'s point-index images and
uint8 colour planes bit for bit (tied depths included: both sort stably).
Its float planes are held to JAX's within one ulp, the criterion of
`tests/test_conditioning.py`: XLA on the CPU divides by 255 as a multiply
by the reciprocal, where torch and numpy divide.
"""

import json

import matplotlib
import numpy as np
import pytest

from flexam_tpu.conditioning import camera as jcam
from flexam_tpu.conditioning import camera_presets as jpre
from flexam_tpu.conditioning import object_motion as jobj
from flexam_tpu.conditioning import rasterize as jras
from flexam_tpu.conditioning import rasterize_device as jdev
from flexam_tpu.conditioning import tracks as jtr
from flexam_tpu_torch import conditioning as tcond
from flexam_tpu_torch.conditioning import camera as tcam
from flexam_tpu_torch.conditioning import camera_presets as tpre
from flexam_tpu_torch.conditioning import object_motion as tobj
from flexam_tpu_torch.conditioning import rasterize as tras
from flexam_tpu_torch.conditioning import rasterize_device as tdev
from flexam_tpu_torch.conditioning import tracks as ttr

H, W, T, N = 48, 64, 9, 40


def _tracks(seed=0, n=N):
    """Drifting points, some invisible; depths random (ties unlikely)."""
    rng = np.random.RandomState(seed)
    base = np.stack([rng.uniform(0, W, n), rng.uniform(0, H, n),
                     rng.uniform(0.5, 3.0, n)], axis=1)
    drift = rng.uniform(-3, 3, (T, 1, 3)).cumsum(0)
    tracks = base[None] + drift
    vis = rng.rand(T, n) > 0.2
    return tracks.astype(np.float32), vis


def _distinct_depth_tracks(seed=3):
    """Strictly distinct depths: the painter order is then the same for
    every sort, and all three rasterizers agree bit for bit."""
    rng = np.random.RandomState(seed)
    tracks, vis = _tracks(seed)
    flat = tracks.reshape(-1, 3)
    flat[:, 2] = np.linspace(0.5, 3.0, flat.shape[0])[
        rng.permutation(flat.shape[0])]
    return tracks, vis


def _tied_depth_tracks(seed=4):
    """Depths on a grid of 4 values: overlapping splats tie everywhere."""
    tracks, vis = _tracks(seed, n=60)
    tracks[..., 2] = np.round(tracks[..., 2] * 1.5) / 1.5
    return tracks, vis


# --------------------------------------------------------------------------
# numpy copies: exactly the JAX package's numbers
# --------------------------------------------------------------------------

def test_exports_match():
    from flexam_tpu import conditioning as jcond
    names = {n for n in dir(jcond) if not n.startswith("_")
             and not isinstance(getattr(jcond, n), type(json))}
    assert names <= set(dir(tcond)), names - set(dir(tcond))


@pytest.mark.parametrize("motion", [
    "trans 0.5 -0.2 1.0",
    "rot y 30",
    "trans 0 0 0.5 0 3; rot x 25 1 4",
    "spiral 2.0",
])
def test_camera_dsl(motion):
    ours = tcam.CameraMotionGenerator(motion, frame_num=T, H=H, W=W)
    theirs = jcam.CameraMotionGenerator(motion, frame_num=T, H=H, W=W)
    np.testing.assert_array_equal(ours.get_default_motion(),
                                  theirs.get_default_motion())
    np.testing.assert_array_equal(ours.intr, theirs.intr)


def test_w2s_moge():
    rng = np.random.RandomState(1)
    pts = rng.uniform(-2, 2, (T, N, 3)).astype(np.float32)
    pts[..., 2] += 5.0
    ours = tcam.CameraMotionGenerator("trans 0.2 0.1 0.3", frame_num=T,
                                      H=H, W=W)
    theirs = jcam.CameraMotionGenerator("trans 0.2 0.1 0.3", frame_num=T,
                                        H=H, W=W)
    poses = theirs.get_default_motion()
    np.testing.assert_array_equal(ours.w2s_moge(pts, poses),
                                  theirs.w2s_moge(pts, poses))


@pytest.mark.parametrize("override", [True, False])
def test_vggt_roundtrip(override):
    rng = np.random.RandomState(2)
    uvz = np.stack([rng.uniform(0, W, (T, N)), rng.uniform(0, H, (T, N)),
                    rng.uniform(1.0, 4.0, (T, N))], axis=-1).astype(np.float32)
    intr = np.tile(np.array([[50.0, 0, W / 2], [0, 50.0, H / 2], [0, 0, 1]],
                            np.float32), (T, 1, 1))
    extr = np.tile(np.eye(4, dtype=np.float32)[:3], (T, 1, 1))
    extr[:, 0, 3] = np.linspace(0, 0.5, T)
    ours = tcam.CameraMotionGenerator("trans 0 0 1", frame_num=T, H=H, W=W)
    theirs = jcam.CameraMotionGenerator("trans 0 0 1", frame_num=T, H=H, W=W)
    poses = theirs.get_default_motion()
    world = theirs.s2w_vggt(uvz, extr, intr)
    np.testing.assert_array_equal(ours.s2w_vggt(uvz, extr, intr), world)
    for p in (poses, None):
        np.testing.assert_array_equal(
            ours.w2s_vggt(world, extr, intr, poses=p,
                          override_extrinsics=override),
            theirs.w2s_vggt(world, extr, intr, poses=p,
                            override_extrinsics=override))


def test_camera_pose_files_and_rays(tmp_path):
    """CameraCtrl pose rows -> Camera, relative poses, the Plucker video,
    the trajectory-JSON contract and the adapter's fold, and a 'path'
    motion read from a pose file."""
    rng = np.random.RandomState(5)
    rows = []
    for i in range(T):
        w2c = np.eye(4)[:3].copy()
        w2c[:, 3] = rng.uniform(-0.5, 0.5, 3)
        rows.append([i, 0.5, 0.9, 0.5, 0.5, 0, 0] + w2c.flatten().tolist())
    rows = np.array(rows)
    np.testing.assert_array_equal(
        tcam.get_relative_pose([tcam.Camera(r) for r in rows]),
        jcam.get_relative_pose([jcam.Camera(r) for r in rows]))
    np.testing.assert_array_equal(
        tcam.process_pose_params(rows, width=W, height=H),
        jcam.process_pose_params(rows, width=W, height=H))
    traj = json.dumps(rows[:, 1:].tolist())
    for a, b in zip(tcam.camera_inputs_from_trajectory(traj, T, H, W),
                    jcam.camera_inputs_from_trajectory(traj, T, H, W)):
        np.testing.assert_array_equal(a, b)
    cam = rng.randn(1, 6, T, 8, 8).astype(np.float32)
    np.testing.assert_array_equal(tcam.fold_camera_video(cam),
                                  jcam.fold_camera_video(cam))
    path = tmp_path / "poses.txt"
    path.write_text("header\n" + "\n".join(" ".join(str(v) for v in r)
                                           for r in rows))
    ours = tcam.CameraMotionGenerator("path", frame_num=T + 2, H=H, W=W,
                                      pose_file=str(path))
    theirs = jcam.CameraMotionGenerator("path", frame_num=T + 2, H=H, W=W,
                                        pose_file=str(path))
    np.testing.assert_array_equal(ours.get_default_motion(),
                                  theirs.get_default_motion())
    ours.process_pose_file(str(path), width=W, height=H)
    theirs.process_pose_file(str(path), width=W, height=H)
    np.testing.assert_array_equal(ours.intr, theirs.intr)


def test_camera_from_video_needs_pi3(tmp_path):
    """A video as the camera path runs Pi3 on the video's frames, which the
    port reads from the `.npz` frame dump: a `.mp4` without one raises,
    naming the decoder it would need, before any model is built (the Pi3
    side is held to JAX in `tests/test_torch_pi3.py`)."""
    gen = tcam.CameraMotionGenerator("trans 0 0 1", frame_num=T, H=H, W=W,
                                     device="cpu")
    with pytest.raises(ValueError, match="OpenCV or imageio"):
        gen.process_video_file(str(tmp_path / "clip.mp4"))


@pytest.mark.parametrize("names,speed", [
    (["Pan Up"], 1.0), (["Zoom In", "CW"], 0.5),
    (["ACW", "Pan Left", "Zoom Out"], 2.0)])
def test_camera_presets(names, speed):
    np.testing.assert_array_equal(tpre.combine_presets(names, speed, T),
                                  jpre.combine_presets(names, speed, T))
    a = tpre.preset_camera_motion(names[0], speed, T)
    np.testing.assert_array_equal(a, jpre.preset_camera_motion(names[0],
                                                               speed, T))
    b = jpre.preset_camera_motion(names[-1], speed, T + 3)
    joined = tpre.join_camera_motion(a, b)
    np.testing.assert_array_equal(joined, jpre.join_camera_motion(a, b))
    assert (tpre.trajectory_json(joined, 1.0, 1.2, 0.5, 0.5)
            == jpre.trajectory_json(joined, 1.0, 1.2, 0.5, 0.5))
    assert tpre.PRESET_NAMES == jpre.PRESET_NAMES


@pytest.mark.parametrize("motion,dist", [("up", 30.0), ("rot", 45.0),
                                         ("down_right", 12.0),
                                         ("pitch_up", 20.0),
                                         ("roll_right", 15.0)])
def test_object_motion(motion, dist):
    tracks, _ = _tracks(3)
    mask = np.zeros((H, W), np.float32)
    mask[10:35, 20:50] = 1.0
    ours = tobj.ObjectMotionGenerator()
    theirs = jobj.ObjectMotionGenerator()
    np.testing.assert_array_equal(
        ours.apply_motion(tracks, mask, motion, dist, num_frames=T),
        theirs.apply_motion(tracks, mask, motion, dist, num_frames=T))
    moge = np.random.RandomState(6).rand(T, 6, 8, 3).astype(np.float32)
    moge[0, 0, 0] = np.nan
    m = np.zeros((6, 8), bool)
    m[1:4, 2:6] = True
    np.testing.assert_array_equal(
        ours.apply_motion(moge, m, motion, dist, num_frames=T,
                          tracking_method="moge"),
        theirs.apply_motion(moge, m, motion, dist, num_frames=T,
                            tracking_method="moge"))


def test_track_colors_and_encoding():
    tracks, _ = _tracks(4)
    for a, b in zip(ttr.cosine_positional_encoding(tracks, H, W, L=4),
                    jtr.cosine_positional_encoding(tracks, H, W, L=4)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ttr.cos_level_colors(a[0]),
                                      jtr.cos_level_colors(b[0]))
    np.testing.assert_array_equal(ttr.tracking_colors(tracks, H, W),
                                  jtr.tracking_colors(tracks, H, W))
    np.testing.assert_array_equal(ttr.normalize_tracks(tracks, H, W),
                                  jtr.normalize_tracks(tracks, H, W))
    flat = tracks.copy()
    flat[..., 2] = 0.0       # no depth: random blue channel from rng
    np.testing.assert_array_equal(
        ttr.tracking_colors(flat, H, W, rng=np.random.RandomState(2)),
        jtr.tracking_colors(flat, H, W, rng=np.random.RandomState(2)))
    np.testing.assert_array_equal(
        ttr.normalize_tracks(flat, H, W, rng=np.random.RandomState(2)),
        jtr.normalize_tracks(flat, H, W, rng=np.random.RandomState(2)))


def test_spectral_table_is_matplotlibs():
    """The port's own Spectral table equals matplotlib's on every entry,
    and its colour call on values in and out of [0, 1] and NaN."""
    cmap = matplotlib.colormaps["Spectral"]
    np.testing.assert_array_equal(ttr.spectral_lut(256),
                                  cmap(np.arange(256))[:, :3])
    x = np.concatenate([np.random.RandomState(0).rand(1000),
                        [0.0, 1.0, 255 / 256, 1 / 256, -0.2, 1.3, np.nan,
                         np.inf, -np.inf]])
    np.testing.assert_array_equal(ttr.spectral_colormap(x), cmap(x)[:, :3])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_spectral_depth_colors(dtype):
    rng = np.random.RandomState(1)
    for n in (1, 2, 7, 100, 4680):
        d = rng.uniform(0.1, 8.0, n).astype(dtype)
        np.testing.assert_array_equal(ttr.spectral_depth_colors(d),
                                      jtr.spectral_depth_colors(d))
    d = np.full(5, 2.0, dtype)      # p98 == p2: every point the first colour
    np.testing.assert_array_equal(ttr.spectral_depth_colors(d),
                                  jtr.spectral_depth_colors(d))


@pytest.mark.parametrize("mask_kind", [None, "foreground_edit",
                                       "background_edit"])
def test_numpy_rasterizers(mask_kind):
    """The numpy rasterizer equals the JAX package's (its numpy painter,
    or its C++ one where built: the same pixels) on all three streams."""
    tracks, vis = _distinct_depth_tracks(5)
    mask = None
    kw = {}
    if mask_kind:
        mask = np.zeros((T, H, W), np.float32)
        mask[:, :, : W // 2] = 1.0
        kw = dict(mask_video=mask, generate_type=mask_kind)
    np.testing.assert_array_equal(
        tras.rasterize_tracking_video(tracks, vis, H, W, point_wise=4, **kw),
        jras.rasterize_tracking_video(tracks, vis, H, W, point_wise=4, **kw))
    enc = ttr.cosine_positional_encoding(tracks, H, W, L=2)
    ours = tras.rasterize_cos_videos(enc, tracks, vis, H, W, **kw)
    theirs = jras.rasterize_cos_videos(enc, tracks, vis, H, W, **kw)
    for lvl in range(2):
        np.testing.assert_array_equal(ours[lvl], theirs[lvl])
    np.testing.assert_array_equal(
        tras.rasterize_depth_video(tracks, vis, H, W, point_wise=2, **kw),
        jras.rasterize_depth_video(tracks, vis, H, W, point_wise=2, **kw))


# --------------------------------------------------------------------------
# the device rasterizer (run here on the CPU)
# --------------------------------------------------------------------------

def _streams(r):
    """The six streams of a rasterizer, as numpy float32 [1, 3, T, H, W]."""
    out = {"tracking": r.tracking_video(), "depth": r.depth_video()}
    out.update({f"cos_{i}": v for i, v in enumerate(r.cos_videos())})
    return {k: np.asarray(v) for k, v in out.items()}


def _u8(v):
    return np.round(np.asarray(v, np.float32) * 255).astype(np.uint8)


def _host_streams(tracks, vis, point_wise=4, **kw):
    enc = ttr.cosine_positional_encoding(tracks, H, W)
    cos = tras.rasterize_cos_videos(enc, tracks, vis, H, W, **kw)
    out = {"tracking": tras.rasterize_tracking_video(
        tracks, vis, H, W, point_wise=point_wise,
        rng=np.random.RandomState(7), **kw),
        "depth": tras.rasterize_depth_video(tracks, vis, H, W,
                                            point_wise=point_wise, **kw)}
    out.update({f"cos_{i}": v for i, v in cos.items()})
    return out


def _assert_matches_jax(ours, theirs):
    """Point-index images and uint8 planes bit for bit; the float planes
    within one ulp (XLA's reciprocal multiply)."""
    for key in theirs._pimg_cache:
        np.testing.assert_array_equal(ours._pimg_cache[key].numpy(),
                                      np.asarray(theirs._pimg_cache[key]))
    a, b = _streams(ours), _streams(theirs)
    for k in b:
        np.testing.assert_array_equal(_u8(a[k]), _u8(b[k]), err_msg=k)
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=6e-8, err_msg=k)


@pytest.mark.parametrize("point_wise", [4, 2])
def test_device_rasterizer_equals_numpy(point_wise):
    """Distinct depths: all six streams equal the numpy rasterizer's, float
    for float."""
    tracks, vis = _distinct_depth_tracks()
    dev = tdev.DeviceRasterizer(tracks, vis, H, W, point_wise=point_wise,
                                rng=np.random.RandomState(7), device="cpu")
    got = _streams(dev)
    for k, v in _host_streams(tracks, vis, point_wise).items():
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("depths", ["distinct", "tied"])
def test_device_rasterizer_equals_jax(depths):
    tracks, vis = (_distinct_depth_tracks() if depths == "distinct"
                   else _tied_depth_tracks())
    ours = tdev.DeviceRasterizer(tracks, vis, H, W, device="cpu",
                                 rng=np.random.RandomState(7))
    theirs = jdev.DeviceRasterizer(tracks, vis, H, W,
                                   rng=np.random.RandomState(7))
    _assert_matches_jax(ours, theirs)
    if depths == "tied":
        # the ties are real: the numpy oracle's unstable sort picks other
        # winners somewhere, so only a stable sort reproduces JAX here
        a = _streams(ours)["tracking"]
        assert (_u8(a) != _u8(_host_streams(tracks, vis)["tracking"])).any()


@pytest.mark.parametrize("gen_type", ["foreground_edit", "background_edit"])
@pytest.mark.parametrize("point_wise", [4, 2])
def test_device_rasterizer_mask_filter(gen_type, point_wise):
    """The fg/bg filter samples the mask at each point's clipped centre:
    equal to the numpy rasterizer and to JAX."""
    tracks, vis = _distinct_depth_tracks(9)
    mask = np.zeros((T, H, W), np.float32)
    mask[:, : H // 2] = 1.0
    mask[::2, :, : W // 3] = 1.0
    kw = dict(raster_mask=mask, generate_type=gen_type)
    ours = tdev.DeviceRasterizer(tracks, vis, H, W, point_wise=point_wise,
                                 rng=np.random.RandomState(7), device="cpu",
                                 **kw)
    got = _streams(ours)
    host = _host_streams(tracks, vis, point_wise, mask_video=mask,
                         generate_type=gen_type)
    for k, v in host.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    theirs = jdev.DeviceRasterizer(tracks, vis, H, W, point_wise=point_wise,
                                   rng=np.random.RandomState(7), **kw)
    _assert_matches_jax(ours, theirs)
    unfiltered = _streams(tdev.DeviceRasterizer(
        tracks, vis, H, W, point_wise=point_wise, device="cpu",
        rng=np.random.RandomState(7)))
    assert not np.array_equal(unfiltered["tracking"], got["tracking"])


def test_device_rasterizer_drops_bad_points():
    """Points out of bounds (on each edge, including the tracking stream's
    y < 1), NaN or infinite, and invisible ones are dropped as the numpy
    rasterizer and JAX drop them; positions in (-1, 0) truncate to 0."""
    tracks, vis = _distinct_depth_tracks(11)
    tracks[:, 0, :2] = (-0.5, 10.0)          # trunc -> x = 0: kept
    tracks[:, 1, :2] = (10.0, 0.5)           # y = 0: not in tracking
    tracks[:, 2, :2] = (W + 0.0, 10.0)       # x = W: dropped
    tracks[:, 3, :2] = (10.0, H + 0.25)      # y = H: dropped
    tracks[:, 4, :2] = (-1.0, 10.0)          # x = -1: dropped
    tracks[:, 5, 0] = np.nan
    tracks[:, 6, 1] = np.inf
    tracks[:, 7, :2] = (-3e9, 4e9)           # beyond int32
    tracks[:, 8, :2] = (W - 0.01, H - 0.01)  # last pixel: kept
    vis[:, 9] = False
    mask = np.ones((T, H, W), np.float32)
    for kw in ({}, dict(raster_mask=mask, generate_type="foreground_edit")):
        ours = tdev.DeviceRasterizer(tracks, vis, H, W, device="cpu",
                                     rng=np.random.RandomState(7), **kw)
        host = _host_streams(tracks, vis,
                             **({} if not kw else dict(
                                 mask_video=mask,
                                 generate_type="foreground_edit")))
        got = _streams(ours)
        for k, v in host.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        theirs = jdev.DeviceRasterizer(tracks, vis, H, W,
                                       rng=np.random.RandomState(7), **kw)
        _assert_matches_jax(ours, theirs)


def test_frame_producers_match_jax():
    """The encoder's frame producers: groups of frames in [-1, 1], in the
    asked dtype, equal to the whole video's frames and to JAX's."""
    import torch
    tracks, vis = _distinct_depth_tracks(12)
    ours = tdev.DeviceRasterizer(tracks, vis, H, W, device="cpu")
    theirs = jdev.DeviceRasterizer(tracks, vis, H, W)
    pairs = [(ours.tracking_frame_fn(), theirs.tracking_frame_fn(),
              ours.tracking_video(normalize=True)),
             (ours.depth_frame_fn(), theirs.depth_frame_fn(),
              ours.depth_video(normalize=True)),
             (ours.cos_frame_fn(3), theirs.cos_frame_fn(3),
              ours.cos_video(3, normalize=True))]
    for mine, jax_fn, whole in pairs:
        for a, n in ((0, 9), (0, 5), (5, 4), (8, 1)):
            got = mine(a, n)
            assert got.shape == (1, 3, n, H, W)
            np.testing.assert_array_equal(got.numpy(),
                                          whole[:, :, a:a + n].numpy())
            np.testing.assert_allclose(got.numpy(), np.asarray(jax_fn(a, n)),
                                       rtol=0, atol=1.2e-7)
    bf = ours.tracking_frame_fn(torch.bfloat16)(2, 3)
    assert bf.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        bf.float().numpy(),
        ours.tracking_video(normalize=True)[:, :, 2:5].bfloat16().float()
        .numpy())
    ours.drop(ours.track_window, True)
    assert (ours.track_window, True) not in ours._pimg_cache
    ours.free()
    assert not ours._pimg_cache
