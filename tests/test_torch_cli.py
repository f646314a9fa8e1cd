"""The CLI's host modules and the orchestrator of the port against the JAX
package, on the CPU: the fg/bg edit masks (JAX's use OpenCV), the media
readers, the pose solver and pose fixtures, the long-video windows, and
`FlexAMOrchestrator.apply_tracks` / `apply_tracking` with JAX's noise
crossing as `latents=`.

Files: JAX reads videos with OpenCV (here a lossless PNG sequence) and
images with PIL (PNG); the port reads the same frames from an `.npz` frame
dump and `.npy` images, the formats it takes without a decoder.
"""

import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from flexam_tpu import config as jcfg
from flexam_tpu import long_video as jlong
from flexam_tpu import orchestrator as jorch
from flexam_tpu import pipeline as jpipe
from flexam_tpu.conditioning import CameraMotionGenerator as JCam
from flexam_tpu.conditioning import ObjectMotionGenerator as JObj
from flexam_tpu.models import dit as jdit
from flexam_tpu.models import t5 as jt5
from flexam_tpu.models import vae as jvae
from flexam_tpu.perception import pose_solver as jsolver
from flexam_tpu.perception import poses as jposes
from flexam_tpu.utils import masks as jmasks
from flexam_tpu.utils import media as jmedia
from flexam_tpu_torch import config as tcfg
from flexam_tpu_torch import long_video as tlong
from flexam_tpu_torch import orchestrator as torch_orch
from flexam_tpu_torch import pipeline as tpipe
from flexam_tpu_torch.conditioning import CameraMotionGenerator as TCam
from flexam_tpu_torch.conditioning import ObjectMotionGenerator as TObj
from flexam_tpu_torch.io.convert import from_jax_params
from flexam_tpu_torch.perception import pose_solver as tsolver
from flexam_tpu_torch.perception import poses as tposes
from flexam_tpu_torch.utils import masks as tmasks
from flexam_tpu_torch.utils import media as tmedia
from flexam_tpu_torch.utils import timing as ttiming


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops: beside the other test workers, torch's
    intra-op threads would oversubscribe the cores and stall at every op's
    barrier (tests/test_torch_video_tracking.py), so one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


T, H, W = 9, 32, 32
U8 = dict(rtol=0, atol=1.01 / 255)       # one uint8 step of the decode


def _port(tree):
    return from_jax_params(jax.tree_util.tree_map(np.asarray, tree),
                           device="cpu")


def _write_png_sequence(frames, d):
    """uint8 [T, H, W, 3] RGB frames as a PNG sequence OpenCV reads as a
    video, losslessly."""
    os.makedirs(d, exist_ok=True)
    for i, f in enumerate(frames):
        cv2.imwrite(os.path.join(d, f"f_{i:03d}.png"), f[..., ::-1])
    return os.path.join(d, "f_%03d.png")


def _write_npz_dump(frames, path, fps=25):
    np.savez_compressed(path, video=frames, fps=fps)
    return path


# ---------------------------------------------------------------------------
# Masks
# ---------------------------------------------------------------------------

def _mask_video(seed, f=5, h=48, w=64):
    """Mask videos with several components, holes and shapes touching the
    frame's edges, as [F, 3, H, W] in [0, 1]."""
    rng = np.random.RandomState(seed)
    out = np.zeros((f, h, w), np.uint8)
    for i in range(f):
        m = out[i]
        for _ in range(rng.randint(1, 4)):
            cv2.circle(m, (int(rng.randint(-5, w + 5)),
                           int(rng.randint(-5, h + 5))),
                       int(rng.randint(3, 14)), 255, -1)
        cv2.rectangle(m, (int(rng.randint(0, w)), int(rng.randint(0, h))),
                      (int(rng.randint(0, w)), int(rng.randint(0, h))), 255,
                      -1)
        cv2.circle(m, (w // 2, h // 2), int(rng.randint(2, 6)), 0, -1)  # hole
        m[rng.rand(h, w) < 0.01] = 255                               # specks
    return np.repeat(out[:, None], 3, axis=1).astype(np.float32) / 255.0


@pytest.mark.parametrize("blur,dilation", [(15, 200), (15, 3), (0, 2),
                                           (0, 0), (6, 9)])
def test_fg_mask_matches_jax_bit_for_bit(blur, dilation):
    """The OpenCV-free foreground mask equals JAX's cv2 one on every pixel:
    components, holes, specks (kept without blur: single pixels and short
    lines, which JAX skips), shapes cut by the frame's edges."""
    for seed in range(3):
        mv = _mask_video(seed)
        want = jmasks.generate_mask_fg_tracking(mv, blur_radius=blur,
                                                dilation_pixels=dilation)
        got = tmasks.generate_mask_fg_tracking(mv, blur_radius=blur,
                                               dilation_pixels=dilation,
                                               device="cpu")
        assert got.dtype == want.dtype and got.shape == want.shape
        assert not got[0].any()
        np.testing.assert_array_equal(got, want, err_msg=f"seed {seed}")


def test_hull_fill_and_ellipse_match_opencv():
    """The pieces against OpenCV directly: filled hulls of random point
    sets (cv2.fillPoly of cv2.convexHull), the ellipse element, and the
    dilation."""
    rng = np.random.RandomState(4)
    for _ in range(200):
        pts = rng.randint(0, 40, (rng.randint(3, 9), 2))
        hull = tmasks._hull(pts)
        if len(hull) < 3:
            continue
        ref = np.zeros((42, 42), np.uint8)
        cv2.fillPoly(ref, [cv2.convexHull(pts.astype(np.int32))], 1)
        got = np.zeros((42, 42), np.uint8)
        tmasks._fill_convex(got, hull)
        np.testing.assert_array_equal(got, ref)
    for r in (0, 1, 4, 17, 200):
        k = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (2 * r + 1,) * 2)
        widths = tmasks.ellipse_half_widths(r)
        np.testing.assert_array_equal(k.sum(1), 2 * widths + 1)
        m = rng.rand(2, 30, 45) < 0.01
        want = np.stack([cv2.dilate(x.astype(np.uint8), k) for x in m]) > 0
        got = tmasks.dilate_ellipse(torch.from_numpy(m), r).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"r {r}")


def test_bg_mask_matches_jax():
    for mv in (_mask_video(5), _mask_video(6) * 255.0):
        np.testing.assert_array_equal(tmasks.generate_mask_bg_tracking(mv),
                                      jmasks.generate_mask_bg_tracking(mv))


# ---------------------------------------------------------------------------
# Media
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [(H, W), (24, 40)], ids=["same", "resized"])
def test_media_readers_match_jax(tmp_path, size):
    """Video, mask video, image-to-video and image readers on the same
    frames: equal at sample_size; resized, images equal (PIL's bicubic in
    its fixed point) and video frames within one uint8 level (OpenCV's
    bilinear)."""
    rng = np.random.RandomState(7)
    frames = rng.randint(0, 256, (T, 20, 28, 3)).astype(np.uint8)
    frames[:, :, :, 1] = cv2.GaussianBlur(frames[:, :, :, 1], (5, 5), 2)
    img = rng.randint(0, 256, (20, 28, 3)).astype(np.uint8)
    if size == (H, W):
        frames = np.stack([cv2.resize(f, (W, H)) for f in frames])
        img = cv2.resize(img, (W, H))
    seq = _write_png_sequence(frames, str(tmp_path / "seq"))
    dump = _write_npz_dump(frames, str(tmp_path / "v.npz"))
    np.save(str(tmp_path / "img.npy"), img)
    Image.fromarray(img).save(str(tmp_path / "img.png"))
    vid_tol = 0 if size == (H, W) else 1.01 / 255

    got = tmedia.get_maskvideo_input(dump, 6, size)
    want = jmedia.get_maskvideo_input(seq, 6, size)
    np.testing.assert_allclose(got, want, rtol=0, atol=vid_tol)
    got = tmedia.get_video_input(dump, 7, size)
    want = jmedia.get_video_input(seq, 7, size)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=vid_tol)
    np.testing.assert_array_equal(got[1], want[1])
    # arrays are taken as they are, by both
    for g, w in zip(tmedia.get_video_input(frames, 5, size,
                                           ref_image=str(tmp_path / "img.npy")),
                    jmedia.get_video_input(frames, 5, size,
                                           ref_image=str(tmp_path / "img.png"))):
        np.testing.assert_array_equal(g, w)
    for pad in (False, True):
        np.testing.assert_array_equal(
            tmedia.get_image_latent(str(tmp_path / "img.npy"), size, pad),
            jmedia.get_image_latent(str(tmp_path / "img.png"), size, pad))
    for g, w in zip(tmedia.get_image_to_video_input(img, 5, size, img[::-1]),
                    jmedia.get_image_to_video_input(img, 5, size, img[::-1])):
        np.testing.assert_array_equal(g, w)
    assert tmedia.is_video_path(dump) and not tmedia.is_video_path(
        str(tmp_path / "img.npy"))


def test_media_refuses_files_it_cannot_decode(tmp_path):
    with pytest.raises(ValueError, match="PIL"):
        tmedia.get_image_latent(str(tmp_path / "x.png"), (H, W))
    with pytest.raises(ValueError, match="OpenCV"):
        tmedia.get_maskvideo_input(str(tmp_path / "x.mp4"), 3, (H, W))


def test_save_video_round_trip(tmp_path):
    """save_video writes through imageio or, without a usable encoder, an
    .npz dump that the readers take back: uint8 frames as JAX's writer
    quantizes them."""
    v = np.random.RandomState(8).rand(1, 3, 4, H, W).astype(np.float32)
    path = tmedia.save_video(v, str(tmp_path / "out.mp4"), fps=8)
    want = (np.clip(v[0].transpose(1, 2, 3, 0), 0, 1) * 255).astype(np.uint8)
    if path.endswith(".npz"):
        frames, fps = tmedia.read_video_frames(path)
        assert fps == 8
        np.testing.assert_array_equal(frames, want)
    else:
        assert os.path.getsize(path) > 0


def test_timing_spans_and_profile(tmp_path):
    m = ttiming.Metrics()
    with m.span("a", sync=[torch.ones(2)]):
        pass
    m.count("n", 2)
    assert set(m.spans) == {"a"} and m.counters == {"n": 2.0}
    assert '"spans_s"' in m.dump(str(tmp_path / "m.json"))
    with ttiming.torch_profile(str(tmp_path / "trace")):
        torch.ones(4).sum()
    assert os.path.exists(tmp_path / "trace" / "trace.json")


# ---------------------------------------------------------------------------
# Poses (tests/test_pose_solver.py mirrored) and pose fixtures
# ---------------------------------------------------------------------------

def _rotation(axis, deg):
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    th = np.deg2rad(deg)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def _synthetic_scene(t=12, n=300, w=640, h=480, seed=0, outliers=0):
    rng = np.random.RandomState(seed)
    K = tsolver.default_intrinsics(w, h)
    world = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                      rng.uniform(4, 9, n)], axis=1)
    extr = np.zeros((t, 3, 4))
    tracks = np.zeros((t, n, 3), np.float32)
    for i in range(t):
        R = _rotation([0, 1, 0], 2.0 * i) @ _rotation([1, 0, 0], 0.7 * i)
        tv = np.array([0.05 * i, -0.02 * i, 0.1 * np.sin(i / 3.0)])
        extr[i, :, :3], extr[i, :, 3] = R, tv
        cam = world @ R.T + tv
        tracks[i, :, 0] = cam[:, 0] / cam[:, 2] * K[0, 0] + K[0, 2]
        tracks[i, :, 1] = cam[:, 1] / cam[:, 2] * K[1, 1] + K[1, 2]
        tracks[i, :, 2] = cam[:, 2]
    vis = np.ones((t, n), bool)
    if outliers:
        idx = rng.choice(n, outliers, replace=False)
        drift = rng.uniform(-1, 1, (outliers, 3)) * 0.4
        for i in range(t):
            cam = (world[idx] + drift * i) @ extr[i, :, :3].T + extr[i, :, 3]
            tracks[i, idx, 0] = cam[:, 0] / cam[:, 2] * K[0, 0] + K[0, 2]
            tracks[i, idx, 1] = cam[:, 1] / cam[:, 2] * K[1, 1] + K[1, 2]
            tracks[i, idx, 2] = cam[:, 2]
    return tracks, vis, extr, K


def _pose_err(extr, true):
    rot = np.linalg.norm(extr[:, :, :3] - true[:, :, :3], axis=(1, 2))
    return rot.max(), np.linalg.norm(extr[:, :, 3] - true[:, :, 3],
                                     axis=1).max()


def _solve_both(tracks, vis, **kw):
    got = tsolver.solve_camera_poses(tracks, vis, **kw)
    want = jsolver.solve_camera_poses(tracks, vis, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    return got


@pytest.mark.parametrize("case", ["clean", "moving_object_occlusion",
                                  "intrinsics_prior", "camera_path_roundtrip",
                                  "untrackable_frame"])
def test_pose_solver_matches_jax(case):
    """The five cases of `tests/test_pose_solver.py`, each on both
    packages (equal outputs) with the JAX test's own bounds."""
    if case == "clean":
        tracks, vis, true, K = _synthetic_scene()
        extr, k_all = _solve_both(tracks, vis, intrinsics=K)
        rot, tr = _pose_err(extr.astype(np.float64), true)
        assert rot < 1e-4 and tr < 1e-4 and k_all.shape == (12, 3, 3)
    elif case == "moving_object_occlusion":
        tracks, vis, true, K = _synthetic_scene(n=400, outliers=80, seed=1)
        vis &= np.random.RandomState(2).rand(*vis.shape) > 0.15
        extr, _ = _solve_both(tracks, vis, intrinsics=K)
        rot, tr = _pose_err(extr.astype(np.float64), true)
        assert rot < 1e-3 and tr < 1e-3
    elif case == "intrinsics_prior":
        K = tsolver.default_intrinsics(896, 512)
        np.testing.assert_array_equal(K, jsolver.default_intrinsics(896, 512))
        assert K[0, 2] == 448 and K[1, 2] == 256
    elif case == "camera_path_roundtrip":
        tracks, vis, true, K = _synthetic_scene(seed=3)
        extr, k_all = _solve_both(tracks, vis, intrinsics=K)
        world = TCam("", frame_num=12, H=480, W=640).s2w_vggt(tracks, extr,
                                                              k_all)
        np.testing.assert_allclose(
            world, JCam("", frame_num=12, H=480, W=640).s2w_vggt(
                tracks, extr, k_all), rtol=1e-6, atol=1e-6)
        assert world.std(axis=0).mean() < 1e-3
        np.testing.assert_allclose(
            world[5], tsolver.unproject_tracks(tracks, K)[0],
            rtol=1e-3, atol=1e-3)
    else:
        tracks, vis, true, K = _synthetic_scene(t=6)
        vis[3] = False
        extr, _ = _solve_both(tracks, vis, intrinsics=K)
        np.testing.assert_allclose(extr[3], extr[2])


def test_pose_fixtures_match_jax(tmp_path):
    """`poses_npz_to_extri_intri` on the three fixture formats."""
    rng = np.random.RandomState(9)
    q = rng.randn(5, 4)
    enc = np.concatenate([rng.randn(5, 3), q / np.linalg.norm(q, axis=1,
                                                                keepdims=True),
                          rng.uniform(0.5, 1.2, (5, 2))], 1).astype(np.float32)
    c2w = np.tile(np.eye(4, dtype=np.float32), (5, 1, 1))
    c2w[:, :3, :3] = tposes.quat_to_rotmat(enc[:, 3:7])
    c2w[:, :3, 3] = enc[:, :3]
    fixtures = {"extr": dict(extrinsics=c2w[:, :3]),
                "extr_intr": dict(extrinsics=c2w[:, :3],
                                  intrinsics=np.tile(np.eye(3), (5, 1, 1))),
                "vggt": dict(pose_encoding=enc), "pi3": dict(camera_poses=c2w)}
    for name, data in fixtures.items():
        path = str(tmp_path / f"{name}.npz")
        np.savez(path, **data)
        for g, w in zip(tposes.poses_npz_to_extri_intri(path, 64, 48),
                        jposes.poses_npz_to_extri_intri(path, 64, 48)):
            np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_array_equal(tposes.rotmat_to_quat(c2w[:, :3, :3]),
                                  jposes.rotmat_to_quat(c2w[:, :3, :3]))


# ---------------------------------------------------------------------------
# Long video (tests/test_long_video.py mirrored)
# ---------------------------------------------------------------------------

def _recording_window(calls):
    def window(start_frames=None, num_frames=None, frame_offset=0, **kw):
        calls.append((frame_offset, num_frames, None if start_frames is None
                      else start_frames.shape[2]))
        base = 0.0 if start_frames is None else float(
            start_frames[0, 0, -1, 0, 0])
        vals = base + np.arange(num_frames, dtype=np.float32)
        if start_frames is not None:
            vals[:start_frames.shape[2]] = start_frames[0, 0, :, 0, 0]
        return np.tile(vals[None, None, :, None, None], (1, 3, 1, 4, 4))
    return window


@pytest.mark.parametrize("total,partial,overlap", [(21, 9, 3), (9, 5, 2),
                                                   (97, 25, 4), (11, 21, 4)])
def test_long_video_windows_match_jax(total, partial, overlap):
    """The window schedule, seeding and cross-fade of
    `tests/test_long_video.py`'s composition and final-window cases."""
    calls, jcalls = [], []
    out = tlong.generate_long_video(_recording_window(calls), total, partial,
                                    overlap)
    want = jlong.generate_long_video(_recording_window(jcalls), total,
                                     partial, overlap)
    assert calls == jcalls
    np.testing.assert_array_equal(out, want)
    assert out.shape[2] == total
    assert (np.diff(out[0, 0, :, 0, 0]) >= -1e-5).all()


def test_window_inputs_from_seed_matches_jax():
    seed = np.full((1, 3, 3, 8, 8), 0.7, np.float32)
    for s in (seed, None):
        for g, w in zip(tlong.window_inputs_from_seed(s, 9, 8, 8),
                        jlong.window_inputs_from_seed(s, 9, 8, 8)):
            np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# Orchestrator and long video through the pipelines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pipes():
    cfg = jcfg.tiny_test_config()
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    dp = jdit.init_dit_params(k1, cfg.dit, dtype=jnp.float32)
    vp = jvae.init_vae_params(k2, cfg.vae)
    tp5 = jt5.init_t5_params(k3, cfg.t5)
    jp = jpipe.FlexAMGenerationPipeline(
        jpipe.FlexAMModels(cfg=cfg, dit_params=dp, vae_params=vp,
                           t5_params=tp5), compute_dtype=jnp.float32)
    tp = tpipe.FlexAMGenerationPipeline(
        tpipe.FlexAMModels(cfg=tcfg.tiny_test_config(), dit_params=_port(dp),
                           vae_params=_port(vp), t5_params=_port(tp5)),
        device="cpu")
    return jp, tp


def _noise(seed, t=T):
    lt = (t - 1) // 4 + 1
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                        (1, 8, lt, H // 16, W // 16)))


def _scene(seed=3):
    rng = np.random.RandomState(seed)
    n = 40
    base = np.stack([rng.uniform(2, W - 2, n), rng.uniform(2, H - 2, n),
                     rng.uniform(1.0, 3.0, n)], axis=1)
    drift = rng.uniform(-0.5, 0.5, (T, 1, 3)).cumsum(0)
    tracks = (base[None] + drift).astype(np.float32)
    video = rng.rand(1, 3, T, H, W).astype(np.float32)
    mask = np.zeros((T, H, W, 3), np.uint8)
    mask[:, H // 4: 3 * H // 4, W // 4: 3 * W // 4] = 255
    return tracks, np.ones((T, n), bool), video, mask


@pytest.mark.parametrize("mode", ["full_edit", "foreground_edit",
                                  "background_edit", "camera_object"])
def test_apply_tracks_matches_jax(pipes, tmp_path, mode):
    """The device path (`apply_tracks`) on both packages, the port given
    JAX's noise: the decoded videos within one uint8 step, the tolerance
    `tests/test_torch_track_path.py` holds generate_from_cond to."""
    jp, tp = pipes
    tracks, vis, video, mask = _scene()
    seed = 5
    kw = dict(prompt="a test scene", num_inference_steps=2,
              guidance_scale=6.0, density=0.125, seed=seed)
    jtracks = ttracks = tracks
    if mode == "camera_object":
        omask = np.zeros((H, W), bool)
        omask[H // 4: 3 * H // 4, W // 4: 3 * W // 4] = True
        extr = np.tile(np.eye(3, 4, dtype=np.float32), (T, 1, 1))
        extr[:, 2, 3] = 4.0
        intr = np.tile(np.array([[24.0, 0, W / 2], [0, 24.0, H / 2],
                                 [0, 0, 1]], np.float32), (T, 1, 1))
        out = []
        for Cam, Obj in ((JCam, JObj), (TCam, TObj)):
            cam = Cam("trans 0.1 0 0.2; rot y 10", frame_num=T, H=H, W=W)
            tr = cam.w2s_vggt(cam.s2w_vggt(tracks, extr, intr), extr, intr,
                              cam.get_default_motion())
            out.append(Obj().apply_motion(tr, omask, "up", 50, num_frames=T,
                                          tracking_method="DELTA"))
        jtracks, ttracks = out
        np.testing.assert_allclose(ttracks, jtracks, rtol=1e-6, atol=1e-5)
    if mode in ("full_edit", "camera_object"):
        jkw = tkw = dict(first_frame=video[:, :, :1])
    else:
        m01 = (mask[None].transpose(0, 4, 1, 2, 3)[:, :1] / 255.0).astype(
            np.float32)
        jkw = dict(video=video, mask_video=m01, ref_image=video[:, :, :1],
                   mask_path=_write_png_sequence(mask, str(tmp_path / "seq")))
        tkw = dict(jkw, mask_path=_write_npz_dump(mask, str(tmp_path / "m.npz")))
    gen_type = "full_edit" if mode == "camera_object" else mode
    jo = jorch.FlexAMOrchestrator(jp, output_dir=str(tmp_path / "j"),
                                  save_tracking=False)
    to = torch_orch.FlexAMOrchestrator(tp, output_dir=str(tmp_path / "t"),
                                       save_tracking=False)
    want = jo.apply_tracks(jtracks, vis, H, W, generate_type=gen_type, **jkw,
                           **kw)
    got = to.apply_tracks(ttracks, vis, H, W, generate_type=gen_type, **tkw,
                          latents=_noise(seed), **kw)
    assert got.shape == (1, 3, T, H, W)
    np.testing.assert_allclose(got, want, **U8)


@pytest.mark.parametrize("mode", ["full_edit", "background_edit"])
def test_apply_tracking_matches_jax(pipes, tmp_path, mode):
    """The host path: `visualize_tracking` (numpy rasterizers, artifacts
    saved) then `apply_tracking` (`generate`), on both packages."""
    jp, tp = pipes
    tracks, vis, video, mask = _scene(seed=4)
    jo = jorch.FlexAMOrchestrator(jp, output_dir=str(tmp_path / "j"))
    to = torch_orch.FlexAMOrchestrator(tp, output_dir=str(tmp_path / "t"))
    jmask = tmask = None
    if mode == "background_edit":
        jmask = _write_png_sequence(mask, str(tmp_path / "seq"))
        tmask = _write_npz_dump(mask, str(tmp_path / "m.npz"))
    jvis = jo.visualize_tracking(tracks, vis, H, W, generate_type=mode,
                                 mask_path=jmask)
    tvis = to.visualize_tracking(tracks, vis, H, W, generate_type=mode,
                                 mask_path=tmask)
    np.testing.assert_array_equal(tvis[0], jvis[0])
    np.testing.assert_array_equal(tvis[2], jvis[2])
    for k in jvis[1]:
        np.testing.assert_array_equal(tvis[1][k], jvis[1][k])
    assert len(os.listdir(tmp_path / "t")) == 6
    inpaint_mask = np.full((1, 1, T, H, W), 255.0, np.float32)
    inpaint_mask[:, :, 0] = 0.0
    args = (video[:, :, :1], video, inpaint_mask)
    kw = dict(prompt="a test scene", num_inference_steps=2,
              guidance_scale=6.0, density=0.125, seed=6)
    want = jo.apply_tracking(*jvis, *args, **kw)
    got = to.apply_tracking(*tvis, *args, latents=_noise(6), **kw)
    np.testing.assert_allclose(got, want, **U8)


def test_long_video_with_real_pipelines(pipes):
    """`tests/test_long_video.py`'s two overlapped windows through the tiny
    pipelines of both packages (each window's noise JAX's, as latents=)."""
    jp, tp = pipes

    def windows(pipe, port):
        def window(start_frames=None, num_frames=None, frame_offset=0):
            video, mask = tlong.window_inputs_from_seed(start_frames,
                                                        num_frames, H, W)
            kw = dict(mask_video=mask, num_inference_steps=2,
                      guidance_scale=6.0, seed=3, density=0.1)
            if port:
                kw["latents"] = _noise(3, num_frames)
            return pipe.generate(video, "long video", **kw)
        return window

    want = jlong.generate_long_video(windows(jp, False), 13, 9, 1)
    got = tlong.generate_long_video(windows(tp, True), 13, 9, 1)
    assert got.shape == (1, 3, 13, H, W) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **U8)
