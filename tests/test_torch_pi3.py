"""The port's Pi3 (`flexam_tpu_torch/perception/pi3.py`) against the JAX
package's, on the CPU at the tiny geometry of `tests/test_pi3.py`
(`_TINY`), with the weights crossed through `io.convert.from_jax_params`.

The forward's poses, points and confidence, `pi3_video_poses` (strided
views, interpolated back), `load_images_as_tensor` on a `.mp4.npz` frame
dump and `CameraMotionGenerator.process_video_file` with its `path`
branch are held at rtol 2e-4 / atol 1e-5 in fp32, with the pose head's
zero-initialised last layer set to random values so that the poses are not
the identity by construction. OpenCV's INTER_AREA, numpy's here
(`utils.media.resize_frames_area`), equals `cv2.resize` on float and uint8
frames at the fractional factors the port uses. The properties of JAX's
tests are the port's too: permutation equivariance, SE(3) poses, the
identity at init. The loaders map a state dict of distinct values leaf for
leaf as JAX's do.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from flexam_tpu.perception import pi3 as J
from flexam_tpu_torch.perception import pi3 as T
from tests.test_pi3 import _TINY
from tests.test_torch_moge import (assert_maps_like_jax, assert_same_params,
                                   distinct_state_dict, jax_tree, port_tree,
                                   write_checkpoint)

TOL = dict(rtol=2e-4, atol=1e-5)
TINY_T = T.Pi3Config(**dataclasses.asdict(_TINY))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These modules run thousands of small torch ops; beside the other
    test workers, torch's intra-op threads would oversubscribe the cores
    and stall at every op's barrier, so they run on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_model(params):
    """A JAX Pi3 holding `params` (JAX's eager init compiles op by op)."""
    jm = J.Pi3.__new__(J.Pi3)
    jm.cfg, jm.params = _TINY, params
    jm.load_report, jm.load_ok = None, False
    jm._jit = jax.jit(lambda p, x: J.pi3_forward(p, _TINY, x))
    return jm


def tiny_tree(seed, cam_fc2=True):
    params = T.pi3_init(torch.Generator().manual_seed(seed), TINY_T, "cpu")
    if cam_fc2:
        g = torch.Generator().manual_seed(seed + 100)
        params["cam_fc2"] = {
            "weight": torch.randn((7, TINY_T.dec_dim), generator=g) * 0.05,
            "bias": torch.randn((7,), generator=g) * 0.05}
    return params


@pytest.fixture(scope="module")
def models():
    jp = jax_tree(tiny_tree(0))
    tm = T.Pi3(TINY_T, device="cpu")
    tm.params = port_tree(jp)
    return jax_model(jp), tm


def _imgs(n=3, seed=0):
    return np.random.RandomState(seed).rand(n, 3, 28, 42).astype(np.float32)


def test_forward_matches_jax(models):
    jm, tm = models
    imgs = _imgs(3)
    want = jm(imgs[None])
    got = tm(imgs)                       # batchless, as the reference allows
    assert set(got) == set(want)
    assert got["camera_poses"].shape == (1, 3, 4, 4)
    assert got["points"].shape == (1, 3, 28, 42, 3)
    assert got["conf"].shape == (1, 3, 28, 42, 1)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)
    assert np.abs(got["camera_poses"][0, :, :3, 3]).max() > 1e-3
    with pytest.raises(ValueError, match="imgs"):
        tm(imgs[0])


def test_poses_are_se3_and_identity_at_init(models):
    _, tm = models
    for p in tm(_imgs(2)[None])["camera_poses"][0]:
        R = p[:3, :3]
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)
        assert abs(np.linalg.det(R) - 1.0) < 1e-4
        np.testing.assert_array_equal(p[3], [0, 0, 0, 1])
    fresh = T.Pi3(TINY_T, seed=2, device="cpu")
    np.testing.assert_array_equal(
        fresh(_imgs(2)[None])["camera_poses"][0],
        np.stack([np.eye(4, dtype=np.float32)] * 2))


def test_permutation_equivariance(models):
    """No view-index encoding: permuting the views permutes every output."""
    _, tm = models
    imgs = _imgs(4, seed=3)
    perm = np.asarray([2, 0, 3, 1])
    direct = tm(imgs[None])
    permuted = tm(imgs[perm][None])
    for k in direct:
        np.testing.assert_allclose(permuted[k][0], direct[k][0][perm],
                                   rtol=2e-4, atol=2e-5, err_msg=k)


def test_video_poses_match_jax(models):
    """Six frames at chunk 1: views 0, 2, 4 and 5 (stride 2 plus the last),
    the INTER_AREA resize of float frames to 28x42, and the poses
    interpolated back to every frame."""
    jm, tm = models
    video = np.random.RandomState(7).rand(6, 30, 44, 3).astype(np.float32)
    np.testing.assert_array_equal(T.pi3_views(6, 1), [0, 2, 4, 5])
    assert len(T.pi3_views(49)) == 25            # the demo's 49 frames
    want = J.pi3_video_poses(video, model=jm, chunk=1)
    got = T.pi3_video_poses(video, model=tm, chunk=1)
    assert got.shape == (6, 4, 4) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(
        T.pi3_video_poses(video.transpose(0, 3, 1, 2), model=tm, chunk=1),
        got, rtol=0, atol=0)


@pytest.mark.parametrize("hw,size", [((512, 896), (378, 672)),
                                     ((30, 44), (28, 42)),
                                     ((28, 42), (28, 42)),
                                     ((480, 640), (378, 672)),
                                     ((32, 32), (28, 42))])
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_area_resize_matches_opencv(hw, size, dtype):
    """OpenCV's INTER_AREA. Shrinking both sides (by non-integer factors,
    512x896 -> 378x672 among them) takes its fractional-area path: float32
    sums in OpenCV's order, equal to it value for value. Where a side
    grows, OpenCV interpolates linearly with area-mode fractions: equal in
    float32, and within one level in uint8 (OpenCV's 11-bit fixed point)."""
    import cv2
    from flexam_tpu_torch.utils.media import resize_frames_area
    rs = np.random.RandomState(2)
    f = rs.rand(2, *hw, 3)
    f = (f * 255).astype(np.uint8) if dtype == "uint8" else f.astype(
        np.float32)
    want = np.stack([cv2.resize(x, size[::-1], interpolation=cv2.INTER_AREA)
                     for x in f])
    got = resize_frames_area(f, size)
    assert got.dtype == want.dtype and got.shape == want.shape
    if dtype == "uint8" and not (size[0] <= hw[0] and size[1] <= hw[1]):
        assert np.abs(got.astype(int) - want).max() <= 1
    else:
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def dump(tmp_path_factory):
    """A clip as `save_video` leaves it without an encoder: only
    `clip.mp4.npz` (uint8 frames), no `clip.mp4`."""
    d = tmp_path_factory.mktemp("pi3_clip")
    frames = (np.random.RandomState(9).rand(5, 32, 48, 3) * 255).astype(
        np.uint8)
    np.savez_compressed(d / "clip.mp4.npz", video=frames, fps=8)
    return str(d / "clip.mp4")


def test_load_images_as_tensor_matches_jax(dump, tmp_path):
    got = T.load_images_as_tensor(dump, interval=2, target_hw=(28, 42))
    want = J.load_images_as_tensor(dump, interval=2, target_hw=(28, 42))
    assert got.shape == (3, 3, 28, 42) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        T.load_images_as_tensor(dump + ".npz", target_hw=(28, 42)),
        J.load_images_as_tensor(dump + ".npz", target_hw=(28, 42)))
    real = tmp_path / "real.mp4"
    real.write_bytes(b"\x00" * 64)
    with pytest.raises(ValueError, match="OpenCV or imageio"):
        T.load_images_as_tensor(str(real))


def test_process_video_file_matches_jax(models, dump, monkeypatch):
    """`process_video_file`: Pi3 on the dump's frames -> w2c Camera entries
    with the 55-degree FoV intrinsic; and the DSL's `path` branch on the
    video (its extension check kept) gives JAX's relative w2c poses."""
    from flexam_tpu.conditioning.camera import CameraMotionGenerator as JCam
    from flexam_tpu_torch.conditioning.camera import \
        CameraMotionGenerator as TCam
    jm, tm = models
    monkeypatch.setattr(J, "Pi3Config", lambda: _TINY)    # infer_hw 28x42
    monkeypatch.setattr(T, "Pi3Config", lambda: TINY_T)
    gen_t = TCam("path", frame_num=7, H=384, W=672, pose_file=dump,
                 device="cpu")
    gen_j = JCam("path", frame_num=7, H=384, W=672, pose_file=dump)
    tc = gen_t.process_video_file(dump, model=tm)
    jc = gen_j.process_video_file(dump, model=jm)
    assert len(tc) == len(jc) == 5
    fx = (672 / 2) / np.tan(np.radians(55) / 2)
    assert abs(tc[0].fx - fx) < 1e-3
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(a.w2c_mat, b.w2c_mat, **TOL)
    np.testing.assert_array_equal(gen_t.intr, gen_j.intr)
    monkeypatch.setattr(T.Pi3, "from_pretrained",
                        classmethod(lambda cls, *a, **k: tm))
    monkeypatch.setattr(J.Pi3, "from_pretrained",
                        classmethod(lambda cls, *a, **k: jm))
    got, want = gen_t.get_default_motion(), gen_j.get_default_motion()
    assert got.shape == (7, 4, 4)
    np.testing.assert_allclose(got, want, **TOL)
    with pytest.raises(ValueError, match="pose source"):
        TCam("path", pose_file="poses.json").get_default_motion()


def test_state_dict_maps_to_the_same_leaves_as_jax(models):
    """The greedy shape mapper over Pi3's lists (dec_frame, dec_global)."""
    jm, tm = models
    assert_maps_like_jax(jm.params, tm.params,
                         distinct_state_dict(jm.params, 13))


@pytest.mark.parametrize("fmt", ["safetensors", "pt", "dir"])
def test_load_pi3_matches_jax(models, tmp_path, monkeypatch, fmt):
    """A file in the loaders' order loads fully in both packages (a
    directory resolves to model.safetensors first), also through
    `from_pretrained` on FLEXAM_PI3_CKPT, with the same weights and poses."""
    jm, tm = models
    if fmt == "dir":
        write_checkpoint(tm.params, tmp_path / "model.safetensors",
                         "safetensors")
        write_checkpoint(tiny_tree(8), tmp_path / "model.pt", "pt")
        path = str(tmp_path)
    else:
        path = write_checkpoint(tm.params, tmp_path / f"pi3.{fmt}", fmt)
    jl = J.load_pi3(path, jax_model(jax_tree(tiny_tree(5))))
    tl = T.load_pi3(path, cfg=TINY_T, device="cpu")
    assert jl.load_ok and tl.load_ok
    assert tl.load_report == jl.load_report
    assert_same_params(tl.params, jl.params)
    monkeypatch.setenv("FLEXAM_PI3_CKPT", path)
    monkeypatch.chdir(tmp_path)
    fp = T.Pi3.from_pretrained(cfg=TINY_T, device="cpu")
    assert fp.load_ok
    imgs = _imgs(2, seed=4)[None]
    np.testing.assert_allclose(fp(imgs)["camera_poses"],
                               jm(imgs)["camera_poses"], **TOL)


def test_loader_coverage_gating(models, tmp_path, monkeypatch, capsys):
    """A junk checkpoint is flagged, not served as trained; a self
    checkpoint under fake names passes; a missing file raises before any
    model is built; without a checkpoint `from_pretrained` warns."""
    _, tm = models
    junk = str(tmp_path / "pi3.pt")
    torch.save({"junk.weight": torch.zeros(5, 5)}, junk)
    assert T.load_pi3(junk, cfg=TINY_T, device="cpu").load_ok is False
    good = write_checkpoint(T.Pi3(TINY_T, seed=2, device="cpu").params,
                            tmp_path / "good.pt", "pt")
    assert T.load_pi3(good, T.Pi3(TINY_T, device="cpu")).load_ok is True
    with pytest.raises(FileNotFoundError):
        T.load_pi3(str(tmp_path / "missing.pt"), cfg=TINY_T, device="cpu")
    monkeypatch.delenv("FLEXAM_PI3_CKPT", raising=False)
    monkeypatch.chdir(tmp_path)
    r = T.Pi3.from_pretrained(cfg=TINY_T, device="cpu")
    assert r.load_ok is False and "no Pi3 weights" in capsys.readouterr().out


def test_verify_ckpt_pi3_matches_jax(models, tmp_path, monkeypatch):
    from flexam_tpu.tools import verify_ckpt as jvc
    from flexam_tpu_torch.tools import verify_ckpt as tvc
    jm, tm = models
    fresh = [jax_model(jm.params) for _ in range(2)]
    monkeypatch.setattr(J, "Pi3", lambda cfg=None: fresh.pop())
    monkeypatch.setattr(T, "Pi3Config", lambda: TINY_T)
    good = write_checkpoint(tm.params, tmp_path / "pi3.pt", "pt")
    junk = str(tmp_path / "junk.pt")
    torch.save({"junk.weight": torch.zeros(5, 5)}, junk)
    for path, ok in ((good, True), (junk, False)):
        assert tvc.verify("pi3", path, "cpu") is ok
        assert jvc.verify("pi3", path) is ok
    assert tvc.main(["--model", "pi3", "--platform", "cpu", junk]) == 1


def test_demo_camera_control_takes_pi3_poses(models, tmp_path, monkeypatch,
                                             capsys):
    """`demo.main` on a clip with a tracks file without poses and
    FLEXAM_PI3_CKPT (no FLEXAM_VGGT_CKPT): the poses come from Pi3, equal
    to JAX's `pi3_video_poses` and 55-degree intrinsics on the same frames
    and checkpoint, not from the track solver. Then `--camera_motion path
    --pose_file clip.mp4` (only its frame dump exists) takes the camera
    path from Pi3 on the clip, as JAX's generator does."""
    from flexam_tpu.perception.poses import pi3_poses_to_extri_intri as jp2e
    from flexam_tpu_torch import demo
    from flexam_tpu_torch.perception import pose_solver
    from tests.test_torch_vggt import DEMO_H, DEMO_T, DEMO_W, demo_inputs, spy
    jm, tm = models
    argv = demo_inputs(tmp_path)
    ckpt = write_checkpoint(tm.params, tmp_path / "pi3.pt", "pt")
    monkeypatch.setattr(T, "Pi3Config", lambda: TINY_T)
    monkeypatch.delenv("FLEXAM_VGGT_CKPT", raising=False)
    monkeypatch.setenv("FLEXAM_PI3_CKPT", ckpt)
    monkeypatch.chdir(tmp_path)
    poses, solved, fits = [], [], []
    spy(monkeypatch, T, "pi3_video_poses", poses)
    spy(monkeypatch, pose_solver, "solve_camera_poses", solved)
    out = demo.main(argv + ["--camera_motion", "trans 0.1 0 0",
                            "--output_dir", str(tmp_path / "out")])
    assert out.shape == (1, 3, DEMO_T, DEMO_H, DEMO_W)
    assert "camera poses from the native Pi3 model" in capsys.readouterr(
        ).out
    assert len(poses) == 1 and not solved
    (frames,), _, c2w = poses[0]
    jl = J.load_pi3(ckpt, jax_model(jax_tree(tiny_tree(5))))
    np.testing.assert_allclose(c2w, J.pi3_video_poses(frames, model=jl),
                               **TOL)

    # a video as the camera path
    from flexam_tpu.conditioning.camera import CameraMotionGenerator as JCam
    from flexam_tpu_torch.conditioning import camera as tcam
    clip = tmp_path / "path.mp4"
    np.savez(str(clip) + ".npz",
             video=(np.random.RandomState(8).rand(4, 30, 44, 3) * 255
                    ).astype(np.uint8), fps=8)
    spy(monkeypatch, tcam.CameraMotionGenerator, "get_default_motion", fits)
    demo.main(argv + ["--camera_motion", "path", "--pose_file", str(clip),
                      "--output_dir", str(tmp_path / "path")])
    assert len(poses) == 2 and not solved and len(fits) == 1
    monkeypatch.setattr(J, "Pi3Config", lambda: _TINY)
    monkeypatch.setattr(J.Pi3, "from_pretrained",
                        classmethod(lambda cls, *a, **k: jl))
    want = JCam("path", frame_num=DEMO_T, H=DEMO_H, W=DEMO_W,
                pose_file=str(clip)).get_default_motion()
    np.testing.assert_allclose(fits[0][2], want, **TOL)
    assert not np.allclose(want, np.eye(4), atol=1e-3)
    e, i = jp2e(c2w, DEMO_W, DEMO_H)
    assert e.shape == (DEMO_T, 3, 4) and i.shape == (DEMO_T, 3, 3)
