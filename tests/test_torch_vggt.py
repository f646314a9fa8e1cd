"""The port's VGGT (`flexam_tpu_torch/perception/vggt.py`) against the JAX
package's, on the CPU at the tiny geometry of `tests/test_vggt.py`
(`_TINY`), with the weights crossed through `io.convert.from_jax_params`.

The aggregator's tokens list, the camera head's encodings and the depth
head's depth and confidence are held at rtol 2e-4 / atol 1e-5 in fp32, with
the camera head's zero-initialised last layer set to random values, so that
the poses are not the identity on both sides by construction;
`vggt_video_poses` likewise (its OpenCV bicubic resize is numpy's here,
`utils.media.resize_frames_cubic`, held to `cv2.resize` below). The
properties of JAX's tests are the port's too: identity poses at init and a
first frame that is special. The loaders map a state dict of distinct
values leaf for leaf as JAX's do, and the demo's camera path takes its poses
from the model, not from the track solver.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from flexam_tpu.perception import vggt as J
from flexam_tpu_torch.perception import vggt as T
from tests.test_torch_moge import (assert_maps_like_jax, assert_same_params,
                                   distinct_state_dict, jax_tree, port_tree,
                                   write_checkpoint)
from tests.test_vggt import _TINY

TOL = dict(rtol=2e-4, atol=1e-5)
TINY_T = T.VGGTConfig(**dataclasses.asdict(_TINY))


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
    """A JAX VGGT holding `params` (JAX's eager init compiles op by op;
    the values only need to be the same on both sides)."""
    jm = J.VGGT.__new__(J.VGGT)
    jm.cfg, jm.params = _TINY, params
    jm.load_report, jm.load_ok = None, False
    jm._agg_jit = jax.jit(lambda p, x: J.vggt_aggregator(p, _TINY, x))
    return jm


def tiny_tree(seed, cam_fc2=True):
    """The port's tiny init, its camera head's last layer random when
    `cam_fc2`."""
    params = T.vggt_init(torch.Generator().manual_seed(seed), TINY_T, "cpu")
    if cam_fc2:
        g = torch.Generator().manual_seed(seed + 100)
        params["cam_fc2"] = {
            "weight": torch.randn((9, TINY_T.agg_dim), generator=g) * 0.05,
            "bias": torch.randn((9,), generator=g) * 0.05}
    return params


@pytest.fixture(scope="module")
def models():
    jp = jax_tree(tiny_tree(0))
    tm = T.VGGT(TINY_T, device="cpu")
    tm.params = port_tree(jp)
    return jax_model(jp), tm


def _imgs(t=3, h=28, w=42, seed=0):
    return np.random.RandomState(seed).rand(t, 3, h, w).astype(np.float32)


def test_aggregator_and_heads_match_jax(models):
    """The reference's three-call chain (`demo.py:310-321`) on both sides:
    every layer of the tokens list, every camera-head iteration, and the
    depth head's depth and confidence."""
    from flexam_tpu_torch.perception.poses import pose_encoding_to_extri_intri
    jm, tm = models
    imgs = _imgs(3)[None]
    jt, jps = jm.aggregator(imgs)
    tt, tps = tm.aggregator(imgs)
    assert tps == jps == _TINY.n_special and len(tt) == _TINY.agg_depth
    assert tt[-1].shape == (1, 3, 5 + 2 * 3, _TINY.agg_dim)
    for i, (a, b) in enumerate(zip(tt, jt)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL,
                                   err_msg=f"tokens {i}")
    jenc, tenc = jm.camera_head(jt), tm.camera_head(tt)
    assert len(tenc) == _TINY.cam_iters
    for a, b in zip(tenc, jenc):
        np.testing.assert_allclose(a, b, **TOL)
    assert np.abs(tenc[-1][..., :3]).max() > 1e-3      # not the identity
    extr, intr = pose_encoding_to_extri_intri(tenc[-1], (28, 42))
    R = extr[:, :, :3]
    np.testing.assert_allclose(R @ R.transpose(0, 2, 1),
                               np.stack([np.eye(3)] * 3), atol=1e-5)
    jd, jc = jm.depth_head(jt, imgs, jps)
    td, tc = tm.depth_head(tt, imgs, tps)
    assert td.shape == (1, 3, 28, 42, 1) and tc.shape == (1, 3, 28, 42)
    np.testing.assert_allclose(td, jd, **TOL)
    np.testing.assert_allclose(tc, jc, **TOL)


def test_identity_initialized_poses():
    """A random VGGT (zero last layer, identity quat seed, fov 0.9) emits
    exactly the identity rotation and zero translation."""
    from flexam_tpu_torch.perception.poses import quat_to_rotmat
    m = T.VGGT(TINY_T, seed=4, device="cpu")
    enc = m.camera_head(m.aggregator(_imgs(2)[None])[0])[-1]
    np.testing.assert_array_equal(enc[..., :3], 0.0)
    np.testing.assert_array_equal(enc[..., 3:7], [[[1, 0, 0, 0]] * 2])
    np.testing.assert_allclose(enc[..., 7:], 0.9, rtol=1e-7)
    np.testing.assert_allclose(quat_to_rotmat(enc[0, :, 3:7]),
                               np.stack([np.eye(3)] * 2), atol=1e-6)


def test_first_frame_is_special(models):
    """Distinct first-frame tokens pin the reference view: swapping two
    views does not just permute the outputs (the opposite of Pi3)."""
    _, tm = models
    imgs = _imgs(2, seed=3)
    a = tm.aggregator(imgs[None])[0][-1][0, :, 0].numpy()
    b = tm.aggregator(imgs[::-1].copy()[None])[0][-1][0, :, 0].numpy()
    assert not np.allclose(b, a[::-1], atol=1e-4)


def test_video_poses_match_jax(models):
    """`vggt_video_poses` on a 30x40 clip: the width-518 bicubic resize
    (392x518), the aggregator, the camera head, the extrinsics and
    intrinsics, against JAX's chain through `cv2.resize`."""
    jm, tm = models
    video = np.random.RandomState(7).rand(3, 30, 40, 3).astype(np.float32)
    je, ji = J.vggt_video_poses(video, model=jm)
    te, ti = T.vggt_video_poses(video.transpose(0, 3, 1, 2), model=tm)
    assert te.shape == (3, 3, 4) and ti.shape == (3, 3, 3)
    np.testing.assert_allclose(te, je, **TOL)
    np.testing.assert_allclose(ti, ji, rtol=2e-4, atol=1e-3)
    np.testing.assert_allclose(ti[:, :2, 2], [[259.0, 196.0]] * 3)


@pytest.mark.parametrize("hw,size", [((512, 896), (294, 518)),
                                     ((30, 40), (392, 518)),
                                     ((28, 42), (28, 42))])
def test_cubic_resize_matches_opencv(hw, size):
    """OpenCV's INTER_CUBIC of float frames: its float64 weights stored as
    float32 and a four-tap sum a pass; OpenCV's vectorized passes round
    their sums otherwise, so values in [0, 1] agree within 1e-6 (a few
    float32 ulps), and exactly where nothing is resized."""
    import cv2
    from flexam_tpu_torch.utils.media import resize_frames_cubic
    f = np.random.RandomState(1).rand(2, *hw, 3).astype(np.float32)
    want = np.stack([cv2.resize(x, size[::-1], interpolation=cv2.INTER_CUBIC)
                     for x in f])
    got = resize_frames_cubic(f, size)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if hw == size:
        np.testing.assert_array_equal(got, f)


def test_state_dict_maps_to_the_same_leaves_as_jax(models):
    """The greedy shape mapper over VGGT's lists (agg_frame, agg_global,
    cam_trunk, depth_proj beside depth_conv1/2) and its 4-dim special
    tokens, which are not conv kernels."""
    jm, tm = models
    assert_maps_like_jax(jm.params, tm.params,
                         distinct_state_dict(jm.params, 11))


@pytest.mark.parametrize("fmt", ["safetensors", "pt", "dir"])
def test_load_vggt_matches_jax(models, tmp_path, monkeypatch, fmt):
    """A file in the loaders' order loads fully in both packages (a
    directory resolves to model.safetensors before model.pt, where a decoy
    of other values lies), through `from_pretrained` on FLEXAM_VGGT_CKPT
    too, with the same weights and poses."""
    jm, tm = models
    if fmt == "dir":
        write_checkpoint(tm.params, tmp_path / "model.safetensors",
                         "safetensors")
        write_checkpoint(tiny_tree(8), tmp_path / "model.pt", "pt")
        path = str(tmp_path)
    else:
        path = write_checkpoint(tm.params, tmp_path / f"vggt.{fmt}", fmt)
    jl = J.load_vggt(path, jax_model(jax_tree(tiny_tree(5))))
    tl = T.load_vggt(path, cfg=TINY_T, device="cpu")
    assert jl.load_ok and tl.load_ok
    assert tl.load_report == jl.load_report
    assert_same_params(tl.params, jl.params)
    monkeypatch.setenv("FLEXAM_VGGT_CKPT", path)
    monkeypatch.chdir(tmp_path)
    fp = T.VGGT.from_pretrained(cfg=TINY_T, device="cpu")
    assert fp.load_ok
    imgs = _imgs(2, seed=9)[None]
    np.testing.assert_allclose(
        fp.camera_head(fp.aggregator(imgs)[0])[-1],
        jm.camera_head(jm.aggregator(imgs)[0])[-1], **TOL)


def test_loader_coverage_gating(tmp_path, monkeypatch, capsys):
    """A junk checkpoint is flagged, not served as trained; a missing
    file raises before any model is built; without a checkpoint
    `from_pretrained` warns and builds a random model, and never looks
    past the local path and FLEXAM_VGGT_CKPT."""
    path = str(tmp_path / "vggt.pt")
    torch.save({"junk.weight": torch.zeros(4, 4)}, path)
    m = T.load_vggt(path, cfg=TINY_T, device="cpu")
    assert m.load_ok is False and m.load_report["unused"] == ["junk.weight"]
    with pytest.raises(FileNotFoundError):
        T.load_vggt(str(tmp_path / "missing.pt"), cfg=TINY_T, device="cpu")
    monkeypatch.delenv("FLEXAM_VGGT_CKPT", raising=False)
    monkeypatch.chdir(tmp_path)
    r = T.VGGT.from_pretrained(cfg=TINY_T, device="cpu")
    assert r.load_ok is False and "no VGGT weights" in capsys.readouterr().out


def test_verify_ckpt_vggt_matches_jax(models, tmp_path, monkeypatch):
    from flexam_tpu.tools import verify_ckpt as jvc
    from flexam_tpu_torch.tools import verify_ckpt as tvc
    jm, tm = models
    fresh = [jax_model(jm.params) for _ in range(2)]
    monkeypatch.setattr(J, "VGGT", lambda cfg=None: fresh.pop())
    monkeypatch.setattr(T, "VGGTConfig", lambda: TINY_T)
    good = write_checkpoint(tm.params, tmp_path / "vggt.safetensors",
                            "safetensors")
    junk = str(tmp_path / "junk.pt")
    torch.save({"junk.weight": torch.zeros(4, 4)}, junk)
    for path, ok in ((good, True), (junk, False)):
        assert tvc.verify("vggt", path, "cpu") is ok
        assert jvc.verify("vggt", path) is ok
    assert tvc.verify("vggt", str(tmp_path / "missing"), "cpu") is False
    assert tvc.main(["--model", "vggt", "--platform", "cpu", good]) == 0


DEMO_T, DEMO_H, DEMO_W = 5, 32, 32


def demo_inputs(d):
    """A clip (an .npz frame dump) and a tracks file without poses, at the
    demo tests' size, and the demo's arguments for them."""
    rng = np.random.RandomState(21)
    frames = (rng.rand(DEMO_T, DEMO_H, DEMO_W, 3) * 255).astype(np.uint8)
    np.savez(d / "clip.npz", video=frames, fps=8)
    n = 30
    base = np.stack([rng.uniform(2, DEMO_W - 2, n),
                     rng.uniform(2, DEMO_H - 2, n),
                     rng.uniform(1.0, 3.0, n)], axis=1)
    drift = rng.uniform(-0.5, 0.5, (DEMO_T, 1, 3)).cumsum(0)
    np.savez(d / "tracks.npz", tracks=(base[None] + drift).astype(np.float32),
             visibility=np.ones((DEMO_T, n), bool))
    return ["--prompt", "a test scene", "--platform", "cpu",
            "--random_init", "tiny", "--sample_size", str(DEMO_H),
            str(DEMO_W), "--video_length", str(DEMO_T),
            "--num_inference_steps", "1", "--seed", "3",
            "--input_path", str(d / "clip.npz"),
            "--tracks_npz", str(d / "tracks.npz")]


def spy(monkeypatch, module, name, log):
    """Record the arguments and results of `module.name`."""
    orig = getattr(module, name)

    def wrapped(*a, **k):
        out = orig(*a, **k)
        log.append((a, k, out))
        return out
    monkeypatch.setattr(module, name, wrapped)


def test_demo_camera_control_takes_vggt_poses(models, tmp_path, monkeypatch,
                                              capsys):
    """`demo.main` on a clip with a tracks file without poses,
    --camera_motion "rot y 10" and FLEXAM_VGGT_CKPT: the poses come from
    VGGT (JAX's NOTE line, no track solver), equal to JAX's
    `vggt_video_poses` on the same frames and checkpoint; a checkpoint that
    does not map falls to the track solver, as JAX's `load_ok` gate does."""
    from flexam_tpu_torch import demo
    from flexam_tpu_torch.perception import pose_solver
    jm, tm = models
    argv = demo_inputs(tmp_path) + ["--camera_motion", "rot y 10"]
    ckpt = write_checkpoint(tm.params, tmp_path / "vggt.safetensors",
                            "safetensors")
    monkeypatch.setattr(T, "VGGTConfig", lambda: TINY_T)
    monkeypatch.delenv("FLEXAM_PI3_CKPT", raising=False)
    monkeypatch.setenv("FLEXAM_VGGT_CKPT", ckpt)
    monkeypatch.chdir(tmp_path)
    poses, solved = [], []
    spy(monkeypatch, T, "vggt_video_poses", poses)
    spy(monkeypatch, pose_solver, "solve_camera_poses", solved)
    out = demo.main(argv + ["--output_dir", str(tmp_path / "out")])
    assert out.shape == (1, 3, DEMO_T, DEMO_H, DEMO_W)
    assert "camera poses from the native VGGT model" in capsys.readouterr(
        ).out
    assert len(poses) == 1 and not solved
    (frames,), _, (extr, intr) = poses[0]
    assert frames.shape == (DEMO_T, 3, DEMO_H, DEMO_W)
    je, ji = J.vggt_video_poses(frames, model=J.load_vggt(
        ckpt, jax_model(jax_tree(tiny_tree(5)))))
    np.testing.assert_allclose(extr, je, **TOL)
    np.testing.assert_allclose(intr, ji, rtol=2e-4, atol=1e-3)
    junk = str(tmp_path / "junk.pt")
    torch.save({"junk.weight": torch.zeros(4, 4)}, junk)
    monkeypatch.setenv("FLEXAM_VGGT_CKPT", junk)
    demo.main(argv + ["--output_dir", str(tmp_path / "junk")])
    assert len(poses) == 1 and len(solved) == 1
