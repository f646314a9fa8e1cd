"""The port's node pack (`flexam_tpu_torch/nodes.py`) against the JAX
package's (`flexam_tpu/nodes.py`), on the CPU, mirroring
`tests/test_nodes.py`: each node runs in both packages on the same inputs.

  * the mappings: keys, display names, INPUT_TYPES, RETURN_TYPES /
    RETURN_NAMES / FUNCTION / CATEGORY, and the ComfyUI call protocol;
  * the resolution snap, the visualizers (bit for bit), ImageMaximumNode
    after a resize (1e-6), ImageCollectNode, the camera preset nodes,
    the KJNodes trajectory (within 1/255, and equal: the uint8
    INTER_LINEAR resize is OpenCV's fixed point), VideoToCanny (equal),
    LoadConfig on
    each bundled YAML (and the bundled bytes equal to JAX's);
  * the annotators: the registry and fixture paths, VideoToPose's pose
    branch, its keypoint branch and its DWPose branch (the tiny ONNX
    graphs of `flexam_tpu_torch/testing.py`, `cv2.dnn` in JAX),
    VideoToDepth through UniDepth, Depth-Anything-V2 and ZoeDepth on tiny
    random trees, and VideoToTrackingPredict without DELTA against JAX's
    node (OpenCV's Farneback);
  * the sampler: the arguments each package's node passes to `generate`
    (captured; arrays within 1e-6) for motion_transfer, fg and bg masks,
    start / end images, RIFLEx, camera conditions and the refusal without
    the adapter; one end-to-end run with JAX's noise (as
    tests/test_torch_pipeline.py), the decoded video within one uint8
    level; the LoRA merge, host cache and unmerge against JAX's node; and
    the loader's config, qfloat8 and model_2.
"""

import dataclasses
import filecmp
import inspect
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexam_tpu.nodes as J
import flexam_tpu_torch.nodes as N
from flexam_tpu import pipeline as jpipe
from flexam_tpu.config import tiny_test_config as jax_tiny
from flexam_tpu_torch import pipeline as tpipe
from flexam_tpu_torch.config import tiny_test_config
from flexam_tpu_torch.io.convert import from_jax_params
from tests.test_torch_depth_anything import registry_env, trees  # noqa: F401
from tests.test_torch_unidepth import models  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the surface
# ---------------------------------------------------------------------------


def test_mappings_match_jax():
    assert list(N.NODE_CLASS_MAPPINGS) == list(J.NODE_CLASS_MAPPINGS)
    assert N.NODE_DISPLAY_NAME_MAPPINGS == J.NODE_DISPLAY_NAME_MAPPINGS
    for name, jcls in J.NODE_CLASS_MAPPINGS.items():
        tcls = N.NODE_CLASS_MAPPINGS[name]
        assert tcls.__name__ == jcls.__name__, name
        assert tcls.INPUT_TYPES() == jcls.INPUT_TYPES(), name
        for attr in ("RETURN_TYPES", "RETURN_NAMES", "FUNCTION",
                     "CATEGORY"):
            assert getattr(tcls, attr, None) == getattr(jcls, attr, None), \
                (name, attr)
    assert N.NODE_CLASS_MAPPINGS["LoadWan2_2FunModel_FlexAM"] is \
        N.LoadFlexAMModel


def test_every_node_satisfies_comfyui_protocol():
    """ComfyUI calls FUNCTION with every declared input as a keyword."""
    for name, cls in N.NODE_CLASS_MAPPINGS.items():
        fn = getattr(cls, cls.FUNCTION)
        params = inspect.signature(fn).parameters
        spec = cls.INPUT_TYPES()
        for section in ("required", "optional"):
            for inp in spec.get(section, {}):
                assert inp in params, (name, inp)
        if hasattr(cls, "RETURN_NAMES"):
            assert len(cls.RETURN_NAMES) == len(cls.RETURN_TYPES), name


def test_workflow_jsons_are_jax_copies_of_known_nodes():
    ours = os.path.join(ROOT, "flexam_tpu_torch", "workflows")
    theirs = os.path.join(ROOT, "flexam_tpu", "workflows")
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs))
    builtin = {"VHS_LoadVideo", "VHS_VideoCombine", "LoadImage", "Note",
               "PrimitiveNode"}
    for f in os.listdir(ours):
        assert filecmp.cmp(os.path.join(ours, f), os.path.join(theirs, f),
                           shallow=False), f
        wf = json.load(open(os.path.join(ours, f)))
        for n in wf["nodes"]:
            assert (n["type"] in N.NODE_CLASS_MAPPINGS
                    or n["type"] in builtin), (f, n["type"])
        ids = {n["id"] for n in wf["nodes"]}
        for link in wf["links"]:
            assert link[1] in ids and link[3] in ids


def test_load_config_reads_each_bundled_yaml_as_jax(tmp_path, monkeypatch):
    ours = os.path.join(ROOT, "flexam_tpu_torch", "configs")
    theirs = os.path.join(ROOT, "flexam_tpu", "configs")
    monkeypatch.delenv("FLEXAM_CONFIG_DIR", raising=False)
    names = []
    for sub in sorted(os.listdir(theirs)):
        for f in sorted(os.listdir(os.path.join(theirs, sub))):
            names.append(f"{sub}/{f}")
            assert filecmp.cmp(os.path.join(ours, sub, f),
                               os.path.join(theirs, sub, f), shallow=False)
    assert len(names) == 4
    for name in names:
        got, = N.LoadConfig().process(name)
        want, = J.LoadConfig().process(name)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
    cfg, = N.LoadConfig().process("wan2.2/wan_civitai_5b_FlexAM.yaml")
    assert cfg.dit.add_ref_conv and cfg.vae.latent_channels == 48
    # the explicit dir, then FLEXAM_CONFIG_DIR, then the bundled files
    (tmp_path / "a" / "wan2.2").mkdir(parents=True)
    (tmp_path / "b" / "wan2.2").mkdir(parents=True)
    src = os.path.join(theirs, "wan2.2")
    for d, f in (("a", "wan_civitai_5b.yaml"),
                 ("b", "wan_civitai_5b_FlexAM.yaml")):
        (tmp_path / d / "wan2.2" / "x.yaml").write_bytes(
            open(os.path.join(src, f), "rb").read())
    monkeypatch.setenv("FLEXAM_CONFIG_DIR", str(tmp_path / "b"))
    for cd in (None, str(tmp_path / "a")):
        got, = N.LoadConfig().process("wan2.2/x.yaml", config_dir=cd)
        want, = J.LoadConfig().process("wan2.2/x.yaml", config_dir=cd)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    with pytest.raises(FileNotFoundError):
        N.LoadConfig().process("wan2.2/wan_civitai_t2v.yaml")


def test_resolution_snap_matches_jax():
    t, j = N.FlexAMV2VSampler(), J.FlexAMV2VSampler()
    assert t.snap_resolution(512, 896) == (384, 672)
    assert t.snap_resolution(512, 896, 640) == (480, 832)
    for h, w in ((512, 896), (512, 512), (480, 832), (720, 1280),
                 (1024, 256), (33, 77)):
        for base in (32, 512, 640, 768, 1024):
            assert t.snap_resolution(h, w, base) == \
                j.snap_resolution(h, w, base)


def test_attention_and_compile_nodes(monkeypatch):
    from flexam_tpu_torch.core.attention import _default_backend
    prev = os.environ.get("FLEXAM_ATTENTION")
    try:
        for name, want in (("torch", "xla"), ("sage", "pallas_int8"),
                           ("flash", "pallas")):
            sentinel = object()
            assert N.FunAttention().process(name, sentinel)[0] is sentinel
            assert os.environ["FLEXAM_ATTENTION"] == want
            assert _default_backend() == want
        N.FunAttention().process("sparse")
        assert os.environ["FLEXAM_ATTENTION"] == "sparse"
    finally:
        if prev is None:
            os.environ.pop("FLEXAM_ATTENTION", None)
        else:
            os.environ["FLEXAM_ATTENTION"] = prev
        from flexam_tpu_torch.core.attention import _backend_choice
        _backend_choice.cache_clear()

    def no_compile(*a, **k):
        raise AssertionError("FunCompile must not call torch.compile")

    monkeypatch.setattr(torch, "compile", no_compile)
    models = object()
    assert N.FunCompile().compile(64, models)[0] is models
    assert N.FunTextBox().process("p") == J.FunTextBox().process("p")
    assert N.FunRiflex().process(4) == J.FunRiflex().process(4)


def test_camera_nodes_match_jax():
    for cls in (N.CameraBasicFromChaoJie, J.CameraBasicFromChaoJie):
        assert cls.INPUT_TYPES()["required"]["camera_pose"][0]
    rt, = N.CameraBasicFromChaoJie().run("Zoom In", 1.3, 12)
    np.testing.assert_allclose(
        rt, J.CameraBasicFromChaoJie().run("Zoom In", 1.3, 12)[0],
        rtol=1e-6, atol=1e-7)
    rt2, = N.CameraCombineFromChaoJie().run("Pan Up", "Pan Left")
    np.testing.assert_allclose(
        rt2, J.CameraCombineFromChaoJie().run("Pan Up", "Pan Left")[0],
        rtol=1e-6, atol=1e-7)
    joined, = N.CameraJoinFromChaoJie().run(rt, rt2)
    np.testing.assert_allclose(
        joined, J.CameraJoinFromChaoJie().run(rt, rt2)[0], rtol=1e-6,
        atol=1e-7)
    s, n = N.CameraTrajectoryFromChaoJie().run(joined)
    js, jn = J.CameraTrajectoryFromChaoJie().run(joined)
    assert n == jn == 28
    np.testing.assert_allclose(np.array(json.loads(s)),
                               np.array(json.loads(js)), rtol=1e-6)


# ---------------------------------------------------------------------------
# visualizers, image nodes, OpenCV nodes
# ---------------------------------------------------------------------------


def _tracks(seed=1, t=5, n=20):
    rs = np.random.RandomState(seed)
    tracks = np.stack([rs.uniform(0, 64, (t, n)), rs.uniform(0, 48, (t, n)),
                       rs.uniform(0.5, 3, (t, n))], -1).astype(np.float32)
    vis = rs.rand(t, n) > 0.2
    return tracks, vis


@pytest.mark.parametrize("kind", ["all", "tracking", "cos", "depth"])
def test_visualizers_equal_jax(kind):
    tracks, vis = _tracks()
    video = np.zeros((1, 3, 5, 48, 64), np.float32)
    mask = np.zeros((5, 48, 64), np.float32)         # the rasterizer's
    mask[:, 10:30, 20:50] = 1.0
    cls = {"all": "VideoToTrackingVisualizeAll",
           "tracking": "VideoToTrackingVisualize",
           "cos": "VideoToCosVisualize",
           "depth": "VideoTodepthVisualize"}[kind]
    for kw in (dict(height=48, width=64), dict(input_video=video),
               dict(height=48, width=64, mask_video=mask,
                    generate_type="fg_generation" if kind == "all"
                    else "foreground_edit")):
        got = getattr(N, cls)().process(tracks, vis, **kw)
        want = getattr(J, cls)().process(tracks, vis, **kw)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_image_nodes_match_jax():
    rs = np.random.RandomState(0)
    a = rs.rand(4, 32, 40, 3).astype(np.float32)
    for b in (rs.rand(4, 16, 16, 3).astype(np.float32),     # grows
              rs.rand(3, 64, 96, 3).astype(np.float32),     # shrinks
              rs.rand(5, 32, 40, 3).astype(np.float32)):    # same size
        got, = N.ImageMaximumNode().imagemaximum(a, b)
        want, = J.ImageMaximumNode().imagemaximum(a, b)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    c, = N.ImageCollectNode().imagecollect(a, b)
    jc, = J.ImageCollectNode().imagecollect(a, b)
    assert len(c) == len(jc) == 9
    for x, y in zip(c, jc):
        np.testing.assert_array_equal(x, y)


def test_kjnodes_trajectory_within_a_level_of_jax():
    masks = np.zeros((2, 96, 160), np.float32)
    for coords in (str([{"x": 10, "y": 12}, {"x": 80, "y": 50}]),
                   [str([{"x": 30, "y": 40}, {"x": 150, "y": 90}]),
                    str([{"x": 5, "y": 90}, {"x": 100, "y": 2}])]):
        got, = N.CreateTrajectoryBasedOnKJNodes().createtrajectory(coords,
                                                                   masks)
        want, = J.CreateTrajectoryBasedOnKJNodes().createtrajectory(coords,
                                                                    masks)
        assert got.shape == want.shape == (2, 96, 160, 3)
        np.testing.assert_allclose(got, want, rtol=0, atol=1.0 / 255 + 1e-7)
        assert got.max() > 0.5
    np.testing.assert_array_equal(N.CreateTrajectoryBasedOnKJNodes._heatmap(),
                                  J.CreateTrajectoryBasedOnKJNodes._heatmap())


def test_kjnodes_trajectory_equals_jax():
    """The trajectory's heatmap resize is OpenCV's INTER_LINEAR fixed point
    (`utils.cv.resize_u8_linear`), so the node equals JAX's exactly."""
    masks = np.zeros((2, 96, 160), np.float32)
    for coords in (str([{"x": 10, "y": 12}, {"x": 80, "y": 50}]),
                   [str([{"x": 30, "y": 40}, {"x": 150, "y": 90}]),
                    str([{"x": 5, "y": 90}, {"x": 100, "y": 2}])]):
        got, = N.CreateTrajectoryBasedOnKJNodes().createtrajectory(coords,
                                                                   masks)
        want, = J.CreateTrajectoryBasedOnKJNodes().createtrajectory(coords,
                                                                    masks)
        np.testing.assert_array_equal(got, want)


def test_canny_node_equals_jax():
    from tests.test_torch_cv import _textured
    rs = np.random.RandomState(0)
    tex = np.stack([_textured(48, 64, s) for s in range(4)])
    v = np.stack([tex, np.roll(tex, 7, -1), tex[::-1]], 1) / 255.0
    v = (v + 0.02 * rs.rand(*v.shape)).astype(np.float32)   # [T, 3, H, W]
    for video, kw in ((v.transpose(1, 0, 2, 3)[None], {}),
                      (v.transpose(0, 2, 3, 1), dict(low_threshold=40,
                                                     high_threshold=90)),
                      (v.transpose(0, 2, 3, 1), dict(video_length=2,
                                                     low_threshold=120,
                                                     high_threshold=60))):
        got, = N.VideoToCanny().process(video, **kw)
        want, = J.VideoToCanny().process(video, **kw)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        assert got.any()


# ---------------------------------------------------------------------------
# annotators
# ---------------------------------------------------------------------------


def test_annotator_registry_and_fixtures(tmp_path, monkeypatch):
    rs = np.random.RandomState(0)
    video = rs.rand(1, 3, 3, 16, 16).astype(np.float32)
    with pytest.raises(RuntimeError, match="external model"):
        N.VideoToPose().process(video, video_length=3)
    fx = str(tmp_path / "tracks.npz")
    np.savez(fx, tracks=rs.rand(3, 7, 3).astype(np.float32),
             visibility=np.ones((3, 7), bool))
    got = N.VideoToTrackingPredict().process(video, fixture=fx)
    want = J.VideoToTrackingPredict().process(video, fixture=fx)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[1].dtype == bool
    pose = str(tmp_path / "pose.npz")
    np.savez(pose, pose=rs.rand(3, 16, 16, 3).astype(np.float32))
    np.testing.assert_array_equal(
        N.VideoToPose().process(video, 3, fixture=pose)[0],
        J.VideoToPose().process(video, 3, fixture=pose)[0])
    depth = str(tmp_path / "depth.npz")
    np.savez(depth, depth=rs.rand(3, 16, 16).astype(np.float32) + 0.5)
    np.testing.assert_array_equal(
        N.VideoToDepth().process(video, 3, fixture=depth)[0],
        J.VideoToDepth().process(video, 3, fixture=depth)[0])
    try:
        for reg, mod in ((N.register_annotator_backend, N),
                         (J.register_annotator_backend, J)):
            reg("depth", lambda v, **kw: {"depth": np.repeat(
                v.mean(-1, keepdims=True), 3, -1)})
            reg("tracking", lambda v, density=10, **kw: {
                "tracks": np.ones((v.shape[0], 4, 3)) * density,
                "visibility": np.ones((v.shape[0], 4))})
        for node in ("VideoToDepth", "VideoToTrackingPredict"):
            got = getattr(N, node)().process(video, video_length=3)
            want = getattr(J, node)().process(video, video_length=3)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
    finally:
        for mod in (N, J):
            mod.ANNOTATOR_BACKENDS.pop("depth", None)
            mod.ANNOTATOR_BACKENDS.pop("tracking", None)


def test_pose_model_branches_raise(tmp_path, monkeypatch):
    """VideoToPose raises where JAX's node does: with no backend, fixture
    or DWPose files it needs an external model (RuntimeError in both), and
    with FLEXAM_DWPOSE_DET / FLEXAM_DWPOSE_POSE naming a file that is no
    ONNX model the reader refuses it (ValueError; JAX: cv2.error)."""
    import cv2
    rs = np.random.RandomState(1)
    video = rs.rand(3, 16, 16, 3).astype(np.float32)
    kp = str(tmp_path / "kp.npz")
    np.savez(kp, keypoints=rs.rand(3, 1, 133, 2), scores=rs.rand(3, 1, 133))
    monkeypatch.delenv("FLEXAM_DWPOSE_DET", raising=False)
    monkeypatch.delenv("FLEXAM_DWPOSE_POSE", raising=False)
    for node in (N.VideoToPose(), J.VideoToPose()):
        with pytest.raises(RuntimeError, match="needs an external model"):
            node.process(video, 3)
    monkeypatch.setenv("FLEXAM_DWPOSE_DET", kp)
    monkeypatch.setenv("FLEXAM_DWPOSE_POSE", kp)
    with pytest.raises(ValueError, match="onnx: wire type"):
        N.VideoToPose().process(video, 3, device="cpu")
    with pytest.raises(cv2.error):
        J.VideoToPose().process(video, 3)


def test_pose_model_branches_match_jax(tmp_path, monkeypatch):
    """Both model branches of VideoToPose equal JAX's node pixel for
    pixel: raw keypoints from a fixture (drawn by `pose_render`), and the
    native DWPose through FLEXAM_DWPOSE_DET / FLEXAM_DWPOSE_POSE on the tiny
    YOLOX and RTMPose graphs (the port's ONNX runner on the CPU, `cv2.dnn`
    in JAX)."""
    from flexam_tpu_torch.testing import write_tiny_dwpose
    rs = np.random.RandomState(1)
    video = rs.rand(3, 16, 16, 3).astype(np.float32)
    kp = str(tmp_path / "kp.npz")
    np.savez(kp, keypoints=rs.rand(3, 1, 133, 2), scores=rs.rand(3, 1, 133))
    got, = N.VideoToPose().process(video, 3, fixture=kp)
    want, = J.VideoToPose().process(video, 3, fixture=kp)
    assert got.shape == (1, 3, 3, 16, 16) and got.max() > 0
    np.testing.assert_array_equal(got, want)
    det, pose = write_tiny_dwpose(str(tmp_path))
    monkeypatch.setenv("FLEXAM_DWPOSE_DET", det)
    monkeypatch.setenv("FLEXAM_DWPOSE_POSE", pose)
    got, = N.VideoToPose().process(video, 3, device="cpu")
    want, = J.VideoToPose().process(video, 3)
    assert got.shape == (1, 3, 3, 16, 16) and got.max() > 0
    np.testing.assert_array_equal(got, want)


def _depth_envs(monkeypatch):
    for k in ("FLEXAM_DEPTH_BACKEND", "FLEXAM_UNIDEPTH_CKPT",
              "FLEXAM_DAV2_CKPT", "FLEXAM_ZOE_CKPT"):
        monkeypatch.delenv(k, raising=False)


def _depth_video():
    rs = np.random.RandomState(9)
    return rs.rand(1, 3, 3, 28, 40).astype(np.float32)


def _same_visualization(got, want, atol):
    assert got.shape == want.shape == (1, 3, 3, 28, 40)
    assert got.min() >= 0 and got.max() <= 1
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("backend", ["dav2", "zoe"])
def test_video_to_depth_through_dav2_and_zoe(registry_env, monkeypatch,
                                             backend):
    """fp32 in both: the depth agrees to ~1e-6 of its size, and the node's
    2-85 percentile normalization divides by a span of the same order as
    the depth, so the 0..1 video is held at 1e-4."""
    dav, zoe = registry_env
    _depth_envs(monkeypatch)
    monkeypatch.setenv("FLEXAM_ZOE_CKPT", zoe)
    if backend == "dav2":
        monkeypatch.setenv("FLEXAM_DAV2_CKPT", dav)
    from flexam_tpu_torch.perception import depth as tdepth
    picked = []
    fn = tdepth.DEPTH_BACKENDS[backend]
    monkeypatch.setitem(tdepth.DEPTH_BACKENDS, backend, lambda v, **kw: (
        picked.append(kw), fn(v, **kw))[1])
    video = _depth_video()
    got, = N.VideoToDepth().process(video, 3, device="cpu")
    want, = J.VideoToDepth().process(video, 3)
    assert picked == [{"device": "cpu"}]
    _same_visualization(got, want, 1e-4)


def test_video_to_depth_through_unidepth(models, monkeypatch, tmp_path):
    """UniDepth's video path rounds its depth to float16 in both packages
    (test_torch_unidepth), so the two depths may sit one float16 step
    (2^-11 of the value) apart; over the normalization span that is held
    at 2e-3 of the 0..1 video."""
    from flexam_tpu.perception import unidepth as JU
    from flexam_tpu_torch.perception import unidepth as TU
    jm, tm = models
    ckpt = tmp_path / "unidepth.safetensors"
    ckpt.write_bytes(b"cached")
    _depth_envs(monkeypatch)
    monkeypatch.setenv("FLEXAM_UNIDEPTH_CKPT", str(ckpt))
    monkeypatch.setitem(JU._BACKEND_CACHE, str(ckpt), jm)
    monkeypatch.setitem(TU._BACKEND_CACHE, (str(ckpt), "cpu"), tm)
    video = _depth_video()
    got, = N.VideoToDepth().process(video, 3, device="cpu")
    want, = J.VideoToDepth().process(video, 3)
    _same_visualization(got, want, 2e-3)


def _no_delta_env(monkeypatch, tmp_path):
    for k in ("FLEXAM_DELTA_CKPT", "FLEXAM_DEPTH_BACKEND",
              "FLEXAM_UNIDEPTH_CKPT", "FLEXAM_DAV2_CKPT", "FLEXAM_ZOE_CKPT"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.chdir(tmp_path)                # no ./checkpoints here


def test_tracking_predict_without_delta_is_the_device_flow_tracker(
        monkeypatch, tmp_path):
    """No DELTA file: the node runs the flow tracker (`track_video_flow`)
    once, on the node's device, at the node's density, and returns its
    tracks and visibility."""
    import flexam_tpu_torch.perception as perception
    from tests.test_torch_flow_device import _translating
    _no_delta_env(monkeypatch, tmp_path)
    calls = []
    orig = perception.track_video_flow

    def spy(video, **kw):
        calls.append(kw)
        return orig(video, **kw)

    monkeypatch.setattr(perception, "track_video_flow", spy)
    video = _translating(48, 64, 6, 2, seed=7)
    tracks, vis = N.VideoToTrackingPredict().process(
        video.transpose(3, 0, 1, 2)[None], density=8, device="cpu")
    assert len(calls) == 1
    assert calls[0]["device"] == "cpu" and calls[0]["density"] == 8
    assert tracks.shape[0] == 6 and vis.shape == tracks.shape[:2]


def test_tracking_predict_without_delta_matches_jax(monkeypatch, tmp_path):
    """No DELTA file: the port's node runs JAX's baseline, the Farneback
    tracker (on the CPU here), held to JAX's node, which runs OpenCV's
    Farneback, on the clip of tests/test_torch_flow_device.py: 1e-3 px,
    visibility equal."""
    from tests.test_torch_flow_device import _translating
    _no_delta_env(monkeypatch, tmp_path)
    video = _translating(48, 64, 6, 2, seed=7)
    got_t, got_v = N.VideoToTrackingPredict().process(
        video.transpose(3, 0, 1, 2)[None], density=8, device="cpu")
    want_t, want_v = J.VideoToTrackingPredict().process(
        video.transpose(3, 0, 1, 2)[None], density=8)
    np.testing.assert_allclose(got_t, want_t, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(got_v, want_v)


# ---------------------------------------------------------------------------
# the loader and the sampler
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pipes():
    """A tiny JAX pipeline and the port's on the same weights: the port's
    init (JAX's eager init compiles op by op), stacked into JAX's layout,
    and crossed back by from_jax_params."""
    from flexam_tpu_torch.io.convert import stack_blocks
    from flexam_tpu_torch.models.dit import init_dit_params
    from flexam_tpu_torch.models.t5 import init_t5_params
    from flexam_tpu_torch.models.vae import init_vae_params
    from tests.test_torch_pipeline import _port_pipe
    cfg = tiny_test_config()
    kw = dict(dtype=torch.float32, device="cpu")
    params = [jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                     stack_blocks(tree)) for tree in (
        init_dit_params(cfg.dit, seed=0, **kw),
        init_vae_params(cfg.vae, seed=1, **kw),
        init_t5_params(cfg.t5, seed=2, **kw))]
    jp = jpipe.FlexAMGenerationPipeline(
        jpipe.FlexAMModels(cfg=jax_tiny(), dit_params=params[0],
                           vae_params=params[1], t5_params=params[2]),
        compute_dtype=jnp.float32)
    return jp, _port_pipe(params)


def _capture(monkeypatch, pipe):
    calls = []

    def fake(**kw):
        calls.append(kw)
        return np.zeros((1, 3, 1, 8, 8), np.float32)

    monkeypatch.setattr(pipe, "generate", fake)
    for name in ("enable_riflex", "disable_riflex"):
        monkeypatch.setattr(pipe, name, lambda *a, _n=name, **k:
                            calls.append({_n: (a, k)}))
    return calls


def _same_calls(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            a, b = g[k], w[k]
            if isinstance(b, (list, tuple)) and b and isinstance(
                    b[0], np.ndarray):
                assert len(a) == len(b), k
                for x, y in zip(a, b):
                    np.testing.assert_allclose(x, y, rtol=0, atol=1e-6,
                                               err_msg=k)
            elif isinstance(b, np.ndarray) or hasattr(b, "shape"):
                assert a.shape == b.shape, k
                np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                           rtol=0, atol=1e-6, err_msg=k)
            else:
                assert a == b, (k, a, b)


def _clip(seed, t=9, h=40, w=72):
    rs = np.random.RandomState(seed)
    return rs, rs.rand(1, 3, t, h, w).astype(np.float32)


def _sampler_cases():
    rs, video = _clip(0)
    img = lambda: rs.rand(9, 40, 72, 3).astype(np.float32)   # noqa: E731
    mask = np.zeros((1, 1, 9, 40, 72), np.float32)
    mask[..., 8:30, 20:50] = 1.0
    # the mask pipelines take the demo's [F, C, H, W] (which the node's
    # IMAGE conversion leaves as it is)
    fmask = mask[0].transpose(1, 0, 2, 3)
    base = dict(prompt="a node graph video", video_length=9,
                base_resolution=64, steps=2, seed=7, density=10.0)
    start = rs.rand(40, 72, 3).astype(np.float32)
    end = rs.rand(2, 40, 72, 3).astype(np.float32)
    return {
        "motion_transfer": dict(
            base, original_video=video, control_video=img(),
            depth_video=img(), cos_video0=img(), cos_video1=img(),
            cos_video2=img(), cos_video3=img(), mask_video=mask,
            ref_image=rs.rand(1, 40, 72, 3).astype(np.float32),
            enable_teacache=True, teacache_threshold=0.2,
            num_skip_start_steps=1, cfg_skip_ratio=0.25,
            scheduler="Flow_Unipc", shift=3, boundary=0.8,
            negative_prompt="blurry", denoise_strength=0.5),
        "fg_generation": dict(base, original_video=video, mask_video=fmask,
                              generate_type="fg_generation",
                              dilation_pixels=5),
        "bg_generation": dict(base, original_video=video,
                              mask_video=1.0 - fmask,
                              generate_type="bg_generation"),
        "start_end_image": dict(base, start_image=start, end_image=end),
        "riflex": dict(base, original_video=video, riflex_k=4),
    }


@pytest.mark.parametrize("case", list(_sampler_cases()))
def test_sampler_passes_jax_arguments(pipes, monkeypatch, case):
    jp, tp = pipes
    kw = _sampler_cases()[case]
    want = _capture(monkeypatch, jp)
    got = _capture(monkeypatch, tp)
    J.FlexAMV2VSampler().process(funmodels=jp, **kw)
    N.FlexAMV2VSampler().process(funmodels=tp, **kw)
    _same_calls(got, want)
    if case == "riflex":
        assert want[0] == {"enable_riflex": ((), {"k": 4, "L_test": 3})}


def test_sampler_camera_conditions_as_jax(pipes, monkeypatch):
    """A Control-Camera config: the trajectory JSON becomes the camera
    video, zeros video and full mask, as JAX's; without the adapter both
    refuse."""
    jp, tp = pipes
    rt, = N.CameraBasicFromChaoJie().run("Pan Left", 1.0, 9)
    traj, _ = N.CameraTrajectoryFromChaoJie().run(rt)
    _, video = _clip(3)
    kw = dict(prompt="x", video_length=9, base_resolution=64, steps=1,
              original_video=video, camera_conditions=traj,
              control_video=video)
    for pipe in (jp, tp):
        with pytest.raises(ValueError, match="Control-Camera"):
            (J if pipe is jp else N).FlexAMV2VSampler().process(
                funmodels=pipe, **kw)
    for pipe in (jp, tp):
        monkeypatch.setattr(pipe, "cfg", dataclasses.replace(
            pipe.cfg, dit=dataclasses.replace(pipe.cfg.dit,
                                              add_control_adapter=True)))
    want = _capture(monkeypatch, jp)
    got = _capture(monkeypatch, tp)
    J.FlexAMV2VSampler().process(funmodels=jp, **kw)
    N.FlexAMV2VSampler().process(funmodels=tp, **kw)
    _same_calls(got, want)
    assert got[0]["camera_video"].shape[1] == 6
    assert got[0]["control_video"] is None


def test_sampler_end_to_end_matches_jax(pipes, monkeypatch):
    """One motion_transfer run through both nodes (2 CFG steps, a control
    video, a mask with frame 0 known): JAX's noise from PRNGKey(seed),
    handed to the port as `latents=`; the decoded videos within one uint8
    level (1/255), as tests/test_torch_pipeline.py holds generate."""
    jp, tp = pipes
    rs = np.random.RandomState(11)
    t, h, w = 5, 32, 32
    video = rs.rand(1, 3, t, h, w).astype(np.float32)
    mask = np.ones((1, 1, t, h, w), np.float32)
    mask[:, :, 0] = 0.0
    ctrl = rs.rand(t, h, w, 3).astype(np.float32)
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(5),
                                         (1, 8, 2, 2, 2), jnp.float32))
    gen = tp.generate
    monkeypatch.setattr(tp, "generate",
                        lambda **kw: gen(latents=noise, **kw))
    kw = dict(prompt="a cat", original_video=video, control_video=ctrl,
              mask_video=mask, video_length=t, base_resolution=32, steps=2,
              seed=5, density=10.0)
    want, = J.FlexAMV2VSampler().process(funmodels=jp, **kw)
    got, = N.FlexAMV2VSampler().process(funmodels=tp, **kw)
    assert got.shape == (1, 3, t, h, w) and np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                               atol=1.01 / 255)


def _q(tree, layer):
    w = tree["blocks"]["self_attn"]["q"]["weight"] if isinstance(
        tree["blocks"], dict) else tree["blocks"][layer]["self_attn"]["q"][
            "weight"]
    return np.asarray(w[layer] if isinstance(tree["blocks"], dict) else w)


def test_sampler_lora_merge_cache_and_unmerge_as_jax(pipes, monkeypatch,
                                                     tmp_path):
    from safetensors.numpy import save_file
    jp, tp = pipes
    dim = tp.cfg.dit.dim
    rs = np.random.RandomState(3)
    lora = {
        "lora_unet_blocks_1_self_attn_q.lora_down.weight":
            rs.randn(2, dim).astype(np.float32) * 0.02,
        "lora_unet_blocks_1_self_attn_q.lora_up.weight":
            rs.randn(dim, 2).astype(np.float32) * 0.02,
        "lora_unet_blocks_1_self_attn_q.alpha": np.array(2.0, np.float32)}
    path = str(tmp_path / "l.safetensors")
    save_file(lora, path)
    monkeypatch.setattr(J.FlexAMV2VSampler, "_lora_cache", {})
    monkeypatch.setattr(J.FlexAMV2VSampler, "_lora_before", {})
    monkeypatch.setattr(N.FlexAMV2VSampler, "_lora_cache", {})
    monkeypatch.setattr(N.FlexAMV2VSampler, "_lora_before", {})
    jparams, tparams = jp.models.dit_params, tp.models.dit_params
    _capture(monkeypatch, jp)
    _capture(monkeypatch, tp)
    pristine = _q(tparams, 1).copy()
    np.testing.assert_array_equal(pristine, _q(jparams, 1))
    _, video = _clip(4, 5, 32, 32)
    kw = dict(prompt="x", original_video=video, video_length=5,
              base_resolution=32, steps=1, loras=[path])
    js, ts = J.FlexAMV2VSampler(), N.FlexAMV2VSampler()
    try:
        for strength, cache in ((1.0, True), (0.5, True), (1.0, True),
                                (0.5, False)):
            js.process(funmodels=jp, strength_model=[strength],
                       lora_cache=cache, **kw)
            ts.process(funmodels=tp, strength_model=[strength],
                       lora_cache=cache, **kw)
            np.testing.assert_allclose(_q(tp.models.dit_params, 1),
                                       _q(jp.models.dit_params, 1),
                                       rtol=0, atol=1e-6)
            if cache:
                np.testing.assert_allclose(
                    _q(tp.models.dit_params, 1) - pristine,
                    strength * (lora["lora_unet_blocks_1_self_attn_q."
                                     "lora_up.weight"]
                                @ lora["lora_unet_blocks_1_self_attn_q."
                                       "lora_down.weight"]),
                    rtol=1e-4, atol=1e-7)
            else:    # merged for the run, unmerged after it
                np.testing.assert_allclose(_q(tp.models.dit_params, 1),
                                           pristine, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(_q(tp.models.dit_params, 0),
                                      _q(tparams, 0))
    finally:
        jp.set_dit_params(jparams)
        tp.set_dit_params(tparams)


def _leaf_dtypes(tree):
    return {jax.tree_util.keystr(p): str(getattr(v, "dtype", None))
            .replace("torch.", "")
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_loader_random_init_qfloat8_and_model_2():
    """qfloat8 stores the leaves JAX's `convert_weights_to_fp8` stores (its
    rule on the same tree in JAX's layout), in both experts."""
    from flexam_tpu.utils.fp8 import convert_weights_to_fp8 as jax_fp8
    from flexam_tpu_torch.io.convert import stack_blocks
    from flexam_tpu_torch.models.dit import init_dit_params
    pipe, = N.LoadFlexAMModel().loadmodel(
        "nonexistent", GPU_memory_mode="model_full_load_and_qfloat8",
        random_init="tiny", model_2="also-missing", device="cpu")
    assert pipe.device.type == "cpu" and pipe.gpu_memory_mode == \
        "model_full_load_and_qfloat8"
    assert pipe.cfg == tiny_test_config()
    fresh = init_dit_params(tiny_test_config().dit, seed=0,
                            dtype=torch.float32, device="cpu")
    want = _leaf_dtypes(from_jax_params(jax_fp8(jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.numpy()), stack_blocks(fresh))), "cpu"))
    for name in ("dit_params", "dit2_params"):
        got = _leaf_dtypes(getattr(pipe.models, name))
        assert got == want, name
        assert "float8_e4m3fn" in set(got.values())
    plain, = N.LoadFlexAMModel().loadmodel("nonexistent", random_init="tiny",
                                           device="cpu")
    assert plain.models.dit2_params is None
    assert set(_leaf_dtypes(plain.models.dit_params).values()) == {"float32"}


def test_loader_config_drives_geometry():
    tiny = tiny_test_config()
    custom = dataclasses.replace(
        tiny, dit=dataclasses.replace(tiny.dit, num_layers=3))
    pipe, = N.LoadFlexAMModel().loadmodel(model="x", random_init="tiny",
                                          config=custom, device="cpu")
    assert pipe.cfg.dit.num_layers == 3
    assert len(pipe.models.dit_params["blocks"]) == 3
    assert pipe.models.dit_params["patch_embedding"]["weight"].dtype == \
        torch.float32


def test_loader_and_sampler_tiny_in_the_port():
    """`tests/test_nodes.py:test_loader_and_sampler_tiny` on the port."""
    pipe, = N.LoadFlexAMModel().loadmodel("nonexistent", random_init="tiny",
                                          device="cpu")
    assert isinstance(pipe, tpipe.FlexAMGenerationPipeline)
    rs, video = _clip(0, 5, 32, 32)
    out, = N.FlexAMV2VSampler().process(
        pipe, "a node graph video", video,
        control_video=rs.rand(1, 3, 5, 32, 32).astype(np.float32),
        mask_video=np.ones((1, 1, 5, 32, 32), np.float32),
        video_length=5, base_resolution=32, steps=1, density=10.0)
    assert out.shape == (1, 3, 5, 32, 32) and np.isfinite(out).all()


def test_loader_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        N.LoadFlexAMModel().loadmodel("x", random_init="tiny")
