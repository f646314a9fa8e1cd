"""DWPose in the port (`perception/dwpose.py`, `perception/onnx_graph.py`,
`io/onnx.py`) against the JAX package's and against `cv2.dnn`.

No `.onnx` file of YOLOX-L or RTMPose is in the repository, so the graphs
are the seeded ones `flexam_tpu_torch/testing.py` writes: tiny ones, a
YOLOX-shaped detector ([1, 3, 640, 640] -> [1, 8400, 85]) and an
RTMPose-shaped estimator (-> [1, 133, 576], [1, 133, 768]) using every op
the runner takes, and YOLOX-L / RTMPose-l at their published architecture,
in these tests cut to a few channels. `cv2.dnn.readNetFromONNX` reads the
same files:

  * the reader: the writer's graphs read back (nodes, attributes,
    initializers, inputs and outputs), raw and packed tensor data alike;
  * each op in a graph of its own, and the whole graphs, against
    `cv2.dnn` within rtol 1e-4 / atol 1e-5, and every output of the whole
    graphs, the networks' features among them, within FEATURE_REL of its
    largest magnitude: 1e-5, ten times the measured difference (about
    1e-6) and far below what fp32 weights and inputs rounded to TF32 give
    (above 5e-4, which a test shows); an op outside the list raises and
    names the op and its node;
  * the detector: JAX's `DWPoseDetector` (through `cv2.dnn`) and the
    port's (`device="cpu"`) on the same frames give equal boxes and
    keypoints and scores within 1e-5. The image decides what these
    compare: the objectness and class logits carry the head's features
    (a share of std ~2 logits), and each SimCC row's argmax is one of two
    seeded bins by a linear function of the row's tokens (std ~7), so a
    network computed wrongly moves the scores and the keypoints, which a
    test shows. The boxes come from dyadic weights on a constant map, so
    the crops are exact, and the test asserts a SimCC margin of 1e-3
    between the two largest logits of every row (the measured least is
    0.098) before comparing argmaxes;
  * the detector's empty branches (no detection; detections of another
    class only), `dwpose_video` on 2 frames at 96x128 (equal videos), and
    JAX's `test_full_video_path_with_fake_models` with its canned outputs.
"""

import cv2
import numpy as np
import pytest
import torch

from flexam_tpu.perception import dwpose as jdw
from flexam_tpu_torch import testing as tt
from flexam_tpu_torch.io import onnx as tonnx
from flexam_tpu_torch.perception import dwpose as tdw
from flexam_tpu_torch.perception import onnx_graph as tog

CLOSE = dict(rtol=1e-4, atol=1e-5)
FEATURE_REL = 1e-5          # of max |ref|, every output of a whole graph


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops: one intra-op thread beside the other test
    workers (see tests/test_torch_video_tracking.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dwpose"))
    det, pose = tt.write_tiny_dwpose(d)
    paths = {"det": det, "pose": pose, "dir": d}
    for kind, build in (("det", tt.tiny_yolox_onnx),
                        ("pose", tt.tiny_rtmpose_onnx)):
        paths[kind + "_features"] = path = f"{d}/{kind}_features.onnx"
        with open(path, "wb") as f:
            f.write(build(0, features=True))
    return paths


@pytest.fixture(scope="module")
def detectors(files):
    """JAX's detector (cv2.dnn) and the port's (the CPU), on one pair of
    files, shared by the tests."""
    return (jdw.DWPoseDetector(files["det"], files["pose"]),
            tdw.DWPoseDetector(files["det"], files["pose"], device="cpu"))


def _frames(n=2, h=96, w=128, seed=0):
    return np.random.RandomState(seed).rand(n, h, w, 3).astype(np.float32)


def _cv2_run(path, *inputs):
    net = cv2.dnn.readNetFromONNX(path)
    for i, x in enumerate(inputs):
        net.setInput(x, "" if len(inputs) == 1 else f"in{i}")
    return net.forward(net.getUnconnectedOutLayersNames())


# ---------------------------------------------------------------------------
# the reader
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["yolox", "rtmpose"])
def test_reader_round_trips_the_writer(kind):
    build = tt.tiny_yolox_onnx if kind == "yolox" else tt.tiny_rtmpose_onnx
    wr_nodes = []
    orig = tt.OnnxWriter.to_bytes

    def spy(self, *a, **k):
        wr_nodes.append((list(self.nodes), dict(self.inits)))
        return orig(self, *a, **k)

    tt.OnnxWriter.to_bytes = spy
    try:
        model = tonnx.read_onnx(build(0))
    finally:
        tt.OnnxWriter.to_bytes = orig
    nodes, inits = wr_nodes[0]
    assert model.opset_version == 11
    assert [(n.op_type, n.inputs, n.outputs) for n in model.graph.nodes] \
        == [(o, i, out) for o, i, out, _ in nodes]
    for n, (_, _, _, attrs) in zip(model.graph.nodes, nodes):
        assert n.attrs.keys() == attrs.keys()
        for k, v in attrs.items():
            got = n.attrs[k]
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(got, v)
            elif isinstance(v, str):
                assert got == v.encode()
            elif isinstance(v, float):
                assert got == np.float32(v)
            elif isinstance(v, list) and v and isinstance(v[0], float):
                np.testing.assert_array_equal(got, np.float32(v))
            else:
                assert got == v
    assert model.graph.initializers.keys() == inits.keys()
    for k, v in inits.items():
        got = model.graph.initializers[k]
        assert got.dtype == v.dtype and got.shape == v.shape
        np.testing.assert_array_equal(got, v)
    shapes = {"yolox": ([(1, 3, 640, 640)], [(1, 8400, 85)]),
              "rtmpose": ([(1, 3, 384, 288)], [(1, 133, 576),
                                               (1, 133, 768)])}[kind]
    assert [i.shape for i in model.graph.inputs] == shapes[0]
    assert [o.shape for o in model.graph.outputs] == shapes[1]


def test_reader_takes_packed_data_and_negative_ints():
    """float_data / int64_data (packed) read as raw_data does; negative
    int64 attributes (ten-byte varints) keep their sign."""
    wr = tt.OnnxWriter(0)
    f = np.random.RandomState(0).randn(2, 3).astype(np.float32)
    i = np.asarray([-5, 0, 7, -(1 << 40)], np.int64)
    y = wr.op("Add", ["x", wr.const(f)])
    wr.op("Transpose", [y], perm=[-1, 0])
    wr.const(i, "ints")
    for raw in (True, False):
        g = tonnx.read_onnx(wr.to_bytes([("x", (2, 3))], [(y, (2, 3))],
                                        raw=raw)).graph
        vals = list(g.initializers.values())
        np.testing.assert_array_equal(vals[0], f)
        np.testing.assert_array_equal(vals[1], i)
        assert g.nodes[1].attrs["perm"] == [-1, 0]


# ---------------------------------------------------------------------------
# the runner, op by op and whole, against cv2.dnn
# ---------------------------------------------------------------------------

X = np.random.RandomState(3).randn(1, 4, 6, 8).astype(np.float32)


def _op_graph(op):
    """A small graph on x [1, 4, 6, 8] around one op of the runner's list;
    returns (writer, output name)."""
    wr = tt.OnnxWriter(7)
    rs = wr.rng
    c = lambda a, stem="c": wr.const(np.asarray(a, np.float32), stem)
    i64 = lambda a: wr.const(np.asarray(a, np.int64), "i")
    bcast = c(rs.randn(1, 4, 1, 1))
    if op == "Conv":
        y = wr.conv("x", 4, 3, 3, 2, silu=False)
    elif op in ("Sigmoid", "Relu", "HardSigmoid"):
        kw = {"alpha": 0.3, "beta": 0.4} if op == "HardSigmoid" else {}
        y = wr.op(op, ["x"], **kw)
    elif op in ("Mul", "Add", "Sub"):
        y = wr.op(op, ["x", bcast])
    elif op == "Div":
        y = wr.op("Div", ["x", c(np.abs(rs.randn(1, 4, 1, 1)) + 1)])
    elif op == "Pow":
        y = wr.op("Pow", [wr.op("Sigmoid", ["x"]), c(3.0)])
    elif op == "Sqrt":
        y = wr.op("Sqrt", [wr.op("Add", [wr.op("Mul", ["x", "x"]), c(1.0)])])
    elif op == "Concat":
        y = wr.op("Concat", ["x", wr.op("Sigmoid", ["x"])], axis=1)
    elif op == "Split":
        a, b = wr.op("Split", ["x"], n_out=2, axis=1, split=[1, 3])
        y = wr.op("Concat", [b, a], axis=1)
    elif op == "Slice":
        y = wr.op("Slice", ["x", i64([1, 0]), i64([(1 << 63) - 1, 5]),
                            i64([2, 3]), i64([2, 1])])
    elif op == "MaxPool":
        y = wr.op("MaxPool", ["x"], kernel_shape=[3, 3], strides=[2, 2],
                  pads=[1, 1, 1, 1])
    elif op == "GlobalAveragePool":
        y = wr.op("Mul", ["x", wr.op("GlobalAveragePool", ["x"])])
    elif op in ("ReduceMean", "ReduceL2"):
        y = wr.op(op, ["x"], axes=[-1], keepdims=1)
    elif op == "Resize":
        y = wr.op("Resize", ["x", c(np.zeros(0)), c([1, 1, 2, 2])],
                  mode="nearest", coordinate_transformation_mode="asymmetric",
                  nearest_mode="floor")
    elif op == "Reshape":
        y = wr.op("Reshape", ["x", i64([1, 4, 48])])
    elif op == "Flatten":
        y = wr.op("Flatten", ["x"], axis=1)
    elif op == "Transpose":
        y = wr.op("Transpose", ["x"], perm=[0, 2, 3, 1])
    elif op == "Unsqueeze":
        y = wr.op("Unsqueeze", [wr.op("Flatten", ["x"], axis=2)], axes=[0])
    elif op == "Squeeze":
        y = wr.op("Squeeze", [wr.op("Reshape", ["x", i64([1, 4, 1, 48])])],
                  axes=[2])
    elif op == "MatMul":
        y = wr.op("MatMul", [wr.op("Reshape", ["x", i64([1, 4, 48])]),
                             c(rs.randn(48, 5))])
    elif op == "Gemm":
        flat = wr.op("Flatten", ["x"], axis=1)
        y = wr.op("Gemm", [flat, c(rs.randn(7, 192)), c(rs.randn(7))],
                  transB=1, alpha=0.5, beta=2.0)
    elif op == "Softmax":
        y = wr.op("Softmax", [wr.op("Flatten", ["x"], axis=1)], axis=1)
    elif op == "Constant":
        y = wr.op("Add", ["x", wr.op("Constant", [], value=np.asarray(
            rs.randn(1, 4, 1, 1), np.float32))])
    elif op == "Shape":
        y = wr.op("Reshape", [wr.op("Sigmoid", [wr.op("Flatten", ["x"],
                                                      axis=1)]),
                              wr.op("Shape", ["x"])])
    elif op == "Gather":
        y = wr.op("Gather", ["x", i64([2, 0, 3])], axis=1)
    elif op == "Cast":
        batch = wr.op("Gather", [wr.op("Shape", ["x"]), wr.op(
            "Constant", [], value=np.asarray(0, np.int64))], axis=0)
        batch = wr.op("Cast", [wr.op("Unsqueeze", [batch], axes=[0])], to=7)
        y = wr.op("Reshape", ["x", wr.op("Concat", [batch, i64([4, -1])],
                                         axis=0)])
    elif op == "Identity":
        y = wr.op("Identity", [wr.op("Add", ["x", bcast])])
    return wr, y


@pytest.mark.parametrize("op", sorted(tog.OPS))
def test_each_op_matches_cv2_dnn(op, tmp_path):
    wr, y = _op_graph(op)
    path = str(tmp_path / f"{op}.onnx")
    with open(path, "wb") as f:
        f.write(wr.to_bytes([("x", X.shape)], [(y, ())]))
    assert op in {n.op_type for n in tonnx.read_onnx(path).graph.nodes}
    want = _cv2_run(path, X)[0]
    got = tog.OnnxGraph(path, device="cpu")(X)[0].numpy()
    np.testing.assert_allclose(got.reshape(want.shape), want, **CLOSE)
    assert got.size == want.size


def test_unknown_op_raises_naming_it(tmp_path):
    wr = tt.OnnxWriter(0)
    y = wr.op("Erf", ["x"])
    with pytest.raises(NotImplementedError, match=r"Erf \(node 'Erf_0'\)"):
        tog.OnnxGraph(tonnx.read_onnx(wr.to_bytes([("x", (1, 4))],
                                                  [(y, (1, 4))])),
                      device="cpu")


def _graph_input(kind, seed=5):
    rs = np.random.RandomState(seed)
    return (rs.rand(1, 3, 640, 640).astype(np.float32) * 255
            if kind == "det" else rs.randn(1, 3, 384, 288).astype(np.float32))


def _within_feature_rel(got, want):
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= FEATURE_REL * np.abs(w).max()


@pytest.mark.parametrize("kind", ["det", "pose"])
def test_whole_graphs_match_cv2_dnn(files, kind):
    """The tiny graphs with their features as outputs (the detector's
    stride-8 neck, the estimator's tokens): DWPose's outputs within CLOSE,
    every output within FEATURE_REL of its largest magnitude, the SimCC
    argmaxes equal."""
    x = _graph_input(kind)
    path = files[kind + "_features"]
    want = _cv2_run(path, x)
    got = [g.numpy() for g in tog.OnnxGraph(path, device="cpu")(x)]
    assert len(got) == len(want) == 2 + (kind == "pose")
    for g, w in zip(got[:-1], want[:-1]):
        np.testing.assert_allclose(g, w, **CLOSE)
    _within_feature_rel(got, want)
    if kind == "pose":
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1))


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32's 10-bit mantissa (half away from zero)."""
    return ((t.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


@pytest.mark.parametrize("kind", ["det", "pose"])
def test_feature_bound_fails_under_tf32_rounding(files, kind):
    """FEATURE_REL is tight enough to catch TF32: with the weights and the
    input rounded to TF32, some output leaves it by 50x."""
    x = _graph_input(kind)
    path = files[kind + "_features"]
    want = _cv2_run(path, x)
    g = tog.OnnxGraph(path, device="cpu")
    for k, v in g.consts.items():
        if v.is_floating_point():
            g.consts[k] = _tf32(v.clone())
    got = [o.numpy() for o in g(_tf32(torch.from_numpy(x)))]
    worst = max(np.abs(o - w).max() / np.abs(w).max()
                for o, w in zip(got, want))
    assert worst > 50 * FEATURE_REL


@pytest.mark.parametrize("kind", ["yolox", "rtmpose"])
def test_published_architectures_match_cv2_dnn(tmp_path, kind):
    """`yolox_onnx` / `rtmpose_onnx` (YOLOX-L and RTMPose-l at depth 1.0,
    in this test at 1/8 of their widths): read by cv2.dnn and run by the port to
    the same outputs within FEATURE_REL (random weights give outputs that
    cancel to near zero, so no elementwise rtol); the detector's two
    seeded persons pass the score threshold."""
    build = tt.yolox_onnx if kind == "yolox" else tt.rtmpose_onnx
    path = str(tmp_path / f"{kind}.onnx")
    with open(path, "wb") as f:
        f.write(build(0, depth=1.0, width=0.125))
    g = tog.OnnxGraph(path, device="cpu")
    ops = [n.op_type for n in g.graph.nodes]
    x = _graph_input("det" if kind == "yolox" else "pose")
    want = _cv2_run(path, x)
    got = [o.numpy() for o in g(x)]
    _within_feature_rel(got, want)
    if kind == "yolox":
        # Focus, 4 stem/stage convs, 3+9+9+3 bottlenecks of 2 convs, the
        # CSP layers' 3 each, SPP's 2, the PAFPN's 4 CSPs of 3 bottlenecks,
        # its 4 convs, and 3 heads of 5 convs + 3 predictions
        assert ops.count("Conv") == (1 + 4 + 2 * 24 + 3 * 4 + 2
                                     + 4 * (3 + 2 * 3) + 4 + 3 * 8)
        assert got[0].shape == (1, 8400, 85)
        assert ((got[0][0, :, 4] * got[0][0, :, 5]) > 0.3).sum() == 2
    else:
        # the stem's 3, 4 stage convs, 3+6+6+3 blocks of 3, the CSP
        # layers' 3 and attention's 1 each, SPPF's 2 and the head's 7x7
        assert ops.count("Conv") == 3 + 4 + 3 * 18 + 4 * 4 + 2 + 1
        assert [o.shape for o in got] == [(1, 133, 576), (1, 133, 768)]


# ---------------------------------------------------------------------------
# the detector against JAX's
# ---------------------------------------------------------------------------


def test_detector_matches_jax(detectors):
    jd, td = detectors
    for frame in _frames():
        x, ratio = tdw.letterbox((frame * 255).astype(np.uint8))
        jx, jratio = jdw.letterbox((frame * 255).astype(np.uint8))
        np.testing.assert_array_equal(x, jx)
        assert ratio == jratio
        raw_t = td._run(td.det, x[None])[0][0]
        raw_j = np.asarray(jd._run(jd.det, jx[None])[0])[0]
        np.testing.assert_allclose(raw_t, raw_j, **CLOSE)
        boxes = tdw.detect_people(raw_t, ratio)
        np.testing.assert_array_equal(boxes, jdw.detect_people(raw_j, ratio))
        assert len(boxes) == 3              # one of four overlapping: NMS
        kp, sc = td(frame)
        jkp, jsc = jd(frame)
        np.testing.assert_array_equal(kp, jkp)
        np.testing.assert_allclose(sc, jsc, rtol=0, atol=1e-5)
        assert 0.1 < (sc > 0.3).mean() < 0.9    # visible and hidden joints


def test_simcc_maxima_have_a_clear_margin(detectors):
    """The argmax decides the keypoints: on each crop, every SimCC row's
    largest logit leads the next by more than 1e-3 in the port's outputs
    and in cv2.dnn's, far above their difference (below 1e-4)."""
    jd, td = detectors
    frame = (_frames(1)[0] * 255).astype(np.uint8)
    x, ratio = tdw.letterbox(frame)
    boxes = tdw.detect_people(td._run(td.det, x[None])[0][0], ratio)
    for bbox in boxes:
        crop = tdw.crop_person(frame, bbox)[0].transpose(2, 0, 1)[None]
        outs = td._run(td.pose, crop), jd._run(jd.pose, crop)
        for logits in outs:
            for lg in logits:
                top2 = np.sort(np.asarray(lg)[0], axis=1)[:, -2:]
                assert (top2[:, 1] - top2[:, 0]).min() > 1e-3
        for a, b in zip(*outs):
            assert np.abs(np.asarray(a) - np.asarray(b)).max() < 1e-4


def test_scores_and_keypoints_follow_the_network(files, detectors):
    """A network computed wrongly shows: noise of a tenth of the weights'
    std on the first convolution of each graph moves more than 2 % of the
    keypoints (the estimator's) and the detection scores beyond 1e-5 (the
    detector's)."""
    _, td = detectors
    frame = _frames(1)[0]
    kp, _ = td(frame)
    x, _ = tdw.letterbox((frame * 255).astype(np.uint8))
    scores = lambda d: d._run(d.det, x[None])[0][0][:, 4:6].prod(-1)
    for graph in ("pose", "det"):
        wrong = tdw.DWPoseDetector(files["det"], files["pose"], device="cpu")
        g = getattr(wrong, graph)
        w = next(n.inputs[1] for n in g.graph.nodes if n.op_type == "Conv")
        rs = torch.Generator().manual_seed(0)
        g.consts[w] = g.consts[w] + 0.1 * g.consts[w].std() * torch.randn(
            g.consts[w].shape, generator=rs)
        if graph == "pose":
            wkp, _ = wrong(frame)
            assert (wkp != kp).any(-1).mean() > 0.02     # 0.063 measured
        else:
            assert np.abs(scores(wrong) - scores(td)).max() > 1e-5


@pytest.mark.parametrize("people", ["none", "other"])
def test_detector_empty_branches_match_jax(files, people):
    """No detection at all: no poses. Detections of another class only:
    one pose from the whole frame."""
    det, pose = tt.write_tiny_dwpose(files["dir"], people=people)
    frame = _frames(1)[0]
    kp, sc = tdw.DWPoseDetector(det, pose, device="cpu")(frame)
    jkp, jsc = jdw.DWPoseDetector(det, pose)(frame)
    assert kp.shape == jkp.shape == ((0, 133, 2) if people == "none"
                                     else (1, 133, 2))
    np.testing.assert_array_equal(kp, jkp)
    np.testing.assert_allclose(sc, jsc, rtol=0, atol=1e-5)


def test_dwpose_video_matches_jax(files, monkeypatch):
    video = _frames()
    got = tdw.dwpose_video(video, files["det"], files["pose"], device="cpu")
    want = jdw.dwpose_video(video, files["det"], files["pose"])
    assert got.shape == (2, 96, 128, 3) and got.sum() > 0
    np.testing.assert_array_equal(got, want)
    monkeypatch.delenv("FLEXAM_DWPOSE_DET", raising=False)
    monkeypatch.delenv("FLEXAM_DWPOSE_POSE", raising=False)
    with pytest.raises(RuntimeError, match="FLEXAM_DWPOSE_DET"):
        tdw.dwpose_video(video, device="cpu")


def test_pre_and_post_processing_match_jax():
    """The numpy halves on random inputs: the YOLOX decode + NMS, the crop
    and the SimCC decode."""
    rs = np.random.RandomState(2)
    raw = rs.randn(8400, 85).astype(np.float32) * 0.2
    raw[:12, 4:6] = 4.0
    np.testing.assert_array_equal(tdw.detect_people(raw.copy(), 0.5),
                                  jdw.detect_people(raw.copy(), 0.5))
    img = (rs.rand(200, 260, 3) * 255).astype(np.uint8)
    for bbox in np.asarray([[30, 20, 160, 190], [80, 40, 250, 180]],
                           np.float32):
        for a, b in zip(tdw.crop_person(img, bbox),
                        jdw.crop_person(img, bbox)):
            np.testing.assert_array_equal(a, b)
    sx = rs.rand(2, 133, 576).astype(np.float32) - 0.2
    sy = rs.rand(2, 133, 768).astype(np.float32) - 0.2
    c, s = np.float32([100, 90]), np.float32([120, 160])
    for a, b in zip(tdw.keypoints_from_simcc(sx, sy, c, s),
                    jdw.keypoints_from_simcc(sx, sy, c, s)):
        np.testing.assert_array_equal(a, b)


class _FakeSession:
    """JAX's test's cv2.dnn stand-in (`tests/test_dwpose.py:17`)."""

    def __init__(self, outputs):
        self._outputs = outputs
        self.inputs = []

    def getUnconnectedOutLayersNames(self):
        n = 2 if callable(self._outputs) else len(self._outputs)
        return ["out%d" % i for i in range(n)]

    def setInput(self, x):
        self.inputs.append(np.asarray(x))

    def forward(self, names):
        out = self._outputs
        if callable(out):
            out = out(self.inputs[-1])
        return out


def _fake_reader(rng):
    """JAX's `fake_read` (`tests/test_dwpose.py:143-151`) on `rng`."""
    a = 8400

    def fake_read(net_path):
        if "det" in net_path:
            raw = rng.randn(1, a, 85).astype(np.float32) * 0.3
            raw[0, :6, 4:6] = 5.0
            return _FakeSession([raw])
        k = 133
        return _FakeSession(lambda x: (
            rng.rand(1, k, 576).astype(np.float32),
            rng.rand(1, k, 768).astype(np.float32)))
    return fake_read


def test_full_video_path_with_fake_models(monkeypatch):
    """JAX's test with its canned outputs, on the port: the same canned
    sessions (as graphs returning their outputs) give a rendered control
    video in range."""
    class FakeGraph:
        def __init__(self, path, device="cuda"):
            self.session = _fake_reader(port_rng)(path)
            self.device = torch.device(device)

        def __call__(self, x):
            self.session.setInput(x)
            return [torch.from_numpy(np.asarray(o)) for o in
                    self.session.forward(None)]

    port_rng = np.random.RandomState(3)
    monkeypatch.setattr(tog, "OnnxGraph", FakeGraph)
    video = np.random.RandomState(4).rand(2, 96, 128, 3).astype(np.float32)
    out = tdw.dwpose_video(video, det_onnx="det.onnx", pose_onnx="pose.onnx",
                           device="cpu")
    assert out.shape == (2, 96, 128, 3)
    assert out.max() <= 1.0 and out.min() >= 0.0
    assert out.sum() > 0          # something was drawn
