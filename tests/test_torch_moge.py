"""The port's MoGe-2 (`flexam_tpu_torch/perception/moge.py`) against the
JAX package's, on the CPU at the tiny geometry of `tests/test_moge.py`
(`TINY`), with the weights crossed through `io.convert.from_jax_params`.

Outputs in fp32 are held at rtol 2e-4 / atol 1e-5; the mask (`logits > 0`)
must agree entry for entry, so the focal/shift solver sees the same points
on both sides. The solver is host numpy in both packages (JAX's code), held
to exact recovery on synthetic pinhole scenes as JAX's test holds it. The
loaders map a state dict of distinct values leaf for leaf as JAX's do.

The helpers at the top are shared with `tests/test_torch_{vggt,pi3}.py`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexam_tpu.perception import moge as J
from flexam_tpu.perception.densetrack3d import \
    map_torch_state_dict as jax_map
from flexam_tpu_torch.io.convert import from_jax_params
from flexam_tpu_torch.perception import moge as T
from flexam_tpu_torch.perception.densetrack3d import (_jax_leaves,
                                                      map_torch_state_dict)
from tests.test_moge import TINY, _pinhole_points

TOL = dict(rtol=2e-4, atol=1e-5)
TINY_T = T.MoGeConfig(**dataclasses.asdict(TINY))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These modules run thousands of small torch ops; beside the other
    test workers, torch's intra-op threads would oversubscribe the cores
    and stall at every op's barrier, so they run on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# helpers shared by the three geometry models' tests
# ---------------------------------------------------------------------------


def jax_tree(tree, key=""):
    """The port's tree in JAX's layout: conv kernels (4-dim `weight`
    leaves) HWIO, every other leaf as it is."""
    if isinstance(tree, dict):
        return {k: jax_tree(v, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [jax_tree(v, key) for v in tree]
    a = tree.numpy()
    if a.ndim == 4 and key == "weight":
        a = a.transpose(2, 3, 1, 0)
    return jnp.asarray(a)


def port_tree(jtree):
    return from_jax_params(jax.tree_util.tree_map(np.asarray, jtree), "cpu")


def distinct_state_dict(jparams, seed):
    """A torch state dict with distinct values for every leaf of the JAX
    tree, in a scrambled order, convs in torch's OIHW, plus a tensor that
    matches nothing and an entry that is not a tensor."""
    rng = np.random.RandomState(seed)
    flat, _ = jax.tree_util.tree_flatten_with_path(jparams)
    sd = {}
    for i in rng.permutation(len(flat)):
        path, leaf = flat[i]
        arr = rng.randn(*np.asarray(leaf).shape).astype(np.float32)
        if arr.ndim == 4 and jax.tree_util.keystr(path).endswith(
                "['weight']"):
            arr = arr.transpose(3, 2, 0, 1)
        sd[f"module_{i}.w"] = torch.from_numpy(np.ascontiguousarray(arr))
    sd["odd_tensor"] = torch.zeros(13, 17)
    sd["step"] = 7
    return sd


def assert_maps_like_jax(jparams, tparams, sd):
    """Both shape mappers on one state dict: the same report, and every
    leaf of the port equal to JAX's leaf in the port's layout."""
    jp, jrep = jax_map(jparams, {k: (v.numpy() if torch.is_tensor(v) else v)
                                 for k, v in sd.items()})
    tp, trep = map_torch_state_dict(tparams, sd)
    assert trep == jrep
    assert trep["unused"] == ["odd_tensor"] and not trep["missed"]
    want = port_tree(jp)
    flat, _ = jax.tree_util.tree_flatten_with_path(jparams)
    assert [jax.tree_util.keystr(p) for p, _ in flat] == [
        p for p, _ in _jax_leaves(tparams)]
    for (pa, a), (pb, b) in zip(_jax_leaves(tp), _jax_leaves(want)):
        assert pa == pb
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=pa)
    return tp


def assert_same_params(tparams, jparams):
    for (pa, a), (pb, b) in zip(_jax_leaves(tparams),
                                _jax_leaves(port_tree(jparams))):
        assert pa == pb
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=pa)


def write_checkpoint(tparams, path, fmt):
    """The port's tree as a reference-format file of fake names, in the
    loaders' order (names that sort in it, as a safetensors file keeps its
    names sorted): `.pt` ({"model": ...}) or `.safetensors`."""
    from flexam_tpu_torch.io.checkpoints import save_safetensors
    sd = {}
    for i, (p, t) in enumerate(_jax_leaves(tparams)):
        sd[f"tensor_{i:04d}"] = t.contiguous()
    if fmt == "safetensors":
        save_safetensors(str(path), sd)
    else:
        torch.save({"model": sd}, str(path))
    return str(path)


# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    """Both models on one set of weights (the port's init, crossed to JAX's
    layout and back), with the level weights moved off their zero init."""
    seed = T.MoGeModel(TINY_T, seed=3, device="cpu")
    seed.params["head"]["level_w"] = torch.tensor([0.3, -0.2])
    jp = jax_tree(seed.params)
    jm = J.MoGeModel(TINY, params=jp)
    tm = T.MoGeModel(TINY_T, params=port_tree(jp), device="cpu")
    return jm, tm


@pytest.mark.parametrize("h,w", [(44, 60), (42, 56)])
def test_infer_matches_jax(models, h, w):
    jm, tm = models
    img = np.random.RandomState(h).rand(3, h, w).astype(np.float32)
    want = jm.infer(img)
    got = tm.infer(torch.from_numpy(img))
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["mask"], want["mask"])
    assert 0 < got["mask"].mean() < 1
    for k in ("points", "depth", "normal", "intrinsics"):
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)
    assert tm.last_info["network_hw"] == tm.network_hw(h, w)


def test_forward_matches_jax(models):
    """The encoder and head on one normalized input: point map, mask
    logits, normals and the log scale."""
    jm, tm = models
    x = np.random.RandomState(5).randn(2, 28, 42, 3).astype(np.float32)
    want = J._forward_jit(jm.params, jnp.asarray(x), (40, 56), TINY)
    got = T.forward(tm.params, torch.from_numpy(x), (40, 56), TINY_T)
    for a, b, name in zip(got, want, ("points", "logits", "normal",
                                      "log_scale")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL,
                                   err_msg=name)


def test_focal_shift_exact_recovery():
    pts, f_true, dz_true = _pinhole_points()
    f, dz = T.recover_focal_shift(pts, None)
    assert f == pytest.approx(f_true, rel=1e-4)
    assert dz == pytest.approx(dz_true, rel=1e-3, abs=1e-3)
    assert (f, dz) == J.recover_focal_shift(pts, None)


def test_focal_shift_recovery_masked_noise():
    pts, f_true, dz_true = _pinhole_points(seed=1)
    rng = np.random.RandomState(2)
    mask = rng.rand(*pts.shape[:2]) > 0.3
    pts2 = pts + rng.randn(*pts.shape) * 1e-4
    pts2[~mask] = np.nan
    f, dz = T.recover_focal_shift(pts2, mask)
    assert f == pytest.approx(f_true, rel=1e-2)
    assert dz == pytest.approx(dz_true, rel=1e-2, abs=1e-2)
    assert T.recover_focal_shift(pts2[:2, :3], None) == (1.0, 0.0)


def test_demo_moge_consumption(models):
    """The output feeds the demo's image path: points tiled over T,
    projected under identity poses, converted to DELTA-format tracks, as
    JAX's do from JAX's output."""
    from flexam_tpu.conditioning import CameraMotionGenerator as JCam
    from flexam_tpu.orchestrator import convert_moge_to_delta_format as jconv
    from flexam_tpu_torch.conditioning import CameraMotionGenerator as TCam
    from flexam_tpu_torch.orchestrator import convert_moge_to_delta_format
    jm, tm = models
    h, w, t = 42, 56, 5
    img = np.random.RandomState(4).rand(3, h, w).astype(np.float32)
    outs = []
    for m, cam_cls, conv in ((tm, TCam, convert_moge_to_delta_format),
                             (jm, JCam, jconv)):
        out = m.infer(img)
        cam = cam_cls("", frame_num=t, H=h, W=w)
        cam.set_intr(out["intrinsics"])
        pred = np.tile(out["points"][None], (t, 1, 1, 1))
        poses = np.tile(np.eye(4, dtype=np.float32), (t, 1, 1))
        uvd = cam.w2s_moge(pred.reshape(t, h * w, 3), poses)
        outs.append(conv(uvd.reshape(t, h, w, 3), out["mask"], h, w))
    assert np.isfinite(outs[0][0]).all()
    np.testing.assert_allclose(outs[0][0], outs[1][0], rtol=2e-4, atol=1e-4)
    np.testing.assert_array_equal(outs[0][1], outs[1][1])


def test_state_dict_maps_to_the_same_leaves_as_jax(models):
    jm, tm = models
    assert_maps_like_jax(jm.params, tm.params,
                         distinct_state_dict(jm.params, 7))


@pytest.mark.parametrize("fmt", ["pt", "safetensors", "dir"])
def test_load_moge_matches_jax(models, tmp_path, monkeypatch, fmt):
    """A file written in the loaders' order loads fully in both packages
    (a directory resolves to model.pt before model.safetensors, where a
    decoy safetensors of other values lies) and infers the same."""
    jm, tm = models
    monkeypatch.setattr(J, "MoGeConfig", lambda: TINY)
    monkeypatch.setattr(J, "moge_init", lambda key, cfg: jax_tree(
        T.moge_init(torch.Generator().manual_seed(9), TINY_T, "cpu")))
    if fmt == "dir":
        write_checkpoint(tm.params, tmp_path / "model.pt", "pt")
        decoy = T.moge_init(torch.Generator().manual_seed(8), TINY_T, "cpu")
        write_checkpoint(decoy, tmp_path / "model.safetensors",
                         "safetensors")
        path = str(tmp_path)
    else:
        path = write_checkpoint(tm.params, tmp_path / f"moge.{fmt}", fmt)
    jl = J.load_moge(path, TINY)
    tl = T.load_moge(path, TINY_T, device="cpu")
    assert jl.load_ok and tl.load_ok
    assert tl.load_report == jl.load_report
    assert_same_params(tl.params, jl.params)
    img = np.random.RandomState(6).rand(3, 44, 60).astype(np.float32)
    np.testing.assert_allclose(tl.infer(img)["points"],
                               jm.infer(img)["points"], **TOL)
    assert T.MoGeModel.from_pretrained(path, TINY_T, device="cpu").load_ok


def test_load_moge_refuses_low_coverage(tmp_path, monkeypatch):
    """A checkpoint that maps below the bar raises, in both packages, unless
    FLEXAM_MOGE_BESTEFFORT=1 accepts the partial load."""
    path = str(tmp_path / "junk.pt")
    torch.save({"junk.weight": torch.zeros(4, 4)}, path)
    monkeypatch.delenv("FLEXAM_MOGE_BESTEFFORT", raising=False)
    with pytest.raises(ValueError, match="coverage"):
        T.load_moge(path, TINY_T, device="cpu")
    monkeypatch.setenv("FLEXAM_MOGE_BESTEFFORT", "1")
    m = T.load_moge(path, TINY_T, device="cpu")
    assert m.load_ok is False and m.load_report["unused"] == ["junk.weight"]
    with pytest.raises(FileNotFoundError):
        T.load_moge(str(tmp_path / "missing.pt"), TINY_T, device="cpu")


def test_verify_ckpt_moge_matches_jax(models, tmp_path, monkeypatch):
    """`verify_ckpt --model moge` reports a full file as passing and a junk
    one as failing, as JAX's tool does (both with their default config
    swapped for the tiny one); the port's leaves the environment as it
    found it."""
    from flexam_tpu.tools import verify_ckpt as jvc
    from flexam_tpu_torch.tools import verify_ckpt as tvc
    _, tm = models
    monkeypatch.setattr(J, "MoGeConfig", lambda: TINY)
    monkeypatch.setattr(T, "MoGeConfig", lambda: TINY_T)
    monkeypatch.setattr(J, "moge_init", lambda key, cfg: jax_tree(
        T.moge_init(torch.Generator().manual_seed(9), TINY_T, "cpu")))
    monkeypatch.setenv("FLEXAM_MOGE_BESTEFFORT", "0")   # JAX's tool sets it
    good = write_checkpoint(tm.params, tmp_path / "moge.pt", "pt")
    junk = str(tmp_path / "junk.pt")
    torch.save({"junk.weight": torch.zeros(4, 4)}, junk)
    for path, ok in ((good, True), (junk, False)):
        assert tvc.verify("moge", path, "cpu") is ok
        assert jvc.verify("moge", path) is ok
        monkeypatch.setenv("FLEXAM_MOGE_BESTEFFORT", "0")
    assert tvc.main(["--model", "moge", "--platform", "cpu", good]) == 0
    import os
    assert os.environ["FLEXAM_MOGE_BESTEFFORT"] == "0"


def test_demo_image_input_runs_moge(models, tmp_path, monkeypatch):
    """`demo.main` on an image with FLEXAM_MOGE_CKPT, --object_motion up and
    --object_mask: MoGe runs on the first frame from the checkpoint (no
    fixture), and the tracks the demo hands the generation equal those of
    the same run fed JAX's MoGe output for that frame as a --moge_npz
    fixture."""
    from flexam_tpu_torch import demo
    from flexam_tpu_torch.orchestrator import FlexAMOrchestrator
    from flexam_tpu_torch.utils.media import get_image_latent
    jm, tm = models
    h = w = 32
    img = str(tmp_path / "img.npy")
    np.save(img, (np.random.RandomState(3).rand(h, w, 3) * 255).astype(
        np.uint8))
    omask = np.zeros((h, w), np.uint8)
    omask[8:24, 8:24] = 255
    np.save(tmp_path / "omask.npy", omask)
    ckpt = write_checkpoint(tm.params, tmp_path / "moge.pt", "pt")
    monkeypatch.setattr(T, "MoGeConfig", lambda: TINY_T)
    monkeypatch.delenv("FLEXAM_MOGE_BESTEFFORT", raising=False)
    seen, calls = [], []
    orig_apply, orig_infer = FlexAMOrchestrator.apply_tracks, T.MoGeModel.infer

    def apply(self, tracks, vis, *a, **k):
        seen.append((np.asarray(tracks), np.asarray(vis)))
        return orig_apply(self, tracks, vis, *a, **k)

    def infer(self, image, **k):
        calls.append(np.asarray(image))
        return orig_infer(self, image, **k)
    monkeypatch.setattr(FlexAMOrchestrator, "apply_tracks", apply)
    monkeypatch.setattr(T.MoGeModel, "infer", infer)
    argv = ["--prompt", "a test scene", "--platform", "cpu",
            "--random_init", "tiny", "--sample_size", str(h), str(w),
            "--video_length", "5", "--num_inference_steps", "1",
            "--seed", "3", "--input_path", img, "--object_motion", "up",
            "--object_mask", str(tmp_path / "omask.npy")]
    monkeypatch.setenv("FLEXAM_MOGE_CKPT", ckpt)
    out = demo.main(argv + ["--output_dir", str(tmp_path / "ckpt")])
    assert out.shape == (1, 3, 5, h, w) and np.isfinite(out).all()
    assert len(calls) == 1
    frame = get_image_latent(img, (h, w))[0, :, 0]
    np.testing.assert_array_equal(calls[0], frame)
    want = jm.infer(frame)
    np.savez(tmp_path / "moge.npz", **{k: want[k] for k in
                                       ("points", "mask", "intrinsics")})
    monkeypatch.delenv("FLEXAM_MOGE_CKPT")
    demo.main(argv + ["--moge_npz", str(tmp_path / "moge.npz"),
                      "--output_dir", str(tmp_path / "npz")])
    assert len(calls) == 1 and len(seen) == 2
    np.testing.assert_allclose(seen[0][0], seen[1][0], rtol=2e-4, atol=1e-3)
    np.testing.assert_array_equal(seen[0][1], seen[1][1])
