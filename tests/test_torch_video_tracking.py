"""Video input end to end in the port against the JAX package, on the CPU
at tiny sizes: `tracking.dispatch_tracking`'s three routes,
`tools/track`, the demo's DELTA, flow and `--repaint true` runs, the
server's `track_method`, `verify_ckpt --model delta`, and the slice as a
whole (clip -> UniDepth -> DELTA -> apply_tracks, with JAX's noise).

Both packages run one set of weights: the port's tiny inits crossed to
JAX's layout (the tiny pipeline of `tests/test_torch_serve.py`'s shapes,
DenseTrack3D at `tests/test_densetrack3d.py`'s TINY, UniDepth at
`tests/test_unidepth.py`'s). A DELTA checkpoint is loaded by both loaders
with their default config swapped for the tiny one. The dispatch's flow
method runs each package's device tracker (FLEXAM_FLOW=device); the
demo's flow branch, `tools/track --method flow`, `track_video_flow` and
FLEXAM_FLOW=host run the Farneback tracker, OpenCV's in JAX and
`perception/farneback.py` in the port.

Tracks agree to 1e-3 px with equal visibility; videos within one uint8
step of the decode (`tests/test_torch_cli.py`'s U8)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexam_tpu import orchestrator as jorch
from flexam_tpu import pipeline as jpipe
from flexam_tpu import serve as jserve
from flexam_tpu.config import tiny_test_config as jax_tiny
from flexam_tpu.perception import densetrack3d as jdt
from flexam_tpu.perception import tracking as jtrack
from flexam_tpu_torch import demo as tdemo
from flexam_tpu_torch import orchestrator as torch_orch
from flexam_tpu_torch import pipeline as tpipe
from flexam_tpu_torch import serve as tserve
from flexam_tpu_torch.config import tiny_test_config
from flexam_tpu_torch.io.convert import from_jax_params, stack_blocks
from flexam_tpu_torch.perception import densetrack3d as tdt
from flexam_tpu_torch.perception import tracking as ttrack

T, H, W = 9, 32, 32
DENSITY = 8
U8 = dict(rtol=0, atol=1.01 / 255)
TRACKS = dict(rtol=0, atol=1e-3)
DT_TINY = dict(stride=4, window_len=8, model_resolution=(64, 96),
               upsample_factor=4, latent_dim=32, dim=64, num_heads=4,
               num_blocks=2, iters=2, num_virtual_tracks=8,
               compute="float32")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These modules run thousands of small torch ops; beside the other
    test workers, torch's intra-op threads would oversubscribe the cores
    and stall at every op's barrier, so they run on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_jax(tree):
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(x.numpy()) if torch.is_tensor(x) else x,
        stack_blocks(tree))


class _JaxNoise(tpipe.FlexAMGenerationPipeline):
    """The port's pipeline drawing JAX's initial noise (PRNGKey(seed))
    where the caller passes no latents."""

    def denoise(self, cond, context, *a, seed=1245644, latents=None, **kw):
        if latents is None:
            latents = np.asarray(jax.random.normal(
                jax.random.PRNGKey(seed), (1,) + tuple(cond["latent_shape"]),
                jnp.float32))
        return super().denoise(cond, context, *a, seed=seed,
                               latents=latents, **kw)


@pytest.fixture(scope="module")
def pipes():
    """The tiny pipelines of both packages on one set of weights."""
    from flexam_tpu_torch.models.dit import init_dit_params
    from flexam_tpu_torch.models.t5 import init_t5_params
    from flexam_tpu_torch.models.vae import init_vae_params
    cfg = tiny_test_config()
    kw = dict(dtype=torch.float32, device="cpu")
    trees = [_to_jax(init_dit_params(cfg.dit, seed=0, **kw)),
             _to_jax(init_vae_params(cfg.vae, seed=1, **kw)),
             _to_jax(init_t5_params(cfg.t5, seed=2, **kw))]
    jp = jpipe.FlexAMGenerationPipeline(jpipe.FlexAMModels(
        cfg=jax_tiny(), dit_params=trees[0], vae_params=trees[1],
        t5_params=trees[2]), compute_dtype=jnp.float32)
    conv = [from_jax_params(jax.tree_util.tree_map(np.asarray, p), "cpu")
            for p in trees]
    tp = _JaxNoise(tpipe.FlexAMModels(cfg=cfg, dit_params=conv[0],
                                      vae_params=conv[1],
                                      t5_params=conv[2]), device="cpu")
    return jp, tp


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """A textured clip drifting one pixel a frame, as the demo reads it
    (an .npz frame dump) and as both packages take it ([1, 3, T, H, W])."""
    d = tmp_path_factory.mktemp("video_tracking")
    rng = np.random.RandomState(11)
    big = rng.rand(H // 4 + 6, W // 4 + 6, 3)
    big = np.kron(big, np.ones((4, 4, 1)))                 # 4x4 texture
    frames = np.stack([big[4:4 + H, 4 + i:4 + i + W] for i in range(T)])
    u8 = (frames * 255).astype(np.uint8)
    path = str(d / "clip.npz")
    np.savez(path, video=u8, fps=8)
    video = u8.transpose(3, 0, 1, 2)[None].astype(np.float32) / 255.0
    return path, video, d


@pytest.fixture(scope="module")
def delta_ckpt(clip):
    """A reference-format densetrack3d.pth of the tiny model."""
    model = tdt.DenseTrack3D(**DT_TINY, seed=4, device="cpu")
    path = str(clip[2] / "densetrack3d.pth")
    torch.save({"model": model.state_dict()}, path)
    return path


@pytest.fixture
def tiny_loaders(monkeypatch, delta_ckpt):
    """Both DELTA loaders build the tiny config by default; the checkpoint
    is found through FLEXAM_DELTA_CKPT; JAX's flow method is its device
    tracker; depth is the luminance placeholder on both sides."""
    monkeypatch.setattr(jdt, "load_densetrack3d", functools.partial(
        jdt.load_densetrack3d, **DT_TINY))
    monkeypatch.setattr(tdt, "load_densetrack3d", functools.partial(
        tdt.load_densetrack3d, **DT_TINY))
    monkeypatch.setenv("FLEXAM_DELTA_CKPT", delta_ckpt)
    monkeypatch.setenv("FLEXAM_FLOW", "device")
    for k in ("FLEXAM_DEPTH_BACKEND", "FLEXAM_UNIDEPTH_CKPT",
              "FLEXAM_FORCE_DELTA", "FLEXAM_FLUX_CKPT", "FLEXAM_FLUX_AE"):
        monkeypatch.delenv(k, raising=False)
    return delta_ckpt


def _same_tracks(got, want):
    np.testing.assert_allclose(got[0], want[0], **TRACKS)
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("route", ["delta", "low_coverage", "flow", "auto"])
def test_dispatch_tracking_routes_match_jax(clip, tiny_loaders, monkeypatch,
                                            tmp_path, capsys, route):
    """'delta' with a checkpoint that maps runs DenseTrack3D; one that maps
    below the coverage bar falls back to the flow tracker with JAX's
    warning; 'flow' runs the flow tracker; 'auto' without a checkpoint
    does too."""
    _, video, _ = clip
    method, ckpt = route, None
    if route == "low_coverage":
        sd = torch.load(tiny_loaders, weights_only=True)["model"]
        half = dict(list(sd.items())[: len(sd) // 2])
        ckpt = str(tmp_path / "half.pth")
        torch.save(half, ckpt)
        method = "delta"
    if route == "auto":
        monkeypatch.delenv("FLEXAM_DELTA_CKPT")
        monkeypatch.chdir(tmp_path)              # no ./checkpoints either
    want = jtrack.dispatch_tracking(video, method, density=DENSITY,
                                    ckpt=ckpt)
    jout = capsys.readouterr().out
    got = ttrack.dispatch_tracking(video, method, density=DENSITY,
                                   ckpt=ckpt, device="cpu")
    tout = capsys.readouterr().out
    _same_tracks(got, want)
    fell_back = "falling back to the optical-flow tracker"
    assert (fell_back in tout) == (fell_back in jout) == (
        route == "low_coverage")
    n_flow = len(range(DENSITY // 2, H, DENSITY)) * len(
        range(DENSITY // 2, W, DENSITY))
    assert (got[0].shape[1] == n_flow) == (route != "delta")


def test_flow_divergences_and_checkpoint_search(clip, monkeypatch, tmp_path):
    """The Farneback tracker: `track_video_flow` and FLEXAM_FLOW=host give
    JAX's tracks (OpenCV's Farneback there); the checkpoint search follows
    JAX's order."""
    _, video, _ = clip
    monkeypatch.delenv("FLEXAM_DEPTH_BACKEND", raising=False)
    monkeypatch.delenv("FLEXAM_UNIDEPTH_CKPT", raising=False)
    _same_tracks(ttrack.track_video_flow(video, density=DENSITY,
                                         device="cpu"),
                 jtrack.track_video_flow(video, density=DENSITY))
    monkeypatch.setenv("FLEXAM_FLOW", "host")
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("FLEXAM_DELTA_CKPT", raising=False)
    _same_tracks(ttrack.dispatch_tracking(video, "flow", density=DENSITY,
                                          device="cpu"),
                 jtrack.dispatch_tracking(video, "flow", density=DENSITY))
    assert ttrack.find_delta_checkpoint() is None
    (tmp_path / "checkpoints" / "DELTA").mkdir(parents=True)
    (tmp_path / "checkpoints" / "DELTA" / "densetrack3d.pth").write_bytes(b"")
    assert ttrack.find_delta_checkpoint() == jtrack.find_delta_checkpoint() \
        == "checkpoints/DELTA/densetrack3d.pth"
    monkeypatch.setenv("FLEXAM_DELTA_CKPT", str(tmp_path / "missing.pth"))
    assert ttrack.find_delta_checkpoint() == "checkpoints/DELTA/densetrack3d.pth"


@pytest.mark.parametrize("method", ["delta", "flow"])
def test_tools_track_matches_jax(clip, tiny_loaders, tmp_path, method):
    """`python -m flexam_tpu_torch.tools.track` on the .npz clip writes the
    tracks JAX's trackers give on the same frames (JAX's own CLI decodes
    with OpenCV; its flow method is the Farneback tracker), and solved
    poses with --solve_poses."""
    from flexam_tpu_torch.tools import track
    path, video, _ = clip
    out = str(tmp_path / "tracks.npz")
    track.main(["--input", path, "--output", out, "--method", method,
                "--density", str(DENSITY), "--video_length", str(T),
                "--sample_size", str(H), str(W), "--platform", "cpu",
                "--solve_poses"])
    data = np.load(out)
    if method == "delta":
        want = jtrack.track_video_delta(video, density=DENSITY,
                                        ckpt=tiny_loaders)
    else:
        want = jtrack.track_video_flow(video, density=DENSITY)
    _same_tracks((data["tracks"], data["visibility"]), want)
    assert data["extrinsics"].shape == (T, 3, 4)
    assert data["intrinsics"].shape == (T, 3, 3)


def _jax_apply_tracks(jp, tracks, vis, first, tmp_path, seed=3, steps=2):
    orch = jorch.FlexAMOrchestrator(jp, output_dir=str(tmp_path / "jax"),
                                    save_tracking=False)
    return orch.apply_tracks(
        tracks, vis, H, W, prompt="a test scene", point_wise=4,
        generate_type="full_edit", first_frame=first,
        density=1.0 / DENSITY, num_inference_steps=steps,
        guidance_scale=6.0, seed=seed)


@pytest.mark.parametrize("mode", ["DELTA", "flow", "repaint"])
def test_demo_video_runs_match_jax(pipes, clip, tiny_loaders, monkeypatch,
                                   tmp_path, mode):
    """`demo.main --input_path clip.npz` in full_edit: DELTA tracking from
    FLEXAM_DELTA_CKPT, the flow tracker, and `--repaint true` (the first
    frame generated natively from its luminance depth, then the video from
    synthetic tracks). JAX's chain (the same functions on the same frames,
    weights and noise) gives the same tracks and video."""
    from flexam_tpu import demo as jdemo
    from flexam_tpu.perception.depth import estimate_depth
    from flexam_tpu.repaint import FirstFrameRepainter, make_flexam_repaint_fn
    jp, tp = pipes
    path, video, _ = clip
    monkeypatch.setattr(tdemo, "_build_models", lambda args: tp)
    seen = {}

    def spy(orig):
        def run(*a, **k):
            seen["tracks"] = orig(*a, **k)
            return seen["tracks"]
        return run
    # the DELTA branch dispatches; the flow branch runs the Farneback
    # tracker, as JAX's demo does
    monkeypatch.setattr(ttrack, "dispatch_tracking",
                        spy(ttrack.dispatch_tracking))
    monkeypatch.setattr(ttrack, "track_video_flow",
                        spy(ttrack.track_video_flow))
    argv = ["--prompt", "a test scene", "--platform", "cpu",
            "--random_init", "tiny", "--sample_size", str(H), str(W),
            "--video_length", str(T), "--num_inference_steps", "2",
            "--density", str(DENSITY), "--seed", "3", "--input_path", path,
            "--generate_type", "full_edit",
            "--output_dir", str(tmp_path / "port")]
    if mode == "repaint":
        argv += ["--repaint", "true", "--synthetic_tracks"]
    else:
        argv += ["--tracking_method", mode]
    got = tdemo.main(argv)

    first = video[:, :, :1]
    if mode == "repaint":
        rp = FirstFrameRepainter(
            H, W, str(tmp_path / "jax"),
            depth_fn=lambda img: estimate_depth(
                (np.asarray(img, np.float32) / 255.0)[None])[0],
            repaint_fn=make_flexam_repaint_fn(jp, seed=3))
        first = rp.repaint(video[0, :, 0], "a test scene",
                           num_inference_steps=2)[:, :, 0][:, :, None]
        tracks = jdemo._synthetic_grid_tracks(T, H, W, DENSITY)
        assert np.load(tmp_path / "port" / "temp_repainted.npy").shape == (
            H, W, 3)
    else:
        tracks = (jtrack.track_video_flow(video, density=DENSITY)
                  if mode == "flow" else
                  jtrack.dispatch_tracking(video, "delta", density=DENSITY))
        _same_tracks(seen["tracks"], tracks)
    want = _jax_apply_tracks(jp, *tracks, first, tmp_path)
    assert got.shape == (1, 3, T, H, W)
    np.testing.assert_allclose(got, np.asarray(want), **U8)


def test_demo_still_raises_for_unported_models(pipes, clip, tiny_loaders,
                                               monkeypatch, tmp_path):
    """FLUX, MoGe, VGGT and Pi3 run (`tests/test_torch_repaint_flux.py`
    and `tests/test_torch_{moge,vggt,pi3}.py` hold them to JAX): a
    checkpoint variable naming no file raises FileNotFoundError from their
    loaders, as JAX's."""
    path, _, _ = clip
    monkeypatch.setattr(tdemo, "_build_models", lambda args: pipes[1])
    base = ["--prompt", "x", "--platform", "cpu", "--random_init", "tiny",
            "--sample_size", str(H), str(W), "--video_length", str(T),
            "--num_inference_steps", "1", "--density", str(DENSITY),
            "--input_path", path, "--output_dir", str(tmp_path)]
    monkeypatch.setenv("FLEXAM_FLUX_CKPT", "flux.safetensors")
    monkeypatch.setenv("FLEXAM_FLUX_AE", "ae.safetensors")
    with pytest.raises(FileNotFoundError, match="flux.safetensors"):
        tdemo.main(base + ["--repaint", "true", "--synthetic_tracks"])
    monkeypatch.delenv("FLEXAM_FLUX_AE")
    monkeypatch.delenv("FLEXAM_FLUX_CKPT")
    for env in ("FLEXAM_VGGT_CKPT", "FLEXAM_PI3_CKPT"):
        monkeypatch.setenv(env, "x")
        with pytest.raises(FileNotFoundError, match="'x'"):
            tdemo.main(base + ["--tracking_method", "flow",
                               "--camera_motion", "trans 0.1 0 0"])
        monkeypatch.delenv(env)
    monkeypatch.setenv("FLEXAM_MOGE_CKPT", "x")
    np.save(tmp_path / "img.npy", np.zeros((H, W, 3), np.uint8))
    with pytest.raises(FileNotFoundError, match="'x'"):
        tdemo.main(base[:-4] + ["--input_path", str(tmp_path / "img.npy"),
                                "--output_dir", str(tmp_path)])


def test_serve_track_method_matches_jax(pipes, clip, tiny_loaders):
    """A bare clip posted with `track_method: "flow"`: the server tracks it
    on the pipeline's device and anchors full_edit on the clip's first
    frame, as JAX's server does."""
    jp, tp = pipes
    _, video, _ = clip
    payload = {"prompt": "a test scene",
               "video": tserve._encode_array(video), "track_method": "flow",
               "track_density": DENSITY, "num_inference_steps": 2,
               "guidance_scale": 6.0, "seed": 3, "density": 1.0 / DENSITY}
    jout = jserve.GenerationServer(jp).handle(dict(payload))
    tout = tserve.GenerationServer(tp).handle(dict(payload))
    jv = jserve._decode_array(jout["video"]).astype(np.int16)
    tv = tserve._decode_array(tout["video"]).astype(np.int16)
    assert tv.shape == jv.shape == (1, 3, T, H, W)
    assert np.abs(tv - jv).max() <= 1


def test_verify_ckpt_delta_matches_jax(tiny_loaders, tmp_path, capsys):
    """`verify_ckpt --model delta`: the tiny checkpoint passes, half of it
    fails the coverage bar, in both tools."""
    from flexam_tpu.tools import verify_ckpt as jvc
    from flexam_tpu_torch.tools import verify_ckpt as tvc
    assert tvc.verify("delta", tiny_loaders, "cpu") is True
    assert jvc.verify("delta", tiny_loaders) is True
    sd = torch.load(tiny_loaders, weights_only=True)["model"]
    half = str(tmp_path / "half.pth")
    torch.save(dict(list(sd.items())[: len(sd) // 2]), half)
    assert tvc.main(["--model", "delta", "--platform", "cpu", half]) == 1
    assert jvc.verify("delta", half) is False
    assert "delta[" in capsys.readouterr().out


def test_slice_end_to_end_matches_jax(pipes, clip, tmp_path, monkeypatch):
    """The slice as a whole: the clip's depth from UniDepth V2, DELTA
    tracks on it, then apply_tracks (1 step, JAX's noise), in each
    package on the same weights."""
    from flexam_tpu.perception import unidepth as jud
    from flexam_tpu_torch.perception import unidepth as tud
    from tests.test_torch_unidepth import _jax_tree as ud_jax_tree
    from tests.test_unidepth import TINY as UD_TINY
    jp, tp = pipes
    _, video, _ = clip
    tcfg = tud.UniDepthV2Config(**UD_TINY)
    jparams = ud_jax_tree(tud.UniDepthV2(tcfg, seed=8, device="cpu").params)
    jdepth_model = jud.UniDepthV2(jud.UniDepthV2Config(**UD_TINY),
                                  params=jparams)
    tdepth_model = tud.UniDepthV2(tcfg, params=from_jax_params(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu"), device="cpu")
    tdelta = tdt.DenseTrack3D(**DT_TINY, seed=9, device="cpu")
    jdelta = jdt.DenseTrack3D.__new__(jdt.DenseTrack3D)
    jdelta.cfg = jdt.DenseTrack3DConfig(**DT_TINY)
    jdelta.params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a.transpose(2, 3, 1, 0) if a.ndim == 4 else a),
        jax.tree_util.tree_map(lambda t: t.numpy(), tdelta.params))
    tdelta.params = from_jax_params(
        jax.tree_util.tree_map(np.asarray, jdelta.params), "cpu")
    # the registry's unidepth backend, handed each package's model
    monkeypatch.setattr(jud, "_BACKEND_CACHE", {
        ("__random__"): jdepth_model})
    monkeypatch.setattr(tud, "_BACKEND_CACHE", {
        ("__random__", "cpu"): tdepth_model})
    monkeypatch.delenv("FLEXAM_UNIDEPTH_CKPT", raising=False)
    want = jtrack.track_video_delta(video, density=DENSITY, model=jdelta,
                                    depth_backend="unidepth")
    got = ttrack.track_video_delta(video, density=DENSITY, model=tdelta,
                                   depth_backend="unidepth")
    _same_tracks(got, want)
    first = video[:, :, :1]
    jv = _jax_apply_tracks(jp, *want, first, tmp_path, seed=4, steps=1)
    tv = torch_orch.FlexAMOrchestrator(
        tp, output_dir=str(tmp_path / "port"), save_tracking=False
    ).apply_tracks(*got, H, W, prompt="a test scene", point_wise=4,
                   generate_type="full_edit", first_frame=first,
                   density=1.0 / DENSITY, num_inference_steps=1,
                   guidance_scale=6.0, seed=4)
    np.testing.assert_allclose(tv, np.asarray(jv), **U8)
