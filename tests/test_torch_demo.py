"""The demo modes of `tests/test_demo_modes.py`, driven through the port's
`flexam_tpu_torch.demo.main` with `--platform cpu` at tiny geometry:
full_edit (device path and host path with artifacts), foreground_edit,
background_edit, camera + object motion, the MoGe image path and camera
control with solved poses. Each produces its result at the right shape,
deterministically under one seed (two runs, equal), the native repaint
(`--repaint true`) and the flow tracker with camera motion included
(`tests/test_torch_video_tracking.py` holds them to JAX). The quantized modes
(`--quant int8|fp8`, FLEXAM_QUANT, `--prequant`) run, deterministically;
with `--checkpoint_path` the DiT is quantized from the checkpoint's float32
values as it loads, and equals the JAX CLI's quantized host tree exactly
(int8 weights and float32 scales, e4m3 bytes, the bf16 rest).

The fixtures are the JAX test's, in the formats the port reads without a
decoder: the input and mask videos as `.npz` frame dumps, the repaint and
object-mask images as `.npy`.
"""

import os

import numpy as np
import pytest
import torch

from flexam_tpu_torch.demo import main
from flexam_tpu_torch.utils.media import read_video_frames


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
BASE = ["--prompt", "a test scene", "--platform", "cpu",
        "--random_init", "tiny", "--sample_size", str(H), str(W),
        "--video_length", str(T), "--num_inference_steps", "2",
        "--density", "8", "--seed", "3"]


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_demo_fixtures")
    rng = np.random.RandomState(0)

    video = rng.rand(1, 3, T, H, W).astype(np.float32)
    video_path = str(d / "input.npz")
    np.savez(video_path, video=(video[0].transpose(1, 2, 3, 0) * 255
                                ).astype(np.uint8), fps=8)

    mask = np.zeros((T, H, W, 3), np.uint8)
    mask[:, H // 4: 3 * H // 4, W // 4: 3 * W // 4] = 255
    mask_path = str(d / "mask.npz")
    np.savez(mask_path, video=mask, fps=8)

    repaint_path = str(d / "repaint.npy")
    np.save(repaint_path, rng.randint(0, 255, (H, W, 3), dtype=np.uint8))
    omask_path = str(d / "omask.npy")
    om = np.zeros((H, W), np.uint8)
    om[H // 4: 3 * H // 4, W // 4: 3 * W // 4] = 255
    np.save(omask_path, om)

    n = 40
    base = np.stack([rng.uniform(2, W - 2, n), rng.uniform(2, H - 2, n),
                     rng.uniform(1.0, 3.0, n)], axis=1)
    drift = rng.uniform(-0.5, 0.5, (T, 1, 3)).cumsum(0)
    tracks = (base[None] + drift).astype(np.float32)
    vis = np.ones((T, n), bool)
    extr = np.tile(np.eye(3, 4, dtype=np.float32), (T, 1, 1))
    extr[:, 2, 3] = 4.0
    intr = np.tile(np.array([[24.0, 0, W / 2], [0, 24.0, H / 2],
                             [0, 0, 1]], np.float32), (T, 1, 1))
    tracks_path = str(d / "tracks.npz")
    np.savez(tracks_path, tracks=tracks, visibility=vis,
             extrinsics=extr, intrinsics=intr)
    no_pose_path = str(d / "tracks_noposes.npz")
    np.savez(no_pose_path, tracks=tracks, visibility=vis)

    pts = np.stack(np.meshgrid(np.linspace(0.1, 0.9, H),
                               np.linspace(0.1, 0.9, W),
                               indexing="ij"), axis=-1)
    moge_points = np.concatenate(
        [pts[..., ::-1], np.full((H, W, 1), 2.0)], axis=-1
    ).astype(np.float32)
    moge_path = str(d / "moge.npz")
    np.savez(moge_path, points=moge_points, mask=np.ones((H, W), bool),
             intrinsics=intr[0])

    return dict(video=video_path, mask=mask_path, repaint=repaint_path,
                omask=omask_path, tracks=tracks_path, moge=moge_path,
                no_poses=no_pose_path)


def _run_twice(args, tmp_path, name, expect_artifacts=False):
    """Two runs of the same command: the result at [1, 3, T, H, W] in
    [0, 1], written to result.mp4 (or its .npz dump), the same both times."""
    outs = []
    for i in range(2):
        outdir = str(tmp_path / f"{name}_{i}")
        out = main(args + ["--output_dir", outdir])
        files = os.listdir(outdir)
        result = [f for f in files if f.startswith("result.mp4")]
        assert result, files
        assert out.shape == (1, 3, T, H, W)
        assert np.isfinite(out).all() and out.min() >= 0 and out.max() <= 1
        if result[0].endswith(".npz"):
            frames, _ = read_video_frames(os.path.join(outdir, result[0]))
            assert frames.shape == (T, H, W, 3)
        if expect_artifacts:
            for f in ("tracking_video_delta.mp4", "depth_video_delta.mp4",
                      "delta_cos_i_0.mp4", "delta_cos_i_3.mp4"):
                assert any(x.startswith(f) for x in files), (f, files)
        outs.append(out)
    np.testing.assert_array_equal(outs[0], outs[1])


def test_full_edit_synthetic(fixtures, tmp_path):
    _run_twice(BASE + ["--generate_type", "full_edit", "--synthetic_tracks",
                       "--input_path", fixtures["video"]], tmp_path, "full")


def test_full_edit_host_rasterize(fixtures, tmp_path):
    """The host rasterizer path, with its artifact videos."""
    _run_twice(BASE + ["--generate_type", "full_edit", "--synthetic_tracks",
                       "--input_path", fixtures["video"], "--host_rasterize"],
               tmp_path, "full_host", expect_artifacts=True)


def test_foreground_edit(fixtures, tmp_path):
    _run_twice(BASE + ["--generate_type", "foreground_edit",
                       "--input_path", fixtures["video"],
                       "--mask_path", fixtures["mask"],
                       "--repaint", fixtures["repaint"],
                       "--tracks_npz", fixtures["tracks"]], tmp_path, "fg")


def test_background_edit(fixtures, tmp_path):
    _run_twice(BASE + ["--generate_type", "background_edit",
                       "--input_path", fixtures["video"],
                       "--mask_path", fixtures["mask"],
                       "--repaint", fixtures["repaint"],
                       "--tracks_npz", fixtures["tracks"]], tmp_path, "bg")


def test_camera_and_object_composition(fixtures, tmp_path):
    _run_twice(BASE + ["--generate_type", "full_edit",
                       "--input_path", fixtures["video"],
                       "--tracks_npz", fixtures["tracks"],
                       "--camera_motion", "trans 0.1 0 0.2; rot y 10",
                       "--object_motion", "up",
                       "--object_mask", fixtures["omask"]],
               tmp_path, "cam_obj")


def test_moge_image_path(fixtures, tmp_path):
    _run_twice(BASE + ["--input_path", fixtures["repaint"],
                       "--moge_npz", fixtures["moge"],
                       "--camera_motion", "trans 0 0 0.3"], tmp_path, "moge")


def test_camera_with_solved_poses(fixtures, tmp_path, capsys):
    _run_twice(BASE + ["--generate_type", "full_edit",
                       "--input_path", fixtures["video"],
                       "--tracks_npz", fixtures["no_poses"],
                       "--camera_motion", "trans 0.05 0 0.1"],
               tmp_path, "solved")
    assert "solving camera poses from tracks" in capsys.readouterr().out


def test_repaint_native(fixtures, tmp_path):
    """`--repaint true`: the first frame generated by the FlexAM model from
    its depth (the native repaint), then full_edit; the repainted frame is
    written beside the result."""
    _run_twice(BASE + ["--generate_type", "full_edit",
                       "--input_path", fixtures["video"],
                       "--synthetic_tracks", "--repaint", "true"],
               tmp_path, "rp")
    assert (tmp_path / "rp_0" / "temp_repainted.npy").exists()


def test_full_native_video_path(fixtures, tmp_path):
    """The built-in flow tracker on the input video, with camera motion
    from poses solved on its tracks."""
    _run_twice(BASE + ["--generate_type", "full_edit",
                       "--input_path", fixtures["video"],
                       "--tracking_method", "flow",
                       "--camera_motion", "trans 0.05 0 0.1"],
               tmp_path, "native")


@pytest.mark.parametrize("extra,env,error,match", [
    (["--quant", "int4"], {}, SystemExit, "2"),
    ([], {"FLEXAM_QUANT": "fp4"}, ValueError, "quant"),
    (["--camera_motion", "trans 0.1 0 0"], {"FLEXAM_VGGT_CKPT": "x"},
     FileNotFoundError, "'x'"),
    (["--platform", "tpu"], {}, ValueError, "cuda"),
], ids=["quant", "env_quant", "vggt", "platform"])
def test_refusals(fixtures, tmp_path, monkeypatch, extra, env, error, match):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    argv = BASE + ["--tracks_npz", fixtures["no_poses"],
                   "--output_dir", str(tmp_path / "x")] + extra
    with pytest.raises(error, match=match):
        main(argv)


@pytest.mark.parametrize("extra,env", [
    (["--quant", "int8"], {}),
    (["--quant", "fp8"], {}),
    ([], {"FLEXAM_QUANT": "int8"}),
], ids=["int8", "fp8", "env_int8"])
def test_quant_runs(fixtures, tmp_path, monkeypatch, extra, env):
    """The quantized DiT modes run end to end, deterministically, and the
    pipeline holds the quantized tree."""
    from flexam_tpu_torch import demo

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    built = []
    build = demo._build_models
    monkeypatch.setattr(demo, "_build_models",
                        lambda args: built.append(build(args)) or built[-1])
    _run_twice(BASE + ["--generate_type", "full_edit", "--synthetic_tracks",
                       "--input_path", fixtures["video"]] + extra,
               tmp_path, "q")
    mode = extra[1] if extra else env["FLEXAM_QUANT"]
    assert built[0].quant == mode
    fc1 = built[0].models.dit_params["blocks"][0]["ffn"]["fc1"]
    assert (fc1["weight_q"].dtype == torch.int8 if mode == "int8"
            else fc1["weight"].dtype == torch.float8_e4m3fn)


def test_prequant_run(fixtures, tmp_path):
    """`--prequant` with a file from tools/prequant_ckpt runs end to end."""
    from flexam_tpu_torch.tools.prequant_ckpt import main as prequant_main

    path = str(tmp_path / "tiny_int8.npz")
    assert prequant_main(["--checkpoint", "random:tiny", "--mode", "int8",
                          "--out", path]) == 0
    _run_twice(BASE + ["--generate_type", "full_edit", "--synthetic_tracks",
                       "--input_path", fixtures["video"],
                       "--prequant", path], tmp_path, "pq")


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_checkpoint_quant_matches_jax_host_tree(tmp_path, monkeypatch, mode):
    """`--checkpoint_path` with `--quant`: the DiT the port builds equals
    the JAX CLI's (its float32 host tree quantized, then uploaded by
    `_put_quantized`) leaf for leaf in dtype and bytes. Quantizing after the
    bf16 cast would give other int8 values and e4m3 bytes."""
    import sys
    import types

    import jax

    import flexam_tpu.config as jcfg_mod
    import flexam_tpu_torch.config as tcfg
    from flexam_tpu import pipeline as jpipe
    from flexam_tpu.io.checkpoints import load_dit_checkpoint as jload
    from flexam_tpu.ops.qlinear import convert_dit_to_int8 as jint8
    from flexam_tpu.utils.fp8 import convert_weights_to_fp8 as jfp8
    from flexam_tpu_torch import demo
    from flexam_tpu_torch.io import checkpoints as ck
    from flexam_tpu_torch.models.dit import init_dit_params
    from flexam_tpu_torch.models.t5 import init_t5_params
    from flexam_tpu_torch.models.vae import init_vae_params

    cfg = tcfg.tiny_test_config()
    ck.save_safetensors(str(tmp_path / "model.safetensors"), ck.dit_state_dict(
        init_dit_params(cfg.dit, seed=5, dtype=torch.float32, device="cpu")))
    torch.save(ck.vae_state_dict(init_vae_params(cfg.vae, seed=6, device="cpu",
                                                 dtype=torch.float32), cfg.vae),
               str(tmp_path / "Wan2.2_VAE.pth"))
    torch.save(ck.t5_state_dict(init_t5_params(cfg.t5, seed=7, device="cpu",
                                               dtype=torch.float32)),
               str(tmp_path / "models_t5_umt5-xxl-enc-bf16.pth"))
    stub = types.ModuleType("transformers")
    stub.AutoTokenizer = types.SimpleNamespace(
        from_pretrained=lambda path: None)
    monkeypatch.setitem(sys.modules, "transformers", stub)
    monkeypatch.setattr(tcfg, "WAN22_5B_FLEXAM", cfg)
    args = demo.build_argparser().parse_args(
        ["--prompt", "x", "--platform", "cpu", "--checkpoint_path",
         str(tmp_path), "--quant", mode])
    pipe = demo._build_models(args)
    assert pipe.compute_dtype == torch.bfloat16

    host = jload(str(tmp_path), jcfg_mod.tiny_test_config().dit,
                 dtype=np.float32)
    ref = jax.tree_util.tree_map(np.asarray, jpipe._put_quantized(
        (jint8 if mode == "int8" else jfp8)(host)))

    def check(port, j, layer=None):
        if isinstance(port, dict):
            assert set(port) == set(j)
            for k, v in port.items():
                check(v, j[k], layer)
        elif isinstance(port, list):
            for i, v in enumerate(port):
                check(v, j, i)
        else:
            a = np.asarray(j if layer is None else j[layer])
            assert str(port.dtype).replace("torch.", "") == str(a.dtype)
            if port.element_size() == 1:
                assert port.contiguous().view(torch.uint8).numpy().tobytes() \
                    == a.view(np.uint8).tobytes()
            else:
                np.testing.assert_array_equal(port.float().numpy(),
                                              a.astype(np.float32))
    check(pipe.models.dit_params, ref)


def test_checkpoint_path_branch(fixtures, tmp_path, monkeypatch):
    """`--checkpoint_path` end to end at tiny size: reference-format files
    (DiT shards, Wan2.2_VAE.pth, the umT5 .pth) written from random trees,
    the config constant pointed at the tiny config, and a stand-in for
    `transformers.AutoTokenizer` (the repo has no tokenizer files). The
    pipeline gets the loaded weights, `t5_from_checkpoint` and the
    tokenizer, and the run is deterministic."""
    import sys
    import types

    import torch

    import flexam_tpu_torch.config as tcfg
    from flexam_tpu_torch import demo
    from flexam_tpu_torch.io import checkpoints as ck
    from flexam_tpu_torch.models.dit import init_dit_params
    from flexam_tpu_torch.models.t5 import init_t5_params
    from flexam_tpu_torch.models.vae import init_vae_params

    cfg = tcfg.tiny_test_config()
    ck.save_safetensors(str(tmp_path / "model.safetensors"), ck.dit_state_dict(
        init_dit_params(cfg.dit, seed=5, dtype=torch.float32, device="cpu")))
    torch.save(ck.vae_state_dict(init_vae_params(cfg.vae, seed=6, device="cpu",
                                                 dtype=torch.float32), cfg.vae),
               str(tmp_path / "Wan2.2_VAE.pth"))
    torch.save(ck.t5_state_dict(init_t5_params(cfg.t5, seed=7, device="cpu",
                                               dtype=torch.float32)),
               str(tmp_path / "models_t5_umt5-xxl-enc-bf16.pth"))

    class Tokenizer:
        def __call__(self, prompts, max_length, return_tensors, **kw):
            assert return_tensors == "np"
            ids = np.zeros((len(prompts), max_length), np.int64)
            for i, p in enumerate(prompts):
                raw = [3 + ord(c) % 200 for c in p][:max_length - 1] + [1]
                ids[i, :len(raw)] = raw
            return {"input_ids": ids, "attention_mask": (ids > 0).astype(int)}

    loaded = []
    stub = types.ModuleType("transformers")
    stub.AutoTokenizer = types.SimpleNamespace(
        from_pretrained=lambda path: loaded.append(path) or Tokenizer())
    monkeypatch.setitem(sys.modules, "transformers", stub)
    monkeypatch.setattr(tcfg, "WAN22_5B_FLEXAM", cfg)
    built = []
    build = demo._build_models
    monkeypatch.setattr(demo, "_build_models",
                        lambda args: built.append(build(args)) or built[-1])
    argv = [a for a in BASE if a not in ("--random_init", "tiny")]
    outs = [main(argv + ["--checkpoint_path", str(tmp_path),
                         "--synthetic_tracks",
                         "--output_dir", str(tmp_path / f"out{i}")])
            for i in range(2)]
    assert outs[0].shape == (1, 3, T, H, W)
    np.testing.assert_array_equal(outs[0], outs[1])
    pipe = built[0]
    assert pipe.models.t5_from_checkpoint and pipe.tokenizer is not None
    assert loaded[0].endswith("google/umt5-xxl")
    assert pipe.models.dit_params["blocks"][0]["modulation"].dtype == \
        torch.bfloat16
