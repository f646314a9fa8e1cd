"""The CLI slice on the card: checkpoint loading onto CUDA (the loaders and
`tools.verify_ckpt`'s default), the foreground mask's dilation on the
device, TeaCache's kernel launches, a resumed denoise, and `demo
--random_init tiny` / `serving_bench --tiny` (head_dim 24, through the
dispatcher's exact branch).

These need a CUDA device and skip without one. On a machine with an H100:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cli_cuda.py

The pipeline is the tiny config widened to head_dim 128 (dim 256, 2 heads),
the width the attention kernels take, in bf16; the two tiny runs keep
head_dim 24.
"""

import dataclasses

import numpy as np
import pytest
import torch

from flexam_tpu_torch.config import tiny_test_config
from flexam_tpu_torch.io import checkpoints as ck
from flexam_tpu_torch.models.dit import init_dit_params
from flexam_tpu_torch.models.t5 import init_t5_params
from flexam_tpu_torch.models.vae import init_vae_params
from flexam_tpu_torch.ops import launch_counts, reset_launch_counts
from flexam_tpu_torch.pipeline import FlexAMGenerationPipeline, FlexAMModels
from flexam_tpu_torch.utils.masks import generate_mask_fg_tracking

pytestmark = pytest.mark.cuda

T, H, W = 9, 64, 64


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cfg():
    cfg = tiny_test_config()
    return dataclasses.replace(cfg, dit=dataclasses.replace(
        cfg.dit, dim=256, ffn_dim=512, num_heads=2))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _assert_same(got, want, device):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].device.type == device, k
        assert g[k].dtype == w[k].dtype, k
        assert torch.equal(g[k].cpu(), w[k].cpu()), k


def test_loaders_onto_the_card(dev, tmp_path):
    """Files written from random bf16 trees load onto CUDA leaf for leaf as
    they load on the CPU."""
    cfg = _cfg()
    dit = init_dit_params(cfg.dit, seed=1, dtype=torch.bfloat16, device="cpu")
    sd = ck.dit_state_dict(dit)
    keys = sorted(sd)
    for i, part in enumerate((keys[::2], keys[1::2])):
        ck.save_safetensors(str(tmp_path / f"dit-{i}.safetensors"),
                            {k: sd[k] for k in part})
    vae = init_vae_params(cfg.vae, seed=2, dtype=torch.bfloat16, device="cpu")
    torch.save(ck.vae_state_dict(vae, cfg.vae), str(tmp_path / "vae.pth"))
    t5 = init_t5_params(cfg.t5, seed=3, dtype=torch.bfloat16, device="cpu")
    torch.save(ck.t5_state_dict(t5), str(tmp_path / "t5.pth"))
    for load, args, kw in (
            (ck.load_dit_checkpoint, (str(tmp_path), cfg.dit),
             dict(matrix_dtype=torch.bfloat16)),
            (ck.load_vae_checkpoint, (str(tmp_path / "vae.pth"), cfg.vae), {}),
            (ck.load_t5_checkpoint, (str(tmp_path / "t5.pth"), cfg.t5), {})):
        _assert_same(load(*args, device="cuda", **kw),
                     load(*args, device="cpu", **kw), "cuda")
    got = ck.load_dit_checkpoint(str(tmp_path), cfg.dit, device="cuda",
                                 matrix_dtype=torch.bfloat16)
    assert torch.equal(got["blocks"][1]["ffn"]["fc1"]["weight"].cpu(),
                       dit["blocks"][1]["ffn"]["fc1"]["weight"])


def write_tiny_checkpoints(tmp_path):
    """Reference-format dit / vae / t5 files of the tiny config, written
    from random bf16 trees: {kind: path}."""
    cfg = tiny_test_config()
    kw = dict(dtype=torch.bfloat16, device="cpu")
    d = tmp_path / "tiny_transformer"
    d.mkdir()
    ck.save_safetensors(str(d / "model.safetensors"), ck.dit_state_dict(
        init_dit_params(cfg.dit, seed=1, **kw)))
    torch.save(ck.vae_state_dict(init_vae_params(cfg.vae, seed=2, **kw),
                                 cfg.vae), str(tmp_path / "tiny_vae.pth"))
    torch.save(ck.t5_state_dict(init_t5_params(cfg.t5, seed=3, **kw)),
               str(tmp_path / "tiny_t5.pth"))
    return cfg, {"dit": str(d), "vae": str(tmp_path / "tiny_vae.pth"),
                 "t5": str(tmp_path / "tiny_t5.pth")}


@pytest.mark.parametrize("kind", ["dit", "vae", "t5"])
def test_verify_ckpt_loads_onto_the_card(dev, tmp_path, monkeypatch, kind):
    """`tools.verify_ckpt` with no `--platform` loads onto CUDA (the tool's
    config swapped for the tiny one) and passes a full file."""
    import flexam_tpu_torch.config as tcfg
    from flexam_tpu_torch.tools import verify_ckpt
    cfg, paths = write_tiny_checkpoints(tmp_path)
    monkeypatch.setattr(tcfg, "FlexAMConfig", lambda: cfg)
    loader = {"dit": "load_dit_checkpoint", "vae": "load_vae_checkpoint",
              "t5": "load_t5_checkpoint"}[kind]
    loaded = []
    orig = getattr(ck, loader)
    monkeypatch.setattr(ck, loader, lambda *a, **kw: loaded.append(
        orig(*a, **kw)) or loaded[-1])
    assert verify_ckpt.verify(kind, paths[kind]) is True
    assert verify_ckpt.main(["--model", kind, paths[kind]]) == 0
    assert len(loaded) == 2
    for tree in loaded:
        assert {t.device.type for _, t in _leaves(tree)} == {"cuda"}


def test_fg_mask_dilation_on_the_card(dev):
    rng = np.random.RandomState(0)
    mv = np.zeros((4, 3, 96, 128), np.float32)
    for i in range(4):
        y, x = rng.randint(10, 80), rng.randint(10, 110)
        mv[i, :, y:y + 12, x:x + 15] = 1.0
        mv[i, :, 5:9, 100:127] = 1.0
    for r in (5, 40, 200):
        np.testing.assert_array_equal(
            generate_mask_fg_tracking(mv, dilation_pixels=r, device="cuda"),
            generate_mask_fg_tracking(mv, dilation_pixels=r, device="cpu"))


@pytest.fixture
def pipe(dev):
    cfg = _cfg()
    models = FlexAMModels(
        cfg=cfg,
        dit_params=init_dit_params(cfg.dit, seed=4, dtype=torch.bfloat16,
                                   device=dev),
        vae_params=init_vae_params(cfg.vae, seed=5, dtype=torch.bfloat16,
                                   device=dev))
    return FlexAMGenerationPipeline(models, device=dev)


def _cond(pipe):
    g = torch.Generator(device="cuda").manual_seed(6)
    video = torch.rand((1, 3, T, H, W), generator=g, device="cuda")
    mask = torch.ones((1, 1, T, H, W), device="cuda")
    mask[:, :, 0] = 0.0
    return pipe.prepare_conditioning(video, mask, video, video, None,
                                     video[:, :, :1])


def test_teacache_launches(pipe):
    """With a huge threshold only the first teacache_skip_start forwards
    run the blocks: each computed forward launches, in every block, one
    self-attention and one cross-attention (B2 for both at this size: all
    keys fit one block) and two B3 and two B4 calls."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cond = _cond(pipe)
    ctx = torch.randn((2, 16, 64), device="cuda").to(torch.bfloat16)
    layers = pipe.cfg.dit.num_layers
    reset_launch_counts()
    lat = pipe.denoise(cond, ctx, num_inference_steps=5, guidance_scale=6.0,
                       teacache_thresh=1e9, teacache_skip_start=2)
    counts = launch_counts()
    assert bool(lat.isfinite().all())
    assert pipe.last_denoise_info == {"steps": 5,
                                      "teacache_computed_forwards": 2.0,
                                      "teacache_skipped_forwards": 3.0}
    attention = counts["flash_attention"] + counts["single_kv_attention"]
    assert attention == 2 * 2 * layers, counts
    assert counts["rmsnorm_rope"] == 2 * 2 * layers, counts
    assert counts["ln_mod_binary"] == 2 * 2 * layers, counts


def test_resume_equals_uninterrupted(pipe):
    """Snapshots after steps 1 and 3 of 4 (2 steps a chunk); resuming from
    step 1 gives the uninterrupted latents bit for bit (the kernels are
    deterministic tile by tile)."""
    cond = _cond(pipe)
    ctx = torch.randn((2, 16, 64), device="cuda").to(torch.bfloat16)
    pipe.steps_per_launch = 2
    kw = dict(num_inference_steps=4, guidance_scale=6.0, seed=7, density=0.1)
    snaps = {}
    full = pipe.denoise(cond, ctx, **kw,
                        checkpoint_cb=lambda s, snap: snaps.update({s: snap}))
    assert sorted(snaps) == [1, 3]
    resumed = pipe.denoise(cond, ctx, resume=snaps[1], **kw)
    assert torch.equal(resumed, full)


def test_demo_tiny_on_the_card(dev, tmp_path):
    """`demo --random_init tiny` on CUDA: head_dim 24 runs through the
    dispatcher's exact branch, and no attention kernel launches."""
    from flexam_tpu_torch.core.attention import exact_calls
    from flexam_tpu_torch.demo import main
    reset_launch_counts()
    calls = exact_calls["exact_attention"]
    out = main(["--prompt", "a test scene", "--random_init", "tiny",
                "--sample_size", "32", "32", "--video_length", "9",
                "--num_inference_steps", "2", "--density", "8",
                "--generate_type", "full_edit", "--synthetic_tracks",
                "--output_dir", str(tmp_path)])
    assert out.shape == (1, 3, 9, 32, 32) and np.isfinite(out).all()
    # self- and cross-attention in each of 2 blocks, 2 CFG steps
    assert exact_calls["exact_attention"] - calls == 2 * 2 * 2
    assert launch_counts()["flash_attention"] == 0


def test_serving_bench_tiny_on_the_card(dev):
    """`serving_bench --tiny` on CUDA (the refusal is gone): one run."""
    import contextlib
    import io

    from flexam_tpu_torch.core.attention import exact_calls
    from flexam_tpu_torch.tools import serving_bench
    calls = exact_calls["exact_attention"]
    with contextlib.redirect_stdout(io.StringIO()):
        recs, summary = serving_bench.main(
            ["--tiny", "--steps", "1", "--size", "32", "32", "--frames", "9",
             "--mode", "bf16", "--runs", "1"])
    assert recs[0]["video_shape"] == [1, 3, 9, 32, 32]
    assert recs[0]["latents_finite"]
    assert exact_calls["exact_attention"] > calls
