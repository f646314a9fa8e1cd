"""The port's FLUX.1-Depth repaint (`flexam_tpu_torch/repaint_flux.py`)
against the JAX package's, on the CPU at JAX's tiny geometry (fp32), with
the trees crossed through `io.convert.from_jax_params` and JAX's noise
(`jax.random.normal(PRNGKey(seed))`) handed across as `latents=`; the
loaders on files the port's writers put in the BFL / `ae` names; the demo's
`--repaint true` branch under FLEXAM_FLUX_CKPT / FLEXAM_FLUX_AE.

Bounds: the control tokens and the text features at rtol 2e-4 / atol
1e-5; the repainted uint8 image within one level of JAX's (the float
image is truncated to uint8 on both sides, so a value at a level's edge
may land on either side). The tiny transformer carries t * 1000 through
exp, whose one-ulp differences between XLA and torch move the forward by
5e-5 of its size (`tests/test_torch_flux.py`); four steps keep that below
one level.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexam_tpu import repaint_flux as JR
from flexam_tpu.models import flux as JF
from flexam_tpu.models import flux_vae as JV
from flexam_tpu_torch import repaint_flux as TR
from flexam_tpu_torch.io.checkpoints import save_safetensors
from flexam_tpu_torch.models import flux as TF
from flexam_tpu_torch.models import flux_vae as TV
from tests.test_torch_flux import close, crossed, randomize, to_jax

H, W = 16, 24


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """(JAX repainter, port repainter) over the same random tiny trees."""
    cfg_t, vcfg_t = TF.FluxConfig.tiny(32), TV.FluxVAEConfig.tiny()
    flux = randomize(TF.init_flux_params(cfg_t, seed=0, device="cpu"), 3)
    vae = randomize(TV.init_flux_vae_params(vcfg_t, seed=1, device="cpu"),
                    4, scale=0.02)
    jflux, jvae = to_jax(flux), to_jax(vae, conv=True)
    jr = JR.FluxDepthRepainter(jflux, jvae, cfg=JF.FluxConfig.tiny(32),
                               vae_cfg=JV.FluxVAEConfig.tiny(),
                               dtype=jnp.float32, steps_per_launch=4)
    tr = TR.FluxDepthRepainter(crossed(jflux), crossed(jvae), cfg=cfg_t,
                               vae_cfg=vcfg_t, dtype=torch.float32,
                               device="cpu")
    return jr, tr


def depth_map(h=20, w=28):
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    return np.sin(xx / 4.0) + 0.05 * yy


def jax_noise(seed, h=H, w=W, z=4):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                        (1, z, h // 2, w // 2), jnp.float32))


@pytest.mark.parametrize("control", ["depth", "rgb_u8"])
def test_control_tokens_match_jax(pair, control):
    """Depth (any range, resized antialiased to the image) or an RGB
    control image -> VAE posterior mean -> packed tokens."""
    jr, tr = pair
    ctrl = depth_map()
    if control == "rgb_u8":
        ctrl = (np.random.default_rng(0).uniform(0, 255, (H, W, 3))
                ).astype(np.uint8)
    got = tr.control_tokens(ctrl, H, W)
    c = np.asarray(ctrl, np.float32)
    if c.ndim == 2:
        c = np.repeat(((c - c.min()) / (c.max() - c.min()))[..., None], 3,
                      -1)
    else:
        c = c / 255.0
    if c.shape[:2] != (H, W):
        c = np.asarray(jax.image.resize(jnp.asarray(c), (H, W, 3),
                                        "bilinear"))
    z = JV.flux_vae_encode(jr.vae_params, jr.vae_cfg,
                           jnp.asarray(c * 2.0 - 1.0)[None])
    want = JF.pack_latents(jnp.transpose(z, (0, 3, 1, 2)))
    close(got, want)


@pytest.mark.parametrize("seed,size", [(1, (H, W)), (5, (18, 26))],
                         ids=["exact", "snapped"])
def test_repaint_matches_jax(pair, seed, size):
    """The whole repaint, four steps at guidance 7.5: JAX's noise given as
    `latents`; the size snapped to the VAE x patch multiple as JAX does."""
    jr, tr = pair
    h, w = size
    want = jr("a red house", depth_map(), h, w, num_inference_steps=4,
              seed=seed)
    got = tr("a red house", depth_map(), h, w, num_inference_steps=4,
             latents=jax_noise(seed))
    assert got.shape == want.shape == (H, W, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_repaint_fn_seed_and_guidance(pair, tmp_path):
    """`as_repaint_fn` behind `FirstFrameRepainter`: the port's own noise
    is a function of the seed; guidance and the control image matter."""
    from flexam_tpu_torch.repaint import FirstFrameRepainter
    _, tr = pair
    rp = FirstFrameRepainter(H, W, str(tmp_path), depth_fn=lambda img:
                             depth_map(H, W),
                             repaint_fn=tr.as_repaint_fn(seed=1))
    frame = np.random.default_rng(0).uniform(0, 1, (3, H, W)).astype(
        np.float32)
    out = rp.repaint(frame, "a red house", num_inference_steps=3)
    assert out.shape == (1, 3, 1, H, W) and np.isfinite(out).all()
    saved = np.load(tmp_path / "temp_repainted.npy")
    a = tr("a red house", depth_map(H, W), H, W, 3, seed=1)
    np.testing.assert_array_equal(saved, a)
    assert (tr("a red house", depth_map(H, W), H, W, 3, seed=2) != a).any()
    assert (tr("a red house", depth_map(H, W), H, W, 3, 2.0,
               seed=1) != a).any()
    assert (tr("a red house", depth_map(H, W)[::-1], H, W, 3,
               seed=1) != a).any()


def test_encode_text_matches_jax(pair, monkeypatch):
    """Without towers: JAX's hashed pseudo-features. With tiny T5 v1.1
    and CLIP-L towers: the hashed ids through both encoders; text from a
    checkpoint without a tokenizer is refused, as in JAX."""
    from flexam_tpu.config import T5Config as JT5Config
    from flexam_tpu.models import clip_text as JC
    from flexam_tpu.models import t5 as JT5
    from flexam_tpu_torch.config import T5Config
    from flexam_tpu_torch.models import clip_text as TC
    from flexam_tpu_torch.models.t5 import init_t5_params
    jr, tr = pair
    for a, b in zip(tr.encode_text("a fox"), jr.encode_text("a fox")):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tr._hash_ids("héllo", 8, 50),
                                  jr._hash_ids("héllo", 8, 50))
    t5_kw = dict(vocab=96, dim=32, dim_attn=32, dim_ffn=64, num_heads=4,
                 num_layers=2, num_buckets=8, max_distance=16,
                 shared_pos=True, text_length=12)
    t5 = randomize(init_t5_params(T5Config(**t5_kw), seed=0,
                                  dtype=torch.float32, device="cpu"), 5)
    clip = randomize(TC.init_clip_text_params(TC.CLIPTextConfig.tiny(),
                                              seed=0, device="cpu"), 6)
    jt5 = to_jax(t5)
    jt = JR.FluxDepthRepainter(
        jr.params, jr.vae_params, jt5, to_jax(clip), cfg=jr.cfg,
        vae_cfg=jr.vae_cfg, t5_cfg=JT5Config(**t5_kw),
        clip_cfg=JC.CLIPTextConfig.tiny(), dtype=jnp.float32)
    tt = TR.FluxDepthRepainter(
        tr.params, tr.vae_params, crossed(jt5), crossed(to_jax(clip)),
        cfg=tr.cfg, vae_cfg=tr.vae_cfg, t5_cfg=T5Config(**t5_kw),
        clip_cfg=TC.CLIPTextConfig.tiny(), dtype=torch.float32,
        device="cpu")
    for a, b in zip(tt.encode_text("a fox"), jt.encode_text("a fox")):
        close(a, b)
    tt.text_from_checkpoint = True
    monkeypatch.delenv("FLEXAM_ALLOW_HASHED_IDS", raising=False)
    with pytest.raises(RuntimeError, match="tokenizer"):
        tt.encode_text("a fox")
    monkeypatch.setenv("FLEXAM_ALLOW_HASHED_IDS", "1")
    assert tt.encode_text("a fox")[0].shape == (1, 12, 32)
    assert JT5 is not None


@pytest.fixture(scope="module")
def files(pair, tmp_path_factory):
    """The tiny repainter's transformer and VAE in the BFL / `ae` names."""
    _, tr = pair
    d = tmp_path_factory.mktemp("flux_files")
    paths = {"ckpt": str(d / "flux1-depth-dev.safetensors"),
             "ae": str(d / "ae.safetensors")}
    save_safetensors(paths["ckpt"], TF.flux_state_dict(tr.params, tr.cfg))
    save_safetensors(paths["ae"],
                     TV.flux_vae_state_dict(tr.vae_params, tr.vae_cfg))
    return paths


def test_load_flux_repainter_matches_jax(pair, files, monkeypatch):
    """Both loaders read the port's files (JAX's `_load_one` through
    `safetensors`) into the same trees; the environment names the files
    when the arguments do not."""
    from tests.test_torch_flux import assert_trees_equal
    jr, tr = pair
    kw = dict(cfg=JF.FluxConfig.tiny(32), vae_cfg=JV.FluxVAEConfig.tiny(),
              dtype=jnp.float32)
    jl = JR.load_flux_repainter(files["ckpt"], files["ae"], **kw)
    monkeypatch.setenv("FLEXAM_FLUX_CKPT", files["ckpt"])
    monkeypatch.setenv("FLEXAM_FLUX_AE", files["ae"])
    tl = TR.load_flux_repainter(cfg=tr.cfg, vae_cfg=tr.vae_cfg,
                                dtype=torch.float32, device="cpu")
    assert_trees_equal(tl.params, crossed(jl.params))
    assert_trees_equal(tl.vae_params, crossed(jl.vae_params))
    assert not tl.text_from_checkpoint and tl.t5_params is None


def test_loader_refusals():
    with pytest.raises(FileNotFoundError, match="FLEXAM_FLUX_CKPT"):
        TR.load_flux_repainter(ckpt="", ae="", device="cpu")


def test_loader_coverage_gates(tmp_path):
    """A file of other tensors is refused by the coverage gate (strict), as
    JAX's loader refuses it."""
    bad = {"not_a_flux_key": torch.zeros(4, 4)}
    f1, f2 = str(tmp_path / "flux.safetensors"), str(tmp_path / "ae.st")
    save_safetensors(f1, bad)
    with pytest.raises(ValueError, match="coverage"):
        TR.load_flux_repainter(ckpt=f1, ae=f1, device="cpu")
    with pytest.raises(ValueError, match="coverage"):
        JR.load_flux_repainter(ckpt=f1, ae=f1)
    assert not os.path.exists(f2)


def test_demo_repaint_through_flux(pair, files, monkeypatch, tmp_path):
    """`--repaint true` with FLEXAM_FLUX_CKPT + FLEXAM_FLUX_AE: the demo
    loads the repainter from the files (geometry swapped for the tiny one)
    and writes the FLUX frame: the one the repainter gives for the first
    frame's depth and the demo's seed."""
    from flexam_tpu_torch import demo
    from flexam_tpu_torch.perception.depth import estimate_depth
    _, tr = pair
    monkeypatch.setattr(TR, "load_flux_repainter", functools.partial(
        TR.load_flux_repainter, cfg=tr.cfg, vae_cfg=tr.vae_cfg,
        dtype=torch.float32))
    monkeypatch.setenv("FLEXAM_FLUX_CKPT", files["ckpt"])
    monkeypatch.setenv("FLEXAM_FLUX_AE", files["ae"])
    t, h, w = 9, 32, 32
    video = np.random.RandomState(0).rand(t, h, w, 3)
    np.savez(tmp_path / "in.npz", video=(video * 255).astype(np.uint8),
             fps=8)
    out = demo.main(["--prompt", "a test scene", "--platform", "cpu",
                     "--random_init", "tiny", "--sample_size", str(h),
                     str(w), "--video_length", str(t),
                     "--num_inference_steps", "2", "--density", "8",
                     "--seed", "3", "--generate_type", "full_edit",
                     "--synthetic_tracks", "--repaint", "true",
                     "--input_path", str(tmp_path / "in.npz"),
                     "--output_dir", str(tmp_path / "out")])
    assert out.shape == (1, 3, t, h, w)
    saved = np.load(tmp_path / "out" / "temp_repainted.npy")
    first = (np.load(tmp_path / "in.npz")["video"][0] / 255.0)
    img = (np.clip(first.astype(np.float32), 0, 1) * 255).astype(np.uint8)
    depth = estimate_depth((img.astype(np.float32) / 255.0)[None])[0]
    np.testing.assert_array_equal(saved, tr("a test scene", depth, h, w, 2,
                                            seed=3))


def test_load_flux_repainter_text_towers_match_jax(files, monkeypatch,
                                                   tmp_path):
    """FLEXAM_FLUX_T5 / FLEXAM_FLUX_CLIP: transformers' random T5 v1.1 and
    CLIP-L text models (tiny geometries swapped in for both loaders) load
    into both repainters; text from a checkpoint refuses hashed ids
    without a tokenizer, and with FLEXAM_ALLOW_HASHED_IDS=1 both encode
    the prompt alike."""
    transformers = pytest.importorskip("transformers")
    from flexam_tpu.config import T5Config as JT5Config
    from flexam_tpu.models import clip_text as JC
    from flexam_tpu_torch.config import T5Config
    from flexam_tpu_torch.models import clip_text as TC
    t5_kw = dict(vocab=96, dim=32, dim_attn=32, dim_ffn=64, num_heads=4,
                 num_layers=2, num_buckets=8, max_distance=16,
                 shared_pos=True, text_length=12)
    torch.manual_seed(0)
    t5 = transformers.T5EncoderModel(transformers.T5Config(
        vocab_size=96, d_model=32, d_kv=8, d_ff=64, num_layers=2,
        num_heads=4, relative_attention_num_buckets=8,
        relative_attention_max_distance=16, dropout_rate=0.0,
        feed_forward_proj="gated-gelu", is_encoder_decoder=False,
        use_cache=False, tie_word_embeddings=False)).eval()
    clip = transformers.CLIPTextModel(transformers.CLIPTextConfig(
        vocab_size=64, hidden_size=32, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=2,
        max_position_embeddings=10, eos_token_id=63, bos_token_id=62,
        pad_token_id=0, hidden_act="quick_gelu")).eval()
    f_t5, f_clip = str(tmp_path / "t5.safetensors"), str(
        tmp_path / "clip.safetensors")
    save_safetensors(f_t5, {k: v.contiguous() for k, v in
                            t5.state_dict().items()})
    save_safetensors(f_clip, clip.state_dict())
    monkeypatch.setattr(TR, "FLUX_T5_CONFIG", T5Config(**t5_kw))
    monkeypatch.setattr(JR, "FLUX_T5_CONFIG", JT5Config(**t5_kw))
    monkeypatch.setattr(TR, "CLIPTextConfig", TC.CLIPTextConfig.tiny)
    monkeypatch.setattr(JR, "CLIPTextConfig", JC.CLIPTextConfig.tiny)
    tl = TR.load_flux_repainter(files["ckpt"], files["ae"], f_t5, f_clip,
                                cfg=TF.FluxConfig.tiny(32),
                                vae_cfg=TV.FluxVAEConfig.tiny(),
                                dtype=torch.float32, device="cpu")
    jl = JR.load_flux_repainter(files["ckpt"], files["ae"], f_t5, f_clip,
                                cfg=JF.FluxConfig.tiny(32),
                                vae_cfg=JV.FluxVAEConfig.tiny(),
                                dtype=jnp.float32)
    assert tl.text_from_checkpoint and jl.text_from_checkpoint
    monkeypatch.delenv("FLEXAM_ALLOW_HASHED_IDS", raising=False)
    with pytest.raises(RuntimeError, match="tokenizer"):
        tl.encode_text("a fox")
    monkeypatch.setenv("FLEXAM_ALLOW_HASHED_IDS", "1")
    # both loaders keep the text towers' stored dtype (float32 here): the
    # features are compared as the towers give them
    tl.t5_cfg, tl.clip_cfg = T5Config(**t5_kw), TC.CLIPTextConfig.tiny()
    jl.t5_cfg, jl.clip_cfg = JT5Config(**t5_kw), JC.CLIPTextConfig.tiny()
    for a, b in zip(tl.encode_text("a fox"), jl.encode_text("a fox")):
        close(a, b)
