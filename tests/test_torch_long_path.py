"""The port's long-clip path against the JAX package, on the CPU: RIFLEx
tables, the group-streamed VAE, the pipeline's streaming switch, and a tiny
head_dim-128 denoise under FLEXAM_ATTENTION=sparse and under explicit int8.

Weights are the JAX init's (through `from_jax_params`); inputs and noise are
made from numpy seeds and handed to both packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexam_tpu.core.attention as JA
import flexam_tpu_torch.core.attention as TA
from flexam_tpu import config as jcfg
from flexam_tpu import pipeline as jpipe
from flexam_tpu.core import rope as jrope
from flexam_tpu.models import dit as jdit
from flexam_tpu.models import vae as jvae
from flexam_tpu.models import vae_stream as jvs
from flexam_tpu.ops.int8_attention import int8_flash_attention
from flexam_tpu_torch import config as tcfg
from flexam_tpu_torch import pipeline as tpipe
from flexam_tpu_torch.core import rope as trope
from flexam_tpu_torch.io.convert import from_jax_params
from flexam_tpu_torch.models import dit as tdit
from flexam_tpu_torch.models import vae as tvae
from flexam_tpu_torch.models import vae_stream as tvs
from flexam_tpu_torch.ops import launch_counts

F32 = dict(rtol=2e-4, atol=1e-5)


def _port(tree):
    return from_jax_params(jax.tree_util.tree_map(np.asarray, tree),
                           device="cpu")


# --------------------------------------------------------------------------
# RIFLEx
# --------------------------------------------------------------------------

@pytest.mark.parametrize("riflex", [None, {"k": 6, "L_test": 51},
                                    {"k": 4, "L_test": 30,
                                     "L_test_scale": 1.5}])
def test_riflex_tables_match(riflex):
    np.testing.assert_array_equal(
        trope.make_rope_tables(128, 1024, riflex=riflex),
        jrope.make_rope_tables(128, 1024, riflex=riflex))
    cfg = tcfg.WAN22_5B_FLEXAM.dit
    np.testing.assert_array_equal(
        tdit.make_rope_tables_for(cfg, riflex=riflex).numpy(),
        np.asarray(jdit.make_rope_tables_for(jcfg.WAN22_5B_FLEXAM.dit,
                                             riflex=riflex)))


# --------------------------------------------------------------------------
# streamed VAE
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def vae():
    """The tiny VAE with its attention projections given weights (the init
    zeroes them), as JAX and port trees."""
    cfg = jcfg.tiny_test_config().vae
    params = jax.tree_util.tree_map(
        lambda a: a, jvae.init_vae_params(jax.random.PRNGKey(1), cfg))
    rs = np.random.RandomState(4)
    for part in ("encoder", "decoder"):
        proj = params[part]["middle"][1]["proj"]
        proj["weight"] = jnp.asarray(
            rs.randn(*proj["weight"].shape).astype(np.float32) * 0.05)
    return cfg, params, tcfg.tiny_test_config().vae, _port(params)


def test_vae_encode_streamed(vae):
    """17 frames in groups of 9 + 8: equal to JAX's streamed encode and to
    the port's whole-clip encode (fp32 tolerance)."""
    jc, jp, tc, tp = vae
    x = np.random.RandomState(5).uniform(-1, 1, (1, 3, 17, 32, 32)) \
        .astype(np.float32)
    mu_j, lv_j = jvs.vae_encode_streamed(jp, jc, jnp.asarray(x), group_size=8)
    mu_t, lv_t = tvs.vae_encode_streamed(tp, tc, torch.from_numpy(x),
                                         group_size=8)
    assert mu_t.shape == (1, 8, 5, 2, 2)
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), **F32)
    np.testing.assert_allclose(lv_t.numpy(), np.asarray(lv_j), **F32)
    mu_w, lv_w = tvae.vae_encode(tp, tc, torch.from_numpy(x))
    np.testing.assert_allclose(mu_t.numpy(), mu_w.numpy(), **F32)
    np.testing.assert_allclose(lv_t.numpy(), lv_w.numpy(), **F32)
    np.testing.assert_array_equal(
        tvs.vae_encode_mode_streamed(tp, tc, torch.from_numpy(x)).numpy(),
        mu_t.numpy())


def test_vae_decode_streamed(vae):
    """5 latent frames in groups of 2 (the first) + 2 + 1: equal to JAX's
    streamed decode and to the whole-clip decode; the uint8 flavour gives
    the bytes of the float flavour's uint8 and of JAX's (transposed to
    [B, 3, T, H, W]), and is within one step of the whole clip's uint8
    (the two differ in the last fp32 bit, which can move a value across a
    rounding tie)."""
    jc, jp, tc, tp = vae
    z = np.random.RandomState(6).randn(1, 8, 5, 2, 3).astype(np.float32)
    d_j = np.asarray(jvs.vae_decode_streamed(jp, jc, jnp.asarray(z),
                                             group_size=2))
    d_t = tvs.vae_decode_streamed(tp, tc, torch.from_numpy(z), group_size=2)
    assert d_t.shape == (1, 3, 17, 32, 48)
    np.testing.assert_allclose(d_t.numpy(), d_j, rtol=2e-4, atol=2e-5)
    d_w = tvae.vae_decode(tp, tc, torch.from_numpy(z))
    np.testing.assert_allclose(d_t.numpy(), d_w.numpy(), rtol=2e-4,
                               atol=2e-5)

    def u8(x):
        return torch.round((x.float() + 1.0) * 127.5).clamp(0, 255).to(
            torch.uint8)

    u_t = tvs.vae_decode_streamed_u8(tp, tc, torch.from_numpy(z),
                                     group_size=2)
    assert u_t.dtype == torch.uint8 and u_t.device.type == "cpu"
    np.testing.assert_array_equal(u_t.numpy(), u8(d_t).numpy())
    u_j = np.asarray(jvs.vae_decode_streamed_u8(jp, jc, jnp.asarray(z),
                                                group_size=2))
    off = np.abs(u_t.numpy().astype(int) - u_j.transpose(0, 4, 1, 2, 3))
    assert off.max() <= 1 and off.mean() < 1e-3
    off = (u_t.int() - u8(d_w).int()).abs()
    assert off.max().item() <= 1 and off.float().mean().item() < 1e-3


def _tiny_pipes(dit_cfg_kw=None, attn_fn=None):
    """A JAX and a port pipeline over the same tiny weights (fp32)."""
    cfg = jcfg.tiny_test_config()
    tcf = tcfg.tiny_test_config()
    if dit_cfg_kw:
        cfg = dataclasses.replace(cfg, dit=dataclasses.replace(cfg.dit,
                                                               **dit_cfg_kw))
        tcf = dataclasses.replace(tcf, dit=dataclasses.replace(tcf.dit,
                                                               **dit_cfg_kw))
    k1, k2 = jax.random.split(jax.random.PRNGKey(42))
    dp = jdit.init_dit_params(k1, cfg.dit, dtype=jnp.float32)
    vp = jvae.init_vae_params(k2, cfg.vae)
    jp = jpipe.FlexAMGenerationPipeline(
        jpipe.FlexAMModels(cfg=cfg, dit_params=dp, vae_params=vp),
        compute_dtype=jnp.float32, attn_fn=attn_fn)
    tp = tpipe.FlexAMGenerationPipeline(
        tpipe.FlexAMModels(cfg=tcf, dit_params=_port(dp),
                           vae_params=_port(vp)), device="cpu")
    return jp, tp


def test_pipeline_streams_long_clips():
    """With the threshold lowered below a tiny clip, prepare_conditioning
    encodes streamed and decode_u8 decodes streamed, and both match the
    whole-clip pipeline; the threshold itself is the JAX package's."""
    _, pipe = _tiny_pipes()
    assert pipe.VAE_STREAM_THRESHOLD == jpipe.FlexAMGenerationPipeline \
        .VAE_STREAM_THRESHOLD == 8_000_000
    assert not pipe._use_streaming(1, 17, 512, 896)
    assert pipe._use_streaming(1, 97, 512, 896)
    rs = np.random.RandomState(9)
    t, h, w = 13, 32, 32
    video = rs.rand(1, 3, t, h, w).astype(np.float32)
    mask = np.ones((1, 1, t, h, w), np.float32)
    mask[:, :, 0] = 0.0
    ctrl = rs.rand(1, 3, t, h, w).astype(np.float32)
    whole = pipe.prepare_conditioning(video, mask, ctrl, None, None, None)
    z = torch.from_numpy(rs.randn(1, 8, 4, 2, 2).astype(np.float32))
    u_whole = pipe.decode_u8(z)
    pipe.VAE_STREAM_THRESHOLD = 1000
    streamed = pipe.prepare_conditioning(video, mask, ctrl, None, None, None)
    for key in ("control_latents", "masked_video_latents",
                "additional_control"):
        np.testing.assert_allclose(streamed[key].numpy(), whole[key].numpy(),
                                   **F32)
    u_str = pipe.decode_u8(z)
    assert u_str.shape == u_whole.shape == (1, 3, 13, 32, 32)
    off = (u_str.int() - u_whole.int()).abs()
    assert off.max().item() <= 1 and off.float().mean().item() < 1e-3


def test_decode_counts_the_frames_it_decodes(monkeypatch):
    """decode_u8 streams when the frames it decodes, 4 (T' - 1) + 1, pass
    the threshold: 4 latent frames of 32x32 pixels decode 13 frames (13,312
    pixels), streamed below that and whole above."""
    _, pipe = _tiny_pipes()
    z = torch.from_numpy(np.random.RandomState(10).randn(1, 8, 4, 2, 2)
                         .astype(np.float32))
    calls = []

    def streamed(*args, **kw):
        calls.append(kw["group_size"])
        return torch.zeros((1, 3, 13, 32, 32), dtype=torch.uint8)

    monkeypatch.setattr(tpipe, "vae_decode_streamed_u8", streamed)
    pipe.VAE_STREAM_THRESHOLD = 13 * 32 * 32
    assert pipe.decode_u8(z).shape == (1, 3, 13, 32, 32) and calls == []
    pipe.VAE_STREAM_THRESHOLD = 13 * 32 * 32 - 1
    pipe.decode_u8(z)
    assert calls == [2]


# --------------------------------------------------------------------------
# denoise under the long-clip attention backends
# --------------------------------------------------------------------------

# head_dim 128 (the kernels' width): dim 256 over 2 heads
HD128 = dict(dim=256, ffn_dim=256, num_heads=2)


def _cond_and_context(seed, lt=4, lh=4, lw=8):
    """A conditioning dict (first frame known) and a CFG context, as numpy;
    4 latent frames of 4x8 give 8 spatial tokens a frame and 40 tokens with
    the ref block."""
    rs = np.random.RandomState(seed)

    def r(*shape):
        return rs.randn(*shape).astype(np.float32)

    mask = np.ones((1, 1, lt, lh, lw), np.float32)
    mask[:, :, 0] = 0.0
    cond = {"control_latents": r(1, 8, lt, lh, lw),
            "mask_latents": r(1, 4, lt, lh, lw),
            "masked_video_latents": r(1, 8, lt, lh, lw),
            "additional_control": r(1, 40, lt, lh, lw),
            "ref_latents": r(1, 8, lh, lw), "mask_ti2v": mask}
    return cond, r(2, 16, 64), r(1, 8, lt, lh, lw)


def _denoise_both(jp, tp, seed):
    cond, ctx, noise = _cond_and_context(seed)
    meta = {"first_frame_known": True, "per_token_t": True,
            "latent_shape": (8,) + noise.shape[2:]}
    kw = dict(num_inference_steps=2, guidance_scale=6.0, density=0.2)
    ref = jp.denoise({**{k: jnp.asarray(v) for k, v in cond.items()}, **meta},
                     jnp.asarray(ctx), latents=jnp.asarray(noise), **kw)
    got = tp.denoise({**{k: torch.from_numpy(v) for k, v in cond.items()},
                      **meta}, torch.from_numpy(ctx), latents=noise, **kw)
    return np.asarray(ref), got.numpy()


def test_denoise_sparse_matches_jax(monkeypatch):
    """FLEXAM_ATTENTION=sparse with window 1: video self-attention over 5
    blocks of 8 tokens goes block-sparse in both pipelines (JAX: the Pallas
    kernel in interpret mode), cross-attention dense."""
    monkeypatch.setenv("FLEXAM_ATTENTION", "sparse")
    monkeypatch.setenv("FLEXAM_SPARSE_WINDOW", "1")
    for mod in (TA, JA):
        mod._default_backend.cache_clear()
    try:
        jp, tp = _tiny_pipes(HD128)
        ref, got = _denoise_both(jp, tp, 12)
        assert (4, 4, 8, 1) in tp._sparse_attn_cache
    finally:
        monkeypatch.delenv("FLEXAM_ATTENTION")
        for mod in (TA, JA):
            mod._default_backend.cache_clear()
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
    _, dense = _denoise_both(jp, tp, 12)
    assert np.abs(got - dense).max() > 1e-3       # the mask changes the result


def test_denoise_int8_matches_jax(monkeypatch):
    """FLEXAM_ATTENTION=pallas_int8 in the port against the JAX pipeline
    with the int8 Pallas kernel (interpret mode) as its attn_fn: every
    attention call, cross-attention included, is int8. The two frameworks'
    fp32 q/k differ in their last bits, so a value on an int8 rounding tie
    can land one step apart and move its logits by up to 1/127 of the
    block's largest; the bound is therefore set against int8's own error:
    the packages agree to a tenth of the largest, and a hundredth of the
    mean, difference between int8 and exact attention over the same
    denoise (measured about a twentieth and a two-hundredth)."""
    def jax_int8(q, k, v, k_len=None, scale=None):
        return int8_flash_attention(q, k, v, k_len=k_len, scale=scale,
                                    interpret=True)

    jp, tp = _tiny_pipes(HD128, attn_fn=jax_int8)
    _, exact = _denoise_both(jp, tp, 13)
    monkeypatch.setenv("FLEXAM_ATTENTION", "pallas_int8")
    TA._default_backend.cache_clear()
    try:
        ref, got = _denoise_both(jp, tp, 13)
    finally:
        monkeypatch.delenv("FLEXAM_ATTENTION")
        TA._default_backend.cache_clear()
    err_int8 = np.abs(got - exact)
    diff = np.abs(got - ref)
    assert err_int8.mean() > 1e-3                  # int8 really ran
    assert diff.max() < 0.1 * err_int8.max(), (diff.max(), err_int8.max())
    assert diff.mean() < 0.01 * err_int8.mean(), (diff.mean(),
                                                   err_int8.mean())
    assert all(n == 0 for n in launch_counts().values())   # CPU: no launches
