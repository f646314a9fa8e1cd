"""The Control-Camera adapter in the port against the JAX package, on the
CPU: `_camera_adapter` on random inputs, its parameters through
`from_jax_params`, `generate(camera_video=)` end to end on
`tests/test_camera_adapter_path.py`'s `_camera_pipe` config, the refusals
(no adapter; camera with TeaCache), and `generate`'s parameter order.

Weights are the JAX init's and the noise JAX's, passed as `latents=`;
fp32 throughout, held at the suite's rtol 2e-4, the decoded video within
one uint8 level (1/255)."""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexam_tpu import pipeline as jpipe
from flexam_tpu.config import tiny_test_config as jax_tiny
from flexam_tpu.models import dit as jdit
from flexam_tpu.models.t5 import init_t5_params
from flexam_tpu.models.vae import init_vae_params
from flexam_tpu_torch import pipeline as tpipe
from flexam_tpu_torch.config import tiny_test_config
from flexam_tpu_torch.io.convert import from_jax_params
from flexam_tpu_torch.models import dit as tdit

RTOL, ATOL = 2e-4, 2e-5


def _with_adapter(cfg, downscale=16, **dit_kw):
    # adapter input = 6 Plucker channels x the 4-frame fold = 24; downscale
    # 16 equals the tiny VAE's spatial compression, so the adapter's token
    # grid lands on the DiT's patch grid (as `_camera_pipe` reasons)
    return dataclasses.replace(cfg, dit=dataclasses.replace(
        cfg.dit, add_control_adapter=True, in_dim_control_adapter=24,
        downscale_factor_control_adapter=downscale, **dit_kw))


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("downscale,dit_kw,hw", [
    (8, {}, (32, 48)),                                # the tiny config
    (16, {"dim": 64, "ffn_dim": 128, "num_heads": 2}, (64, 96)),
], ids=["tiny_d8", "narrow_d16"])
def test_camera_adapter_matches_jax(downscale, dit_kw, hw):
    jcfg = _with_adapter(jax_tiny(), downscale, **dit_kw).dit
    tcfg = _with_adapter(tiny_test_config(), downscale, **dit_kw).dit
    params = jdit.init_dit_params(jax.random.PRNGKey(3), jcfg,
                                  dtype=jnp.float32)
    ours = from_jax_params(_host(params), device="cpu")
    y = np.random.RandomState(0).randn(2, 24, 3, *hw).astype(np.float32)
    patch = tuple(jcfg.patch_size[1:])
    ref = np.asarray(jdit._camera_adapter(params["control_adapter"],
                                          jnp.asarray(y), patch, downscale))
    got = tdit._camera_adapter(ours["control_adapter"], torch.from_numpy(y),
                               patch, downscale)
    h, w = hw[0] // downscale // patch[0], hw[1] // downscale // patch[1]
    assert got.shape == ref.shape == (2, 3 * h * w, tcfg.dim)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_control_adapter_leaves_cross():
    """`from_jax_params` carries every control_adapter leaf as it is, and
    the port's own init makes the same leaves (shapes and dtypes)."""
    jcfg = _with_adapter(jax_tiny()).dit
    params = _host(jdit.init_dit_params(jax.random.PRNGKey(4), jcfg,
                                        dtype=jnp.float32))
    ours = from_jax_params(params, device="cpu")
    own = tdit.init_dit_params(_with_adapter(tiny_test_config()).dit,
                               dtype=torch.float32, device="cpu")
    for conv in ("conv", "res_conv1", "res_conv2"):
        for k in ("weight", "bias"):
            ref = params["control_adapter"][conv][k]
            got = ours["control_adapter"][conv][k]
            np.testing.assert_array_equal(got.numpy(), ref)
            assert own["control_adapter"][conv][k].shape == got.shape
            assert own["control_adapter"][conv][k].dtype == got.dtype


def _pipes():
    cfg = _with_adapter(jax_tiny())
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    params = (jdit.init_dit_params(k1, cfg.dit, dtype=jnp.float32),
              init_vae_params(k2, cfg.vae), init_t5_params(k3, cfg.t5))
    jp = jpipe.FlexAMGenerationPipeline(
        jpipe.FlexAMModels(cfg=cfg, dit_params=params[0],
                           vae_params=params[1], t5_params=params[2]),
        compute_dtype=jnp.float32)
    conv = [from_jax_params(_host(p), device="cpu") for p in params]
    tp = tpipe.FlexAMGenerationPipeline(tpipe.FlexAMModels(
        cfg=_with_adapter(tiny_test_config()), dit_params=conv[0],
        vae_params=conv[1], t5_params=conv[2]), device="cpu")
    return jp, tp


def test_generate_with_camera_matches_jax():
    """`test_camera_video_reaches_generation`'s call (zeros video, a random
    camera video, 2 steps at CFG 1) through both pipelines: the latents at
    rtol 2e-4, the video within one uint8 level, and the port's output
    differs from the same call without the camera."""
    jp, tp = _pipes()
    video = np.zeros((1, 3, 9, 32, 32), np.float32)
    cam = np.random.default_rng(0).standard_normal(
        (1, 6, 9, 32, 32)).astype(np.float32)
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                         (1, 8, 3, 2, 2), jnp.float32))
    kw = dict(num_inference_steps=2, guidance_scale=1.0)
    jlat = jp.generate(video, "x", camera_video=cam, seed=0,
                       output_type="latent", **kw)
    tlat = tp.generate(video, "x", camera_video=cam, latents=noise,
                       output_type="latent", **kw)
    np.testing.assert_allclose(tlat, np.asarray(jlat), rtol=RTOL, atol=ATOL)
    jvid = jp.generate(video, "x", camera_video=cam, seed=0, **kw)
    tvid = tp.generate(video, "x", camera_video=cam, latents=noise, **kw)
    np.testing.assert_allclose(tvid, jvid, rtol=0, atol=1.01 / 255)
    plain = tp.generate(video, "x", latents=noise, **kw)
    assert tvid.shape == plain.shape == (1, 3, 9, 32, 32)
    assert np.abs(tvid - plain).max() > 0


def _refusal(fn):
    with pytest.raises(Exception) as e:
        fn()
    return type(e.value), str(e.value)


def test_camera_refusals_match_jax():
    """Without the adapter both packages refuse camera_video with the same
    ValueError; with TeaCache both refuse (JAX's TeaCache forward takes no
    y_camera: TypeError)."""
    cfg = jax_tiny()
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    params = (jdit.init_dit_params(k1, cfg.dit, dtype=jnp.float32),
              init_vae_params(k2, cfg.vae), init_t5_params(k3, cfg.t5))
    jp = jpipe.FlexAMGenerationPipeline(jpipe.FlexAMModels(
        cfg=cfg, dit_params=params[0], vae_params=params[1],
        t5_params=params[2]), compute_dtype=jnp.float32)
    conv = [from_jax_params(_host(p), device="cpu") for p in params]
    tp = tpipe.FlexAMGenerationPipeline(tpipe.FlexAMModels(
        cfg=tiny_test_config(), dit_params=conv[0], vae_params=conv[1],
        t5_params=conv[2]), device="cpu")
    video = np.zeros((1, 3, 9, 32, 32), np.float32)
    cam = np.zeros((1, 6, 9, 32, 32), np.float32)
    kw = dict(camera_video=cam, num_inference_steps=1, guidance_scale=1.0)
    jerr = _refusal(lambda: jp.generate(video, "x", **kw))
    terr = _refusal(lambda: tp.generate(video, "x", **kw))
    assert jerr[0] is terr[0] is ValueError
    assert terr[1] == jerr[1] and "Control-Camera" in terr[1]

    jp, tp = _pipes()
    kw["teacache_thresh"] = 0.1
    jerr = _refusal(lambda: jp.generate(video, "x", **kw))
    terr = _refusal(lambda: tp.generate(video, "x", **kw))
    assert jerr[0] is terr[0] is TypeError
    assert "y_camera" in jerr[1] and "y_camera" in terr[1]


def test_generate_parameter_order_matches_jax():
    """`generate` and `generate_from_cond` take JAX's parameters in JAX's
    order, `offload_dit_for_decode` included, with the port's `latents`
    last; so a positional caller reaches the same parameter in both."""
    for name in ("generate", "generate_from_cond"):
        jparams = list(inspect.signature(
            getattr(jpipe.FlexAMGenerationPipeline, name)).parameters)
        tparams = list(inspect.signature(
            getattr(tpipe.FlexAMGenerationPipeline, name)).parameters)
        assert tparams == jparams + ["latents"], name
