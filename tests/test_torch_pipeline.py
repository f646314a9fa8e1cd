"""The port's pipeline against the JAX package, on the CPU.

Weights are the JAX init's (through `from_jax_params`) and the initial
noise is JAX's, passed in as `latents=` (torch cannot replay jax.random).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexam_tpu import pipeline as jpipe
from flexam_tpu.config import tiny_test_config as jax_tiny
from flexam_tpu.models.dit import init_dit_params
from flexam_tpu.models.t5 import init_t5_params
from flexam_tpu.models.vae import init_vae_params
from flexam_tpu_torch import pipeline as tpipe
from flexam_tpu_torch.config import tiny_test_config
from flexam_tpu_torch.io.convert import from_jax_params

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "tiny_latents.npz")


def _jax_params():
    cfg = jax_tiny()
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(42), 3)
    return (init_dit_params(k1, cfg.dit, dtype=jnp.float32),
            init_vae_params(k2, cfg.vae), init_t5_params(k3, cfg.t5))


def _port_pipe(params):
    conv = [from_jax_params(jax.tree_util.tree_map(np.asarray, p),
                            device="cpu") for p in params]
    models = tpipe.FlexAMModels(cfg=tiny_test_config(), dit_params=conv[0],
                                vae_params=conv[1], t5_params=conv[2])
    return tpipe.FlexAMGenerationPipeline(models, device="cpu")


def test_golden_latents_reproduced():
    """`tests/golden/tiny_latents.npz` from the recipe of
    tests/test_golden.py: PRNGKey(42) weights, seed-123 noise, 4 CFG Euler
    steps with the first frame known."""
    pipe = _port_pipe(_jax_params())
    rng = np.random.RandomState(7)
    t, h, w = 9, 32, 32
    video = rng.rand(1, 3, t, h, w).astype(np.float32)
    mask = np.ones((1, 1, t, h, w), np.float32)
    mask[:, :, 0] = 0.0
    cond = pipe.prepare_conditioning(
        video, mask, rng.rand(1, 3, t, h, w).astype(np.float32),
        rng.rand(1, 3, t, h, w).astype(np.float32),
        [rng.rand(1, 3, t, h, w).astype(np.float32) for _ in range(4)],
        rng.rand(1, 3, 1, h, w).astype(np.float32))
    assert cond["first_frame_known"]
    ids = np.arange(16, dtype=np.int32)[None] % 64
    ctx = pipe.encode_prompt_ids(ids, np.ones((1, 16), np.int32))
    context = torch.cat([ctx, ctx], dim=0)
    c, lt, lh, lw = cond["latent_shape"]
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(123),
                                         (1, c, lt, lh, lw), jnp.float32))
    lat = pipe.denoise(cond, context, num_inference_steps=4,
                       guidance_scale=6.0, density=0.1, latents=noise)
    ref = np.load(GOLDEN)["latents"]
    np.testing.assert_allclose(lat.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_generate_matches_jax():
    """One tiny generate() end to end (2 CFG steps, a mask with frame 0
    known), held to the JAX pipeline. Both return the uint8 decode / 255,
    so the bound is one uint8 step (1/255) where rounding lands on the
    other side; the latents before the decode match at 1e-4."""
    params = _jax_params()
    cfg = jax_tiny()
    jp = jpipe.FlexAMGenerationPipeline(
        jpipe.FlexAMModels(cfg=cfg, dit_params=params[0], vae_params=params[1],
                           t5_params=params[2]), compute_dtype=jnp.float32)
    pipe = _port_pipe(params)
    rng = np.random.RandomState(11)
    t, h, w = 5, 32, 32
    video = rng.rand(1, 3, t, h, w).astype(np.float32)
    mask = np.ones((1, 1, t, h, w), np.float32)
    mask[:, :, 0] = 0.0
    ctrl = rng.rand(1, 3, t, h, w).astype(np.float32)
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(5),
                                         (1, 8, 2, 2, 2), jnp.float32))
    kw = dict(mask_video=mask, control_video=ctrl, num_inference_steps=2,
              guidance_scale=6.0, density=0.3)
    # JAX draws its noise from PRNGKey(seed); the port takes it as latents=
    jax_lat = jp.generate(video, "a cat", seed=5, output_type="latent", **kw)
    lat = pipe.generate(video, "a cat", output_type="latent", latents=noise,
                        **kw)
    np.testing.assert_allclose(lat, jax_lat, rtol=1e-4, atol=1e-4)
    jax_video = np.asarray(jp._decode_u8_host(jnp.asarray(jax_lat))
                           ).transpose(0, 4, 1, 2, 3).astype(np.float32) / 255.0
    video_out = pipe.generate(video, "a cat", latents=noise, **kw)
    assert video_out.shape == (1, 3, t, h, w)
    assert np.isfinite(video_out).all()
    assert video_out.min() >= 0.0 and video_out.max() <= 1.0
    np.testing.assert_allclose(video_out, jax_video, rtol=0, atol=1.01 / 255)


@pytest.mark.parametrize("align", [False, True])
def test_resize_trilinear(align):
    """Antialiased half-pixel resize (jax.image) and align-corners resize,
    down in space, up and down in time."""
    x = np.random.RandomState(3).rand(1, 4, 5, 32, 48).astype(np.float32)
    for size in ((2, 2, 3), (9, 4, 6), (1, 8, 8)):
        ref = jpipe.resize_trilinear(jnp.asarray(x), size, align_corners=align)
        got = tpipe.resize_trilinear(torch.from_numpy(x), size,
                                     align_corners=align)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("kind", ["flow_match_euler", "flow_dpm",
                                  "flow_unipc"])
def test_sampler_matches_jax(kind):
    """The schedule tables are the JAX package's (copied numpy), and the
    torch solver step tracks the JAX step over a whole 6-step run."""
    from flexam_tpu.sampling import flow_match as jfm
    from flexam_tpu_torch.sampling import flow_match as tfm

    jt, tt = jfm.build_schedule(kind, 6), tfm.build_schedule(kind, 6)
    for name in ("sigmas", "timesteps", "c_x", "c_last", "c_mt", "c_hist",
                 "p_x", "p_mt", "p_hist"):
        np.testing.assert_array_equal(getattr(tt, name), getattr(jt, name))
    rs = np.random.RandomState(8)
    x0 = rs.randn(1, 4, 2, 3, 3).astype(np.float32)
    vel = rs.randn(6, 1, 4, 2, 3, 3).astype(np.float32)
    ja = jfm.schedule_arrays(jt)
    ta = tfm.schedule_arrays(tt)
    js = jfm.sampler_init_state(jnp.asarray(x0), jt.order)
    ts = tfm.sampler_init_state(torch.from_numpy(x0), tt.order)
    for i in range(6):
        js, jx = jfm.sampler_step(ja, jt.convert, js, jnp.asarray(vel[i]), i)
        ts, tx = tfm.sampler_step(ta, tt.convert, ts, torch.from_numpy(vel[i]),
                                  i)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=2e-4,
                                   atol=1e-5)
    np.testing.assert_allclose(
        tfm.add_noise(torch.from_numpy(x0), torch.from_numpy(vel[0]),
                      0.3).numpy(),
        np.asarray(jfm.add_noise(jnp.asarray(x0), jnp.asarray(vel[0]), 0.3)),
        rtol=1e-6, atol=1e-6)


def test_denoise_moe_and_cfg_skip():
    """Timestep-MoE segments (a second, high-noise DiT) and the cfg-skip
    tail (the last half of the steps cond-only), held to JAX."""
    params = _jax_params()
    dit2 = init_dit_params(jax.random.PRNGKey(99), jax_tiny().dit,
                           dtype=jnp.float32)
    jp = jpipe.FlexAMGenerationPipeline(
        jpipe.FlexAMModels(cfg=jax_tiny(), dit_params=params[0],
                           vae_params=params[1], t5_params=params[2],
                           dit2_params=dit2), compute_dtype=jnp.float32)
    pipe = _port_pipe(params)
    pipe.models.dit2_params = from_jax_params(
        jax.tree_util.tree_map(np.asarray, dit2), device="cpu")
    rng = np.random.RandomState(12)
    t, h, w = 5, 32, 32
    video = rng.rand(1, 3, t, h, w).astype(np.float32)
    ctrl = rng.rand(1, 3, t, h, w).astype(np.float32)
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(6),
                                         (1, 8, 2, 2, 2), jnp.float32))
    kw = dict(num_inference_steps=4, guidance_scale=5.0, cfg_skip_ratio=0.5,
              boundary=0.9)
    ref = jp.denoise(jp.prepare_conditioning(video, None, ctrl, None, None,
                                             None),
                     jp.encode_prompt("a boat"), latents=jnp.asarray(noise),
                     **kw)
    got = pipe.denoise(pipe.prepare_conditioning(video, None, ctrl),
                       pipe.encode_prompt("a boat"), latents=noise, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def test_tokenize_and_mask_latents():
    """Hashed prompt ids and the mask -> latent-mask construction."""
    params = _jax_params()
    jp = jpipe.FlexAMGenerationPipeline(
        jpipe.FlexAMModels(cfg=jax_tiny(), dit_params=params[0],
                           vae_params=params[1], t5_params=params[2]),
        compute_dtype=jnp.float32)
    pipe = _port_pipe(params)
    for a, b in zip(pipe.tokenize(["a cat", "x" * 40]),
                    jp.tokenize(["a cat", "x" * 40])):
        np.testing.assert_array_equal(a, b)
    mask = (np.random.RandomState(2).rand(1, 1, 9, 32, 32) > 0.5
            ).astype(np.float32)
    ref_lat, ref_ti2v = jp._mask_latents_jit(jnp.asarray(mask), (3, 2, 2))
    got_lat, got_ti2v = pipe._mask_latents(torch.from_numpy(mask), (3, 2, 2))
    np.testing.assert_allclose(got_lat.numpy(), np.asarray(ref_lat),
                               rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(got_ti2v.numpy(), np.asarray(ref_ti2v),
                               rtol=2e-4, atol=1e-5)
