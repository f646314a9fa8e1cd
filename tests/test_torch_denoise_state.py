"""Denoise state in the port against the JAX package, on the CPU: TeaCache
(`dit_forward_teacache` and the pipeline's `teacache_*` arguments), the
checkpoint/resume snapshots of `denoise`, `last_denoise_info`, and
`set_dit_params` / `release_dit`.

Mirrors `tests/test_pipeline.py`'s TeaCache and checkpoint/resume cases
with the same weights (through `from_jax_params`), conditioning inputs,
context and initial noise (JAX's, crossing as `latents=`) in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexam_tpu import config as jcfg
from flexam_tpu import pipeline as jpipe
from flexam_tpu.models import dit as jdit
from flexam_tpu.models import vae as jvae
from flexam_tpu_torch import config as tcfg
from flexam_tpu_torch import pipeline as tpipe
from flexam_tpu_torch.io.convert import from_jax_params
from flexam_tpu_torch.models import dit as tdit

F32 = dict(rtol=2e-4, atol=1e-5)
T, H, W = 9, 32, 32
SHAPE = (1, 8, 3, 2, 2)


def _port(tree):
    return from_jax_params(jax.tree_util.tree_map(np.asarray, tree),
                           device="cpu")


@pytest.fixture(scope="module")
def setup():
    """Both pipelines over the same tiny fp32 weights, a cond prepared by
    each from the same inputs, one context and JAX's noise."""
    cfg = jcfg.tiny_test_config()
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    dp = jdit.init_dit_params(k1, cfg.dit, dtype=jnp.float32)
    vp = jvae.init_vae_params(k2, cfg.vae)
    jp = jpipe.FlexAMGenerationPipeline(
        jpipe.FlexAMModels(cfg=cfg, dit_params=dp, vae_params=vp),
        compute_dtype=jnp.float32)
    tp = tpipe.FlexAMGenerationPipeline(
        tpipe.FlexAMModels(cfg=tcfg.tiny_test_config(), dit_params=_port(dp),
                           vae_params=_port(vp)), device="cpu")
    rng = np.random.RandomState(0)
    video = rng.rand(1, 3, T, H, W).astype(np.float32)
    mask = np.ones((1, 1, T, H, W), np.float32)
    streams = [rng.rand(1, 3, T, H, W).astype(np.float32) for _ in range(6)]
    ref = rng.rand(1, 3, 1, H, W).astype(np.float32)
    args = (video, mask, streams[0], streams[1], streams[2:], ref)
    ctx = rng.randn(2, 16, 64).astype(np.float32)
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(11), SHAPE))
    return dict(jp=jp, tp=tp, jcond=jp.prepare_conditioning(*args),
                cond=tp.prepare_conditioning(*args), ctx=ctx, noise=noise,
                k4=jax.random.PRNGKey(99), cfg=cfg)


def _both(s, **kw):
    """JAX's and the port's denoise on the same inputs; returns both latents
    and both last_denoise_info."""
    kw = dict(dict(num_inference_steps=4, guidance_scale=6.0, density=0.1),
              **kw)
    jl = np.asarray(s["jp"].denoise(s["jcond"], jnp.asarray(s["ctx"]),
                                    latents=jnp.asarray(s["noise"]), **kw))
    tl = s["tp"].denoise(s["cond"], torch.from_numpy(s["ctx"]),
                         latents=s["noise"], **kw).numpy()
    return tl, jl, s["tp"].last_denoise_info, s["jp"].last_denoise_info


@pytest.mark.parametrize("thresh,skip_start,cfg_skip",
                         [(0.1, 2, 0.0), (1e9, 2, 0.0), (1e9, 5, 0.0),
                          (0.1, 2, 0.5)],
                         ids=["thresh0.1", "skip_all", "warmup5",
                              "cfg_skip_segments"])
def test_teacache_denoise_matches_jax(setup, thresh, skip_start, cfg_skip):
    """`tests/test_pipeline.py:107` mirrored: the TeaCache loop runs, the
    first `teacache_skip_start` forwards always compute, a huge threshold
    skips every later one, and the latents and forward counts equal JAX's
    (with a cfg-skip tail the state starts afresh in each segment)."""
    tl, jl, info, jinfo = _both(setup, num_inference_steps=6,
                                teacache_thresh=thresh,
                                teacache_skip_start=skip_start,
                                cfg_skip_ratio=cfg_skip)
    np.testing.assert_allclose(tl, jl, **F32)
    assert info == jinfo, (info, jinfo)
    if thresh > 1e8 and not cfg_skip:
        assert info["teacache_computed_forwards"] == min(skip_start, 6)
        assert info["teacache_skipped_forwards"] == 6 - min(skip_start, 6)
    plain, _, plain_info, _ = _both(setup, num_inference_steps=6,
                                    cfg_skip_ratio=cfg_skip)
    assert plain_info == {"steps": 6}
    if info["teacache_skipped_forwards"]:
        assert not np.allclose(tl, plain)
    else:
        np.testing.assert_array_equal(tl, plain)


def test_checkpoint_resume_matches_jax(setup):
    """`tests/test_pipeline.py:127` mirrored: with 2 steps a chunk, 4 steps
    give snapshots after steps 1 and 3 whose solver state equals JAX's, and
    resuming from step 1 equals the uninterrupted run bit for bit."""
    jp, tp = setup["jp"], setup["tp"]
    old = (jp.steps_per_launch, tp.steps_per_launch)
    snaps, jsnaps = {}, {}
    try:
        jp.steps_per_launch = tp.steps_per_launch = 2
        kw = dict(num_inference_steps=4, guidance_scale=6.0, density=0.1)
        ctx = torch.from_numpy(setup["ctx"])
        full = tp.denoise(setup["cond"], ctx, latents=setup["noise"], **kw)
        tp.denoise(setup["cond"], ctx, latents=setup["noise"],
                   checkpoint_cb=lambda s, snap: snaps.update({s: snap}), **kw)
        jp.denoise(setup["jcond"], jnp.asarray(setup["ctx"]),
                   latents=jnp.asarray(setup["noise"]),
                   checkpoint_cb=lambda s, snap: jsnaps.update({s: snap}),
                   **kw)
        resumed = tp.denoise(setup["cond"], ctx, latents=setup["noise"],
                             resume=snaps[1], **kw)
        # a snapshot of JAX's resumes the port's run too
        from_jax = tp.denoise(setup["cond"], ctx, latents=setup["noise"],
                              resume=jsnaps[1], **kw)
    finally:
        jp.steps_per_launch, tp.steps_per_launch = old
    assert sorted(snaps) == sorted(jsnaps) == [1, 3]
    for step in snaps:
        assert snaps[step]["step"] == jsnaps[step]["step"] == step
        assert len(snaps[step]["sampler_state"]) == 3
        for a, b in zip(snaps[step]["sampler_state"],
                        jsnaps[step]["sampler_state"]):
            assert isinstance(a, np.ndarray) and a.dtype == np.float32
            np.testing.assert_allclose(a, np.asarray(b), **F32)
    torch.testing.assert_close(resumed, full, rtol=0, atol=0)
    np.testing.assert_allclose(from_jax.numpy(), full.numpy(), **F32)


def test_dit_forward_teacache_matches_jax(setup):
    """Several steps of the TeaCache forward alone, with falling timesteps,
    a warmup of 2 and a threshold that lets some steps run and others skip:
    the velocities and the carried state equal JAX's, and so does each
    decision."""
    cfg = setup["cfg"]
    jparams = setup["jp"].models.dit_params
    params = setup["tp"].models.dit_params
    rng = np.random.RandomState(5)
    x = rng.randn(2, 8, 3, 2, 2).astype(np.float32)
    y = rng.randn(2, 20, 3, 2, 2).astype(np.float32)
    ac = rng.randn(2, 40, 3, 2, 2).astype(np.float32)
    ref = rng.randn(2, 8, 2, 2).astype(np.float32)
    ctx = rng.randn(2, 16, 64).astype(np.float32)
    mask = np.ones((2, 3), np.float32)      # 3 video tokens + 1 ref token
    mask[:, :1] = 0.0
    kw = dict(density=np.full((2,), 0.1, np.float32), y=y,
              additional_control=ac, full_ref=ref, binary_t_mask=mask)
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    jstate = jdit.init_teacache_state(2, 4, cfg.dit.dim, jnp.float32)
    state = tdit.init_teacache_state(2, 4, cfg.dit.dim, torch.float32,
                                     device="cpu")
    rope = jnp.asarray(jdit.make_rope_tables_for(cfg.dit), jnp.float32)
    trope = tdit.make_rope_tables_for(tcfg.tiny_test_config().dit)
    decisions = []
    for i, tv in enumerate([999.0, 990.0, 989.99, 989.98, 900.0, 899.99, 500.0]):
        t = np.full((2,), tv, np.float32)
        before = float(jstate["computed"])
        jv, jstate = jdit.dit_forward_teacache(
            jparams, cfg.dit, jnp.asarray(x), jnp.asarray(t),
            jnp.asarray(ctx), jstate, jnp.int32(i), rope_tables=rope,
            rel_l1_thresh=0.05, num_skip_start_steps=2, **jkw)
        v, state = tdit.dit_forward_teacache(
            params, tcfg.tiny_test_config().dit, torch.from_numpy(x),
            torch.from_numpy(t), torch.from_numpy(ctx), state, i,
            rope_tables=trope, rel_l1_thresh=0.05, num_skip_start_steps=2,
            **tkw)
        decisions.append(float(jstate["computed"]) - before)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), **F32)
        assert float(state["computed"]) == float(jstate["computed"])
        for k in ("prev_mod", "residual"):
            np.testing.assert_allclose(state[k].numpy(), np.asarray(jstate[k]),
                                       err_msg=k, **F32)
        np.testing.assert_allclose(float(state["accum"]),
                                   float(jstate["accum"]), rtol=1e-4)
    assert 0.0 in decisions[2:] and 1.0 in decisions[2:], decisions


def test_teacache_coefficients_table():
    for name in ("Wan2.1-T2V-1.3B", "wan2.1-t2v-14b", "Wan2.1-I2V-14B-480P",
                 "wan2.2-fun-5b", "unknown-model"):
        assert (tdit.get_teacache_coefficients(name)
                == jdit.get_teacache_coefficients(name))
    assert tdit.TEACACHE_COEFFICIENTS == jdit.TEACACHE_COEFFICIENTS
    assert (tdit.WAN22_TEACACHE_COEFFICIENTS
            == jdit.WAN22_TEACACHE_COEFFICIENTS)


def test_set_dit_params_and_release(setup):
    """set_dit_params swaps the weights both packages denoise with (the
    results agree again); release_dit drops them."""
    jp, tp = setup["jp"], setup["tp"]
    old_j, old_t = jp.models.dit_params, tp.models.dit_params
    other = jdit.init_dit_params(setup["k4"], setup["cfg"].dit,
                                 dtype=jnp.float32)
    try:
        base, _, _, _ = _both(setup, num_inference_steps=2)
        jp.set_dit_params(other)
        tp.set_dit_params(_port(other))
        swapped, jswapped, _, _ = _both(setup, num_inference_steps=2)
        np.testing.assert_allclose(swapped, jswapped, **F32)
        assert not np.allclose(swapped, base)
        tp.release_dit()
        assert tp.models.dit_params is None
    finally:
        jp.set_dit_params(old_j)
        tp.set_dit_params(old_t)
