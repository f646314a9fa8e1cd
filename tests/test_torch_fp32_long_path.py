"""The fp32 long-clip path through `generate(compute_dtype=torch.float32)`
against the JAX package, on the CPU.

The long path at 512x896x201f runs fp32 self-attention through B6 (the auto
int8 upgrade at 23,296 tokens) or, under FLEXAM_ATTENTION=sparse, through
B5, beside RIFLEx tables and the streamed VAE. Here a tiny clip takes the
same pieces: a DiT of two 128-wide heads (the kernels' width), RIFLEx, the
streamed encode and decode (VAE_STREAM_THRESHOLD lowered below the clip),
a mask with frame 0 known and a reference image (the ref block), in fp32.
On the CPU each kernel wrapper takes its plain version; JAX's Pallas
kernels run in interpret mode.

  * int8: INT8_AUTO_MIN_TOKENS is lowered to the clip's 40 tokens in both
    packages and JAX's backend choice set to its TPU default (`pallas`, not
    explicit), so both take the auto int8 upgrade for self-attention and
    the exact kernels for cross-attention. Held as
    `tests/test_torch_long_path.py::test_denoise_int8_matches_jax` holds
    its denoise: against int8's own error (the two packages' fp32 q and k
    differ in their last bits, and a value on an int8 rounding tie lands
    one step apart).
  * sparse: FLEXAM_ATTENTION=sparse (window 1): video self-attention
    block-sparse in both, latents at rtol/atol 2e-4, the streamed decode's
    video to one uint8 step.

Weights are the JAX init's (through `from_jax_params`); inputs and noise
are made from numpy seeds (JAX's noise from its seed, handed to the port
as `latents=`).
"""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexam_tpu.core.attention as JA
import flexam_tpu.ops.int8_attention as J8
import flexam_tpu_torch.core.attention as TA
from flexam_tpu import config as jcfg
from flexam_tpu import pipeline as jpipe
from flexam_tpu.models import dit as jdit
from flexam_tpu.models.t5 import init_t5_params
from flexam_tpu.models.vae import init_vae_params
from flexam_tpu_torch import config as tcfg
from flexam_tpu_torch import pipeline as tpipe
from flexam_tpu_torch.io.convert import from_jax_params
from flexam_tpu_torch.ops import int8_attention as T8
from flexam_tpu_torch.ops import launch_counts
from flexam_tpu_torch.ops import sparse_attention as TS

JF = importlib.import_module("flexam_tpu.ops.flash_attention")

# two heads of 128 (the kernels' width)
DIT_128 = dict(dim=256, ffn_dim=256, num_heads=2)
# 13 frames of 64x128: 4 latent frames of 4x8, 8 tokens each, + the ref
# block
FRAMES, HEIGHT, WIDTH = 13, 64, 128
TOKENS = 5 * 8
RIFLEX = dict(k=6, L_test=4)
NOISE_SEED = 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small torch ops beside the other test workers: one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def pipes():
    """A JAX and a port pipeline in fp32 over the same tiny weights, both
    with RIFLEx and a streaming threshold below the clip. Made for each
    test: JAX's pipeline keeps its traced denoise per instance, with the
    attention backend chosen at trace time."""
    jc, tc = jcfg.tiny_test_config(), tcfg.tiny_test_config()
    jc = dataclasses.replace(jc, dit=dataclasses.replace(jc.dit, **DIT_128))
    tc = dataclasses.replace(tc, dit=dataclasses.replace(tc.dit, **DIT_128))
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(23), 3)
    params = (jdit.init_dit_params(k1, jc.dit, dtype=jnp.float32),
              init_vae_params(k2, jc.vae), init_t5_params(k3, jc.t5))
    jp = jpipe.FlexAMGenerationPipeline(
        jpipe.FlexAMModels(cfg=jc, dit_params=params[0],
                           vae_params=params[1], t5_params=params[2]),
        compute_dtype=jnp.float32)
    conv = [from_jax_params(jax.tree_util.tree_map(np.asarray, p),
                            device="cpu") for p in params]
    tp = tpipe.FlexAMGenerationPipeline(
        tpipe.FlexAMModels(cfg=tc, dit_params=conv[0], vae_params=conv[1],
                           t5_params=conv[2]),
        device="cpu", compute_dtype=torch.float32)
    for p in (jp, tp):
        p.VAE_STREAM_THRESHOLD = 1000
        p.enable_riflex(**RIFLEX)
    assert tp._use_streaming(1, FRAMES, HEIGHT, WIDTH)
    return jp, tp


def _inputs():
    rng = np.random.RandomState(31)
    t, h, w = FRAMES, HEIGHT, WIDTH
    mask = np.ones((1, 1, t, h, w), np.float32)
    mask[:, :, 0] = 0.0                       # first frame known
    return dict(video=rng.rand(1, 3, t, h, w).astype(np.float32),
                mask_video=mask,
                control_video=rng.rand(1, 3, t, h, w).astype(np.float32),
                ref_image=rng.rand(1, 3, 1, h, w).astype(np.float32))


def _generate(pipe, output_type):
    """The generate of the tests in one package (JAX's draws its noise from
    NOISE_SEED, the port takes the same noise as `latents=`)."""
    inp = _inputs()
    video = inp.pop("video")
    kw = dict(inp, num_inference_steps=2, guidance_scale=6.0, density=0.3,
              output_type=output_type)
    if isinstance(pipe, jpipe.FlexAMGenerationPipeline):
        return np.asarray(pipe.generate(video, "a fox", seed=NOISE_SEED,
                                        **kw))
    noise = np.asarray(jax.random.normal(
        jax.random.PRNGKey(NOISE_SEED), (1, 8, 4, 4, 8), jnp.float32))
    return np.asarray(pipe.generate(video, "a fox", latents=noise, **kw))


def _generate_both(jp, tp, output_type):
    """The same generate in both packages: (JAX's output, the port's)."""
    return _generate(jp, output_type), _generate(tp, output_type)


def _counting(monkeypatch, module, name):
    """Count the calls of module.name (a plain version) in a list."""
    calls = []
    orig = getattr(module, name)

    def counted(*a, **k):
        calls.append(a[0].shape[1])
        return orig(*a, **k)

    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.fixture
def int8_auto(monkeypatch):
    """The auto int8 upgrade at the tiny clip's token count in both
    packages, JAX at its TPU default backend with its Pallas kernels in
    interpret mode."""
    monkeypatch.setattr(TA, "INT8_AUTO_MIN_TOKENS", TOKENS)
    monkeypatch.setattr(JA, "INT8_AUTO_MIN_TOKENS", TOKENS)
    monkeypatch.setattr(JA, "_backend_choice", functools.lru_cache(
        maxsize=1)(lambda: ("pallas", False)))
    monkeypatch.setattr(J8, "int8_flash_attention", functools.partial(
        J8.int8_flash_attention, interpret=True))
    monkeypatch.setattr(JF, "flash_attention", functools.partial(
        JF.flash_attention, interpret=True))
    monkeypatch.delenv("FLEXAM_ATTENTION", raising=False)
    monkeypatch.delenv("FLEXAM_INT8_AUTO", raising=False)
    TA._default_backend.cache_clear()
    yield
    monkeypatch.undo()
    TA._default_backend.cache_clear()


def test_generate_f32_int8_auto_matches_jax(pipes, int8_auto, monkeypatch):
    """The fp32 long path under the auto ladder: self-attention of the 40
    tokens takes B6 (its plain version) in the port, JAX's int8 Pallas
    kernel in JAX, every denoise step; the latents agree to a tenth of the
    largest, and a hundredth of the mean, difference between int8 and
    exact attention over the same generate (the port's, with the
    threshold one token above the clip)."""
    jp, tp = pipes
    int8_calls = _counting(monkeypatch, T8, "int8_attention_plain")
    ref, got = _generate_both(jp, tp, "latent")
    # 2 steps, CFG batched, 2 blocks: self-attention only
    assert int8_calls == [TOKENS] * 4
    assert got.dtype == np.float32 and got.shape == ref.shape
    monkeypatch.setattr(TA, "INT8_AUTO_MIN_TOKENS", TOKENS + 1)
    exact = _generate(tp, "latent")
    assert len(int8_calls) == 4
    err_int8 = np.abs(got - exact)
    diff = np.abs(got - ref)
    assert err_int8.mean() > 1e-3                  # int8 really ran
    assert diff.max() < 0.1 * err_int8.max(), (diff.max(), err_int8.max())
    assert diff.mean() < 0.01 * err_int8.mean(), (diff.mean(),
                                                   err_int8.mean())
    assert all(n == 0 for n in launch_counts().values())   # CPU: no launches


def test_generate_f32_sparse_matches_jax(pipes, monkeypatch):
    """The fp32 long path under FLEXAM_ATTENTION=sparse (window 1): video
    self-attention block-sparse in both packages (B5's plain version here,
    JAX's sparse Pallas kernel in interpret mode), cross-attention dense;
    latents at 2e-4, the streamed decode's uint8 video to one step."""
    jp, tp = pipes
    monkeypatch.setenv("FLEXAM_ATTENTION", "sparse")
    monkeypatch.setenv("FLEXAM_SPARSE_WINDOW", "1")
    for mod in (TA, JA):
        mod._default_backend.cache_clear()
    sparse_calls = _counting(monkeypatch, TS, "masked_dense_attention")
    try:
        ref, got = _generate_both(jp, tp, "latent")
        assert sparse_calls == [TOKENS] * 4
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
        ref_video, video = _generate_both(jp, tp, "np")
    finally:
        monkeypatch.delenv("FLEXAM_ATTENTION")
        for mod in (TA, JA):
            mod._default_backend.cache_clear()
    assert video.shape == (1, 3, FRAMES, HEIGHT, WIDTH)
    assert np.isfinite(video).all() and 0.0 <= video.min() <= video.max() \
        <= 1.0
    np.testing.assert_allclose(video, ref_video, rtol=0, atol=1.01 / 255)
    dense = _generate(tp, "latent")
    assert np.abs(got - dense).max() > 1e-3     # the mask changes the result
