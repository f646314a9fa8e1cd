"""The port's kernel modules (B1-B4) against the JAX Pallas kernels.

The JAX side runs the Pallas kernels in interpret mode on the CPU, as the
JAX package's own tests do; the port side runs each kernel's plain PyTorch
version (the path its wrappers take for CPU tensors), on the same inputs
made with numpy from a seed. head_dim is 128, the kernels' production
width. fp32 is held at rtol 2e-4 / atol 1e-5 (the suite's tolerance);
bf16 at one bf16 ulp (rtol 8e-3), since the two frameworks may round an
intermediate differently by one ulp.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexam_tpu.core.rope import build_video_rope, make_rope_tables
from flexam_tpu.ops.flash_attention import flash_attention as jax_flash
from flexam_tpu.ops.fused import ln_modulation as jax_ln_mod
from flexam_tpu.ops.fused import rmsnorm_rope as jax_rmsnorm_rope
from flexam_tpu_torch.core import attention as tattn
from flexam_tpu_torch.ops import fused as tfused

tflash = importlib.import_module("flexam_tpu_torch.ops.flash_attention")

F32 = dict(rtol=2e-4, atol=1e-5)
BF16 = dict(rtol=8e-3, atol=8e-3)


def _qkv(seed, b, lq, lk, h, d=128):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, lq, h, d).astype(np.float32),
            rs.randn(b, lk, h, d).astype(np.float32),
            rs.randn(b, lk, h, d).astype(np.float32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


@pytest.mark.parametrize("k_len", [None, [300, 129]])
def test_flash_attention_ragged(k_len):
    """B1: Lq and Lk divide no tile; optional per-batch key mask."""
    q, k, v = _qkv(0, 2, 200, 300, 2)
    kl = None if k_len is None else np.asarray(k_len, np.int32)
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               k_len=None if kl is None else jnp.asarray(kl),
                               interpret=True))
    got = tflash.flash_attention(_t(q), _t(k), _t(v),
                                 k_len=None if kl is None
                                 else torch.from_numpy(kl))
    assert got.shape == (2, 200, 2, 128)
    np.testing.assert_allclose(got.numpy(), ref, **F32)
    assert tflash.launches["flash_attention"] == 0   # plain path, no launch


@pytest.mark.parametrize("k_len", [None, [96, 40]])
def test_single_kv_attention(k_len):
    """B2: all keys (<= 512) in one block, as the DiT cross-attention."""
    q, k, v = _qkv(1, 2, 150, 96, 3)
    kl = None if k_len is None else np.asarray(k_len, np.int32)
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               k_len=None if kl is None else jnp.asarray(kl),
                               interpret=True))
    got = tflash.single_kv_attention(_t(q), _t(k), _t(v),
                                     k_len=None if kl is None
                                     else torch.from_numpy(kl))
    np.testing.assert_allclose(got.numpy(), ref, **F32)


def test_single_kv_rejects_long_keys():
    q, k, v = (torch.zeros(1, 4, 1, 128), torch.zeros(1, 513, 1, 128),
               torch.zeros(1, 513, 1, 128))
    with pytest.raises(ValueError):
        tflash.single_kv_attention(q, k, v)


def test_attention_dispatch_on_cpu(monkeypatch):
    """The dispatcher takes the plain version for CPU tensors; under
    FLEXAM_ATTENTION=sparse a generic call (not the pipeline's video
    self-attention) takes the dense default, as in the JAX package."""
    q, k, v = _qkv(2, 1, 20, 30, 2)
    got = tattn.attention(_t(q), _t(k), _t(v))
    ref = tflash.attention_plain(_t(q), _t(k), _t(v), q_chunk=7)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6, atol=1e-6)
    monkeypatch.setenv("FLEXAM_ATTENTION", "sparse")
    tattn._default_backend.cache_clear()
    try:
        assert tattn.resolve_backend(20, 30) == "pallas"
        np.testing.assert_array_equal(
            tattn.attention(_t(q), _t(k), _t(v)).numpy(), got.numpy())
    finally:
        monkeypatch.delenv("FLEXAM_ATTENTION")
        tattn._default_backend.cache_clear()


def _rope_inputs(seed, b, s, heads, dh=128, grid=(2, 4, 5)):
    rs = np.random.RandomState(seed)
    x = rs.randn(b, s, heads * dh).astype(np.float32)
    gamma = (1.0 + 0.1 * rs.randn(heads * dh)).astype(np.float32)
    tables = jnp.asarray(make_rope_tables(dh, 64))
    cos, sin = build_video_rope(tables, grid, dh)   # 40 rotated tokens
    return x, gamma, np.asarray(cos), np.asarray(sin)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_rope_with_unrotated_tail(dtype):
    """B3: RMSNorm over all heads + RoPE; tokens 40..47 are past the table."""
    x, gamma, cos, sin = _rope_inputs(3, 2, 48, 3)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    ref = jax_rmsnorm_rope(jnp.asarray(x, jd), jnp.asarray(gamma, jd),
                           jnp.asarray(cos), jnp.asarray(sin), 3,
                           interpret=True)
    got = tfused.rmsnorm_rope(_t(x, td), _t(gamma, td), _t(cos), _t(sin), 3)
    assert got.shape == (2, 48, 3, 128) and got.dtype == td
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32),
                               **(F32 if dtype == "float32" else BF16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["binary", "bcast"])
def test_ln_modulation(mode, dtype):
    """B4 in both modes: per-token (shift, scale) pair select by a [B, S]
    mask, or per-batch terms."""
    rs = np.random.RandomState(4)
    b, s, d = 2, 40, 256
    x = rs.randn(b, s, d).astype(np.float32)
    rows = (b, 2, d) if mode == "binary" else (b, d)
    sh = rs.randn(*rows).astype(np.float32)
    sc = rs.randn(*rows).astype(np.float32)
    mask = ((rs.rand(b, s) > 0.5).astype(np.float32) if mode == "binary"
            else None)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    ref = jax_ln_mod(jnp.asarray(x, jd), jnp.asarray(sh), jnp.asarray(sc),
                     mask=None if mask is None else jnp.asarray(mask),
                     interpret=True)
    got = tfused.ln_modulation(_t(x, td), _t(sh), _t(sc),
                               mask=None if mask is None else _t(mask))
    assert got.dtype == td
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32),
                               **(F32 if dtype == "float32" else BF16))


def test_ulp_bf16_is_the_bf16_spacing():
    from flexam_tpu_torch.testing import ulp_bf16
    rs = np.random.RandomState(5)
    x = torch.from_numpy(np.abs(rs.randn(4096) * 10.0 ** rs.uniform(
        -6, 4, 4096)).astype(np.float32)).to(torch.bfloat16)
    x = x[x > 0]
    nxt = (x.view(torch.int16) + 1).view(torch.bfloat16)
    np.testing.assert_array_equal((nxt.float() - x.float()).numpy(),
                                  ulp_bf16(x).numpy())


def test_ln_modulation_bound_catches_rmsnorm():
    """The B4 bound the chip checks use holds a one-ulp rounding flip and
    refuses RMSNorm in place of LayerNorm on rows with their own offset."""
    from flexam_tpu_torch.core.layers import rms_norm
    from flexam_tpu_torch.testing import check_ln_modulation
    rs = np.random.RandomState(6)
    b, s, d = 2, 64, 256
    x = _t(rs.randn(b, s, d) * np.exp(0.5 * rs.randn(b, s, 1))
           + 4.0 * rs.randn(b, s, 1), torch.bfloat16)
    sh, sc = _t(rs.randn(b, 2, d)), _t(rs.randn(b, 2, d))
    mask = _t(rs.rand(b, s) > 0.5)
    ref = tfused.ln_modulation_plain(x, sh, sc, mask=mask)
    flipped = ref.clone()
    flipped.view(-1)[7] = (ref.view(-1)[7:8].view(torch.int16) + 1).view(
        torch.bfloat16)[0]
    check_ln_modulation(flipped, ref, sh, mask, "one ulp")
    m = mask[:, :, None]
    shs = m * sh[:, 0:1] + (1 - m) * sh[:, 1:2]
    scs = m * sc[:, 0:1] + (1 - m) * sc[:, 1:2]
    rms = rms_norm(x, torch.ones(d, dtype=torch.bfloat16), 1e-6)
    wrong = (rms * (1.0 + scs.to(x.dtype)) + shs.to(x.dtype)).to(x.dtype)
    with pytest.raises(AssertionError):
        check_ln_modulation(wrong, ref, sh, mask, "rmsnorm")
