"""The dispatcher's exact branch (ROADMAP B-hd's dispatch half) on the CPU:
head dims the kernels do not take (not a multiple of 128) go to
`exact_attention` for the pallas and pallas_int8 backends alike, equal to
JAX's `attention()` there (its `xla_attention` fallback) at fp32 rtol 2e-4;
`exact_calls` counts each such call and none at head_dim 128."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexam_tpu.core import attention as jattn
from flexam_tpu_torch.core import attention as tattn


def _qkv(d, lq=40, lk=56, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randn(2, n, 3, d).astype(np.float32) for n in (lq, lk, lk)]


@pytest.mark.parametrize("backend", ["pallas", "pallas_int8"])
@pytest.mark.parametrize("d", [24, 64])
@pytest.mark.parametrize("k_len", [None, [56, 17]])
def test_exact_branch_matches_jax(backend, d, k_len):
    q, k, v = _qkv(d)
    kl = None if k_len is None else np.asarray(k_len, np.int32)
    ref = jattn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          k_len=None if kl is None else jnp.asarray(kl),
                          backend=backend)
    before = tattn.exact_calls["exact_attention"]
    got = tattn.attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v),
                          k_len=None if kl is None else torch.from_numpy(kl),
                          backend=backend)
    assert tattn.exact_calls["exact_attention"] == before + 1
    assert got.shape == q.shape and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-5)


@pytest.mark.parametrize("backend", ["pallas", "pallas_int8", None])
def test_head_dim_128_takes_no_exact_branch(backend):
    q, k, v = (torch.from_numpy(a) for a in _qkv(128, lq=16, lk=16))
    before = tattn.exact_calls["exact_attention"]
    out = tattn.attention(q, k, v, backend=backend)
    assert out.shape == q.shape
    assert tattn.exact_calls["exact_attention"] == before


def test_tiny_dit_forward_counts_the_branch():
    """A tiny DiT forward (head_dim 24) sends each block's self- and
    cross-attention through the exact branch."""
    from flexam_tpu_torch.config import tiny_test_config
    from flexam_tpu_torch.models.dit import dit_forward, init_dit_params

    cfg = tiny_test_config().dit
    params = init_dit_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    g = torch.Generator().manual_seed(1)
    x = torch.randn((1, cfg.in_dim, 2, 4, 4), generator=g)
    ctx = torch.randn((1, cfg.text_len, cfg.text_dim), generator=g)
    before = tattn.exact_calls["exact_attention"]
    out = dit_forward(params, cfg, x, torch.full((1,), 500.0), ctx)
    assert out.shape == (1, cfg.out_dim, 2, 4, 4)
    assert bool(out.isfinite().all())
    assert tattn.exact_calls["exact_attention"] - before == \
        2 * cfg.num_layers
