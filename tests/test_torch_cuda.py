"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need a CUDA device and skip without one. On a machine with an H100:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(`--noconftest`: the suite's conftest configures JAX, which this file does
not use.) Shapes here are the edge cases the smoke's flagship shapes do not
reach: ragged lengths, per-batch key masks, tokens past the RoPE table.
Each element is held to a few bf16 ulps of its own size, with the bounds
`chip_smoke.py` uses (`flexam_tpu_torch/testing.py` states them and why).
"""

import pytest
import torch

from flexam_tpu_torch.ops import flash_attention as fa
from flexam_tpu_torch.ops import fused
from flexam_tpu_torch.testing import (check_attention, check_ln_modulation,
                                      check_rmsnorm_rope)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rand(dev, *shape, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)


@pytest.mark.parametrize("lq,lk,k_len", [(200, 300, None), (200, 300, [300, 129]),
                                         (1, 2000, [1, 1999]), (77, 64, None)])
def test_flash_attention_edges(dev, lq, lk, k_len):
    q, k, v = (_rand(dev, 2, lq, 3, 128, seed=1), _rand(dev, 2, lk, 3, 128, seed=2),
               _rand(dev, 2, lk, 3, 128, seed=3))
    kl = None if k_len is None else torch.tensor(k_len, device=dev)
    before = fa.launches["flash_attention"]
    got = fa.flash_attention(q, k, v, k_len=kl)
    torch.cuda.synchronize()
    assert fa.launches["flash_attention"] == before + 1
    check_attention(got, fa.attention_plain(q, k, v, k_len=kl), "B1")


@pytest.mark.parametrize("lk,k_len", [(96, None), (96, [96, 40]), (512, None),
                                      (1, None), (300, [5, 300])])
def test_single_kv_attention_edges(dev, lk, k_len):
    q, k, v = (_rand(dev, 2, 150, 2, 128, seed=4), _rand(dev, 2, lk, 2, 128, seed=5),
               _rand(dev, 2, lk, 2, 128, seed=6))
    kl = None if k_len is None else torch.tensor(k_len, device=dev)
    got = fa.single_kv_attention(q, k, v, k_len=kl)
    torch.cuda.synchronize()
    check_attention(got, fa.attention_plain(q, k, v, k_len=kl), "B2")


def test_attention_rejects_unsupported(dev):
    q = _rand(dev, 1, 8, 2, 64)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)                       # head_dim 64
    q = _rand(dev, 1, 8, 2, 128)
    with pytest.raises(TypeError):
        fa.flash_attention(q.float(), q.float(), q.float())
    with pytest.raises(ValueError):
        fa.flash_attention(q.transpose(1, 2), q.transpose(1, 2),
                           q.transpose(1, 2))             # not contiguous


@pytest.mark.parametrize("s,l_rot", [(48, 40), (1, 1), (300, 300), (33, 64)])
def test_rmsnorm_rope_edges(dev, s, l_rot):
    x = _rand(dev, 2, s, 3 * 128, seed=7)
    gamma = 1.0 + 0.1 * _rand(dev, 3 * 128, seed=8)
    ang = torch.rand((l_rot, 64), device=dev) * 6.0
    got = fused.rmsnorm_rope(x, gamma, torch.cos(ang), torch.sin(ang), 3)
    ref = fused.rmsnorm_rope_plain(x, gamma, torch.cos(ang), torch.sin(ang), 3)
    torch.cuda.synchronize()
    check_rmsnorm_rope(got, ref, "B3")


@pytest.mark.parametrize("mode", ["binary", "bcast"])
@pytest.mark.parametrize("s,d", [(13, 256), (300, 3072), (1, 128)])
def test_ln_modulation_edges(dev, mode, s, d):
    # rows with their own offset and scale, as DiT hidden states have
    x = (_rand(dev, 2, s, d, seed=9).float()
         * torch.exp(0.5 * _rand(dev, 2, s, 1, seed=10).float())
         + 4.0 * _rand(dev, 2, s, 1, seed=11).float()).to(torch.bfloat16)
    terms = (2, 2, d) if mode == "binary" else (2, d)
    sh = torch.randn(terms, device=dev)
    sc = torch.randn(terms, device=dev)
    mask = (torch.rand((2, s), device=dev) > 0.5).float() \
        if mode == "binary" else None
    got = fused.ln_modulation(x, sh, sc, mask=mask)
    ref = fused.ln_modulation_plain(x, sh, sc, mask=mask)
    torch.cuda.synchronize()
    check_ln_modulation(got, ref, sh, mask, "B4")
