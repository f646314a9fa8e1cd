"""The long-clip attention of the port against the JAX package, on the CPU:
the sparsity policy, B5's and B6's plain versions against the Pallas
kernels in interpret mode, and the backend ladder's decisions.

Inputs are made from numpy seeds and handed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexam_tpu.core.attention as JA
from flexam_tpu.ops import int8_attention as J8
from flexam_tpu.ops import sparse_attention as JS
import flexam_tpu_torch.core.attention as TA
from flexam_tpu_torch.ops import int8_attention as T8
from flexam_tpu_torch.ops import sparse_attention as TS
from flexam_tpu_torch.ops.flash_attention import attention_plain

F32 = dict(rtol=2e-4, atol=1e-5)


def _qkv(seed, b, lq, lk, h, d=128):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, lq, h, d).astype(np.float32),
            rs.randn(b, lk, h, d).astype(np.float32),
            rs.randn(b, lk, h, d).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# --------------------------------------------------------------------------
# B5: policy, plain version, dispatch
# --------------------------------------------------------------------------

@pytest.mark.parametrize("frames,spatial,ref,window,group", [
    (51, 448, 448, 2, None),     # 512x896x201f: 26 blocks of 896, 147 pairs
    (25, 448, 448, 2, None),     # 512x896x97f
    (4, 8, 8, 1, None),
    (7, 12, 0, 0, None),
    (6, 40, 40, 2, 1),
])
def test_sparse_policy_matches_jax(frames, spatial, ref, window, group):
    args = (frames, spatial, ref, window, group)
    pj, pt = JS.video_sparse_policy(*args), TS.video_sparse_policy(*args)
    assert pt == pj
    kj, nj = JS.rows_to_arrays(pj["rows"])
    kt, nt = TS.rows_to_arrays(pt["rows"])
    np.testing.assert_array_equal(kt, kj)
    np.testing.assert_array_equal(nt, nj)
    assert TS.pick_group(len(pt["rows"]), spatial) == JS.pick_group(
        len(pj["rows"]), spatial)
    if (frames, spatial) == (51, 448):
        assert (pt["blk"], len(pt["rows"]), int(nt.sum())) == (896, 26, 147)


@pytest.mark.parametrize("frames,window,blk", [(5, 1, 64), (4, 0, 40)])
def test_sparse_plain_matches_pallas(frames, window, blk):
    """B 1, H 2, D 128: the plain version (`masked_dense_attention`, which
    a CPU tensor takes) against the Pallas kernel in interpret mode, for
    blocks of 64 tokens and of 40 (a multiple of 8 only)."""
    rows = JS.video_block_rows(frames, window=window)
    L = len(rows) * blk
    q, k, v = _qkv(1, 1, L, L, 2)
    ref = np.asarray(JS.sparse_flash_attention(*_j(q, k, v), rows, blk,
                                               interpret=True))
    got = TS.sparse_flash_attention(*_t(q, k, v), rows, blk)
    np.testing.assert_allclose(got.numpy(), ref, **F32)
    dense = attention_plain(*_t(q, k, v))
    assert np.abs(got.numpy() - dense.numpy()).max() > 1e-2  # the mask bites


def test_sparse_attn_fn_dispatch():
    """Video self-attention of the geometry goes block-sparse; cross-
    attention, a k_len mask and other lengths go to dense attention."""
    fn_t = TS.make_sparse_attn_fn(4, 8, ref_tokens=8, window=1)
    fn_j = JS.make_sparse_attn_fn(4, 8, ref_tokens=8, window=1,
                                  interpret=True)
    q, k, v = _qkv(2, 1, 40, 40, 2)
    np.testing.assert_allclose(fn_t(*_t(q, k, v)).numpy(),
                               np.asarray(fn_j(*_j(q, k, v))), **F32)
    qc, kc, vc = _qkv(3, 1, 40, 16, 2)
    np.testing.assert_allclose(fn_t(*_t(qc, kc, vc)).numpy(),
                               attention_plain(*_t(qc, kc, vc)).numpy(),
                               **F32)
    kl = torch.tensor([30])
    np.testing.assert_allclose(fn_t(*_t(q, k, v), k_len=kl).numpy(),
                               attention_plain(*_t(q, k, v),
                                               k_len=kl).numpy(), **F32)


# --------------------------------------------------------------------------
# B6: quantization, plain version
# --------------------------------------------------------------------------

@pytest.mark.parametrize("L", [256, 1100])
def test_int8_quantization_matches_jax(L):
    """q and k quantize to the same int8 values and scales as the JAX
    wrapper, per quantization block (1,100 rows: one block of 1,024 and a
    padded second one)."""
    q, k, _ = _qkv(4, 2, L, L, 2)
    blk = T8.quant_block(L)
    assert blk == min(J8._auto_block(L), J8._ceil_to(L, 128))
    pad = -(-L // blk) * blk - L

    def jax_quant(x):
        xt = jnp.pad(jnp.transpose(jnp.asarray(x), (0, 2, 1, 3)),
                     ((0, 0), (0, 0), (0, pad), (0, 0)))
        x8, s = J8._quantize_blocks(xt, blk)
        return (np.asarray(x8)[:, :, :L].transpose(0, 2, 1, 3),
                np.repeat(np.asarray(s), blk, axis=2)[:, :, :L])

    q8, qs, k8, ks = T8.quantize_qk(*_t(q, k))
    want = jax_quant(q)
    np.testing.assert_array_equal(q8.numpy(), want[0])
    np.testing.assert_array_equal(qs.numpy(), want[1])
    # k: the same blocks from the same smoothed keys
    kt = jnp.transpose(jnp.asarray(k), (0, 2, 1, 3))
    k_smooth = np.array(kt - jnp.mean(kt, axis=2, keepdims=True)
                        ).transpose(0, 2, 1, 3).copy()
    k8s, kss = T8.quantize_blocks(torch.from_numpy(k_smooth), blk)
    want = jax_quant(k_smooth)
    np.testing.assert_array_equal(k8s.numpy(), want[0])
    np.testing.assert_array_equal(
        kss.repeat_interleave(blk, dim=2)[:, :, :L].numpy(), want[1])
    # end to end, the fp32 key mean may differ in its last bit between the
    # two frameworks' sum orders: scales within 2 fp32 ulps, and an int8
    # value off by one only where the division lands on a rounding tie
    np.testing.assert_allclose(ks.numpy(), want[1], rtol=2.4e-7, atol=0)
    diff = np.abs(k8.numpy().astype(np.int32) - want[0].astype(np.int32))
    assert diff.max() <= 1 and diff.mean() < 1e-3


@pytest.mark.parametrize("B,L,H,k_len", [(1, 256, 2, None),
                                         (2, 1100, 1, [1100, 700])])
def test_int8_plain_matches_pallas(B, L, H, k_len):
    """B6's plain version against `int8_flash_attention(interpret=True)`:
    the same int8 logits, so fp32 agreement; at 1,100 tokens with a k_len
    mask the Pallas kernel runs two key blocks (online softmax) and the
    plain version one softmax per row. Against exact attention the error
    stays under the JAX test's 0.02 mean relative bound."""
    q, k, v = _qkv(5, B, L, L, H)
    kl_j = None if k_len is None else jnp.asarray(k_len, jnp.int32)
    kl_t = None if k_len is None else torch.tensor(k_len)
    ref = np.asarray(J8.int8_flash_attention(*_j(q, k, v), k_len=kl_j,
                                             interpret=True))
    got = T8.int8_attention(*_t(q, k, v), k_len=kl_t).numpy()
    np.testing.assert_allclose(got, ref, **F32)
    exact = attention_plain(*_t(q, k, v), k_len=kl_t).numpy()
    assert np.abs(got - exact).mean() / np.abs(exact).mean() < 0.02


def test_int8_plain_matches_pallas_block_scales():
    """As above at 1,584 tokens (three quantization blocks of 528), with q
    rows and keys whose size alternates by 4x from one block to the next:
    each block's scale is its own, in the port as in JAX."""
    L = 1584
    blk = T8.quant_block(L)
    assert blk == 528
    odd = (np.arange(L) // blk) % 2 == 1
    fq, fk = (np.where(odd == o, 0.5, 2.0).astype(np.float32)[:, None, None]
              for o in (True, False))
    q, k, v = _qkv(6, 1, L, L, 1)
    q, k = q * fq, k * fk
    ref = np.asarray(J8.int8_flash_attention(*_j(q, k, v), interpret=True))
    got = T8.int8_attention(*_t(q, k, v)).numpy()
    np.testing.assert_allclose(got, ref, **F32)


# --------------------------------------------------------------------------
# the backend ladder
# --------------------------------------------------------------------------

def test_resolve_backend_matches_jax(monkeypatch):
    """The decisions of tests/test_attention.py (int8 auto-upgrade) for both
    packages: long self-attention upgrades under the auto default, never
    cross-attention, never an explicit choice; FLEXAM_INT8_AUTO=0 opts
    out."""
    monkeypatch.delenv("FLEXAM_INT8_AUTO", raising=False)
    L = TA.INT8_AUTO_MIN_TOKENS
    assert L == JA.INT8_AUTO_MIN_TOKENS == 23296
    cases = [((L, L), None), ((L + 448, L + 448), None), ((11648, 11648), None),
             ((L, 512), None), ((L, L), "pallas")]
    for choice in (("pallas", False), ("pallas", True), ("xla", False)):
        monkeypatch.setattr(JA, "_backend_choice", lambda c=choice: c)
        monkeypatch.setattr(TA, "_backend_choice", lambda c=choice: c)
        for (lq, lk), backend in cases:
            assert (TA.resolve_backend(lq, lk, backend)
                    == JA.resolve_backend(lq, lk, backend))
    monkeypatch.setattr(TA, "_backend_choice", lambda: ("pallas", False))
    assert TA.resolve_backend(L, L) == "pallas_int8"
    assert TA.resolve_backend(L, 512) == "pallas"
    monkeypatch.setenv("FLEXAM_INT8_AUTO", "0")
    assert TA.resolve_backend(L, L) == "pallas"


@pytest.mark.parametrize("env,want", [
    ("pallas", ("pallas", True)), ("pallas_int8", ("pallas_int8", True)),
    ("xla", ("xla", True)), ("flash_attn_3", ("pallas", True)),
    ("flash", ("pallas", True)), ("sage", ("pallas_int8", True)),
    ("SageAttn", ("pallas_int8", True)), ("torch_sdpa", ("xla", True)),
    ("sparse", ("pallas", False)), ("", ("pallas", False))])
def test_backend_env_names(monkeypatch, env, want):
    """FLEXAM_ATTENTION names what it names in the JAX package; the auto
    default is the port's kernels (JAX picks xla off the TPU)."""
    monkeypatch.setenv("FLEXAM_ATTENTION", env)
    for mod in (TA, JA):
        mod._default_backend.cache_clear()
    try:
        assert TA._backend_choice() == want
        jb, je = JA._backend_choice()
        assert je == want[1] and (jb == want[0] or not je)
    finally:
        monkeypatch.delenv("FLEXAM_ATTENTION")
        for mod in (TA, JA):
            mod._default_backend.cache_clear()


def test_explicit_int8_routes_cross_attention(monkeypatch):
    """An explicit int8 choice sends every call through B6, cross-attention
    over text tokens included; the auto default keeps it exact."""
    q, k, v = _qkv(6, 1, 300, 16, 2)
    exact = attention_plain(*_t(q, k, v)).numpy()
    monkeypatch.setenv("FLEXAM_ATTENTION", "sage")
    TA._default_backend.cache_clear()
    try:
        assert TA.resolve_backend(300, 16) == "pallas_int8"
        got = TA.attention(*_t(q, k, v)).numpy()
        np.testing.assert_array_equal(
            got, T8.int8_attention_plain(*_t(q, k, v)).numpy())
        np.testing.assert_allclose(
            got, np.asarray(J8.int8_flash_attention(*_j(q, k, v),
                                                    interpret=True)), **F32)
        assert np.abs(got - exact).max() > 0
    finally:
        monkeypatch.delenv("FLEXAM_ATTENTION")
        TA._default_backend.cache_clear()
    np.testing.assert_allclose(TA.attention(*_t(q, k, v)).numpy(), exact,
                               **F32)


def test_xla_backend_is_the_plain_version_on_cpu():
    q, k, v = _qkv(7, 1, 20, 30, 1, d=64)
    np.testing.assert_array_equal(
        TA.attention(*_t(q, k, v), backend="xla").numpy(),
        attention_plain(*_t(q, k, v)).numpy())
    # head dims B6 does not take go to exact attention, as in JAX
    np.testing.assert_allclose(
        TA.attention(*_t(q, k, v), backend="pallas_int8").numpy(),
        np.asarray(JA.attention(*_j(q, k, v), backend="pallas_int8")),
        **F32)
