"""Head dims above 128 in the port against the JAX package, on the CPU.

JAX's attention kernels take any head dim that is a multiple of 128, and so
do the port's: B1, B2, B5 and B6 (their plain versions here, which a CPU
tensor takes) against the Pallas kernels in interpret mode at head dims 256
and 384, and B2 at 128 on the edges of the card's tiles there; the dispatcher at 256 (the kernels, never the exact branch, equal
to JAX's `attention()`); a DiT of two 256-wide heads against JAX's
`dit_forward` with its Pallas B3/B4 in interpret mode; and the choice of
kernel instance the card makes for each head dim.

Inputs are made from numpy seeds and handed to both packages; fp32 is held
at rtol 2e-4 / atol 2e-5, bf16 (B2 at head dim 128) to `check_attention`'s
bound.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexam_tpu.core.attention as JA
from flexam_tpu import config as jcfg
from flexam_tpu.models import dit as jdit
from flexam_tpu.ops import int8_attention as J8
from flexam_tpu.ops import sparse_attention as JS
import flexam_tpu_torch.core.attention as TA
from flexam_tpu_torch import config as tcfg
from flexam_tpu_torch.io.convert import from_jax_params
from flexam_tpu_torch.models import dit as tdit
from flexam_tpu_torch.ops import int8_attention as T8
from flexam_tpu_torch.ops import sparse_attention as TS
from flexam_tpu_torch.testing import check_attention

# the modules (each package's `ops.flash_attention` names the function)
JF = importlib.import_module("flexam_tpu.ops.flash_attention")
TF = importlib.import_module("flexam_tpu_torch.ops.flash_attention")

F32 = dict(rtol=2e-4, atol=2e-5)
HEAD_DIMS = (256, 384)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small torch ops beside the other test workers: one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(seed, b, lq, lk, h, d):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, lq, h, d).astype(np.float32),
            rs.randn(b, lk, h, d).astype(np.float32),
            rs.randn(b, lk, h, d).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("kernel,lk,k_len", [
    ("flash_attention", 700, [700, 77]),     # B1: key blocks, a ragged mask
    ("single_kv_attention", 96, [96, 5]),    # B2: one key block
])
def test_exact_kernels_match_pallas(d, kernel, lk, k_len):
    """B1 and B2 (plain versions) against JAX's `flash_attention` in
    interpret mode, which runs its online-softmax kernel over several key
    blocks at 700 keys and its single-block kernel at 96."""
    q, k, v = _qkv(1, 2, 130, lk, 1, d)
    ref = np.asarray(JF.flash_attention(
        *_j(q, k, v), k_len=jnp.asarray(k_len, jnp.int32), interpret=True))
    got = getattr(TF, kernel)(*_t(q, k, v), k_len=torch.tensor(k_len))
    np.testing.assert_allclose(got.numpy(), ref, **F32)


@pytest.mark.parametrize("kernel,lk,k_len", [
    ("flash_attention", 1, None),
    ("flash_attention", 79, [79, 1]),
    ("flash_attention", 80, [80, 79]),
    ("flash_attention", 81, [81, 80]),
    ("flash_attention", 159, [79, 80]),
    ("flash_attention", 161, [161, 81]),
    ("flash_attention", 640, [0, 161]),
    ("flash_attention", 11648, [11648, 11601]),
    ("single_kv_attention", 1, None),
    ("single_kv_attention", 80, [80, 64]),
    ("single_kv_attention", 400, [400, 81]),
    ("single_kv_attention", 511, [511, 63]),
    ("single_kv_attention", 512, [0, 512]),
])
def test_d256_tile_edges_match_pallas(kernel, lk, k_len):
    """B1 and B2 (plain versions) at head dim 256 on the key counts and
    k_len edges of the card's tiles there (B1 80 keys a tile, B2 64),
    against JAX's `flash_attention` in interpret mode. k_len 0 only where
    JAX pads no key (640, 512): it masks its padding keys as it masks the
    rest, so a row with every key masked averages over them too."""
    q, k, v = _qkv(11, 2, 33, lk, 1, 256)
    kl = None if k_len is None else k_len
    ref = np.asarray(JF.flash_attention(
        *_j(q, k, v), k_len=None if kl is None else jnp.asarray(kl,
                                                                jnp.int32),
        interpret=True))
    got = getattr(TF, kernel)(*_t(q, k, v),
                              k_len=None if kl is None else torch.tensor(kl))
    np.testing.assert_allclose(got.numpy(), ref, **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lk,k_len", [
    (1, None),
    (63, [63, 62]),
    (64, [64, 63]),
    (65, [65, 64]),
    (127, [127, 65]),
    (128, [128, 0]),
    (129, [129, 128]),
    (300, [257, 127]),
    (511, [511, 449]),
    (512, [0, 385]),
])
def test_d128_single_kv_tile_edges_match_pallas(lk, k_len, dtype):
    """B2 (plain version) at head dim 128, bf16 and fp32, on the key counts
    and k_len edges of the card's tiles there (bf16 128 keys a tile, fp32
    64), against JAX's `flash_attention` in interpret mode (its
    single-block kernel). fp32 at rtol 2e-4 / atol 2e-5; bf16 within
    `check_attention`'s bound (JAX rounds each probability to bf16 before
    normalising, the plain version after). k_len 0 only where JAX pads no
    key (128, 512)."""
    q, k, v = _qkv(13, 2, 65, lk, 1, 128)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    ref = JF.flash_attention(
        *(jnp.asarray(a, jd) for a in (q, k, v)),
        k_len=None if k_len is None else jnp.asarray(k_len, jnp.int32),
        interpret=True)
    got = TF.single_kv_attention(
        *(t.to(td) for t in _t(q, k, v)),
        k_len=None if k_len is None else torch.tensor(k_len))
    assert got.dtype == td
    ref = torch.from_numpy(np.array(ref, np.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), ref.numpy(), **F32)
    else:
        check_attention(got, ref, f"B2 d128 bf16 lk {lk}")


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_int8_plain_matches_pallas(d):
    """B6's plain version against `int8_flash_attention(interpret=True)`:
    quantization blocks of the whole head dim, as in JAX."""
    q, k, v = _qkv(2, 1, 200, 200, 2, d)
    k_len = [150]
    ref = np.asarray(J8.int8_flash_attention(
        *_j(q, k, v), k_len=jnp.asarray(k_len, jnp.int32), interpret=True))
    got = T8.int8_attention(*_t(q, k, v), k_len=torch.tensor(k_len))
    np.testing.assert_allclose(got.numpy(), ref, **F32)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_sparse_plain_matches_pallas(d):
    """B5's plain version under a `video_block_rows` policy (4 frames and
    the ref block, window 1, blocks of 64 tokens) against the Pallas
    kernel in interpret mode."""
    rows = JS.video_block_rows(4, window=1)
    assert rows == TS.video_block_rows(4, window=1)
    blk = 64
    L = len(rows) * blk
    q, k, v = _qkv(3, 1, L, L, 1, d)
    ref = np.asarray(JS.sparse_flash_attention(*_j(q, k, v), rows, blk,
                                               interpret=True))
    got = TS.sparse_flash_attention(*_t(q, k, v), rows, blk)
    np.testing.assert_allclose(got.numpy(), ref, **F32)


@pytest.mark.parametrize("backend,jax_kernel", [
    ("pallas", (JF, "flash_attention")),
    ("pallas_int8", (J8, "int8_flash_attention")),
])
def test_dispatch_at_head_dim_256(backend, jax_kernel, monkeypatch):
    """At head dim 256 the dispatcher takes the kernels (on the CPU their
    plain versions), never the exact branch, for self-attention and for
    cross-attention over 512 keys, and equals JAX's `attention()` with its
    Pallas kernel in interpret mode."""
    module, name = jax_kernel
    monkeypatch.setattr(module, name, functools.partial(
        getattr(module, name), interpret=True))
    q, k, v = _qkv(4, 1, 160, 512, 1, 256)
    calls = TA.exact_calls["exact_attention"]
    for kk, vv in ((q, q), (k, v)):
        got = TA.attention(*_t(q, kk, vv), backend=backend)
        ref = np.asarray(JA.attention(*_j(q, kk, vv), backend=backend))
        np.testing.assert_allclose(got.numpy(), ref, **F32)
    assert TA.exact_calls["exact_attention"] == calls


def test_dit_forward_head_dim_256(monkeypatch):
    """A DiT of 2 heads of 256 (dim 512, 2 blocks): the kernel path (B3 for
    q/k, B4 for the prologues, the attention kernels' plain versions)
    against JAX's `dit_forward` with its Pallas B3/B4 in interpret mode."""
    monkeypatch.setenv("FLEXAM_FUSED", "interpret")
    kw = dict(dim=512, ffn_dim=512, num_heads=2, num_layers=2, in_dim=8,
              out_dim=4, text_dim=32, text_len=6, freq_dim=32,
              add_ref_conv=False, add_cnn_block=False)
    jc, tc = jcfg.DiTConfig(**kw), tcfg.DiTConfig(**kw)
    assert tc.head_dim == 256 and tdit.use_kernels(tc.head_dim)
    params = jdit.init_dit_params(jax.random.PRNGKey(0), jc, dtype=jnp.float32)
    rs = np.random.RandomState(6)
    x = rs.randn(1, 4, 2, 4, 4).astype(np.float32)
    inputs = dict(t=np.asarray([500.0], np.float32),
                  context=rs.randn(1, 6, 32).astype(np.float32),
                  y=rs.randn(1, 4, 2, 4, 4).astype(np.float32),
                  density=np.asarray([0.1], np.float32))
    mask = (rs.rand(1, 2 * 2 * 2) > 0.5).astype(np.float32)
    ref = jdit.dit_forward(params, jc, jnp.asarray(x),
                           **{k: jnp.asarray(a) for k, a in inputs.items()},
                           binary_t_mask=jnp.asarray(mask))
    calls = TA.exact_calls["exact_attention"]
    got = tdit.dit_forward(
        from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                        device="cpu"),
        tc, torch.from_numpy(x),
        **{k: torch.from_numpy(a) for k, a in inputs.items()},
        binary_t_mask=torch.from_numpy(mask))
    assert TA.exact_calls["exact_attention"] == calls
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32)


@pytest.mark.parametrize("d,want", [(128, "d128"), (256, "d256"),
                                    (384, "wide"), (512, "wide"),
                                    (1024, "wide"), (2048, "wide")])
def test_head_dim_instance(d, want):
    """Every multiple of 128 runs an instance of the kernels on the card."""
    assert TF.head_dim_instance(d) == want


@pytest.mark.parametrize("d", [64, 96, 200, 0, -128])
def test_head_dim_instance_refuses(d):
    """Any other head dim raises (the dispatcher sends it to the exact
    branch before any kernel sees it)."""
    with pytest.raises(ValueError):
        TF.head_dim_instance(d)
