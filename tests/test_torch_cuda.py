"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need a CUDA device and skip without one. On a machine with an H100:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(`--noconftest`: the suite's conftest configures JAX, which this file does
not use.) Shapes here are the edge cases the smoke's flagship shapes do not
reach: ragged lengths, per-batch key masks, tokens past the RoPE table.
Each element is held to a few bf16 ulps of its own size, with the bounds
`chip_smoke.py` uses (`flexam_tpu_torch/testing.py` states them and why).
"""

import importlib

import pytest
import torch

from flexam_tpu_torch.core import attention as attn
from flexam_tpu_torch.ops import fused
from flexam_tpu_torch.ops import int8_attention as i8
from flexam_tpu_torch.ops import sparse_attention as sp
from flexam_tpu_torch.testing import (block_scaled, check_attention,
                                      check_int8_attention,
                                      check_ln_modulation,
                                      check_rmsnorm_rope,
                                      check_sparse_attention)

fa = importlib.import_module("flexam_tpu_torch.ops.flash_attention")

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
    # a contiguous view 2 bytes past a 16-byte boundary: refused before any
    # launch, by both wrappers
    flat = torch.zeros(8 * 2 * 128 + 1, device=dev, dtype=torch.bfloat16)
    odd = flat[1:].view(1, 8, 2, 128)
    assert odd.is_contiguous() and odd.data_ptr() % 16
    before = dict(fa.launches)
    for fn in (fa.flash_attention, fa.single_kv_attention):
        with pytest.raises(ValueError):
            fn(odd, q, q)
    assert fa.launches == before


@pytest.mark.parametrize("entry", ["flexam_flash_attention",
                                   "flexam_single_kv_attention"])
def test_attention_entry_refuses_bad_maps(dev, entry):
    """The C entry points themselves (below the wrappers' checks) return an
    error and launch nothing when a tensor map cannot be built: a pointer
    off a 16-byte boundary, or a head dim other than 128; B2 also refuses
    more than 512 keys."""
    from flexam_tpu_torch.ops import build
    fn = getattr(build.library(), entry)
    q = _rand(dev, 1, 64, 2, 128)
    out = torch.empty_like(q)
    stream = build.stream_handle(q)

    def call(qp, d=128, lk=64):
        return fn(qp, q.data_ptr(), q.data_ptr(), out.data_ptr(), None,
                  1, 2, 64, lk, d, 0.1, stream)

    assert call(q.data_ptr() + 2) != 0
    assert call(q.data_ptr(), d=64) != 0
    if entry == "flexam_single_kv_attention":
        assert call(q.data_ptr(), lk=513) != 0
    torch.cuda.synchronize()
    assert call(q.data_ptr()) == 0        # the same call, well formed
    torch.cuda.synchronize()


def _structured(dev, b, lq, lk, h, seed):
    """q/k/v whose rows and columns all differ in known ways: q and k carry
    a row-dependent offset along one dim (so each query row prefers other
    keys, and a row or key swap moves the output), v a ramp over its
    columns plus one over keys (so a transposed or mis-swizzled V, or a
    column swap, is off by far more than the bound)."""
    q, k, v = (_rand(dev, b, n, h, 128, seed=seed + i).float()
               for i, n in enumerate((lq, lk, lk)))
    rows = torch.arange(lq, device=dev, dtype=torch.float32)
    keys = torch.arange(lk, device=dev, dtype=torch.float32)
    q[..., 0] += 6.0 * (rows / lq - 0.5)[None, :, None]
    k[..., 0] += 6.0 * (keys / lk - 0.5)[None, :, None]
    cols = torch.arange(128, device=dev, dtype=torch.float32)
    v = 0.25 * v + (cols / 32.0)[None, None, None, :] \
        - (2.0 * keys / lk)[None, :, None, None]
    return (t.to(torch.bfloat16) for t in (q, k, v))


@pytest.mark.parametrize("b,h,lq,lk,k_len", [
    (1, 3, 1, 129, None),              # one query row, keys 1 past a tile
    (2, 3, 77, 300, [300, 128]),       # k_len on a tile edge
    (2, 3, 200, 2000, [1, 1000]),      # k_len 1, and inside a tile
    (1, 3, 11647, 2049, None),         # rows 1 short of 91 tiles; 1 key past 16
    (2, 1, 129, 2049, [2049, 1919]),   # keys ending mid-stage
    (1, 3, 640, 513, [257]),           # 513 keys: B1 at the edge of B2
])
def test_flash_attention_tile_edges(dev, b, h, lq, lk, k_len):
    """B1 where 128-row query tiles, 128-key tiles and the 2-stage ring end
    raggedly, on inputs whose rows and columns all differ."""
    q, k, v = _structured(dev, b, lq, lk, h, seed=40)
    kl = None if k_len is None else torch.tensor(k_len, device=dev)
    before = fa.launches["flash_attention"]
    got = fa.flash_attention(q, k, v, k_len=kl)
    torch.cuda.synchronize()
    assert fa.launches["flash_attention"] == before + 1
    check_attention(got, fa.attention_plain(q, k, v, k_len=kl), "B1")


@pytest.mark.parametrize("b,h,lq,lk,k_len", [
    (1, 3, 77, 1, None),
    (2, 3, 200, 64, [64, 1]),
    (1, 3, 1, 96, None),
    (2, 3, 11647, 300, [300, 128]),
    (2, 1, 129, 512, None),
    (2, 3, 256, 512, [511, 257]),
])
def test_single_kv_tile_edges(dev, b, h, lq, lk, k_len):
    """B2 from 1 key to exactly 512 (4 key tiles), ragged query tiles and
    k_len on and inside tile edges, on inputs whose rows and columns all
    differ."""
    q, k, v = _structured(dev, b, lq, lk, h, seed=50)
    kl = None if k_len is None else torch.tensor(k_len, device=dev)
    before = fa.launches["single_kv_attention"]
    got = fa.single_kv_attention(q, k, v, k_len=kl)
    torch.cuda.synchronize()
    assert fa.launches["single_kv_attention"] == before + 1
    check_attention(got, fa.attention_plain(q, k, v, k_len=kl), "B2")


@pytest.mark.parametrize("lk,kernel", [(512, "single_kv_attention"),
                                       (513, "flash_attention")])
def test_attention_dispatch_at_512_keys(dev, lk, kernel):
    """The dispatch sends 512 keys to B2 and 513 to B1."""
    q, k, v = _structured(dev, 1, 300, lk, 2, seed=60)
    before = dict(fa.launches)
    got = attn.attention(q, k, v)
    torch.cuda.synchronize()
    after = dict(fa.launches)
    assert after[kernel] == before[kernel] + 1
    assert sum(after.values()) == sum(before.values()) + 1
    check_attention(got, fa.attention_plain(q, k, v), kernel)


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


def _rows(dev, b, s, d, seed):
    """x [b, s, d] bf16 whose rows have their own offset and scale, as DiT
    hidden states have."""
    return (_rand(dev, b, s, d, seed=seed).float()
            * torch.exp(0.5 * _rand(dev, b, s, 1, seed=seed + 1).float())
            + 4.0 * _rand(dev, b, s, 1, seed=seed + 2).float()
            ).to(torch.bfloat16)


def _ln_mod_once(x, sh, sc, mask, name):
    """B4 launched once (its counter says so), held to its plain version."""
    key = "ln_mod_binary" if mask is not None else "ln_mod_bcast"
    before = dict(fused.launches)
    got = fused.ln_modulation(x, sh, sc, mask=mask)
    torch.cuda.synchronize()
    assert fused.launches[key] == before[key] + 1
    assert sum(fused.launches.values()) == sum(before.values()) + 1
    check_ln_modulation(got, fused.ln_modulation_plain(x, sh, sc, mask=mask),
                        sh, mask, name)


@pytest.mark.parametrize("mode", ["binary", "bcast"])
@pytest.mark.parametrize("d", [1536, 3072, 5120])
@pytest.mark.parametrize("b,s", [(1, 1), (3, 13), (1, 300), (3, 300)])
def test_ln_modulation_widths(dev, mode, d, b, s):
    """B4 at every config width, with row counts that do not divide evenly
    among the persistent CTAs' warps, and the terms as the main path gives
    them: the scale a strided view of the [B, 2, 6, D] modulation tensor."""
    g = torch.Generator(device=dev).manual_seed(d + s)
    x = _rows(dev, b, s, d, seed=20)
    mod = torch.randn((b, 2, 6, d), generator=g, device=dev)
    if mode == "binary":
        sh, sc = mod[:, :, 0] + mod[:, :, 3], mod[:, :, 1]
        mask = (torch.rand((b, s), generator=g, device=dev) > 0.5).float()
    else:
        sh, sc, mask = mod[:, 0, 0] + mod[:, 0, 3], mod[:, 0, 1], None
    _ln_mod_once(x, sh, sc, mask, f"B4 {mode} D={d} B={b} S={s}")


@pytest.mark.parametrize("d", [1536, 3072, 5120])
def test_ln_modulation_mixed_mask(dev, d):
    """A mask that is not 0 or 1 (0.25, 0.7 among 0 and 1) takes the fp32
    mix of the two branches' terms, as the JAX kernel does."""
    g = torch.Generator(device=dev).manual_seed(d)
    b, s = 2, 300
    x = _rows(dev, b, s, d, seed=30)
    values = torch.tensor([0.0, 1.0, 0.25, 0.7], device=dev)
    mask = values[torch.randint(0, 4, (b, s), generator=g, device=dev)]
    assert all(bool((mask == v).any()) for v in values)
    mod = torch.randn((b, 2, 6, d), generator=g, device=dev)
    _ln_mod_once(x, mod[:, :, 0], mod[:, :, 1], mask, f"B4 mixed D={d}")


@pytest.mark.parametrize("d", [1536, 3072, 5120])
@pytest.mark.parametrize("b,s,l_rot", [(1, 300, 263), (3, 300, 300),
                                       (1, 13, 64), (3, 1, 1)])
def test_rmsnorm_rope_widths(dev, d, b, s, l_rot):
    """B3 at every config width (heads of 128), with the RoPE table shorter
    than, as long as and longer than the sequence."""
    heads = d // 128
    x = _rand(dev, b, s, d, seed=40)
    gamma = 1.0 + 0.1 * _rand(dev, d, seed=41)
    g = torch.Generator(device=dev).manual_seed(l_rot)
    ang = torch.rand((l_rot, 64), generator=g, device=dev) * 6.0
    cos, sin = torch.cos(ang), torch.sin(ang)
    before = fused.launches["rmsnorm_rope"]
    got = fused.rmsnorm_rope(x, gamma, cos, sin, heads)
    torch.cuda.synchronize()
    assert fused.launches["rmsnorm_rope"] == before + 1
    check_rmsnorm_rope(got, fused.rmsnorm_rope_plain(x, gamma, cos, sin,
                                                     heads),
                       f"B3 D={d} B={b} S={s} L_rot={l_rot}")


def test_row_kernels_refuse_what_they_do_not_take(dev):
    """Widths past the register-held row, widths not a multiple of 8, head
    dims not a multiple of 8 and views off a 16-byte boundary raise in the
    wrappers, with no launch."""
    before = dict(fused.launches)
    base = torch.zeros(4 * 384 + 1, dtype=torch.bfloat16, device=dev)
    off = base[1:].view(1, 4, 384)           # contiguous, 2 bytes off
    ang = torch.zeros((4, 64), device=dev)
    ones = torch.ones(384, dtype=torch.bfloat16, device=dev)

    def ln(x, d):
        t = torch.zeros((1, 2, d), device=dev)
        return fused.ln_modulation(x, t, t, mask=torch.ones((1, 4),
                                                            device=dev))
    with pytest.raises(ValueError):
        ln(off, 384)
    with pytest.raises(ValueError):
        ln(_rand(dev, 1, 4, 100), 100)
    with pytest.raises(ValueError):
        ln(_rand(dev, 1, 4, 8200), 8200)
    with pytest.raises(ValueError):
        fused.rmsnorm_rope(off, ones, ang.cos(), ang.sin(), 3)
    with pytest.raises(ValueError):                         # head_dim 12
        fused.rmsnorm_rope(_rand(dev, 1, 4, 384), ones, ang[:, :6],
                           ang[:, :6], 32)
    tab = torch.zeros(4 * 64 + 1, device=dev)[1:].view(4, 64)
    with pytest.raises(ValueError):                         # table 4 B off
        fused.rmsnorm_rope(_rand(dev, 1, 4, 384), ones, tab, tab, 3)
    assert fused.launches == before


def test_row_entries_refuse_bad_arguments(dev):
    """The C entry points of B3 and B4 return an error, with no launch, for
    a pointer off a 16-byte boundary or a width they do not take."""
    from flexam_tpu_torch.ops import build
    lib = build.library()
    x = _rand(dev, 1, 4, 384)
    out = torch.empty_like(x)
    t = torch.zeros((1, 2, 384), device=dev)
    m = torch.ones((1, 4), device=dev)
    tab = torch.zeros((4, 64), device=dev)
    stream = build.stream_handle(x)

    def ln(xp=x.data_ptr(), d=384):
        return lib.flexam_ln_modulation(xp, t.data_ptr(), t.data_ptr(),
                                        m.data_ptr(), out.data_ptr(), 1, 4, d,
                                        768, 384, 768, 384, 1e-6, stream)

    def rms(xp=x.data_ptr(), d=384, dh=128):
        return lib.flexam_rmsnorm_rope(xp, x.data_ptr(), tab.data_ptr(),
                                       tab.data_ptr(), out.data_ptr(), 1, 4, d,
                                       dh, 4, 1e-6, stream)
    assert ln(xp=x.data_ptr() + 2) != 0
    assert ln(d=100) != 0
    assert ln(d=8200) != 0
    assert rms(xp=x.data_ptr() + 2) != 0
    assert rms(d=384, dh=12) != 0
    assert rms(d=8320, dh=128) != 0
    torch.cuda.synchronize()
    assert ln() == 0 and rms() == 0
    torch.cuda.synchronize()


@pytest.mark.parametrize("frames,window,spatial", [
    (6, 1, 40),      # blk 40: one ragged 64-row tile and key tile a block
    (5, 0, 72),      # blk 72: a full tile and a ragged one
    (9, 2, 100),     # blk 200 (group 2 over 10 blocks): 4 tiles, ragged
    (3, 1, 8),       # blk 8, the smallest the JAX dispatch takes
])
def test_sparse_attention_edges(dev, frames, window, spatial):
    """B5 with blocks of 8*k tokens that are not a multiple of 64, ragged
    nnz across rows, and the ref block's full row."""
    pol = sp.video_sparse_policy(frames, spatial, ref_tokens=spatial,
                                 window=window)
    rows, blk = pol["rows"], pol["blk"]
    nnz = [len(r) for r in rows]
    assert len(set(nnz)) > 1 and nnz[-1] == len(rows)
    L = pol["video_len"]
    q, k, v = (_rand(dev, 2, L, 3, 128, seed=20 + i) for i in range(3))
    before = sp.launches["sparse_attention"]
    got = sp.sparse_flash_attention(q, k, v, rows, blk)
    torch.cuda.synchronize()
    assert sp.launches["sparse_attention"] == before + 1
    check_sparse_attention(got, sp.masked_dense_attention(q, k, v, rows, blk),
                           "B5")


@pytest.mark.parametrize("b,lq,lk,k_len,scaled", [
    (2, 2000, 2000, None, False),         # quantization blocks of 1,024, padded
    (2, 2000, 2000, [2000, 777], False),  # k_len masks
    (1, 11648, 11648, None, False),       # blocks of 1,456 = 22.75 row tiles
    (1, 18816, 18816, None, False),       # blocks of 1,344
    (2, 130, 70, [70, 1], False),         # tiny and ragged
    (1, 11648, 11648, None, True),        # 6 of 7 block edges inside a tile
    (2, 1584, 1584, [1584, 1100], True),  # blocks of 528: both edges in a tile
    (1, 3000, 1584, None, True),          # query blocks 1,024, key blocks 528
])
def test_int8_attention_edges(dev, b, lq, lk, k_len, scaled):
    """B6 where its quantization blocks do not align with its 64-row
    tiles, with k_len masks and short ragged lengths. `scaled`: q rows and
    keys whose size alternates by 4x from one quantization block to the
    next, so a 64-row or 64-key tile that straddles two blocks and took one
    scale for all its rows or keys would put some logits 4x off."""
    q, k, v = (_rand(dev, b, lq, 2, 128, seed=30), _rand(dev, b, lk, 2, 128,
                                                          seed=31),
               _rand(dev, b, lk, 2, 128, seed=32))
    if scaled:
        q = block_scaled(q, i8.quant_block(lq))
        k = block_scaled(k, i8.quant_block(lk), phase=1)
    kl = None if k_len is None else torch.tensor(k_len, device=dev)
    before = i8.launches["int8_attention"]
    got = i8.int8_attention(q, k, v, k_len=kl)
    torch.cuda.synchronize()
    assert i8.launches["int8_attention"] == before + 1
    check_int8_attention(got, i8.int8_attention_plain(q, k, v, k_len=kl),
                         "B6")


def test_int8_cross_attention_explicit(dev, monkeypatch):
    """An explicit int8 choice takes cross-attention over 512 text tokens
    through B6 (not B2)."""
    monkeypatch.setenv("FLEXAM_ATTENTION", "pallas_int8")
    attn._default_backend.cache_clear()
    try:
        q = _rand(dev, 2, 3000, 2, 128, seed=33)
        k, v = _rand(dev, 2, 512, 2, 128, seed=34), _rand(dev, 2, 512, 2, 128,
                                                           seed=35)
        before = (i8.launches["int8_attention"],
                  fa.launches["single_kv_attention"])
        got = attn.attention(q, k, v)
        torch.cuda.synchronize()
        assert (i8.launches["int8_attention"],
                fa.launches["single_kv_attention"]) == (before[0] + 1,
                                                        before[1])
    finally:
        monkeypatch.delenv("FLEXAM_ATTENTION")
        attn._default_backend.cache_clear()
    check_int8_attention(got, i8.int8_attention_plain(q, k, v), "B6 cross")


def test_long_kernels_reject_unsupported(dev):
    q = _rand(dev, 1, 64, 2, 128)
    rows, blk = [[0, 1], [0, 1]], 32
    with pytest.raises(TypeError):
        i8.int8_attention(q.float(), q.float(), q.float())
    with pytest.raises(ValueError):
        i8.int8_attention(q[..., :64].contiguous(), q[..., :64].contiguous(),
                          q[..., :64].contiguous())          # head_dim 64
    with pytest.raises(TypeError):
        sp.sparse_flash_attention(q.float(), q.float(), q.float(), rows, blk)
    with pytest.raises(ValueError):
        sp.sparse_flash_attention(q, q, q, rows, 40)          # L != 2 * 40
    with pytest.raises(ValueError):
        sp.sparse_flash_attention(q, q, q, rows, blk,
                                  kidx=torch.zeros((2, 2), device=dev),
                                  nnz=torch.full((2,), 2, device=dev))
    with pytest.raises(NotImplementedError):
        attn.attention(q, q, q, backend="xla")


@pytest.mark.parametrize("frames,window,spatial,b,h", [
    (5, 2, 448, 2, 2),    # blk 896 = 7 key tiles: the long path's blocks
    (9, 2, 100, 1, 3),    # blk 200: each block's second tile ends mid-tile
    (7, 1, 64, 2, 2),     # blk 64: a row tile spans two query blocks
])
def test_sparse_attention_structured(dev, frames, window, spatial, b, h):
    """B5 on inputs whose rows and columns all differ (a transposed or
    mis-swizzled operand, a key of the next block counted, or a row of the
    next block stored, is off by far more than the bound), at the long
    path's block size and at blocks whose edges fall inside a tile."""
    pol = sp.video_sparse_policy(frames, spatial, ref_tokens=spatial,
                                 window=window)
    rows, blk = pol["rows"], pol["blk"]
    assert pol["video_len"] == len(rows) * blk
    q, k, v = _structured(dev, b, pol["video_len"], pol["video_len"], h,
                          seed=70)
    before = sp.launches["sparse_attention"]
    got = sp.sparse_flash_attention(q, k, v, rows, blk)
    torch.cuda.synchronize()
    assert sp.launches["sparse_attention"] == before + 1
    check_sparse_attention(got, sp.masked_dense_attention(q, k, v, rows, blk),
                           "B5")


@pytest.mark.parametrize("b,lq,lk,k_len", [
    (2, 300, 400, [127, 128]),     # k_len one short of and on a tile edge
    (2, 129, 257, [129, 1]),       # one key past a tile; a single key
    (1, 700, 512, None),           # 512 keys: the text length
    (2, 1000, 512, [512, 300]),
    (1, 2000, 2000, None),         # quantization blocks of 1,024 rows
])
def test_int8_attention_structured(dev, b, lq, lk, k_len):
    """B6 on inputs whose rows and columns all differ, with k_len around a
    128-key tile's edge, and at the 512 text keys the explicit int8 choice
    sends to it."""
    q, k, v = _structured(dev, b, lq, lk, 2, seed=80)
    kl = None if k_len is None else torch.tensor(k_len, device=dev)
    before = i8.launches["int8_attention"]
    got = i8.int8_attention(q, k, v, k_len=kl)
    torch.cuda.synchronize()
    assert i8.launches["int8_attention"] == before + 1
    check_int8_attention(got, i8.int8_attention_plain(q, k, v, k_len=kl),
                         "B6")


def test_sparse_entry_refuses_bad_maps(dev):
    """B5's C entry point returns an error and launches nothing for a
    pointer off a 16-byte boundary or a head dim other than 128."""
    from flexam_tpu_torch.ops import build
    fn = build.library().flexam_sparse_attention
    rows, blk = [[0, 1], [1]], 64
    q = _rand(dev, 1, 2 * blk, 2, 128)
    out = torch.empty_like(q)
    kidx, nnz = (torch.from_numpy(a).to(dev) for a in sp.rows_to_arrays(rows))
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    stream = build.stream_handle(q)

    def call(qp=q.data_ptr(), op=out.data_ptr(), d=128):
        return fn(qp, q.data_ptr(), q.data_ptr(), op, kidx.data_ptr(),
                  nnz.data_ptr(), counter.data_ptr(), 1, 2, 2, blk, 2, d, 0.1,
                  stream)

    before = sp.launches["sparse_attention"]
    assert call(qp=q.data_ptr() + 2) != 0
    assert call(op=out.data_ptr() + 2) != 0
    assert call(d=64) != 0
    torch.cuda.synchronize()
    assert call() == 0                    # the same call, well formed
    torch.cuda.synchronize()
    assert sp.launches["sparse_attention"] == before   # C calls, not the wrapper


def test_sparse_entry_zeroes_its_counter(dev):
    """B5's C entry point gives the right output whatever its counter word
    holds at the call: garbage first, then what the first launch left."""
    from flexam_tpu_torch.ops import build
    fn = build.library().flexam_sparse_attention
    pol = sp.video_sparse_policy(5, 200, ref_tokens=200, window=1)
    rows, blk, L = pol["rows"], pol["blk"], pol["video_len"]
    q, k, v = (_rand(dev, 1, L, 2, 128, seed=90 + i) for i in range(3))
    kidx, nnz = (torch.from_numpy(a).to(dev) for a in sp.rows_to_arrays(rows))
    counter = torch.full((1,), 123456, dtype=torch.int32, device=dev)
    ref = sp.masked_dense_attention(q, k, v, rows, blk)
    before = sp.launches["sparse_attention"]
    for _ in range(2):
        out = torch.full_like(q, float("nan"))
        assert fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  kidx.data_ptr(), nnz.data_ptr(), counter.data_ptr(), 1, 2,
                  len(rows), blk, kidx.shape[1], 128,
                  128 ** -0.5 * fa.LOG2E, build.stream_handle(q)) == 0
        torch.cuda.synchronize()
        check_sparse_attention(out, ref, "B5 from its C entry point")
    assert sp.launches["sparse_attention"] == before   # C calls, not the wrapper


def test_int8_entry_refuses_bad_maps(dev):
    """B6's C entry point returns an error and launches nothing for an int8
    or bf16 pointer off a 16-byte boundary or a head dim other than 128."""
    from flexam_tpu_torch.ops import build
    fn = build.library().flexam_int8_attention
    q = _rand(dev, 1, 64, 2, 128)
    q8, qs, k8, ks = i8.quantize_qk(q, q)
    out = torch.empty_like(q)
    stream = build.stream_handle(q)

    def call(q8p=q8.data_ptr(), vp=q.data_ptr(), d=128):
        return fn(q8p, k8.data_ptr(), vp, out.data_ptr(), qs.data_ptr(),
                  ks.data_ptr(), None, 1, 2, 64, 64, d, 0.1, stream)

    before = i8.launches["int8_attention"]
    assert call(q8p=q8.data_ptr() + 1) != 0
    assert call(vp=q.data_ptr() + 2) != 0
    assert call(d=64) != 0
    torch.cuda.synchronize()
    assert call() == 0
    torch.cuda.synchronize()
    assert i8.launches["int8_attention"] == before


def test_sparse_refuses_an_empty_block_list(dev):
    """B5's wrapper refuses a query block with no key block (its kernel
    needs at least one key tile an item) before any launch."""
    q = _rand(dev, 1, 64, 2, 128)
    before = sp.launches["sparse_attention"]
    with pytest.raises(ValueError):
        sp.sparse_flash_attention(q, q, q, [[0, 1], []], 32)
    assert sp.launches["sparse_attention"] == before


@pytest.mark.parametrize("d", [24, 64, 96])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k_len", [None, [300, 77]])
def test_exact_branch_on_the_card(dev, d, dtype, k_len):
    """Head dims the kernels do not take go to the dispatcher's exact
    branch on CUDA (plain torch ops, no launch), held to `attention_plain`
    within the attention bound; each call is counted."""
    from flexam_tpu_torch.ops import launch_counts
    q, k, v = (_rand(dev, 2, n, 3, d, seed=s).to(dtype)
               for n, s in ((200, 11), (300, 12), (300, 13)))
    kl = None if k_len is None else torch.tensor(k_len, device=dev)
    for backend in ("pallas", "pallas_int8"):
        calls = attn.exact_calls["exact_attention"]
        kernels = launch_counts()
        got = attn.attention(q, k, v, k_len=kl, backend=backend)
        torch.cuda.synchronize()
        assert attn.exact_calls["exact_attention"] == calls + 1
        assert launch_counts() == kernels
        assert got.dtype == dtype and got.is_cuda
        check_attention(got, fa.attention_plain(q, k, v, k_len=kl),
                        f"exact d={d}")


def test_head_dim_128_launches_kernels_not_the_branch(dev):
    q = _rand(dev, 2, 700, 2, 128, seed=14)
    ctx = _rand(dev, 2, 64, 2, 128, seed=15)
    calls = attn.exact_calls["exact_attention"]
    b1, b2 = (fa.launches[k] for k in ("flash_attention",
                                       "single_kv_attention"))
    attn.attention(q, q, q, backend="pallas")             # B1: 700 keys
    attn.attention(q, ctx, ctx, backend="pallas")         # B2: 64 keys
    torch.cuda.synchronize()
    assert fa.launches["flash_attention"] == b1 + 1
    assert fa.launches["single_kv_attention"] == b2 + 1
    assert attn.exact_calls["exact_attention"] == calls
