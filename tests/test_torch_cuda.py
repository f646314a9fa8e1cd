"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need a CUDA device and skip without one. On a machine with an H100:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(`--noconftest`: the suite's conftest configures JAX, which this file does
not use.) Shapes here are the edge cases the smoke's flagship shapes do not
reach: ragged lengths, per-batch key masks, tokens past the RoPE table.
Each element is held to a few ulps of its own size (bf16; tf32 for B1/B2
in fp32, fp32 for B3/B4 in fp32), with the bounds `chip_smoke.py` uses
(`flexam_tpu_torch/testing.py` states them and why). B1-B6 run in both
dtypes they take (`DTYPES`, and the `f32` cases of B5 and B6).
"""

import importlib

import pytest
import torch

from flexam_tpu_torch.core import attention as attn
from flexam_tpu_torch.ops import fused
from flexam_tpu_torch.ops import int8_attention as i8
from flexam_tpu_torch.ops import sparse_attention as sp
from flexam_tpu_torch.testing import (attention_split_plain, block_scaled,
                                      check_attention,
                                      check_attention_tf32,
                                      check_int8_attention,
                                      check_int8_attention_tf32,
                                      check_ln_modulation,
                                      check_ln_modulation_f32,
                                      check_rmsnorm_rope,
                                      check_rmsnorm_rope_f32,
                                      check_sparse_attention,
                                      check_sparse_attention_tf32)

fa = importlib.import_module("flexam_tpu_torch.ops.flash_attention")

pytestmark = pytest.mark.cuda

# the dtypes B1-B4 take on the card
DTYPES = pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                                 ids=["bf16", "f32"])


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rand(dev, *shape, seed=0, dtype=torch.bfloat16):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev, dtype=dtype)


def _check_attn(got, ref, name):
    """B1/B2's bound for the output's dtype (bf16, or TF32 for fp32)."""
    if got.dtype == torch.float32:
        return check_attention_tf32(got, ref, name + " f32")
    return check_attention(got, ref, name)


def _check_rms(got, ref, name):
    if got.dtype == torch.float32:
        return check_rmsnorm_rope_f32(got, ref, name + " f32")
    return check_rmsnorm_rope(got, ref, name)


def _check_ln(got, ref, x, sh, sc, mask, name):
    if got.dtype == torch.float32:
        return check_ln_modulation_f32(got, ref, x, sh, sc, mask,
                                       name + " f32")
    return check_ln_modulation(got, ref, sh, mask, name)


@DTYPES
@pytest.mark.parametrize("lq,lk,k_len", [(200, 300, None), (200, 300, [300, 129]),
                                         (1, 2000, [1, 1999]), (77, 64, None)])
def test_flash_attention_edges(dev, lq, lk, k_len, dtype):
    q, k, v = (_rand(dev, 2, lq, 3, 128, seed=1, dtype=dtype),
               _rand(dev, 2, lk, 3, 128, seed=2, dtype=dtype),
               _rand(dev, 2, lk, 3, 128, seed=3, dtype=dtype))
    kl = None if k_len is None else torch.tensor(k_len, device=dev)
    before = fa.launches["flash_attention"]
    got = fa.flash_attention(q, k, v, k_len=kl)
    torch.cuda.synchronize()
    assert fa.launches["flash_attention"] == before + 1
    assert got.dtype == dtype
    _check_attn(got, fa.attention_plain(q, k, v, k_len=kl), "B1")


@DTYPES
@pytest.mark.parametrize("lk,k_len", [(96, None), (96, [96, 40]), (512, None),
                                      (1, None), (300, [5, 300])])
def test_single_kv_attention_edges(dev, lk, k_len, dtype):
    q, k, v = (_rand(dev, 2, 150, 2, 128, seed=4, dtype=dtype),
               _rand(dev, 2, lk, 2, 128, seed=5, dtype=dtype),
               _rand(dev, 2, lk, 2, 128, seed=6, dtype=dtype))
    kl = None if k_len is None else torch.tensor(k_len, device=dev)
    got = fa.single_kv_attention(q, k, v, k_len=kl)
    torch.cuda.synchronize()
    _check_attn(got, fa.attention_plain(q, k, v, k_len=kl), "B2")


def test_attention_rejects_unsupported(dev):
    """Head dims that are not a multiple of 128, fp16 (no path of the JAX
    package makes fp16 activations; bf16 and fp32 launch), mixed dtypes,
    non-contiguous and misaligned views raise before any launch."""
    q = _rand(dev, 1, 8, 2, 64)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)                       # head_dim 64
    q = _rand(dev, 1, 8, 2, 128)
    before = dict(fa.launches)
    for fn in (fa.flash_attention, fa.single_kv_attention):
        with pytest.raises(TypeError):
            fn(q.half(), q.half(), q.half())
        with pytest.raises(TypeError):
            fn(q.float(), q, q)
    assert fa.launches == before
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
    off a 16-byte boundary, or a head dim that is not a multiple of 128; B2
    also refuses more than 512 keys, B1 a tail split without a workspace
    or of more tail items than work items."""
    from flexam_tpu_torch.ops import build
    fn = getattr(build.library(), entry)
    q = _rand(dev, 1, 64, 2, 128)
    out = torch.empty_like(q)
    stream = build.stream_handle(q)

    def call(qp, d=128, lk=64, split=None):
        # B1 takes the tail split's workspace, tail items and parts
        head = (None, 0, 1) if split is None else split
        return fn(qp, q.data_ptr(), q.data_ptr(), out.data_ptr(), None,
                  *(head if entry == "flexam_flash_attention" else ()),
                  1, 2, 64, lk, d, 0.1, stream)

    assert call(q.data_ptr() + 2) != 0
    assert call(q.data_ptr(), d=64) != 0
    if entry == "flexam_single_kv_attention":
        assert call(q.data_ptr(), lk=513) != 0
    else:
        # a split without a workspace, or of more items than the launch has
        ws = fa.split_workspace(q)
        assert call(q.data_ptr(), split=(None, 1, 2)) != 0
        assert call(q.data_ptr(), split=(ws.data_ptr(), 3, 2)) != 0
    torch.cuda.synchronize()
    assert call(q.data_ptr()) == 0        # the same call, well formed
    torch.cuda.synchronize()


def _structured(dev, b, lq, lk, h, seed, d=128, dtype=torch.bfloat16):
    """q/k/v whose rows and columns all differ in known ways: q and k carry
    a row-dependent offset along one dim (so each query row prefers other
    keys, and a row or key swap moves the output), v a ramp over its
    columns plus one over keys (so a transposed or mis-swizzled V, or a
    column swap, is off by far more than the bound)."""
    q, k, v = (_rand(dev, b, n, h, d, seed=seed + i).float()
               for i, n in enumerate((lq, lk, lk)))
    rows = torch.arange(lq, device=dev, dtype=torch.float32)
    keys = torch.arange(lk, device=dev, dtype=torch.float32)
    q[..., 0] += 6.0 * (rows / lq - 0.5)[None, :, None]
    k[..., 0] += 6.0 * (keys / lk - 0.5)[None, :, None]
    cols = torch.arange(d, device=dev, dtype=torch.float32)
    v = 0.25 * v + (cols / 32.0 * 128 / d)[None, None, None, :] \
        - (2.0 * keys / lk)[None, :, None, None]
    return (t.to(dtype) for t in (q, k, v))


def _b1_split_check(got, q, k, v, kl, name):
    """B1 (bf16, head dim 128) against `attention_plain` and against the
    plain model of the tail split it ran (`testing.attention_split_plain`),
    each within `check_attention`'s bound; returns the split (t, s)."""
    t, s = fa.b1_split(q, k)
    _check_attn(got, fa.attention_plain(q, k, v, k_len=kl), name)
    check_attention(got, attention_split_plain(
        q, k, v, k_len=kl, tail=t, parts=s,
        tile_keys=fa.b1_plan()["tile_keys"]),
        f"{name} (split model, t {t}, s {s})")
    return t, s


@pytest.mark.parametrize("lk", [1, 95, 96, 97, 127, 128, 129, 2072, 2304])
def test_b1_d128_key_counts(dev, lk):
    """B1-128 on key counts at its 128-key tiles' edges (and 96's), and
    FLUX's 2,072 and 2,304: 2 x 3 x 2 items, each split by keys where it
    has more than one key tile."""
    q, k, v = _structured(dev, 2, 200, lk, 3, seed=50)
    got = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    split = _b1_split_check(got, q, k, v, None, f"B1 d128 lk {lk}")
    tile = fa.b1_plan()["tile_keys"]
    assert split == fa.tail_split(12, -(-lk // tile),
                                  fa.multiprocessors(q.device))
    assert (split[1] > 1) == (lk > tile)


@pytest.mark.parametrize("k_len", [[127, 128], [129, 1], [0, 300], [0, 0],
                                   [255, 256], [257, 250]])
def test_b1_d128_k_len_edges(dev, k_len):
    """k_len before, on and after a tile edge, and 0 (every key masked
    alike: the mean of v over all 300 keys, in every part)."""
    q, k, v = _structured(dev, 2, 150, 300, 2, seed=51)
    kl = torch.tensor(k_len, device=dev)
    got = fa.flash_attention(q, k, v, k_len=kl)
    torch.cuda.synchronize()
    _b1_split_check(got, q, k, v, kl, f"B1 d128 k_len {k_len}")


@pytest.mark.parametrize("lq", [1, 63, 65, 130])
def test_b1_d128_ragged_queries(dev, lq):
    q, k, v = _structured(dev, 2, lq, 700, 3, seed=52)
    kl = torch.tensor([700, 333], device=dev)
    got = fa.flash_attention(q, k, v, k_len=kl)
    torch.cuda.synchronize()
    _b1_split_check(got, q, k, v, kl, f"B1 d128 lq {lq}")


@pytest.mark.parametrize("rounds,tail,split", [
    (1, 1, True),              # a tail of 1 after a whole round
    (1, "half-1", True),       # just under half a round
    (1, "half", True),         # half a round
    (1, "half+1", False),      # just over: no split
    (2, 0, False),             # whole rounds
    (0, "third", True),        # fewer items than SMs
    (3, 1, True),              # three whole items a CTA, then the tail
])
def test_b1_d128_tail_rounds(dev, rounds, tail, split):
    """Item counts on the card's SMs (one query tile of one head an item):
    the split the wrapper takes, and the output, whatever the last round
    holds."""
    sms = fa.multiprocessors(torch.device(dev))
    t = {"half-1": sms // 2 - 1, "half": sms // 2, "half+1": sms // 2 + 1,
         "third": sms // 3}.get(tail, tail)
    items = rounds * sms + t
    q, k, v = _structured(dev, 1, items * 128 - 37, 500, 1, seed=53)
    got = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    ts = _b1_split_check(got, q, k, v, None, f"B1 d128 {items} items")
    assert (ts[1] > 1) == split, ts
    if split:
        assert ts[0] == t


def test_b1_d128_workspace_reused(dev):
    """A second launch on the stream's cached workspace gives the same bits
    (the merge sums the parts in part order, whichever CTA merges), and
    every counter is back at zero after each launch."""
    q, k, v = _structured(dev, 1, 2304, 2304, 24, seed=54)
    assert fa.b1_split(q, k)[1] > 1
    first = fa.flash_attention(q, k, v)
    ws = fa.split_workspace(q)
    sms = fa.multiprocessors(q.device)
    counters = ws[-2 * 4 * sms:].view(torch.int32)   # after the slots
    torch.cuda.synchronize()
    assert counters.numel() == 2 * sms and not counters.any()
    for _ in range(3):
        again = fa.flash_attention(q, k, v)
        torch.cuda.synchronize()
        assert torch.equal(again, first)
        assert not counters.any()
    _b1_split_check(first, q, k, v, None, "B1 d128 FLUX")


@pytest.mark.parametrize("b,h,lq,lk,k_len", [
    (1, 3, 1, 129, None),              # one query row, keys 1 past a tile
    (2, 3, 77, 300, [300, 128]),       # k_len on a tile edge
    (2, 3, 200, 2000, [1, 1000]),      # k_len 1, and inside a tile
    (1, 3, 11647, 2049, None),         # rows 1 short of 91 tiles; 1 key past 16
    (2, 1, 129, 2049, [2049, 1919]),   # keys ending mid-stage
    (1, 3, 640, 513, [257]),           # 513 keys: B1 at the edge of B2
])
@DTYPES
def test_flash_attention_tile_edges(dev, b, h, lq, lk, k_len, dtype):
    """B1 where 128-row query tiles, 128-key (fp32: 64-key) tiles and the
    ring end raggedly, on inputs whose rows and columns all differ (in
    fp32 a V^T key out of the pre-pass's order is off by far more than the
    bound)."""
    q, k, v = _structured(dev, b, lq, lk, h, seed=40, dtype=dtype)
    kl = None if k_len is None else torch.tensor(k_len, device=dev)
    before = fa.launches["flash_attention"]
    got = fa.flash_attention(q, k, v, k_len=kl)
    torch.cuda.synchronize()
    assert fa.launches["flash_attention"] == before + 1
    _check_attn(got, fa.attention_plain(q, k, v, k_len=kl), "B1")


@pytest.mark.parametrize("b,h,lq,lk,k_len", [
    (1, 3, 77, 1, None),
    (2, 3, 200, 64, [64, 1]),
    (1, 3, 1, 96, None),
    (2, 3, 11647, 300, [300, 128]),
    (2, 1, 129, 512, None),
    (2, 3, 256, 512, [511, 257]),
])
@DTYPES
def test_single_kv_tile_edges(dev, b, h, lq, lk, k_len, dtype):
    """B2 from 1 key to exactly 512 (4 key tiles; 8 in fp32), ragged query
    tiles and k_len on and inside tile edges, on inputs whose rows and
    columns all differ."""
    q, k, v = _structured(dev, b, lq, lk, h, seed=50, dtype=dtype)
    kl = None if k_len is None else torch.tensor(k_len, device=dev)
    before = fa.launches["single_kv_attention"]
    got = fa.single_kv_attention(q, k, v, k_len=kl)
    torch.cuda.synchronize()
    assert fa.launches["single_kv_attention"] == before + 1
    _check_attn(got, fa.attention_plain(q, k, v, k_len=kl), "B2")


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


@DTYPES
@pytest.mark.parametrize("s,l_rot", [(48, 40), (1, 1), (300, 300), (33, 64)])
def test_rmsnorm_rope_edges(dev, s, l_rot, dtype):
    x = _rand(dev, 2, s, 3 * 128, seed=7, dtype=dtype)
    gamma = 1.0 + 0.1 * _rand(dev, 3 * 128, seed=8, dtype=dtype)
    ang = torch.rand((l_rot, 64), device=dev) * 6.0
    got = fused.rmsnorm_rope(x, gamma, torch.cos(ang), torch.sin(ang), 3)
    ref = fused.rmsnorm_rope_plain(x, gamma, torch.cos(ang), torch.sin(ang), 3)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    _check_rms(got, ref, "B3")


@DTYPES
@pytest.mark.parametrize("mode", ["binary", "bcast"])
@pytest.mark.parametrize("s,d", [(13, 256), (300, 3072), (1, 128)])
def test_ln_modulation_edges(dev, mode, s, d, dtype):
    # rows with their own offset and scale, as DiT hidden states have
    x = (_rand(dev, 2, s, d, seed=9).float()
         * torch.exp(0.5 * _rand(dev, 2, s, 1, seed=10).float())
         + 4.0 * _rand(dev, 2, s, 1, seed=11).float()).to(dtype)
    terms = (2, 2, d) if mode == "binary" else (2, d)
    sh = torch.randn(terms, device=dev)
    sc = torch.randn(terms, device=dev)
    mask = (torch.rand((2, s), device=dev) > 0.5).float() \
        if mode == "binary" else None
    got = fused.ln_modulation(x, sh, sc, mask=mask)
    ref = fused.ln_modulation_plain(x, sh, sc, mask=mask)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    _check_ln(got, ref, x, sh, sc, mask, "B4")


def _rows(dev, b, s, d, seed, dtype=torch.bfloat16):
    """x [b, s, d] whose rows have their own offset and scale, as DiT
    hidden states have."""
    return (_rand(dev, b, s, d, seed=seed).float()
            * torch.exp(0.5 * _rand(dev, b, s, 1, seed=seed + 1).float())
            + 4.0 * _rand(dev, b, s, 1, seed=seed + 2).float()
            ).to(dtype)


def _ln_mod_once(x, sh, sc, mask, name):
    """B4 launched once (its counter says so), held to its plain version."""
    key = "ln_mod_binary" if mask is not None else "ln_mod_bcast"
    before = dict(fused.launches)
    got = fused.ln_modulation(x, sh, sc, mask=mask)
    torch.cuda.synchronize()
    assert fused.launches[key] == before[key] + 1
    assert sum(fused.launches.values()) == sum(before.values()) + 1
    _check_ln(got, fused.ln_modulation_plain(x, sh, sc, mask=mask), x, sh,
              sc, mask, name)


@DTYPES
@pytest.mark.parametrize("mode", ["binary", "bcast"])
@pytest.mark.parametrize("d", [1536, 3072, 5120])
@pytest.mark.parametrize("b,s", [(1, 1), (3, 13), (1, 300), (3, 300)])
def test_ln_modulation_widths(dev, mode, d, b, s, dtype):
    """B4 at every config width, with row counts that do not divide evenly
    among the persistent CTAs' warps, and the terms as the main path gives
    them: the scale a strided view of the [B, 2, 6, D] modulation tensor."""
    g = torch.Generator(device=dev).manual_seed(d + s)
    x = _rows(dev, b, s, d, seed=20, dtype=dtype)
    mod = torch.randn((b, 2, 6, d), generator=g, device=dev)
    if mode == "binary":
        sh, sc = mod[:, :, 0] + mod[:, :, 3], mod[:, :, 1]
        mask = (torch.rand((b, s), generator=g, device=dev) > 0.5).float()
    else:
        sh, sc, mask = mod[:, 0, 0] + mod[:, 0, 3], mod[:, 0, 1], None
    _ln_mod_once(x, sh, sc, mask, f"B4 {mode} D={d} B={b} S={s}")


@DTYPES
@pytest.mark.parametrize("d", [1536, 3072, 5120])
def test_ln_modulation_mixed_mask(dev, d, dtype):
    """A mask that is not 0 or 1 (0.25, 0.7 among 0 and 1) takes the fp32
    mix of the two branches' terms, as the JAX kernel does."""
    g = torch.Generator(device=dev).manual_seed(d)
    b, s = 2, 300
    x = _rows(dev, b, s, d, seed=30, dtype=dtype)
    values = torch.tensor([0.0, 1.0, 0.25, 0.7], device=dev)
    mask = values[torch.randint(0, 4, (b, s), generator=g, device=dev)]
    assert all(bool((mask == v).any()) for v in values)
    mod = torch.randn((b, 2, 6, d), generator=g, device=dev)
    _ln_mod_once(x, mod[:, :, 0], mod[:, :, 1], mask, f"B4 mixed D={d}")


@DTYPES
@pytest.mark.parametrize("d", [1536, 3072, 5120, 8192])
@pytest.mark.parametrize("b,s,l_rot", [(1, 300, 263), (3, 300, 300),
                                       (1, 13, 64), (3, 1, 1)])
def test_rmsnorm_rope_widths(dev, d, b, s, l_rot, dtype):
    """B3 at every config width (heads of 128) and the widest row it takes,
    with the RoPE table shorter than, as long as and longer than the
    sequence."""
    heads = d // 128
    x = _rand(dev, b, s, d, seed=40, dtype=dtype)
    gamma = 1.0 + 0.1 * _rand(dev, d, seed=41, dtype=dtype)
    g = torch.Generator(device=dev).manual_seed(l_rot)
    ang = torch.rand((l_rot, 64), generator=g, device=dev) * 6.0
    cos, sin = torch.cos(ang), torch.sin(ang)
    before = fused.launches["rmsnorm_rope"]
    got = fused.rmsnorm_rope(x, gamma, cos, sin, heads)
    torch.cuda.synchronize()
    assert fused.launches["rmsnorm_rope"] == before + 1
    _check_rms(got, fused.rmsnorm_rope_plain(x, gamma, cos, sin, heads),
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
    """B5 and B6 take bf16 and fp32 (one launch each), as B1 and B2 do;
    fp16, mixed dtypes and a head dim of 64 raise before any launch."""
    q = _rand(dev, 1, 64, 2, 128)
    rows, blk = [[0, 1], [0, 1]], 32
    before = (dict(i8.launches), dict(sp.launches))
    for t in (q.half(), q.float()):
        with pytest.raises(TypeError, match="takes bfloat16 or float32"):
            i8.int8_attention(t, q, q)
        with pytest.raises(TypeError, match="takes bfloat16 or float32"):
            sp.sparse_flash_attention(t, q, q, rows, blk)
    with pytest.raises(TypeError, match="takes bfloat16 or float32"):
        i8.int8_attention(q.half(), q.half(), q.half())
    with pytest.raises(TypeError, match="takes bfloat16 or float32"):
        sp.sparse_flash_attention(q.half(), q.half(), q.half(), rows, blk)
    with pytest.raises(ValueError):
        i8.int8_attention(q[..., :64].contiguous(), q[..., :64].contiguous(),
                          q[..., :64].contiguous())          # head_dim 64
    assert (dict(i8.launches), dict(sp.launches)) == before
    f = q.float()
    i8.int8_attention(f, f, f)
    sp.sparse_flash_attention(f, f, f, rows, blk)
    torch.cuda.synchronize()
    assert (i8.launches["int8_attention"], sp.launches["sparse_attention"]) \
        == (before[0]["int8_attention"] + 1, before[1]["sparse_attention"] + 1)
    with pytest.raises(ValueError):
        sp.sparse_flash_attention(q, q, q, rows, 40)          # L != 2 * 40
    with pytest.raises(ValueError):
        sp.sparse_flash_attention(q, q, q, rows, blk,
                                  kidx=torch.zeros((2, 2), device=dev),
                                  nnz=torch.full((2,), 2, device=dev))
    # `xla` is JAX's plain softmax attention, the exact branch on the card
    calls = attn.exact_calls["exact_attention"]
    out = attn.attention(q, q, q, backend="xla")
    assert attn.exact_calls["exact_attention"] == calls + 1
    check_attention(out, fa.attention_plain(q, q, q), "xla")


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


# head dims above 128: 256 runs its own instance of each kernel, 384 and
# 512 the wide design (csrc/hopper_wide.cuh)
WIDE_HEAD_DIMS = (256, 384, 512)


@DTYPES
@pytest.mark.parametrize("d", WIDE_HEAD_DIMS)
@pytest.mark.parametrize("b,h,lq,lk,k_len", [
    (1, 2, 1, 129, None),            # one query row, keys 1 past a tile
    (2, 2, 200, 300, [300, 63]),     # k_len inside the first 64-key tile
    (2, 1, 77, 700, [1, 650]),       # k_len 1; a ragged q tile
    (1, 2, 130, 520, [0]),           # every key masked alike
])
def test_flash_attention_head_dims(dev, d, b, h, lq, lk, k_len, dtype):
    """B1 at head dims 256, 384 and 512 on structured inputs (a column,
    span or slab mixed up is off by far more than the bound); in fp32 all
    three run the wide design's fp32 dense mode."""
    q, k, v = _structured(dev, b, lq, lk, h, seed=80, d=d, dtype=dtype)
    kl = None if k_len is None else torch.tensor(k_len, device=dev)
    before = fa.launches["flash_attention"]
    got = fa.flash_attention(q, k, v, k_len=kl)
    torch.cuda.synchronize()
    assert fa.launches["flash_attention"] == before + 1
    _check_attn(got, fa.attention_plain(q, k, v, k_len=kl), f"B1 d{d}")


@DTYPES
@pytest.mark.parametrize("d", WIDE_HEAD_DIMS)
@pytest.mark.parametrize("lq,lk,k_len", [(300, 96, None), (200, 512, [5, 300]),
                                         (65, 512, [512, 0]), (1, 1, None)])
def test_single_kv_attention_head_dims(dev, d, lq, lk, k_len, dtype):
    """B2 at head dims 256, 384 and 512, up to its 512 keys."""
    q, k, v = _structured(dev, 2, lq, lk, 2, seed=84, d=d, dtype=dtype)
    kl = None if k_len is None else torch.tensor(k_len, device=dev)
    before = fa.launches["single_kv_attention"]
    got = fa.single_kv_attention(q, k, v, k_len=kl)
    torch.cuda.synchronize()
    assert fa.launches["single_kv_attention"] == before + 1
    _check_attn(got, fa.attention_plain(q, k, v, k_len=kl), f"B2 d{d}")


# D = 256 runs B1 on 80-key tiles and B2 on 64-key tiles (its O staged for
# TMA stores), K and V in rings of their own (csrc/flash_attention.cu,
# D256Plan): key counts and k_len
# around those tiles' edges, k_len 0, ragged query tiles, and walks long
# enough that the rings' stages and phases carry across work items
@pytest.mark.parametrize("b,h,lq,lk,k_len", [
    (1, 2, 130, 1, None),             # one key
    (1, 2, 130, 79, None),            # one key short of a tile
    (2, 1, 77, 80, None),             # one whole tile, a ragged q tile
    (1, 2, 200, 81, None),            # one key past a tile
    (2, 2, 129, 159, [159, 79]),      # k_len one short of the 2nd / 1st edge
    (2, 2, 129, 161, [160, 81]),      # k_len on the 2nd edge / one past the 1st
    (2, 2, 300, 400, [80, 0]),        # k_len on the 1st edge; 0
    (1, 1, 130, 11648, None),         # the flagship's keys
    (2, 1, 1, 11648, [11601, 11520]),  # one query row; k_len inside / on edges
])
def test_flash_attention_d256_tiles(dev, b, h, lq, lk, k_len):
    """B1 at head dim 256 on its 80-key tiles and split K / V rings."""
    q, k, v = _structured(dev, b, lq, lk, h, seed=120, d=256)
    kl = None if k_len is None else torch.tensor(k_len, device=dev)
    before = fa.launches["flash_attention"]
    got = fa.flash_attention(q, k, v, k_len=kl)
    torch.cuda.synchronize()
    assert fa.launches["flash_attention"] == before + 1
    check_attention(got, fa.attention_plain(q, k, v, k_len=kl),
                    f"B1 d256 lk {lk}")


@pytest.mark.parametrize("lq,lk,k_len", [
    (130, 1, None), (77, 80, [80, 64]), (77, 97, [96, 49]),
    (129, 144, [48, 47]), (200, 400, [65, 0]), (129, 511, [511, 63]),
    (300, 512, [512, 448]),
])
def test_single_kv_attention_d256_tiles(dev, lq, lk, k_len):
    """B2 at head dim 256 on its 64-key tiles and split K / V rings, O
    written through shared memory by TMA stores (ragged Lq: rows past it
    clipped), up to its 512 keys."""
    q, k, v = _structured(dev, 2, lq, lk, 2, seed=124, d=256)
    kl = None if k_len is None else torch.tensor(k_len, device=dev)
    before = fa.launches["single_kv_attention"]
    got = fa.single_kv_attention(q, k, v, k_len=kl)
    torch.cuda.synchronize()
    assert fa.launches["single_kv_attention"] == before + 1
    check_attention(got, fa.attention_plain(q, k, v, k_len=kl),
                    f"B2 d256 lk {lk}")


@pytest.mark.parametrize("kernel,lk,k_len", [
    ("flash_attention", 161, [161, 80]),
    ("flash_attention", 400, None),
    ("single_kv_attention", 512, [300, 81]),
    ("single_kv_attention", 63, None),
])
def test_d256_rings_cross_items(dev, kernel, lk, k_len):
    """B1 / B2 at head dim 256 with at least three work items for every
    persistent CTA (one an SM): the split rings' stages and phases carry
    from item to item, items of 1 to 6 key tiles, and a ragged last q
    tile."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    b, h = 2, 2
    lq = 128 * -(-3 * sms // (b * h)) - 51
    assert -(-lq // 128) * b * h >= 3 * sms
    q, k, v = _structured(dev, b, lq, lk, h, seed=128, d=256)
    kl = None if k_len is None else torch.tensor(k_len, device=dev)
    fn = getattr(fa, kernel)
    before = fa.launches[kernel]
    got = fn(q, k, v, k_len=kl)
    torch.cuda.synchronize()
    assert fa.launches[kernel] == before + 1
    check_attention(got, fa.attention_plain(q, k, v, k_len=kl),
                    f"{kernel} d256 across items")


# B2 at head dim 128 runs plans of its own (csrc/flash_attention.cu): bf16
# on SplitPlan<128, ...> (128-key tiles), fp32 on F32SplitPlan (64-key
# tiles), K and V (V^T) in rings of their own, O written through shared
# memory by TMA stores, and fp32 rounding q in shared memory: key counts
# around both tile widths' edges, k_len before, on and after them and 0,
# ragged query tiles (rows past Lq clipped by the stores), and walks long
# enough that the rings' stages and phases carry across work items
@pytest.mark.parametrize("lq,lk,k_len", [
    (130, 1, None),                  # one key
    (63, 63, [63, 62]),              # one key short of a 64-key tile
    (65, 64, [64, 63]),              # one 64-key tile
    (1, 65, [65, 64]),               # one key past it; k_len on its edge
    (130, 127, [127, 65]),           # one short of a 128-key tile
    (63, 128, [128, 0]),             # one 128-key tile; k_len 0
    (65, 129, [129, 128]),           # one key past it; k_len on its edge
    (130, 300, [257, 127]),          # k_len one past / one short of edges
    (1, 511, [511, 449]),            # one short of 512
    (130, 512, [512, 384]),          # every key; k_len on a tile edge
    (65, 512, [0, 385]),             # k_len 0; one past an edge
])
@DTYPES
def test_single_kv_attention_d128_tiles(dev, lq, lk, k_len, dtype):
    """B2 at head dim 128 on its split rings and staged O, bf16 and fp32,
    from 1 key to its 512."""
    q, k, v = _structured(dev, 2, lq, lk, 3, seed=132, dtype=dtype)
    kl = None if k_len is None else torch.tensor(k_len, device=dev)
    before = fa.launches["single_kv_attention"]
    got = fa.single_kv_attention(q, k, v, k_len=kl)
    torch.cuda.synchronize()
    assert fa.launches["single_kv_attention"] == before + 1
    assert got.dtype == dtype
    _check_attn(got, fa.attention_plain(q, k, v, k_len=kl),
                f"B2 d128 lk {lk}")


@pytest.mark.parametrize("lk,k_len", [(512, [300, 129]), (63, None),
                                      (200, [0, 65])])
@DTYPES
def test_single_kv_d128_rings_cross_items(dev, lk, k_len, dtype):
    """B2 at head dim 128 with at least three work items for every
    persistent CTA (one an SM): the split rings' stages and phases, the
    staged O's buffer and, in fp32, the rounding of each item's Q carry
    from item to item, through items of 1 to 8 key tiles and a ragged last
    q tile."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    b, h = 2, 2
    lq = 128 * -(-3 * sms // (b * h)) - 63
    assert -(-lq // 128) * b * h >= 3 * sms
    q, k, v = _structured(dev, b, lq, lk, h, seed=136, dtype=dtype)
    kl = None if k_len is None else torch.tensor(k_len, device=dev)
    got = fa.single_kv_attention(q, k, v, k_len=kl)
    torch.cuda.synchronize()
    _check_attn(got, fa.attention_plain(q, k, v, k_len=kl),
                "B2 d128 across items")


def _tf32(t):
    """t rounded to tf32 as the kernels round (cvt.rna: to nearest, ties
    away from zero), as fp32."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def test_single_kv_f32_rounds_q_in_the_kernel(dev):
    """B2 in fp32 at head dim 128 reads q as given and rounds it to tf32 in
    shared memory: on q whose low 13 bits are set its output equals, bit
    for bit, its output on q rounded as the pre-pass rounds; and it
    allocates no q workspace (the call's peak holds the output, k's
    workspace and V^T, not a second q)."""
    _, k, v = _structured(dev, 2, 2000, 512, 4, seed=140,
                          dtype=torch.float32)
    # fp32 draws (_structured's are bf16 values, whose low 16 bits are 0)
    q = _rand(dev, 2, 2000, 4, 128, seed=143, dtype=torch.float32)
    assert bool(((q.view(torch.int32) & 0x1fff) != 0).float().mean() > 0.9)
    rounded = _tf32(q)
    assert not torch.equal(rounded, q)
    got = fa.single_kv_attention(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(got, fa.single_kv_attention(rounded, k, v))
    check_attention_tf32(got, fa.attention_plain(q, k, v), "B2 f32 q")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = fa.single_kv_attention(q, k, v)
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated(dev) - base
    q_bytes = q.numel() * 4
    assert q_bytes <= grown < q_bytes + 4 * k.numel() * 4, grown
    del out


@pytest.mark.parametrize("d", WIDE_HEAD_DIMS)
@pytest.mark.parametrize("b,lq,lk,k_len", [(2, 300, 300, None),
                                           (1, 2000, 2000, [777]),
                                           (2, 130, 70, [70, 1])])
def test_int8_attention_head_dims(dev, d, b, lq, lk, k_len):
    """B6 at head dims 256, 384 and 512, with k_len masks and quantization
    blocks that do not align with its tiles."""
    q, k, v = (_rand(dev, b, lq, 2, d, seed=88), _rand(dev, b, lk, 2, d,
                                                        seed=89),
               _rand(dev, b, lk, 2, d, seed=90))
    kl = None if k_len is None else torch.tensor(k_len, device=dev)
    before = i8.launches["int8_attention"]
    got = i8.int8_attention(q, k, v, k_len=kl)
    torch.cuda.synchronize()
    assert i8.launches["int8_attention"] == before + 1
    check_int8_attention(got, i8.int8_attention_plain(q, k, v, k_len=kl),
                         f"B6 d{d}")


@pytest.mark.parametrize("d", WIDE_HEAD_DIMS)
@pytest.mark.parametrize("frames,window,spatial", [
    (5, 2, 448),     # blk 896: 7 row tiles, 14 key tiles of 64
    (9, 2, 100),     # blk 200: each block's last tile ends mid-tile
    (6, 1, 40),      # blk 40: a block inside one tile
])
def test_sparse_attention_head_dims(dev, d, frames, window, spatial):
    """B5 at head dims 256, 384 and 512 on structured inputs."""
    pol = sp.video_sparse_policy(frames, spatial, ref_tokens=spatial,
                                 window=window)
    rows, blk = pol["rows"], pol["blk"]
    q, k, v = _structured(dev, 1, pol["video_len"], pol["video_len"], 2,
                          seed=92, d=d)
    before = sp.launches["sparse_attention"]
    got = sp.sparse_flash_attention(q, k, v, rows, blk)
    torch.cuda.synchronize()
    assert sp.launches["sparse_attention"] == before + 1
    check_sparse_attention(got, sp.masked_dense_attention(q, k, v, rows, blk),
                           f"B5 d{d}")


@pytest.mark.parametrize("d", [256, 384])
def test_head_dims_above_128_launch_kernels_not_the_branch(dev, d,
                                                           monkeypatch):
    """The dispatcher sends a head dim that is a multiple of 128 to the
    kernels, never to the exact branch: B1 for self-attention, B2 for 512
    text keys, B6 under pallas_int8; and a head dim that is not one (192)
    to the exact branch; the kernels themselves raise on it."""
    q = _rand(dev, 2, 600, 2, d, seed=95)
    t = _rand(dev, 2, 512, 2, d, seed=96)
    calls = attn.exact_calls["exact_attention"]
    before = dict(fa.launches)
    check_attention(attn.attention(q, q, q), fa.attention_plain(q, q, q),
                    "dispatch B1")
    check_attention(attn.attention(q, t, t), fa.attention_plain(q, t, t),
                    "dispatch B2")
    assert fa.launches == {"flash_attention": before["flash_attention"] + 1,
                           "single_kv_attention":
                               before["single_kv_attention"] + 1}
    monkeypatch.setenv("FLEXAM_ATTENTION", "pallas_int8")
    attn._default_backend.cache_clear()
    try:
        n8 = i8.launches["int8_attention"]
        check_int8_attention(attn.attention(q, q, q),
                             i8.int8_attention_plain(q, q, q), "dispatch B6")
        assert i8.launches["int8_attention"] == n8 + 1
    finally:
        monkeypatch.delenv("FLEXAM_ATTENTION")
        attn._default_backend.cache_clear()
    assert attn.exact_calls["exact_attention"] == calls
    odd = _rand(dev, 1, 64, 2, 192, seed=97)
    attn.attention(odd, odd, odd)
    assert attn.exact_calls["exact_attention"] == calls + 1
    for fn in (fa.flash_attention, fa.single_kv_attention,
               i8.int8_attention):
        with pytest.raises(ValueError):
            fn(odd, odd, odd)


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


def _refusal_cases(dev, dtype=torch.bfloat16):
    """(name, launch key, call) of each kernel wrapper at a shape it
    takes; `call(t)` launches with `t` as its first tensor argument."""
    q = _rand(dev, 1, 256, 2, 128, seed=40, dtype=dtype)
    kv = _rand(dev, 1, 64, 2, 128, seed=41, dtype=dtype)
    gamma = torch.ones(3072, device=dev, dtype=dtype)
    cos = torch.ones(64, 64, device=dev)
    sin = torch.zeros(64, 64, device=dev)
    terms = torch.zeros(1, 3072, device=dev)
    pair = torch.zeros(1, 2, 3072, device=dev)
    mask = torch.ones(1, 64, device=dev)
    rows = [[0, 1], [0, 1]]
    return [
        ("flash_attention", fa.launches, "flash_attention",
         lambda t: fa.flash_attention(t, q, q)),
        ("single_kv_attention", fa.launches, "single_kv_attention",
         lambda t: fa.single_kv_attention(t, kv, kv)),
        ("rmsnorm_rope", fused.launches, "rmsnorm_rope",
         lambda t: fused.rmsnorm_rope(t, gamma, cos, sin, 24)),
        ("ln_mod_bcast", fused.launches, "ln_mod_bcast",
         lambda t: fused.ln_modulation(t, terms, terms)),
        ("ln_mod_binary", fused.launches, "ln_mod_binary",
         lambda t: fused.ln_modulation(t, pair, pair, mask=mask)),
        ("sparse_attention", sp.launches, "sparse_attention",
         lambda t: sp.sparse_flash_attention(t, q, q, rows, 128)),
        ("int8_attention", i8.launches, "int8_attention",
         lambda t: i8.int8_attention(t, q, q)),
    ]


@pytest.mark.parametrize("case,dtype", [
    *((c, torch.bfloat16) for c in range(7)),
    *((c, torch.float32) for c in range(7))], ids=[
    "B1", "B2", "B3", "B4prime", "B4", "B5", "B6",
    "B1-f32", "B2-f32", "B3-f32", "B4prime-f32", "B4-f32", "B5-f32",
    "B6-f32"])
def test_kernels_refuse_autograd(dev, case, dtype):
    """Each of B1-B6, in bf16 and fp32, raises NotImplementedError for an
    input that requires grad under grad mode (its output would carry no
    grad_fn), before any launch; under no_grad the same call launches."""
    name, counts, key, call = _refusal_cases(dev, dtype)[case]
    attn_like = name not in ("rmsnorm_rope", "ln_mod_bcast", "ln_mod_binary")
    t = (_rand(dev, 1, 256, 2, 128, seed=43, dtype=dtype) if attn_like
         else _rand(dev, 1, 64, 3072, seed=43, dtype=dtype)
         ).requires_grad_(True)
    before = counts[key]
    with pytest.raises(NotImplementedError, match="FLEXAM_FUSED=0"):
        call(t)
    assert counts[key] == before
    with torch.no_grad():
        out = call(t)
    torch.cuda.synchronize()
    assert counts[key] == before + 1 and out.grad_fn is None


def test_dit_trains_on_the_card_through_torch_ops(dev, monkeypatch):
    """At head dim 128 the default backends refuse a backward; with
    FLEXAM_FUSED=0 FLEXAM_ATTENTION=xla the DiT's gradients reach the q/k
    norms and launch no kernel."""
    import dataclasses
    from flexam_tpu_torch.config import tiny_test_config
    from flexam_tpu_torch.models.dit import init_dit_params
    from flexam_tpu_torch.ops import launch_counts
    from flexam_tpu_torch.train import flow_match_loss, trainable
    cfg = dataclasses.replace(tiny_test_config().dit, dim=256, num_heads=2,
                              ffn_dim=512)
    params = init_dit_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    trainable(params)
    g = torch.Generator(device=dev).manual_seed(1)
    c = cfg.out_dim
    batch = {"latents": torch.randn((1, c, 2, 4, 4), generator=g,
                                    device=dev),
             "context": torch.randn((1, cfg.text_len, cfg.text_dim),
                                    generator=g, device=dev).bfloat16(),
             "y": torch.randn((1, 2 * c + 4, 2, 4, 4), generator=g,
                              device=dev),
             "additional_control": torch.randn((1, 5 * c, 2, 4, 4),
                                               generator=g, device=dev),
             "full_ref": torch.randn((1, c, 4, 4), generator=g, device=dev)}
    sigma = torch.full((1,), 0.5, device=dev)
    eps = torch.randn_like(batch["latents"])
    with pytest.raises(NotImplementedError):
        flow_match_loss(params, cfg, batch, sigma, eps)
    monkeypatch.setenv("FLEXAM_FUSED", "0")
    monkeypatch.setenv("FLEXAM_ATTENTION", "xla")
    attn._default_backend.cache_clear()
    try:
        kernels = launch_counts()
        flow_match_loss(params, cfg, batch, sigma, eps).backward()
        torch.cuda.synchronize()
        assert launch_counts() == kernels
        norm_q = params["blocks"][0]["self_attn"]["norm_q"].grad
        assert norm_q is not None and torch.isfinite(norm_q).all()
        assert norm_q.abs().max() > 0
    finally:
        monkeypatch.delenv("FLEXAM_ATTENTION")
        attn._default_backend.cache_clear()


def test_run_steps_graph_replay_equals_eager_steps(dev):
    """`train.run_steps` replays a captured step as a CUDA graph after its
    warmup steps; the result equals running every step eagerly (the same
    kernels on the same inputs)."""
    import dataclasses
    from flexam_tpu_torch.config import tiny_test_config
    from flexam_tpu_torch.io.convert import tree_leaves
    from flexam_tpu_torch.models.dit import init_dit_params
    from flexam_tpu_torch.train import (adamw, cosine_decay_schedule,
                                        draw_noise, flow_match_loss,
                                        run_steps, trainable)
    cfg = dataclasses.replace(tiny_test_config().dit)
    c = cfg.out_dim
    g = torch.Generator(device=dev).manual_seed(2)
    data = {"latents": torch.randn((6, c, 2, 4, 4), generator=g, device=dev),
            "y": torch.randn((6, 2 * c + 4, 2, 4, 4), generator=g,
                             device=dev),
            "additional_control": torch.randn((6, 5 * c, 2, 4, 4),
                                              generator=g, device=dev),
            "full_ref": torch.randn((6, c, 4, 4), generator=g, device=dev),
            "context": torch.randn((6, cfg.text_len, cfg.text_dim),
                                   generator=g, device=dev)}
    sigma, eps = draw_noise(data["latents"], g)
    runs = []
    for warmup in (3, 8):                       # graph replay / all eager
        params = init_dit_params(cfg, seed=0, dtype=torch.float32,
                                 device=dev)
        opt = adamw(trainable(params), cosine_decay_schedule(1e-3, 8, 0.1))
        b = {k: v[:2].clone() for k, v in data.items()}
        s, e = sigma[:2].clone(), eps[:2].clone()

        def load(i):
            j = torch.tensor([i % 6, (i + 1) % 6], device=dev)
            for k, v in data.items():
                torch.index_select(v, 0, j, out=b[k])
            torch.index_select(sigma, 0, j, out=s)
            torch.index_select(eps, 0, j, out=e)

        losses = run_steps(opt, 8, load, lambda: flow_match_loss(
            params, cfg, b, s, e), warmup=warmup)
        runs.append((losses, [t.detach().clone() for t in
                              tree_leaves(params)]))
    (lg, pg), (le, pe) = runs
    torch.testing.assert_close(torch.tensor(lg), torch.tensor(le),
                               rtol=1e-5, atol=0)
    for a, b in zip(pg, pe):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_ulysses_two_ranks_on_one_card(dev):
    """Two ranks on cuda:0 over gloo (NCCL refuses two ranks on one
    device): Ulysses over sp = 2 runs B1 on each rank's 4 of 8 heads over
    the whole sequence, equal to one rank's B1 on all heads (the same
    per-head work) within a bf16 ulp of the output's size."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from flexam_tpu_torch.parallel import launch
    r = launch.run("torch_parallel_ranks:ulysses_on_card", 2, (2, 1024, 8, 128),
                   run_timeout=300)
    assert r["launches"] == 1
    scale = float(r["ref"].abs().max())
    assert float((r["out"] - r["ref"]).abs().max()) <= 2 ** -8 * scale


def _tiny_pipe(dev, quant=None):
    from flexam_tpu_torch.config import tiny_test_config
    from flexam_tpu_torch.models.dit import init_dit_params
    from flexam_tpu_torch.models.vae import init_vae_params
    from flexam_tpu_torch.pipeline import (FlexAMGenerationPipeline,
                                           FlexAMModels)
    cfg = tiny_test_config()
    return FlexAMGenerationPipeline(FlexAMModels(
        cfg=cfg, dit_params=init_dit_params(cfg.dit, seed=0,
                                            dtype=torch.bfloat16, device=dev),
        vae_params=init_vae_params(cfg.vae, seed=1, dtype=torch.bfloat16,
                                   device=dev)), device=dev, quant=quant)


@pytest.mark.parametrize("quant", [None, "int8", "fp8"])
def test_offload_pins_frees_and_restores(dev, quant):
    """The DiT's host copy is pinned; the offload frees the tree's device
    bytes; the restore gives every leaf back bit for bit in its dtype; a
    second cycle reuses the host copy and an in-place write refetches."""
    from flexam_tpu_torch.io.convert import tree_leaves
    pipe = _tiny_pipe(dev, quant)
    leaves = tree_leaves(pipe.models.dit_params)
    nbytes = sum(t.nbytes for t in leaves)
    before = [t.clone() for t in leaves]
    del leaves
    torch.cuda.synchronize()
    a0 = torch.cuda.memory_allocated()
    pipe.offload_dit_to_host()
    freed = a0 - torch.cuda.memory_allocated()
    assert nbytes <= freed <= nbytes + 512 * len(before)
    host = tree_leaves(pipe._dit_host)
    assert all(t.device.type == "cpu" and t.is_pinned() for t in host)
    pipe.restore_dit()
    after = tree_leaves(pipe.models.dit_params)
    for a, b in zip(before, after):
        assert b.is_cuda and a.dtype == b.dtype
        assert torch.equal(a.reshape(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8))
    host1 = pipe._dit_host
    pipe.offload_dit_to_host()
    pipe.restore_dit()
    assert pipe._dit_host is host1
    bias = pipe.models.dit_params["head"]["head"]["bias"]
    bias.add_(1.0)
    want = bias.clone()
    pipe.offload_dit_to_host()
    assert pipe._dit_host is not host1
    pipe.restore_dit()
    assert torch.equal(pipe.models.dit_params["head"]["head"]["bias"], want)


def test_decode_ladder_on_a_real_oom(dev, monkeypatch, capsys):
    """Device memory held so that a group of 4 latent frames cannot be
    decoded and a group of 2 can: the ladder steps down on the real
    out-of-memory error and gives group 2's video bit for bit. The first
    group's choice from the device's room is turned off, so that the
    decode meets the error (the ladder is its backstop)."""
    import gc

    from flexam_tpu_torch import pipeline as tpipe
    monkeypatch.setattr(tpipe, "device_room_bytes", lambda device: None)
    pipe = _tiny_pipe(dev)
    pipe.VAE_STREAM_THRESHOLD = 1000
    pipe.offload_dit_to_host()                        # first group: 4
    g = torch.Generator(device=dev).manual_seed(3)
    z = torch.randn((1, 8, 9, 64, 64), generator=g, device=dev)
    extra, videos = {}, {}
    for group in (2, 4):
        monkeypatch.setenv("FLEXAM_DECODE_GROUP", str(group))
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        videos[group] = pipe.decode_u8(z)
        extra[group] = torch.cuda.max_memory_allocated() - base
    monkeypatch.delenv("FLEXAM_DECODE_GROUP")
    assert extra[4] > extra[2] + (64 << 20), extra
    tried = []
    real = tpipe.vae_decode_streamed_u8

    def spy(*args, group_size=4, **kw):
        tried.append(group_size)
        return real(*args, group_size=group_size, **kw)
    monkeypatch.setattr(tpipe, "vae_decode_streamed_u8", spy)
    gc.collect()
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info()
    # room for group 2 with a margin: a convolution whose workspace cannot
    # be allocated falls back to another algorithm (other bits)
    ballast = torch.empty(int(free - extra[2] - 0.75 * (extra[4] - extra[2])),
                          dtype=torch.uint8, device=dev)
    try:
        got = pipe.decode_u8(z)
    finally:
        del ballast
    assert tried == [4, 2], (tried, extra)
    assert torch.equal(got, videos[2])
    assert "OOM at group_size=4; retrying smaller" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# B5 and B6 in fp32 (TF32 P.V; B6's Q K^T int8)
# ---------------------------------------------------------------------------

F32_BLOCKS = pytest.mark.parametrize("frames,window,spatial,b,h", [
    (3, 1, 8, 2, 2),       # blk 8, the smallest the JAX dispatch takes
    (6, 1, 40, 2, 2),      # blk 40: a block inside one 64-key tile
    (5, 0, 72, 1, 3),      # blk 72: a full tile and a ragged one
    (9, 2, 100, 1, 2),     # blk 200 (group 2): each block's last tile ragged
    (7, 2, 448, 1, 2),     # blk 896 (group 2): the long path's blocks
])


@F32_BLOCKS
def test_sparse_attention_f32_blocks(dev, frames, window, spatial, b, h):
    """B5 in fp32 at blocks of 8, 40, 72, 200 and 896 tokens, ragged nnz
    and the ref block's full row, on structured inputs: V ramped over keys
    (a key tile read from the wrong key of V^T, or the pre-pass's order of
    each 8 keys lost where a block starts at a multiple of 8 that is not
    one of 64, is off by far more than the bound)."""
    pol = sp.video_sparse_policy(frames, spatial, ref_tokens=spatial,
                                 window=window)
    rows, blk, L = pol["rows"], pol["blk"], pol["video_len"]
    nnz = [len(r) for r in rows]
    assert len(set(nnz)) > 1 and nnz[-1] == len(rows)
    q, k, v = _structured(dev, b, L, L, h, seed=110, dtype=torch.float32)
    before = sp.launches["sparse_attention"]
    got = sp.sparse_flash_attention(q, k, v, rows, blk)
    torch.cuda.synchronize()
    assert sp.launches["sparse_attention"] == before + 1
    assert got.dtype == torch.float32
    check_sparse_attention_tf32(
        got, sp.masked_dense_attention(q, k, v, rows, blk), f"B5 f32 blk{blk}")


@pytest.mark.parametrize("b,lq,lk", [
    (2, 2000, 2000),       # quantization blocks of 1,024, padded
    (1, 11648, 11648),     # blocks of 1,456 = 22.75 row tiles
    (1, 18816, 18816),     # blocks of 1,344
    (2, 130, 70),          # cross-attention, tiny and ragged
])
@pytest.mark.parametrize("with_k_len", [False, True])
def test_int8_attention_f32_edges(dev, b, lq, lk, with_k_len):
    """B6 in fp32 with block-scaled q and k (sizes 4x apart from one
    quantization block to the next: a 64-row or 64-key tile that took one
    scale for rows or keys of two blocks is far off), with and without a
    k_len mask."""
    q, k, v = (_rand(dev, b, lq, 2, 128, seed=120, dtype=torch.float32),
               _rand(dev, b, lk, 2, 128, seed=121, dtype=torch.float32),
               _rand(dev, b, lk, 2, 128, seed=122, dtype=torch.float32))
    q = block_scaled(q, i8.quant_block(lq))
    k = block_scaled(k, i8.quant_block(lk), phase=1)
    kl = (torch.tensor([lk, max(1, lk * 3 // 7)][:b], device=dev)
          if with_k_len else None)
    before = i8.launches["int8_attention"]
    got = i8.int8_attention(q, k, v, k_len=kl)
    torch.cuda.synchronize()
    assert i8.launches["int8_attention"] == before + 1
    assert got.dtype == torch.float32
    check_int8_attention_tf32(got, i8.int8_attention_plain(q, k, v, k_len=kl),
                              "B6 f32")


@pytest.mark.parametrize("b,lq,lk,k_len", [
    (2, 300, 400, [63, 64]),       # k_len one short of and on a tile edge
    (2, 129, 257, [129, 1]),       # one key past a tile; a single key
    (1, 700, 512, None),           # 512 keys: the text length
    (1, 2000, 2000, None),         # quantization blocks of 1,024 rows
])
def test_int8_attention_f32_structured(dev, b, lq, lk, k_len):
    """B6 in fp32 on structured inputs, V ramped over keys: a V^T tile
    read from the wrong keys, or a probability put beside another key's v
    (the s32 fragment against the pre-pass's order of each 8 keys), is off
    by far more than the bound."""
    q, k, v = _structured(dev, b, lq, lk, 2, seed=124, dtype=torch.float32)
    kl = None if k_len is None else torch.tensor(k_len, device=dev)
    before = i8.launches["int8_attention"]
    got = i8.int8_attention(q, k, v, k_len=kl)
    torch.cuda.synchronize()
    assert i8.launches["int8_attention"] == before + 1
    check_int8_attention_tf32(got, i8.int8_attention_plain(q, k, v, k_len=kl),
                              "B6 f32 structured")


@pytest.mark.parametrize("d", [128, 256, 384])
def test_long_kernels_f32_head_dims(dev, d):
    """B5 and B6 in fp32 at head dims 128 (their `f32_d128` instances), 256
    and 384 (the wide design's fp32 sparse and int8 modes), on structured
    inputs, B6 with a k_len mask."""
    assert fa.attention_instance(d, torch.float32) == (
        "f32_d128" if d == 128 else "f32_wide")
    pol = sp.video_sparse_policy(9, 100, ref_tokens=100, window=2)
    rows, blk, L = pol["rows"], pol["blk"], pol["video_len"]
    q, k, v = _structured(dev, 1, L, L, 2, seed=126, d=d, dtype=torch.float32)
    before = sp.launches["sparse_attention"]
    got = sp.sparse_flash_attention(q, k, v, rows, blk)
    torch.cuda.synchronize()
    assert sp.launches["sparse_attention"] == before + 1
    check_sparse_attention_tf32(
        got, sp.masked_dense_attention(q, k, v, rows, blk), f"B5 f32 d{d}")
    q, k, v = _structured(dev, 2, 300, 700, 2, seed=128, d=d,
                          dtype=torch.float32)
    kl = torch.tensor([700, 129], device=dev)
    before = i8.launches["int8_attention"]
    got = i8.int8_attention(q, k, v, k_len=kl)
    torch.cuda.synchronize()
    assert i8.launches["int8_attention"] == before + 1
    check_int8_attention_tf32(got, i8.int8_attention_plain(q, k, v, k_len=kl),
                              f"B6 f32 d{d}")


def test_long_f32_entries_refuse_bad_maps(dev):
    """B5's and B6's fp32 C entry points return an error and launch nothing
    for a pointer off a 16-byte boundary (an input, a workspace or the
    output) or a head dim that is not a multiple of 128; the same calls
    well formed return 0."""
    from flexam_tpu_torch.ops import build
    lib = build.library()
    rows, blk = [[0, 1], [1]], 64
    q = _rand(dev, 1, 2 * blk, 2, 128, dtype=torch.float32)
    out = torch.empty_like(q)
    qw, kw = torch.empty_like(q), torch.empty_like(q)
    vt = torch.empty((1, 128, 2, 2 * blk), device=dev)
    kidx, nnz = (torch.from_numpy(a).to(dev) for a in sp.rows_to_arrays(rows))
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    stream = build.stream_handle(q)

    def sparse(qp=q.data_ptr(), vtp=vt.data_ptr(), op=out.data_ptr(), d=128):
        return lib.flexam_sparse_attention_f32(
            qp, q.data_ptr(), q.data_ptr(), qw.data_ptr(), kw.data_ptr(), vtp,
            op, kidx.data_ptr(), nnz.data_ptr(), counter.data_ptr(), 1, 2, 2,
            blk, 2, d, 0.1, stream)

    q8, qs, k8, ks = i8.quantize_qk(q, q)

    def int8(q8p=q8.data_ptr(), vp=q.data_ptr(), vtp=vt.data_ptr(), d=128):
        return lib.flexam_int8_attention_f32(
            q8p, k8.data_ptr(), vp, vtp, out.data_ptr(), qs.data_ptr(),
            ks.data_ptr(), None, 1, 2, 2 * blk, 2 * blk, d, 0.1, stream)

    before = (sp.launches["sparse_attention"], i8.launches["int8_attention"])
    for bad in (dict(qp=q.data_ptr() + 4), dict(vtp=vt.data_ptr() + 4),
                dict(op=out.data_ptr() + 4), dict(d=64)):
        assert sparse(**bad) != 0
    for bad in (dict(q8p=q8.data_ptr() + 1), dict(vp=q.data_ptr() + 4),
                dict(vtp=vt.data_ptr() + 4), dict(d=64)):
        assert int8(**bad) != 0
    torch.cuda.synchronize()
    assert sparse() == 0 and int8() == 0
    torch.cuda.synchronize()
    assert (sp.launches["sparse_attention"],
            i8.launches["int8_attention"]) == before   # C calls only
