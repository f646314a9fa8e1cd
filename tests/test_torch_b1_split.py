"""B1's tail split (`flexam_tpu_torch/ops/flash_attention.py` tail_split),
on the CPU.

On the card B1 at head dim 128 (bf16) runs one persistent CTA an SM; the
launch's last round, when it is at most half full, runs its work items in
parts of contiguous key tiles, and the CTA that finishes an item's last
part merges the parts. Here: the plan's arithmetic (every (item, key tile)
in exactly one unit, the tail within one round, no split past half a round)
and the plain model of the split and merge that the card tests hold the
kernel to (`testing.attention_split_plain`), against JAX's
`flash_attention` in interpret mode at the edges of 128-key tiles (the
card's: its library reports them, `b1_plan`), with k_len 0 and with parts
that get no key tile; and the wrapper's choice of split, on the plan the
library reports. fp32 at rtol 2e-4
/ atol 2e-5; bf16 within `check_attention`'s bound.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexam_tpu_torch.testing import attention_split_plain, check_attention

JF = importlib.import_module("flexam_tpu.ops.flash_attention")
TF = importlib.import_module("flexam_tpu_torch.ops.flash_attention")

F32 = dict(rtol=2e-4, atol=2e-5)
TILE = 128   # keys a tile of B1 at head dim 128 (SplitPlan<128, 128, ...>)


@pytest.mark.parametrize("n_work,n_tiles,sms", [
    (432, 18, 132),       # FLUX 2,304 tokens: 36 tail items in 3 parts
    (408, 17, 132),       # FLUX' 2,072: 12 in 11
    (4368, 91, 132),      # the flagship: 12 in 11
    (24, 10, 132),        # fewer items than SMs
    (133, 10, 132),       # a tail of 1
    (197, 10, 132),       # a tail of 65, just under half a round
    (198, 10, 132),       # 66, half a round
    (199, 10, 132),       # 67, just over: no split
    (264, 10, 132),       # whole rounds: no split
    (7, 2, 132),          # parts bounded by the key tiles
    (5, 1, 132),          # one key tile: no split
    (400, 30, 128),       # another card
])
def test_tail_split_covers_every_tile_once(n_work, n_tiles, sms):
    t, s = TF.tail_split(n_work, n_tiles, sms)
    tail = n_work % sms
    if tail == 0 or tail > sms // 2 or n_tiles == 1:
        assert (t, s) == (0, 1)
    else:
        assert t == tail and s == min(sms // tail, n_tiles) and s > 1
    units = TF.split_units(n_work, t, s, n_tiles)
    seen = {}
    for item, t0, t1 in units:
        assert 0 <= t0 <= t1 <= n_tiles
        for tile in range(t0, t1):
            assert (item, tile) not in seen
            seen[item, tile] = True
    assert len(seen) == n_work * n_tiles
    # the tail's units fit one round of the card
    assert len(units) - (n_work - t) <= sms
    assert t * s <= sms


def test_split_units_with_fewer_tiles_than_parts():
    """An item whose k_len leaves fewer key tiles than parts gets empty
    parts (the kernel skips them in the merge), and the rest still cover
    its tiles once."""
    units = TF.split_units(3, 2, 5, 2)
    assert units[0] == (0, 0, 2)
    parts = units[1:6]
    assert [t1 - t0 for _, t0, t1 in parts].count(0) == 3
    assert sorted(t for _, t0, t1 in parts for t in range(t0, t1)) == [0, 1]


class _Lib:
    """A stand-in for the kernel library's `flexam_b1_plan`: B1-128's
    plan as `csrc/flash_attention.cu` reports it, by B1_PLAN_FIELDS."""

    def __init__(self, tile_keys=TILE, tail_split=1):
        self.fields = (tile_keys, 2, 1, 1, 1, 1, tail_split)
        self.calls = 0

    def flexam_b1_plan(self, out):
        self.calls += 1
        out[:] = self.fields
        return 0


def test_b1_plan_reads_the_library_once():
    """`b1_plan` names the library's fields and keeps them on it."""
    lib = _Lib()
    plan = TF.b1_plan(lib)
    assert plan == dict(zip(TF.B1_PLAN_FIELDS, lib.fields))
    assert TF.b1_plan(lib) is plan and lib.calls == 1


@pytest.mark.parametrize("d,dtype,expect", [
    (128, torch.bfloat16, (36, 3)),
    (128, torch.float32, (0, 1)),
    (256, torch.bfloat16, (0, 1)),
])
def test_b1_split_takes_bf16_at_head_dim_128(monkeypatch, d, dtype, expect):
    """The wrapper splits only the bf16 instance at head dim 128, with
    FLUX's 2,304 tokens in 24 heads on 132 SMs."""
    monkeypatch.setattr(TF, "multiprocessors", lambda device: 132)
    q = torch.zeros(1, 2304, 24, d, dtype=dtype)
    assert TF.b1_split(q, q, _Lib()) == expect


@pytest.mark.parametrize("tile_keys,tail_split,expect", [
    (128, 0, (0, 1)),      # a plan without the tail split
    (1024, 1, (36, 3)),    # 3 key tiles: 3 parts
    (2048, 1, (36, 2)),    # 2 key tiles bound the parts
    (4096, 1, (0, 1)),     # one key tile: no split
])
def test_b1_split_follows_the_library_s_plan(monkeypatch, tile_keys,
                                             tail_split, expect):
    """The split counts key tiles of the plan the library reports, and
    takes none where the library's B1 has no tail split."""
    monkeypatch.setattr(TF, "multiprocessors", lambda device: 132)
    q = torch.zeros(1, 2304, 24, 128, dtype=torch.bfloat16)
    assert TF.b1_split(q, q, _Lib(tile_keys, tail_split)) == expect


def _qkv(seed, b, lq, lk, h, d=128):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, lq, h, d).astype(np.float32),
            rng.randn(b, lk, h, d).astype(np.float32),
            rng.randn(b, lk, h, d).astype(np.float32))


def _jax(q, k, v, k_len, dtype=jnp.float32):
    return JF.flash_attention(
        *(jnp.asarray(a, dtype) for a in (q, k, v)),
        k_len=None if k_len is None else jnp.asarray(k_len, jnp.int32),
        interpret=True)


@pytest.mark.parametrize("b,h,lq,lk,k_len,tail,parts", [
    (2, 1, 65, 127, None, 2, 2),         # one tile: part 0 empty
    (2, 1, 70, 128, [128, 127], 2, 2),   # one whole tile, k_len 1 short
    (2, 1, 63, 129, [129, 128], 2, 2),   # 1 key past a tile; k_len on the edge
    (2, 1, 130, 384, [0, 384], 4, 3),    # k_len 0: every key masked alike
    (2, 1, 1, 700, [100, 699], 2, 5),    # 1 tile of 6 in 5 parts: 4 empty
    (1, 2, 65, 2304, None, 2, 3),        # FLUX's keys, 18 tiles in 3
    (1, 1, 127, 2072, [1000], 1, 11),    # FLUX' keys, k_len inside a tile
    (2, 2, 130, 300, [257, 300], 3, 2),  # 8 items, the last 3 split
])
def test_split_model_matches_pallas(b, h, lq, lk, k_len, tail, parts):
    q, k, v = _qkv(21, b, lq, lk, h)
    ref = np.asarray(_jax(q, k, v, k_len))
    kl = None if k_len is None else torch.tensor(k_len)
    got = attention_split_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                k_len=kl, tail=tail, parts=parts,
                                tile_keys=TILE)
    np.testing.assert_allclose(got.numpy(), ref, **F32)


@pytest.mark.parametrize("lk,k_len,parts", [(2304, None, 3),
                                            (384, [0, 200], 4)])
def test_split_model_bf16_within_the_card_bound(lk, k_len, parts):
    """In bf16 the parts round their probabilities to bf16 against their
    own row max (as the kernel's tiles do): within `check_attention`'s
    bound of JAX's kernel."""
    q, k, v = _qkv(22, 2, 65, lk, 1)
    ref = torch.from_numpy(np.array(_jax(q, k, v, k_len, jnp.bfloat16),
                                    np.float32))
    kl = None if k_len is None else torch.tensor(k_len)
    got = attention_split_plain(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
        k_len=kl, tail=2, parts=parts, tile_keys=TILE)
    check_attention(got, ref, f"split model bf16 lk {lk}")


def test_split_model_without_a_split_is_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _qkv(23, 1, 100, 200, 2))
    assert torch.equal(attention_split_plain(q, k, v, tail=0, parts=1,
                                             tile_keys=TILE),
                       TF.attention_plain(q, k, v))
