"""Exact softmax attention: kernels B1 and B2 and their plain versions.

Port of `flexam_tpu/ops/flash_attention.py`. The CUDA kernels live in
`csrc/flash_attention.cu`:

  * B1 `flash_attention` — online softmax over key tiles (the TPU
    `_flash_kernel`), any key count; at head dim 128 in bf16 the launch's
    last round of work items runs split by keys (`tail_split`);
  * B2 `single_kv_attention` — at most 512 keys (the TPU
    `_single_kv_kernel`, which the TPU wrapper takes when one key block
    covers every key: the DiT's cross-attention over 512 text tokens); on
    the card, B1's kernel bounded to 512 keys (at head dims 128 and 256
    with K and V in rings of their own and O written by TMA stores).

Both are Hopper kernels (TMA loads into an mbarrier ring, wgmma, a producer
warp beside two consumer warpgroups); `csrc/flash_attention.cu` says how.

Layout [B, L, H, D] (the reference `attention()` layout), bf16 or fp32,
on the card any D that is a multiple of 128, the JAX kernels' domain. Each
(head dim, dtype) runs one instance of the kernel (`attention_instance`):
in bf16 128 and 256 have their own, every larger multiple of 128 the wide
design of `csrc/hopper_wide.cuh`; in fp32 (TF32 wgmma, the card's
counterpart of the TPU's default fp32 matmul precision, whatever
`torch.backends.cuda.matmul.allow_tf32` says) 128 has its own and every
larger multiple the wide design. fp32 runs a pre-pass
(`csrc/tf32_prep.cuh`, shared with B5 and B6) that rounds q and k to tf32
and writes V^T (rounded) into workspaces allocated here. B5 and B6 take the
same dtypes and name their instances alike. B2 at head dim 128 in fp32
rounds q itself (no q workspace). A CUDA tensor launches the
kernel or raises; a CPU tensor takes `attention_plain`, which mirrors the
JAX math
(`core/attention.py:xla_attention`: fp32 logits and softmax, probabilities
cast to q.dtype before P.V) with the kernels' -1e30 key mask.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional

import torch

from flexam_tpu_torch.ops import build

LOG2E = 1.4426950408889634
MASK_VALUE = -1e30
SINGLE_KV_MAX_KEYS = 512
# fp32: the V^T workspace's keys are padded to a multiple of this
# (`csrc/tf32_prep.cuh` kKeyPad)
F32_KEY_PAD = 64
# the dtypes the attention kernels (B1, B2, B5, B6) take on the card
DTYPES = (torch.bfloat16, torch.float32)
# bytes of fp32 logits one chunk of `attention_plain` may hold: the SVD
# UNet's first-level spatial attention at 512x896 (32 frames x 5 heads x
# 7,168 keys) would hold 33 GB unchunked
LOGITS_BUDGET = 1 << 30

# kernel launches on CUDA tensors, by kernel
launches = {"flash_attention": 0, "single_kv_attention": 0}

# B1 at head dim 128 in bf16: query rows a work item, and the fields of
# its plan and measures as the library reports them (`b1_plan`)
B1_ROWS = 128
B1_PLAN_FIELDS = ("tile_keys", "stages", "split_ring", "stage_o",
                  "ping_pong", "lane_release", "tail_split")
_workspaces: dict = {}
_sms: dict = {}


def b1_plan(lib=None) -> dict:
    """B1 at head dim 128 in bf16 as `lib` (the kernel library by default)
    builds it (`flexam_b1_plan`): its keys a tile and stages, whether K
    and V have rings of their own and O is staged, and which of its
    measures it takes, by B1_PLAN_FIELDS (cached on the library)."""
    lib = build.library() if lib is None else lib
    plan = getattr(lib, "b1_plan", None)
    if plan is None:
        out = (ctypes.c_int * len(B1_PLAN_FIELDS))()
        lib.flexam_b1_plan(out)
        plan = lib.b1_plan = dict(zip(B1_PLAN_FIELDS, out))
    return plan


def tail_split(n_work: int, n_tiles: int, sms: int) -> tuple:
    """(t, s): how B1's launch of `n_work` work items of `n_tiles` key tiles
    each on `sms` SMs (one persistent CTA an SM) splits its last round.
    The launch has n_work // sms whole rounds and a tail of
    t = n_work % sms items; when 0 < t <= sms / 2, each tail item runs as
    s = min(sms // t, n_tiles) parts of contiguous key tiles, so that the
    last round fills the card. (0, 1) splits nothing: no tail, a tail over
    half a round, or one part an item."""
    t = n_work % sms
    s = min(sms // t, n_tiles) if 0 < t <= sms // 2 else 1
    return (t, s) if s > 1 else (0, 1)


def split_units(n_work: int, tail: int, parts: int, n_tiles: int) -> list:
    """The units of a B1 launch split by `tail_split`, in the order the
    persistent CTAs walk them: (item, first key tile, end key tile) for
    each whole item, then for each of the last `tail` items its `parts`
    parts, part p taking tiles [p n / s, (p + 1) n / s) of its n =
    `n_tiles` (the kernel's own ranges; a part may be empty where n < s)."""
    units = [(i, 0, n_tiles) for i in range(n_work - tail)]
    for i in range(n_work - tail, n_work):
        units += [(i, p * n_tiles // parts, (p + 1) * n_tiles // parts)
                  for p in range(parts)]
    return units


def multiprocessors(device: torch.device) -> int:
    """The SMs of a CUDA device (cached)."""
    i = device.index if device.index is not None \
        else torch.cuda.current_device()
    if i not in _sms:
        _sms[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _sms[i]


def b1_split(q: torch.Tensor, k: torch.Tensor, lib=None) -> tuple:
    """The (t, s) of `tail_split` that B1 launches with on these inputs,
    on the key tiles of `b1_plan(lib)` ((0, 1) at any instance but bf16 at
    head dim 128, and for a plan without the tail split)."""
    b, lq, h, d = q.shape
    if d != 128 or q.dtype != torch.bfloat16:
        return 0, 1
    plan = b1_plan(lib)
    if not plan["tail_split"]:
        return 0, 1
    n_work = -(-lq // B1_ROWS) * h * b
    n_tiles = -(-k.shape[1] // plan["tile_keys"])
    return tail_split(n_work, n_tiles, multiprocessors(q.device))


def split_workspace(q: torch.Tensor, lib=None) -> torch.Tensor:
    """The tail split's workspace for q's device and current stream, of
    the size `lib` (the kernel library by default) asks for
    (`flexam_b1_split_workspace_bytes`: a slot of fp32 O, row maxima and
    sums for each SM, then two counter words a tail item), made (zeroed)
    at its first use and kept: the kernel leaves its counters at zero, so
    no later launch on the stream clears anything."""
    lib = build.library() if lib is None else lib
    nbytes = lib.flexam_b1_split_workspace_bytes(multiprocessors(q.device))
    key = (q.device.index, build.stream_handle(q), nbytes)
    ws = _workspaces.get(key)
    if ws is None:
        ws = torch.zeros(nbytes, dtype=torch.uint8, device=q.device)
        _workspaces[key] = ws
    return ws


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    k_len: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None,
                    q_chunk: int = 2048,
                    keep_rows: Optional[Callable] = None,
                    budget: int = LOGITS_BUDGET) -> torch.Tensor:
    """softmax(q k^T * scale) v in fp32 with probabilities cast to q.dtype
    before P.V; keys at or past k_len[b] get the logit -1e30. Runs over
    chunks of at most `q_chunk` query rows and of batch elements, so that the
    fp32 logits of one chunk (b' x H x rows x Lk x 4 bytes) stay within
    `budget` bytes; the batch is split only where one row of every batch
    element is over it (the result does not depend on the chunking, up to
    the order in which the matmuls sum their fp32 products).
    `keep_rows(a, b)`, if given, returns a bool mask of the keys each of
    query rows a..b-1 may see, broadcastable to [B, H, b - a, Lk]; the rest
    get the logit -1e30 too."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, lq, h = q.shape[:3]
    lk = k.shape[1]
    row = 4 * h * lk                       # fp32 logits of one query row
    nb = b if budget >= b * row else max(1, budget // row)
    rows = max(1, min(q_chunk, lq, budget // (nb * row)))
    kf = k.float().permute(0, 2, 3, 1)                  # [B, H, D, Lk]
    vf = v.float().transpose(1, 2)                      # [B, H, Lk, D]
    keep = None
    if k_len is not None:
        keep = (torch.arange(lk, device=q.device)[None, :]
                < k_len.to(q.device)[:, None])[:, None, None, :]
    out = torch.empty_like(q)
    for b0 in range(0, b, nb):
        b1 = min(b0 + nb, b)
        for a in range(0, lq, rows):
            e = min(a + rows, lq)
            qf = q[b0:b1, a:e].float().transpose(1, 2)  # [b', H, c, D]
            logits = torch.matmul(qf, kf[b0:b1]).mul_(scale)
            if keep is not None:
                logits.masked_fill_(~keep[b0:b1], MASK_VALUE)
            if keep_rows is not None:
                m = keep_rows(a, e)
                if m.dim() == 4 and m.shape[0] > 1:
                    m = m[b0:b1]
                logits.masked_fill_(~m, MASK_VALUE)
            probs = torch.softmax(logits, dim=-1).to(q.dtype)
            del logits
            o = torch.matmul(probs.float(), vf[b0:b1])
            out[b0:b1, a:e] = o.transpose(1, 2).to(q.dtype)
    return out


def attention_instance(d: int, dtype: torch.dtype) -> str:
    """The kernel instance of B1, B2, B5 and B6 alike that runs head dim `d`
    in `dtype` on the card:
    bf16 "d128", "d256", or "wide" (`csrc/hopper_wide.cuh`: slabs of 128
    output columns) for any larger multiple of 128; fp32 (TF32) "f32_d128",
    or "f32_wide" for any larger multiple of 128. Raises TypeError for any
    other dtype (fp16 included: no path of the JAX package makes fp16
    activations) and ValueError for a head dim that is not a positive
    multiple of 128 (the dispatcher sends those to exact attention, as
    JAX's does)."""
    if dtype not in DTYPES:
        raise TypeError(f"the attention kernels take bf16 or fp32, got "
                        f"{dtype}")
    if d <= 0 or d % 128:
        raise ValueError(f"the attention kernels take a head_dim that is a "
                         f"multiple of 128, got {d}")
    if dtype == torch.float32:
        return "f32_d128" if d == 128 else "f32_wide"
    return {128: "d128", 256: "d256"}.get(d, "wide")


def head_dim_instance(d: int) -> str:
    """`attention_instance(d, bf16)`: the instance of head dim `d` in B1,
    B2, B5 and B6 alike."""
    return attention_instance(d, torch.bfloat16)


def check_dtype(dtypes, name, q, k, v) -> None:
    """Raise TypeError unless q, k and v share a dtype of `dtypes`."""
    if q.dtype not in dtypes or k.dtype != q.dtype or v.dtype != q.dtype:
        names = " or ".join(str(t).replace("torch.", "") for t in dtypes)
        raise TypeError(f"{name}: the kernel takes {names} q, k, v; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")


def check_inputs(q, k, v, k_len, name, dtypes=DTYPES):
    """Raise unless q [B, Lq, H, D], k = v [B, Lk, H, D] share a dtype of
    `dtypes` (bf16 or fp32), are contiguous and on one CUDA device, with D
    a multiple of 128 (`attention_instance`); returns k_len as int32 (or
    None)."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"{name}: q, k and v must be on one CUDA device")
    check_dtype(dtypes, name, q, k, v)
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{name}: expected q [B, Lq, H, D], k = v "
                         f"[B, Lk, H, D]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree on B, H or D")
    try:
        attention_instance(d, q.dtype)
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None
    for t in (q, k, v):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: q, k, v must be contiguous and "
                             "16-byte aligned")
    if k_len is not None:
        if k_len.shape != (b,) or k_len.device != q.device:
            raise ValueError(f"{name}: k_len must be [B] on q's device")
        k_len = k_len.to(torch.int32).contiguous()
    return k_len


def vt_workspace(v: torch.Tensor) -> torch.Tensor:
    """The fp32 pre-pass's V^T workspace for v [B, Lk, H, D]: [B, D, H,
    Lkp] with Lkp = Lk rounded up to F32_KEY_PAD (B1, B2, B5, B6)."""
    b, lk, h, d = v.shape
    lkp = -(-lk // F32_KEY_PAD) * F32_KEY_PAD
    return torch.empty((b, d, h, lkp), dtype=v.dtype, device=v.device)


def _launch(entry, name, q, k, v, k_len, scale):
    build.refuse_autograd(name, q, k, v)
    k_len = check_inputs(q, k, v, k_len, name)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, lq, h, d = q.shape
    lk = k.shape[1]
    out = torch.empty_like(q)
    tail = (k_len.data_ptr() if k_len is not None else None,
            b, h, lq, lk, d, float(scale) * LOG2E, build.stream_handle(q))
    if q.dtype == torch.float32:
        # the pre-pass's outputs: q and k rounded to tf32, V^T rounded; B2
        # at head dim 128 rounds q in shared memory and takes no q workspace
        qw = None if (entry == "flexam_single_kv_attention" and d == 128) \
            else torch.empty_like(q)
        kw, vt = torch.empty_like(k), vt_workspace(v)
        err = getattr(build.library(), entry + "_f32")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if qw is None else qw.data_ptr(), kw.data_ptr(),
            vt.data_ptr(), out.data_ptr(), *tail)
    elif entry == "flexam_flash_attention":
        t, s = b1_split(q, k)
        ws = split_workspace(q) if s > 1 else None
        err = build.library().flexam_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), tail[0],
            None if ws is None else ws.data_ptr(), t, s, *tail[1:])
    else:
        err = getattr(build.library(), entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *tail)
    build.check(err, name)
    launches[name] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    k_len: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """B1: exact attention over [B, L, H, D], bf16 or fp32; any key
    count."""
    if not q.is_cuda:
        return attention_plain(q, k, v, k_len=k_len, scale=scale)
    return _launch("flexam_flash_attention", "flash_attention", q, k, v,
                   k_len, scale)


def single_kv_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        k_len: Optional[torch.Tensor] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """B2: exact attention over [B, L, H, D], bf16 or fp32, with at most
    512 keys."""
    if k.shape[1] > SINGLE_KV_MAX_KEYS:
        raise ValueError(f"single_kv_attention takes at most "
                         f"{SINGLE_KV_MAX_KEYS} keys, got {k.shape[1]}")
    if not q.is_cuda:
        return attention_plain(q, k, v, k_len=k_len, scale=scale)
    return _launch("flexam_single_kv_attention", "single_kv_attention",
                   q, k, v, k_len, scale)
