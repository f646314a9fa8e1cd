"""Exact softmax attention: kernels B1 and B2 and their plain versions.

Port of `flexam_tpu/ops/flash_attention.py`. The CUDA kernels live in
`csrc/flash_attention.cu`:

  * B1 `flash_attention` — online softmax over 128-key tiles (the TPU
    `_flash_kernel`), any key count;
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
