"""Exact softmax attention: kernels B1 and B2 and their plain versions.

Port of `flexam_tpu/ops/flash_attention.py`. The CUDA kernels live in
`csrc/flash_attention.cu`:

  * B1 `flash_attention` — online softmax over 128-key tiles (the TPU
    `_flash_kernel`), any key count;
  * B2 `single_kv_attention` — at most 512 keys (the TPU
    `_single_kv_kernel`, which the TPU wrapper takes when one key block
    covers every key: the DiT's cross-attention over 512 text tokens); on
    the card, B1's kernel bounded to 4 key tiles.

Both are Hopper kernels (TMA loads into an mbarrier ring, wgmma, a producer
warp beside two consumer warpgroups); `csrc/flash_attention.cu` says how.

Layout [B, L, H, D] (the reference `attention()` layout), bf16, D == 128 on
the card. A CUDA tensor launches the kernel or raises; a CPU tensor takes
`attention_plain`, which mirrors the JAX math (`core/attention.py:
xla_attention`: fp32 logits and softmax, probabilities cast to q.dtype before
P.V) with the kernels' -1e30 key mask.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from flexam_tpu_torch.ops import build

LOG2E = 1.4426950408889634
MASK_VALUE = -1e30
SINGLE_KV_MAX_KEYS = 512
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


def check_inputs(q, k, v, k_len, name):
    """Raise unless q [B, Lq, H, 128], k = v [B, Lk, H, 128] are bf16,
    contiguous and on one CUDA device; returns k_len as int32 (or None)."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"{name}: q, k and v must be on one CUDA device")
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: the kernel takes bf16 q, k, v; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{name}: expected q [B, Lq, H, D], k = v "
                         f"[B, Lk, H, D]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree on B, H or D")
    if d != 128:
        raise ValueError(f"{name}: the kernel takes head_dim 128, got {d}")
    for t in (q, k, v):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: q, k, v must be contiguous and "
                             "16-byte aligned")
    if k_len is not None:
        if k_len.shape != (b,) or k_len.device != q.device:
            raise ValueError(f"{name}: k_len must be [B] on q's device")
        k_len = k_len.to(torch.int32).contiguous()
    return k_len


def _launch(entry, name, q, k, v, k_len, scale):
    k_len = check_inputs(q, k, v, k_len, name)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, lq, h, d = q.shape
    out = torch.empty_like(q)
    err = getattr(build.library(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        k_len.data_ptr() if k_len is not None else None,
        b, h, lq, k.shape[1], d, float(scale) * LOG2E,
        build.stream_handle(q))
    build.check(err, name)
    launches[name] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    k_len: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """B1: exact attention over [B, L, H, D]; any key count."""
    if not q.is_cuda:
        return attention_plain(q, k, v, k_len=k_len, scale=scale)
    return _launch("flexam_flash_attention", "flash_attention", q, k, v,
                   k_len, scale)


def single_kv_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        k_len: Optional[torch.Tensor] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """B2: exact attention over [B, L, H, D] with at most 512 keys."""
    if k.shape[1] > SINGLE_KV_MAX_KEYS:
        raise ValueError(f"single_kv_attention takes at most "
                         f"{SINGLE_KV_MAX_KEYS} keys, got {k.shape[1]}")
    if not q.is_cuda:
        return attention_plain(q, k, v, k_len=k_len, scale=scale)
    return _launch("flexam_single_kv_attention", "single_kv_attention",
                   q, k, v, k_len, scale)
