"""Ring sequence-parallel attention.

Port of `flexam_tpu/parallel/ring.py`, the ring half of the reference's
xDiT USP hybrid (`ulysses_degree x ring_degree`, `ui/controller.py:63,
89-95`). Each rank keeps its query slice; the key/value slices travel
round the ring (`batch_isend_irecv` a hop, `comm.ring_shift`) while
each rank accumulates the exact online softmax over them. Like JAX's (XLA
code, no Pallas kernel), `ring_accumulate` is plain torch ops in float32.
A hop's logits are computed over query chunks whose float32 logits stay
within `LOGITS_BUDGET` (the exact branch's bound): at the flagship shape
one unchunked hop is gigabytes a rank.

The hops carry gradients (`comm.ring_shift` sends a hop's gradient back
the other way round the ring), so ring attention differentiates as JAX's
does under `jax.grad`.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from flexam_tpu_torch.core.attention import attention as default_attention
from flexam_tpu_torch.ops.flash_attention import LOGITS_BUDGET
from flexam_tpu_torch.parallel import comm
from flexam_tpu_torch.parallel.ulysses import (MeshAttention,
                                               make_ulysses_attention)

_NEG = -1e30


def ring_accumulate(q_l: torch.Tensor, k_l: torch.Tensor, v_l: torch.Tensor,
                    mesh, axis: str, scale: float,
                    block_mask: Optional[np.ndarray] = None,
                    blk: int = 0) -> torch.Tensor:
    """Exact online softmax over the ring `axis`: q_l / k_l / v_l are this
    rank's contiguous slices [B, L/n, H, D]; the key/value slices make n
    hops. Block-sparse mode (`block_mask` [nb, nb] bool over the whole
    sequence in `blk`-token blocks): each hop applies the sub-mask between
    this rank's query slice and the hop's key/value origin (rank
    (me - s) mod n at hop s); a row that sees no key in a hop adds
    nothing."""
    n = mesh.shape.get(axis, 1)
    me = mesh.index(axis)
    b, lq, h, d = q_l.shape
    lk = k_l.shape[1]
    qf = (q_l.float() * scale).transpose(1, 2)            # [B, H, Lq, D]
    if block_mask is not None:
        assert blk > 0 and lq % blk == 0 and lk % blk == 0, (lq, lk, blk)
        nbq, nbk = lq // blk, lk // blk
        mask_dev = torch.from_numpy(np.asarray(block_mask, bool)).to(
            q_l.device)
        tok_q = torch.arange(lq, device=q_l.device) // blk
        tok_k = torch.arange(lk, device=q_l.device) // blk
    rows = max(1, min(lq, LOGITS_BUDGET // max(1, b * h * lk * 4)))
    chunks = [(a, min(lq, a + rows)) for a in range(0, lq, rows)]
    # each query chunk's running (m, l, acc), replaced (never written in
    # place) so that autograd can differentiate the recurrence
    m = [torch.full((b, h, e - a, 1), _NEG, device=q_l.device)
         for a, e in chunks]
    l = [torch.zeros((b, h, e - a, 1), device=q_l.device) for a, e in chunks]
    acc = [torch.zeros((b, h, e - a, d), device=q_l.device)
           for a, e in chunks]
    k_blk, v_blk = k_l, v_l
    for s in range(n):
        kf = k_blk.float().transpose(1, 2)                 # [B, H, Lk, D]
        vf = v_blk.float().transpose(1, 2)
        if block_mask is not None:
            origin = (me - s) % n
            sub = mask_dev[me * nbq:(me + 1) * nbq,
                           origin * nbk:(origin + 1) * nbk]
        for c, (a, e) in enumerate(chunks):
            logits = torch.matmul(qf[:, :, a:e], kf.transpose(-1, -2))
            if block_mask is not None:
                keep = sub[tok_q[a:e]][:, tok_k]           # [rows, Lk]
                logits = logits.masked_fill(~keep, _NEG)
            m_new = torch.maximum(m[c], logits.amax(-1, keepdim=True))
            p = torch.exp(logits - m_new)
            del logits
            if block_mask is not None:
                p = p.masked_fill(~keep, 0.0)
            alpha = torch.exp(m[c] - m_new)
            l[c] = l[c] * alpha + p.sum(-1, keepdim=True)
            acc[c] = acc[c] * alpha + torch.matmul(p, vf)
            m[c] = m_new
            del p
        if s + 1 < n:
            k_blk = comm.ring_shift(k_blk, mesh, axis)
            v_blk = comm.ring_shift(v_blk, mesh, axis)
    out = torch.cat([a_ / torch.clamp_min(l_, 1e-30)
                     for a_, l_ in zip(acc, l)], dim=2)
    return out.transpose(1, 2).to(q_l.dtype)


class RingAttention(MeshAttention):
    def __init__(self, mesh, seq_axis: str = "sp",
                 batch_axis: Optional[str] = "dp",
                 inner: Callable = default_attention):
        super().__init__(mesh, inner, batch_axis)
        self.seq_axis = seq_axis
        self.token_axes = (seq_axis,)
        self.sp = mesh.shape.get(seq_axis, 1)
        self.ulysses = make_ulysses_attention(mesh, seq_axis, batch_axis,
                                              inner)

    def __call__(self, q, k, v, k_len=None, scale=None):
        if self.sp == 1 or q.shape[1] != k.shape[1] or k_len is not None:
            # cross-attention (local) and masked calls: JAX's fallback
            return self.ulysses(q, k, v, k_len=k_len, scale=scale)
        s = scale if scale is not None else q.shape[-1] ** -0.5
        return ring_accumulate(q, k, v, self.mesh, self.seq_axis, s)


def make_ring_attention(mesh, seq_axis: str = "sp",
                        batch_axis: Optional[str] = "dp",
                        inner: Callable = default_attention) -> RingAttention:
    """attn_fn(q, k, v, k_len=None, scale=None) over local token slices:
    self-attention rotates the keys and values round sp, cross-attention
    runs locally (the text keys are replicated)."""
    return RingAttention(mesh, seq_axis, batch_axis, inner)
