"""Ring sequence-parallel attention.

Port of `flexam_tpu/parallel/ring.py`, the ring half of the reference's
xDiT USP hybrid (`ulysses_degree x ring_degree`, `ui/controller.py:63,
89-95`). Each rank keeps its query slice; the key/value slices travel
round the ring (`batch_isend_irecv` a hop, `comm.ring_shift_raw`) while
each rank accumulates the exact online softmax over them. Like JAX's (XLA
code, no Pallas kernel), `ring_accumulate` is plain torch ops in float32.
A hop's logits are computed over query chunks whose float32 logits stay
within `LOGITS_BUDGET` (the exact branch's bound): at the flagship shape
one unchunked hop is gigabytes a rank.

The hops carry no gradient: training takes the Ulysses schedule.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from flexam_tpu_torch.core.attention import attention as default_attention
from flexam_tpu_torch.ops.flash_attention import LOGITS_BUDGET
from flexam_tpu_torch.parallel import comm
from flexam_tpu_torch.parallel.ulysses import (MeshAttention,
                                               make_ulysses_attention,
                                               refuse_grad)

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
    refuse_grad("ring_accumulate", q_l, k_l, v_l)
    n = mesh.shape.get(axis, 1)
    me = mesh.index(axis)
    b, lq, h, d = q_l.shape
    lk = k_l.shape[1]
    qf = (q_l.float() * scale).transpose(1, 2)            # [B, H, Lq, D]
    m = torch.full((b, h, lq, 1), _NEG, device=q_l.device)
    l = torch.zeros((b, h, lq, 1), device=q_l.device)
    acc = torch.zeros((b, h, lq, d), device=q_l.device)
    if block_mask is not None:
        assert blk > 0 and lq % blk == 0 and lk % blk == 0, (lq, lk, blk)
        nbq, nbk = lq // blk, lk // blk
        mask_dev = torch.from_numpy(np.asarray(block_mask, bool)).to(
            q_l.device)
        tok_q = torch.arange(lq, device=q_l.device) // blk
        tok_k = torch.arange(lk, device=q_l.device) // blk
    rows = max(1, min(lq, LOGITS_BUDGET // max(1, b * h * lk * 4)))
    k_blk, v_blk = k_l, v_l
    for s in range(n):
        kf = k_blk.float().transpose(1, 2)                 # [B, H, Lk, D]
        vf = v_blk.float().transpose(1, 2)
        if block_mask is not None:
            origin = (me - s) % n
            sub = mask_dev[me * nbq:(me + 1) * nbq,
                           origin * nbk:(origin + 1) * nbk]
        for a in range(0, lq, rows):
            e = min(lq, a + rows)
            logits = torch.matmul(qf[:, :, a:e], kf.transpose(-1, -2))
            if block_mask is not None:
                keep = sub[tok_q[a:e]][:, tok_k]           # [rows, Lk]
                logits = logits.masked_fill(~keep, _NEG)
            m_old = m[:, :, a:e]
            m_new = torch.maximum(m_old, logits.amax(-1, keepdim=True))
            p = torch.exp(logits - m_new)
            del logits
            if block_mask is not None:
                p = p.masked_fill(~keep, 0.0)
            alpha = torch.exp(m_old - m_new)
            l[:, :, a:e] = l[:, :, a:e] * alpha + p.sum(-1, keepdim=True)
            acc[:, :, a:e] = acc[:, :, a:e] * alpha + torch.matmul(p, vf)
            m[:, :, a:e] = m_new
            del p
        if s + 1 < n:
            k_blk = comm.ring_shift_raw(k_blk, mesh, axis)
            v_blk = comm.ring_shift_raw(v_blk, mesh, axis)
    out = acc / torch.clamp_min(l, 1e-30)
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
